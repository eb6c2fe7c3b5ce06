"""paligemma-3b [vlm]: SigLIP frontend stubbed as 256 patch embeddings;
gemma-style decoder with prefix-LM attention. [arXiv:2407.07726; hf]"""
from repro_torch.config import ARCHS, ModelConfig


@ARCHS.register("paligemma_3b")
def paligemma_3b() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b", family="vlm",
        num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
        head_dim=256, d_ff=16384, vocab_size=257216,
        frontend="vision_patches", num_prefix_embeddings=256,
        prefix_lm=True, tie_embeddings=True,
        notes="backbone only; SigLIP patches provided by input_specs()",
    )
