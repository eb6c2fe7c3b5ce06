"""smollm-135m [dense]: llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.config import ARCHS, ModelConfig


@ARCHS.register("smollm_135m")
def smollm_135m() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m", family="dense",
        num_layers=30, d_model=576, num_heads=9, num_kv_heads=3,
        d_ff=1536, vocab_size=49152,
        tie_embeddings=True,
    )
