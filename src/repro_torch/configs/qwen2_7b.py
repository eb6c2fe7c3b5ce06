"""qwen2-7b [dense]: GQA, QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.config import ARCHS, ModelConfig


@ARCHS.register("qwen2_7b")
def qwen2_7b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b", family="dense",
        num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
        d_ff=18944, vocab_size=152064,
        qkv_bias=True, rope_theta=1_000_000.0,
    )
