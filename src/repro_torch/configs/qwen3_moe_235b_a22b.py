"""qwen3-moe-235b-a22b [moe]: 128 experts top-8, qk-norm GQA.
[hf:Qwen/Qwen3-235B-A22B; hf]"""
from repro_torch.config import ARCHS, ModelConfig, MoEConfig


@ARCHS.register("qwen3_moe_235b_a22b")
def qwen3_moe_235b_a22b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
        head_dim=128, d_ff=1536, vocab_size=151936,
        moe=MoEConfig(num_experts=128, top_k=8, d_ff=1536),
        moe_layer_stride=1,
        qk_norm=True, rope_theta=1_000_000.0,
        notes="~235B total / ~22B active params",
    )
