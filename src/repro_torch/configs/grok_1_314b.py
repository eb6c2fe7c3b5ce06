"""grok-1-314b [moe]: 8 experts top-2, every layer MoE.
[hf:xai-org/grok-1; unverified]"""
from repro_torch.config import ARCHS, ModelConfig, MoEConfig


@ARCHS.register("grok_1_314b")
def grok_1_314b() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", family="moe",
        num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=32768, vocab_size=131072,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff=32768),
        moe_layer_stride=1,
        # 8 experts cannot fill the 16-way model axis: shard each expert's
        # d_ff over `model` (TP-within-expert) and leave experts local
        sharding_overrides=(("expert", None), ("expert_ff", "model")),
        notes="~314B total / ~86B active params",
    )
