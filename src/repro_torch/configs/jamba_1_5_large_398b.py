"""jamba-1.5-large-398b [hybrid]: Mamba+attention 1:7 interleave, MoE every
other layer (16 experts top-2). [arXiv:2403.19887; hf]"""
from repro_torch.config import (
    ARCHS, BLOCK_ATTN, BLOCK_MAMBA, ModelConfig, MoEConfig,
)

# one attention layer per 8-layer Jamba block (middle position)
_PATTERN = tuple(([BLOCK_MAMBA] * 4 + [BLOCK_ATTN] + [BLOCK_MAMBA] * 3) * 9)


@ARCHS.register("jamba_1_5_large_398b")
def jamba_1_5_large_398b() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=24576, vocab_size=65536,
        block_pattern=_PATTERN,
        moe=MoEConfig(num_experts=16, top_k=2, d_ff=24576),
        moe_layer_stride=2,     # MoE every other layer
        pos_embedding="none",   # Jamba uses no explicit positions
        ssm_state_dim=16, ssm_conv_dim=4,
        notes="~398B total / ~94B active params",
    )
