"""xlstm-1.3b [ssm]: sLSTM + mLSTM blocks (7:1 interleave).
[arXiv:2405.04517; unverified]"""
from repro_torch.config import ARCHS, BLOCK_MLSTM, BLOCK_SLSTM, ModelConfig

_PATTERN = tuple(([BLOCK_MLSTM] * 7 + [BLOCK_SLSTM]) * 6)


@ARCHS.register("xlstm_1_3b")
def xlstm_1_3b() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", family="ssm",
        num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
        d_ff=0,                 # xLSTM blocks carry their own projections
        vocab_size=50304,
        block_pattern=_PATTERN,
        pos_embedding="none",   # recurrence provides position
        notes="matrix-memory mLSTM with per-head block-diagonal qkv",
    )
