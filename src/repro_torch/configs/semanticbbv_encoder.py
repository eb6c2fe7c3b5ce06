"""The paper's own Stage-1 RWKV encoder (~22M params) as a zoo config, so
it is served like any other arch."""
from repro_torch.config import ARCHS, BLOCK_RWKV, ModelConfig


@ARCHS.register("semanticbbv_encoder")
def semanticbbv_encoder() -> ModelConfig:
    return ModelConfig(
        name="semanticbbv-encoder", family="rwkv",
        num_layers=12, d_model=384, num_heads=6, num_kv_heads=6,
        d_ff=1536,              # channel-mix expand 4x
        vocab_size=256,         # asm-token dimension vocabulary
        block_pattern=tuple([BLOCK_RWKV] * 12),
        pos_embedding="none",
        dtype="float32", param_dtype="float32",
        notes="paper Table II: 22M-class encoder; multi-dim embeddings "
              "are added by repro.core.bbe on top of this backbone",
    )
