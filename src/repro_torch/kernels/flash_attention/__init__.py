from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    NEG_INF, attention_reference,
)
