from repro_torch.kernels.set_attention.ops import masked_set_attention
from repro_torch.kernels.set_attention.ref import (
    NEG_INF, set_attention_reference,
)
