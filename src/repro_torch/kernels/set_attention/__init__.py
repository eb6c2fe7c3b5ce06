from repro_torch.kernels.set_attention.ops import (
    masked_set_attention, set_attention_backward,
)
from repro_torch.kernels.set_attention.ref import (
    NEG_INF, set_attention_backward_reference, set_attention_reference,
)
