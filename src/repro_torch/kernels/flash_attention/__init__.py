from repro_torch.kernels.flash_attention.ops import (
    flash_attention, flash_attention_backward, flash_forward,
)
from repro_torch.kernels.flash_attention.ref import (
    NEG_INF, attention_backward_reference, attention_reference,
)
