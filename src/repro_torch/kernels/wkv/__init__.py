from repro_torch.kernels.wkv.ops import wkv, wkv_backward
from repro_torch.kernels.wkv.ref import wkv_backward_reference, wkv_reference
