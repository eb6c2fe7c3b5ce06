from repro_torch.kernels.wkv.ops import wkv
from repro_torch.kernels.wkv.ref import wkv_reference
