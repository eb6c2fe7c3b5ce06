from repro_torch.kernels.kmeans_assign.ops import kmeans_assign, kmeans_update
from repro_torch.kernels.kmeans_assign.ref import (
    kmeans_assign_reference, kmeans_update_reference,
)
