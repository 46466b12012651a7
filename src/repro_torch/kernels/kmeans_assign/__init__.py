from repro_torch.kernels.kmeans_assign.ops import (  # noqa: F401
    kmeans_assign, kmeans_assign_partials)
from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref  # noqa: F401
