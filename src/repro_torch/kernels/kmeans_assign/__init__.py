from repro_torch.kernels.kmeans_assign.ops import (  # noqa: F401
    kmeans_assign, kmeans_assign_partials, kmeans_partials)
from repro_torch.kernels.kmeans_assign.ref import (  # noqa: F401
    kmeans_assign_ref, kmeans_partials_ref)
