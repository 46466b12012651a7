from repro_torch.kernels.bucket_partition.ops import (bucket_dest,  # noqa: F401
                                                      bucket_scatter)
from repro_torch.kernels.bucket_partition.ref import (  # noqa: F401
    bucket_blocks_ref, bucket_dest_ref, dest_from_blocks)
