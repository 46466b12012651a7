from repro_torch.kernels.bucket_partition.ops import (  # noqa: F401
    bucket_dest, bucket_partition, bucket_partition_rows, bucket_scatter)
from repro_torch.kernels.bucket_partition.ref import (  # noqa: F401
    bucket_blocks_ref, bucket_dest_ref, bucket_partition_ref,
    bucket_partition_rows_ref, dest_from_blocks)
