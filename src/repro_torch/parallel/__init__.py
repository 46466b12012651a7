from repro_torch.parallel.sharding import (  # noqa: F401
    NO_PARALLEL,
    ParallelConfig,
    batch_spec,
    constrain,
    heads_spec,
)
