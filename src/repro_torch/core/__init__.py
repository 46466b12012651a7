from repro_torch.core.engine import (SphereEngine, SphereReport,  # noqa: F401
                                     SphereSession)
from repro_torch.core.executor import ArrayExecutor, BytesExecutor  # noqa: F401
from repro_torch.core.job import SphereJob, SphereStage  # noqa: F401
from repro_torch.core.planner import (IncrementalPlan,  # noqa: F401
                                      SpherePlanner, StagePlan, TaskPlan,
                                      TaskSpec)
from repro_torch.core.metrics import MetricsRegistry  # noqa: F401
from repro_torch.core.stream import SphereStream, WindowPolicy  # noqa: F401
from repro_torch.core.shuffle import (hash_partitioner,  # noqa: F401
                                      range_partitioner, reduce_partitioner)
from repro_torch.core.trace import NULL_TRACER, NullTracer, Tracer  # noqa: F401
