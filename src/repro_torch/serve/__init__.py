from repro_torch.serve.engine import ServeEngine, Request  # noqa: F401
from repro_torch.serve.sampler import SamplerConfig, sample  # noqa: F401
