from repro_torch.models import model  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    decode_step,
    forward,
    init_cache,
    init_params,
    param_shapes,
    prefill,
)
