from repro_torch.kernels.rg_lru_scan.ops import rg_lru_scan  # noqa: F401
from repro_torch.kernels.rg_lru_scan.ref import lru_scan_ref  # noqa: F401
