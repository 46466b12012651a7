from repro_torch.data.dataset import SectorTokenDataset  # noqa: F401
from repro_torch.data.pipeline import DataPipeline  # noqa: F401
from repro_torch.data.synth import write_synthetic_corpus  # noqa: F401
