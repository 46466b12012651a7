from repro_torch.train import optim  # noqa: F401
from repro_torch.train.checkpoint import SectorCheckpointer  # noqa: F401
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
