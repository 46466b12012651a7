from repro_torch.sector.chunk import ChunkMeta, FileMeta  # noqa: F401
from repro_torch.sector.client import SectorClient  # noqa: F401
from repro_torch.sector.events import EventBus, SectorEvent  # noqa: F401
from repro_torch.sector.master import SectorMaster  # noqa: F401
from repro_torch.sector.server import ChunkServer  # noqa: F401
from repro_torch.sector.topology import TERAFLOW_TESTBED, Topology  # noqa: F401
