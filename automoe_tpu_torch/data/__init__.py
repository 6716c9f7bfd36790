"""Host-side data pipeline of the port (automoe_tpu/data), for detection:
fixed-shape padded collates, the sharded sampler and threaded loader, the
BDD and CARLA detection caches and their loader factories."""
from automoe_tpu_torch.data.factories import (  # noqa: F401
    get_bdd_detection_loader,
    get_carla_detection_loader,
)
from automoe_tpu_torch.data.loader import DataLoader, ShardedSampler  # noqa: F401
