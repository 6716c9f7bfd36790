"""Host-side data pipeline of the port (automoe_tpu/data): fixed-shape
padded collates, the sharded sampler and threaded loader, the BDD and
CARLA detection caches, the CARLA sequence windows and their loader
factories."""
from automoe_tpu_torch.data.factories import (  # noqa: F401
    get_bdd_detection_loader,
    get_carla_detection_loader,
    get_carla_sequence_loader,
)
from automoe_tpu_torch.data.loader import DataLoader, ShardedSampler  # noqa: F401
