"""Data pipeline of the port (automoe_tpu/data): fixed-shape padded
collates, the sampler and threaded loader, the BDD, CARLA and nuScenes
caches, the CARLA sequence windows, the packed caches and their native
reader, the device-resident epoch loader and the loader factories."""
from automoe_tpu_torch.data.factories import (  # noqa: F401
    get_bdd_detection_loader,
    get_bdd_drivable_loader,
    get_bdd_segmentation_loader,
    get_carla_detection_loader,
    get_carla_drivable_loader,
    get_carla_segmentation_loader,
    get_carla_sequence_loader,
    get_nuscenes_loader,
)
from automoe_tpu_torch.data.loader import DataLoader, ShardedSampler  # noqa: F401
