from automoe_tpu_torch.models.resnet import ResNet18Backbone  # noqa: F401
from automoe_tpu_torch.models.experts import (  # noqa: F401
    BDDDetectionExpert,
    BDDDrivableExpert,
    BDDSegmentationExpert,
    NuScenesExpert,
    NuScenesImage2DHead,
    PointNet,
    TNet,
)
from automoe_tpu_torch.models.extractors import (  # noqa: F401
    DetectionExpertExtractor,
    DrivableExpertExtractor,
    NuScenesExpertExtractor,
    SegmentationExpertExtractor,
    make_extractor,
)
from automoe_tpu_torch.models.context import SimpleContextExtractor  # noqa: F401
from automoe_tpu_torch.models.gating import GatingNetwork  # noqa: F401
from automoe_tpu_torch.models.policy import EasyBackbone, TrajectoryPolicy  # noqa: F401
from automoe_tpu_torch.models.automoe import (  # noqa: F401
    AutoMoE,
    automoe_pooled_features,
    create_automoe_model,
)
