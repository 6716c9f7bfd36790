"""Training losses of the port (automoe_tpu/losses)."""
from automoe_tpu_torch.losses.detection import (  # noqa: F401
    detection_set_loss,
    scatter_matched_targets,
)
from automoe_tpu_torch.losses.trajectory import gating_losses, policy_losses  # noqa: F401
