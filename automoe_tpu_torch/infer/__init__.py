from automoe_tpu_torch.infer.controllers import PID, pure_pursuit_steer, to_finite_float  # noqa: F401
from automoe_tpu_torch.infer.engine import InferenceEngine  # noqa: F401
