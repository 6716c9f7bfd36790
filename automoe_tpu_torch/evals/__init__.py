"""Evaluation metrics and the eval CLI of the port (automoe_tpu/evals)."""
from automoe_tpu_torch.evals.detection import detection_eval_batch, evaluate_detection  # noqa: F401
from automoe_tpu_torch.evals.segmentation import evaluate_seg_like, seg_eval_batch  # noqa: F401
from automoe_tpu_torch.evals.nuscenes import evaluate_nuscenes  # noqa: F401
from automoe_tpu_torch.evals.gating import evaluate_automoe  # noqa: F401
