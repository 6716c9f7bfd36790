"""Latency-path inference engine (port of automoe_tpu/infer/engine.py).

The camera frame goes to the device as raw uint8; resize (two matmuls,
ops/resize.py) → ImageNet normalize → AutoMoE run there, in the engine's
dtype (bf16 by default). `quantize=True` swaps the expert trunks for the
int8 path (serving/quant.py), whose stem is the hand-written kernel K3
(or K4 with stem_variant="pool").
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from automoe_tpu_torch.configs import load_model_config
from automoe_tpu_torch.models import create_automoe_model
from automoe_tpu_torch.ops.resize import resize_bilinear, resize_weights
from automoe_tpu_torch.utils import resolve_device

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class InferenceEngine:
    def __init__(
        self,
        model_config,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        *,
        camera_hw: Tuple[int, int] = (600, 800),
        model_hw: Tuple[int, int] = (256, 256),
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        quantize: bool = False,
        calib_frames: Optional[np.ndarray] = None,
        stem_variant: str = "fused",
        device=None,
    ):
        """state_dict: weights under the reference torch names (e.g. from
        ckpt.state_dict_from_jax or a reference .pth); None → seeded
        random weights. quantize=True serves int8 expert trunks,
        calibrated on `calib_frames` (raw uint8 [N,H,W,3]; prefer real
        frames — the fallback is two uniform-noise frames).
        device: default cuda; raises when no GPU is present unless the
        caller passes device="cpu"."""
        self.device = resolve_device(device)
        self.config = load_model_config(model_config)
        self.dtype = dtype
        self.camera_hw = tuple(camera_hw)
        self.model_hw = tuple(model_hw)
        # float32 first: the int8 pack folds BatchNorm from float32 weights
        model = create_automoe_model(self.config, fast_gating_pool=True,
                                     device=self.device, seed=seed)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self._mats = tuple(
            torch.as_tensor(m, device=self.device).to(dtype)
            for m in resize_weights(*camera_hw, *model_hw, antialias=True)
        )
        self._mean = torch.tensor(IMAGENET_MEAN, device=self.device)
        self._std = torch.tensor(IMAGENET_STD, device=self.device)

        self._qexperts = None
        self._quant_fwd = None
        if quantize:
            from automoe_tpu_torch.serving.quant import (
                make_quant_forward,
                prepare_qexperts,
                quantize_automoe,
            )

            if calib_frames is None:
                calib_frames = np.random.default_rng(0).integers(
                    0, 256, (2, *camera_hw, 3), dtype=np.uint8
                )
            with torch.inference_mode():
                calib_img = self._preprocess(
                    torch.as_tensor(np.asarray(calib_frames), device=self.device)
                )
            qpack = quantize_automoe(model, [{"image": calib_img}], dtype=dtype)
            self._qexperts = prepare_qexperts(qpack, dtype=dtype, device=self.device)
            self._quant_fwd = make_quant_forward(
                self.config, qpack["scales"], dtype=dtype, stem_variant=stem_variant
            )
        self.model = model.to(dtype).eval()

    def _preprocess(self, frame_u8: torch.Tensor) -> torch.Tensor:
        """uint8 [B,H,W,3] → /255 → resize → normalize, NHWC. Division and
        resize run in the engine's dtype; the normalize in float32 (the
        JAX package's bf16 − f32 promotion), rounded to the dtype."""
        x = frame_u8.to(self.dtype) / 255.0
        x = resize_bilinear(x, *self.model_hw, antialias=True, mats=self._mats)
        return ((x.float() - self._mean) / self._std).to(self.dtype)

    @classmethod
    def from_torch_checkpoint(cls, model_config, ckpt_path: str, *,
                              prefer_ema: bool = False, **kw):
        """Serve an AutoMoE torch checkpoint: a reference `.pth` (DDP
        prefixes stripped) or a gating checkpoint written by
        `automoe-train-torch` (its `model_state_dict`). prefer_ema=True
        serves the EMA weights such a checkpoint holds from a run with
        --ema-decay (KeyError if it has none); int8 calibration then runs
        on them."""
        from automoe_tpu_torch.ckpt import load_torch_state_dict, state_dict_from_checkpoint

        sd = (state_dict_from_checkpoint(ckpt_path, prefer_ema=True) if prefer_ema
              else load_torch_state_dict(ckpt_path))
        return cls(model_config, sd, **kw)

    @torch.inference_mode()
    def _step(self, frames: torch.Tensor, speeds: torch.Tensor) -> Dict[str, torch.Tensor]:
        image = self._preprocess(frames)
        batch = {"image": image, "speed": speeds.to(self.dtype)}
        # controls are unavailable at inference → zeros (the model's default)
        if self._quant_fwd is not None:
            out = self._quant_fwd(self.model, self._qexperts, batch)
        else:
            out = self.model(batch)
        return {k: out[k].float() for k in ("waypoints", "speed", "speed_seq",
                                            "expert_weights")}

    def warmup(self) -> None:
        """One B=1 zero frame through `infer`, then wait for the device."""
        self.infer(np.zeros((1, *self.camera_hw, 3), np.uint8), 0.0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def infer(self, frame_u8: np.ndarray, last_speed_kmh: float) -> Dict[str, np.ndarray]:
        """frame_u8 [H,W,3] or [1,H,W,3] uint8 → host numpy outputs."""
        if frame_u8.ndim == 3:
            frame_u8 = frame_u8[None]
        return self.infer_batch(frame_u8, np.asarray([last_speed_kmh]))

    def infer_batch(self, frames_u8: np.ndarray, speeds_kmh: np.ndarray
                    ) -> Dict[str, np.ndarray]:
        """frames_u8 [B,H,W,3] uint8, speeds_kmh [B] → host numpy outputs."""
        return self.fetch(*self.dispatch_batch(frames_u8, speeds_kmh))

    def dispatch_batch(self, frames_u8: np.ndarray, speeds_kmh: np.ndarray):
        """`infer_batch` without the host fetch: uploads the batch and
        enqueues the step on the current stream, returning (device
        outputs, real_b) without waiting for the device. Complete with
        `fetch`."""
        speeds = np.asarray(speeds_kmh, np.float32).reshape(-1, 1)
        frames_u8 = np.asarray(frames_u8, np.uint8)
        if frames_u8.shape[0] != speeds.shape[0]:
            raise ValueError(
                f"batch mismatch: {frames_u8.shape[0]} frames vs "
                f"{speeds.shape[0]} speeds"
            )
        out = self._step(torch.from_numpy(frames_u8).to(self.device),
                         torch.from_numpy(speeds).to(self.device))
        return out, frames_u8.shape[0]

    @staticmethod
    def fetch(out: Dict[str, torch.Tensor], real_b: int) -> Dict[str, np.ndarray]:
        """Copy a `dispatch_batch` result to the host (waits for the
        device step)."""
        return {k: v[:real_b].cpu().numpy() for k, v in out.items()}
