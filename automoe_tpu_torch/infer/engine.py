"""Latency-path inference engine (port of automoe_tpu/infer/engine.py).

The camera frame goes to the device as raw uint8; resize (two matmuls,
ops/resize.py) → ImageNet normalize → AutoMoE run there, in the engine's
dtype (bf16 by default). `quantize=True` swaps the expert trunks for the
int8 path (serving/quant.py), whose stem is the hand-written kernel K3
(or K4 with stem_variant="pool").

`devices=[...]` serves data-parallel (the JAX engine's `mesh=` with a
'data' axis; `automoe-serve-torch --data-parallel`): one replica of the
model (and of the int8 pack, so K3 runs on each) per device, all in this
process. A batch is repeat-padded to a multiple of the replicas
(`batch_multiple`), each replica takes a contiguous slice, every slice is
enqueued on its own device's stream with no host wait in between, and
`fetch` joins the slices and trims the padding.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Dict, List, Optional, Sequence, Tuple

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
        devices: Optional[Sequence] = None,
    ):
        """state_dict: weights under the reference torch names (e.g. from
        ckpt.state_dict_from_jax or a reference .pth); None → seeded
        random weights. quantize=True serves int8 expert trunks,
        calibrated on `calib_frames` (raw uint8 [N,H,W,3]; prefer real
        frames — the fallback is two uniform-noise frames).
        device: default cuda; raises when no GPU is present unless the
        caller passes device="cpu". devices: one replica per device
        (module docstring); `device` is then devices[0]."""
        if devices is not None:
            devices = [resolve_device(d) for d in devices]
            if not devices:
                raise ValueError("devices must name at least one device")
            device = devices[0]
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
        qpack = None
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
        self._replicas: List["InferenceEngine"] = [self]
        for d in (devices or [])[1:]:
            self._replicas.append(self._replica(d, qpack))
        self.batch_multiple = len(self._replicas)

    def _replica(self, device: torch.device, qpack) -> "InferenceEngine":
        """This engine's model, constants and int8 pack on `device`."""
        r = copy.copy(self)
        r.device = device
        r.model = copy.deepcopy(self.model).to(device)
        r._mats = tuple(m.to(device) for m in self._mats)
        r._mean, r._std = self._mean.to(device), self._std.to(device)
        if qpack is not None:
            from automoe_tpu_torch.serving.quant import prepare_qexperts

            r._qexperts = prepare_qexperts(qpack, dtype=self.dtype, device=device)
        r._replicas = [r]
        r.batch_multiple = 1
        return r

    def _pad_group(self, frames: np.ndarray, speeds: np.ndarray):
        """Repeat-pad a batch up to a multiple of the replicas (identity
        with one); returns (frames, speeds, real_b)."""
        b, m = frames.shape[0], self.batch_multiple
        if m <= 1 or b % m == 0:
            return frames, speeds, b
        pad = (-b) % m
        frames = np.concatenate([frames, np.repeat(frames[-1:], pad, 0)])
        speeds = np.concatenate([speeds, np.repeat(speeds[-1:], pad, 0)])
        return frames, speeds, b

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

    def _run(self, frames: torch.Tensor, speeds: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The step's body, uint8 frames [B,H,W,3] and speeds [B,1] on the
        device → the output dict; `_step` runs it in inference mode, and
        serving/export.py traces it."""
        image = self._preprocess(frames)
        batch = {"image": image, "speed": speeds.to(self.dtype)}
        # controls are unavailable at inference → zeros (the model's default)
        if self._quant_fwd is not None:
            out = self._quant_fwd(self.model, self._qexperts, batch)
        else:
            out = self.model(batch)
        return {k: out[k].float() for k in ("waypoints", "speed", "speed_seq",
                                            "expert_weights")}

    @torch.inference_mode()
    def _step(self, frames: torch.Tensor, speeds: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self._run(frames, speeds)

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
        enqueues the step on the current stream (of each replica's
        device), returning (device outputs, real_b) without waiting for
        the device. Complete with `fetch`."""
        speeds = np.asarray(speeds_kmh, np.float32).reshape(-1, 1)
        frames_u8 = np.asarray(frames_u8, np.uint8)
        if frames_u8.shape[0] != speeds.shape[0]:
            raise ValueError(
                f"batch mismatch: {frames_u8.shape[0]} frames vs "
                f"{speeds.shape[0]} speeds"
            )
        if len(self._replicas) == 1:
            out = self._step(torch.from_numpy(frames_u8).to(self.device),
                             torch.from_numpy(speeds).to(self.device))
            return out, frames_u8.shape[0]
        frames_u8, speeds, real_b = self._pad_group(frames_u8, speeds)
        per = frames_u8.shape[0] // len(self._replicas)
        outs = []
        for i, r in enumerate(self._replicas):
            rows = slice(i * per, (i + 1) * per)
            cuda = r.device.type == "cuda"
            with torch.cuda.device(r.device) if cuda else contextlib.nullcontext():
                f, s = (torch.from_numpy(np.ascontiguousarray(a[rows]))
                        for a in (frames_u8, speeds))
                if cuda:  # pinned: the copy is queued, the host goes on
                    f, s = f.pin_memory(), s.pin_memory()
                outs.append(r._step(f.to(r.device, non_blocking=cuda),
                                    s.to(r.device, non_blocking=cuda)))
        return outs, real_b

    @staticmethod
    def fetch(out, real_b: int) -> Dict[str, np.ndarray]:
        """Copy a `dispatch_batch` result to the host (waits for the
        device step): one output dict, or one a replica, joined in order;
        the padding is trimmed."""
        if isinstance(out, dict):
            return {k: v[:real_b].cpu().numpy() for k, v in out.items()}
        return {k: np.concatenate([o[k].cpu().numpy() for o in out])[:real_b]
                for k in out[0]}
