"""Ahead-of-time export of the serving step (port of
automoe_tpu/serving/export.py): the whole serving computation —
preprocess + AutoMoE forward (bf16, f32 or the int8 variant), weights
included — as one `torch.export` program that a serving host runs
without any model code, config or checkpoint plumbing:

    blob = export_serving_step(engine)            # bytes
    step = load_serving_step(blob)                 # callable
    out  = step(frames_u8, speed_kmh)              # {'waypoints': ...}

The program holds the model's parameters and buffers, the resize
matrices, the normalisation mean and std, the gating pool's
mean-of-resize vectors and, for an int8 engine, the packed int8 trunks,
their scales and the stem's constants, all as buffers of the traced
module. The int8 stem kernels stay single nodes of the graph
(`torch.ops.automoe.*`, ops/stem.py), so a loaded program launches them
on the card. Input shapes are fixed at export: another shape raises.

The JAX package's `platforms=` argument has no counterpart: a torch
program runs on the device it was traced on (the engine's), which
`save_serving_bundle` records in meta.json. A bundle traced on `cuda`
raises on a machine with no GPU; it never runs on the CPU instead.
`ArtifactEngine` imports the custom ops and no model code.
"""
from __future__ import annotations

import copy
import io
import json
import re
from pathlib import Path
from typing import Any, Dict, Union

import numpy as np
import torch

import automoe_tpu_torch.ops.stem  # noqa: F401  (registers torch.ops.automoe.*)

#: the engine attributes the step reads besides its model
_ENGINE_STATE = ("_mats", "_mean", "_std", "_qexperts")


class _Buffer:
    """Where a tensor stood in a lifted tree: the name of its buffer."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name


def _is_port_object(obj: Any) -> bool:
    """An instance of one of the port's plain classes (the int8 stems)."""
    return (type(obj).__module__.startswith("automoe_tpu_torch.")
            and not isinstance(obj, torch.nn.Module) and hasattr(obj, "__dict__"))


def _lift(owner: torch.nn.Module, obj: Any, path: str) -> Any:
    """A template of `obj` (dicts, lists, tuples and the port's plain
    objects' attributes, walked through) in which each tensor is registered as a buffer of
    `owner` and replaced by its `_Buffer`. Inference tensors are cloned:
    an exported program cannot lift them."""
    if isinstance(obj, torch.Tensor):
        name = f"{re.sub(r'[^0-9A-Za-z_]', '_', path)}_{len(owner._buffers)}"
        owner.register_buffer(name, obj.clone() if obj.is_inference() else obj)
        return _Buffer(name)
    if isinstance(obj, dict):
        return {k: _lift(owner, v, f"{path}_{k}") for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_lift(owner, v, f"{path}_{i}") for i, v in enumerate(obj))
    if _is_port_object(obj):
        out = copy.copy(obj)
        out.__dict__ = {k: _lift(owner, v, f"{path}_{k}") for k, v in vars(obj).items()}
        return out
    return obj


def _fill(owner: torch.nn.Module, template: Any) -> Any:
    """`template` with each `_Buffer` replaced by `owner`'s buffer."""
    if isinstance(template, _Buffer):
        return getattr(owner, template.name)
    if isinstance(template, dict):
        return {k: _fill(owner, v) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_fill(owner, v) for v in template)
    if _is_port_object(template):
        out = copy.copy(template)
        out.__dict__ = {k: _fill(owner, v) for k, v in vars(template).items()}
        return out
    return template


class ServingStep(torch.nn.Module):
    """An InferenceEngine's step as a module: forward(frames_u8 [B,H,W,3]
    uint8, speed_kmh [B,1] f32) → the engine's output dict. The model is
    a submodule; every other tensor the step reads is a buffer. Build it
    after one live batch (`export_serving_step` runs it), so that the
    model's gating-pool vectors are made and lifted here."""

    def __init__(self, engine):
        super().__init__()
        self.model = engine.model
        self._engine = engine
        self._state = _lift(self, {k: getattr(engine, k) for k in _ENGINE_STATE}, "engine")
        self._uv = _lift(self, dict(engine.model._uv_cache), "uv")

    def forward(self, frames_u8: torch.Tensor, speed_kmh: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        engine = copy.copy(self._engine)
        engine.__dict__.update(_fill(self, self._state), model=self.model)
        cache = self.model._uv_cache
        self.model._uv_cache = _fill(self, self._uv)
        try:
            return engine._run(frames_u8, speed_kmh)
        finally:
            self.model._uv_cache = cache


def export_serving_step(engine, batch_size: int = 1) -> bytes:
    """Serialize an InferenceEngine's step (weights included) for
    `batch_size` frames on the engine's device. The program takes
    (frames_u8 [B,H,W,3] uint8, speed_kmh [B,1] f32) and returns the
    engine's output dict (float32 `waypoints`, `speed`, `speed_seq`,
    `expert_weights`)."""
    h, w = engine.camera_hw
    frames = torch.zeros((batch_size, h, w, 3), dtype=torch.uint8, device=engine.device)
    speeds = torch.zeros((batch_size, 1), dtype=torch.float32, device=engine.device)
    engine._step(frames, speeds)  # makes the model's gating-pool vectors
    # traced without autograd, as it runs: the int8 forward's own no_grad
    # then adds no nested graph, and the stem kernels are nodes of the top one
    with torch.no_grad():
        exported = torch.export.export(ServingStep(engine), (frames, speeds))
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def load_serving_step(blob: Union[bytes, str, Path]):
    """Rehydrate an exported serving step from its bytes or a path to
    them. Returns fn(frames_u8, speed_kmh) -> outputs dict (tensors on the
    program's device); the inputs are tensors on that device, or arrays.
    A shape other than the exported one raises."""
    if isinstance(blob, (bytes, bytearray)):
        blob = io.BytesIO(bytes(blob))
    module = torch.export.load(blob).module()
    device = next(iter(module.buffers())).device

    @torch.inference_mode()
    def step(frames_u8, speed_kmh):
        return module(torch.as_tensor(frames_u8, device=device),
                      torch.as_tensor(speed_kmh, device=device))

    return step


def save_serving_artifact(engine, path: Union[str, Path], batch_size: int = 1) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(export_serving_step(engine, batch_size))
    return path


def save_serving_bundle(engine, out_dir: Union[str, Path], buckets=(1, 2, 4, 8)) -> Path:
    """Export one program per bucket batch size (b{b}.pt2) + meta.json
    (camera_hw, buckets, the device the programs were traced on), so a
    server cold-starts from the programs alone: no model code, no
    checkpoint, no calibration. Pairs with serving/server.py's bucketed
    micro-batching: the front end only ever dispatches bucket sizes."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    buckets = sorted(set(int(b) for b in buckets))
    for b in buckets:
        (out / f"b{b}.pt2").write_bytes(export_serving_step(engine, b))
    (out / "meta.json").write_text(json.dumps({
        "camera_hw": list(engine.camera_hw),
        "buckets": buckets,
        "device": engine.device.type,
    }))
    return out


class ArtifactEngine:
    """InferenceEngine-compatible facade over a `save_serving_bundle` dir:
    `camera_hw`, `buckets`, `infer_batch` (bucket batch sizes only) and
    `infer`, so `serving.server.BatchingServer(ArtifactEngine(dir))`
    serves without importing model code: the cold-start serving path.
    It uploads each batch to the bundle's device and fetches the results.
    A bundle traced on `cuda` raises where no GPU is present."""

    def __init__(self, bundle_dir: Union[str, Path]):
        d = Path(bundle_dir)
        meta = json.loads((d / "meta.json").read_text())
        self.camera_hw = tuple(meta["camera_hw"])
        self.buckets = list(meta["buckets"])
        self.device = torch.device(meta["device"])
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"the bundle {d} was traced on cuda and no CUDA device is "
                               "available; export it from a CPU engine to serve on the CPU")
        self._steps = {b: load_serving_step(d / f"b{b}.pt2") for b in self.buckets}

    def infer_batch(self, frames_u8: np.ndarray, speeds_kmh: np.ndarray
                    ) -> Dict[str, np.ndarray]:
        b = int(np.asarray(frames_u8).shape[0])
        if b not in self._steps:
            raise ValueError(f"no artifact for batch {b}; bundle buckets: {self.buckets}")
        speeds = torch.from_numpy(np.asarray(speeds_kmh, np.float32).reshape(-1, 1))
        frames = torch.from_numpy(np.ascontiguousarray(frames_u8, np.uint8))
        out = self._steps[b](frames.to(self.device), speeds.to(self.device))
        return {k: v.cpu().numpy() for k, v in out.items()}

    def infer(self, frame_u8: np.ndarray, last_speed_kmh: float) -> Dict[str, np.ndarray]:
        out = self.infer_batch(np.asarray(frame_u8, np.uint8)[None],
                               np.asarray([last_speed_kmh]))
        return {k: v[0] for k, v in out.items()}
