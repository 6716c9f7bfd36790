"""Fake-quantization for quantization-aware training (port of
automoe_tpu/ops/fake_quant.py).

Training sees the int8 grid the serving path deploys (serving/quant.py):

  * weights: symmetric per-output-channel int8, scale = max(absmax,
    1e-12)/127, round half to even, clip to ±127 — `quantize_folded`'s
    grid. It commutes with BatchNorm folding, which scales each output
    channel: fq(c ⊙ W) = c ⊙ fq(W), so the grid trained against is the
    grid of the deployed folded weights;
  * activations: symmetric per-tensor int8 with the batch's own absmax
    (stateless; serving calibrates static scales from the same
    distribution).

Both pass the gradient straight through (x + (q − x).detach()).

Layout: the port's conv weights are OIHW, so the output channel is axis
0 (the JAX package's HWIO kernels carry it on the last axis).
"""
from __future__ import annotations

from typing import Optional

import torch

_EPS = 1e-12


def _ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return x + (q - x).detach()


def _grid(xf: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    s = (torch.clamp(amax, min=_EPS) / 127.0).detach()
    return torch.clamp(torch.round(xf / s), -127, 127) * s


def fake_quant_weight(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel int8 fake-quant of a weight whose axis 0 is the
    output channel (OIHW conv, [out, in] linear)."""
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(range(1, w.ndim)), keepdim=True)
    return _ste(wf, _grid(wf, amax)).to(w.dtype)


def fake_quant_act(x: torch.Tensor, amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-tensor int8 fake-quant of an activation, dynamic absmax scale
    (`amax`: the absmax of the whole tensor when x is a shard of it)."""
    xf = x.float()
    return _ste(xf, _grid(xf, xf.abs().amax() if amax is None else amax)).to(x.dtype)
