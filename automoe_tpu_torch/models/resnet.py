"""ResNet-18 backbone (port of automoe_tpu/models/resnet.py), NCHW.

Structurally torchvision's resnet18 as the reference experts consume it:
`children()[:-2]` → [B,512,H/32,W/32], or with `include_pool` the global
average pool → [B,512]. The backbone IS an nn.Sequential whose children
are named 0..7 (conv1, bn1, relu, maxpool, layer1..layer4), so its state
dict carries the reference names (`backbone.0.weight`,
`backbone.4.0.conv1.weight`, …). In eval mode torch's BatchNorm2d with
running stats is the JAX package's TorchBatchNorm.

Two training options leave the state dict unchanged:
  * qat: every BasicBlock conv reads its weight through the per-output-
    channel int8 fake-quant and its input through the per-tensor one
    (ops/fake_quant.py), in train and eval; the stem conv stays float, as
    the int8 serving path keeps it (serving/quant.py);
  * remat: in a backward pass each BasicBlock is checkpointed
    (torch.utils.checkpoint, non-reentrant, RNG state kept): its
    activations are recomputed in the backward instead of held. The
    recomputation normalises with the batch statistics again but does
    not move BatchNorm's running statistics a second time, so a step
    leaves parameters and running statistics as it does without remat
    (a batch whose statistics are not finite is the exception: 0·inf).
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from automoe_tpu_torch.ops.fake_quant import fake_quant_act, fake_quant_weight


class QATConv2d(nn.Conv2d):
    """nn.Conv2d whose weight is fake-quantized on every read (the stored
    parameter stays float)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, fake_quant_weight(self.weight), self.bias)


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, *,
                 qat: bool = False, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        Conv = QATConv2d if qat else nn.Conv2d
        self.qat = qat
        self.conv1 = Conv(inplanes, planes, 3, stride, 1, bias=False, **fk)
        self.bn1 = nn.BatchNorm2d(planes, eps=1e-5, momentum=0.1, **fk)
        self.conv2 = Conv(planes, planes, 3, 1, 1, bias=False, **fk)
        self.bn2 = nn.BatchNorm2d(planes, eps=1e-5, momentum=0.1, **fk)
        self.downsample = None
        if inplanes != planes or stride != 1:
            self.downsample = nn.Sequential(
                Conv(inplanes, planes, 1, stride, bias=False, **fk),
                nn.BatchNorm2d(planes, eps=1e-5, momentum=0.1, **fk),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fq = fake_quant_act if self.qat else (lambda t: t)
        xq = fq(x)
        y = torch.relu(self.bn1(self.conv1(xq)))
        y = self.bn2(self.conv2(fq(y)))
        r = x if self.downsample is None else self.downsample(xq)
        return torch.relu(y + r)


@contextlib.contextmanager
def _running_stats_frozen(module: nn.Module) -> Iterator[None]:
    """Train-mode BatchNorms under `module` normalise with batch statistics
    but leave running_mean/var and num_batches_tracked as they were: a
    momentum of 0 keeps the running statistics (r·1 + batch·0, exactly),
    and the step count is put back. The saved tensors stay those of the
    original forward, as the checkpoint's recomputation requires."""
    bns = [m for m in module.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    saved = [(m.momentum, None if m.num_batches_tracked is None
              else m.num_batches_tracked.clone()) for m in bns]
    for m in bns:
        m.momentum = 0.0
    try:
        yield
    finally:
        with torch.no_grad():
            for m, (momentum, count) in zip(bns, saved):
                m.momentum = momentum
                if count is not None:
                    m.num_batches_tracked.copy_(count)


def remat_block(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """block(x), its activations recomputed in the backward pass."""
    return checkpoint(block, x, use_reentrant=False, preserve_rng_state=True,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _running_stats_frozen(block)))


#: (filters, stride) of layer1..layer4
STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))


class ResNet18Backbone(nn.Sequential):
    """conv1..layer4 of ResNet-18. Input [B,3,H,W].

    include_pool=False → [B, 512, H/32, W/32];
    include_pool=True  → [B, 512] (global average pool).
    """

    def __init__(self, include_pool: bool = False, *, remat: bool = False,
                 qat: bool = False, device=None, dtype=None):
        fk = dict(device=device, dtype=dtype)
        layers = []
        inplanes = 64
        for filters, stride in STAGES:
            layers.append(nn.Sequential(
                BasicBlock(inplanes, filters, stride, qat=qat, **fk),
                BasicBlock(filters, filters, 1, qat=qat, **fk),
            ))
            inplanes = filters
        super().__init__(
            nn.Conv2d(3, 64, 7, 2, 3, bias=False, **fk),
            nn.BatchNorm2d(64, eps=1e-5, momentum=0.1, **fk),
            nn.ReLU(),
            nn.MaxPool2d(3, 2, 1),
            *layers,
        )
        self.include_pool = include_pool
        self.remat = remat

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            children = list(self)
            for m in children[:4]:  # conv1, bn1, relu, maxpool
                x = m(x)
            for layer in children[4:]:
                for block in layer:
                    x = remat_block(block, x)
        else:
            x = super().forward(x)
        if self.include_pool:
            x = x.mean(dim=(2, 3))
        return x
