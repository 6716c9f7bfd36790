"""What the evaluators share: the forward they run, as a module or as a
callable."""
from __future__ import annotations

from typing import Callable, Tuple, Union

import torch
from torch import nn

Forward = Union[nn.Module, Callable]


def as_forward(model: Forward, device=None) -> Tuple[Callable, torch.device]:
    """(forward, device). A module runs in eval mode on its own device; any
    other callable (an int8 forward, serving/quant.py) takes the same inputs
    and returns what the module would, and needs `device`, where the
    evaluator puts the batches (as the JAX package's evaluators take an
    apply_fn)."""
    if isinstance(model, nn.Module):
        dev = next(model.parameters()).device
        want = None if device is None else torch.device(device)
        if want is not None and (want.type != dev.type
                                 or want.index not in (None, dev.index)):
            raise ValueError(f"the module is on {dev}, not on {device}")
        return model.eval(), dev
    if device is None:
        raise ValueError("a forward that is not a module needs device=")
    return model, torch.device(device)

