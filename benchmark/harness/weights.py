"""Weights made from the seed on the device: one normal draw for every
floating leaf of the model's state dict in a single call, then scaled by
the leaf's kind. Both the program and the reference load this state dict."""
from __future__ import annotations

import math
from typing import Dict

import torch

from .seeds import generator


def shapes_of(model: torch.nn.Module) -> Dict[str, tuple]:
    """{name: (shape, dtype)} of a model's state dict (a model built on the
    meta device costs nothing)."""
    return {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()}


@torch.no_grad()
def make_state_dict(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """Kernels N(0, 1 / fan_in); norm scales 1 + N(0, 0.01); biases
    N(0, 0.01); BatchNorm running means 0 and variances 1; integer buffers
    0. Views into one buffer, in sorted key order."""
    names = sorted(k for k, (_, dt) in shapes.items() if dt.is_floating_point)
    total = sum(math.prod(shapes[k][0]) for k in names)
    flat = torch.randn(total, generator=generator(seed, "weights", device), device=device)
    sd, off = {}, 0
    for k in names:
        shape = shapes[k][0]
        n = math.prod(shape)
        x = flat[off:off + n].view(shape)
        off += n
        if k.endswith("running_mean"):
            x.zero_()
        elif k.endswith("running_var"):
            x.fill_(1.0)
        elif len(shape) >= 2:
            x.mul_(1.0 / math.sqrt(n // shape[0]))
        elif k.endswith(".weight"):
            x.mul_(0.1).add_(1.0)
        else:
            x.mul_(0.1)
        sd[k] = x
    for k, (shape, dt) in shapes.items():
        if not dt.is_floating_point:
            sd[k] = torch.zeros(shape, dtype=dt, device=device)
    return sd
