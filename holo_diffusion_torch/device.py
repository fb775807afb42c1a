"""Device resolution for the port's entry points.

Every entry point runs on CUDA unless the caller asks for the CPU. With no
GPU and no explicit device it raises: it never falls back to the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> `cuda` (raises when CUDA is absent); anything else as given,
    raising when it names CUDA on a machine without it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        hint = "" if device is not None else " (pass device='cpu' to run on the CPU)"
        raise RuntimeError(f"CUDA is not available{hint}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def module_device(module: torch.nn.Module) -> torch.device:
    """Device of a module's first parameter or buffer."""
    for t in module.parameters():
        return t.device
    for t in module.buffers():
        return t.device
    return torch.device("cpu")


def place(module: torch.nn.Module, device: DeviceLike = None) -> torch.device:
    """Resolve `device` and move `module` there (in place); returns it."""
    dev = resolve_device(device)
    if module_device(module) != dev:
        module.to(dev)
    return dev


def set_full_precision() -> None:
    """Keep float32 convolutions and matmuls in full float32 on the card:
    cuDNN convolutions default to TF32, which keeps ~3 decimal digits."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
