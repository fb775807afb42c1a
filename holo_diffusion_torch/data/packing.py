"""One-buffer host-to-device copies of a batch (port of
holo_diffusion_tpu/data/packing.py).

`BatchPacker.pack` writes every tensor of a FrameData, its cameras
included, into one uint8 host buffer (pinned when it is bound for the
card); `packed_transfer` copies that buffer with one
`to(device, non_blocking=True)`, and `unpack` rebuilds the FrameData on
the device as views into the buffer (`buf[lo:hi].view(dtype).view(shape)`),
without a copy. In the JAX package this works around a TPU transport's
latency for each array; over PCIe a batch of ~11 tensors pays no such
latency, so here it is a parity feature with no expected gain.

Each leaf starts at a multiple of 16 bytes, since `Tensor.view(dtype)`
needs the storage offset to be a multiple of the item size (JAX packs the
leaves back to back); so `nbytes` may exceed JAX's. Bool leaves are stored
as their 0/1 bytes and viewed back as bool. Every leaf round-trips bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch

from ..device import DeviceLike
from ..geometry.cameras import PerspectiveCameras
from .frame_data import FrameData

ALIGN = 16

# a FrameData's structure: which of its fields (camera fields first) are set
Structure = Tuple[str, ...]


def _leaves(batch: FrameData) -> Tuple[Structure, List[torch.Tensor]]:
    names, leaves = [], []
    for f in dataclasses.fields(batch.camera):
        names.append("camera." + f.name)
        leaves.append(getattr(batch.camera, f.name))
    for f in dataclasses.fields(batch)[1:]:
        x = getattr(batch, f.name)
        if x is not None:
            names.append(f.name)
            leaves.append(x)
    return tuple(names), leaves


def _rebuild(names: Structure, leaves: List[torch.Tensor]) -> FrameData:
    cam = {n[len("camera."):]: x for n, x in zip(names, leaves) if n.startswith("camera.")}
    rest = {n: x for n, x in zip(names, leaves) if not n.startswith("camera.")}
    return FrameData(PerspectiveCameras(**cam), **rest)


class BatchPacker:
    """Pack and unpack a FrameData of fixed structure, shapes and dtypes
    through one flat uint8 buffer. The layout is taken from the first
    packed batch (or `example`); every later batch must match it, else
    `ValueError`, as in JAX."""

    def __init__(self, example: Optional[FrameData] = None):
        self.structure: Optional[Structure] = None
        if example is not None:
            self._build_spec(example)

    def _build_spec(self, batch: FrameData) -> None:
        self.structure, leaves = _leaves(batch)
        self._shapes = tuple(tuple(x.shape) for x in leaves)
        self._dtypes = tuple(x.dtype for x in leaves)
        self._bounds, lo = [], 0
        for x in leaves:
            lo = -(-lo // ALIGN) * ALIGN
            hi = lo + x.numel() * x.element_size()
            self._bounds.append((lo, hi))
            lo = hi
        self.nbytes = lo

    def pack(self, batch: FrameData, pin: bool = False) -> torch.Tensor:
        """One (nbytes,) uint8 CPU tensor holding every leaf's bytes, in
        page-locked memory with `pin`."""
        if self.structure is None:
            self._build_spec(batch)
        names, leaves = _leaves(batch)
        if names != self.structure:
            raise ValueError(f"BatchPacker: batch structure changed from {self.structure} to {names}")
        buf = torch.empty((self.nbytes,), dtype=torch.uint8, pin_memory=pin)
        for x, dt, sh, (lo, hi) in zip(leaves, self._dtypes, self._shapes, self._bounds):
            if x.dtype != dt or tuple(x.shape) != sh:
                raise ValueError(f"BatchPacker: leaf changed from {dt}{list(sh)} to {x.dtype}{list(x.shape)}")
            buf[lo:hi].copy_(x.reshape(-1).view(torch.uint8))
        return buf

    def unpack(self, buf: torch.Tensor) -> FrameData:
        """The FrameData whose leaves are views into `buf` (on any device)."""
        if self.structure is None:
            raise ValueError("BatchPacker.unpack before any pack or example")
        leaves = [buf[lo:hi].view(dt).view(sh)
                  for dt, sh, (lo, hi) in zip(self._dtypes, self._shapes, self._bounds)]
        return _rebuild(self.structure, leaves)


def packed_transfer(packer: BatchPacker, device: DeviceLike) -> Callable[[FrameData], torch.Tensor]:
    """The loader's `transfer`: pack on the host (pinned for the card), then
    one non-blocking copy to `device`."""
    dev = torch.device(device)

    def transfer(batch: FrameData) -> torch.Tensor:
        return packer.pack(batch, pin=dev.type == "cuda").to(dev, non_blocking=True)

    return transfer


def make_packer_for_groups(example_batch: Optional[FrameData] = None, steps_per_call: int = 1) -> BatchPacker:
    """A packer for the batches of one train-step call: without an example
    its layout comes from the first packed batch; with one, from the
    example, stacked `steps_per_call` times (`FrameData.stack_steps`) when
    a call takes more than one step's batch."""
    if example_batch is None:
        return BatchPacker()
    if steps_per_call > 1:
        example_batch = FrameData.stack_steps([example_batch] * steps_per_call)
    return BatchPacker(example_batch)
