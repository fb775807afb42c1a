"""Independent random streams from one `--seed`: weights, frames, the
program's draws, the grid, each from its own `torch.Generator`."""
from __future__ import annotations

import hashlib

import torch

STREAMS = ("weights", "frames", "draws", "grid", "check")


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for `stream`, from any whole `seed`."""
    h = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, stream: str, device) -> torch.Generator:
    if stream not in STREAMS:
        raise ValueError(f"unknown stream {stream!r}")
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))
