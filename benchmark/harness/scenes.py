"""Synthetic training frames, made on the device from the seed: a sphere
with a random radius, centre and colour map, seen by `n_frames` cameras at
random elevations around it (the pattern of the program's synthetic scenes),
with its mask and depth. Stored as a CO3D batch is on the host: uint8 RGB,
fg probability and crop mask, float16 depth, in pinned memory on a card's
machine."""
from __future__ import annotations

import math
from typing import Dict

import torch

from ..reference import cameras as cam
from ..reference.render import pixel_ndc, rays
from .seeds import generator

FOCAL = 2.5


@torch.no_grad()
def make_batch(gen: torch.Generator, n_frames: int, size: int, device) -> Dict[str, torch.Tensor]:
    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape or (1,), generator=gen, device=device)

    radius, dist = float(u(1.6, 2.4)), float(u(7.0, 9.0))
    centre = u(-0.3, 0.3, 3)
    mix = u(-1.0, 1.0, 3, 3)
    elev = u(-30.0, 45.0, n_frames)
    azim = (torch.arange(n_frames, device=device) * (360.0 / n_frames) + u(0.0, 360.0)) % 360.0
    R, T = cam.look_at(torch.full((n_frames,), dist, device=device), elev, azim,
                       at=tuple(float(c) for c in centre))
    cams = {"R": R, "T": T, "focal": torch.full((n_frames, 2), FOCAL, device=device),
            "pp": torch.zeros((n_frames, 2), device=device)}
    xys = pixel_ndc(size, size, device)[None].expand(n_frames, size * size, 2)
    b = rays(cams, xys, xys[..., :1])
    d = b["directions"] / torch.linalg.norm(b["directions"], dim=-1, keepdim=True)
    o = b["origins"] - centre
    bq = 2.0 * torch.sum(o * d, dim=-1)
    disc = bq * bq - 4.0 * (torch.sum(o * o, dim=-1) - radius ** 2)
    hit = disc > 0
    t = (-bq - torch.sqrt(torch.clamp(disc, min=0.0))) / 2.0
    n = (o + t[..., None] * d) / radius
    rgb = torch.where(hit[..., None], torch.clamp(0.5 + 0.5 * n @ mix / math.sqrt(3.0), 0.0, 1.0),
                      torch.ones_like(n))
    z = cam.world_to_camera(cams, b["origins"] + t[..., None] * d)[..., 2]
    shape = (n_frames, size, size)
    return {
        **cams,
        "image_rgb": torch.round(rgb * 255.0).to(torch.uint8).reshape(*shape, 3),
        "fg_probability": (hit.to(torch.uint8) * 255).reshape(*shape, 1),
        "mask_crop": torch.full((*shape, 1), 255, dtype=torch.uint8, device=device),
        "depth_map": torch.where(hit, z, torch.zeros_like(z)).to(torch.float16).reshape(*shape, 1),
    }


def make_pool(seed: int, n_batches: int, n_frames: int, size: int, device):
    """`n_batches` batches, all different, on the host (pinned when
    `device` is a card)."""
    gen = generator(seed, "frames", device)
    pool = []
    for _ in range(n_batches):
        batch = make_batch(gen, n_frames, size, device)
        if torch.device(device).type == "cuda":
            batch = {k: v.to("cpu").pin_memory() for k, v in batch.items()}
        pool.append(batch)
    return pool


def to_device(batch: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in batch.items()}
