"""Image sampling and resizing (port of holo_diffusion_tpu/ops/image.py).

`bilinear_sample_ndc` is the grid_sample inside Implicitron's ViewSampler:
2D maps sampled at pytorch3d-NDC locations (+x left, +y up), zero padding.
The port samples every map with plain corner gathers (the JAX package's
matmul form for small maps is a TPU workaround with identical values).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_sample_ndc(
    image: torch.Tensor, xys: torch.Tensor, align_corners: bool = False
) -> torch.Tensor:
    """Sample (H, W, C) at pytorch3d-NDC xys (..., 2) -> (..., C); zero
    outside the image."""
    H, W, C = image.shape
    # flip to grid_sample orientation, then to continuous pixel coordinates
    gx, gy = -xys[..., 0], -xys[..., 1]
    if align_corners:
        fx, fy = (gx + 1.0) * 0.5 * (W - 1), (gy + 1.0) * 0.5 * (H - 1)
    else:
        fx, fy = (gx + 1.0) * 0.5 * W - 0.5, (gy + 1.0) * 0.5 * H - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx, wy = fx - x0, fy - y0
    flat = image.reshape(-1, C)
    out = None
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            w = (wx if dx else 1 - wx) * (wy if dy else 1 - wy)
            inside = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
            term = flat[idx] * (w * inside)[..., None]
            out = term if out is None else out + term
    return out


def resize_image(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of (B, H, W, C) with half-pixel centres and no
    antialiasing (the reference's `F.interpolate(mode="bilinear")`)."""
    x = image.permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False,
                      antialias=False)
    return x.permute(0, 2, 3, 1)
