"""Monte-Carlo splatting of sparse ray renders onto an image grid (port of
holo_diffusion_tpu/ops/splat.py; pytorch3d `rasterize_mc`): each ray goes to
its nearest pixel, collisions are averaged by mask weight."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def rasterize_sparse_rays(
    xys: torch.Tensor,
    features: torch.Tensor,
    image_size: Tuple[int, int],
    depths: Optional[torch.Tensor] = None,
    masks: Optional[torch.Tensor] = None,
):
    """xys (B, N, 2) NDC ray positions; features (B, N, C); depths, masks
    (B, N, 1). Returns (images (B, H, W, C), depths (B, H, W, 1), masks
    (B, H, W, 1)); pixels that no ray reaches are zero."""
    H, W = image_size
    B, N, C = features.shape
    col = torch.clamp(torch.round((1.0 - xys[..., 0]) * W / 2.0 - 0.5), 0, W - 1)
    row = torch.clamp(torch.round((1.0 - xys[..., 1]) * H / 2.0 - 0.5), 0, H - 1)
    # one flat index over all images: image b's pixels at b * H * W
    base = torch.arange(B, device=xys.device)[:, None] * (H * W)
    pix = (base + row.long() * W + col.long()).reshape(-1)
    w = torch.ones((B, N, 1), dtype=features.dtype, device=features.device) if masks is None else masks

    def splat(vals):
        num = vals.new_zeros((B * H * W, vals.shape[-1])).index_add_(
            0, pix, (vals * w).reshape(-1, vals.shape[-1]))
        return num / torch.clamp(den, min=1e-8)

    den = w.new_zeros((B * H * W, 1)).index_add_(0, pix, w.reshape(-1, 1))
    images = splat(features).reshape(B, H, W, C)
    mask_img = torch.clamp(den, max=1.0).reshape(B, H, W, 1)
    if depths is None:
        depth_img = features.new_zeros((B, H, W, 1))
    else:
        depth_img = splat(depths).reshape(B, H, W, 1)
    return images, depth_img, mask_img
