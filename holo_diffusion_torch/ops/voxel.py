"""World-space trilinear voxel-grid sampling (port of
holo_diffusion_tpu/ops/voxel.py).

Conventions (pytorch3d `Volumes`): a (D, H, W) grid with voxel size
extent / D on every axis, centred at the origin; index i along an axis of
size n sits at world (i - (n - 1) / 2) * voxel_size (align_corners); (x, y, z)
map to the (W, H, D) axes; zero outside the grid. Grids are channels-last
(D, H, W, C).
"""
from __future__ import annotations

import torch


def voxel_coord_grid(
    resol: int, extent: float, device=None, dtype=torch.float32
) -> torch.Tensor:
    """World xyz of each voxel centre, (resol, resol, resol, 3); out[k, j, i]
    has x = coords[i], y = coords[j], z = coords[k]."""
    voxel_size = extent / resol
    coords = (torch.arange(resol, device=device, dtype=dtype) - (resol - 1) / 2.0) * voxel_size
    zz, yy, xx = torch.meshgrid(coords, coords, coords, indexing="ij")
    return torch.stack([xx, yy, zz], dim=-1)


def continuous_indices(points_world: torch.Tensor, D: int, H: int, W: int, extent: float):
    """World xyz (..., 3) -> continuous voxel indices (ix, iy, iz)."""
    voxel_size = extent / D
    ix = points_world[..., 0] / voxel_size + (W - 1) / 2.0
    iy = points_world[..., 1] / voxel_size + (H - 1) / 2.0
    iz = points_world[..., 2] / voxel_size + (D - 1) / 2.0
    return ix, iy, iz


def sample_voxel_grid_world(
    grid: torch.Tensor, points_world: torch.Tensor, extent: float
) -> torch.Tensor:
    """Trilinearly sample grid (D, H, W, C) at world points (..., 3) ->
    (..., C); zero outside the grid (grid_sample zero padding,
    align_corners=True)."""
    D, H, W, C = grid.shape
    ix, iy, iz = continuous_indices(points_world, D, H, W, extent)
    x0, y0, z0 = torch.floor(ix), torch.floor(iy), torch.floor(iz)
    fx, fy, fz = ix - x0, iy - y0, iz - z0
    flat = grid.reshape(-1, C)
    out = None
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi, zi = x0 + dx, y0 + dy, z0 + dz
                w = (
                    (fx if dx else 1.0 - fx)
                    * (fy if dy else 1.0 - fy)
                    * (fz if dz else 1.0 - fz)
                )
                inside = (
                    (xi >= 0) & (xi <= W - 1)
                    & (yi >= 0) & (yi <= H - 1)
                    & (zi >= 0) & (zi <= D - 1)
                )
                lin = (
                    (zi.clamp(0, D - 1) * H + yi.clamp(0, H - 1)) * W
                    + xi.clamp(0, W - 1)
                ).long()
                contrib = flat[lin] * (w * inside)[..., None]
                out = contrib if out is None else out + contrib
    return out
