"""World-space trilinear voxel-grid sampling (port of
holo_diffusion_tpu/ops/voxel.py): the gather sampler, the corner-packed
sampler, and the hat-weight corners that the sampling kernels' plain
versions share.

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


def hat_corners(points_world: torch.Tensor, D: int, H: int, W: int, extent: float):
    """The 8 corners q in {floor(i), floor(i) + 1} per axis of each point, in
    (dz, dy, dx) order: flat cells (..., 8) (clamped into the grid only to
    stay valid indices), hat weights relu(1 - |i - q|) per axis (..., 8, 3)
    as (x, y, z), and their slopes d/di = -sign(i - q) inside |i - q| < 1
    (..., 8, 3), 0 on an exact voxel plane. A corner outside the grid gets
    weight and slope 0 (kron_sample.py:66-80 and :133-160 of the JAX
    package)."""
    idx = continuous_indices(points_world, D, H, W, extent)
    base = [torch.floor(i) for i in idx]
    sizes = (W, H, D)
    cells, hats, slopes = [], [], []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                q = [b + d for b, d in zip(base, (dx, dy, dz))]
                inside = torch.ones_like(idx[0], dtype=torch.bool)
                for qq, n in zip(q, sizes):
                    inside = inside & (qq >= 0) & (qq <= n - 1)
                e = [i - qq for i, qq in zip(idx, q)]
                hats.append(torch.stack([torch.clamp(1.0 - ee.abs(), min=0.0) for ee in e], dim=-1)
                            * inside[..., None])
                slopes.append(torch.stack(
                    [torch.where(ee.abs() < 1.0, -torch.sign(ee), torch.zeros_like(ee)) for ee in e], dim=-1)
                    * inside[..., None])
                qx, qy, qz = (qq.clamp(0, n - 1) for qq, n in zip(q, sizes))
                cells.append(((qz * H + qy) * W + qx).long())
    return torch.stack(cells, dim=-1), torch.stack(hats, dim=-2), torch.stack(slopes, dim=-2)


def pack_corner_grid(grid: torch.Tensor) -> torch.Tensor:
    """Each cell's 2x2x2 corner neighbourhood in its row: packed[z, y, x] =
    concat over (dz, dy, dx) of grid[z + dz, y + dy, x + dx], zero past the
    +1 edges. (D, H, W, C) -> (D, H, W, 8C)."""
    D, H, W, C = grid.shape
    padded = torch.nn.functional.pad(grid, (0, 0, 0, 1, 0, 1, 0, 1))
    return torch.cat(
        [padded[dz:dz + D, dy:dy + H, dx:dx + W] for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)],
        dim=-1,
    )


def sample_packed_voxel_grid_world(
    packed: torch.Tensor, points_world: torch.Tensor, extent: float
) -> torch.Tensor:
    """Trilinear sampling from `pack_corner_grid(grid)`: one row gather per
    point, then the 8 chunks weighted. The same function as
    `sample_voxel_grid_world(grid, ...)`. (D, H, W, 8C), (..., 3) -> (..., C)."""
    D, H, W, C8 = packed.shape
    C = C8 // 8
    ix, iy, iz = continuous_indices(points_world, D, H, W, extent)
    xc = torch.floor(ix).clamp(0, W - 1)
    yc = torch.floor(iy).clamp(0, H - 1)
    zc = torch.floor(iz).clamp(0, D - 1)
    rows = packed.reshape(-1, C8)[((zc * H + yc) * W + xc).long()]
    corners = rows.reshape(*rows.shape[:-1], 8, C)
    # chunk (dz, dy, dx) holds grid[clipped base + d]: its weight comes from
    # its ABSOLUTE position q, relu(1 - |i - q|) per axis (a base clipped up
    # from -1 is then weighted right; a +1 chunk past the edge reads zeros)
    out = 0.0
    ci = 0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                wx = torch.clamp(1.0 - (ix - (xc + dx)).abs(), min=0.0)
                wy = torch.clamp(1.0 - (iy - (yc + dy)).abs(), min=0.0)
                wz = torch.clamp(1.0 - (iz - (zc + dz)).abs(), min=0.0)
                out = out + corners[..., ci, :] * (wx * wy * wz)[..., None]
                ci += 1
    return out
