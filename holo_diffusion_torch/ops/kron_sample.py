"""Trilinear world-space sampling of a voxel grid, with both of its
cotangents (port of holo_diffusion_tpu/ops/pallas/kron_sample.py).

Three CUDA kernels of `csrc/kron_sample.cu`, each with its plain PyTorch
version here:

  kron_sample_fwd      the sample (N, 3) -> (N, C), zero outside the grid
  kron_sample_dgrid    the grid cotangent sum_n w_n (x) g_n, (D, H, W, C)
  kron_sample_dpoints  the points cotangent (N, 3) of sum g . sample

For CUDA tensors the dispatchers launch the kernel or raise; for CPU
tensors they run the plain version. `KronSample` joins them as a
`torch.autograd.Function` (the JAX package's `jax.custom_vjp`): its backward
launches the grid kernel only when the grid needs a gradient and the points
kernel only when the points do, as XLA drops the unused d_points call in
the JAX package. The kernels launch through `_build.launch`, which counts
them by entry point and channel count.

The TPU computes the sample as a Kronecker-factored matrix product; on the
H100 the grid stays in L2 and each kernel gathers (or scatters into) the 8
corners of a point, so `block_n`, `interpret` and `precision` have no effect
here: the port computes in float32 on the CUDA cores, which is the JAX
package's `precision="highest"` result.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .voxel import hat_corners

# largest D*H*W*C for which the implicit function picks this sampler (and
# the fused decode) by default off the card, as the JAX package does on its
# accelerator: 16^3 x 64, the TPU's limit (`models/implicit.py`
# `sampler_route`; on the card the kernels' 32-bit offsets set the limit)
DEFAULT_MAX_GC = 16 ** 3 * 64
# largest D*H*W*C that these kernels and the fused decode index with 32-bit offsets
KERNEL_MAX_GC = 2 ** 31 - 1
ENTRY_POINTS = tuple(e for e in _build.KERNELS if e.startswith("kron_sample"))


# ---- plain versions


def _hat_weights(points: torch.Tensor, grid_shape, extent: float):
    D, H, W = grid_shape[:3]
    cells, hats, slopes = hat_corners(points, D, H, W, extent)
    return cells, hats[..., 0] * hats[..., 1] * hats[..., 2], hats, slopes


def kron_sample_fwd_reference(grid: torch.Tensor, points: torch.Tensor, extent: float) -> torch.Tensor:
    """grid (D, H, W, C), points (N, 3) -> (N, C): the 8 hat-weighted corners."""
    C = grid.shape[-1]
    cells, w, _, _ = _hat_weights(points, grid.shape, extent)
    flat = grid.reshape(-1, C)
    out = torch.zeros((points.shape[0], C), dtype=grid.dtype, device=grid.device)
    for k in range(8):
        out = out + flat[cells[:, k]] * w[:, k, None]
    return out


def kron_sample_dgrid_reference(
    points: torch.Tensor, g: torch.Tensor, grid_shape: Tuple[int, ...], extent: float
) -> torch.Tensor:
    """Cotangent of the grid from g (N, C): each point adds w * g to its 8
    corners (outside corners add 0)."""
    D, H, W, C = grid_shape
    cells, w, _, _ = _hat_weights(points, grid_shape, extent)
    d_grid = torch.zeros((D * H * W, C), dtype=g.dtype, device=g.device)
    for k in range(8):
        d_grid.index_add_(0, cells[:, k], w[:, k, None] * g)
    return d_grid.reshape(D, H, W, C)


def kron_sample_dpoints_reference(
    grid: torch.Tensor, points: torch.Tensor, g: Optional[torch.Tensor], extent: float
) -> torch.Tensor:
    """Cotangent (N, 3) of the points from g (N, C), or from all ones when g
    is None (the spatial gradient of the summed field): per axis the hat
    slope -sign(i - q) times the other two hats, times D / extent."""
    D, H, W, C = grid.shape
    cells, _, hats, slopes = _hat_weights(points, grid.shape, extent)
    hx, hy, hz = hats.unbind(-1)
    sx, sy, sz = slopes.unbind(-1)
    gw = torch.stack([sx * hy * hz, hx * sy * hz, hx * hy * sz], dim=-1)  # (N, 8, 3)
    flat = grid.reshape(-1, C)
    out = torch.zeros(points.shape, dtype=grid.dtype, device=grid.device)
    for k in range(8):
        v = flat[cells[:, k]]
        v = v.sum(-1) if g is None else (v * g).sum(-1)
        out = out + gw[:, k] * v[:, None]
    return out * (D / extent)


# ---- the CUDA kernels


# channels a K6 lane owns: 16 (4 lanes per point at C 64) was the fastest
# of G = 2..32 at C 64 on an H100 (`kernel_sweep.py`)
DPOINTS_LANE_CHANNELS = 16
# channels a K4 lane owns at least: 16 in float4 units, 32 single. On the
# render chunks' ray-ordered points, G = 4 at C 64 and G = 8 at C 257 were
# the fastest of G = 1..32 on an H100 (`kernel_sweep.py`; on uniformly
# random points G = 8 and 16 were, by 3 % and 17 %)
SAMPLE_LANE_CHANNELS = {4: 16, 1: 32}


def dpoints_layout(C: int) -> Tuple[int, int]:
    """K6's layout for C channels: (log2 of the lanes per point, channels per
    unit). About 16 channels per lane: G = the smallest power of two >=
    ceil(C / 16), at most a warp (1 at C <= 16, 4 at C 64, 32 at C 257). A
    unit is a float4 when C % 4 == 0 (and the grid and cotangent rows lie on
    16-byte boundaries, which the kernel checks), else one float. The kernel
    holds 8 channels of cotangent in registers at a time."""
    lanes_log2 = min(5, max(0, (-(-C // DPOINTS_LANE_CHANNELS) - 1).bit_length()))
    return lanes_log2, 4 if C % 4 == 0 else 1


def sample_layout(C: int) -> Tuple[int, int]:
    """K4's and K7's layout: (log2 of the lanes per point, channels per unit). G is
    the largest power of two, at most a warp, that leaves each lane at least
    SAMPLE_LANE_CHANNELS[unit] channels (1 lane at C < 32, 4 at C 64, 8 at
    C 257); units as `dpoints_layout`'s, and lane l owns units l, l + G,
    l + 2G, ... A lane holds up to 4 float4 or 8 single channels of
    accumulators at a time."""
    vec = 4 if C % 4 == 0 else 1
    return min(5, max(0, (C // SAMPLE_LANE_CHANNELS[vec]).bit_length() - 1)), vec


# K5's layout, the same at every C: a block stages 2^6 = 64 consecutive
# points' corners and cotangent rows (at most 256 floats of each row; a
# second chunk of blocks takes the rest, C 257), and a thread per (unit,
# corner, run of 2^5 = 32 points) adds one atomic each time its corner's
# cell changes along the run; units as `dpoints_layout`'s. Of tiles 32..256
# and runs 8..32 at C 64 on an H100 (`kernel_sweep.py` k5), the fastest on
# ray-ordered points, as training passes hold them; on uniformly random
# points, where runs merge nothing, within 3 % of the best
DGRID_TILE_LOG2, DGRID_RUN_LOG2 = 6, 5


def check_flat_index(grid_shape) -> None:
    """The sampling kernels (and the fused decode) index the grid with
    32-bit offsets."""
    n = 1
    for d in grid_shape:
        n *= int(d)
    if n > KERNEL_MAX_GC:
        raise ValueError(f"grid {tuple(grid_shape)} has {n} elements: 32-bit offsets take < 2**31")


def check_operands(points: torch.Tensor, C: int, grid=None, g=None) -> None:
    """Raise on what the sampling kernels do not take: float32 tensors on
    the points' device, (N, 3) points, a (D, H, W, C) grid and an (N, C)
    cotangent."""
    dev = points.device
    for name, t in (("points", points), ("grid", grid), ("g", g)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, points on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if points.dim() != 2 or points.shape[1] != 3:
        raise ValueError(f"points {tuple(points.shape)} must be (N, 3)")
    if grid is not None and (grid.dim() != 4 or grid.shape[-1] != C):
        raise ValueError(f"grid {tuple(grid.shape)} must be (D, H, W, {C})")
    if g is not None and tuple(g.shape) != (points.shape[0], C):
        raise ValueError(f"cotangent {tuple(g.shape)} must be ({points.shape[0]}, {C})")


def _launch(name: str, pointers, grid_shape, n: int, extent: float, *tail, device, layout_log2: int):
    """Launch entry point `name`; `layout_log2` is log2 of the lanes per
    point (K4, K6) or of K5's run."""
    D, H, W, C = grid_shape
    _build.launch(name, *pointers, n, D, H, W, C, layout_log2, float(extent) / D, *tail, device=device, C=C)


def _fwd_cuda(grid, points, extent):
    check_operands(points, grid.shape[-1], grid=grid)
    check_flat_index(grid.shape)
    grid, points = grid.contiguous(), points.contiguous()
    out = torch.empty((points.shape[0], grid.shape[-1]), dtype=torch.float32, device=points.device)
    if points.shape[0] > 0:
        _launch("kron_sample_fwd", (points.data_ptr(), grid.data_ptr(), out.data_ptr()),
                grid.shape, points.shape[0], extent, device=points.device,
                layout_log2=sample_layout(grid.shape[-1])[0])
    return out


def _dgrid_cuda(points, g, grid_shape, extent):
    check_operands(points, grid_shape[-1], g=g)
    check_flat_index(grid_shape)
    points, g = points.contiguous(), g.contiguous()
    # the kernel adds into a zeroed grid with atomics
    d_grid = torch.zeros(tuple(grid_shape), dtype=torch.float32, device=points.device)
    if points.shape[0] > 0:
        _launch("kron_sample_dgrid", (points.data_ptr(), g.data_ptr(), d_grid.data_ptr()),
                grid_shape, points.shape[0], extent, DGRID_TILE_LOG2, device=points.device,
                layout_log2=DGRID_RUN_LOG2)
    return d_grid


def _dpoints_cuda(grid, points, g, extent):
    check_operands(points, grid.shape[-1], grid=grid, g=g)
    check_flat_index(grid.shape)
    grid, points = grid.contiguous(), points.contiguous()
    g = None if g is None else g.contiguous()
    out = torch.empty(points.shape, dtype=torch.float32, device=points.device)
    if points.shape[0] > 0:
        # a null cotangent is the all-ones one, never materialised
        g_ptr = None if g is None else g.data_ptr()
        _launch("kron_sample_dpoints", (points.data_ptr(), g_ptr, grid.data_ptr(), out.data_ptr()),
                grid.shape, points.shape[0], extent, grid.shape[0] / float(extent), device=points.device,
                layout_log2=dpoints_layout(grid.shape[-1])[0])
    return out


def kron_sample_fwd(grid: torch.Tensor, points: torch.Tensor, extent: float) -> torch.Tensor:
    """K4: grid (D, H, W, C), points (N, 3) -> (N, C)."""
    if _build.on_cpu(points):
        return kron_sample_fwd_reference(grid, points, extent)
    return _fwd_cuda(grid, points, extent)


def kron_sample_dgrid(points: torch.Tensor, g: torch.Tensor, grid_shape, extent: float) -> torch.Tensor:
    """K5: the grid cotangent (D, H, W, C) from g (N, C). The kernel sums
    with float atomics, so its result is not bit-reproducible."""
    if _build.on_cpu(points):
        return kron_sample_dgrid_reference(points, g, grid_shape, extent)
    return _dgrid_cuda(points, g, grid_shape, extent)


def kron_sample_dpoints(
    grid: torch.Tensor, points: torch.Tensor, g: Optional[torch.Tensor], extent: float
) -> torch.Tensor:
    """K6: the points cotangent (N, 3) from g (N, C), or from all ones."""
    if _build.on_cpu(points):
        return kron_sample_dpoints_reference(grid, points, g, extent)
    return _dpoints_cuda(grid, points, g, extent)


class KronSample(torch.autograd.Function):
    """K4 forward; backward K5 for the grid and K6 for the points, each
    launched only when its input needs a gradient. First order only."""

    @staticmethod
    def forward(ctx, grid, points, extent):
        ctx.save_for_backward(grid, points)
        ctx.extent = extent
        return kron_sample_fwd(grid, points, extent)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        grid, points = ctx.saved_tensors
        d_grid = d_points = None
        if ctx.needs_input_grad[0]:
            d_grid = kron_sample_dgrid(points, g, grid.shape, ctx.extent)
        if ctx.needs_input_grad[1]:
            d_points = kron_sample_dpoints(grid, points, g, ctx.extent)
        return d_grid, d_points, None


def trilinear_sample_fused(
    grid: torch.Tensor,
    points: torch.Tensor,
    extent: float,
    block_n: int = 512,
    interpret: bool = False,
    precision: str = "highest",
) -> torch.Tensor:
    """Trilinear world-space sampling: grid (D, H, W, C), points (..., 3)
    world xyz -> (..., C) float32, zero outside the grid (grid_sample zero
    padding, align_corners=True); differentiable in grid and points.
    `block_n`, `interpret` and `precision` are the JAX signature's and have
    no effect (module docstring)."""
    shape = points.shape[:-1]
    grid = grid.float()
    flat = points.reshape(-1, 3).float()
    if torch.is_grad_enabled() and (grid.requires_grad or flat.requires_grad):
        out = KronSample.apply(grid, flat, float(extent))
    else:
        out = kron_sample_fwd(grid, flat, float(extent))
    return out.reshape(*shape, grid.shape[-1])


def trilinear_point_gradient(
    grid: torch.Tensor,
    points: torch.Tensor,
    extent: float,
    block_n: int = 512,
    interpret: bool = False,
    precision: str = "highest",
) -> torch.Tensor:
    """d/d(points) of `trilinear_sample_fused(grid, points).sum(-1)` as one
    direct K6 launch with the all-ones cotangent. Grid and points are
    treated as constants: the result carries no gradient (its one consumer
    is the normals output). grid (D, H, W, C), points (..., 3) -> (..., 3)."""
    shape = points.shape[:-1]
    flat = points.detach().reshape(-1, 3).float()
    return kron_sample_dpoints(grid.detach().float(), flat, None, float(extent)).reshape(*shape, 3)
