"""Trilinear world-space sampling by the one-hot corner formulation (port of
holo_diffusion_tpu/ops/pallas/fused_render.py), forward only.

`trilinear_sample_pallas` launches the CUDA kernel `trilinear_sample_onehot`
of `csrc/fused_render.cu` (K7) for CUDA tensors, or raises; for CPU tensors
it runs the plain version `trilinear_sample_onehot_reference`. On the TPU
the kernel is a one-hot matrix product on the MXU; on the H100 it is an
8-corner gather on K4's layout (`kron_sample.sample_layout`; see the CUDA
source). It has no backward, as the JAX
function has no VJP: asking it for a gradient raises.
`trilinear_sample_onehot_xla` is the one-hot product itself in plain
PyTorch, as the JAX package keeps it in plain XLA.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .kron_sample import check_flat_index, check_operands, on_cpu, sample_layout
from .voxel import continuous_indices, sample_voxel_grid_world

ENTRY_POINTS = ("trilinear_sample_onehot",)

_launches: Dict[str, int] = {name: 0 for name in ENTRY_POINTS}


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def trilinear_sample_onehot_reference(grid: torch.Tensor, points: torch.Tensor, extent: float) -> torch.Tensor:
    """Plain version of the kernel: floor/fraction weights, clipped cells, 0
    for a corner outside (the gather sampler's arithmetic)."""
    return sample_voxel_grid_world(grid, points, extent)


def _library():
    from . import _build

    lib = _build.load("fused_render")
    if not getattr(lib, "_argtypes_set", False):
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.trilinear_sample_onehot.argtypes = [ptr, ptr, ptr, i64, i32, i32, i32, i32, i32, f32, ptr]
        lib.trilinear_sample_onehot.restype = i32
        lib._argtypes_set = True
    return lib


def _sample_cuda(grid: torch.Tensor, points: torch.Tensor, extent: float) -> torch.Tensor:
    D, H, W, C = grid.shape
    check_operands(points, C, grid=grid)
    check_flat_index(grid.shape)
    grid, points = grid.contiguous(), points.contiguous()
    n = points.shape[0]
    out = torch.empty((n, C), dtype=torch.float32, device=points.device)
    if n > 0:
        with torch.cuda.device(points.device):
            stream = torch.cuda.current_stream(points.device).cuda_stream
            err = _library().trilinear_sample_onehot(
                points.data_ptr(), grid.data_ptr(), out.data_ptr(), n, D, H, W, C,
                sample_layout(C)[0], float(extent) / D, stream)
        if err != 0:
            raise RuntimeError(f"trilinear_sample_onehot launch failed: cudaError {err}")
        if not torch.cuda.is_current_stream_capturing():
            _launches["trilinear_sample_onehot"] += 1
    return out


def trilinear_sample_pallas(
    grid: torch.Tensor,
    points: torch.Tensor,
    extent: float,
    block_n: int = 256,
    interpret: bool = False,
) -> torch.Tensor:
    """grid (D, H, W, C), points (..., 3) world xyz -> (..., C) float32,
    zero outside the grid. Forward only: raises when grad mode is on and an
    input requires grad. `block_n` and `interpret` are the JAX signature's
    and have no effect."""
    if torch.is_grad_enabled() and (grid.requires_grad or points.requires_grad):
        raise RuntimeError(
            "trilinear_sample_pallas is forward only (the kernel has no backward, "
            "as the JAX function has no VJP); use sampler='fused' to differentiate")
    shape = points.shape[:-1]
    flat = points.reshape(-1, 3)
    if on_cpu(flat):
        out = trilinear_sample_onehot_reference(grid, flat, extent)
    else:
        out = _sample_cuda(grid, flat, extent)
    return out.reshape(*shape, grid.shape[-1])


def trilinear_sample_onehot_xla(
    grid: torch.Tensor, points: torch.Tensor, extent: float, block_n: int = 1024
) -> torch.Tensor:
    """The one-hot product in plain PyTorch, `block_n` points at a time:
    each block's (block_n, D*H*W) weight matrix, 8 non-zeros per row, times
    the flattened grid."""
    D, H, W, C = grid.shape
    G = D * H * W
    shape = points.shape[:-1]
    pts = points.reshape(-1, 3)
    flat = grid.reshape(G, C)
    cols = torch.arange(G, device=grid.device)
    blocks = []
    for p in pts.split(block_n):
        ix, iy, iz = continuous_indices(p, D, H, W, extent)
        x0, y0, z0 = torch.floor(ix), torch.floor(iy), torch.floor(iz)
        fx, fy, fz = ix - x0, iy - y0, iz - z0
        wm = torch.zeros((p.shape[0], G), dtype=grid.dtype, device=grid.device)
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    xi, yi, zi = x0 + dx, y0 + dy, z0 + dz
                    w = (fx if dx else 1.0 - fx) * (fy if dy else 1.0 - fy) * (fz if dz else 1.0 - fz)
                    inside = ((xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
                              & (zi >= 0) & (zi <= D - 1))
                    lin = (zi.clamp(0, D - 1) * H + yi.clamp(0, H - 1)) * W + xi.clamp(0, W - 1)
                    wm = wm + (cols == lin.long()[:, None]) * (w * inside)[:, None]
        blocks.append(wm @ flat)
    out = torch.cat(blocks) if blocks else pts.new_zeros((0, C))
    return out.reshape(*shape, C)
