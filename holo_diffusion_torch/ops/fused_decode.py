"""One-kernel render decode: trilinear sample + density affine + radiance head
(port of holo_diffusion_tpu/ops/pallas/fused_decode.py, forward only).

`fused_sample_decode` launches the CUDA kernel of `csrc/fused_decode.cu` for
CUDA tensors and raises when it cannot; for CPU tensors it runs the plain
PyTorch version `fused_sample_decode_reference`, which is also what the card
is checked against. Each entry point counts its launches
(`launch_counts`/`reset_launch_counts`).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .voxel import continuous_indices, sample_voxel_grid_world

NEG_SLOPE = 0.2  # torch.nn.LeakyReLU(0.2)
SUPPORTED_CHANNELS = (32, 64)  # template instantiations in the CUDA source
ENTRY_POINTS = ("fused_decode_fwd", "fused_decode_fwd_normals")

_launches: Dict[str, int] = {name: 0 for name in ENTRY_POINTS}


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def _lrelu(x):
    return F.leaky_relu(x, NEG_SLOPE)


def _hat_grad(d):
    # d/di relu(1 - |i - q|) = -sign(i - q) inside the hat, 0 outside
    return torch.where(d.abs() < 1.0, -torch.sign(d), torch.zeros_like(d))


def trilinear_gradient(
    field: torch.Tensor, points_world: torch.Tensor, extent: float
) -> torch.Tensor:
    """Analytic spatial gradient of the scalar trilinear field (D, H, W) at
    world points (..., 3) -> (..., 3); zero outside the grid."""
    D, H, W = field.shape
    ix, iy, iz = continuous_indices(points_world, D, H, W, extent)
    x0, y0, z0 = torch.floor(ix), torch.floor(iy), torch.floor(iz)
    flat = field.reshape(-1)
    g = torch.zeros(points_world.shape, dtype=field.dtype, device=field.device)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi, zi = x0 + dx, y0 + dy, z0 + dz
                ex, ey, ez = ix - xi, iy - yi, iz - zi
                hx, hy, hz = [torch.clamp(1.0 - e.abs(), min=0.0) for e in (ex, ey, ez)]
                inside = (
                    (xi >= 0) & (xi <= W - 1)
                    & (yi >= 0) & (yi <= H - 1)
                    & (zi >= 0) & (zi <= D - 1)
                )
                lin = (
                    (zi.clamp(0, D - 1) * H + yi.clamp(0, H - 1)) * W
                    + xi.clamp(0, W - 1)
                ).long()
                v = flat[lin] * inside
                g = g + torch.stack(
                    [hz * hy * _hat_grad(ex), hz * _hat_grad(ey) * hx,
                     _hat_grad(ez) * hy * hx],
                    dim=-1,
                ) * v[..., None]
    return g * (D / extent)


def fused_sample_decode_reference(
    grid: torch.Tensor,
    A: torch.Tensor,
    c: torch.Tensor,
    Wr: torch.Tensor,
    br: torch.Tensor,
    points: torch.Tensor,
    pe_dirs: torch.Tensor,
    extent: float,
    hidden: int,
    g1: Optional[torch.Tensor] = None,
):
    """Plain PyTorch version of the kernel; same arguments and outputs as
    `fused_sample_decode`."""
    s = sample_voxel_grid_world(grid, points, extent)
    pre = s @ A + c
    h_all = _lrelu(pre)
    pe = pe_dirs[..., None, :].expand(*points.shape[:-1], pe_dirs.shape[-1])
    rin = torch.cat([h_all[..., :hidden], pe], dim=-1)
    rgb = torch.sigmoid(_lrelu(rin @ Wr + br))
    densities = h_all[..., hidden:hidden + 1]
    if g1 is None:
        return densities, rgb
    return densities, rgb, trilinear_gradient(g1, points, extent)


def _library():
    from . import _build

    lib = _build.load("fused_decode")
    if not getattr(lib, "_argtypes_set", False):
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        head = [ptr] * 7
        tail = [i64, i32, i32, i32, i32, i32, i32, i32, i32, f32, f32, ptr]
        lib.fused_decode_fwd.argtypes = head + [ptr] + tail
        lib.fused_decode_fwd_normals.argtypes = head + [ptr, ptr] + tail
        lib.fused_decode_fwd.restype = i32
        lib.fused_decode_fwd_normals.restype = i32
        lib._argtypes_set = True
    return lib


def _fused_sample_decode_cuda(grid, A, c, Wr, br, points, pe_dirs, extent, hidden, g1):
    dev = points.device
    tensors = {"grid": grid, "A": A, "c": c, "Wr": Wr, "br": br,
               "points": points, "pe_dirs": pe_dirs}
    if g1 is not None:
        tensors["g1"] = g1
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, points on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    D, H, W, C = grid.shape
    if C not in SUPPORTED_CHANNELS:
        raise NotImplementedError(
            f"fused_decode kernel is built for C in {SUPPORTED_CHANNELS}, got {C}"
        )
    n_out = hidden + 1
    pe_dim = pe_dirs.shape[-1]
    if A.shape != (C, n_out) or c.shape != (n_out,):
        raise ValueError(f"A {tuple(A.shape)} / c {tuple(c.shape)} do not match C={C}, hidden={hidden}")
    if Wr.shape != (hidden + pe_dim, 3) or br.shape != (3,):
        raise ValueError(f"Wr {tuple(Wr.shape)} / br {tuple(br.shape)} do not match hidden + pe_dim")
    if pe_dirs.shape[:-1] != points.shape[:-2]:
        raise ValueError(
            f"pe_dirs {tuple(pe_dirs.shape)} must be per ray of points {tuple(points.shape)}"
        )
    if g1 is not None and g1.shape != (D, H, W):
        raise ValueError(f"g1 {tuple(g1.shape)} must be {(D, H, W)}")

    j_pad = -(-n_out // 4) * 4
    A_p = F.pad(A, (0, j_pad - n_out)).contiguous()
    c_p = F.pad(c, (0, j_pad - n_out)).contiguous()
    pts = points.reshape(-1, 3).contiguous()
    pe = pe_dirs.reshape(-1, pe_dim).contiguous()
    grid_c, Wr_c, br_c = grid.contiguous(), Wr.contiguous(), br.contiguous()
    if grid_c.data_ptr() % 16:
        # the kernel reads each grid cell's channels as float4
        raise ValueError("grid must start on a 16-byte boundary")
    n = pts.shape[0]
    lanes = 4 if g1 is None else 7
    out = torch.empty((n, lanes), dtype=torch.float32, device=dev)
    if n == 0:
        return _split_lanes(out.reshape(*points.shape[:-1], lanes))
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        head = [pts.data_ptr(), pe.data_ptr(), grid_c.data_ptr(), A_p.data_ptr(),
                c_p.data_ptr(), Wr_c.data_ptr(), br_c.data_ptr()]
        tail = [n, points.shape[-2], D, H, W, C, j_pad, hidden, pe_dim,
                float(extent) / D, D / float(extent), stream]
        if g1 is None:
            name = "fused_decode_fwd"
            err = lib.fused_decode_fwd(*head, out.data_ptr(), *tail)
        else:
            name = "fused_decode_fwd_normals"
            g1_c = g1.contiguous()
            err = lib.fused_decode_fwd_normals(*head, g1_c.data_ptr(), out.data_ptr(), *tail)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    _launches[name] += 1
    return _split_lanes(out.reshape(*points.shape[:-1], lanes))


def _split_lanes(out):
    """(..., 4 or 7) kernel output -> (density, rgb[, field gradient])."""
    if out.shape[-1] == 4:
        return out[..., 0:1], out[..., 1:4]
    return out[..., 0:1], out[..., 1:4], out[..., 4:7]


def fused_sample_decode(
    grid: torch.Tensor,
    A: torch.Tensor,
    c: torch.Tensor,
    Wr: torch.Tensor,
    br: torch.Tensor,
    points: torch.Tensor,
    pe_dirs: torch.Tensor,
    extent: float,
    hidden: int,
    g1: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """One-kernel render decode.

    grid: (D, H, W, C); A: (C, hidden+1) collapsed density affine; c:
    (hidden+1,); Wr: (hidden + pe_dim, 3) radiance kernel; br: (3,); points:
    (..., P, 3) world points, P per ray; pe_dirs: (..., pe_dim) harmonic-
    embedded unit view direction of each ray, shared by its P points.
    Returns (densities (..., P, 1), rgb (..., P, 3)); with g1 (D, H, W) =
    grid @ A[:, -1] also the field's spatial gradient (..., P, 3).
    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version.
    """
    args = (grid, A, c, Wr, br, points, pe_dirs, extent, hidden, g1)
    if points.device.type == "cpu":
        return fused_sample_decode_reference(*args)
    if points.device.type != "cuda":
        raise NotImplementedError(f"no fused_decode kernel for {points.device}")
    return _fused_sample_decode_cuda(*args)
