"""One-kernel render decode: trilinear sample + density affine + radiance head
(port of holo_diffusion_tpu/ops/pallas/fused_decode.py), forward and backward.

`fused_sample_decode` launches the CUDA kernels of `csrc/fused_decode.cu`
(forward) and `csrc/fused_decode_bwd.cu` (backward) at C 32 and 64, and of
`csrc/fused_decode_c128.cu` (both) at C 128, for CUDA tensors and raises
when it cannot; for CPU tensors it runs the plain PyTorch versions
`fused_sample_decode_reference` and `fused_sample_decode_bwd_reference`,
which are also what the card is checked against. When an input requires
grad, the call goes through `FusedSampleDecode`, a `torch.autograd.Function`
whose backward is the backward kernel (the `jax.custom_vjp` of the JAX
package). Each entry point counts its launches
(`launch_counts`/`reset_launch_counts`), and by channel count
(`launch_counts_by_channels`). A call made while a CUDA graph captures
(`render_eval.py`) counts nothing: its kernel launches at each replay,
which a device trace sees and these counters do not.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.profiling import span
from .kron_sample import check_flat_index, kron_sample_dpoints_reference
from .voxel import continuous_indices, sample_voxel_grid_world

NEG_SLOPE = 0.2  # torch.nn.LeakyReLU(0.2)
# dynamic shared memory one block may opt into on sm_90 (H100), in bytes
SMEM_OPTIN_BYTES = 232_448
ENTRY_POINTS = ("fused_decode_fwd", "fused_decode_fwd_normals", "fused_decode_bwd")
# by channel count, each entry point's (library under csrc/, C function)
_C64_FUNCTIONS = {"fused_decode_fwd": ("fused_decode", "fused_decode_fwd"),
                  "fused_decode_fwd_normals": ("fused_decode", "fused_decode_fwd_normals"),
                  "fused_decode_bwd": ("fused_decode_bwd", "fused_decode_bwd")}
KERNEL_FUNCTIONS = {
    32: _C64_FUNCTIONS,
    64: _C64_FUNCTIONS,
    128: {"fused_decode_fwd": ("fused_decode_c128", "decode_c128_fwd"),
          "fused_decode_fwd_normals": ("fused_decode_c128", "decode_c128_fwd_normals"),
          "fused_decode_bwd": ("fused_decode_c128", "decode_c128_bwd")},
}
SUPPORTED_CHANNELS = tuple(KERNEL_FUNCTIONS)  # the channel counts the CUDA sources are built for

_launches: Dict[str, int] = {name: 0 for name in ENTRY_POINTS}
# the same launches by channel count, keyed "<entry point>@C<C>"
_launches_by_channels: Dict[str, int] = {}


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def launch_counts_by_channels() -> Dict[str, int]:
    return dict(_launches_by_channels)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0
    _launches_by_channels.clear()


def _count_launch(name: str, C: int) -> None:
    if torch.cuda.is_current_stream_capturing():
        return
    _launches[name] += 1
    key = f"{name}@C{C}"
    _launches_by_channels[key] = _launches_by_channels.get(key, 0) + 1


def fwd_smem_bytes(C: int, hidden: int, pe_dim: int) -> int:
    """Dynamic shared memory of K1/K3: at C 32 and 64 (`csrc/fused_decode.cu`
    `Layout`) A split into TF32 hi/lo, c, the radiance rows, pe rows, br,
    and 16 warps' 16-point s tiles; at C 128 (`csrc/fused_decode_c128.cu`
    `FwdLayout`) A unsplit and 8 warps' s tiles."""
    n_cols = -(-(hidden + 1) // 16) * 16
    a_words, warps = (C * n_cols, 8) if C == 128 else (2 * C * n_cols, 16)
    return 4 * (a_words + n_cols + 4 * n_cols + 4 * pe_dim + 4 + warps * 16 * (C + 4))


def bwd_smem_bytes(C: int, hidden: int, pe_dim: int) -> int:
    """Dynamic shared memory of K2, 32-point tiles: at C 32 and 64
    (`csrc/fused_decode_bwd.cu` `Layout`) A split, the s tile split and two
    d_s buffers; at C 128 (`csrc/fused_decode_c128.cu` `BwdLayout`) each of
    the three unsplit and single."""
    n_cols, tile = -(-(hidden + 1) // 8) * 8, 32
    copies = 1 if C == 128 else 2
    words = (copies * C * n_cols + n_cols + -(-(3 * (hidden + pe_dim + 1)) // 4) * 4
             + copies * tile * (C + 4) + tile * (n_cols + 4) + copies * tile * (C + 4)
             + 2 * 2 * 8 * tile + 2 * 4 * tile + -(-(tile * pe_dim) // 4) * 4)
    return 4 * words


def kernels_take(C: int, hidden: int, pe_dim: int) -> bool:
    """True where K1, K3 and K2 all launch: C is one the kernels are built
    for, both layouts fit a block's shared memory, and K2's column checks
    hold (`launch`: hidden + 1 padded to 8 at most 320 columns, 272 at C
    128, and a thread each for the columns, the pe rows and dbr of its
    512). At pe_dim 27 that is hidden <= 279 at C 64, <= 319 at C 32, <= 271
    at C 128."""
    n_cols = -(-(hidden + 1) // 8) * 8
    return (C in SUPPORTED_CHANNELS
            and fwd_smem_bytes(C, hidden, pe_dim) <= SMEM_OPTIN_BYTES
            and bwd_smem_bytes(C, hidden, pe_dim) <= SMEM_OPTIN_BYTES
            and n_cols <= (272 if C == 128 else 320) and n_cols + pe_dim + 1 <= 512)


def _lrelu(x):
    return F.leaky_relu(x, NEG_SLOPE)


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
    # the field's spatial gradient: K6's plain version at C = 1, ones cotangent
    grads = kron_sample_dpoints_reference(g1[..., None], points.reshape(-1, 3), None, extent)
    return densities, rgb, grads.reshape(points.shape)


def _dlrelu(x):
    # slope 1 at exactly 0, as the TPU kernel's `_dlrelu` (torch's
    # leaky_relu backward takes 0.2 there)
    return torch.where(x >= 0, torch.ones_like(x), torch.full_like(x, NEG_SLOPE))


def _corner_weights(points_world: torch.Tensor, D: int, H: int, W: int, extent: float):
    """Flat grid cells (..., 8) and trilinear weights (..., 8) of the 8
    corners of each point; a corner outside the grid gets weight 0 (its cell
    index is clamped only so that it stays a valid index)."""
    ix, iy, iz = continuous_indices(points_world, D, H, W, extent)
    x0, y0, z0 = torch.floor(ix), torch.floor(iy), torch.floor(iz)
    fx, fy, fz = ix - x0, iy - y0, iz - z0
    cells, weights = [], []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi, zi = x0 + dx, y0 + dy, z0 + dz
                inside = (
                    (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
                    & (zi >= 0) & (zi <= D - 1)
                )
                w = (fx if dx else 1.0 - fx) * (fy if dy else 1.0 - fy) * (fz if dz else 1.0 - fz)
                weights.append(w * inside)
                cells.append(
                    ((zi.clamp(0, D - 1) * H + yi.clamp(0, H - 1)) * W + xi.clamp(0, W - 1)).long()
                )
    return torch.stack(cells, dim=-1), torch.stack(weights, dim=-1)


def fused_sample_decode_bwd_reference(
    grid: torch.Tensor,
    A: torch.Tensor,
    c: torch.Tensor,
    Wr: torch.Tensor,
    br: torch.Tensor,
    points: torch.Tensor,
    pe_dirs: torch.Tensor,
    extent: float,
    hidden: int,
    g: torch.Tensor,
):
    """Plain PyTorch version of the backward kernel, step by step as it
    computes: the cotangents (d_grid, dA, dc, dWr, dbr) of
    `fused_sample_decode`'s inputs from the cotangent g (..., P, 4+) =
    [d_density | d_rgb | ...] of its outputs. Lanes past 4 (the normals)
    carry no gradient; points and pe_dirs get none."""
    D, H, W, C = grid.shape
    n_out, pe_dim = A.shape[1], pe_dirs.shape[-1]
    pts = points.reshape(-1, 3)
    pe = pe_dirs[..., None, :].expand(*points.shape[:-1], pe_dim).reshape(-1, pe_dim)
    g = g.reshape(-1, g.shape[-1])
    cells, w = _corner_weights(pts, D, H, W, extent)
    flat = grid.reshape(-1, C)
    # 1. recompute the forward
    s = (flat[cells] * w[..., None]).sum(dim=1)
    pre = s @ A + c
    rin = torch.cat([_lrelu(pre[:, :hidden]), pe], dim=-1)
    rpre = rin @ Wr + br
    rgb = torch.sigmoid(_lrelu(rpre))
    # 2. radiance head
    d_rpre = g[:, 1:4] * rgb * (1.0 - rgb) * _dlrelu(rpre)
    dWr = rin.t() @ d_rpre
    dbr = d_rpre.sum(dim=0)
    d_rin = d_rpre @ Wr.t()
    # 3. density affine
    d_h = torch.cat([d_rin[:, :hidden], g[:, 0:1], d_rin.new_zeros((d_rin.shape[0], n_out - hidden - 1))], dim=-1)
    d_pre = d_h * _dlrelu(pre)
    dA = s.t() @ d_pre
    dc = d_pre.sum(dim=0)
    d_s = d_pre @ A.t()
    # 4. scatter into the grid (outside corners add 0)
    d_grid = torch.zeros_like(flat).index_add_(
        0, cells.reshape(-1), (w[..., None] * d_s[:, None, :]).reshape(-1, C)
    )
    return d_grid.reshape(grid.shape), dA, dc, dWr, dbr


def _kernel_function(name: str, C: int):
    """The C function that launches entry point `name` at C channels
    (`KERNEL_FUNCTIONS`; the same arguments at every C)."""
    from . import _build

    lib, fn = KERNEL_FUNCTIONS[C][name]
    f = getattr(_build.load(lib), fn)
    if not getattr(f, "_argtypes_set", False):
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        dims = [i64, i32, i32, i32, i32, i32, i32, i32, i32]
        if name == "fused_decode_bwd":
            f.argtypes = [ptr] * 12 + dims + [f32, ptr]
        else:
            f.argtypes = [ptr] * (8 if name == "fused_decode_fwd" else 9) + dims + [f32, f32, ptr]
        f.restype = i32
        f._argtypes_set = True
    return f


def _kernel_operands(grid, A, c, Wr, br, points, pe_dirs, hidden, **extra):
    """Check what the kernels take and lay the operands out for them:
    contiguous float32 on the points' device, A and c zero-padded to a
    multiple of 4 columns, points (n, 3), pe (n_rays, pe_dim)."""
    dev = points.device
    tensors = {"grid": grid, "A": A, "c": c, "Wr": Wr, "br": br,
               "points": points, "pe_dirs": pe_dirs, **extra}
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
    grid_c = grid.contiguous()
    if grid_c.data_ptr() % 16:
        # the kernels read each grid cell's channels as float4
        raise ValueError("grid must start on a 16-byte boundary")
    j_pad = -(-n_out // 4) * 4
    ops = dict(
        grid=grid_c, A=F.pad(A, (0, j_pad - n_out)).contiguous(),
        c=F.pad(c, (0, j_pad - n_out)).contiguous(), Wr=Wr.contiguous(), br=br.contiguous(),
        points=points.reshape(-1, 3).contiguous(), pe=pe_dirs.reshape(-1, pe_dim).contiguous(),
    )
    dims = [ops["points"].shape[0], points.shape[-2], D, H, W, C, j_pad, hidden, pe_dim]
    return ops, dims


def _fused_sample_decode_cuda(grid, A, c, Wr, br, points, pe_dirs, extent, hidden, g1):
    extra = {} if g1 is None else {"g1": g1}
    ops, dims = _kernel_operands(grid, A, c, Wr, br, points, pe_dirs, hidden, **extra)
    check_flat_index(grid.shape)
    D, H, W = grid.shape[:3]
    if g1 is not None and g1.shape != (D, H, W):
        raise ValueError(f"g1 {tuple(g1.shape)} must be {(D, H, W)}")
    n = dims[0]
    lanes = 4 if g1 is None else 7
    out = torch.empty((n, lanes), dtype=torch.float32, device=points.device)
    if n == 0:
        return _split_lanes(out.reshape(*points.shape[:-1], lanes))
    C = dims[5]
    name = "fused_decode_fwd" if g1 is None else "fused_decode_fwd_normals"
    launch = _kernel_function(name, C)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        head = [ops[k].data_ptr() for k in ("points", "pe", "grid", "A", "c", "Wr", "br")]
        tail = dims + [float(extent) / D, D / float(extent), stream]
        if g1 is None:
            err = launch(*head, out.data_ptr(), *tail)
        else:
            g1_c = g1.contiguous()
            err = launch(*head, g1_c.data_ptr(), out.data_ptr(), *tail)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    _count_launch(name, C)
    return _split_lanes(out.reshape(*points.shape[:-1], lanes))


def _fused_sample_decode_bwd_cuda(grid, A, c, Wr, br, points, pe_dirs, extent, hidden, g):
    """Launch the backward kernel; same arguments and results as
    `fused_sample_decode_bwd_reference`."""
    if g.shape[:-1] != points.shape[:-1] or g.shape[-1] < 4:
        raise ValueError(f"cotangent {tuple(g.shape)} does not match points {tuple(points.shape)}")
    ops, dims = _kernel_operands(grid, A, c, Wr, br, points, pe_dirs, hidden, g=g)
    n, C, j_pad, pe_dim = dims[0], dims[5], dims[6], dims[8]
    dev = points.device
    g4 = g.reshape(n, -1)[:, :4].contiguous()
    # the kernel accumulates into zeroed outputs; dWr's last row is dbr
    d_grid = torch.zeros_like(ops["grid"])
    dA = torch.zeros((C, j_pad), dtype=torch.float32, device=dev)
    dc = torch.zeros((j_pad,), dtype=torch.float32, device=dev)
    dWr = torch.zeros((hidden + pe_dim + 1, 3), dtype=torch.float32, device=dev)
    if n > 0:
        launch = _kernel_function("fused_decode_bwd", C)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = launch(
                ops["points"].data_ptr(), ops["pe"].data_ptr(), g4.data_ptr(),
                *(ops[k].data_ptr() for k in ("grid", "A", "c", "Wr", "br")),
                d_grid.data_ptr(), dA.data_ptr(), dc.data_ptr(), dWr.data_ptr(),
                *dims, float(extent) / grid.shape[0], stream,
            )
        if err != 0:
            raise RuntimeError(f"fused_decode_bwd launch failed: cudaError {err}")
        _count_launch("fused_decode_bwd", C)
    n_out = hidden + 1
    return d_grid, dA[:, :n_out], dc[:n_out], dWr[:-1], dWr[-1]


def _split_lanes(out):
    """(..., 4 or 7) kernel output -> (density, rgb[, field gradient])."""
    if out.shape[-1] == 4:
        return out[..., 0:1], out[..., 1:4]
    return out[..., 0:1], out[..., 1:4], out[..., 4:7]


def _device_checked(points: torch.Tensor) -> str:
    if points.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no fused_decode kernel for {points.device}")
    return points.device.type


def _forward(grid, A, c, Wr, br, points, pe_dirs, extent, hidden, g1):
    args = (grid, A, c, Wr, br, points, pe_dirs, extent, hidden, g1)
    if _device_checked(points) == "cpu":
        return fused_sample_decode_reference(*args)
    return _fused_sample_decode_cuda(*args)


def _backward(grid, A, c, Wr, br, points, pe_dirs, extent, hidden, g):
    args = (grid, A, c, Wr, br, points, pe_dirs, extent, hidden, g)
    if _device_checked(points) == "cpu":
        return fused_sample_decode_bwd_reference(*args)
    return _fused_sample_decode_bwd_cuda(*args)


class FusedSampleDecode(torch.autograd.Function):
    """The forward kernel (K1, or K3 with g1) joined to the backward kernel:
    gradients for grid, A, c, Wr and br; none for points, pe_dirs and g1,
    and the normals output is not differentiable (its cotangent is dropped,
    as in the JAX package's custom VJP)."""

    @staticmethod
    def forward(ctx, grid, A, c, Wr, br, points, pe_dirs, extent, hidden, g1):
        out = _forward(grid, A, c, Wr, br, points, pe_dirs, extent, hidden, g1)
        ctx.save_for_backward(grid, A, c, Wr, br, points, pe_dirs)
        ctx.extent, ctx.hidden = extent, hidden
        if g1 is not None:
            ctx.mark_non_differentiable(out[2])
        return out

    @staticmethod
    def backward(ctx, d_density, d_rgb, *unused):
        with span("holo.decode.bwd"):
            grid, A, c, Wr, br, points, pe_dirs = ctx.saved_tensors
            g = torch.cat([d_density, d_rgb], dim=-1)
            grads = _backward(grid, A, c, Wr, br, points, pe_dirs, ctx.extent, ctx.hidden, g)
        return (*grads, None, None, None, None, None)


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
    grid @ A[:, -1] also the field's spatial gradient (..., P, 3), which
    carries no gradient. Differentiable in grid, A, c, Wr and br.
    CUDA tensors launch the kernels (or raise); CPU tensors take the plain
    versions.
    """
    args = (grid, A, c, Wr, br, points, pe_dirs, extent, hidden, g1)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (grid, A, c, Wr, br)):
        _device_checked(points)
        return FusedSampleDecode.apply(*args)
    return _forward(*args)
