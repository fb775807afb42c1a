"""The view pooler's sampler: every (S, h, w, c) feature map sampled
bilinearly at each source view's projected points, zero outside the map
(Implicitron's ViewSampler; the port's K8).

`view_sample` launches the CUDA kernels of `csrc/view_sample.cu` for CUDA
tensors, all maps and views in one launch (`view_sample_fwd`) and their
gradients in one more (`view_sample_bwd`), or raises; for CPU tensors it
runs the plain version `view_sample_reference`, one `bilinear_sample_ndc`
call a view and a map, which is also what the card is checked against.
When a map requires grad, the call goes through `ViewSample`, a
`torch.autograd.Function` whose backward is the backward kernel. No TPU
kernel is replaced: the JAX package leaves this sampling to XLA. The
kernels launch through `_build.launch`, which counts them.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch
from torch.autograd.function import once_differentiable

from ..utils.profiling import span
from . import _build
from .image import bilinear_sample_ndc

MAX_MAPS = 8  # the kernel's table of maps (`kMaxMaps`)


def view_sample_reference(maps: Sequence[torch.Tensor], xy: torch.Tensor,
                          align_corners: bool = False) -> torch.Tensor:
    """Plain version: maps (S, h, w, c) each, xy (S, N, 2) in pytorch3d NDC
    -> (S, N, sum c), the maps' samples side by side in the given order."""
    S = xy.shape[0]
    return torch.cat([torch.stack([bilinear_sample_ndc(m[s], xy[s], align_corners) for s in range(S)])
                      for m in maps], dim=-1)


def check_operands(maps: Sequence[torch.Tensor], xy: torch.Tensor) -> List[int]:
    """Check what the kernels take: 1 to MAX_MAPS float32 maps (S, h, w, c)
    on xy's device, xy (S, N, 2) float32 that needs no gradient. Returns
    each map's first channel in the rows, and the rows' width F last."""
    if not 1 <= len(maps) <= MAX_MAPS:
        raise ValueError(f"view_sample takes 1 to {MAX_MAPS} maps, got {len(maps)}")
    if xy.dim() != 3 or xy.shape[-1] != 2:
        raise ValueError(f"xy must be (S, N, 2), got {tuple(xy.shape)}")
    if xy.dtype != torch.float32:
        raise TypeError(f"xy must be float32, got {xy.dtype}")
    if xy.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("view_sample has no gradient with respect to xy")
    S = xy.shape[0]
    offsets = [0]
    for j, m in enumerate(maps):
        if m.device != xy.device:
            raise ValueError(f"map {j} is on {m.device}, xy on {xy.device}")
        if m.dtype != torch.float32:
            raise TypeError(f"map {j} must be float32, got {m.dtype}")
        if m.dim() != 4 or m.shape[0] != S or min(m.shape[1:]) < 1:
            raise ValueError(f"map {j} must be ({S}, h, w, c) with h, w, c >= 1, got {tuple(m.shape)}")
        offsets.append(offsets[-1] + m.shape[-1])
    return offsets


def _launch(name, maps, grads, offsets, xy, align_corners, rows):
    """One launch of `name` over the maps (and, backward, their gradient
    buffers), rows being out or grad_out (S, N, F) with channel stride 1."""
    words = []
    for m, g, off in zip(maps, grads, offsets):
        words += [m.data_ptr() if g is None else 0, 0 if g is None else g.data_ptr(),
                  *m.shape[1:], off, *m.stride(), *(m.stride() if g is None else g.stride())]
    desc = (ctypes.c_longlong * len(words))(*words)
    S, N = xy.shape[:2]
    _build.launch(name, desc, len(maps), xy.data_ptr(), *xy.stride(), S, N, int(align_corners),
                  rows.data_ptr(), *rows.stride()[:2], device=xy.device)


def _fwd_cuda(maps, xy, align_corners, offsets):
    S, N = xy.shape[:2]
    out = torch.empty((S, N, offsets[-1]), dtype=torch.float32, device=xy.device)
    if S * N > 0:
        _launch("view_sample_fwd", maps, [None] * len(maps), offsets, xy, align_corners, out)
    return out


def _bwd_cuda(metas, offsets, xy, align_corners, grad_out, wanted):
    """The gradients of the maps `wanted` names (None for the others), parts
    of one buffer that the kernel writes whole. Each part is laid out as
    `torch.empty_like` lays out its map (`metas`): with the map's own
    strides where those are dense, as the extractor's NHWC views of NCHW
    memory are. No points: zeros, and nothing to launch."""
    if grad_out.stride(-1) != 1:
        grad_out = grad_out.contiguous()
    take = [j for j, w in enumerate(wanted) if w]
    S, N = xy.shape[:2]
    alloc = torch.empty if S * N > 0 else torch.zeros
    flat = alloc((sum(metas[j].numel() for j in take),), dtype=torch.float32, device=xy.device)
    grads, start = [None] * len(metas), 0
    for j in take:
        grads[j] = flat.as_strided(metas[j].shape, metas[j].stride(), start)
        start += metas[j].numel()
    if take and S * N > 0:
        _launch("view_sample_bwd", [metas[j] for j in take], [grads[j] for j in take], [offsets[j] for j in take],
                xy, align_corners, grad_out)
    return grads


class ViewSample(torch.autograd.Function):
    """The forward kernel joined to the backward kernel: gradients for the
    maps that need one, none for xy."""

    @staticmethod
    def forward(ctx, xy, align_corners, offsets, *maps):
        out = _fwd_cuda(maps, xy, align_corners, offsets)
        ctx.save_for_backward(xy)
        # the backward needs the maps' shapes and strides, not their values
        ctx.metas = [torch.empty_like(m, device="meta") for m in maps]
        ctx.offsets, ctx.align_corners = offsets, align_corners
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        with span("holo.pool.bwd"):
            (xy,) = ctx.saved_tensors
            grads = _bwd_cuda(ctx.metas, ctx.offsets, xy, ctx.align_corners, grad_out, ctx.needs_input_grad[3:])
        return (None, None, None, *grads)


def view_sample(maps: Sequence[torch.Tensor], xy: torch.Tensor, align_corners: bool = False) -> torch.Tensor:
    """Sample every map (S, h, w, c) at xy (S, N, 2), pytorch3d NDC: view s
    of each map at xy[s]. Returns (S, N, sum c), the maps side by side in
    the given order. Differentiable in the maps, not in xy. CUDA tensors
    launch the kernels (or raise); CPU tensors take the plain version."""
    if _build.on_cpu(xy):
        return view_sample_reference(maps, xy, align_corners)
    offsets = check_operands(maps, xy)
    if torch.is_grad_enabled() and any(m.requires_grad for m in maps):
        return ViewSample.apply(xy, align_corners, offsets, *maps)
    return _fwd_cuda(maps, xy, align_corners, offsets)
