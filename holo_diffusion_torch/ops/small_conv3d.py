"""The UNet's small-volume 3D convolutions: a float32 convolution whose
output has at most 64 positions (batch x output voxels), the port's K9.

`refusal` is the route: the reason a call goes to the library's
convolution (cuDNN on the card), or None where K9 takes it; it depends on
what the call observes alone (device, dtype, grad mode, autocast, the
convolution's geometry and the output's positions). `small_conv3d`
launches the kernel of `csrc/small_conv3d.cu` for CUDA tensors, or raises
for a call the route refuses; for CPU tensors it runs the plain version,
`small_conv3d_reference`, which is `F.conv3d`.

No TPU kernel is replaced: the JAX package leaves its convolutions to XLA.
K9 was added because the library tiles these calls as if the output were
large: a GEMM of Cout x P x (Cin x 27) with P <= 64 output positions gets
one to four tiles on as many of the card's 132 SMs, most of whose
multiply-adds fall on padding, and reads its weights at a few percent of
the card's bandwidth. What bounds the call is each output's chain of
multiply-adds, the shared-memory reads that feed it, and the bytes of the
weights of the taps that meet an in-bounds input voxel for some output
(`used_taps`; at 1^3 voxels only the centre tap of a 3^3 kernel does). K9
sums each output as cuDNN does, one fused multiply-add a tap, channel by
channel, so its outputs are cuDNN's bit for bit; it gives every lane of
its warps one output's chain (`tiling`: 4 or 8 output channels a block, 8
or 4 positions a warp) so that the chains spread over many SMs, walks
each chain's taps as a box of constant offsets (`kind`; the route leaves
a shape with no such box to the library), and feeds the chains the used
taps' weights, each read once, through a ring of shared-memory stages
(`plan`). It launches
through `_build.launch` on the current stream, allocates nothing and reads
the weights where they lie, so a CUDA graph captures it and replays it on
live weights.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from . import _build

MAX_POSITIONS = 64  # the most output positions K9 takes
# the kernel's constants (`csrc/small_conv3d.cu`)
STAGES = 4  # chunks of input channels in a block's shared-memory ring
MAX_SHARED_BYTES = 200 * 1024  # the ring (the kernel opts in above 48 KB; the H100 gives up to 227 KB)
STAGE_BYTES = 18 * 1024  # the stage a chunk is cut for


def output_extent(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def _axis_taps(n: int, k: int, stride: int, pad: int) -> Tuple[int, ...]:
    """The offsets d in [0, k) that meet an in-bounds input on an axis of n
    voxels for some output."""
    outs = range(output_extent(n, k, stride, pad))
    return tuple(d for d in range(k) if any(0 <= o * stride + d - pad < n for o in outs))


def used_taps(spatial: Sequence[int], k: int, stride: Sequence[int]) -> Tuple[int, ...]:
    """The taps dz * k * k + dy * k + dx of a k^3 kernel (padding k // 2)
    that meet an in-bounds voxel of an input of extents `spatial` for at
    least one output position, in increasing order."""
    z, y, x = (_axis_taps(n, k, s, k // 2) for n, s in zip(spatial, stride))
    return tuple(dz * k * k + dy * k + dx for dz in z for dy in y for dx in x)


def positions(shape: Sequence[int], k: int, stride: Sequence[int]) -> int:
    """P = B x the output's voxels of an input (B, C, D, H, W), padding k // 2."""
    return shape[0] * math.prod(output_extent(n, k, s, k // 2) for n, s in zip(shape[2:], stride))


def refusal(shape: Sequence[int], device: torch.device, dtype: torch.dtype, conv: torch.nn.Conv3d) -> Optional[str]:
    """Why `conv` of an input of `shape`, `device` and `dtype` goes to the
    library's convolution; None where K9 takes it: a no-grad float32
    forward on CUDA (autocast off) of a 1^3 or 3^3 kernel, padding k // 2,
    groups 1, dilation 1, stride 1 or 2 on each axis, at most
    MAX_POSITIONS output positions, and a box walk (`kind`)."""
    return _refusal(shape, device, dtype, conv.weight.dtype, tuple(conv.kernel_size), tuple(conv.stride),
                    conv.padding, conv.padding_mode, tuple(conv.dilation), conv.groups)


def _refusal(shape, device, dtype, weight_dtype, kernel_size, stride, padding, padding_mode, dilation,
             groups) -> Optional[str]:
    if device.type != "cuda":
        return f"the input lies on {device.type}, not a CUDA device"
    if torch.is_grad_enabled():
        return "grad is enabled, so autograd records the forward"
    if torch.is_autocast_enabled("cuda"):
        return "autocast is enabled on CUDA"
    if dtype != torch.float32 or weight_dtype != torch.float32:
        return f"the input is {dtype} and the weight {weight_dtype}, not both float32"
    if groups != 1:
        return f"groups {groups}, not 1"
    if dilation != (1, 1, 1):
        return f"dilation {dilation}, not 1"
    k = kernel_size[0]
    if kernel_size != (k, k, k) or k not in (1, 3):
        return f"kernel {kernel_size}, not 1^3 or 3^3"
    if padding_mode != "zeros" or tuple(padding) != (k // 2,) * 3:
        return f"padding {padding!r} ({padding_mode}), not {k // 2} with zeros"
    if any(s not in (1, 2) for s in stride):
        return f"stride {stride}, not 1 or 2 on each axis"
    if len(shape) != 5:
        return f"the input has {len(shape)} dimensions, not 5"
    P = positions(shape, k, stride)
    if P > MAX_POSITIONS:
        return f"{P} output positions, more than {MAX_POSITIONS}"
    if kind(shape[2:], k, stride, len(used_taps(shape[2:], k, stride))) is None:
        return f"no box walk for extents {tuple(shape[2:])} at stride {stride}"
    return None


def tiling(P: int) -> Tuple[int, int]:
    """(output channels a block, chain warps a block) for P output
    positions: a warp's 32 lanes hold 32 / co_tile positions x co_tile
    channels; 4 channels and one warp (8 positions) up to 8 positions,
    else 8 channels and two warps (8 positions) a block, so that a call's
    chains spread over about as many SMs as the card has."""
    return (4, 1) if P <= 8 else (8, 2)


# how a lane walks its taps (`Kind` of the kernel): a box of one shape for
# every position
BOX1, BOX2, BOX2S, HALO6, HALO10 = range(5)


def kind(spatial: Sequence[int], k: int, stride: Sequence[int], taps: int) -> Optional[int]:
    """The walk of a call: BOX1 where one tap is used; at a cube of 3^3
    taps, one stride on every axis: HALO6 / HALO10 at 4^3 / 8^3 voxels,
    every tap used (the input held in a halo of zeros, 3^3 taps a
    position), BOX2 / BOX2S at 2^3 voxels, stride 1 / 2 (2^3 taps a
    position); None for any other shape, whose positions' in-bounds taps
    form boxes of different shapes."""
    if taps == 1:
        return BOX1
    n = spatial[0]
    if k == 3 and tuple(spatial) == (n,) * 3 and len(set(stride)) == 1:
        if n in (4, 8) and taps == 27:
            return HALO6 if n == 4 else HALO10
        if n == 2:
            return BOX2 if stride[0] == 1 else BOX2S
    return None


def channel_floats(walk: int, batch: int, spatial: Sequence[int]) -> int:
    """An input channel's floats in a stage: the voxels inside a halo of
    one (HALO6, HALO10), else the voxels."""
    if walk in (HALO6, HALO10):
        return batch * math.prod(n + 2 for n in spatial)
    return batch * math.prod(spatial)


def _wstride(cc: int, taps: int) -> int:
    """A weight row's floats in a stage: cc x taps, padded to 4 x an odd
    number (the rows then start in distinct banks)."""
    w = -(-cc * taps // 4) * 4
    return w + 4 if w // 4 % 2 == 0 else w


def shared_bytes(cc: int, taps: int, xp: int, co_tile: int) -> int:
    """The ring's bytes, as the kernel lays it out: in each of STAGES
    stages, co_tile weight rows of a chunk of `cc` input channels at the
    used taps, then the chunk's channels of `xp` floats (channel_floats),
    padded to 4 floats."""
    return STAGES * 4 * (co_tile * _wstride(cc, taps) + -(-cc * xp // 4) * 4)


def plan(cin: int, taps: int, xp: int, vec: bool, co_tile: int) -> int:
    """The input channels a chunk of a call of `cin` input channels,
    `taps` used taps, `xp` floats an input channel in a stage and co_tile
    output channels a block: about STAGE_BYTES a stage, in steps of 4
    where the weight rows are copied 16 bytes at a time (`vec`: every tap
    used), and a ring that fits MAX_SHARED_BYTES."""
    step = 4 if vec else 1
    per_channel = 4 * (co_tile * taps + xp)
    cc = min(max(step, STAGE_BYTES // per_channel // step * step), -(-cin // step) * step)
    while cc > 1 and shared_bytes(cc, taps, xp, co_tile) > MAX_SHARED_BYTES:
        cc -= 1
    if shared_bytes(cc, taps, xp, co_tile) > MAX_SHARED_BYTES:
        raise ValueError(f"an input channel of {xp} floats leaves no room for a chunk in shared memory")
    return cc


def small_conv3d_reference(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                           stride: Union[int, Sequence[int]]) -> torch.Tensor:
    """Plain version: `F.conv3d` with padding k // 2."""
    return F.conv3d(x, weight, bias, stride, weight.shape[-1] // 2)


def small_conv3d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 stride: Union[int, Sequence[int]]) -> torch.Tensor:
    """The convolution of x (B, Cin, D, H, W) by weight (Cout, Cin, k, k, k)
    and bias (Cout,) or None, padding k // 2 -> (B, Cout, Do, Ho, Wo).
    CUDA tensors launch K9 (or raise where the route refuses the call); CPU
    tensors take the plain version."""
    if _build.on_cpu(x):
        return small_conv3d_reference(x, weight, bias, stride)
    stride = (stride,) * 3 if isinstance(stride, int) else tuple(stride)
    k = weight.shape[-1]
    why = _refusal(x.shape, x.device, x.dtype, weight.dtype, tuple(weight.shape[2:]), stride, (k // 2,) * 3,
                   "zeros", (1, 1, 1), 1)
    if why is not None:
        raise ValueError(f"K9 does not take this convolution: {why}")
    if weight.device != x.device or (bias is not None and (bias.device != x.device or bias.dtype != x.dtype)):
        raise ValueError("x, weight and bias must lie on one device, in float32")
    x, weight = x.contiguous(), weight.contiguous()
    B, Cin, D, H, W = x.shape
    Cout = weight.shape[0]
    if weight.shape[1] != Cin:
        raise ValueError(f"the weight takes {weight.shape[1]} input channels, x has {Cin}")
    out_sp = [output_extent(n, k, s, k // 2) for n, s in zip((D, H, W), stride)]
    taps = used_taps((D, H, W), k, stride)
    vec = len(taps) == k ** 3 and Cin * k ** 3 % 4 == 0
    out = torch.empty((B, Cout, *out_sp), dtype=torch.float32, device=x.device)
    table = (ctypes.c_int * len(taps))(*taps)
    co_tile, chains = tiling(B * math.prod(out_sp))
    walk = kind((D, H, W), k, stride, len(taps))
    cc = plan(Cin, len(taps), channel_floats(walk, B, (D, H, W)), vec, co_tile)
    _build.launch("small_conv3d", x.data_ptr(), weight.data_ptr(), 0 if bias is None else bias.contiguous().data_ptr(),
                  out.data_ptr(), B, Cin, D, H, W, Cout, *out_sp, k, *stride, len(taps), table, cc, co_tile, chains,
                  walk, device=x.device)
    return out
