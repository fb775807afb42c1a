"""The UNet denoiser (port of holo_diffusion_tpu/models/unet3d.py; reference
guided_diffusion unet.py:566-837 wrapped by SimpleUnet3D), in 1, 2 or 3
spatial dimensions.

The public `UNetModel3D.forward` takes and returns channels-last
(B, *spatial, C) tensors like the JAX model; inside it runs channels-first
for cuDNN. Module and parameter names follow the reference torch model
(`time_embed.0`, `label_emb`, `input_blocks.{i}.{j}.in_layers.2`, `...qkv`,
`...proj_out`, `out.2`), so a reference state_dict loads directly.
GroupNorm and the attention softmax run in float32; with `dtype` bfloat16
the convolutions and matmuls run in bfloat16 under autocast. Attention is a
plain matmul over the flattened positions.

Initialisation: `weights.init_weights` draws xavier-uniform kernels and zero
biases (SimpleUnet3D's scheme); `simple_init=False` zeroes the ResBlocks' out
convs and the attention projections (guided_diffusion's scheme) and
`zero_last_conv` the last conv, here and in `init_weights`, through
`zero_init_parameters`.

On the card a forward that autograd does not record replays a CUDA graph
of the whole UNet, captured once per model, device and input shape
(`_UNetGraphs`): the host makes a copy of each input, one replay and one
copy of the output in place of ~500 launches, and the same kernels run on
the same operands, so the output is bitwise the eager one's. The route
(`graph_refusal`) depends on what the call observes alone: a CPU input, a
forward with grad enabled (every training forward) or one made while the
current stream captures runs eagerly. Weights are read live at each
replay; weights moved or replaced, another float32 precision or the
other train/eval mode capture anew (`_graph_key`). Each forward adds 1 to
the counter `unet_graphed` or `unet_eager` and each capture 1 to
`unet_graph_captures` (`utils/profiling.py` `count`, while a torch
profiler records). What runs in Python inside the body (the `holo.unet`
span, forward hooks) runs at the graph's warm-up and capture alone.

The 3D convolutions are `RoutedConv3d`s: a no-grad float32 forward on the
card of a 1^3 or 3^3 convolution whose output has at most 64 positions
(batch x output voxels; at B = 1 the levels of 4^3 voxels and fewer, 51
convolutions of hydrant's UNet) takes the hand-written kernel K9
(`ops/small_conv3d.py`) in place of cuDNN, eagerly or inside the graph
alike; every other call (the CPU, grad on, bfloat16 autocast, more
positions, extents K9 has no box walk for) takes the library's
convolution. The route
(`small_conv3d.refusal`) depends on what the call observes alone, as the
graph's does, and each call on the card adds 1 to the counter
`conv3d_small` or `conv3d_cudnn`. K9 sums each output in the order of
cuDNN's kernel for these shapes, so at the UNets' shapes both routes give
the same bits, and it reruns bitwise, so a graphed forward stays bitwise
the eager one.
"""
from __future__ import annotations

import math
import weakref
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import small_conv3d
from ..utils.cuda_graphs import GraphCache, storage_key
from ..utils.profiling import count, span
_AVG_POOL = {1: nn.AvgPool1d, 2: nn.AvgPool2d, 3: nn.AvgPool3d}


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0):
    """Sinusoidal embeddings, [cos | sin] order (nn.py:109-127)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32) computed in float32, cast back (nn.py:23-25)."""

    def __init__(self, channels: int):
        super().__init__(32, channels, eps=1e-5)

    def forward(self, x):
        return super().forward(x.float()).type(x.dtype)


class RoutedConv3d(nn.Conv3d):
    """`nn.Conv3d` (the same parameters and state_dict) whose forward takes
    K9 (`ops/small_conv3d.py`) where `small_conv3d.refusal` finds no reason
    not to, and the library's convolution otherwise; each call on the card
    adds 1 to the counter `conv3d_small` or `conv3d_cudnn` of its route."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cuda":
            return super().forward(x)
        # grad on (every training forward) is refused before the route looks
        # at the call's geometry
        if not torch.is_grad_enabled() and small_conv3d.refusal(x.shape, x.device, x.dtype, self) is None:
            count("conv3d_small", 1)
            return small_conv3d.small_conv3d(x, self.weight, self.bias, self.stride)
        count("conv3d_cudnn", 1)
        return super().forward(x)


_CONV = {1: nn.Conv1d, 2: nn.Conv2d, 3: RoutedConv3d}


def conv_nd(dims: int, cin: int, cout: int, k: int = 3, stride: Union[int, Tuple[int, ...]] = 1) -> nn.Module:
    return _CONV[dims](cin, cout, k, stride=stride, padding=k // 2)


def _stride(dims: int, homogeneous: bool) -> Union[int, Tuple[int, ...]]:
    """The downsampling stride: 2 on every axis, or on H and W only."""
    return (1, 2, 2) if dims == 3 and not homogeneous else 2


def _resize_nearest_2x(x: torch.Tensor, homogeneous: bool, dims: int) -> torch.Tensor:
    """Nearest x2 on every spatial axis of a channels-first tensor; at dims 3
    the depth axis only scales when `homogeneous` (unet.py:92-103)."""
    if dims == 3 and not homogeneous:
        return F.interpolate(x, (x.shape[2], x.shape[3] * 2, x.shape[4] * 2), mode="nearest")
    return F.interpolate(x, scale_factor=2, mode="nearest")


def zero_init_(module: nn.Module) -> nn.Module:
    """Zero every parameter that a module of `module` names in its
    `zero_init_parameters()` (the JAX package's zero initialisers)."""
    with torch.no_grad():
        for mod in module.modules():
            for p in getattr(mod, "zero_init_parameters", lambda: [])():
                p.zero_()
    return module


class TimestepEmbedSequential(nn.Sequential):
    """Sequential that passes the time embedding to the blocks that take it."""

    def forward(self, x, emb):
        for layer in self:
            x = layer(x, emb) if isinstance(layer, ResBlock3D) else layer(x)
        return x


class Upsample3D(nn.Module):
    """Nearest x2 (every axis, or H and W only), then a 3^dims conv when
    `use_conv`."""

    def __init__(self, channels: int, homogeneous: bool = True, use_conv: bool = True, dims: int = 3):
        super().__init__()
        self.homogeneous, self.dims = homogeneous, dims
        if use_conv:
            self.conv = conv_nd(dims, channels, channels)

    def forward(self, x):
        x = _resize_nearest_2x(x, self.homogeneous, self.dims)
        return self.conv(x) if hasattr(self, "conv") else x


class Downsample3D(nn.Module):
    """Strided 3^dims conv (`use_conv`) or average pool: stride 2 on every
    axis, or on H and W only."""

    def __init__(self, channels: int, homogeneous: bool = True, use_conv: bool = True, dims: int = 3):
        super().__init__()
        stride = _stride(dims, homogeneous)
        self.op = conv_nd(dims, channels, channels, stride=stride) if use_conv else _AVG_POOL[dims](stride, stride)

    def forward(self, x):
        return self.op(x)


class ResBlock3D(nn.Module):
    """GN-SiLU-conv in, FiLM scale-shift from the time embedding, GN-SiLU-
    dropout-conv out, 1^dims skip conv when the width changes
    (unet.py:141-256). The JAX block's `up`/`down` options are left out:
    no model of either package sets them (ResBlockGigaGAN has its own)."""

    def __init__(
        self,
        channels: int,
        emb_channels: int,
        out_channels: int,
        dropout: float = 0.0,
        use_scale_shift_norm: bool = True,
        dims: int = 3,
        simple_init: bool = True,
        use_checkpoint: bool = False,
    ):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.dims = dims
        self.simple_init, self.use_checkpoint = simple_init, use_checkpoint
        self.in_layers = nn.Sequential(GroupNorm32(channels), nn.SiLU(), conv_nd(dims, channels, out_channels))
        self.emb_layers = nn.Sequential(
            nn.SiLU(),
            nn.Linear(emb_channels, 2 * out_channels if use_scale_shift_norm else out_channels),
        )
        self.out_layers = nn.Sequential(
            GroupNorm32(out_channels), nn.SiLU(), nn.Dropout(dropout),
            conv_nd(dims, out_channels, out_channels),
        )
        self.skip_connection = (
            nn.Identity() if out_channels == channels else conv_nd(dims, channels, out_channels, k=1)
        )

    def zero_init_parameters(self) -> List[nn.Parameter]:
        return [] if self.simple_init else [self.out_layers[3].weight]

    def forward(self, x, emb):
        if self.use_checkpoint and self.training and torch.is_grad_enabled():
            return checkpoint(self._forward, x, emb, use_reentrant=False)
        return self._forward(x, emb)

    def _forward(self, x, emb):
        h = self.in_layers(x)
        emb_out = self.emb_layers(emb).type(h.dtype)
        emb_out = emb_out.reshape(*emb_out.shape, *([1] * self.dims))
        if self.use_scale_shift_norm:
            norm, rest = self.out_layers[0], self.out_layers[1:]
            scale, shift = torch.chunk(emb_out, 2, dim=1)
            h = rest(norm(h) * (1 + scale) + shift)
        else:
            h = self.out_layers(h + emb_out)
        return self.skip_connection(x) + h


def attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-head attention of (BH, ch, Tq) queries over (BH, ch, Tk) keys and
    values, 1/sqrt(sqrt(ch)) on both q and k, the softmax in float32 ->
    (BH, ch, Tq)."""
    scale = 1.0 / math.sqrt(math.sqrt(q.shape[1]))
    weight = torch.einsum("bct,bcs->bts", q * scale, k * scale)
    weight = torch.softmax(weight.float(), dim=-1).type(weight.dtype)
    return torch.einsum("bts,bcs->bct", weight, v)


class AttentionBlock3D(nn.Module):
    """Self-attention over the flattened positions (unet.py:356-406 with
    QKVAttentionLegacy 429-459): per-head contiguous [q; k; v] split,
    1/sqrt(sqrt(d)) on both q and k, float32 softmax."""

    def __init__(self, channels: int, num_heads: int = 1, num_head_channels: int = -1,
                 simple_init: bool = True, use_checkpoint: bool = False):
        super().__init__()
        self.num_heads = num_heads if num_head_channels == -1 else channels // num_head_channels
        self.simple_init, self.use_checkpoint = simple_init, use_checkpoint
        self.norm = GroupNorm32(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)

    def zero_init_parameters(self) -> List[nn.Parameter]:
        return [] if self.simple_init else [self.proj_out.weight]

    def split_heads(self, qkv: torch.Tensor):
        """(B, 3C, T) -> q, k, v of (B * heads, ch, T)."""
        B, C3, T = qkv.shape
        ch = C3 // (3 * self.num_heads)
        return qkv.reshape(B * self.num_heads, 3 * ch, T).split(ch, dim=1)

    def forward(self, x):
        if self.use_checkpoint and self.training and torch.is_grad_enabled():
            return checkpoint(self._forward, x, use_reentrant=False)
        return self._forward(x)

    def _forward(self, x):
        B, C = x.shape[:2]
        spatial = x.shape[2:]
        q, k, v = self.split_heads(self.qkv(self.norm(x.reshape(B, C, -1))))
        a = attention_heads(q, k, v).reshape(B, C, -1)
        return x + self.proj_out(a).reshape(B, C, *spatial)


class UNetModel3D(nn.Module):
    """The full UNet (unet.py:566-837). The hydrant release config is 3D,
    model_channels=64, channel_mult=(1, 1, 2, 4, 8), attention at ds {4, 8},
    num_heads=2, scale-shift norm, homogeneous resampling.

    `conv_resample=False` downsamples by average pooling and upsamples with
    no conv; `num_classes` > 0 adds a label embedding to the time embedding
    (`forward(..., y=labels)`); `cond_features` are concatenated to `x` on
    channels (`in_channels` counts both). `use_remat` recomputes each
    ResBlock and attention block in the backward of a training forward
    (`torch.utils.checkpoint`; the JAX model's `nn.remat`); the numbers do
    not change. Its default here is off: the JAX model's is on."""

    def __init__(
        self,
        in_channels: int = 128,
        model_channels: int = 64,
        out_channels: int = 128,
        num_res_blocks: int = 2,
        attention_resolutions: Tuple[int, ...] = (4, 8),
        dropout: float = 0.0,
        channel_mult: Tuple[int, ...] = (1, 1, 2, 4, 8),
        conv_resample: bool = True,
        num_heads: int = 2,
        num_head_channels: int = -1,
        use_scale_shift_norm: bool = True,
        zero_last_conv: bool = False,
        homogeneous_resample: bool = True,
        simple_init: bool = True,
        use_remat: bool = False,
        dims: int = 3,
        num_classes: int = 0,
        dtype: Union[str, torch.dtype] = torch.float32,
    ):
        super().__init__()
        self.model_channels = model_channels
        self.dims = dims
        self.num_classes = num_classes
        self.zero_last_conv = zero_last_conv
        self.dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        emb_ch = model_channels * 4
        self.time_embed = nn.Sequential(
            nn.Linear(model_channels, emb_ch), nn.SiLU(), nn.Linear(emb_ch, emb_ch)
        )
        if num_classes:
            self.label_emb = nn.Embedding(num_classes, emb_ch)

        def res(cin, cout):
            return ResBlock3D(cin, emb_ch, cout, dropout, use_scale_shift_norm, dims=dims,
                              simple_init=simple_init, use_checkpoint=use_remat)

        def attn(c):
            return AttentionBlock3D(c, num_heads, num_head_channels, simple_init, use_remat)

        ch = int(channel_mult[0] * model_channels)
        self.input_blocks = nn.ModuleList([TimestepEmbedSequential(conv_nd(dims, in_channels, ch))])
        chans = [ch]
        ds = 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, int(mult * model_channels))]
                ch = int(mult * model_channels)
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(TimestepEmbedSequential(*layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(TimestepEmbedSequential(
                    Downsample3D(ch, homogeneous_resample, conv_resample, dims)))
                chans.append(ch)
                ds *= 2

        self.middle_block = TimestepEmbedSequential(res(ch, ch), attn(ch), res(ch, ch))

        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [res(ch + chans.pop(), int(model_channels * mult))]
                ch = int(model_channels * mult)
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                if level and i == num_res_blocks:
                    layers.append(Upsample3D(ch, homogeneous_resample, conv_resample, dims))
                    ds //= 2
                self.output_blocks.append(TimestepEmbedSequential(*layers))

        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(), conv_nd(dims, ch, out_channels))
        zero_init_(self)

    def zero_init_parameters(self) -> List[nn.Parameter]:
        return [self.out[2].weight] if self.zero_last_conv else []

    def embed(self, timesteps: torch.Tensor, y=None) -> torch.Tensor:
        """The time embedding, plus the label embedding of a class-conditional
        model."""
        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels))
        if self.num_classes:
            if y is None:
                raise ValueError("a class-conditional model needs labels y")
            emb = emb + self.label_emb(y)
        return emb

    def autocast(self, device_type: str):
        return torch.autocast(device_type, dtype=self.dtype, enabled=self.dtype != torch.float32)

    def to_channels_first(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, self.dims + 1, *range(1, self.dims + 1)).contiguous()

    def to_channels_last(self, h: torch.Tensor) -> torch.Tensor:
        return h.permute(0, *range(2, self.dims + 2), 1).contiguous()

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, cond_features=None, y=None) -> torch.Tensor:
        """x: (B, *spatial, C) channels-last; timesteps: (B,); cond_features
        (B, *spatial, C') or None; y: (B,) labels -> (B, *spatial, out).
        Replays the model's CUDA graph of these input shapes where
        `graph_refusal` finds no reason not to (module docstring); the
        result is the caller's own tensor either way."""
        if graph_refusal(x.device) is None:
            count("unet_graphed", 1)
            graphs = _UNetGraphs.of(self, x.device, _graph_key(self))
            return graphs.replay(self, (x, timesteps, cond_features, y))
        count("unet_eager", 1)
        return self._forward(x, timesteps, cond_features, y)

    def _forward(self, x, timesteps, cond_features=None, y=None) -> torch.Tensor:
        """The eager body of `forward`, which a graph captures."""
        with span("holo.unet"):
            if cond_features is not None:
                x = torch.cat([x, cond_features], dim=-1)
            with self.autocast(x.device.type):
                emb = self.embed(timesteps, y)
                h = self.to_channels_first(x)
                hs = []
                for block in self.input_blocks:
                    h = block(h, emb)
                    hs.append(h)
                h = self.middle_block(h, emb)
                for block in self.output_blocks:
                    h = block(torch.cat([h, hs.pop()], dim=1), emb)
                # the JAX model returns to the input's dtype before the out norm
                return self.to_channels_last(self.out(h.to(x.dtype)))


# ---- the no-grad forward's CUDA graphs

def graph_refusal(device: torch.device) -> Optional[str]:
    """Why a forward of an input on `device` runs eagerly; None where it
    replays a graph."""
    if device.type != "cuda":
        return f"the input lies on {device.type}, not a CUDA device"
    if torch.is_grad_enabled():
        return "grad is enabled, so autograd records the forward"
    if torch.cuda.is_current_stream_capturing():
        return "the current stream is capturing"
    return None


def _graph_key(model: nn.Module):
    """What a graph of `model` takes as fixed: its train/eval mode, the
    float32 precision of matmuls and cuDNN, and where each parameter and
    buffer is stored (their values are read live at each replay)."""
    return ((model.training, torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32),
            storage_key(model))


def _inputs_key(inputs) -> tuple:
    return tuple(None if t is None else (tuple(t.shape), t.dtype) for t in inputs)


class _UNetGraphs(GraphCache):
    """One model's graphs on one device (`utils/cuda_graphs.py`) by the
    shapes and dtypes of (x, timesteps, cond_features, y), each with its
    static inputs and its static output."""

    _of = weakref.WeakKeyDictionary()  # model -> {device: _UNetGraphs}

    def __init__(self, dev: torch.device):
        super().__init__(dev)
        self.graphs: Dict[tuple, tuple] = {}

    def replay(self, model: nn.Module, inputs: tuple) -> torch.Tensor:
        """The forward of `inputs` through its graph, captured on first use;
        returns a copy of the static output, which the next replay rewrites."""
        key = _inputs_key(inputs)
        if key not in self.graphs:
            count("unet_graph_captures", 1)
            static_inputs = tuple(None if t is None else t.clone(memory_format=torch.contiguous_format)
                                  for t in inputs)
            graph, static_out = self.capture(model._forward, *static_inputs)
            self.graphs[key] = graph, static_inputs, static_out
        graph, static_inputs, static_out = self.graphs[key]
        for static, t in zip(static_inputs, inputs):
            if t is not None:
                static.copy_(t)
        graph.replay()
        return static_out.clone()
