"""3D UNet denoiser (port of holo_diffusion_tpu/models/unet3d.py; reference
guided_diffusion unet.py:566-837 wrapped by SimpleUnet3D).

The public `UNetModel3D.forward` takes and returns channels-last
(B, D, H, W, C) tensors like the JAX model; inside it runs NCDHW for cuDNN.
Module and parameter names follow the reference torch model (`time_embed.0`,
`input_blocks.{i}.{j}.in_layers.2`, `...qkv`, `...proj_out`, `out.2`), so a
reference state_dict loads directly. GroupNorm and the attention softmax run
in float32; attention is a plain matmul over the flattened voxels.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


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


def _conv(cin, cout, k=3, stride=1):
    return nn.Conv3d(cin, cout, k, stride=stride, padding=k // 2)


class TimestepEmbedSequential(nn.Sequential):
    """Sequential that passes the time embedding to the blocks that take it."""

    def forward(self, x, emb):
        for layer in self:
            x = layer(x, emb) if isinstance(layer, ResBlock3D) else layer(x)
        return x


class Upsample3D(nn.Module):
    """Nearest x2 (all axes, or H and W only), then a 3x3x3 conv."""

    def __init__(self, channels: int, homogeneous: bool = True):
        super().__init__()
        self.homogeneous = homogeneous
        self.conv = _conv(channels, channels)

    def forward(self, x):
        if self.homogeneous:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        else:
            x = F.interpolate(x, (x.shape[2], x.shape[3] * 2, x.shape[4] * 2), mode="nearest")
        return self.conv(x)


class Downsample3D(nn.Module):
    """Strided 3x3x3 conv: stride 2 on all axes, or on H and W only."""

    def __init__(self, channels: int, homogeneous: bool = True):
        super().__init__()
        self.op = _conv(channels, channels, stride=2 if homogeneous else (1, 2, 2))

    def forward(self, x):
        return self.op(x)


class ResBlock3D(nn.Module):
    """GN-SiLU-conv in, FiLM scale-shift from the time embedding, GN-SiLU-
    dropout-conv out, 1x1 skip conv when the width changes (unet.py:141-256)."""

    def __init__(
        self,
        channels: int,
        emb_channels: int,
        out_channels: int,
        dropout: float = 0.0,
        use_scale_shift_norm: bool = True,
    ):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_layers = nn.Sequential(GroupNorm32(channels), nn.SiLU(), _conv(channels, out_channels))
        self.emb_layers = nn.Sequential(
            nn.SiLU(),
            nn.Linear(emb_channels, 2 * out_channels if use_scale_shift_norm else out_channels),
        )
        self.out_layers = nn.Sequential(
            GroupNorm32(out_channels), nn.SiLU(), nn.Dropout(dropout),
            _conv(out_channels, out_channels),
        )
        self.skip_connection = (
            nn.Identity() if out_channels == channels else _conv(channels, out_channels, k=1)
        )

    def forward(self, x, emb):
        h = self.in_layers(x)
        emb_out = self.emb_layers(emb).type(h.dtype)[..., None, None, None]
        if self.use_scale_shift_norm:
            norm, rest = self.out_layers[0], self.out_layers[1:]
            scale, shift = torch.chunk(emb_out, 2, dim=1)
            h = rest(norm(h) * (1 + scale) + shift)
        else:
            h = self.out_layers(h + emb_out)
        return self.skip_connection(x) + h


class AttentionBlock3D(nn.Module):
    """Self-attention over the flattened voxels (unet.py:356-406 with
    QKVAttentionLegacy 429-459): per-head contiguous [q; k; v] split,
    1/sqrt(sqrt(d)) on both q and k, float32 softmax."""

    def __init__(self, channels: int, num_heads: int = 1, num_head_channels: int = -1):
        super().__init__()
        self.num_heads = num_heads if num_head_channels == -1 else channels // num_head_channels
        self.norm = GroupNorm32(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)

    def forward(self, x):
        B, C = x.shape[:2]
        spatial = x.shape[2:]
        qkv = self.qkv(self.norm(x.reshape(B, C, -1)))  # (B, 3C, T)
        T = qkv.shape[-1]
        ch = C // self.num_heads
        q, k, v = qkv.reshape(B * self.num_heads, 3 * ch, T).split(ch, dim=1)
        scale = 1.0 / math.sqrt(math.sqrt(ch))
        weight = torch.einsum("bct,bcs->bts", q * scale, k * scale)
        weight = torch.softmax(weight.float(), dim=-1).type(weight.dtype)
        a = torch.einsum("bts,bcs->bct", weight, v).reshape(B, C, T)
        return x + self.proj_out(a).reshape(B, C, *spatial)


class UNetModel3D(nn.Module):
    """The full UNet (unet.py:566-837), 3D. The hydrant release config is
    model_channels=64, channel_mult=(1, 1, 2, 4, 8), attention at ds {4, 8},
    num_heads=2, scale-shift norm, homogeneous resampling."""

    def __init__(
        self,
        in_channels: int = 128,
        model_channels: int = 64,
        out_channels: int = 128,
        num_res_blocks: int = 2,
        attention_resolutions: Tuple[int, ...] = (4, 8),
        dropout: float = 0.0,
        channel_mult: Tuple[int, ...] = (1, 1, 2, 4, 8),
        num_heads: int = 2,
        num_head_channels: int = -1,
        use_scale_shift_norm: bool = True,
        homogeneous_resample: bool = True,
    ):
        super().__init__()
        self.model_channels = model_channels
        emb_ch = model_channels * 4
        self.time_embed = nn.Sequential(
            nn.Linear(model_channels, emb_ch), nn.SiLU(), nn.Linear(emb_ch, emb_ch)
        )

        def res(cin, cout):
            return ResBlock3D(cin, emb_ch, cout, dropout, use_scale_shift_norm)

        def attn(c):
            return AttentionBlock3D(c, num_heads, num_head_channels)

        ch = int(channel_mult[0] * model_channels)
        self.input_blocks = nn.ModuleList([TimestepEmbedSequential(_conv(in_channels, ch))])
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
                self.input_blocks.append(
                    TimestepEmbedSequential(Downsample3D(ch, homogeneous_resample))
                )
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
                    layers.append(Upsample3D(ch, homogeneous_resample))
                    ds //= 2
                self.output_blocks.append(TimestepEmbedSequential(*layers))

        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(), _conv(ch, out_channels))

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        """x: (B, D, H, W, C) channels-last; timesteps: (B,) -> (B, D, H, W, C)."""
        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels))
        h = x.permute(0, 4, 1, 2, 3).contiguous()
        hs = []
        for block in self.input_blocks:
            h = block(h, emb)
            hs.append(h)
        h = self.middle_block(h, emb)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb)
        return self.out(h).permute(0, 2, 3, 4, 1).contiguous()
