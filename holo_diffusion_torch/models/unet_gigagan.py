"""GigaGAN-style UNet variants (port of
holo_diffusion_tpu/models/unet_gigagan.py; reference guided_diffusion
unet.py:259-353, 462-513, 840-1071). No configuration of this repository
selects them.

  * `ResBlockGigaGAN`: a ResBlock without the time embedding;
  * `QKVLocalAttention`: self-attention inside non-overlapping windows of a
    2D map, in the JAX package's form (not the reference's unfold); its
    projection starts at zero, so the block is the identity at init;
  * `AsymmetricUNetModel`: a 2D UNet with no timestep input whose decoder
    has `decoder_blocks_multiplier` ResBlocks per skip connection.

Blocks take channels-first tensors, the model channels-last ones, as in
unet3d.py. Parameter names follow the reference's blocks (`in_layers`,
`out_layers`, `skip_connection`, `norm`, `qkv`, `proj_out`, `input_blocks`,
`middle_block`, `output_blocks`, `out`).
"""
from __future__ import annotations

from typing import List, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .unet3d import (
    AttentionBlock3D,
    Downsample3D,
    GroupNorm32,
    Upsample3D,
    _resize_nearest_2x,
    attention_heads,
    conv_nd,
    zero_init_,
)


class ResBlockGigaGAN(nn.Module):
    """GN-SiLU-conv in (with nearest up or average-pool down between the
    norm and the conv), GN-SiLU-dropout-conv out, 1^dims skip conv when the
    width changes (unet.py:259-353)."""

    def __init__(self, channels: int, out_channels: int, dropout: float = 0.0, up: bool = False,
                 down: bool = False, dims: int = 2):
        super().__init__()
        self.up, self.down, self.dims = up, down, dims
        self.in_layers = nn.Sequential(GroupNorm32(channels), nn.SiLU(), conv_nd(dims, channels, out_channels))
        self.out_layers = nn.Sequential(GroupNorm32(out_channels), nn.SiLU(), nn.Dropout(dropout),
                                        conv_nd(dims, out_channels, out_channels))
        self.skip_connection = (
            nn.Identity() if out_channels == channels else conv_nd(dims, channels, out_channels, k=1))

    def resample(self, x):
        if self.up:
            return _resize_nearest_2x(x, True, self.dims)
        return getattr(F, f"avg_pool{self.dims}d")(x, 2, 2)

    def forward(self, x):
        if self.up or self.down:
            h = self.resample(self.in_layers[:-1](x))
            x = self.resample(x)
            h = self.in_layers[-1](h)
        else:
            h = self.in_layers(x)
        return self.skip_connection(x) + self.out_layers(h)


class QKVLocalAttention(nn.Module):
    """Self-attention inside non-overlapping window x window tiles of a
    (B, C, H, W) map (unet.py:462-513 generalised as the JAX package has
    it); `window` divides H and W."""

    def __init__(self, channels: int, num_heads: int = 1, window: int = 8):
        super().__init__()
        self.num_heads, self.window = num_heads, window
        self.norm = GroupNorm32(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)
        zero_init_(self)

    def zero_init_parameters(self) -> List[nn.Parameter]:
        return [self.proj_out.weight, self.proj_out.bias]

    def forward(self, x):
        B, C, H, W = x.shape
        w = self.window
        if H % w or W % w:
            raise ValueError(f"window {w} must divide the spatial dims {H} x {W}")
        qkv = self.qkv(self.norm(x).reshape(B, C, H * W)).reshape(B, 3 * C, H // w, w, W // w, w)
        # -> (B * windows, 3C, w * w), then the per-head [q; k; v] split
        qkv = qkv.permute(0, 2, 4, 1, 3, 5).reshape(-1, 3 * C, w * w)
        ch = C // self.num_heads
        q, k, v = qkv.reshape(-1, 3 * ch, w * w).split(ch, dim=1)
        a = attention_heads(q, k, v).reshape(B, H // w, W // w, C, w, w)
        a = a.permute(0, 3, 1, 4, 2, 5).reshape(B, C, H * W)
        return x + self.proj_out(a).reshape(B, C, H, W)


class AsymmetricUNetModel(nn.Module):
    """2D UNet, no timestep input: `num_res_blocks` ResBlockGigaGANs per
    encoder level, `decoder_blocks_multiplier` times as many per skip
    connection in the decoder (unet.py:840-1071). (B, H, W, C) in and out."""

    def __init__(
        self,
        in_channels: int = 3,
        model_channels: int = 64,
        out_channels: int = 3,
        num_res_blocks: int = 1,
        attention_resolutions: Tuple[int, ...] = (),
        channel_mult: Tuple[int, ...] = (1, 2, 4),
        num_heads: int = 1,
        dropout: float = 0.0,
        decoder_blocks_multiplier: int = 2,
        dtype: Union[str, torch.dtype] = torch.float32,
    ):
        super().__init__()
        self.dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        ch = int(channel_mult[0] * model_channels)
        self.input_blocks = nn.ModuleList([nn.Sequential(conv_nd(2, in_channels, ch))])
        chans = [ch]
        ds = 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlockGigaGAN(ch, int(mult * model_channels), dropout)]
                ch = int(mult * model_channels)
                if ds in attention_resolutions:
                    layers.append(AttentionBlock3D(ch, num_heads))
                self.input_blocks.append(nn.Sequential(*layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.Sequential(Downsample3D(ch, dims=2)))
                chans.append(ch)
                ds *= 2
        self.middle_block = nn.Sequential(ResBlockGigaGAN(ch, ch, dropout), AttentionBlock3D(ch, num_heads),
                                          ResBlockGigaGAN(ch, ch, dropout))
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                cout = int(mult * model_channels)
                layers = [ResBlockGigaGAN(ch + chans.pop() if j == 0 else cout, cout, dropout)
                          for j in range(decoder_blocks_multiplier)]
                ch = cout
                if ds in attention_resolutions:
                    layers.append(AttentionBlock3D(ch, num_heads))
                if level and i == num_res_blocks:
                    layers.append(Upsample3D(ch, dims=2))
                    ds //= 2
                self.output_blocks.append(nn.Sequential(*layers))
        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(), conv_nd(2, ch, out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(x.device.type, dtype=self.dtype, enabled=self.dtype != torch.float32):
            h = x.permute(0, 3, 1, 2)
            hs = []
            for block in self.input_blocks:
                h = block(h)
                hs.append(h)
            h = self.middle_block(h)
            for block in self.output_blocks:
                h = block(torch.cat([h, hs.pop()], dim=1))
            return self.out(h).permute(0, 2, 3, 1)
