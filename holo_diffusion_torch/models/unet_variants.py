"""The reference's UNet variants (port of
holo_diffusion_tpu/models/unet_variants.py; reference guided_diffusion
unet.py:27-56, 1073-1286), built from the `dims`-generalised blocks of
unet3d.py. No configuration of this repository selects them.

  * `SuperResModel`: the UNet over x concatenated with the bilinear
    upsampling of a low-resolution input;
  * `AttentionPool2d`: attention pooling with a learned positional
    embedding and the mean token as the query;
  * `EncoderUNetModel`: the UNet's encoder half with an `adaptive`,
    `attention` or `spatial` pooled head.

Parameter names are the reference classes' (`input_blocks`, `middle_block`,
`out`, `positional_embedding`, `qkv_proj`, `c_proj`); the computation is the
JAX package's (its per-head [q; k; v] split in the pool, its spatial pool
over each level's output). The models take and return channels-last
tensors; `AttentionPool2d`, a block, takes channels-first ones.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.image import resize_bilinear_antialiased
from .unet3d import (
    AttentionBlock3D,
    Downsample3D,
    GroupNorm32,
    ResBlock3D,
    TimestepEmbedSequential,
    UNetModel3D,
    attention_heads,
    conv_nd,
    timestep_embedding,
)

_GROW = {1: "linear", 3: "trilinear"}


def resize_bilinear(x: torch.Tensor, size: Tuple[int, ...]) -> torch.Tensor:
    """(B, *spatial, C) -> (B, *size, C) as `jax.image.resize(...,
    "bilinear")`: half-pixel centres; a shrink antialiases (2D only)."""
    dims = x.ndim - 2
    if dims == 2:
        return resize_bilinear_antialiased(x, *size)
    if any(s < n for s, n in zip(size, x.shape[1:-1])):
        raise ValueError(f"an antialiased {dims}-D shrink is not supported; only 2D images shrink")
    h = F.interpolate(x.movedim(-1, 1), size=size, mode=_GROW[dims], align_corners=False)
    return h.movedim(1, -1)


class SuperResModel(UNetModel3D):
    """The UNet over (x ++ upsample(low_res)) (unet.py:1073-1087);
    `in_channels` counts both."""

    def forward(self, x, timesteps, low_res, **kwargs):
        upsampled = resize_bilinear(low_res, tuple(x.shape[1:-1]))
        return super().forward(x, timesteps, cond_features=upsampled, **kwargs)


class AttentionPool2d(nn.Module):
    """Attention pooling over the flattened positions of a channels-first
    (B, C, *spatial) map with spacial_dim ** dims positions: the mean token
    is prepended, a learned positional embedding added, and the pooled mean
    token returned, (B, output_dim) (unet.py:27-56)."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int = 1, output_dim: int = 0,
                 dims: int = 2):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(
            torch.randn(embed_dim, spacial_dim ** dims + 1) / embed_dim ** 0.5)
        self.qkv_proj = nn.Conv1d(embed_dim, 3 * embed_dim, 1)
        self.c_proj = nn.Conv1d(embed_dim, output_dim or embed_dim, 1)

    def forward(self, x):
        B, C = x.shape[:2]
        x = x.reshape(B, C, -1)
        x = torch.cat([x.mean(dim=-1, keepdim=True), x], dim=-1) + self.positional_embedding.to(x.dtype)
        qkv = self.qkv_proj(x)
        ch = C // self.num_heads
        q, k, v = qkv.reshape(B * self.num_heads, 3 * ch, -1).split(ch, dim=1)
        a = attention_heads(q, k, v).reshape(B, C, -1)
        return self.c_proj(a)[:, :, 0]


class EncoderUNetModel(nn.Module):
    """The UNet's encoder half with a pooled head (unet.py:1090-1286).
    pool: "adaptive" (GN, SiLU, global mean, 1x..x1 conv), "attention" (GN,
    SiLU, `AttentionPool2d`; needs `image_size`) or "spatial" (the mean of
    each level's output and of the middle block's, concatenated, then a
    2048-wide ReLU MLP)."""

    def __init__(
        self,
        image_size: int = 0,
        in_channels: int = 3,
        model_channels: int = 64,
        out_channels: int = 1000,
        num_res_blocks: int = 2,
        attention_resolutions: Tuple[int, ...] = (4, 8),
        channel_mult: Tuple[int, ...] = (1, 2, 4, 8),
        num_heads: int = 1,
        use_scale_shift_norm: bool = True,
        pool: str = "adaptive",
        dims: int = 2,
        dtype: Union[str, torch.dtype] = torch.float32,
    ):
        super().__init__()
        if pool not in ("adaptive", "attention", "spatial"):
            raise ValueError(f"unknown pool {pool}")
        if pool == "attention" and not image_size:
            raise ValueError("pool='attention' needs image_size")
        self.model_channels, self.pool, self.dims = model_channels, pool, dims
        self.dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        emb_ch = model_channels * 4
        self.time_embed = nn.Sequential(nn.Linear(model_channels, emb_ch), nn.SiLU(), nn.Linear(emb_ch, emb_ch))
        ch = int(channel_mult[0] * model_channels)
        self.input_blocks = nn.ModuleList([TimestepEmbedSequential(conv_nd(dims, in_channels, ch))])
        # the input block after which the spatial pool takes each level's mean
        self._level_ends, level_chans = [], []
        ds = 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock3D(ch, emb_ch, int(mult * model_channels), 0.0, use_scale_shift_norm, dims=dims)]
                ch = int(mult * model_channels)
                if ds in attention_resolutions:
                    layers.append(AttentionBlock3D(ch, num_heads))
                self.input_blocks.append(TimestepEmbedSequential(*layers))
            if level != len(channel_mult) - 1:
                self.input_blocks.append(TimestepEmbedSequential(Downsample3D(ch, dims=dims)))
                ds *= 2
            self._level_ends.append(len(self.input_blocks) - 1)
            level_chans.append(ch)
        self.middle_block = TimestepEmbedSequential(
            ResBlock3D(ch, emb_ch, ch, 0.0, use_scale_shift_norm, dims=dims), AttentionBlock3D(ch, num_heads),
            ResBlock3D(ch, emb_ch, ch, 0.0, use_scale_shift_norm, dims=dims))
        if pool == "adaptive":
            pool_nd = {1: nn.AdaptiveAvgPool1d, 2: nn.AdaptiveAvgPool2d, 3: nn.AdaptiveAvgPool3d}[dims]
            self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(), pool_nd(1), conv_nd(dims, ch, out_channels, k=1),
                                     nn.Flatten())
        elif pool == "attention":
            self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(),
                                     AttentionPool2d(image_size // ds, ch, num_heads, out_channels, dims))
        else:
            self.out = nn.Sequential(nn.Linear(sum(level_chans) + ch, 2048), nn.ReLU(), nn.Linear(2048, out_channels))

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        """x: (B, *spatial, C) channels-last; timesteps (B,) -> (B, out)."""
        with torch.autocast(x.device.type, dtype=self.dtype, enabled=self.dtype != torch.float32):
            emb = self.time_embed(timestep_embedding(timesteps, self.model_channels))
            h = x.permute(0, self.dims + 1, *range(1, self.dims + 1))
            means = []
            for i, block in enumerate(self.input_blocks):
                h = block(h, emb)
                if i in self._level_ends:
                    means.append(h.mean(dim=tuple(range(2, h.ndim))))
            h = self.middle_block(h, emb)
            if self.pool == "spatial":
                return self.out(torch.cat(means + [h.mean(dim=tuple(range(2, h.ndim)))], dim=-1))
            return self.out(h)
