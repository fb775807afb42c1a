"""The reference of the denoiser `SimpleUnet3D`: guided-diffusion's UNet in
3D, float32, channels-last at its edges. Its parameter names are the
program's (`net_3d.input_blocks.{i}.{j}.in_layers.2`, ...), so one state
dict loads into both sides. Found by `net_3d_class_type` through
`benchmark.reference.net3d_plugin`: `check` refuses what the reference does
not write out, `build` makes the net, `tiny` cuts its args for CPU tests."""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn


def check(args: Dict) -> None:
    """What the reference writes out; anything else is refused, not guessed."""
    checks = {
        "homogeneous_resample": (args.get("homogeneous_resample", True), True),
        "dropout": (args.get("dropout", 0.0), 0.0),
    }
    for key, (got, want) in checks.items():
        if got != want:
            raise NotImplementedError(f"the reference covers {key}={want!r}, not {got!r}")


def build(feature_size: int, args: Dict) -> nn.Module:
    return UNet(feature_size, **args)


def tiny(args: Dict) -> Dict:
    """The CPU tests' cut: 32 channels, one level of downsampling, attention
    below it."""
    return {**args, **dict(model_channels=32, num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[2],
                           num_heads=2)}


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def gn(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, c, eps=1e-5)


class ResBlock(nn.Module):
    def __init__(self, cin: int, emb: int, cout: int):
        super().__init__()
        self.in_layers = nn.Sequential(gn(cin), nn.SiLU(), nn.Conv3d(cin, cout, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb, 2 * cout))
        self.out_layers = nn.Sequential(gn(cout), nn.SiLU(), nn.Dropout(0.0), nn.Conv3d(cout, cout, 3, padding=1))
        self.skip_connection = nn.Identity() if cin == cout else nn.Conv3d(cin, cout, 1)

    def forward(self, x, emb):
        h = self.in_layers(x)
        scale, shift = torch.chunk(self.emb_layers(emb)[..., None, None, None], 2, dim=1)
        h = self.out_layers[3](F.silu(self.out_layers[0](h) * (1 + scale) + shift))
        return self.skip_connection(x) + h


class Attention(nn.Module):
    def __init__(self, c: int, heads: int):
        super().__init__()
        self.heads = heads
        self.norm = gn(c)
        self.qkv = nn.Conv1d(c, 3 * c, 1)
        self.proj_out = nn.Conv1d(c, c, 1)

    def forward(self, x):
        B, C = x.shape[:2]
        qkv = self.qkv(self.norm(x.reshape(B, C, -1)))
        ch = C // self.heads
        q, k, v = qkv.reshape(B * self.heads, 3 * ch, -1).split(ch, dim=1)
        s = 1.0 / math.sqrt(math.sqrt(ch))
        w = torch.softmax(torch.einsum("bct,bcs->bts", q * s, k * s), dim=-1)
        a = torch.einsum("bts,bcs->bct", w, v).reshape(B, C, -1)
        return x + self.proj_out(a).reshape(x.shape)


class Down(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.op = nn.Conv3d(c, c, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Up(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv3d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Stage(nn.ModuleList):
    def forward(self, x, emb):
        for layer in self:
            x = layer(x, emb) if isinstance(layer, ResBlock) else layer(x)
        return x


class UNet(nn.Module):
    """guided-diffusion's UNet in 3D: scale-shift norm, attention at the
    listed downsampling factors, strided-conv down, nearest + conv up."""

    def __init__(self, channels: int, model_channels: int, num_res_blocks: int, attention_resolutions,
                 channel_mult, num_heads: int, **_):
        super().__init__()
        self.mc = model_channels
        emb = 4 * model_channels
        self.time_embed = nn.Sequential(nn.Linear(model_channels, emb), nn.SiLU(), nn.Linear(emb, emb))
        ch = channel_mult[0] * model_channels
        self.input_blocks = nn.ModuleList([Stage([nn.Conv3d(channels, ch, 3, padding=1)])])
        chans, ds = [ch], 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers: List[nn.Module] = [ResBlock(ch, emb, mult * model_channels)]
                ch = mult * model_channels
                if ds in attention_resolutions:
                    layers.append(Attention(ch, num_heads))
                self.input_blocks.append(Stage(layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(Stage([Down(ch)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = Stage([ResBlock(ch, emb, ch), Attention(ch, num_heads), ResBlock(ch, emb, ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + chans.pop(), emb, model_channels * mult)]
                ch = model_channels * mult
                if ds in attention_resolutions:
                    layers.append(Attention(ch, num_heads))
                if level and i == num_res_blocks:
                    layers.append(Up(ch))
                    ds //= 2
                self.output_blocks.append(Stage(layers))
        self.out = nn.Sequential(gn(ch), nn.SiLU(), nn.Conv3d(ch, channels, 3, padding=1))

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """x (B, r, r, r, C) channels-last, t (B,) -> (B, r, r, r, C)."""
        emb = self.time_embed(timestep_embedding(t, self.mc))
        h = x.permute(0, 4, 1, 2, 3).contiguous()
        hs = []
        for block in self.input_blocks:
            h = block(h, emb)
            hs.append(h)
        h = self.middle_block(h, emb)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb)
        return self.out(h).permute(0, 2, 3, 4, 1).contiguous()
