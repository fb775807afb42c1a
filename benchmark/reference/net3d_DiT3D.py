"""The reference of the denoiser `DiT3D`: DiT-3D (Mo et al., arXiv:2307.01831)
built of DiT's adaLN-Zero blocks (Peebles & Xie, arXiv:2212.09748), float32,
channels-last at its edges. Its parameter names are the program's
(`net_3d.x_embedder.proj`, `net_3d.t_embedder.mlp.{0,2}`,
`net_3d.blocks.<i>.{attn.qkv, attn.proj, mlp.fc1, mlp.fc2, adaLN_modulation.1}`,
`net_3d.final_layer.{adaLN_modulation.1, linear}`), so one state dict loads
into both sides. Found by `net_3d_class_type` through
`benchmark.reference.net3d_plugin`: `check` refuses what the reference does
not write out, `build` makes the net, `tiny` cuts its args for CPU tests.

Departures from DiT-3D, as the program makes them: no class embedder
(HoloDiffusion is unconditional); global attention in every block (DiT-3D's
windowed option is not taken); the grid's C channels in and out (128 at the
32^3 x 128 grid) in place of 3, with no learned sigma; the 3D sin-cos table
is computed from the input's grid at each call and is no parameter.

Attention is softmax(q k^T / sqrt(head dim)) v written out one head at a
time, so a head's T x T scores are the largest intermediate. Autograd would
keep each head's scores and softmax, 2.1 GB a block at 4,096 tokens and 16
heads, 60 GB a pass; so under autograd each block runs in
`torch.utils.checkpoint` and the backward holds one block's at a time."""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

KEYS = ("hidden_size", "depth", "num_heads", "patch_size", "mlp_ratio")
FREQUENCIES = 256
EPS = 1e-6


def check(args: Dict) -> None:
    """What the reference writes out; anything else is refused, not guessed."""
    other = sorted(set(args) - set(KEYS))
    if other:
        raise NotImplementedError(f"the reference covers DiT3D's {list(KEYS)}, not {other} "
                                  "(no windowed attention, no class embedder, no learned sigma)")
    missing = sorted(set(KEYS) - set(args))
    if missing:
        raise NotImplementedError(f"the reference needs DiT3D's {missing}")


def build(feature_size: int, args: Dict) -> nn.Module:
    return DiT(feature_size, **args)


def tiny(args: Dict) -> Dict:
    """The CPU tests' cut: hidden 48, 2 blocks, 4 heads of 12, patch 2."""
    return {**args, **dict(hidden_size=48, depth=2, num_heads=4, patch_size=2, mlp_ratio=4.0)}


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def sincos_positions(dim: int, n: int, device) -> torch.Tensor:
    """(n^3, dim): for each axis of the n^3 token grid (first axis
    outermost) a dim / 3-wide table [sin | cos](pos / 10000^(2i / (dim / 3)))."""
    d = dim // 3
    omega = 1.0 / 10000.0 ** (torch.arange(d // 2, dtype=torch.float64, device=device) * 2.0 / d)
    pos = torch.arange(n, dtype=torch.float64, device=device)
    one = torch.cat([torch.sin(pos[:, None] * omega), torch.cos(pos[:, None] * omega)], dim=1)  # (n, d)
    i = torch.arange(n ** 3, device=device)
    return torch.cat([one[i // (n * n)], one[(i // n) % n], one[i % n]], dim=1).float()


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], eps=EPS)


class PatchEmbed(nn.Module):
    def __init__(self, c: int, d: int, p: int):
        super().__init__()
        self.proj = nn.Conv3d(c, d, p, stride=p)


class TimestepEmbedder(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(FREQUENCIES, d), nn.SiLU(), nn.Linear(d, d))


class Attention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, d = x.shape
        hd = d // self.heads
        q, k, v = self.qkv(x).reshape(B, T, 3, self.heads, hd).unbind(2)
        outs = []
        for h in range(self.heads):
            s = torch.matmul(q[:, :, h], k[:, :, h].transpose(1, 2)) / math.sqrt(hd)
            outs.append(torch.matmul(torch.softmax(s, dim=-1), v[:, :, h]))
        return self.proj(torch.cat(outs, dim=-1))


class Mlp(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class Block(nn.Module):
    def __init__(self, d: int, heads: int, mlp_ratio: float):
        super().__init__()
        self.attn = Attention(d, heads)
        self.mlp = Mlp(d, int(d * mlp_ratio))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(d, 6 * d))

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        m = self.adaLN_modulation(c)[:, None]
        shift1, scale1, gate1, shift2, scale2, gate2 = m.chunk(6, dim=-1)
        x = x + gate1 * self.attn(layer_norm(x) * (1 + scale1) + shift1)
        return x + gate2 * self.mlp(layer_norm(x) * (1 + scale2) + shift2)


class FinalLayer(nn.Module):
    def __init__(self, d: int, p: int, c: int):
        super().__init__()
        self.linear = nn.Linear(d, p ** 3 * c)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(d, 2 * d))

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = self.adaLN_modulation(c)[:, None].chunk(2, dim=-1)
        return self.linear(layer_norm(x) * (1 + scale) + shift)


class DiT(nn.Module):
    """DiT-3D: patchify, sin-cos positions, `depth` adaLN-Zero blocks, the
    final adaLN layer, unpatchify."""

    def __init__(self, channels: int, hidden_size: int, depth: int, num_heads: int, patch_size: int,
                 mlp_ratio: float):
        super().__init__()
        self.c, self.d, self.p = channels, hidden_size, patch_size
        self.x_embedder = PatchEmbed(channels, hidden_size, patch_size)
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.blocks = nn.ModuleList(Block(hidden_size, num_heads, mlp_ratio) for _ in range(depth))
        self.final_layer = FinalLayer(hidden_size, patch_size, channels)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """x (B, r, r, r, C) channels-last, t (B,) -> (B, r, r, r, C)."""
        B, r, p, C = x.shape[0], x.shape[1], self.p, self.c
        n = r // p
        h = self.x_embedder.proj(x.permute(0, 4, 1, 2, 3)).reshape(B, self.d, n ** 3).transpose(1, 2)
        h = h + sincos_positions(self.d, n, x.device)
        c = self.t_embedder.mlp(timestep_embedding(t, FREQUENCIES))
        for block in self.blocks:
            h = checkpoint(block, h, c, use_reentrant=False) if torch.is_grad_enabled() else block(h, c)
        h = self.final_layer(h, c).reshape(B, n, n, n, p, p, p, C)
        return h.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, r, r, r, C)
