"""DiT-3D, a diffusion transformer over the voxel grid (Mo et al., "DiT-3D:
Exploring Plain Diffusion Transformers for 3D Shape Generation",
arXiv:2307.01831), built of DiT's blocks (Peebles & Xie, "Scalable Diffusion
Models with Transformers", arXiv:2212.09748). The JAX package has no
counterpart: the benchmark's plain reference
(`benchmark/reference/net3d_DiT3D.py`) is what the tests hold it to.

`DiT3D.forward` takes and returns channels-last (B, r, r, r, C) grids like
`UNetModel3D`. A Conv3d of kernel and stride p cuts the grid into (r / p)^3
patch tokens of width d; a fixed 3D sin-cos table (d split into three
d / 3-wide 1D tables, one an axis, DiT-3D's `get_3d_sincos_pos_embed`) is
added; `depth` blocks with adaLN-Zero conditioning on the timestep follow,
each, with c the timestep's embedding:

    (shift1, scale1, gate1, shift2, scale2, gate2) = Linear(d, 6d)(SiLU(c))
    x += gate1 * Attn(LN(x) * (1 + scale1) + shift1)
    x += gate2 * MLP(LN(x) * (1 + scale2) + shift2)

LN has no affine and eps 1e-6; Attn is a qkv projection with bias, softmax
over all tokens of q.k / sqrt(head dim) against v, and an output
projection; the MLP is Linear, tanh-GELU, Linear. A final adaLN layer (shift
and scale), Linear(d, p^3 C) and the unpatchify return the grid.

Departures from DiT-3D: no class embedder (HoloDiffusion is unconditional),
no learned sigma (the variances are FIXED_SMALL), so the output has the
input's C channels; global attention in every block (DiT-3D's windowed
attention is not taken); the sin-cos table is a buffer outside the state
dict. Parameter names are DiT's (`x_embedder.proj`, `t_embedder.mlp.{0,2}`,
`blocks.<i>.{attn.qkv, attn.proj, mlp.fc1, mlp.fc2, adaLN_modulation.1}`,
`final_layer.{adaLN_modulation.1, linear}`). The constructor initialises as
DiT does, adaLN-Zero's zeros included; `zero_init_parameters` names those
zeros for `weights.init_weights`.

Attention (`attention`) follows the kernel rule: its plain version, the
scores written out, runs for CPU tensors; a CUDA tensor goes to
`F.scaled_dot_product_attention` pinned to the memory-efficient backend,
which raises where it cannot run and never falls back to a path that holds
the T x T scores. Spans (`utils/profiling.py` `span`): `holo.dit` (a
forward), `holo.dit.attn` and `holo.dit.mlp` (a block's two branches);
counters (`count`): `dit_forwards`, and `dit_attn_fused` or `dit_attn_plain`
for each attention call by its route.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..utils.profiling import count, span
from .unet3d import timestep_embedding, zero_init_

FREQUENCY_EMBEDDING_SIZE = 256
LN_EPS = 1e-6


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over (B, H, T, D), the scores written out."""
    w = torch.softmax(torch.matmul(q, k.transpose(-2, -1)) * q.shape[-1] ** -0.5, dim=-1)
    return torch.matmul(w, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over (B, H, T, D): the plain version on
    the CPU; on CUDA the memory-efficient fused kernel, or an error."""
    if q.device.type == "cpu":
        count("dit_attn_plain", 1)
        return plain_attention(q, k, v)
    count("dit_attn_fused", 1)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return F.scaled_dot_product_attention(q, k, v)


def sincos_1d(dim: int, pos: torch.Tensor) -> torch.Tensor:
    """(M,) float64 positions -> (M, dim): [sin | cos] of pos / 10000^(2i / dim)."""
    omega = 1.0 / 10000.0 ** (torch.arange(dim // 2, dtype=torch.float64, device=pos.device) / (dim / 2))
    out = pos[:, None] * omega[None]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def sincos_table_3d(dim: int, grid: int) -> torch.Tensor:
    """(grid^3, dim) float32: the first axis' table, then the second's, then
    the third's, each dim / 3 wide; tokens ordered first axis outermost, as
    the patch embedding flattens them."""
    g = torch.arange(grid, dtype=torch.float64)
    axes = torch.meshgrid(g, g, g, indexing="ij")
    return torch.cat([sincos_1d(dim // 3, a.reshape(-1)) for a in axes], dim=1).float()


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1 + scale) + shift


class PatchEmbed3D(nn.Module):
    """Conv3d(C, d, p, stride p) on the channels-first grid -> (B, (r / p)^3, d)."""

    def __init__(self, in_channels: int, hidden_size: int, patch_size: int):
        super().__init__()
        self.proj = nn.Conv3d(in_channels, hidden_size, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).flatten(2).transpose(1, 2)


class TimestepEmbedder(nn.Module):
    """256 sinusoidal frequencies of the timestep, then Linear, SiLU, Linear."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(FREQUENCY_EMBEDDING_SIZE, hidden_size), nn.SiLU(),
                                 nn.Linear(hidden_size, hidden_size))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.mlp(timestep_embedding(t, FREQUENCY_EMBEDDING_SIZE))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        q, k, v = self.qkv(x).reshape(B, T, 3, self.num_heads, C // self.num_heads).permute(2, 0, 3, 1, 4)
        return self.proj(attention(q, k, v).transpose(1, 2).reshape(B, T, C))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.act = nn.GELU(approximate="tanh")
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class DiTBlock(nn.Module):
    """The adaLN-Zero block (module docstring's equations)."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(hidden_size, elementwise_affine=False, eps=LN_EPS)
        self.attn = Attention(hidden_size, num_heads)
        self.norm2 = nn.LayerNorm(hidden_size, elementwise_affine=False, eps=LN_EPS)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden_size, 6 * hidden_size))

    def zero_init_parameters(self) -> List[nn.Parameter]:
        return [self.adaLN_modulation[1].weight, self.adaLN_modulation[1].bias]

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift1, scale1, gate1, shift2, scale2, gate2 = self.adaLN_modulation(c)[:, None].chunk(6, dim=-1)
        with span("holo.dit.attn"):
            x = x + gate1 * self.attn(modulate(self.norm1(x), shift1, scale1))
        with span("holo.dit.mlp"):
            return x + gate2 * self.mlp(modulate(self.norm2(x), shift2, scale2))


class FinalLayer(nn.Module):
    """adaLN (shift and scale) over a plain LN, then Linear(d, p^3 C)."""

    def __init__(self, hidden_size: int, patch_size: int, out_channels: int):
        super().__init__()
        self.norm_final = nn.LayerNorm(hidden_size, elementwise_affine=False, eps=LN_EPS)
        self.linear = nn.Linear(hidden_size, patch_size ** 3 * out_channels)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden_size, 2 * hidden_size))

    def zero_init_parameters(self) -> List[nn.Parameter]:
        return [self.adaLN_modulation[1].weight, self.adaLN_modulation[1].bias, self.linear.weight,
                self.linear.bias]

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = self.adaLN_modulation(c)[:, None].chunk(2, dim=-1)
        return self.linear(modulate(self.norm_final(x), shift, scale))


class DiT3D(nn.Module):
    """DiT-3D on an `input_size`^3 x `in_channels` grid; the defaults are
    DiT-XL/2's widths (depth 28, hidden 1,152, 16 heads, MLP ratio 4, patch
    2) on the reference model's 32^3 x 128 grid."""

    def __init__(
        self,
        in_channels: int = 128,
        input_size: int = 32,
        hidden_size: int = 1152,
        depth: int = 28,
        num_heads: int = 16,
        patch_size: int = 2,
        mlp_ratio: float = 4.0,
    ):
        super().__init__()
        if input_size % patch_size:
            raise ValueError(f"the grid's {input_size} voxels an axis are not a multiple of patch {patch_size}")
        if hidden_size % num_heads or hidden_size % 6:
            raise ValueError(f"hidden_size {hidden_size} must divide by num_heads {num_heads} and by 6 "
                             "(three sin-cos tables of sines and cosines)")
        self.in_channels = self.out_channels = in_channels
        self.input_size, self.patch_size = input_size, patch_size
        self.grid = input_size // patch_size
        self.x_embedder = PatchEmbed3D(in_channels, hidden_size, patch_size)
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.register_buffer("pos_embed", sincos_table_3d(hidden_size, self.grid)[None], persistent=False)
        self.blocks = nn.ModuleList(DiTBlock(hidden_size, num_heads, mlp_ratio) for _ in range(depth))
        self.final_layer = FinalLayer(hidden_size, patch_size, in_channels)
        self.initialize_weights()

    @torch.no_grad()
    def initialize_weights(self) -> None:
        """DiT's: xavier-uniform linear kernels (the patch embedding's as a
        (d, C p^3) matrix), zero biases, the timestep MLP's kernels N(0,
        0.02^2), and adaLN-Zero's zeros."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight)
                nn.init.zeros_(m.bias)
        w = self.x_embedder.proj.weight
        nn.init.xavier_uniform_(w.view(w.shape[0], -1))
        nn.init.zeros_(self.x_embedder.proj.bias)
        nn.init.normal_(self.t_embedder.mlp[0].weight, std=0.02)
        nn.init.normal_(self.t_embedder.mlp[2].weight, std=0.02)
        zero_init_(self)

    def unpatchify(self, h: torch.Tensor) -> torch.Tensor:
        """(B, n^3, p^3 C) tokens -> the channels-last (B, n p, n p, n p, C) grid."""
        B, n, p, C = h.shape[0], self.grid, self.patch_size, self.out_channels
        h = h.reshape(B, n, n, n, p, p, p, C).permute(0, 1, 4, 2, 5, 3, 6, 7)
        return h.reshape(B, n * p, n * p, n * p, C)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        """x: (B, r, r, r, C) channels-last; timesteps: (B,) -> (B, r, r, r, C)."""
        if tuple(x.shape[1:]) != (self.input_size,) * 3 + (self.in_channels,):
            raise ValueError(f"DiT3D takes (B, {self.input_size}, {self.input_size}, {self.input_size}, "
                             f"{self.in_channels}) grids, not {tuple(x.shape)}")
        count("dit_forwards", 1)
        with span("holo.dit"):
            h = self.x_embedder(x.permute(0, 4, 1, 2, 3)) + self.pos_embed
            c = self.t_embedder(timesteps)
            for block in self.blocks:
                h = block(h, c)
            return self.unpatchify(self.final_layer(h, c))
