"""The 3D UNet sharded over the latent's D axis across ranks (port of
holo_diffusion_tpu/parallel/spatial.py): for voxel grids too large for one
device's UNet activations. Forward only: denoising and the DDPM loop.

JAX annotates the latent's sharding and GSPMD inserts the collectives. Here
they are written out, through the mesh's process group (NCCL on the card,
gloo on the CPU; parallel/launch.py, parallel/mesh.py). Rank r holds planes
[r * D / N, (r + 1) * D / N) of every activation at full H, W and C,
channels-first (B, C, D, H, W), and:

  * every 3^3 conv first takes a halo of one plane from each neighbouring
    rank (one `all_gather` of every rank's first and last plane; the edge
    ranks take zeros, so the result equals padding 1), then convolves with
    D padding 0. The stride-2 conv of `Downsample3D` needs only the left
    neighbour's plane: slabs start at even planes, so its output slab is
    the rank's slab of the output;
  * nearest upsampling, average pooling and the 1^3 skip conv are local;
  * GroupNorm sums its per-(B, group) statistics over the ranks in two
    passes, the sum and then the centred sum of squares (two `all_reduce`s),
    in float32;
  * attention keeps its queries local and `all_gather`s the keys and values
    of every rank (tokens flatten with D outermost, so a rank's tokens are
    one contiguous range); the softmax over all keys runs in float32.

**Replicated levels.** A level whose D is not a multiple of the world size
(at hydrant's 16^3 and 2 ranks, the fifth level's 1 plane) is computed
whole on every rank: the slab is all-gathered before the `Downsample3D`
that enters it, every deeper level runs the plain modules on the full
tensor, and the `Upsample3D` that leaves it slices the rank's slab again.
GSPMD's placement does the equivalent for JAX.

`make_sharded_denoiser` takes the full latent and returns the full output
on every rank (JAX's `out_shardings` gathered by `np.asarray`); the sampling
loop runs the slab form underneath it and keeps the rank's slab until its
end. `COUNTS` counts the collectives by kind.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..device import place
from ..models import diffusion as gd
from ..models.holo_model import HoloDiffusionModel
from ..models.unet3d import (
    AttentionBlock3D,
    Downsample3D,
    ResBlock3D,
    UNetModel3D,
    Upsample3D,
    _resize_nearest_2x,
    attention_heads,
)
from .mesh import Mesh

# collectives launched, by kind: halo exchanges, GroupNorm all_reduces,
# attention key/value gathers, slab gathers (replicated levels, outputs)
COUNTS = {"halo": 0, "group_norm": 0, "attention": 0, "gather": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _all_gather(x: torch.Tensor, mesh: Mesh, kind: str):
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    COUNTS[kind] += 1
    return parts


def _all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    dist.all_reduce(x, group=mesh.group)
    COUNTS["group_norm"] += 1
    return x


@dataclasses.dataclass(frozen=True)
class SpatialSharding:
    """The rank's slab of the D axis of a (B, D, H, W, C) latent."""

    mesh: Mesh

    def bounds(self, depth: int) -> slice:
        n = depth // self.mesh.world_size
        return slice(self.mesh.rank * n, (self.mesh.rank + 1) * n)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """The full latent -> this rank's slab (B, D / N, H, W, C)."""
        return x[:, self.bounds(x.shape[1])]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's slab -> the full latent, on every rank."""
        return torch.cat(_all_gather(x, self.mesh, "gather"), dim=1)


def spatial_sharding(mesh: Mesh) -> SpatialSharding:
    """The sharding of (B, D, H, W, C) latents: D over the mesh's ranks."""
    return SpatialSharding(mesh)


class _Slab:
    """The sharded forward of one UNetModel3D over one mesh (channels-first
    slabs, D at dim 2)."""

    def __init__(self, unet: UNetModel3D, mesh: Mesh):
        if unet.dims != 3:
            raise ValueError(f"spatial sharding splits the D axis of a 3D UNet, not dims={unet.dims}")
        self.unet, self.mesh = unet, mesh
        self.homogeneous = next((m.homogeneous for m in unet.modules() if isinstance(m, Upsample3D)), True)

    def sharded(self, depth: int, ds: int) -> bool:
        """Whether the level at downsampling factor `ds` is sharded."""
        d = depth // ds if self.homogeneous else depth
        return d % self.mesh.world_size == 0

    # -- the ops of a sharded level
    def halo(self, x: torch.Tensor, right: bool = True) -> torch.Tensor:
        """x with its neighbours' planes on D (zeros at the edges)."""
        edges = torch.stack([x[:, :, 0], x[:, :, -1]])
        parts = _all_gather(edges, self.mesh, "halo")
        r, n = self.mesh.rank, self.mesh.world_size
        zero = torch.zeros_like(edges[0])
        left = parts[r - 1][1] if r > 0 else zero
        planes = [left[:, :, None], x]
        if right:
            planes.append((parts[r + 1][0] if r < n - 1 else zero)[:, :, None])
        return torch.cat(planes, dim=2)

    def conv(self, conv: torch.nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
        """A 3^3 conv of padding 1 (stride 1, or stride 2 on every axis)."""
        if conv.kernel_size[0] == 1:
            return conv(x)
        d_stride = conv.stride[0]
        xp = self.halo(x, right=d_stride == 1)
        return F.conv3d(xp, conv.weight, conv.bias, conv.stride, (0, 1, 1))

    def group_norm(self, gn: torch.nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
        """GroupNorm32 over every rank's planes, in float32, cast back."""
        B, C = x.shape[:2]
        xf = x.float().reshape(B, gn.num_groups, -1)
        count = xf.shape[-1] * self.mesh.world_size
        mean = _all_reduce(xf.sum(-1), self.mesh) / count
        d = xf - mean[..., None]
        var = _all_reduce((d * d).sum(-1), self.mesh) / count
        y = (d * torch.rsqrt(var + gn.eps)[..., None]).reshape(B, C, -1)
        y = y * gn.weight[:, None] + gn.bias[:, None]
        return y.reshape(x.shape).type(x.dtype)

    def attention(self, blk: AttentionBlock3D, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[:2]
        q, k, v = blk.split_heads(blk.qkv(self.group_norm(blk.norm, x.reshape(B, C, -1))))
        ch = q.shape[1]
        kv = torch.cat(_all_gather(torch.cat([k, v], dim=1), self.mesh, "attention"), dim=-1)
        a = attention_heads(q, kv[:, :ch], kv[:, ch:]).reshape(B, C, -1)
        return x + blk.proj_out(a).reshape(x.shape)

    def res_block(self, blk: ResBlock3D, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.conv(blk.in_layers[2], F.silu(self.group_norm(blk.in_layers[0], x)))
        emb_out = blk.emb_layers(emb).type(h.dtype)[..., None, None, None]
        norm, drop, conv = blk.out_layers[0], blk.out_layers[2], blk.out_layers[3]
        if blk.use_scale_shift_norm:
            scale, shift = torch.chunk(emb_out, 2, dim=1)
            h = self.group_norm(norm, h) * (1 + scale) + shift
        else:
            h = self.group_norm(norm, h + emb_out)
        h = self.conv(conv, drop(F.silu(h)))
        return blk.skip_connection(x) + h

    def layer(self, layer, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        if isinstance(layer, ResBlock3D):
            return self.res_block(layer, x, emb)
        if isinstance(layer, AttentionBlock3D):
            return self.attention(layer, x)
        if isinstance(layer, Downsample3D):
            return self.conv(layer.op, x) if isinstance(layer.op, torch.nn.Conv3d) else layer(x)
        if isinstance(layer, Upsample3D):
            x = _resize_nearest_2x(x, layer.homogeneous, 3)
            return self.conv(layer.conv, x) if hasattr(layer, "conv") else x
        return self.conv(layer, x)  # the input conv

    # -- the walk over the UNet's blocks
    def block(self, block, h: torch.Tensor, emb: torch.Tensor, depth: int, ds: int):
        """One TimestepEmbedSequential at level `ds` -> (output, its level):
        each layer sharded or whole; a level boundary gathers or slices."""
        for layer in block:
            ds_out = ds * 2 if isinstance(layer, Downsample3D) else ds // 2 if isinstance(layer, Upsample3D) else ds
            was, now = self.sharded(depth, ds), self.sharded(depth, ds_out)
            if was and not now:  # into a replicated level
                h = torch.cat(_all_gather(h, self.mesh, "gather"), dim=2)
            if was and now:
                h = self.layer(layer, h, emb)
            else:
                h = layer(h, emb) if isinstance(layer, ResBlock3D) else layer(h)
            if now and not was:  # back out of a replicated level
                n = h.shape[2] // self.mesh.world_size
                h = h[:, :, self.mesh.rank * n:(self.mesh.rank + 1) * n]
            ds = ds_out
        return h, ds

    def __call__(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        """The rank's (B, D / N, H, W, C) slab -> the output's slab."""
        unet = self.unet
        depth = x.shape[1] * self.mesh.world_size
        with unet.autocast(x.device.type):
            emb = unet.embed(timesteps)
            h = unet.to_channels_first(x)
            hs, ds = [], 1
            for block in unet.input_blocks:
                h, ds = self.block(block, h, emb, depth, ds)
                hs.append(h)
            h, ds = self.block(unet.middle_block, h, emb, depth, ds)
            for block in unet.output_blocks:
                h, ds = self.block(block, torch.cat([h, hs.pop()], dim=1), emb, depth, ds)
            h = h.to(x.dtype)
            out = self.conv(unet.out[2], F.silu(self.group_norm(unet.out[0], h)))
            return unet.to_channels_last(out)


def _unet_of(model) -> UNetModel3D:
    """A HoloDiffusionModel's denoiser is its net_3d (apply_net_3d); only
    the UNet is sharded, any other denoiser is refused by its class."""
    net = model.net_3d if isinstance(model, HoloDiffusionModel) else model
    if not isinstance(net, UNetModel3D):
        raise NotImplementedError(f"spatial sharding covers the 3D UNet (UNetModel3D) alone, "
                                  f"not a {type(net).__name__}")
    return net


def _slab_denoiser(model, mesh: Mesh) -> _Slab:
    """fn(slab, t): the denoiser on the rank's (B, D / N, H, W, C) slab ->
    the output's slab. `model`: a UNetModel3D or a HoloDiffusionModel
    (through its `net_3d`, as `apply_net_3d`)."""
    unet = _unet_of(model)
    if mesh is None or mesh.group is None:
        raise ValueError("the sharded denoiser needs a mesh (parallel.mesh.make_mesh)")
    return _Slab(unet, mesh)


def make_sharded_denoiser(model, mesh: Mesh) -> Callable:
    """fn(x, t) -> the denoiser's output with the latent's D axis sharded
    over `mesh`: fn takes the full (B, D, H, W, C) latent on every rank and
    returns the full output on every rank. `model`: a UNetModel3D or a
    HoloDiffusionModel (through its `net_3d`, as `apply_net_3d`). D must be
    a multiple of the world size. No autograd."""
    slab = _slab_denoiser(model, mesh)
    sharding = spatial_sharding(mesh)

    @torch.no_grad()
    def fn(x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        if x.shape[1] % mesh.world_size:
            raise ValueError(f"D {x.shape[1]} is not divisible by the world size {mesh.world_size}")
        return sharding.gather(slab(sharding.shard(x), timesteps))

    return fn


@torch.no_grad()
def sample_random_voxel_features_sharded(
    model: HoloDiffusionModel,
    generator: Optional[torch.Generator],
    mesh: Mesh,
    max_iter: Optional[int] = None,
    noise: Optional[torch.Tensor] = None,
    step_noise: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Ancestral DDPM sampling with the latent sharded over `mesh` (the
    multi-rank `sampling.sample_random_voxel_features`) -> the full
    (1, r, r, r, C) grid in [-1, 1] on every rank. Every rank draws the
    full-size noise from `generator` (seeded alike on every rank) in the
    one-device sampler's order, or takes `noise` (x_T) and `step_noise` (one
    tensor per step), and keeps its slab; so the result is the one-device
    sampler's for the same draws, up to rounding. The slabs are gathered
    once, at the end. The model moves to the mesh's device."""
    if model.resol % mesh.world_size:
        raise ValueError(f"resol {model.resol} is not divisible by the world size {mesh.world_size}")
    dev = place(model, mesh.device)
    shape = (1, model.resol, model.resol, model.resol, model.feature_size)
    sharding = spatial_sharding(mesh)
    net = _slab_denoiser(model, mesh)
    sched = model.schedule
    ts = gd.ddpm_timesteps(sched.num_timesteps, max_iter)
    if step_noise is not None and len(step_noise) != len(ts):
        raise ValueError(f"step_noise has {len(step_noise)} tensors for {len(ts)} steps")
    x = noise.to(dev) if noise is not None else torch.randn(shape, generator=generator, device=dev)
    x = sharding.shard(x)
    for i, t_scalar in enumerate(ts):
        t = torch.full((1,), t_scalar, dtype=torch.long, device=dev)
        n = (step_noise[i].to(dev) if step_noise is not None
             else torch.randn(shape, generator=generator, device=dev, dtype=x.dtype))
        x = gd.p_sample(sched, net, x, t, noise=sharding.shard(n))["sample"]
    return torch.clamp(sharding.gather(x), -1.0, 1.0)
