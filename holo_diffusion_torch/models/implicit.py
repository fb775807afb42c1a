"""Voxel-grid implicit function: trilinear world-space sampling + RenderMLP
decode (port of holo_diffusion_tpu/models/implicit.py).

Three ways to decode, chosen by `fuse_decode` and `collapse_density`:

- fused (`ops/fused_decode.py`): sample, collapsed density affine and
  radiance head in one kernel, with the normals' field gradient in the same
  launch when `render_normals` is set;
- collapsed: the grid projected once by the collapsed density affine
  (C -> hidden + 1), sampled by `trilinear_sample_fused`, then the radiance
  head;
- layer by layer: sample the C channels with `sampler`, then the RenderMLP.

Samplers: "fused" (`ops/kron_sample.py`, K4 with K5/K6 as its cotangents),
"packed" and "gather" (plain PyTorch), "pallas" (`ops/fused_render.py`,
K7, forward only) and "onehot_xla" (plain PyTorch). Normals off the fused
path are the analytic field gradient (one K6 launch) when the density net
is collapsible, else autograd of the density head through the sampler.

"auto" resolves by `decode_route` and `sampler_route`. Each decode call
adds 1 to the counter `decodes_fused` or `decodes_layer`
(`utils/profiling.py` `count`, while a torch profiler records). Inside a
chunk's CUDA graph (`render_eval.py`) the call, its counter and its
`holo.decode` span run at capture alone, not at each replay.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.fused_decode import fused_sample_decode, kernels_take
from ..ops.fused_render import trilinear_sample_onehot_xla, trilinear_sample_pallas
from ..ops.kron_sample import DEFAULT_MAX_GC, KERNEL_MAX_GC, trilinear_point_gradient, trilinear_sample_fused
from ..ops.voxel import pack_corner_grid, sample_packed_voxel_grid_world, sample_voxel_grid_world
from ..utils.profiling import count, span
from .render_mlp import RenderMLP

SAMPLERS = ("auto", "fused", "packed", "gather", "pallas", "onehot_xla")
MODES = ("auto", "on", "off")


def _size_limit(device_type: str) -> int:
    """Largest D*H*W*C that "auto" sends to the kernels' path: on the card
    what the kernels index; elsewhere DEFAULT_MAX_GC, the TPU's limit, so
    that a CPU run takes the branch the JAX package takes on its
    accelerator."""
    return KERNEL_MAX_GC if device_type == "cuda" else DEFAULT_MAX_GC


def sampler_route(device_type: str, grid_shape) -> str:
    """The sampler "auto" takes for a (D, H, W, C) grid on `device_type`:
    "fused" (K4-K6) within the size limit, else "packed"."""
    return "fused" if math.prod(grid_shape) <= _size_limit(device_type) else "packed"


def decode_route(device_type: str, grid_shape, fusable: bool, hidden: int, pe_dim: int) -> str:
    """The decode "auto" takes: "fused" (K1/K3 with K2) for a fusable
    decoder on a grid within the size limit whose shape the fused-decode
    kernels take (`ops.fused_decode.kernels_take`, on either device, so
    the CPU runs the branch the card would), else "layer" (layer by
    layer)."""
    if (fusable and math.prod(grid_shape) <= _size_limit(device_type)
            and kernels_take(int(grid_shape[-1]), hidden, pe_dim)):
        return "fused"
    return "layer"


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    # torch F.normalize semantics: v / max(||v||, eps)
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


class VoxelGridImplicitFunction(nn.Module):
    """forward(grid, points, directions) -> (densities, features, aux);
    grid: (D, H, W, C) channels-last, one grid per call.

    `sampler`, `collapse_density` and `fuse_decode` take the JAX package's
    values; "auto" takes the fused decode when the decoder is fusable, the
    grid is within the size limit and the fused-decode kernels take the
    shape (`ops.fused_decode.kernels_take`: C 32, 64 or 128, hidden within
    their shared memory), else the layer-by-layer decode with the "fused"
    sampler under the same size limit ("packed" above it); no collapse. The
    size limit is what the kernels index on the card, and DEFAULT_MAX_GC
    (16^3 x 64, the TPU's) elsewhere (`decode_route`, `sampler_route`).
    `sampler_precision` is accepted for the JAX signature and has no effect:
    every sampler computes in float32."""

    def __init__(
        self,
        resol: int = 32,
        volume_extent: float = 8.0,
        n_hidden: int = 128,
        render_normals: bool = False,
        render_mlp_args: Optional[dict] = None,
        sampler: str = "auto",
        sampler_precision: str = "default",
        collapse_density: str = "auto",
        fuse_decode: str = "auto",
    ):
        super().__init__()
        if sampler not in SAMPLERS:
            raise ValueError(f"sampler={sampler!r}: one of {SAMPLERS}")
        for name, mode in (("collapse_density", collapse_density), ("fuse_decode", fuse_decode)):
            if mode not in MODES:
                raise ValueError(f"{name}={mode!r}: one of {MODES}")
        self.resol = resol
        self.volume_extent = volume_extent
        self.render_normals = render_normals
        self.sampler = sampler
        self.sampler_precision = sampler_precision
        self.collapse_density = collapse_density
        self.fuse_decode = fuse_decode
        self.render_mlp = RenderMLP(**{**(render_mlp_args or {}), "input_dims": n_hidden})

    def _sample(self, voxel_grid: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
        sampler = self.sampler
        if sampler == "auto":
            sampler = sampler_route(voxel_grid.device.type, voxel_grid.shape)
        extent = self.volume_extent
        if sampler == "fused":
            return trilinear_sample_fused(voxel_grid, points, extent, precision=self.sampler_precision)
        if sampler == "packed":
            return sample_packed_voxel_grid_world(pack_corner_grid(voxel_grid), points, extent)
        if sampler == "pallas":
            return trilinear_sample_pallas(voxel_grid, points, extent)
        if sampler == "onehot_xla":
            return trilinear_sample_onehot_xla(voxel_grid, points, extent)
        return sample_voxel_grid_world(voxel_grid, points, extent)

    def forward(
        self,
        voxel_grid: torch.Tensor,
        ray_points_world: torch.Tensor,
        ray_directions: Optional[torch.Tensor] = None,
    ):
        """voxel_grid: (D, H, W, C); ray_points_world: (..., P, 3);
        ray_directions: (..., 3) per ray, or None (unit ones, the pts_3d path,
        holo_voxel_grid_implicit_function.py:232-238)."""
        with span("holo.decode"):
            return self._decode(voxel_grid, ray_points_world, ray_directions)

    def _decode(self, voxel_grid, ray_points_world, ray_directions):
        mlp = self.render_mlp
        fuse = self.fuse_decode
        if fuse == "auto":
            route = decode_route(voxel_grid.device.type, voxel_grid.shape, mlp.decode_is_fusable,
                                 mlp.dnet_hidden_dim, mlp.pe_dim)
            fuse = "on" if route == "fused" else "off"
        if fuse == "on":
            count("decodes_fused", 1)
            return self._fused_decode(voxel_grid, ray_points_world, ray_directions)
        count("decodes_layer", 1)

        if ray_directions is None:
            dirs = torch.ones_like(ray_points_world)
        else:
            dirs = _normalize(ray_directions)[..., None, :].expand(ray_points_world.shape)
        if self.collapse_density == "on":
            if not mlp.density_net_is_collapsible:
                raise ValueError("collapse_density='on' needs a collapsible density net (feat_emb_dims=0)")
            A, c = mlp.density_affine()
            grid_proj = torch.einsum("dhwc,ce->dhwe", voxel_grid, A)
            pre = trilinear_sample_fused(
                grid_proj, ray_points_world, self.volume_extent, precision=self.sampler_precision) + c
            densities, colour = mlp.decode_from_preactivation(pre, dirs)
        else:
            densities, colour = mlp(self._sample(voxel_grid, ray_points_world), dirs)
        aux = {}
        if self.render_normals:
            aux["normals"] = _normalize(self._density_gradient(voxel_grid, ray_points_world))
        return densities, colour, aux

    def _density_gradient(self, voxel_grid: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
        """d density / d points (..., 3), carrying no gradient (normals are
        an output no loss reads, as in the JAX package)."""
        mlp = self.render_mlp
        if mlp.density_net_is_collapsible:
            # the density is a trilinear field of the C = 1 grid grid @ A[:, -1]
            with torch.no_grad():
                A, _ = mlp.density_affine()
                g1 = torch.einsum("dhwc,c->dhw", voxel_grid, A[:, -1])[..., None]
            return trilinear_point_gradient(g1, points, self.volume_extent, precision=self.sampler_precision)
        with torch.enable_grad():
            p = points.detach().requires_grad_(True)
            density = mlp.density(self._sample(voxel_grid.detach(), p))
            (grads,) = torch.autograd.grad(density.sum(), p)
        return grads

    def _fused_decode(self, voxel_grid, ray_points_world, ray_directions):
        mlp = self.render_mlp
        if not mlp.decode_is_fusable:
            raise ValueError("fuse_decode='on' needs a fusable decoder (RenderMLP.decode_is_fusable)")
        A, c = mlp.density_affine()
        Wr, br = mlp.radiance_linear()
        # a ray's direction is constant along it: encode once per ray
        if ray_directions is None:
            dirs = torch.ones(
                ray_points_world.shape[:-2] + (3,),
                dtype=ray_points_world.dtype, device=ray_points_world.device,
            )
        else:
            dirs = _normalize(ray_directions)
        pe_rays = mlp.encode_dirs(dirs)
        g1 = None
        if self.render_normals:
            g1 = torch.einsum("dhwc,c->dhw", voxel_grid, A[:, -1]).detach()
        out = fused_sample_decode(
            voxel_grid, A, c, Wr, br, ray_points_world, pe_rays,
            extent=self.volume_extent, hidden=mlp.dnet_hidden_dim, g1=g1,
        )
        aux = {}
        if g1 is not None:
            densities, colour, grads = out
            aux["normals"] = _normalize(grads)
        else:
            densities, colour = out
        return densities, colour, aux
