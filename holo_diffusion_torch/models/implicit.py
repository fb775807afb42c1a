"""Voxel-grid implicit function: trilinear world-space sampling + RenderMLP
decode (port of holo_diffusion_tpu/models/implicit.py, fused-decode path).

The decode runs as one kernel (`ops/fused_decode.py`): sample, collapsed
density affine and radiance head together, with the normals' field gradient
in the same launch when `render_normals` is set.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.fused_decode import fused_sample_decode
from .render_mlp import RenderMLP


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    # torch F.normalize semantics: v / max(||v||, eps)
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


class VoxelGridImplicitFunction(nn.Module):
    """forward(grid, points, directions) -> (densities, features, aux);
    grid: (D, H, W, C) channels-last, one grid per call."""

    def __init__(
        self,
        resol: int = 32,
        volume_extent: float = 8.0,
        n_hidden: int = 128,
        render_normals: bool = False,
        render_mlp_args: Optional[dict] = None,
    ):
        super().__init__()
        self.resol = resol
        self.volume_extent = volume_extent
        self.render_normals = render_normals
        self.render_mlp = RenderMLP(**{**(render_mlp_args or {}), "input_dims": n_hidden})

    def forward(
        self,
        voxel_grid: torch.Tensor,
        ray_points_world: torch.Tensor,
        ray_directions: Optional[torch.Tensor] = None,
    ):
        """voxel_grid: (D, H, W, C); ray_points_world: (..., P, 3);
        ray_directions: (..., 3) per ray, or None (unit ones, the pts_3d path,
        holo_voxel_grid_implicit_function.py:232-238)."""
        mlp = self.render_mlp
        if not mlp.decode_is_fusable:
            raise NotImplementedError(
                "this render_mlp_args decoder is not fusable; the unfused path "
                "needs the trilinear-sample kernels K4/K6 (ROADMAP.md, queue 2: "
                "kron_sample.py::_fwd_kernel and _dpoints_kernel)"
            )
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
