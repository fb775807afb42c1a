"""Chunked full-image evaluation rendering, with the evaluation-only
empty-space skip, and the render with rays sharded over ranks (port of
holo_diffusion_tpu/render_eval.py).

A dense H x W render is split into chunks of `chunk_size_grid //
n_pts_per_ray_evaluation` rays (the reference's chunking: 40960 points ->
640 rays per chunk at the hydrant config), rendered one after another;
device memory stays bounded whatever the image size. `render_image_sharded`
gives each rank of a mesh a contiguous share of the rays instead, rendered
in one forward.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist

from .device import DeviceLike, place
from .geometry.cameras import PerspectiveCameras
from .geometry.rays import RayBundle
from .models.holo_model import HoloDiffusionModel
from .models.renderer import RendererOutput
from .ops.occupancy import occupancy_from_density, tighten_ray_bundle
from .ops.voxel import voxel_coord_grid
from .parallel.mesh import Mesh
from .utils.profiling import span
from .weights import check_keys

Occupancy = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def make_chunk_render_fn(
    model: HoloDiffusionModel,
) -> Callable[[torch.Tensor, RayBundle], RendererOutput]:
    """fn(voxel_grid, ray_bundle_chunk) -> RendererOutput, without autograd."""

    @torch.no_grad()
    def chunk_render(voxel_grid: torch.Tensor, bundle: RayBundle) -> RendererOutput:
        return model.render_rays(voxel_grid, bundle)

    return chunk_render


class _RenderRays(torch.nn.Module):
    def __init__(self, model: HoloDiffusionModel):
        super().__init__()
        self.model = model

    def forward(self, voxel_grid, bundle):
        return self.model.render_rays(voxel_grid, bundle)


def make_chunk_renderer(
    model: HoloDiffusionModel, variables: Mapping[str, torch.Tensor],
) -> Callable[[torch.Tensor, RayBundle], RendererOutput]:
    """`make_chunk_render_fn` with the weights `variables` (a state_dict of
    `model`) bound: fn(voxel_grid, bundle) renders through them, leaving the
    model's own parameters as they are. Raises naming any key `variables`
    lacks or `model` does not have."""
    check_keys(model, variables.keys(), what="variables")
    wrapper = _RenderRays(model)
    bound = {f"model.{k}": v for k, v in variables.items()}

    @torch.no_grad()
    def chunk_render(voxel_grid: torch.Tensor, bundle: RayBundle) -> RendererOutput:
        return torch.func.functional_call(wrapper, bound, (voxel_grid, bundle))

    return chunk_render


@torch.no_grad()
def compute_occupancy(
    model: HoloDiffusionModel,
    voxel_grid: torch.Tensor,
    resolution: int = 64,
    threshold: float = 0.0,
    dilate: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The probe pass of the empty-space skip (ops/occupancy.py):
    ((r, r, r) bool occupancy of the decoded density field, 0-d bool
    `outside_occupied`, whether space outside the voxel volume contributes).
    One implicit-function call over the voxel-centre lattice of
    `resolution`^3 points plus one point far outside the volume, where the
    features sample to zero and the raw density is the constant the density
    net emits for empty space. Compute once per grid, reuse across views."""
    dev = voxel_grid.device
    pts = voxel_coord_grid(resolution, model.volume_extent, device=dev).reshape(-1, 3)
    far_out = torch.full((1, 3), 1e6, dtype=torch.float32, device=dev)
    raw = model.query_density(voxel_grid, torch.cat([pts, far_out]))
    lattice = raw[:-1].reshape(resolution, resolution, resolution)
    return occupancy_from_density(lattice, threshold, dilate), raw[-1] > threshold


@torch.no_grad()
def render_image_chunked(
    model: HoloDiffusionModel,
    camera: PerspectiveCameras,
    voxel_grid: torch.Tensor,
    image_height: Optional[int] = None,
    image_width: Optional[int] = None,
    device: DeviceLike = None,
    empty_space_skip: bool = False,
    occupancy: Optional[Occupancy] = None,
    occupancy_resolution: int = 64,
    occupancy_threshold: float = 0.0,
    occupancy_probes: int = 128,
) -> Dict[str, torch.Tensor]:
    """Render camera[:1] densely in ray chunks (one chunk for the whole image
    when the model's `chunk_size_grid` is 0).

    voxel_grid: (r, r, r, C). Returns (H, W, c) tensors on the device:
    images/depths/masks[/normals]_render. The model moves to `device`
    (CUDA unless the caller passes "cpu").

    With `empty_space_skip`, or an `occupancy` given (a bare (r, r, r) mask,
    outside the volume empty, or the (mask, outside_occupied) pair of
    `compute_occupancy`), each chunk's rays are tightened to their occupied
    segments before rendering; without `occupancy` it is probed here.
    """
    dev = place(model, device)
    H = image_height or model.render_image_height
    W = image_width or model.render_image_width
    n_rays = H * W
    n_pts = model.n_pts_per_ray_evaluation
    step = max((model.chunk_size_grid or n_rays * n_pts) // n_pts, 1)
    bundle = model.full_grid_rays(camera[:1].to(dev), H, W)
    voxel_grid = voxel_grid.to(dev)
    tighten = None
    if empty_space_skip or occupancy is not None:
        if occupancy is None:
            occupancy = compute_occupancy(model, voxel_grid, occupancy_resolution, occupancy_threshold)
        occ_mask, outside = occupancy if isinstance(occupancy, tuple) else (occupancy, False)

        def tighten(chunk):
            return tighten_ray_bundle(chunk, occ_mask, model.volume_extent, n_probe=occupancy_probes,
                                      outside_occupied=outside)
    chunk_renderer = make_chunk_render_fn(model)
    parts = {"images_render": [], "depths_render": [], "masks_render": [], "normals_render": []}
    for start in range(0, n_rays, step):
        with span("holo.chunk"):
            chunk = bundle.slice_rays(slice(start, start + step))
            if tighten is not None:
                chunk = tighten(chunk)
            out = chunk_renderer(voxel_grid, chunk)
            parts["images_render"].append(out.features[0, :, :3])
            parts["depths_render"].append(out.depths[0])
            parts["masks_render"].append(out.masks[0])
            if out.normals is not None:
                parts["normals_render"].append(out.normals[0])
    return {k: torch.cat(v, dim=0).reshape(H, W, -1) for k, v in parts.items() if v}


@torch.no_grad()
def render_image_sharded(
    model: HoloDiffusionModel,
    camera: PerspectiveCameras,
    voxel_grid: torch.Tensor,
    mesh: Mesh,
    image_height: Optional[int] = None,
    image_width: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Dense render of camera[:1] with the rays sharded over `mesh`'s ranks
    and the grid replicated: the H * W rays, padded with copies of the last
    ray to a multiple of the world size (JAX's `jnp.pad(..., mode="edge")`),
    give each rank one contiguous share, rendered in one `render_rays`
    forward; one `all_gather` a output brings the shares to every rank.
    Returns JAX's keys, images/depths/masks_render, as (H, W, c) tensors on
    the mesh's device, on every rank. The model moves to that device."""
    if mesh is None:
        raise ValueError("render_image_sharded needs a mesh (parallel.mesh.make_mesh)")
    dev = place(model, mesh.device)
    H = image_height or model.render_image_height
    W = image_width or model.render_image_width
    n_rays, world = H * W, mesh.world_size
    share = -(-n_rays // world)
    bundle = model.full_grid_rays(camera[:1].to(dev), H, W)
    pad = share * world - n_rays
    if pad:
        bundle = RayBundle(*(torch.cat([x, x[:, -1:].expand(-1, pad, *x.shape[2:])], dim=1)
                             for x in (bundle.origins, bundle.directions, bundle.lengths, bundle.xys)))
    part = bundle.slice_rays(slice(mesh.rank * share, (mesh.rank + 1) * share))
    out = model.render_rays(voxel_grid.to(dev), part)
    result = {}
    for key, x in (("images_render", out.features[0, :, :3]), ("depths_render", out.depths[0]),
                   ("masks_render", out.masks[0])):
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous(), group=mesh.group)
        result[key] = torch.cat(parts)[:n_rays].reshape(H, W, -1)
    return result
