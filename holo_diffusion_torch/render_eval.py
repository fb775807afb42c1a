"""Chunked full-image evaluation rendering, with the evaluation-only
empty-space skip (port of holo_diffusion_tpu/render_eval.py).

A dense H x W render is split into chunks of `chunk_size_grid //
n_pts_per_ray_evaluation` rays (the reference's chunking: 40960 points ->
640 rays per chunk at the hydrant config), rendered one after another;
device memory stays bounded whatever the image size.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch

from .device import DeviceLike, place
from .geometry.cameras import PerspectiveCameras
from .geometry.rays import RayBundle
from .models.holo_model import HoloDiffusionModel
from .models.renderer import RendererOutput
from .ops.occupancy import occupancy_from_density, tighten_ray_bundle
from .ops.voxel import voxel_coord_grid

Occupancy = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def make_chunk_render_fn(
    model: HoloDiffusionModel,
) -> Callable[[torch.Tensor, RayBundle], RendererOutput]:
    """fn(voxel_grid, ray_bundle_chunk) -> RendererOutput, without autograd."""

    @torch.no_grad()
    def chunk_render(voxel_grid: torch.Tensor, bundle: RayBundle) -> RendererOutput:
        return model.render_rays(voxel_grid, bundle)

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
