"""Chunked full-image evaluation rendering (port of
holo_diffusion_tpu/render_eval.py without the occupancy skip).

A dense H x W render is split into chunks of `chunk_size_grid //
n_pts_per_ray_evaluation` rays (the reference's chunking: 40960 points ->
640 rays per chunk at the hydrant config), rendered one after another;
device memory stays bounded whatever the image size.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .device import DeviceLike, place
from .geometry.cameras import PerspectiveCameras
from .geometry.rays import RayBundle
from .models.holo_model import HoloDiffusionModel
from .models.renderer import RendererOutput


def make_chunk_render_fn(
    model: HoloDiffusionModel,
) -> Callable[[torch.Tensor, RayBundle], RendererOutput]:
    """fn(voxel_grid, ray_bundle_chunk) -> RendererOutput, without autograd."""

    @torch.no_grad()
    def chunk_render(voxel_grid: torch.Tensor, bundle: RayBundle) -> RendererOutput:
        return model.render_rays(voxel_grid, bundle)

    return chunk_render


@torch.no_grad()
def render_image_chunked(
    model: HoloDiffusionModel,
    camera: PerspectiveCameras,
    voxel_grid: torch.Tensor,
    image_height: Optional[int] = None,
    image_width: Optional[int] = None,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """Render camera[:1] densely in ray chunks (one chunk for the whole image
    when the model's `chunk_size_grid` is 0).

    voxel_grid: (r, r, r, C). Returns (H, W, c) tensors on the device:
    images/depths/masks[/normals]_render. The model moves to `device`
    (CUDA unless the caller passes "cpu").
    """
    dev = place(model, device)
    H = image_height or model.render_image_height
    W = image_width or model.render_image_width
    n_rays = H * W
    n_pts = model.n_pts_per_ray_evaluation
    step = max((model.chunk_size_grid or n_rays * n_pts) // n_pts, 1)
    bundle = model.full_grid_rays(camera[:1].to(dev), H, W)
    voxel_grid = voxel_grid.to(dev)
    chunk_renderer = make_chunk_render_fn(model)
    parts = {"images_render": [], "depths_render": [], "masks_render": [], "normals_render": []}
    for start in range(0, n_rays, step):
        out = chunk_renderer(voxel_grid, bundle.slice_rays(slice(start, start + step)))
        parts["images_render"].append(out.features[0, :, :3])
        parts["depths_render"].append(out.depths[0])
        parts["masks_render"].append(out.masks[0])
        if out.normals is not None:
            parts["normals_render"].append(out.normals[0])
    return {k: torch.cat(v, dim=0).reshape(H, W, -1) for k, v in parts.items() if v}
