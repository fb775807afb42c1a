"""Synthetic posed-image scenes (port of holo_diffusion_tpu/data/synthetic.py):
a hard sphere at the origin coloured by its surface normal, ray-traced with
the framework's own camera model, with fg masks and depth maps."""
from __future__ import annotations

import numpy as np
import torch

from ..geometry.cameras import PerspectiveCameras, look_at_view_transform, transform_points_world_to_camera
from ..geometry.rays import sample_rays_full_grid
from .frame_data import FrameData


def make_synthetic_scene(
    n_views: int = 10,
    image_size: int = 32,
    radius: float = 1.0,
    dist: float = 4.0,
    seed: int = 0,
    focal: float = 2.5,
    device=None,
) -> FrameData:
    """`n_views` views on a circle of azimuths, elevations drawn from `seed`
    (numpy, the JAX package's draws), made on `device`."""
    rng = np.random.RandomState(seed)
    azim = np.linspace(0, 360, n_views, endpoint=False)
    elev = rng.uniform(-30, 45, n_views)
    R, T = look_at_view_transform(dist=dist, elev=elev, azim=azim)
    cams = PerspectiveCameras(
        R=R, T=T, focal_length=torch.full((n_views, 2), float(focal)),
        principal_point=torch.zeros((n_views, 2)),
    ).to(device)
    rb = sample_rays_full_grid(cams, image_size, image_size, 2, scene_extent=radius)
    o = rb.origins
    d = rb.directions / torch.linalg.norm(rb.directions, dim=-1, keepdim=True)
    b = 2.0 * torch.sum(o * d, dim=-1)
    c = torch.sum(o * o, dim=-1) - radius ** 2
    disc = b * b - 4 * c
    hit = disc > 0
    t_hit = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / 2.0
    pts = o + t_hit[..., None] * d
    img = torch.where(hit[..., None], 0.5 + 0.5 * pts / radius, torch.ones_like(pts))
    z = transform_points_world_to_camera(cams, pts)[..., 2]
    depth = torch.where(hit, z, torch.zeros_like(z))
    H = W = image_size
    return FrameData(
        camera=cams,
        image_rgb=img.reshape(n_views, H, W, 3),
        fg_probability=hit.to(torch.float32).reshape(n_views, H, W, 1),
        mask_crop=torch.ones((n_views, H, W, 1), device=cams.R.device),
        depth_map=depth.reshape(n_views, H, W, 1),
        sequence_id=torch.zeros((n_views,), dtype=torch.int32, device=cams.R.device),
    )
