"""Fly-around rendering of a sampled voxel grid (port of
holo_diffusion_tpu/utils/flyaround.py, sample mode: the simple_360 orbit and
the images, masks and depths streams; shaded depth and reconstruction mode
belong to later slices)."""
from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, place
from ..geometry.cameras import PerspectiveCameras, look_at_view_transform, so3_exp_map
from ..models.holo_model import HoloDiffusionModel
from ..render_eval import render_image_chunked
from ..sampling import sample_random_voxel_features
from .video import VideoWriter

logger = logging.getLogger(__name__)

# CO3D's canonical up axis (visualize_reconstruction.py:35)
CANONICAL_CO3D_UP_AXIS = (-0.0396, -0.8306, -0.5554)


def simple_360_cameras(
    n_poses: int = 40,
    dist: float = 15.0,
    elevation: float = 15.0,
    up=(0.0, 1.0, 0.0),
    at=(0.0, 0.0, 0.0),
    focal: float = 2.0,
    azimuth_offset: float = 0.0,
) -> PerspectiveCameras:
    """Look-at orbit over azimuths, the world rotated so `up` is the pose
    axis (flyaround.py:301-350)."""
    azim = azimuth_offset + torch.linspace(0.0, 360.0, n_poses + 1)[:-1]
    R, T = look_at_view_transform(dist=dist, elev=elevation, azim=azim, at=at)
    up = np.asarray(up, np.float32)
    up = up / np.linalg.norm(up)
    y = np.array([0.0, 1.0, 0.0], np.float32)
    axis = np.cross(y, up)
    s = np.linalg.norm(axis)
    if s > 1e-6:
        angle = float(np.arctan2(s, np.dot(y, up)))
        R_up = so3_exp_map(torch.as_tensor(axis / s * angle, dtype=torch.float32)[None])[0]
        R = torch.einsum("ij,bjk->bik", R_up.T, R)
    return PerspectiveCameras(
        R=R, T=T,
        focal_length=torch.full((n_poses, 2), float(focal)),
        principal_point=torch.zeros((n_poses, 2)),
    )


@torch.no_grad()
def render_flyaround(
    model: HoloDiffusionModel,
    output_path: str,
    sample_mode: bool = True,
    n_flyaround_poses: int = 40,
    trajectory_distance: float = 15.0,
    up=CANONICAL_CO3D_UP_AXIS,
    generator: Optional[torch.Generator] = None,
    video_fps: int = 20,
    save_voxel_features: bool = False,
    voxel_features: Optional[torch.Tensor] = None,
    sample_use_ddim: bool = False,
    sample_max_iter: Optional[int] = None,
    device: DeviceLike = None,
) -> Dict[str, str]:
    """Sample a voxel grid (unless `voxel_features` (1, r, r, r, C) is given)
    and render it along a simple_360 orbit; returns {stream: video path}.

    With `chunk_size_grid` > 0 the frames go through the chunked renderer on
    the sampled grid as it is; otherwise through the model's forward, which
    first re-denoises the grid at t=0 + tanh — the two paths differ exactly
    as in the JAX package (see ROADMAP.md, Faults).
    """
    if not sample_mode:
        raise NotImplementedError("reconstruction mode is not ported yet (ROADMAP.md §1 item 4)")
    dev = place(model, device)
    cameras = simple_360_cameras(n_flyaround_poses, dist=trajectory_distance, up=up).to(dev)
    if voxel_features is None:
        logger.info("sampling voxel grid via %s ...", "DDIM" if sample_use_ddim else "DDPM")
        voxel_features = sample_random_voxel_features(
            model, generator, max_iter=sample_max_iter, use_ddim=sample_use_ddim, device=dev
        )
    if voxel_features.ndim != 5 or voxel_features.shape[0] != 1:
        raise ValueError(f"voxel_features must be (1, r, r, r, C), got {tuple(voxel_features.shape)}")
    voxel_features = voxel_features.to(dev)

    if model.chunk_size_grid > 0:

        def render_one(cam):
            return render_image_chunked(model, cam, voxel_features[0], device=dev)
    else:

        def render_one(cam):
            return {k: v[0] for k, v in model(cam, voxel_features).items() if k.endswith("_render")}

    os.makedirs(output_path, exist_ok=True)
    streams: Dict[str, VideoWriter] = {}

    def add_frame(key, img):
        if key not in streams:
            streams[key] = VideoWriter(os.path.join(output_path, f"{key}.mp4"), fps=video_fps)
        streams[key].write_frame(img)

    for pose_i in range(n_flyaround_poses):
        preds = render_one(cameras[pose_i])
        add_frame("images_render", preds["images_render"].cpu().numpy())
        add_frame("masks_render", preds["masks_render"].expand(-1, -1, 3).cpu().numpy())
        depth = preds["depths_render"][..., 0]
        depth = depth / (depth.max() + 1e-6)
        add_frame("depths_render", depth[..., None].expand(-1, -1, 3).cpu().numpy())

    out_paths = {k: vw.get_video() for k, vw in streams.items()}
    if save_voxel_features:
        np.save(os.path.join(output_path, "voxel_features.npy"), voxel_features.cpu().numpy())
    return out_paths
