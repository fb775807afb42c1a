"""Fly-around rendering (port of holo_diffusion_tpu/utils/flyaround.py;
reference render_utils/flyaround.py:44-503 and Implicitron's
`generate_eval_video_cameras`): camera trajectories (the simple_360 look-at
orbit; a circle, figure eight, trefoil or figure-eight knot fitted to a
scene's cameras), sample mode (a sampled grid, optionally shown while it is
denoised) and reconstruction mode (a grid pooled from a scene's source
views), the evaluation-only empty-space skip, and the four video streams
(images, masks, depths, shaded depth).
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data.frame_data import FrameData
from ..device import DeviceLike, place
from ..geometry.cameras import (
    PerspectiveCameras,
    camera_centers,
    look_at_rotation,
    look_at_view_transform,
    so3_exp_map,
)
from ..models.holo_model import HoloDiffusionModel
from ..models.metrics import preprocess_input
from ..render_eval import compute_occupancy, render_image_chunked
from ..sampling import sample_random_voxel_features, sample_random_voxel_features_progressive
from .shaded_depth import depth_to_shaded, shaded_from_normals
from .video import VideoWriter

logger = logging.getLogger(__name__)

# CO3D's canonical up axis (visualize_reconstruction.py:35)
CANONICAL_CO3D_UP_AXIS = (-0.0396, -0.8306, -0.5554)
TRAJECTORIES = ("circular_lsq_fit", "figure_eight", "trefoil_knot", "figure_eight_knot")


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


def _fit_plane(centers: np.ndarray):
    """Least-squares plane through camera centres: (centroid, basis e1, e2,
    normal n), by numpy's SVD as in the JAX package (so the same signs)."""
    c0 = centers.mean(0)
    _, _, vt = np.linalg.svd(centers - c0, full_matrices=False)
    return c0, vt[0], vt[1], vt[2]


def fitted_trajectory_cameras(
    train_cameras: PerspectiveCameras,
    n_poses: int = 40,
    trajectory_type: str = "circular_lsq_fit",
    scene_center=(0.0, 0.0, 0.0),
    focal: Optional[float] = None,
    trajectory_scale: float = 1.1,
) -> PerspectiveCameras:
    """Implicitron `generate_eval_video_cameras`: a closed curve fitted to
    the training cameras' centres (in their least-squares plane, radius the
    RMS in-plane distance x `trajectory_scale`), look-at cameras on it
    facing `scene_center`, up the plane's negative normal; focal the
    training cameras' mean unless given. Trajectories: circular_lsq_fit,
    figure_eight, trefoil_knot, figure_eight_knot (flyaround.py:194-213).
    Returns CPU cameras."""
    centers = camera_centers(train_cameras).detach().cpu().numpy()
    c0, e1, e2, n = _fit_plane(centers)
    d = centers - c0
    r = float(np.sqrt(((d @ e1) ** 2 + (d @ e2) ** 2).mean())) * trajectory_scale
    t = np.linspace(0, 2 * np.pi, n_poses, endpoint=False)

    if trajectory_type == "circular_lsq_fit":
        xy = np.stack([np.cos(t), np.sin(t)], -1) * r
        z = np.zeros_like(t)
    elif trajectory_type == "figure_eight":
        xy = np.stack([np.cos(t), np.sin(2 * t) / 2], -1) * r
        z = np.zeros_like(t)
    elif trajectory_type == "trefoil_knot":
        xy = np.stack([np.sin(t) + 2 * np.sin(2 * t), np.cos(t) - 2 * np.cos(2 * t)], -1) / 3.0 * r
        z = -np.sin(3 * t) / 3.0 * r
    elif trajectory_type == "figure_eight_knot":
        xy = np.stack([(2 + np.cos(2 * t)) * np.cos(3 * t), (2 + np.cos(2 * t)) * np.sin(3 * t)], -1) / 3.0 * r
        z = np.sin(4 * t) / 3.0 * r
    else:
        raise ValueError(f"unknown trajectory {trajectory_type!r}: simple_360 or one of {TRAJECTORIES}")

    eye = c0[None] + xy[:, :1] * e1[None] + xy[:, 1:2] * e2[None] + z[:, None] * n[None]
    eye = torch.as_tensor(eye, dtype=torch.float32)
    at = torch.as_tensor(scene_center, dtype=torch.float32).expand(eye.shape)
    up_vec = torch.as_tensor(-n, dtype=torch.float32).expand(eye.shape)
    R = look_at_rotation(eye, at, up_vec)
    T = -torch.einsum("bi,bij->bj", eye, R)
    if focal is None:
        focal_arr = train_cameras.focal_length.detach().cpu().mean(dim=0, keepdim=True).expand(n_poses, 2)
    else:
        focal_arr = torch.full((n_poses, 2), float(focal))
    return PerspectiveCameras(R=R, T=T, focal_length=focal_arr.contiguous(),
                              principal_point=torch.zeros((n_poses, 2)))


def source_view_indices(n_views: int, n_source_views: int, seed: int) -> np.ndarray:
    """The reproducible subset of a scene's views pooled in reconstruction
    mode (the reference's forked RNG; the JAX package's same draw)."""
    return np.random.RandomState(seed).choice(n_views, size=min(n_source_views, n_views), replace=False)


@torch.no_grad()
def render_flyaround(
    model: HoloDiffusionModel,
    output_path: str,
    scene: Optional[FrameData] = None,
    sample_mode: bool = True,
    n_flyaround_poses: int = 40,
    n_source_views: int = 9,
    trajectory_type: str = "simple_360",
    trajectory_distance: float = 15.0,
    up=CANONICAL_CO3D_UP_AXIS,
    generator: Optional[torch.Generator] = None,
    progressive_sampling_steps_per_render: int = -1,
    video_fps: int = 20,
    save_voxel_features: bool = False,
    seed: int = 0,
    shaded_depth_method: str = "gradient",
    voxel_features: Optional[torch.Tensor] = None,
    sample_use_ddim: bool = False,
    sample_max_iter: Optional[int] = None,
    empty_space_skip: bool = False,
    sample_noise: Optional[torch.Tensor] = None,
    sample_step_noise: Optional[Sequence[torch.Tensor]] = None,
    device: DeviceLike = None,
) -> Dict[str, str]:
    """The inference loop (flyaround.py:44-298); returns {stream: video path}.

    Sample mode: sample a grid (unless `voxel_features` (1, r, r, r, C) is
    given), by DDPM or DDIM, and render it along a simple_360 orbit; with
    `progressive_sampling_steps_per_render` > 0 each pose advances the DDPM
    chain that many steps and renders its clipped state. Reconstruction mode
    (`sample_mode=False`): pool the grid once from `n_source_views` of
    `scene` (chosen by `seed`) and render it along `trajectory_type`
    (simple_360, or a trajectory fitted to the scene's cameras).

    Draws come from `generator` (one seeded by `seed` on the device when
    None); `sample_noise` (x_T) and `sample_step_noise` (one tensor per DDPM
    step) replace the sampler's. With `chunk_size_grid` > 0 and full-grid
    evaluation the frames go through the chunked renderer on the grid as it
    is, with `empty_space_skip` probing the occupancy once per grid;
    otherwise through the model's forward, which first denoises the grid at
    t=0 + tanh (the two paths differ as in the JAX package: ROADMAP.md §3).
    The shaded depth stream shades the rendered normals when the model
    renders them, else the depth by `shaded_depth_method` (gradient,
    pointcloud or mesh).
    """
    dev = place(model, device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)

    progressive_gen = None
    if sample_mode:
        cameras = simple_360_cameras(n_flyaround_poses, dist=trajectory_distance, up=up)
        if voxel_features is not None:
            if voxel_features.ndim != 5 or voxel_features.shape[0] != 1:
                raise ValueError(f"voxel_features must be (1, r, r, r, C), got {tuple(voxel_features.shape)}")
        elif progressive_sampling_steps_per_render > 0:
            progressive_gen = sample_random_voxel_features_progressive(
                model, generator, max_iter=sample_max_iter, noise=sample_noise,
                step_noise=sample_step_noise, device=dev)
            voxel_features = next(progressive_gen)
        else:
            logger.info("sampling voxel grid via %s ...", "DDIM" if sample_use_ddim else "DDPM")
            voxel_features = sample_random_voxel_features(
                model, generator, max_iter=sample_max_iter, use_ddim=sample_use_ddim,
                noise=sample_noise, step_noise=sample_step_noise, device=dev)
        voxel_features = voxel_features.to(dev)
    else:
        if scene is None:
            raise ValueError("reconstruction mode needs a scene")
        sel = source_view_indices(scene.batch_size, n_source_views, seed)
        src = scene[torch.as_tensor(sel, device=scene.device)].to(dev)
        if trajectory_type == "simple_360":
            cameras = simple_360_cameras(n_flyaround_poses, dist=trajectory_distance, up=up)
        else:
            cameras = fitted_trajectory_cameras(scene.camera, n_flyaround_poses, trajectory_type)
        # pooled once: the grid is the same for every pose
        img, fg, _ = preprocess_input(src.image_rgb, src.fg_probability, None, model.mask_images,
                                      model.mask_depths, model.mask_threshold, model.bg_color)
        voxel_features = model.pool_features(img, src.camera, fg, src.mask_crop)[None]
    cameras = cameras.to(dev)

    if (model.chunk_size_grid or 0) > 0 and model.sampling_mode_evaluation == "full_grid":
        occ_cache = {"grid": None, "occ": None}

        def render_one(cam, v):
            occ = None
            if empty_space_skip:
                # one probe per grid, reused across poses; a progressive
                # step makes a new grid and a new probe
                if occ_cache["grid"] is not v:
                    occ_cache["occ"] = compute_occupancy(model, v[0])
                    occ_cache["grid"] = v
                occ = occ_cache["occ"]
            return render_image_chunked(model, cam, v[0], device=dev, occupancy=occ)
    else:

        def render_one(cam, v):
            preds = model(cam, voxel_features=v, training=False, draws=generator)
            return {k: x[0] for k, x in preds.items() if k.endswith("_render")}

    os.makedirs(output_path, exist_ok=True)
    streams: Dict[str, VideoWriter] = {}

    def add_frame(key, img):
        if key not in streams:
            streams[key] = VideoWriter(os.path.join(output_path, f"{key}.mp4"), fps=video_fps)
        streams[key].write_frame(img.cpu().numpy())

    for pose_i in range(n_flyaround_poses):
        cam = cameras[pose_i]
        if progressive_gen is not None and pose_i > 0:
            for _ in range(progressive_sampling_steps_per_render):
                try:
                    voxel_features = next(progressive_gen)
                except StopIteration:
                    break
        preds = render_one(cam, voxel_features)
        add_frame("images_render", preds["images_render"])
        add_frame("masks_render", preds["masks_render"].expand(-1, -1, 3))
        depth = preds["depths_render"][..., 0]
        add_frame("depths_render", (depth / (depth.max() + 1e-6))[..., None].expand(-1, -1, 3))
        # flyaround.py:439-470: from the rendered normals when the model
        # renders them, else derived from the depth
        mask2d = preds["masks_render"][..., 0]
        if "normals_render" in preds:
            shaded = shaded_from_normals(preds["normals_render"], mask2d, cam, depth)
        else:
            shaded = depth_to_shaded(depth, mask2d, cam, method=shaded_depth_method)
        add_frame("shaded_depth_render", shaded)

    out_paths = {k: vw.get_video() for k, vw in streams.items()}
    if save_voxel_features and sample_mode:
        np.save(os.path.join(output_path, "voxel_features.npy"), voxel_features.cpu().numpy())
    return out_paths
