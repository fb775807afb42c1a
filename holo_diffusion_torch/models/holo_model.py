"""HoloDiffusionModel, serving subset (port of
holo_diffusion_tpu/models/holo_model.py): the UNet denoiser `net_3d`, the
shared implicit function, the diffusion schedule, ray rendering and the
evaluation forward on a given voxel grid.

View pooling and the training forward belong to the training slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..geometry.cameras import PerspectiveCameras
from ..geometry.rays import RayBundle, sample_rays_full_grid
from . import diffusion as gd
from .implicit import VoxelGridImplicitFunction
from .renderer import RendererOutput, multipass_ea_render
from .unet3d import UNetModel3D


class HoloDiffusionModel(nn.Module):
    def __init__(
        self,
        resol: int = 16,
        volume_extent: float = 8.0,
        feature_size: int = 64,
        num_passes: int = 2,
        net_3d_enabled: bool = True,
        net_3d_args: Optional[dict] = None,
        diffusion_enabled: bool = True,
        diffusion_args: Optional[dict] = None,
        render_image_height: int = 256,
        render_image_width: int = 256,
        sampling_mode_evaluation: str = "full_grid",
        chunk_size_grid: int = 0,
        n_pts_per_ray_evaluation: int = 64,
        stratified_point_sampling_evaluation: bool = False,
        scene_extent: float = 4.0,
        scene_center: Tuple[float, float, float] = (0.0, 0.0, 0.0),
        n_pts_per_ray_fine_evaluation: int = 16,
        append_coarse_samples_to_fine: bool = True,
        surface_thickness: int = 1,
        background_opacity: float = 1e10,
        replicate_last_interval: bool = False,
        density_relu: bool = True,
        render_normals: bool = False,
        render_mlp_args: Optional[dict] = None,
    ):
        super().__init__()
        if sampling_mode_evaluation != "full_grid":
            raise NotImplementedError(
                f"sampling_mode_evaluation={sampling_mode_evaluation!r}: only full_grid"
            )
        if stratified_point_sampling_evaluation:
            raise NotImplementedError("stratified evaluation sampling is not ported")
        self.resol = resol
        self.volume_extent = volume_extent
        self.feature_size = feature_size
        self.num_passes = num_passes
        self.net_3d_enabled = net_3d_enabled
        self.diffusion_enabled = diffusion_enabled
        self.diffusion_args = diffusion_args
        self.render_image_height = render_image_height
        self.render_image_width = render_image_width
        self.sampling_mode_evaluation = sampling_mode_evaluation
        self.chunk_size_grid = chunk_size_grid
        self.n_pts_per_ray_evaluation = n_pts_per_ray_evaluation
        self.scene_extent = scene_extent
        self.scene_center = tuple(scene_center)
        self.n_pts_per_ray_fine_evaluation = n_pts_per_ray_fine_evaluation
        self.append_coarse_samples_to_fine = append_coarse_samples_to_fine
        self.surface_thickness = surface_thickness
        self.background_opacity = background_opacity
        self.replicate_last_interval = replicate_last_interval
        self.density_relu = density_relu

        if net_3d_enabled:
            args = dict(net_3d_args or {})
            args.setdefault("model_channels", 64)
            args.setdefault("num_res_blocks", 2)
            args.setdefault("num_heads", 2)
            args.setdefault("channel_mult", (1, 1, 2, 4, 8))
            args.setdefault("attention_resolutions", (4, 8))
            self.net_3d = UNetModel3D(
                in_channels=feature_size, out_channels=feature_size, **args
            )
        self.implicit_function = VoxelGridImplicitFunction(
            resol=resol,
            volume_extent=volume_extent,
            n_hidden=feature_size,
            render_normals=render_normals,
            render_mlp_args=render_mlp_args,
        )
        self._schedule = None

    @property
    def schedule(self) -> gd.DiffusionSchedule:
        """The diffusion schedule, on the model's device."""
        dev = self.implicit_function.render_mlp._radiance_net.linear(0).weight.device
        if self._schedule is None or self._schedule.betas.device != dev:
            self._schedule = gd.make_named_schedule_from_config(self.diffusion_args, dev)
        return self._schedule

    def apply_net_3d(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        """Raw denoiser on (B, r, r, r, C)."""
        return self.net_3d(x, timesteps)

    def denoise_eval(self, voxel_features: torch.Tensor) -> torch.Tensor:
        """Evaluation pass through the denoiser at t=0 followed by tanh
        (holo_diffusion_model.py:420-426, also applied to generated samples)."""
        if not self.net_3d_enabled:
            return voxel_features
        t0 = torch.zeros((voxel_features.shape[0],), dtype=torch.long, device=voxel_features.device)
        return torch.tanh(self.net_3d(voxel_features, t0))

    def query_density(self, voxel_grid: torch.Tensor, points_world: torch.Tensor) -> torch.Tensor:
        """Raw (pre-relu) densities at world points (..., 3) -> (...)."""
        d, _, _ = self.implicit_function(voxel_grid, points_world[..., None, :], None)
        return d[..., 0, 0]

    def render_rays(self, voxel_grid: torch.Tensor, ray_bundle: RayBundle) -> RendererOutput:
        """Multi-pass EA render of a prepared ray bundle (the chunkable inner
        renderer)."""

        def implicit_fn(points, directions, pass_number):
            return self.implicit_function(voxel_grid, points, directions)

        return multipass_ea_render(
            implicit_fn,
            ray_bundle,
            n_pts_per_ray_fine=self.n_pts_per_ray_fine_evaluation,
            append_coarse_samples_to_fine=self.append_coarse_samples_to_fine,
            surface_thickness=self.surface_thickness,
            background_opacity=self.background_opacity,
            replicate_last_interval=self.replicate_last_interval,
            density_relu=self.density_relu,
            num_passes=self.num_passes,
        )

    def full_grid_rays(
        self, cameras: PerspectiveCameras, height: Optional[int] = None, width: Optional[int] = None
    ) -> RayBundle:
        return sample_rays_full_grid(
            cameras,
            height or self.render_image_height,
            width or self.render_image_width,
            self.n_pts_per_ray_evaluation,
            self.scene_center,
            self.scene_extent,
        )

    def forward(
        self, camera: PerspectiveCameras, voxel_features: torch.Tensor
    ) -> Dict[str, Any]:
        """Evaluation forward on a given grid (holo_diffusion_model.py:201-540
        with voxel_features and training=False): denoise at t=0 + tanh, then a
        full-grid render into camera[:1]. voxel_features: (1, r, r, r, C)."""
        voxel_features = self.denoise_eval(voxel_features)
        target = camera[:1]
        ray_bundle = self.full_grid_rays(target)
        rendered = self.render_rays(voxel_features[0], ray_bundle)
        H, W = self.render_image_height, self.render_image_width
        preds = {
            "voxel_features": voxel_features,
            "rendered": rendered,
            "ray_bundle": ray_bundle,
            "images_render": rendered.features[..., :3].reshape(1, H, W, 3),
            "depths_render": rendered.depths.reshape(1, H, W, 1),
            "masks_render": rendered.masks.reshape(1, H, W, 1),
        }
        if rendered.normals is not None:
            preds["normals_render"] = rendered.normals.reshape(1, H, W, 3)
        return preds
