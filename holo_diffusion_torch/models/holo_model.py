"""HoloDiffusionModel (port of holo_diffusion_tpu/models/holo_model.py):
view pooling -> bootstrapped two-pass diffusion -> multi-pass EA rendering
-> photometric losses, for training and evaluation, plus the serving forward
on a given voxel grid. The denoiser `net_3d` is the one its
`net_3d_class_type` names in `NET_3D`: the 3D UNet (`SimpleUnet3D`) or the
diffusion transformer (`DiT3D`).

Random draws of the training forward come from `Draws` (random_draws.py):
injected values, or an explicit `torch.Generator`. Batches are one scene's
frames, targets first; in a compact batch (data/compact.py) the sources come
apart, already masked and resized on the host.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..geometry.cameras import PerspectiveCameras
from ..geometry.rays import RayBundle, sample_rays_from_mask, sample_rays_full_grid
from ..ops.splat import rasterize_sparse_rays
from ..ops.voxel import voxel_coord_grid
from ..random_draws import Draws
from ..utils.profiling import span
from . import diffusion as gd
from .dit3d import DiT3D
from .feature_extractor import ResNetFeatureExtractor
from .implicit import VoxelGridImplicitFunction
from .metrics import as_unit_float, get_objective, multipass_view_metrics, preprocess_input
from .renderer import RendererOutput, multipass_ea_render
from .unet3d import UNetModel3D
from .view_pooler import ViewPooler


def _unet3d_args(net: dict) -> dict:
    """`net_3d_SimpleUnet3D_args` -> the kwargs of `UNetModel3D`."""
    return dict(
        model_channels=net.get("model_channels", 64),
        num_res_blocks=net.get("num_res_blocks", 2),
        num_heads=net.get("num_heads", 2),
        channel_mult=tuple(net.get("channel_mult", (1, 1, 2, 4, 8))),
        attention_resolutions=tuple(net.get("attention_resolutions", (4, 8))),
        dropout=net.get("dropout", 0.0),
        homogeneous_resample=net.get("homogeneous_resample", True),
    )


def _unet3d(feature_size: int, resol: int, args: dict) -> nn.Module:
    args.setdefault("model_channels", 64)
    args.setdefault("num_res_blocks", 2)
    args.setdefault("num_heads", 2)
    args.setdefault("channel_mult", (1, 1, 2, 4, 8))
    args.setdefault("attention_resolutions", (4, 8))
    return UNetModel3D(in_channels=feature_size, out_channels=feature_size, **args)


# DiT3D's keys (its constructor holds their defaults, DiT-XL/2's widths);
# DiT-3D's windowed attention is not ported
_DIT3D_KEYS = ("hidden_size", "depth", "num_heads", "patch_size", "mlp_ratio")
_DIT3D_WINDOW_KEYS = ("window_size", "window_block_indexes")


def _dit3d_args(net: dict) -> dict:
    """`net_3d_DiT3D_args` -> the keys given, for `DiT3D`; a key it does not
    know, or the windowed attention, is refused."""
    window = sorted(set(net) & set(_DIT3D_WINDOW_KEYS))
    if window:
        raise NotImplementedError(f"net_3d_DiT3D_args {window}: DiT-3D's windowed attention is not supported; "
                                  "every block attends over all tokens")
    unknown = sorted(set(net) - set(_DIT3D_KEYS))
    if unknown:
        raise ValueError(f"unknown net_3d_DiT3D_args keys {unknown} (known: {sorted(_DIT3D_KEYS)})")
    return dict(net)


def _dit3d(feature_size: int, resol: int, args: dict) -> nn.Module:
    return DiT3D(in_channels=feature_size, input_size=resol, **args)


# net_3d_class_type -> (the reader of its yaml `net_3d_<class_type>_args`,
# fn(feature_size, resol, net_3d_args): the denoiser, a module of
# (B, r, r, r, C) grids and (B,) timesteps -> (B, r, r, r, C))
NET_3D = {"SimpleUnet3D": (_unet3d_args, _unet3d), "DiT3D": (_dit3d_args, _dit3d)}

DEFAULT_LOSS_WEIGHTS = {
    "loss_rgb_mse": 1.0,
    "loss_prev_stage_rgb_mse": 1.0,
    "loss_prev_stage_prev_stage_rgb_mse": 1.0,
    "loss_mask_bce": 0.0,
    "loss_prev_stage_mask_bce": 0.0,
}


class HoloDiffusionModel(nn.Module):
    def __init__(
        self,
        resol: int = 16,
        volume_extent: float = 8.0,
        feature_size: int = 64,
        num_passes: int = 2,
        net_3d_enabled: bool = True,
        net_3d_class_type: str = "SimpleUnet3D",
        net_3d_args: Optional[dict] = None,
        diffusion_enabled: bool = True,
        diffusion_args: Optional[dict] = None,
        enable_bootstrap: bool = True,
        bootstrap_prob: float = 0.5,
        render_image_height: int = 256,
        render_image_width: int = 256,
        output_rasterized_mc: bool = True,
        mask_images: bool = True,
        mask_depths: bool = True,
        mask_threshold: float = 0.5,
        bg_color: Tuple[float, float, float] = (1.0, 1.0, 1.0),
        n_train_target_views: int = 6,
        sampling_mode_training: str = "mask_sample",
        sampling_mode_evaluation: str = "full_grid",
        chunk_size_grid: int = 0,
        n_pts_per_ray_training: int = 64,
        n_pts_per_ray_evaluation: int = 64,
        n_rays_per_image: int = 1024,
        stratified_point_sampling_training: bool = True,
        stratified_point_sampling_evaluation: bool = False,
        scene_extent: float = 4.0,
        scene_center: Tuple[float, float, float] = (0.0, 0.0, 0.0),
        n_pts_per_ray_fine_training: int = 16,
        n_pts_per_ray_fine_evaluation: int = 16,
        append_coarse_samples_to_fine: bool = True,
        density_noise_std_train: float = 1.0,
        surface_thickness: int = 1,
        background_opacity: float = 1e10,
        replicate_last_interval: bool = False,
        density_relu: bool = True,
        view_pooler_enabled: bool = True,
        image_feature_extractor_args: Optional[dict] = None,
        view_pooler_args: Optional[dict] = None,
        render_normals: bool = False,
        render_mlp_args: Optional[dict] = None,
        sampler: str = "auto",
        sampler_precision: str = "default",
        collapse_density: str = "auto",
        fuse_decode: str = "auto",
        loss_weights: Optional[Dict[str, float]] = None,
    ):
        super().__init__()
        for mode in (sampling_mode_training, sampling_mode_evaluation):
            if mode not in ("mask_sample", "full_grid"):
                raise ValueError(f"unknown sampling mode {mode!r}")
        self.resol = resol
        self.volume_extent = volume_extent
        self.feature_size = feature_size
        self.num_passes = num_passes
        self.net_3d_enabled = net_3d_enabled
        self.diffusion_enabled = diffusion_enabled
        self.diffusion_args = diffusion_args
        self.enable_bootstrap = enable_bootstrap
        self.bootstrap_prob = bootstrap_prob
        self.render_image_height = render_image_height
        self.render_image_width = render_image_width
        self.output_rasterized_mc = output_rasterized_mc
        self.mask_images = mask_images
        self.mask_depths = mask_depths
        self.mask_threshold = mask_threshold
        self.bg_color = tuple(bg_color)
        self.n_train_target_views = n_train_target_views
        self.sampling_mode_training = sampling_mode_training
        self.sampling_mode_evaluation = sampling_mode_evaluation
        self.chunk_size_grid = chunk_size_grid
        self.n_pts_per_ray_training = n_pts_per_ray_training
        self.n_pts_per_ray_evaluation = n_pts_per_ray_evaluation
        self.n_rays_per_image = n_rays_per_image
        self.stratified_point_sampling_training = stratified_point_sampling_training
        self.stratified_point_sampling_evaluation = stratified_point_sampling_evaluation
        self.scene_extent = scene_extent
        self.scene_center = tuple(scene_center)
        self.n_pts_per_ray_fine_training = n_pts_per_ray_fine_training
        self.n_pts_per_ray_fine_evaluation = n_pts_per_ray_fine_evaluation
        self.append_coarse_samples_to_fine = append_coarse_samples_to_fine
        self.density_noise_std_train = density_noise_std_train
        self.surface_thickness = surface_thickness
        self.background_opacity = background_opacity
        self.replicate_last_interval = replicate_last_interval
        self.density_relu = density_relu
        self.view_pooler_enabled = view_pooler_enabled
        self.loss_weights = dict(DEFAULT_LOSS_WEIGHTS if loss_weights is None else loss_weights)

        if view_pooler_enabled:
            self.image_feature_extractor = ResNetFeatureExtractor(**(image_feature_extractor_args or {}))
            self.view_pooler = ViewPooler(
                feat_dim=self.image_feature_extractor.get_feat_dims(), **(view_pooler_args or {}))
            self.pooled_feature_mapper = nn.Linear(self.view_pooler.out_dim, feature_size)
        if net_3d_enabled:
            if net_3d_class_type not in NET_3D:
                raise NotImplementedError(f"net_3d_class_type={net_3d_class_type!r}: supported denoisers are "
                                          f"{tuple(NET_3D)}")
            _, build = NET_3D[net_3d_class_type]
            self.net_3d = build(feature_size, resol, dict(net_3d_args or {}))
        self.implicit_function = VoxelGridImplicitFunction(
            resol=resol,
            volume_extent=volume_extent,
            n_hidden=feature_size,
            render_normals=render_normals,
            render_mlp_args=render_mlp_args,
            sampler=sampler,
            sampler_precision=sampler_precision,
            collapse_density=collapse_density,
            fuse_decode=fuse_decode,
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

    def pool_features(
        self,
        image_rgb: torch.Tensor,
        cameras: PerspectiveCameras,
        fg_probability: Optional[torch.Tensor] = None,
        mask_crop: Optional[torch.Tensor] = None,
        prerescaled: bool = False,
    ) -> torch.Tensor:
        """Source views (S, H, W, 3), preprocessed, -> voxel grid
        (r, r, r, C) in [-1, 1]: extractor, view pooling at the voxel
        centres, mapper, tanh. `prerescaled`: the views come at the
        extractor's input resolution (compact sources), so its resize is
        skipped."""
        with span("holo.extract"):
            feats = self.image_feature_extractor(as_unit_float(image_rgb), as_unit_float(fg_probability),
                                                 rescale_done=prerescaled)
        with span("holo.pool"):
            pts = voxel_coord_grid(self.resol, self.volume_extent, device=image_rgb.device).reshape(-1, 3)
            pooled = self.view_pooler(feats, cameras, pts, as_unit_float(mask_crop))
            v = torch.tanh(self.pooled_feature_mapper(pooled))
        return v.reshape(self.resol, self.resol, self.resol, self.feature_size)

    def denoise(
        self,
        voxel_features: torch.Tensor,
        training: bool,
        draws: Optional[Draws] = None,
        timesteps: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The diffusion mechanism on (1, r, r, r, C). Training: q_sample at
        t, the denoiser's clipped x0 prediction, then with probability
        `bootstrap_prob` a second q_sample + prediction at t2 from it. The
        second pass runs only when its coin comes up: the pass that is not
        selected has no gradient, so skipping it gives the same result.
        `timesteps` (2,) gives (t, t2), as the loss-aware sampler of the
        training step draws them; without it they are drawn uniformly.
        Evaluation: tanh of the denoiser at t=0."""
        aux: Dict[str, torch.Tensor] = {}
        if not self.net_3d_enabled:
            return voxel_features, aux
        dev = voxel_features.device
        if self.diffusion_enabled and training:
            sched = self.schedule
            if timesteps is None:
                timesteps, _ = gd.uniform_sample_timesteps(sched, 2, draws, dev)
            t, t2 = timesteps[:1], timesteps[1:]
            x_t = gd.q_sample(sched, voxel_features, t, draws.normal("noise", voxel_features.shape, dev))
            aux["x_t"], aux["timesteps"] = x_t, t
            v = gd.p_mean_variance(sched, self.net_3d, x_t, t, clip_denoised=True)["pred_xstart"]
            if self.enable_bootstrap:
                take_boot = draws.coin("take_boot", self.bootstrap_prob)
                if take_boot:
                    x_t2 = gd.q_sample(sched, v, t2, draws.normal("noise2", v.shape, dev))
                    v = gd.p_mean_variance(sched, self.net_3d, x_t2, t2, clip_denoised=True)["pred_xstart"]
                aux["take_boot"] = torch.tensor(take_boot)
            return v, aux
        t0 = torch.zeros((voxel_features.shape[0],), dtype=torch.long, device=dev)
        return torch.tanh(self.net_3d(voxel_features, t0)), aux

    def encode_eval(
        self,
        camera: PerspectiveCameras,
        image_rgb: torch.Tensor,
        fg_probability: Optional[torch.Tensor] = None,
        mask_crop: Optional[torch.Tensor] = None,
        prerescaled: bool = False,
    ) -> torch.Tensor:
        """Preprocess + pool + evaluation denoise of SOURCE views ->
        (r, r, r, C), for rendering one grid into many cameras. With
        `prerescaled` the views are compact sources (masked and resized on
        the host): no re-mask, no resize."""
        if not prerescaled:
            image_rgb, fg_probability, _ = preprocess_input(
                image_rgb, fg_probability, None, self.mask_images, self.mask_depths,
                self.mask_threshold, self.bg_color)
        grid = self.pool_features(image_rgb, camera, fg_probability, mask_crop, prerescaled=prerescaled)
        return self.denoise(grid[None], training=False)[0][0]

    def query_density(self, voxel_grid: torch.Tensor, points_world: torch.Tensor) -> torch.Tensor:
        """Raw (pre-relu) densities at world points (..., 3) -> (...)."""
        d, _, _ = self.implicit_function(voxel_grid, points_world[..., None, :], None)
        return d[..., 0, 0]

    def render_rays(
        self,
        voxel_grid: torch.Tensor,
        ray_bundle: RayBundle,
        training: bool = False,
        draws: Any = None,
    ) -> RendererOutput:
        """Multi-pass EA render of a prepared ray bundle (the chunkable inner
        renderer); training adds density noise, and a stratified mode
        (training, or evaluation given `draws`) a stratified refinement,
        with `draws` as `forward` takes them."""
        draws = Draws.of(draws) if training or draws is not None else None

        def implicit_fn(points, directions, pass_number):
            return self.implicit_function(voxel_grid, points, directions)

        return multipass_ea_render(
            implicit_fn,
            ray_bundle,
            n_pts_per_ray_fine=(
                self.n_pts_per_ray_fine_training if training else self.n_pts_per_ray_fine_evaluation),
            append_coarse_samples_to_fine=self.append_coarse_samples_to_fine,
            surface_thickness=self.surface_thickness,
            background_opacity=self.background_opacity,
            replicate_last_interval=self.replicate_last_interval,
            density_relu=self.density_relu,
            num_passes=self.num_passes,
            training=training,
            density_noise_std_train=self.density_noise_std_train,
            stratified_sampling_coarse=(
                self.stratified_point_sampling_training if training
                else self.stratified_point_sampling_evaluation),
            draws=draws,
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

    def render(
        self,
        voxel_grid: torch.Tensor,
        cameras: PerspectiveCameras,
        training: bool,
        draws: Any = None,
        mask_crop: Optional[torch.Tensor] = None,
    ) -> Tuple[RendererOutput, RayBundle]:
        """Ray sampling + multi-pass render of one grid (r, r, r, C) into
        `cameras`, by the sampling mode of training or evaluation:
        mask-sampled rays (`ray_pixel_u`) or the full pixel grid, with
        stratified coarse lengths (`ray_length_u`) where the mode is
        stratified. Training draws from `draws`; evaluation only where its
        mode asks for draws and `draws` is given, as the JAX package draws
        from an evaluation key (mask sampling needs one; without it a
        stratified full-grid render is deterministic)."""
        with span("holo.render"):
            mode = self.sampling_mode_training if training else self.sampling_mode_evaluation
            stratified = (self.stratified_point_sampling_training if training
                          else self.stratified_point_sampling_evaluation)
            n_pts = self.n_pts_per_ray_training if training else self.n_pts_per_ray_evaluation
            if training or mode == "mask_sample" or draws is not None:
                draws = Draws.of(draws)
            B, dev = cameras.batch_size, voxel_grid.device
            H, W = self.render_image_height, self.render_image_width
            n_rays = self.n_rays_per_image if mode == "mask_sample" else H * W
            u_len = None
            if stratified and draws is not None:
                u_len = draws.uniform("ray_length_u", (B, n_rays, n_pts), dev)
            if mode == "mask_sample":
                if mask_crop is None:
                    raise ValueError("mask_sample ray sampling needs mask_crop")
                mask = mask_crop[..., 0] if mask_crop.ndim == 4 else mask_crop
                bundle = sample_rays_from_mask(
                    cameras, mask, n_pts, draws.uniform("ray_pixel_u", (B, n_rays), dev), u_len,
                    self.scene_center, self.scene_extent)
            else:
                bundle = sample_rays_full_grid(
                    cameras, H, W, n_pts, self.scene_center, self.scene_extent, u_len)
            return self.render_rays(voxel_grid, bundle, training, draws), bundle

    def forward(
        self,
        camera: PerspectiveCameras,
        voxel_features: Optional[torch.Tensor] = None,
        image_rgb: Optional[torch.Tensor] = None,
        fg_probability: Optional[torch.Tensor] = None,
        mask_crop: Optional[torch.Tensor] = None,
        depth_map: Optional[torch.Tensor] = None,
        training: bool = False,
        draws: Any = None,
        timesteps: Optional[torch.Tensor] = None,
        src_image_rgb: Optional[torch.Tensor] = None,
        src_fg_probability: Optional[torch.Tensor] = None,
        src_mask_crop: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        """The pipeline (holo_diffusion_model.py:201-540).

        image_rgb (B, H, W, 3) holds one scene's frames: the first
        n_targets are render targets, the rest pooling sources. With
        `src_image_rgb` (a compact batch, data/compact.py) image_rgb holds
        only the targets, the `src_*` hold the sources already masked and
        resized on the host, and `camera` covers the targets, then the
        sources. Without
        images, `voxel_features` (1, r, r, r, C) is rendered (serving).
        Training needs `draws`: a `torch.Generator`, a mapping of injected
        draws, or a `Draws`; so does evaluation with `mask_sample`, and
        stratified evaluation stratifies only given them. `timesteps` (2,)
        replaces the uniform draw of the two diffusion passes. Returns the
        JAX package's preds: renders, ray bundle, `loss_*` metrics,
        `images/depths/masks[/normals]_render` and the weighted `objective`.
        """
        draws = Draws.of(draws) if training or draws is not None else None
        image_rgb, fg_probability, depth_map = preprocess_input(
            image_rgb, fg_probability, depth_map, self.mask_images, self.mask_depths,
            self.mask_threshold, self.bg_color)
        mask_crop = as_unit_float(mask_crop)
        B = camera.batch_size
        compact = src_image_rgb is not None
        if compact:
            # the loader split targets from sources by the same arithmetic
            # (SourceCompactor.n_targets)
            n_targets = image_rgb.shape[0]
            if n_targets >= B:
                raise ValueError("a compact batch's camera must cover its targets and its sources")
        elif training:
            n_targets = B if self.n_train_target_views <= 0 else min(self.n_train_target_views, B)
        else:
            n_targets = 1
        if not compact and B <= n_targets:
            n_targets = 1

        def targets(x):
            return None if x is None else x[:n_targets]

        def sources(x):
            return None if x is None else (x[n_targets:] if B > 1 else x)

        if image_rgb is not None and voxel_features is not None:
            raise ValueError("give image_rgb or voxel_features, not both")
        if compact:
            grid = self.pool_features(src_image_rgb, camera[n_targets:], src_fg_probability, src_mask_crop,
                                      prerescaled=True)
            voxel_features = grid[None]
        elif image_rgb is not None:
            grid = self.pool_features(
                sources(image_rgb), camera[n_targets:] if B > 1 else camera,
                sources(fg_probability), sources(mask_crop))
            voxel_features = grid[None]
        if voxel_features is None:
            raise ValueError("give image_rgb or voxel_features (sampling.py samples grids)")

        preds: Dict[str, Any] = {}
        voxel_features, aux = self.denoise(voxel_features, training, draws, timesteps)
        preds.update({f"diffusion_{k}": v for k, v in aux.items()})
        preds["voxel_features"] = voxel_features

        rendered, ray_bundle = self.render(
            voxel_features[0], camera[:n_targets], training, draws, targets(mask_crop))
        preds["rendered"] = rendered
        preds["ray_bundle"] = ray_bundle
        with span("holo.loss"):
            preds.update(multipass_view_metrics(
                rendered, ray_bundle.xys, targets(image_rgb), targets(depth_map), targets(fg_probability)))
            preds["objective"] = get_objective(preds, self.loss_weights)

        H, W = self.render_image_height, self.render_image_width
        if (self.sampling_mode_training if training else self.sampling_mode_evaluation) == "mask_sample":
            if self.output_rasterized_mc:
                preds["images_render"], preds["depths_render"], preds["masks_render"] = (
                    rasterize_sparse_rays(ray_bundle.xys, rendered.features[..., :3], (H, W),
                                          rendered.depths, rendered.masks))
        else:
            preds["images_render"] = rendered.features[..., :3].reshape(n_targets, H, W, 3)
            preds["depths_render"] = rendered.depths.reshape(n_targets, H, W, 1)
            preds["masks_render"] = rendered.masks.reshape(n_targets, H, W, 1)
            if rendered.normals is not None:
                preds["normals_render"] = rendered.normals.reshape(n_targets, H, W, 3)
        return preds
