"""The reference's reading of a configuration dict (the release yaml's
nested keys), independent of the program's own config translator."""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Tuple

import torch

from . import DEFAULT_NET_3D, net3d_plugin


@contextlib.contextmanager
def precision(tf32: bool = False):
    """float32 matmuls and convolutions in full float32 (the configuration's
    precision), or in TF32 for the control."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@dataclasses.dataclass(frozen=True)
class Spec:
    resol: int
    volume_extent: float
    feature_size: int
    num_passes: int
    render_height: int
    render_width: int
    chunk_size_grid: int
    n_train_target_views: int
    mask_threshold: float
    bg_color: Tuple[float, float, float]
    enable_bootstrap: bool
    bootstrap_prob: float
    rgb_weights: Tuple[float, ...]  # weight of the rgb mse of the last pass, the one before, ...
    net_3d_type: str  # net_3d_class_type: the denoiser's plug-in, net3d_<type>.py
    net_3d: Dict  # its net_3d_<type>_args
    num_steps: int
    beta_start: float
    beta_end: float
    n_pts_train: int
    n_pts_eval: int
    n_rays_train: int
    stratified_train: bool
    stratified_eval: bool
    scene_extent: float
    scene_center: Tuple[float, float, float]
    n_fine_train: int
    n_fine_eval: int
    append_coarse: bool
    density_noise_std: float
    background_opacity: float
    extractor: Dict
    aggregator: str
    aggregator_args: Dict
    render_normals: bool
    mlp: Dict
    lr: float
    betas: Tuple[float, float]

    @classmethod
    def from_config(cls, cfg: Dict) -> "Spec":
        m = cfg["model_factory_ImplicitronModelFactory_args"]["model_HoloDiffusionModel_args"]
        rays = m["raysampler_AdaptiveRaySampler_args"]
        rend = m["renderer_HoloMultiPassEmissionAbsorptionRenderer_args"]
        march = rend["raymarcher_EmissionAbsorptionRaymarcher_args"]
        diff = m["diffusion_args"]
        net_3d_type = m.get("net_3d_class_type", DEFAULT_NET_3D)
        net_3d_ref = net3d_plugin("reference", net_3d_type)
        net_3d = dict(m[f"net_3d_{net_3d_type}_args"])
        net_3d_ref.check(net_3d)
        fe = dict(m["image_feature_extractor_ResNetFeatureExtractor_args"])
        vp = m["view_pooler_args"]
        agg = vp["feature_aggregator_class_type"]
        mlp = dict(m["implicit_function_HoloVoxelGridImplicitFunction_args"]["render_mlp_args"])
        opt = cfg["optimizer_factory_ImplicitronOptimizerFactory_args"]
        # what the reference writes out; anything else is refused, not guessed
        checks = {
            "model_mean_type": (diff["model_mean_type"], "START_X"),
            "model_var_type": (diff["model_var_type"], "FIXED_SMALL"),
            "beta_schedule_type": (diff["beta_schedule_type"], "linear"),
            "schedule_sampler_type": (diff.get("schedule_sampler_type", "uniform"), "uniform"),
            "sampling_mode_training": (m["sampling_mode_training"], "mask_sample"),
            "sampling_mode_evaluation": (m["sampling_mode_evaluation"], "full_grid"),
            "surface_thickness": (march["surface_thickness"], 1),
            "replicate_last_interval": (march["replicate_last_interval"], False),
            "density_relu": (march["density_relu"], True),
            "masked_sampling": (vp["view_sampler_args"].get("masked_sampling", False), False),
            "feat_emb_dims": (mlp["feat_emb_dims"], 0),
            "rnet_num_layers": (mlp["rnet_num_layers"], 1),
            "activation_fn": (mlp["activation_fn"], "LEAKYRELU"),
            "breed": (opt["breed"], "Adam"),
            "weight_decay": (opt["weight_decay"], 0.0),
            "extractor dtype": (fe.get("dtype", "float32"), "float32"),
            "extractor name": (fe["name"], "resnet34"),
        }
        for key, (got, want) in checks.items():
            if got != want:
                raise NotImplementedError(f"the reference covers {key}={want!r}, not {got!r}")
        weights = m["loss_weights"]
        num_passes = m["num_passes"]
        rgb, prefix = [], "loss_"
        for _ in range(num_passes):
            rgb.append(float(weights.get(prefix + "rgb_mse", 0.0)))
            for k, w in weights.items():
                if k.startswith(prefix) and k[len(prefix):].count("prev_stage") == 0 and w != 0.0 \
                        and k != prefix + "rgb_mse":
                    raise NotImplementedError(f"the reference computes rgb mse losses only, not {k}")
            prefix += "prev_stage_"
        return cls(
            resol=m["resol"], volume_extent=float(m["volume_extent"]), feature_size=m["feature_size"],
            num_passes=num_passes, render_height=m["render_image_height"], render_width=m["render_image_width"],
            chunk_size_grid=m["chunk_size_grid"], n_train_target_views=m["n_train_target_views"],
            mask_threshold=float(m["mask_threshold"]), bg_color=tuple(float(c) for c in m["bg_color"]),
            enable_bootstrap=bool(m["enable_bootstrap"]), bootstrap_prob=float(m["bootstrap_prob"]),
            rgb_weights=tuple(rgb), net_3d_type=net_3d_type, net_3d=net_3d,
            num_steps=diff["num_steps"],
            beta_start=float(diff["beta_start_unscaled"]), beta_end=float(diff["beta_end_unscaled"]),
            n_pts_train=rays["n_pts_per_ray_training"], n_pts_eval=rays["n_pts_per_ray_evaluation"],
            n_rays_train=rays["n_rays_per_image_sampled_from_mask"],
            stratified_train=bool(rays["stratified_point_sampling_training"]),
            stratified_eval=bool(rays["stratified_point_sampling_evaluation"]),
            scene_extent=float(rays["scene_extent"]), scene_center=tuple(float(c) for c in rays["scene_center"]),
            n_fine_train=rend["n_pts_per_ray_fine_training"], n_fine_eval=rend["n_pts_per_ray_fine_evaluation"],
            append_coarse=bool(rend["append_coarse_samples_to_fine"]),
            density_noise_std=float(rend["density_noise_std_train"]),
            background_opacity=float(march["background_opacity"]), extractor=fe, aggregator=agg,
            aggregator_args=dict(vp.get(f"feature_aggregator_{agg}_args", {}) or {}),
            render_normals=bool(m["implicit_function_HoloVoxelGridImplicitFunction_args"]["render_normals"]),
            mlp=mlp, lr=float(opt["lr"]), betas=tuple(float(b) for b in opt["betas"]),
        )
