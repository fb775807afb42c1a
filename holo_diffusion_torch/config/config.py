"""Config loading (port of holo_diffusion_tpu/config/config.py): YAML files
with single-parent `_extends_`, dotted `a.b.c=value` overrides, the model
kwargs of `HoloDiffusionModel`, and the optimizer and gradient-clip settings
of training.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional, Tuple

import yaml

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs")

# top-level keys that may be set from the command line even when the YAML
# lacks them (the reference's hydra struct mode knows them from its schema)
_KNOWN_ROOT_KEYS = frozenset({"exp_dir", "seed"})

logger = logging.getLogger(__name__)


def _deep_update(base: Dict, upd: Dict) -> Dict:
    for k, v in upd.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v
    return base


def _resolve_path(config_name: str, config_dir: str) -> str:
    candidates = [config_name]
    if not config_name.endswith(".yaml"):
        candidates.append(config_name + ".yaml")
    for c in list(candidates):
        candidates.append(os.path.join(config_dir, c))
    for c in candidates:
        if os.path.exists(c):
            return c
    raise FileNotFoundError(f"config {config_name!r} not found (looked in {config_dir})")


def load_config(
    config_name: str,
    overrides: Optional[List[str]] = None,
    config_dir: Optional[str] = None,
) -> Dict[str, Any]:
    """Load `<config_dir>/<config_name>[.yaml]` (or a path) + dotted overrides.
    A `_extends_: <parent>` key deep-merges the file over its parent."""
    config_dir = config_dir or CONFIG_DIR
    path = _resolve_path(config_name, config_dir)
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    parent = cfg.pop("_extends_", None)
    if parent:
        base = load_config(parent, config_dir=os.path.dirname(path) or config_dir)
        cfg = _deep_update(base, cfg)
    if overrides:
        apply_dotted_overrides(cfg, overrides)
    return cfg


def apply_dotted_overrides(cfg: Dict[str, Any], overrides: List[str]) -> Dict[str, Any]:
    """Apply `a.b.c=value` overrides; values parse as YAML literals.

    The root key must exist in the config or be a known root key, as hydra's
    struct mode demands; a `+` prefix force-adds a new key. Setting a key
    under a non-dict value is an error."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, _, raw = ov.partition("=")
        force_add = key.startswith("+")
        if force_add:
            key = key[1:]
        value = yaml.safe_load(raw)
        parts = key.split(".")
        if not force_add and parts[0] not in cfg and parts[0] not in _KNOWN_ROOT_KEYS:
            hint = ""
            for root, node in cfg.items():
                if isinstance(node, dict) and parts[0] in node:
                    hint = f" — did you mean {root}.{key}?"
                    break
            raise ValueError(
                f"unknown config key {parts[0]!r} in override {ov!r}{hint} "
                f"(use +{key}=... to force-add a new key)"
            )
        node = cfg
        for i, p in enumerate(parts[:-1]):
            nxt = node.setdefault(p, {})
            if not isinstance(nxt, dict):
                raise ValueError(
                    f"override {ov!r}: {'.'.join(parts[: i + 1])!r} is "
                    f"{type(nxt).__name__}, not a dict — cannot set a nested key under it"
                )
            node = nxt
        node[parts[-1]] = value
    return cfg


def _check_class_type(value: str, supported: Tuple[str, ...], key: str) -> str:
    if value not in supported:
        raise NotImplementedError(f"{key}={value!r}: supported implementations are {supported}")
    return value


def model_args_from_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """`model_HoloDiffusionModel_args` -> kwargs of the port's
    `HoloDiffusionModel`."""
    mf = cfg.get("model_factory_ImplicitronModelFactory_args", {})
    _check_class_type(mf.get("model_class_type", "HoloDiffusionModel"),
                      ("HoloDiffusionModel",), "model_class_type")
    m = mf.get("model_HoloDiffusionModel_args", {})
    rays = m.get("raysampler_AdaptiveRaySampler_args", {})
    rend = m.get("renderer_HoloMultiPassEmissionAbsorptionRenderer_args", {})
    raym = rend.get("raymarcher_EmissionAbsorptionRaymarcher_args", {})
    impl = m.get("implicit_function_HoloVoxelGridImplicitFunction_args", {})
    diff = m.get("diffusion_args", {})
    fe = m.get("image_feature_extractor_ResNetFeatureExtractor_args", {})
    vp = m.get("view_pooler_args", {})
    agg_type = m.get(
        "feature_aggregator_class_type",
        vp.get("feature_aggregator_class_type", "AngleWeightedReductionFeatureAggregator"),
    )
    agg_args = dict(vp.get(f"feature_aggregator_{agg_type}_args",
                           m.get(f"feature_aggregator_{agg_type}_args", {})) or {})
    # reference-only switches that the reference itself forces off
    for k in ("exclude_target_view", "exclude_target_view_mask_features",
              "concatenate_output", "checkpointed_mlp"):
        agg_args.pop(k, None)
    if fe.get("pretrained", False):
        logger.warning("image_feature_extractor pretrained=true: the repository holds no "
                       "ImageNet weights; the extractor starts from its seeded initialisation")

    for key, default in (
        ("net_3d_class_type", "SimpleUnet3D"),
        ("raysampler_class_type", "AdaptiveRaySampler"),
        ("renderer_class_type", "HoloMultiPassEmissionAbsorptionRenderer"),
        ("implicit_function_class_type", "HoloVoxelGridImplicitFunction"),
        ("image_feature_extractor_class_type", "ResNetFeatureExtractor"),
    ):
        _check_class_type(m.get(key, default), (default,), key)
    _check_class_type(vp.get("view_sampler_args", {}).get("sampling_mode", "bilinear"),
                      ("bilinear",), "view_sampler_args.sampling_mode")
    _check_class_type(rend.get("raymarcher_class_type", "EmissionAbsorptionRaymarcher"),
                      ("EmissionAbsorptionRaymarcher",), "raymarcher_class_type")
    if raym.get("blend_output", False):
        raise NotImplementedError("blend_output=true is not supported")

    args: Dict[str, Any] = dict(
        resol=m.get("resol", 16),
        volume_extent=m.get("volume_extent", 8.0),
        feature_size=m.get("feature_size", 64),
        num_passes=m.get("num_passes", 2),
        render_image_height=m.get("render_image_height", 256),
        render_image_width=m.get("render_image_width", 256),
        sampling_mode_evaluation=m.get("sampling_mode_evaluation", "full_grid"),
        chunk_size_grid=m.get("chunk_size_grid", 0),
        net_3d_enabled=m.get("net_3d_enabled", True),
        diffusion_enabled=m.get("diffusion_enabled", True),
        n_pts_per_ray_evaluation=rays.get("n_pts_per_ray_evaluation", 64),
        stratified_point_sampling_evaluation=rays.get(
            "stratified_point_sampling_evaluation",
            rend.get("stratified_sampling_coarse_evaluation", False),
        ),
        scene_extent=rays.get("scene_extent", 4.0),
        scene_center=tuple(rays.get("scene_center", (0.0, 0.0, 0.0))),
        n_pts_per_ray_fine_evaluation=rend.get("n_pts_per_ray_fine_evaluation", 16),
        append_coarse_samples_to_fine=rend.get("append_coarse_samples_to_fine", True),
        surface_thickness=raym.get("surface_thickness", 1),
        background_opacity=raym.get("background_opacity", 1e10),
        replicate_last_interval=raym.get("replicate_last_interval", False),
        density_relu=raym.get("density_relu", True),
        render_normals=impl.get("render_normals", False),
        render_mlp_args=impl.get("render_mlp_args", None),
        # training
        output_rasterized_mc=m.get("output_rasterized_mc", True),
        mask_images=m.get("mask_images", True),
        mask_depths=m.get("mask_depths", True),
        mask_threshold=m.get("mask_threshold", 0.5),
        bg_color=tuple(m.get("bg_color", raym.get("bg_color", (1.0, 1.0, 1.0)))),
        n_train_target_views=m.get("n_train_target_views", 6),
        sampling_mode_training=m.get("sampling_mode_training", "mask_sample"),
        enable_bootstrap=m.get("enable_bootstrap", True),
        bootstrap_prob=m.get("bootstrap_prob", 0.5),
        loss_weights=m.get("loss_weights"),
        n_pts_per_ray_training=rays.get("n_pts_per_ray_training", 64),
        n_rays_per_image=rays.get("n_rays_per_image_sampled_from_mask", 1024),
        # the raysampler key wins over the renderer's coarse-pass key
        stratified_point_sampling_training=rays.get(
            "stratified_point_sampling_training",
            rend.get("stratified_sampling_coarse_training", True),
        ),
        n_pts_per_ray_fine_training=rend.get("n_pts_per_ray_fine_training", 16),
        density_noise_std_train=rend.get("density_noise_std_train", 1.0),
        # view pooling
        view_pooler_enabled=m.get("view_pooler_enabled", True),
        image_feature_extractor_args=dict(
            name_arch=fe.get("name", "resnet34"),
            stages=tuple(fe.get("stages", (1, 2, 3, 4))),
            normalize_image=fe.get("normalize_image", True),
            image_rescale=fe.get("image_rescale", 0.32),
            first_max_pool=fe.get("first_max_pool", True),
            proj_dim=fe.get("proj_dim", 16),
            l2_norm=fe.get("l2_norm", True),
            add_masks=fe.get("add_masks", True),
            add_images=fe.get("add_images", True),
            feature_rescale=fe.get("feature_rescale", 1.0),
            dtype=fe.get("dtype", "float32"),
        ),
        view_pooler_args=dict(
            aggregator_class_type=agg_type,
            aggregator_args=agg_args,
            masked_sampling=vp.get("view_sampler_args", {}).get("masked_sampling", False),
        ),
    )
    if args["net_3d_enabled"]:
        net = m.get("net_3d_SimpleUnet3D_args", {})
        args["net_3d_args"] = dict(
            model_channels=net.get("model_channels", 64),
            num_res_blocks=net.get("num_res_blocks", 2),
            num_heads=net.get("num_heads", 2),
            channel_mult=tuple(net.get("channel_mult", (1, 1, 2, 4, 8))),
            attention_resolutions=tuple(net.get("attention_resolutions", (4, 8))),
            dropout=net.get("dropout", 0.0),
            homogeneous_resample=net.get("homogeneous_resample", True),
        )
    if args["diffusion_enabled"]:
        args["diffusion_args"] = dict(
            schedule_name=diff.get("beta_schedule_type", "linear"),
            num_steps=diff.get("num_steps", 1000),
            beta_start_unscaled=diff.get("beta_start_unscaled", 1e-4),
            beta_end_unscaled=diff.get("beta_end_unscaled", 0.02),
            model_mean_type=diff.get("model_mean_type", "START_X"),
            model_var_type=diff.get("model_var_type", "FIXED_SMALL"),
        )
    return args


def optimizer_args_from_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """`optimizer_factory_ImplicitronOptimizerFactory_args` and the training
    loop's `clip_grad` -> the optimizer settings of `train.optimizer`: the
    breed's kwargs (`make_optimizer`) and the LR policy's
    (`make_lr_schedule`), as {"optimizer": ..., "schedule": ...}."""
    o = cfg.get("optimizer_factory_ImplicitronOptimizerFactory_args", {})
    t = cfg.get("training_loop_ImplicitronTrainingLoop_args", {})
    return {
        "optimizer": dict(
            breed=o.get("breed", "Adam"),
            lr=o.get("lr", 5e-5),
            betas=tuple(o.get("betas", (0.9, 0.999))),
            momentum=o.get("momentum", 0.9),
            weight_decay=o.get("weight_decay", 0.0),
            clip_grad=t.get("clip_grad", 0.0),
            group_learning_rates=o.get("group_learning_rates", {}) or None,
        ),
        "schedule": dict(
            lr_policy=o.get("lr_policy", "MultiStepLR"),
            gamma=o.get("gamma", 0.1),
            multistep_lr_milestones=tuple(o.get("multistep_lr_milestones", ())),
            exponential_lr_step_size=o.get("exponential_lr_step_size", 250),
            linear_exponential_lr_milestone=o.get("linear_exponential_lr_milestone", 200),
            linear_exponential_start_gamma=o.get("linear_exponential_start_gamma", 0.1),
            max_epochs=t.get("max_epochs", 1000),
        ),
    }
