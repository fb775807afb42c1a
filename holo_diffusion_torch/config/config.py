"""Config loading (port of holo_diffusion_tpu/config/config.py, the subset the
serving slice reads): YAML files with single-parent `_extends_`, dotted
`a.b.c=value` overrides, and the model kwargs of `HoloDiffusionModel`.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import yaml

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs")

# top-level keys that may be set from the command line even when the YAML
# lacks them (the reference's hydra struct mode knows them from its schema)
_KNOWN_ROOT_KEYS = frozenset({"exp_dir", "seed"})


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
    `HoloDiffusionModel` (the serving subset: grid, UNet, schedule, eval ray
    sampling, renderer, implicit function)."""
    mf = cfg.get("model_factory_ImplicitronModelFactory_args", {})
    _check_class_type(mf.get("model_class_type", "HoloDiffusionModel"),
                      ("HoloDiffusionModel",), "model_class_type")
    m = mf.get("model_HoloDiffusionModel_args", {})
    rays = m.get("raysampler_AdaptiveRaySampler_args", {})
    rend = m.get("renderer_HoloMultiPassEmissionAbsorptionRenderer_args", {})
    raym = rend.get("raymarcher_EmissionAbsorptionRaymarcher_args", {})
    impl = m.get("implicit_function_HoloVoxelGridImplicitFunction_args", {})
    diff = m.get("diffusion_args", {})

    for key, default in (
        ("net_3d_class_type", "SimpleUnet3D"),
        ("raysampler_class_type", "AdaptiveRaySampler"),
        ("renderer_class_type", "HoloMultiPassEmissionAbsorptionRenderer"),
        ("implicit_function_class_type", "HoloVoxelGridImplicitFunction"),
    ):
        _check_class_type(m.get(key, default), (default,), key)
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
