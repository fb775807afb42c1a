"""Config loading (port of holo_diffusion_tpu/config/config.py): YAML files
with single-parent `_extends_`, dotted `a.b.c=value` overrides, the model
kwargs of `HoloDiffusionModel`, the optimizer and gradient-clip settings,
the training loop's and the data source's settings, the `expconfig.yaml`
snapshot, and the audit of config keys that nothing reads.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional, Tuple

import yaml

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs")

# top-level keys that may be set from the command line even when the YAML
# lacks them (the reference's hydra struct mode knows them from its schema);
# the Experiment reads them directly (or rejects the features they ask for)
_KNOWN_ROOT_KEYS = frozenset({
    "exp_dir", "seed", "detect_anomaly",
    "disable_testing", "disable_validation",
    "steps_per_dispatch", "packed_transfer", "ema_rate", "eval_use_ema",
    "visualize_denoising_video",
    "compact_sources", "compact_val", "compact_drop_depth",
    "compact_host_resize", "compact_scene_cache", "compact_cached_scenes",
    "lpips_vgg_weights_path", "lpips_lin_weights_path",
    "data_source_class_type", "data_source_ImplicitronDataSource_args",
    "model_factory_class_type", "model_factory_ImplicitronModelFactory_args",
    "optimizer_factory_class_type",
    "optimizer_factory_ImplicitronOptimizerFactory_args",
    "training_loop_class_type", "training_loop_ImplicitronTrainingLoop_args",
})

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
    # the renderer always returns its weights, so both values hold
    rend.get("return_weights", False)

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
        # fuse_decode and collapse_density are model arguments, not config keys
        sampler=impl.get("sampler", "packed"),
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
            schedule_sampler_type=diff.get("schedule_sampler_type", "uniform"),
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


def training_loop_args_from_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """`training_loop_ImplicitronTrainingLoop_args` -> the loop's settings."""
    t = cfg.get("training_loop_ImplicitronTrainingLoop_args", {})
    return dict(
        eval_only=t.get("eval_only", False),
        max_epochs=t.get("max_epochs", 1000),
        store_checkpoints=t.get("store_checkpoints", True),
        store_checkpoints_purge=t.get("store_checkpoints_purge", 1),
        test_interval=t.get("test_interval", -1),
        test_when_finished=t.get("test_when_finished", False),
        validation_interval=t.get("validation_interval", 1),
        clip_grad=t.get("clip_grad", 0.0),
        metric_print_interval=t.get("metric_print_interval", 5),
        visualize_interval=t.get("visualize_interval", 100),
        whole_dataset_batch=t.get("whole_dataset_batch", False),
        profile=t.get("profile", False),
        evaluator_ImplicitronEvaluator_args=dict(
            t.get("evaluator_ImplicitronEvaluator_args", {}) or {}
        ),
    )


def data_source_args_from_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """`data_source_ImplicitronDataSource_args` -> the data source's and the
    loader's settings (the CO3D keys as the JAX package reads them)."""
    d = cfg.get("data_source_ImplicitronDataSource_args", {})
    dm = d.get("dataset_map_provider_JsonIndexDatasetMapProviderV2_args", {})
    ds = dm.get("dataset_JsonIndexDataset_args", {})
    dl = d.get("data_loader_map_provider_SequenceDataLoaderMapProvider_args", {})
    return dict(
        category=dm.get("category", "teddybear"),
        subset_name=dm.get("subset_name", "fewview_dev"),
        dataset_root=dm.get("dataset_root", ds.get("dataset_root", "")),
        test_on_train=dm.get("test_on_train", True),
        image_height=ds.get("image_height", 800),
        image_width=ds.get("image_width", 800),
        box_crop=ds.get("box_crop", True),
        box_crop_mask_thr=ds.get("box_crop_mask_thr", 0.4),
        box_crop_context=ds.get("box_crop_context", 0.3),
        load_depths=ds.get("load_depths", True),
        load_masks=ds.get("load_masks", True),
        load_images=ds.get("load_images", True),
        remove_empty_masks=ds.get("remove_empty_masks", True),
        n_frames_per_sequence=ds.get("n_frames_per_sequence", -1),
        pick_sequence=tuple(ds.get("pick_sequence", ()) or ()),
        exclude_sequence=tuple(ds.get("exclude_sequence", ()) or ()),
        limit_sequences_to=ds.get("limit_sequences_to", 0),
        sort_frames=ds.get("sort_frames", False),
        load_eval_batches=dm.get("load_eval_batches", False),
        n_known_frames_for_test=dm.get("n_known_frames_for_test", 0),
        batch_size=dl.get("batch_size", 16),
        dataset_length_train=dl.get("dataset_length_train", 500),
        dataset_length_val=dl.get("dataset_length_val", 5),
        num_workers=dl.get("num_workers", 5),
        train_conditioning_type=_validate_conditioning(
            dl.get("train_conditioning_type", "SAME")
        ),
        images_per_seq_options=tuple(dl.get("images_per_seq_options", ()) or ()),
    )


def _validate_conditioning(value: str) -> str:
    """Batches hold frames of one sequence (SAME); the reference's KNOWN and
    EVAL conditioning modes are not supported."""
    if str(value).upper() not in ("SAME", ""):
        raise NotImplementedError(
            f"train_conditioning_type={value!r}: only SAME-sequence batching is supported"
        )
    return value


def dump_expconfig(cfg: Dict[str, Any], exp_dir: str) -> str:
    """Snapshot the resolved config to `exp_dir/expconfig.yaml`, which
    `utils/checkpoint_utils.py:load_experiment` reads back."""
    os.makedirs(exp_dir, exist_ok=True)
    path = os.path.join(exp_dir, "expconfig.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return path


# ---------------------------------------------------------------------------
# Consumed-key tracking: the translators above read the config through
# literal `.get` calls; running them over a recording proxy gives the schema
# of key paths they consume, and so the keys of a config that nothing reads.
# ---------------------------------------------------------------------------


class _Tracker:
    def __init__(self):
        self.paths: set = set()  # key paths read
        self.child_reads: dict = {}  # path -> whether a key under it was read


class _TrackingDict:
    """Read-only dict proxy that records every key read, by path."""

    def __init__(self, data, path: Tuple[str, ...], tracker: _Tracker):
        self._d = data if isinstance(data, dict) else {}
        self._path = path
        self._t = tracker
        tracker.child_reads.setdefault(path, False)

    def _record(self, k):
        p = self._path + (k,)
        self._t.paths.add(p)
        self._t.child_reads[self._path] = True
        self._t.child_reads.setdefault(p, False)
        return p

    def get(self, k, default=None):
        p = self._record(k)
        v = self._d.get(k, default)
        if isinstance(v, dict):
            return _TrackingDict(v, p, self._t)
        if isinstance(default, dict):
            return _TrackingDict({}, p, self._t)
        return v

    def __getitem__(self, k):
        p = self._record(k)
        v = self._d[k]
        return _TrackingDict(v, p, self._t) if isinstance(v, dict) else v

    def __contains__(self, k):
        self._record(k)
        return k in self._d

    def keys(self):
        for k in self._d:
            self._record(k)
        return self._d.keys()

    def __iter__(self):
        return iter(self.keys())

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def __len__(self):
        return len(self._d)


# key paths that experiment.py reads directly, outside the translators
_EXTRA_CONSUMED_PATHS = frozenset({
    ("model_factory_ImplicitronModelFactory_args", "resume"),
    ("model_factory_ImplicitronModelFactory_args", "resume_epoch"),
    ("model_factory_ImplicitronModelFactory_args", "force_resume"),
    ("model_factory_ImplicitronModelFactory_args", "model_HoloDiffusionModel_args", "log_vars"),
    ("data_source_ImplicitronDataSource_args", "dataset_map_provider_class_type"),
    ("data_source_ImplicitronDataSource_args", "data_loader_map_provider_class_type"),
    # kwargs passed whole to SyntheticDataProvider
    ("data_source_ImplicitronDataSource_args", "dataset_map_provider_SyntheticDataProvider_args"),
})

# keys of the reference's configs that are recognised but read by nothing,
# with the reason the audit gives
_REFERENCE_IGNORED_KEYS = {
    "only_test_set": "test-set-only loading unsupported; use eval_only + test_on_train=false",
    "path_manager_factory_class_type": "fb-internal PathManager surface; plain filesystem paths only",
    "path_manager_factory_PathManagerFactory_args": "see path_manager_factory_class_type",
    "visdom_env": "visdom is not supported",
    "visdom_port": "visdom is not supported",
    "visdom_server": "visdom is not supported",
}


def consumed_key_schema(cfg: Optional[Dict[str, Any]] = None):
    """Run every translator over a recording proxy of `cfg`; returns
    `(paths, open_subtrees)`: each key path read, and the dict-valued paths
    consumed whole (every key under them counts as read, e.g.
    `render_mlp_args`)."""
    t = _Tracker()
    proxy = _TrackingDict(cfg or {}, (), t)
    for fn in (model_args_from_config, optimizer_args_from_config,
               training_loop_args_from_config, data_source_args_from_config):
        fn(proxy)
    paths = set(t.paths) | set(_EXTRA_CONSUMED_PATHS)
    open_subtrees = {p for p in paths if not t.child_reads.get(p, False)}
    return paths, open_subtrees


def audit_unconsumed_keys(cfg: Dict[str, Any], warn=None) -> List[str]:
    """Warn for every key of `cfg` that nothing reads; returns their dotted
    names. Keys of `_REFERENCE_IGNORED_KEYS` get their reason. The
    `<slot>_<Class>_args` subtree of a class a `*_class_type` key did not
    select is inert and not reported."""
    warn = warn or logger.warning
    paths, open_subtrees = consumed_key_schema(cfg)
    dropped: List[str] = []

    def visit(d: Dict, path: Tuple[str, ...]):
        for k, v in d.items():
            p = path + (k,)
            if p in paths:
                if isinstance(v, dict) and p not in open_subtrees:
                    visit(v, p)
                continue
            if not path and k in _KNOWN_ROOT_KEYS:
                continue
            if k.endswith("_args") and any(
                s != k and k.startswith(s[: -len("class_type")])
                for s in d if s.endswith("_class_type")
            ):
                continue
            name = ".".join(str(x) for x in p)
            dropped.append(name)
            if k in _REFERENCE_IGNORED_KEYS:
                warn(f"config key {name!r} is recognized reference surface "
                     f"but not consumed: {_REFERENCE_IGNORED_KEYS[k]}")
            else:
                warn(f"config key {name!r} is not consumed by any component")

    visit(cfg, ())
    return dropped
