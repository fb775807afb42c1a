"""Experiment: config -> model, optimizer, data and the training loop (port
of holo_diffusion_tpu/experiment.py; reference experiment.py:108-290 and
trainer/training_loop.py:47-712), in one process, or data parallel in one
process a GPU under torchrun (parallel/launch.py).

    exp = Experiment(load_config("synthetic_debug.yaml"), device="cpu")
    state, stats = exp.run(max_epochs=3)

Every epoch reseeds numpy and `random` with seed + epoch + 10000 * rank
and draws the step's random values from `torch.Generator(device).
manual_seed(seed + epoch + 10000 * rank)`, so an epoch run after a resume
draws what it draws in an uninterrupted run. The per-rank offset is the
reference's (experiment.py:167); JAX folds the device index into its key
instead, which torch cannot reproduce, and rank 0 (a single process) keeps
the stream it had without it. With a process group of more than one rank
(and `use_mesh`) each rank trains on its own scene and the ranks average
their gradients (parallel/train_step.py); rank 0 alone writes checkpoints,
stats, plots and visuals, and the ranks meet after each save. With
`compact_sources` the pooling sources are masked and resized on the host
(data/compact.py), with `packed_transfer` each batch is copied as one
buffer (data/packing.py). `run` resumes from the last checkpoint in `exp_dir` by
default; with `steps_per_dispatch` K it groups K batches per call of the
train step; with `eval_only` it evaluates the checkpoint instead
(`run_eval_only`, with LPIPS when `lpips_vgg_weights_path` is set), and
with `disable_testing: false` it evaluates novel views at `test_interval`
and when finished. With `training_loop.profile` it traces the first
epoch's dispatches into exp_dir/traces; every `visualize_interval` epochs
with validation on it dumps PNGs (and with `visualize_denoising_video` a
denoising video) into exp_dir/visuals; after every checkpoint it writes
`train_stats.pdf` and `dashboard.html`. Runs on CUDA unless the caller
passes `device="cpu"`.
"""
from __future__ import annotations

import logging
import os
import random
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from .config import (
    audit_unconsumed_keys,
    data_source_args_from_config,
    dump_expconfig,
    extractor_weights_path,
    model_args_from_config,
    optimizer_args_from_config,
    training_loop_args_from_config,
)
from .data.co3d import CO3DDataProvider
from .data.compact import CompactSceneSampler, SourceCompactor
from .data.frame_data import FrameData
from .data.packing import BatchPacker, packed_transfer
from .data.source import AsyncLoader, SyntheticDataProvider, WholeDatasetLoader, device_batched_loader, epoch_loader
from .device import DeviceLike, resolve_device
from .evaluation import evaluate_new_view_synthesis
from .models.diffusion import LossSecondMomentState
from .models.holo_model import HoloDiffusionModel
from .models.lpips import load_lpips_from_torch_files
from .models.metrics import preprocess_input
from .ops.image import resize_bilinear_antialiased
from .parallel import launch
from .parallel.mesh import make_mesh, replicate
from .parallel.train_step import TrainState, make_eval_step, make_train_step
from .render_eval import render_image_chunked
from .train.checkpoint import restore_checkpoint, save_checkpoint
from .train.optimizer import make_lr_schedule, make_optimizer
from .train.stats import Stats
from .utils.profiling import SteadyStateProfiler, enable_anomaly_detection
from .utils.vis import denoising_video, plot_stats_pdf, visualize_preds, write_dashboard_html
from .weights import init_weights, load_resnet_state_dict

logger = logging.getLogger(__name__)


def _model_cfg_log_vars(cfg):
    """The model config's optional `log_vars`; None logs every scalar."""
    m = cfg.get("model_factory_ImplicitronModelFactory_args", {}).get("model_HoloDiffusionModel_args", {})
    return m.get("log_vars")


def seed_all_random_engines(seed: int):
    """Seed numpy and `random` (reference trainer/utils.py:24-27); torch
    draws come from explicit generators."""
    np.random.seed(seed)
    random.seed(seed)


def _host_floats(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Scalar device tensors -> host floats, in one copy."""
    if not metrics:
        return {}
    return dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))


class Experiment:
    def __init__(self, cfg: dict, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.seed = cfg.get("seed", 42)
        self.exp_dir = cfg.get("exp_dir", "./experiments/run")
        audit_unconsumed_keys(cfg)
        self.model_args = model_args_from_config(cfg)
        self.opt_args = optimizer_args_from_config(cfg)
        self.loop_args = training_loop_args_from_config(cfg)
        self.data_args = data_source_args_from_config(cfg)
        ds_cfg = cfg.get("data_source_ImplicitronDataSource_args", {})
        provider = ds_cfg.get("dataset_map_provider_class_type", "JsonIndexDatasetMapProviderV2")
        seed_all_random_engines(self.seed)
        if cfg.get("detect_anomaly", False):
            enable_anomaly_detection()

        self.model = HoloDiffusionModel(**self.model_args)
        self.data = self._build_data_source(ds_cfg, provider)
        self.batch_size = self.data_args["batch_size"]
        self.n_batches_train = max(1, self.data_args["dataset_length_train"] // self.batch_size)
        self.n_batches_val = max(1, self.data_args["dataset_length_val"] // max(self.batch_size, 1))
        # the schedule's epochs are n_batches_train optimizer steps each
        self.lr_schedule = make_lr_schedule(
            self.opt_args["optimizer"]["lr"], **self.opt_args["schedule"],
            steps_per_epoch=self.n_batches_train)
        # the timestep sampler (diffusion_utils.py:97,113), uniform without diffusion
        diff_args = self.model_args.get("diffusion_args") or {}
        self.schedule_sampler = (diff_args.get("schedule_sampler_type", "uniform")
                                 if self.model_args.get("diffusion_enabled", True) else "uniform")
        self.ema_rate = float(cfg.get("ema_rate", 0.0))
        # optimizer steps per call of the train step
        self.steps_per_dispatch = max(1, int(cfg.get("steps_per_dispatch", 1)))
        self.compactor = self._build_compactor()
        self._train_data = self._val_data = None

    def _build_compactor(self) -> Optional[SourceCompactor]:
        """The host compaction of the pooling sources (`compact_sources`),
        dropping the target depths when no depth term weighs in the
        objective (`compact_drop_depth: auto`)."""
        if not self.cfg.get("compact_sources", False):
            return None
        drop_depth = self.cfg.get("compact_drop_depth", "auto")
        if drop_depth == "auto":
            drop_depth = not any("depth" in k and w != 0.0 for k, w in self.model.loss_weights.items())
        return SourceCompactor.from_model(self.model, drop_depth=bool(drop_depth),
                                          host_resize=self.cfg.get("compact_host_resize", "native"))

    def _make_packer(self, mesh=None) -> Optional[BatchPacker]:
        """The packer of `packed_transfer`: none under a mesh (each rank
        copies its own batch, as in JAX), and none with
        `whole_dataset_batch`, whose one batch is on the device already."""
        if not self.cfg.get("packed_transfer", False) or mesh is not None:
            return None
        if self.loop_args["whole_dataset_batch"]:
            logger.warning("packed_transfer ignored with whole_dataset_batch (the replayed batch is already "
                           "on the device)")
            return None
        return BatchPacker()

    def _compact_train_data(self):
        """The training batches' source: with compact sources and the scene
        cache (`compact_scene_cache`, default on) a `CompactSceneSampler`,
        built once so its cache lasts across epochs; and with `compact_val`
        (default on) one for the validation batches, which split 1 target +
        (B-1) sources. Otherwise the train split (compacted batch by batch
        when compaction is on)."""
        comp = self.compactor
        if comp is None or not self.cfg.get("compact_scene_cache", True):
            return self.data.train
        n_cached = int(self.cfg.get("compact_cached_scenes", 4))
        if self.cfg.get("compact_val", True):
            val_comp = SourceCompactor(1, comp.image_rescale, comp.mask_images, comp.mask_threshold, comp.bg_color,
                                       drop_depth=comp.drop_depth, host_resize=comp.host_resize)
            self._val_data = CompactSceneSampler(self.data.val, val_comp, max_cached_scenes=n_cached)
        return CompactSceneSampler(self.data.train, comp, max_cached_scenes=n_cached)

    def _build_data_source(self, ds_cfg: dict, provider: str):
        """The synthetic scenes (made on the device) or CO3Dv2 (cached on
        the host)."""
        if provider == "SyntheticDataProvider":
            return SyntheticDataProvider(
                seed=self.seed, device=self.device,
                **ds_cfg.get("dataset_map_provider_SyntheticDataProvider_args", {}))
        return CO3DDataProvider(**self.data_args)

    def _to_device(self, batch: FrameData) -> FrameData:
        """A batch on the device. A host batch bound for the card is pinned
        first, so its copy is asynchronous (in the loader's thread, it
        overlaps the step before)."""
        if batch.device.type == "cpu" and self.device.type == "cuda":
            batch = batch.pin_memory()
        return batch.to(self.device, non_blocking=True)

    def init_state(self) -> TrainState:
        """The seeded initialisation (weights.init_weights, drawn on the
        CPU; the extractor's trunk read from the torchvision ResNet
        state_dict at `...ResNetFeatureExtractor_args.weights_path` when
        `pretrained` is true), on the device, with a fresh optimizer, the loss-second-moment
        sampler's empty state when that sampler is on, and an EMA that
        starts at the parameters when `ema_rate` > 0."""
        init_weights(self.model, self.seed)
        resnet = extractor_weights_path(self.cfg)
        if resnet and self.model.view_pooler_enabled:
            load_resnet_state_dict(self.model.image_feature_extractor,
                                   torch.load(resnet, map_location="cpu", weights_only=True))
            logger.info("extractor trunk read from %s", resnet)
        self.model.to(self.device)
        logger.info("model has %.2fM params", sum(p.numel() for p in self.model.parameters()) / 1e6)
        opt = make_optimizer(self.model.named_parameters(), **self.opt_args["optimizer"],
                             schedule=self.lr_schedule)
        sampler_state = None
        if self.schedule_sampler == "loss-second-moment":
            sampler_state = LossSecondMomentState.create(
                (self.model_args.get("diffusion_args") or {}).get("num_steps", 1000), device=self.device)
        return TrainState.create(self.model, opt, sampler_state=sampler_state, ema=self.ema_rate > 0.0)

    def _restore(self, state: TrainState):
        """The checkpoint the config asks for (the last unless
        `resume_epoch`), restored into `state`: (state, epoch), or (None,
        -1) when resuming is off or there is none (which raises under
        `force_resume`)."""
        mf = self.cfg.get("model_factory_ImplicitronModelFactory_args", {})
        if not mf.get("resume", True):
            return None, -1
        restored, ep = restore_checkpoint(self.exp_dir, state, mf.get("resume_epoch", -1))
        if restored is None and mf.get("force_resume", False):
            raise FileNotFoundError(f"force_resume: no checkpoint in {self.exp_dir}")
        return restored, ep

    def _eval_scenes(self, limit: int = -1):
        """The scenes novel-view evaluation runs on: the val split's, or the
        train split's when val is empty; the first `limit` (all when
        negative), loaded one at a time."""
        ds = self.data.val if len(self.data.val) else self.data.train
        return ds.iter_scenes(limit)

    def run_eval_only(self, use_ema: Optional[bool] = None, timings: Optional[Dict[str, List[float]]] = None):
        """Evaluation only (training_loop.py:177-193): restore the checkpoint
        the config asks for, evaluate novel views over the held-out scenes
        (the dataset's eval batches when it loaded them, the CO3D challenge
        protocol), dump `eval_results_epoch_%08d.json` into exp_dir and
        return the results. `use_ema` evaluates through the EMA of the
        parameters (a run trained with ema_rate > 0); None reads the
        config's `eval_use_ema`. `timings` receives each target's seconds by
        phase (`evaluate_new_view_synthesis`)."""
        if use_ema is None:
            use_ema = bool(self.cfg.get("eval_use_ema", False))
        os.makedirs(self.exp_dir, exist_ok=True)
        state = self.init_state()
        restored, epoch = self._restore(state)
        if restored is None:
            logger.warning("eval_only: no checkpoint found; evaluating the freshly initialised model")
        else:
            state = restored
            logger.info("eval_only: restored epoch %d", epoch)
        if use_ema:
            if state.ema is None:
                raise ValueError("eval_use_ema: the checkpoint carries no EMA of the parameters "
                                 "(train with ema_rate > 0)")
            state.swap_in_ema()
        eval_batches, scenes = None, []
        if getattr(self.data, "eval_batches", None):
            # assembled one at a time: a release category has thousands
            eval_batches = (self.data.get_eval_batch(i) for i in range(len(self.data.eval_batches)))
        else:
            scenes = self._eval_scenes()
        perceptual_fn = None
        lpips_vgg = self.cfg.get("lpips_vgg_weights_path")
        if lpips_vgg:
            perceptual_fn = load_lpips_from_torch_files(lpips_vgg, self.cfg.get("lpips_lin_weights_path"),
                                                        device=self.device)
        ev = self.loop_args.get("evaluator_ImplicitronEvaluator_args", {})
        state.model.eval()
        res = evaluate_new_view_synthesis(
            state.model, scenes,
            difficulty_bin_breaks=tuple(ev.get("camera_difficulty_bin_breaks", (0.97, 0.98))),
            perceptual_fn=perceptual_fn,
            eval_batches=eval_batches,
            dump_path=(os.path.join(self.exp_dir, f"eval_results_epoch_{max(epoch, 0):08d}.json")
                       if launch.is_main_process() else None),
            device=self.device,
            timings=timings,
        )
        logger.info("eval_only results: %s", res["overall"])
        return res

    def _test_eval(self, state: TrainState, dump_name: str):
        """Novel-view evaluation of the state's model on the first 4 eval
        scenes, dumped to exp_dir/`dump_name` (training_loop.py:273-279)."""
        state.model.eval()
        res = evaluate_new_view_synthesis(state.model, self._eval_scenes(4),
                                          dump_path=os.path.join(self.exp_dir, dump_name), device=self.device)
        state.model.train()
        return res

    def _group_steps(self, batches):
        """`steps_per_dispatch` batches at a time, stacked on a leading step
        axis where they lie (a host batch is then pinned and copied as one);
        single batches when it is 1."""
        k = self.steps_per_dispatch
        if k == 1:
            yield from batches
            return
        group = []
        for b in batches:
            group.append(b)
            if len(group) == k:
                yield FrameData.stack_steps(group)
                group = []
        if group:
            logger.warning("dropping a trailing group of %d < %d batches", len(group), k)

    # ------------------------------------------------------------------
    def _val_epoch(self, state: TrainState, stats: Stats, eval_step, epoch: int):
        """One EVALUATION epoch over the val set (reference
        training_loop.py:253-265). With `chunk_size_grid` > 0 frames go
        through the chunked renderer, whose device memory is bounded at any
        render size. Returns the last batch's outputs."""
        model = state.model
        use_chunked = (model.chunk_size_grid or 0) > 0 and model.sampling_mode_evaluation == "full_grid"
        # draws of the evaluation sampling modes that draw (mask_sample,
        # stratified points), apart from the training draws
        generator = torch.Generator(device=self.device).manual_seed(self.seed + epoch)
        out = None
        val_data = self._val_data or self.data.val
        for batch in epoch_loader(val_data, self.batch_size, self.n_batches_val, self.seed + epoch):
            batch = self._to_device(batch)
            out = self._eval_batch_chunked(state, batch) if use_chunked else eval_step(state, batch, generator)
            stats.update(_host_floats({k: v for k, v in out.items() if v.ndim == 0}), "val")
        return out

    @torch.no_grad()
    def _eval_batch_chunked(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        """The EVALUATION forward of one batch through the chunked renderer:
        encode a grid from the source frames (1:, or a compact batch's
        sources), render target frame 0 densely, score it against the
        preprocessed target resized to the render size."""
        model = state.model

        def part(x, s):
            return None if x is None else x[s]

        if batch.src_image_rgb is not None:
            # compact: the camera covers the targets, then the sources,
            # which come masked and resized already
            grid = model.encode_eval(batch.camera[batch.image_rgb.shape[0]:], batch.src_image_rgb,
                                     batch.src_fg_probability, batch.src_mask_crop, prerescaled=True)
        else:
            src = slice(1, None) if batch.batch_size > 1 else slice(0, None)
            grid = model.encode_eval(batch.camera[src], batch.image_rgb[src],
                                     part(batch.fg_probability, src), part(batch.mask_crop, src))
        out = render_image_chunked(model, batch.camera[:1], grid, device=self.device)
        gt, fg, _ = preprocess_input(batch.image_rgb[:1], part(batch.fg_probability, slice(0, 1)), None,
                                     model.mask_images, model.mask_depths, model.mask_threshold,
                                     model.bg_color)
        H, W = model.render_image_height, model.render_image_width
        gt = resize_bilinear_antialiased(gt, H, W)[0]
        pred = out["images_render"]
        mse = torch.mean((pred - gt) ** 2)
        result = {
            "loss_rgb_mse": mse,
            "loss_rgb_psnr": -10.0 * torch.log10(torch.clamp(mse, min=1e-12)),
            "images_render": pred[None],
            "depths_render": out["depths_render"][None],
            "masks_render": out["masks_render"][None],
        }
        if fg is not None:
            fg_r = resize_bilinear_antialiased(fg, H, W)[0] > 0.5
            denom = torch.clamp(fg_r.sum() * 3, min=1)
            mse_fg = torch.sum(((pred - gt) ** 2) * fg_r) / denom
            result["loss_rgb_psnr_fg"] = -10.0 * torch.log10(torch.clamp(mse_fg, min=1e-12))
        return result

    def _visualize(self, model: HoloDiffusionModel, preds: Dict[str, torch.Tensor], epoch: int) -> None:
        """A validation epoch's visual dumps into exp_dir/visuals (the
        reference's visdom panels, training_loop.py:501-516): its last
        preds as PNG grids, and with `visualize_denoising_video` the DDPM
        denoising of a fresh sample seen by the first val scene's first
        camera (a train scene's when val is empty)."""
        vis_dir = os.path.join(self.exp_dir, "visuals")
        visualize_preds(preds, vis_dir, "val", epoch)
        if not self.cfg.get("visualize_denoising_video", False):
            return
        ds = self.data.val if len(self.data.val) else self.data.train
        if not len(ds):
            logger.warning("visualize_denoising_video: no scenes in any split; skipping the denoising-video dump")
            return
        camera = ds.get_scene(0).camera[:1]
        generator = torch.Generator(device=self.device).manual_seed(self.seed + epoch)
        t0 = time.perf_counter()
        path = denoising_video(model, os.path.join(vis_dir, f"denoising_{epoch:08d}.mp4"), camera, generator,
                               device=self.device)
        logger.info("denoising video %s in %.3f s", path, time.perf_counter() - t0)

    def run(self, max_epochs: Optional[int] = None, use_mesh: bool = True):
        """Train from the last checkpoint in `exp_dir` (unless `resume` is
        off) up to `max_epochs` (the config's when None); each epoch ends
        with a validation epoch (when on), a test evaluation (when on and
        due), its stats and a checkpoint. With a process group of more than
        one rank and `use_mesh`, data parallel over its ranks: an epoch's
        n_batches_train steps are split over them. Returns (state, stats);
        with `eval_only` the results of `run_eval_only` instead."""
        main = launch.is_main_process()
        os.makedirs(self.exp_dir, exist_ok=True)
        if main:
            dump_expconfig(self.cfg, self.exp_dir)
        if self.loop_args["eval_only"]:
            return self.run_eval_only()
        rank, world = launch.rank(), launch.world_size()
        mesh = make_mesh(self.device) if use_mesh and world > 1 else None
        n_dev = mesh.world_size if mesh is not None else 1
        whole = self.loop_args["whole_dataset_batch"]
        if whole and mesh is not None:
            raise NotImplementedError("whole_dataset_batch replays one batch on one device; run with --no-mesh")
        # kept, so that a caller can read the compact scene cache's hits
        train_data = self._train_data = self._compact_train_data()
        # compacted batch by batch unless the scene cache compacts them
        per_batch_compactor = self.compactor if train_data is self.data.train else None
        packer = self._make_packer(mesh)
        state = self.init_state()
        stats = Stats.load_or_new(os.path.join(self.exp_dir, "train_stats.json"),
                                  log_vars=_model_cfg_log_vars(self.cfg))
        start_epoch = 0
        restored, ep = self._restore(state)
        if restored is not None:
            state, start_epoch = restored, ep + 1
            logger.info("resumed from epoch %d", ep)
        if mesh is not None:
            state = replicate(state, mesh)

        k = self.steps_per_dispatch
        train_step = make_train_step(self.model, state.optimizer, schedule_sampler=self.schedule_sampler,
                                     ema_rate=self.ema_rate, steps_per_call=k, mesh=mesh, packer=packer)
        eval_step = make_eval_step(self.model)
        max_epochs = max_epochs or self.loop_args["max_epochs"]
        print_interval = self.loop_args["metric_print_interval"]
        val_interval = self.loop_args["validation_interval"]
        test_interval = self.loop_args["test_interval"]
        vis_interval = self.loop_args["visualize_interval"]
        testing = not self.cfg.get("disable_testing", True)
        # calls of the train step an epoch on each rank, each of k optimizer steps
        n_calls = max(1, self.n_batches_train // (n_dev * k))
        transfer = self._to_device if packer is None else packed_transfer(packer, self.device)
        stats.epoch = start_epoch - 1

        for epoch in range(start_epoch, max_epochs):
            # the reference's per-rank offset (experiment.py:167)
            seed_all_random_engines(self.seed + epoch + 10000 * rank)
            stats.new_epoch()
            generator = torch.Generator(device=self.device).manual_seed(self.seed + epoch + 10000 * rank)
            if whole:
                loader = WholeDatasetLoader(self.data.train, self.batch_size, n_calls * k, self.seed)
            elif mesh is not None:
                loader = device_batched_loader(train_data, self.batch_size, n_calls * k, self.seed + epoch, n_dev,
                                               process_index=mesh.rank, process_count=n_dev,
                                               transform=per_batch_compactor)
            else:
                loader = epoch_loader(train_data, self.batch_size, n_calls * k, self.seed + epoch)
                if per_batch_compactor is not None:
                    loader = map(per_batch_compactor, loader)

            # Step N's metrics are read after step N+1 is launched, so the
            # host does not wait for the device between steps; a status
            # line flushes them all, so its averages include its step.
            pending = deque()

            def flush(keep: int) -> None:
                while len(pending) > keep:
                    stats.update(_host_floats(pending.popleft()), "train")

            # training_loop.profile: a trace of the first epoch's dispatches
            # 1..profile_steps (dispatch 0 warms the caches up)
            profiler = (SteadyStateProfiler(os.path.join(self.exp_dir, "traces"), self.loop_args["profile_steps"])
                        if self.loop_args["profile"] and epoch == start_epoch and main else None)
            self.model.train()
            for it, batch in enumerate(AsyncLoader(self._group_steps(loader), transfer=transfer)):
                if profiler is not None:
                    profiler.before_dispatch(it)
                state, metrics = train_step(state, batch, generator)
                if profiler is not None:
                    profiler.after_dispatch(it, metrics)
                pending.append(metrics)
                if print_interval and it % print_interval == 0:
                    flush(0)
                    logger.info(stats.status_line("train"))
                else:
                    flush(1)
            flush(0)
            if profiler is not None:
                profiler.finish(metrics)

            if val_interval > 0 and epoch % val_interval == 0 and not self.cfg.get("disable_validation", False):
                self.model.eval()
                out = self._val_epoch(state, stats, eval_step, epoch)
                logger.info(stats.status_line("val"))
                if vis_interval and epoch % vis_interval == 0 and main:
                    self._visualize(state.model, out, epoch)

            if testing and test_interval > 0 and epoch % test_interval == 0 and main:
                res = self._test_eval(state, f"eval_epoch_{epoch:08d}.json")
                logger.info("test eval @ %d: %s", epoch, res["overall"])

            stats.finalize_epoch()
            if self.loop_args["store_checkpoints"] and main:
                save_checkpoint(self.exp_dir, epoch, state, stats,
                                purge=self.loop_args["store_checkpoints_purge"])
                t0 = time.perf_counter()
                try:
                    plot_stats_pdf(stats, os.path.join(self.exp_dir, "train_stats.pdf"))
                    write_dashboard_html(stats, self.exp_dir)
                    logger.info("stats plot and dashboard in %.3f s", time.perf_counter() - t0)
                except ImportError as e:
                    if not (e.name or "").startswith("matplotlib"):
                        raise
                    logger.warning("stats plot failed: %s", e)
            # every rank resumes from what rank 0 wrote
            launch.barrier()
        if testing and self.loop_args["test_when_finished"] and main:
            self._test_eval(state, "eval_final.json")
        return state, stats
