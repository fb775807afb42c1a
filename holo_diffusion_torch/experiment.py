"""Experiment: config -> model, optimizer, data and the training loop (port
of holo_diffusion_tpu/experiment.py; reference experiment.py:108-290 and
trainer/training_loop.py:47-712), in one process on one device.

    exp = Experiment(load_config("synthetic_debug.yaml"), device="cpu")
    state, stats = exp.run(max_epochs=3)

Every epoch reseeds numpy and `random` with seed + epoch and draws the
step's random values from `torch.Generator(device).manual_seed(seed +
epoch)`, so an epoch run after a resume draws what it draws in an
uninterrupted run. `run` resumes from the last checkpoint in `exp_dir` by
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
    model_args_from_config,
    optimizer_args_from_config,
    training_loop_args_from_config,
)
from .data.co3d import CO3DDataProvider
from .data.frame_data import FrameData
from .data.source import AsyncLoader, SyntheticDataProvider, WholeDatasetLoader, epoch_loader
from .device import DeviceLike, resolve_device
from .evaluation import evaluate_new_view_synthesis
from .models.diffusion import LossSecondMomentState
from .models.holo_model import HoloDiffusionModel
from .models.lpips import load_lpips_from_torch_files
from .models.metrics import preprocess_input
from .ops.image import resize_bilinear_antialiased
from .parallel.train_step import TrainState, make_eval_step, make_train_step
from .render_eval import render_image_chunked
from .train.checkpoint import restore_checkpoint, save_checkpoint
from .train.optimizer import make_lr_schedule, make_optimizer
from .train.stats import Stats
from .utils.profiling import SteadyStateProfiler, enable_anomaly_detection
from .utils.vis import denoising_video, plot_stats_pdf, visualize_preds, write_dashboard_html
from .weights import init_weights

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


def _check_ported(cfg) -> None:
    """Raise for each feature the config asks for that the port lacks,
    naming the ROADMAP.md §1 item that ports it."""
    unported = [
        (bool(cfg.get("compact_sources", False)), "compact_sources", 1),
        (bool(cfg.get("packed_transfer", False)), "packed_transfer", 1),
    ]
    for asked, what, item in unported:
        if asked:
            raise NotImplementedError(f"{what}: not ported yet (ROADMAP.md §1 item {item})")


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
        _check_ported(cfg)
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
        CPU), on the device, with a fresh optimizer, the loss-second-moment
        sampler's empty state when that sampler is on, and an EMA that
        starts at the parameters when `ema_rate` > 0."""
        init_weights(self.model, self.seed)
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
            dump_path=os.path.join(self.exp_dir, f"eval_results_epoch_{max(epoch, 0):08d}.json"),
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
        for batch in epoch_loader(self.data.val, self.batch_size, self.n_batches_val, self.seed + epoch):
            batch = self._to_device(batch)
            out = self._eval_batch_chunked(state, batch) if use_chunked else eval_step(state, batch, generator)
            stats.update(_host_floats({k: v for k, v in out.items() if v.ndim == 0}), "val")
        return out

    @torch.no_grad()
    def _eval_batch_chunked(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        """The EVALUATION forward of one batch through the chunked renderer:
        encode a grid from the source frames (1:), render target frame 0
        densely, score it against the preprocessed target resized to the
        render size."""
        model = state.model
        src = slice(1, None) if batch.batch_size > 1 else slice(0, None)

        def part(x, s):
            return None if x is None else x[s]

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

    def run(self, max_epochs: Optional[int] = None):
        """Train from the last checkpoint in `exp_dir` (unless `resume` is
        off) up to `max_epochs` (the config's when None); each epoch ends
        with a validation epoch (when on), a test evaluation (when on and
        due), its stats and a checkpoint. Returns (state, stats); with
        `eval_only` the results of `run_eval_only` instead."""
        os.makedirs(self.exp_dir, exist_ok=True)
        dump_expconfig(self.cfg, self.exp_dir)
        if self.loop_args["eval_only"]:
            return self.run_eval_only()
        state = self.init_state()
        stats = Stats.load_or_new(os.path.join(self.exp_dir, "train_stats.json"),
                                  log_vars=_model_cfg_log_vars(self.cfg))
        start_epoch = 0
        restored, ep = self._restore(state)
        if restored is not None:
            state, start_epoch = restored, ep + 1
            logger.info("resumed from epoch %d", ep)

        k = self.steps_per_dispatch
        train_step = make_train_step(self.model, state.optimizer, schedule_sampler=self.schedule_sampler,
                                     ema_rate=self.ema_rate, steps_per_call=k)
        eval_step = make_eval_step(self.model)
        max_epochs = max_epochs or self.loop_args["max_epochs"]
        print_interval = self.loop_args["metric_print_interval"]
        val_interval = self.loop_args["validation_interval"]
        test_interval = self.loop_args["test_interval"]
        vis_interval = self.loop_args["visualize_interval"]
        testing = not self.cfg.get("disable_testing", True)
        # calls of the train step an epoch, each of k optimizer steps
        n_calls = max(1, self.n_batches_train // k)
        stats.epoch = start_epoch - 1

        for epoch in range(start_epoch, max_epochs):
            seed_all_random_engines(self.seed + epoch)
            stats.new_epoch()
            generator = torch.Generator(device=self.device).manual_seed(self.seed + epoch)
            if self.loop_args["whole_dataset_batch"]:
                loader = WholeDatasetLoader(self.data.train, self.batch_size, n_calls * k, self.seed)
            else:
                loader = epoch_loader(self.data.train, self.batch_size, n_calls * k, self.seed + epoch)

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
                        if self.loop_args["profile"] and epoch == start_epoch else None)
            self.model.train()
            for it, batch in enumerate(AsyncLoader(self._group_steps(loader), transfer=self._to_device)):
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
                if vis_interval and epoch % vis_interval == 0:
                    self._visualize(state.model, out, epoch)

            if testing and test_interval > 0 and epoch % test_interval == 0:
                res = self._test_eval(state, f"eval_epoch_{epoch:08d}.json")
                logger.info("test eval @ %d: %s", epoch, res["overall"])

            stats.finalize_epoch()
            if self.loop_args["store_checkpoints"]:
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
        if testing and self.loop_args["test_when_finished"]:
            self._test_eval(state, "eval_final.json")
        return state, stats
