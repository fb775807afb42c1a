"""Experiment: config -> model, optimizer, data and the training loop (port
of holo_diffusion_tpu/experiment.py; reference experiment.py:108-290 and
trainer/training_loop.py:47-712), in one process on one device.

    exp = Experiment(load_config("synthetic_debug.yaml"), device="cpu")
    state, stats = exp.run(max_epochs=3)

Every epoch reseeds numpy and `random` with seed + epoch and draws the
step's random values from `torch.Generator(device).manual_seed(seed +
epoch)`, so an epoch run after a resume draws what it draws in an
uninterrupted run. `run` resumes from the last checkpoint in `exp_dir` by
default. Runs on CUDA unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

import logging
import os
import random
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .config import (
    audit_unconsumed_keys,
    data_source_args_from_config,
    dump_expconfig,
    model_args_from_config,
    optimizer_args_from_config,
    training_loop_args_from_config,
)
from .data.source import AsyncLoader, SyntheticDataProvider, WholeDatasetLoader, epoch_loader
from .device import DeviceLike, resolve_device
from .models.holo_model import HoloDiffusionModel
from .models.metrics import preprocess_input
from .parallel.train_step import TrainState, make_eval_step, make_train_step
from .render_eval import render_image_chunked
from .train.checkpoint import restore_checkpoint, save_checkpoint
from .train.optimizer import make_lr_schedule, make_optimizer
from .train.stats import Stats
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


def _check_ported(cfg, loop_args, provider: str, diffusion_args) -> None:
    """Raise for each feature the config asks for that the port lacks,
    naming the ROADMAP.md §1 item that ports it."""
    validation_on = loop_args["validation_interval"] > 0 and not cfg.get("disable_validation", False)
    testing = not cfg.get("disable_testing", True) and (
        loop_args["test_interval"] > 0 or loop_args["test_when_finished"])
    unported = [
        (float(cfg.get("ema_rate", 0.0)) > 0.0, "ema_rate > 0 (EMA)", 2),
        ((diffusion_args or {}).get("schedule_sampler_type", "uniform") != "uniform",
         "schedule_sampler_type other than uniform", 2),
        (int(cfg.get("steps_per_dispatch", 1)) > 1, "steps_per_dispatch > 1", 2),
        (provider != "SyntheticDataProvider", f"dataset_map_provider_class_type={provider} (CO3D)", 3),
        (bool(cfg.get("compact_sources", False)), "compact_sources", 3),
        (bool(cfg.get("packed_transfer", False)), "packed_transfer", 3),
        (bool(loop_args["eval_only"]), "eval_only", 4),
        (testing, "test evaluation (disable_testing: false)", 4),
        (bool(loop_args["profile"]), "training_loop profile", 6),
        (validation_on and loop_args["visualize_interval"] > 0,
         "visualize_interval > 0 with validation on (visualizations)", 6),
    ]
    for asked, what, item in unported:
        if asked:
            raise NotImplementedError(f"{what}: not ported yet (ROADMAP.md §1 item {item})")


def _host_floats(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Scalar device tensors -> host floats, in one copy."""
    if not metrics:
        return {}
    return dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))


def _resize_bilinear_antialiased(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, height, width, C) as `jax.image.resize(...,
    "bilinear")` computes it: half-pixel centres, a triangle filter widened
    by the scale when shrinking (antialiasing). ops/image.py:resize_image
    does not antialias, as the model's own resize must not."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(height, width), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


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
        _check_ported(cfg, self.loop_args, provider, self.model_args.get("diffusion_args"))
        seed_all_random_engines(self.seed)
        if cfg.get("detect_anomaly", False):
            # the reference's detect_anomaly (experiment.py:181-184)
            torch.autograd.set_detect_anomaly(True)

        self.model = HoloDiffusionModel(**self.model_args)
        self.data = SyntheticDataProvider(
            seed=self.seed, device=self.device,
            **ds_cfg.get("dataset_map_provider_SyntheticDataProvider_args", {}))
        self.batch_size = self.data_args["batch_size"]
        self.n_batches_train = max(1, self.data_args["dataset_length_train"] // self.batch_size)
        self.n_batches_val = max(1, self.data_args["dataset_length_val"] // max(self.batch_size, 1))
        # the schedule's epochs are n_batches_train optimizer steps each
        self.lr_schedule = make_lr_schedule(
            self.opt_args["optimizer"]["lr"], **self.opt_args["schedule"],
            steps_per_epoch=self.n_batches_train)

    def init_state(self) -> TrainState:
        """The seeded initialisation (weights.init_weights, drawn on the
        CPU), on the device, with a fresh optimizer."""
        init_weights(self.model, self.seed)
        self.model.to(self.device)
        logger.info("model has %.2fM params", sum(p.numel() for p in self.model.parameters()) / 1e6)
        opt = make_optimizer(self.model.named_parameters(), **self.opt_args["optimizer"],
                             schedule=self.lr_schedule)
        return TrainState(self.model, opt)

    # ------------------------------------------------------------------
    def _val_epoch(self, state: TrainState, stats: Stats, eval_step, epoch: int):
        """One EVALUATION epoch over the val set (reference
        training_loop.py:253-265). With `chunk_size_grid` > 0 frames go
        through the chunked renderer, whose device memory is bounded at any
        render size. Returns the last batch's outputs."""
        model = state.model
        use_chunked = (model.chunk_size_grid or 0) > 0 and model.sampling_mode_evaluation == "full_grid"
        out = None
        for batch in epoch_loader(self.data.val, self.batch_size, self.n_batches_val, self.seed + epoch):
            out = self._eval_batch_chunked(state, batch) if use_chunked else eval_step(state, batch)
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
        gt = _resize_bilinear_antialiased(gt, H, W)[0]
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
            fg_r = _resize_bilinear_antialiased(fg, H, W)[0] > 0.5
            denom = torch.clamp(fg_r.sum() * 3, min=1)
            mse_fg = torch.sum(((pred - gt) ** 2) * fg_r) / denom
            result["loss_rgb_psnr_fg"] = -10.0 * torch.log10(torch.clamp(mse_fg, min=1e-12))
        return result

    def run(self, max_epochs: Optional[int] = None):
        """Train from the last checkpoint in `exp_dir` (unless `resume` is
        off) up to `max_epochs` (the config's when None); each epoch ends
        with a validation epoch (when on), its stats and a checkpoint.
        Returns (state, stats)."""
        os.makedirs(self.exp_dir, exist_ok=True)
        dump_expconfig(self.cfg, self.exp_dir)
        state = self.init_state()
        stats = Stats.load_or_new(os.path.join(self.exp_dir, "train_stats.json"),
                                  log_vars=_model_cfg_log_vars(self.cfg))
        start_epoch = 0
        mf = self.cfg.get("model_factory_ImplicitronModelFactory_args", {})
        if mf.get("resume", True):
            restored, ep = restore_checkpoint(self.exp_dir, state, mf.get("resume_epoch", -1))
            if restored is not None:
                state, start_epoch = restored, ep + 1
                logger.info("resumed from epoch %d", ep)
            elif mf.get("force_resume", False):
                raise FileNotFoundError(f"force_resume: no checkpoint in {self.exp_dir}")

        train_step = make_train_step(self.model, state.optimizer)
        eval_step = make_eval_step(self.model)
        max_epochs = max_epochs or self.loop_args["max_epochs"]
        print_interval = self.loop_args["metric_print_interval"]
        val_interval = self.loop_args["validation_interval"]
        stats.epoch = start_epoch - 1

        for epoch in range(start_epoch, max_epochs):
            seed_all_random_engines(self.seed + epoch)
            stats.new_epoch()
            generator = torch.Generator(device=self.device).manual_seed(self.seed + epoch)
            if self.loop_args["whole_dataset_batch"]:
                loader = WholeDatasetLoader(self.data.train, self.batch_size, self.n_batches_train, self.seed)
            else:
                loader = epoch_loader(self.data.train, self.batch_size, self.n_batches_train, self.seed + epoch)

            # Step N's metrics are read after step N+1 is launched, so the
            # host does not wait for the device between steps; a status
            # line flushes them all, so its averages include its step.
            pending = deque()

            def flush(keep: int) -> None:
                while len(pending) > keep:
                    stats.update(_host_floats(pending.popleft()), "train")

            self.model.train()
            for it, batch in enumerate(AsyncLoader(
                    loader, transfer=lambda b: b.to(self.device, non_blocking=True))):
                state, metrics = train_step(state, batch, generator)
                pending.append(metrics)
                if print_interval and it % print_interval == 0:
                    flush(0)
                    logger.info(stats.status_line("train"))
                else:
                    flush(1)
            flush(0)

            if val_interval > 0 and epoch % val_interval == 0 and not self.cfg.get("disable_validation", False):
                self.model.eval()
                self._val_epoch(state, stats, eval_step, epoch)
                logger.info(stats.status_line("val"))

            stats.finalize_epoch()
            if self.loop_args["store_checkpoints"]:
                save_checkpoint(self.exp_dir, epoch, state, stats,
                                purge=self.loop_args["store_checkpoints_purge"])
        return state, stats
