"""One training step on one device (port of the single-device leg of
holo_diffusion_tpu/parallel/train_step.py: uniform timesteps, no EMA, one
step per call): forward with `training=True`, backward of the objective,
optimizer step; and the EVALUATION forward of a batch.

    state = TrainState(model, optimizer)
    train_step = make_train_step(model, optimizer)
    state, metrics = train_step(state, batch, generator_or_draws)
    outputs = make_eval_step(model)(state, batch)

The decode's backward inside `loss.backward()` is the fused-decode backward
kernel on CUDA (ops/fused_decode.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from ..data.frame_data import FrameData
from ..models.holo_model import HoloDiffusionModel
from ..random_draws import Draws
from ..train.optimizer import Optimizer

TRACKED_METRICS = (
    "objective",
    "loss_rgb_mse",
    "loss_rgb_psnr",
    "loss_rgb_psnr_fg",
    "loss_rgb_huber",
    "loss_mask_bce",
    "loss_mask_neg_iou",
    "loss_depth_abs",
    "loss_depth_abs_fg",
    "loss_prev_stage_rgb_mse",
    "loss_prev_stage_rgb_psnr",
    "loss_prev_stage_mask_bce",
    "loss_prev_stage_prev_stage_rgb_mse",
)


@dataclasses.dataclass
class TrainState:
    """The model (its parameters and BN statistics), the optimizer (its
    moments and schedule) and the count of steps taken."""

    model: HoloDiffusionModel
    optimizer: Optimizer
    step: int = 0


def scalar_metrics(preds: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The tracked scalar metrics of `preds`, detached (still on the device)."""
    return {k: preds[k].detach() for k in TRACKED_METRICS if k in preds}


def make_train_step(
    model: HoloDiffusionModel, optimizer: Optimizer
) -> Callable[[TrainState, FrameData, Any], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """train_step(state, batch, generator_or_draws) -> (state, metrics).
    `generator_or_draws` is a `torch.Generator` on the batch's device, or a
    mapping of injected draws (random_draws.py). The state is updated in
    place and returned; metrics stay on the device (reading them waits for
    the step)."""

    def train_step(state: TrainState, batch: FrameData, generator_or_draws) -> Tuple[TrainState, Dict]:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer than this step's")
        optimizer.zero_grad()
        preds = model(
            camera=batch.camera,
            image_rgb=batch.image_rgb,
            fg_probability=batch.fg_probability,
            mask_crop=batch.mask_crop,
            depth_map=batch.depth_map,
            training=True,
            draws=Draws.of(generator_or_draws),
        )
        preds["objective"].backward()
        optimizer.step()
        state.step += 1
        return state, scalar_metrics(preds)

    return train_step


def make_eval_step(model: HoloDiffusionModel) -> Callable[[TrainState, FrameData], Dict[str, torch.Tensor]]:
    """eval_step(state, batch) -> the tracked scalar metrics and
    `images/depths/masks_render` of the EVALUATION forward (frame 0 the
    target, full-grid render), without autograd. It draws nothing random."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: FrameData) -> Dict[str, torch.Tensor]:
        if state.model is not model:
            raise ValueError("the state holds another model than this step's")
        preds = model(
            camera=batch.camera,
            image_rgb=batch.image_rgb,
            fg_probability=batch.fg_probability,
            mask_crop=batch.mask_crop,
            depth_map=batch.depth_map,
            training=False,
        )
        return {
            **scalar_metrics(preds),
            "images_render": preds["images_render"],
            "depths_render": preds["depths_render"],
            "masks_render": preds["masks_render"],
        }

    return eval_step
