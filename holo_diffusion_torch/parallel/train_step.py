"""The training step on one device (port of the single-device leg of
holo_diffusion_tpu/parallel/train_step.py): forward with `training=True`,
backward of the objective, optimizer step, then the loss-second-moment
sampler's update and the EMA of the parameters when they are on; K such
steps per call with `steps_per_call` K; and the EVALUATION forward of a
batch.

    state = TrainState.create(model, optimizer, sampler_state, ema=True)
    train_step = make_train_step(model, optimizer, schedule_sampler="loss-second-moment",
                                 ema_rate=0.9999, steps_per_call=2)
    state, metrics = train_step(state, batch, generator_or_draws)
    outputs = make_eval_step(model)(state, batch)

The decode's backward inside `loss.backward()` is the fused-decode backward
kernel on CUDA (ops/fused_decode.py). The sampler and the EMA are plain
tensor operations (the JAX package runs them as plain XLA): the sampler's
state never leaves the device, the EMA is two `torch._foreach_*` calls.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

from ..data.frame_data import FrameData
from ..models import diffusion as gd
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
    moments and schedule), the count of steps taken, and, when training
    runs them, the EMA of the parameters (by name; parameters only, not
    the BN statistics, as JAX's `ema_params`) and the loss-second-moment
    sampler's state."""

    model: HoloDiffusionModel
    optimizer: Optimizer
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None
    sampler_state: Optional[gd.LossSecondMomentState] = None

    @classmethod
    def create(
        cls,
        model: HoloDiffusionModel,
        optimizer: Optimizer,
        sampler_state: Optional[gd.LossSecondMomentState] = None,
        ema: bool = False,
    ) -> "TrainState":
        """A fresh state; with `ema` the average starts at the parameters."""
        avg = {n: p.detach().clone() for n, p in model.named_parameters()} if ema else None
        return cls(model, optimizer, ema=avg, sampler_state=sampler_state)

    @torch.no_grad()
    def swap_in_ema(self) -> "TrainState":
        """Copy the EMA into the model's parameters (for sampling and
        evaluation through the averaged weights); returns the state."""
        if self.ema is None:
            raise ValueError("the state carries no EMA of the parameters (train with ema_rate > 0)")
        for n, p in self.model.named_parameters():
            p.copy_(self.ema[n])
        return self


def scalar_metrics(preds: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The tracked scalar metrics of `preds`, detached (still on the device)."""
    return {k: preds[k].detach() for k in TRACKED_METRICS if k in preds}


def ts_validity_mask(take_boot) -> torch.Tensor:
    """Validity of the (main, bootstrap) sampler-credit pairs, a CPU bool
    tensor: the main timestep always entered the loss, the bootstrap one
    only when its branch was taken (holo_diffusion_model.py:401-418)."""
    return torch.tensor([True, bool(take_boot)])


def importance_scale(weights: torch.Tensor, take_boot) -> torch.Tensor:
    """The importance-sampling rescale of the objective under the
    loss-second-moment sampler (timestep_sampler.py:48-64): w[t_main], times
    w[t_boot] when the bootstrap branch was taken. `take_boot` is the
    host's coin."""
    return weights[0] * weights[1] if bool(take_boot) else weights[0]


def _per_step_draws(generator_or_draws, k: int) -> List[Draws]:
    """The draws of each of k steps: one generator (or generator-backed
    `Draws`) shared by all, or a sequence of k mappings of injected draws."""
    if k == 1:
        return [Draws.of(generator_or_draws)]
    if isinstance(generator_or_draws, (torch.Generator, Draws)):
        return [Draws.of(generator_or_draws)] * k
    if isinstance(generator_or_draws, Mapping) or len(generator_or_draws) != k:
        raise ValueError(f"{k} steps per call need a generator or {k} mappings of draws")
    return [Draws.of(d) for d in generator_or_draws]


def make_train_step(
    model: HoloDiffusionModel,
    optimizer: Optimizer,
    schedule_sampler: str = "uniform",
    ema_rate: float = 0.0,
    steps_per_call: int = 1,
) -> Callable[[TrainState, FrameData, Any], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """train_step(state, batch, generator_or_draws) -> (state, metrics).

    `generator_or_draws` is a `torch.Generator` on the batch's device, or a
    mapping of injected draws (random_draws.py). The state is updated in
    place and returned; metrics stay on the device (reading them waits for
    the step).

    schedule_sampler "loss-second-moment" (the state must hold a
    `LossSecondMomentState`): the two diffusion timesteps are the draw
    `timesteps` from `state.sampler_state`, the backpropagated objective is
    scaled by `importance_scale`, the metrics stay unweighted, and the
    unweighted objective is credited to both timesteps under
    `ts_validity_mask`. ema_rate > 0 (the state must hold an EMA): after
    each optimizer step ema <- ema * rate + (1 - rate) * params.
    steps_per_call K > 1: the batch carries a leading step axis
    (`FrameData.stack_steps`), K optimizer steps run in the call, and the
    metrics are their average; the draws are one generator or K mappings.
    """
    if schedule_sampler not in ("uniform", "loss-second-moment"):
        raise NotImplementedError(f"unknown schedule sampler: {schedule_sampler}")
    loss_aware = schedule_sampler == "loss-second-moment"
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")

    def one_step(state: TrainState, batch: FrameData, draws: Draws) -> Dict[str, torch.Tensor]:
        timesteps = weights = None
        if loss_aware:
            timesteps, weights = gd.loss_aware_sample_timesteps(model.schedule, state.sampler_state, 2, draws)
        optimizer.zero_grad()
        preds = model(
            camera=batch.camera,
            image_rgb=batch.image_rgb,
            fg_probability=batch.fg_probability,
            mask_crop=batch.mask_crop,
            depth_map=batch.depth_map,
            training=True,
            draws=draws,
            timesteps=timesteps,
        )
        objective = preds["objective"]
        take_boot = bool(preds.get("diffusion_take_boot", False))
        if loss_aware:
            objective = objective * importance_scale(weights, take_boot)
        objective.backward()
        optimizer.step()
        metrics = scalar_metrics(preds)
        if loss_aware:
            state.sampler_state = gd.loss_aware_update(
                state.sampler_state, timesteps, metrics["objective"].expand(2), ts_validity_mask(take_boot))
        if ema_rate > 0.0:
            gd.update_ema(state.ema, dict(model.named_parameters()), ema_rate)
        state.step += 1
        return metrics

    def train_step(state: TrainState, batch: FrameData, generator_or_draws) -> Tuple[TrainState, Dict]:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer than this step's")
        if loss_aware and state.sampler_state is None:
            raise ValueError("the loss-second-moment sampler needs a state with sampler_state")
        if ema_rate > 0.0 and state.ema is None:
            raise ValueError("ema_rate > 0 needs a state with an EMA (TrainState.create(..., ema=True))")
        draws = _per_step_draws(generator_or_draws, steps_per_call)
        if steps_per_call == 1:
            return state, one_step(state, batch, draws[0])
        per_step = [one_step(state, batch.step(k), draws[k]) for k in range(steps_per_call)]
        return state, {key: torch.stack([m[key] for m in per_step]).mean(0) for key in per_step[0]}

    return train_step


def make_eval_step(model: HoloDiffusionModel) -> Callable[..., Dict[str, torch.Tensor]]:
    """eval_step(state, batch, draws=None) -> the tracked scalar metrics and
    `images/depths/masks_render` of the EVALUATION forward (frame 0 the
    target), without autograd. `draws` (a generator or injected values) feed
    the evaluation sampling modes that draw: `mask_sample` (which needs
    them) and stratified points; the full-grid default draws nothing."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: FrameData, draws: Any = None) -> Dict[str, torch.Tensor]:
        if state.model is not model:
            raise ValueError("the state holds another model than this step's")
        preds = model(
            camera=batch.camera,
            image_rgb=batch.image_rgb,
            fg_probability=batch.fg_probability,
            mask_crop=batch.mask_crop,
            depth_map=batch.depth_map,
            training=False,
            draws=draws,
        )
        return {
            **scalar_metrics(preds),
            "images_render": preds["images_render"],
            "depths_render": preds["depths_render"],
            "masks_render": preds["masks_render"],
        }

    return eval_step
