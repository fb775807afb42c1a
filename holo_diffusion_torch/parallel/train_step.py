"""The training step (port of holo_diffusion_tpu/parallel/train_step.py):
forward with `training=True`, backward of the objective, optimizer step,
then the loss-second-moment sampler's update and the EMA of the parameters
when they are on; K such steps per call with `steps_per_call` K; and the
EVALUATION forward of a batch.

With a mesh (parallel/mesh.py: one process a GPU, each on its own scene)
the ranks average their gradients after `backward` with one flat
`all_reduce` (parallel/collectives.py), gather the sampler's (t, loss)
pairs and average the metrics with one more; every rank then applies the
same update, so the state stays bitwise equal across ranks. JAX takes the
mean of the objective before the gradient (train_step.py:280-284); the sum
of the gradients divided by the world size is the same in exact arithmetic
and differs only in float order. Each rank's coin for the bootstrap pass is
its own, so ranks may run different graphs: the explicit reduction after
`backward` does not mind, where DistributedDataParallel's hooks would.
With a packer (data/packing.py) the batch arrives as one uint8 buffer and
is unpacked into views first; that is single-device only, as in JAX.

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
from ..utils.profiling import span
from .collectives import gathered_loss_aware_update, mean_over_ranks

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
    mesh=None,
    packer=None,
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
    mesh (parallel/mesh.py:make_mesh): data parallel across its ranks, each
    passing its own batch and draws; the collectives run every step, also
    within a call of K steps. packer (data/packing.py:BatchPacker): the
    batch is the packed buffer on the device.
    """
    if packer is not None and mesh is not None:
        raise ValueError("packed transfer is single-device: under a mesh each rank copies its own batch")
    if schedule_sampler not in ("uniform", "loss-second-moment"):
        raise NotImplementedError(f"unknown schedule sampler: {schedule_sampler}")
    loss_aware = schedule_sampler == "loss-second-moment"
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")

    def one_step(state: TrainState, batch: FrameData, draws: Draws) -> Dict[str, torch.Tensor]:
        with span("holo.step"):
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
                src_image_rgb=batch.src_image_rgb,
                src_fg_probability=batch.src_fg_probability,
                src_mask_crop=batch.src_mask_crop,
            )
            objective = preds["objective"]
            take_boot = bool(preds.get("diffusion_take_boot", False))
            if loss_aware:
                objective = objective * importance_scale(weights, take_boot)
            with span("holo.backward"):
                objective.backward()
            if mesh is not None:
                # a parameter without a gradient on this rank enters as zeros,
                # so every rank reduces the same buffer
                params = optimizer.params()
                grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
                for p, g in zip(params, mean_over_ranks(grads, mesh.group)):
                    p.grad = g
            optimizer.step()
            metrics = scalar_metrics(preds)
            if loss_aware:
                if mesh is None:
                    state.sampler_state = gd.loss_aware_update(
                        state.sampler_state, timesteps, metrics["objective"].expand(2), ts_validity_mask(take_boot))
                else:
                    state.sampler_state = gathered_loss_aware_update(
                        state.sampler_state, timesteps, metrics["objective"], ts_validity_mask(take_boot), mesh.group)
            if mesh is not None:
                metrics = dict(zip(metrics, mean_over_ranks(list(metrics.values()), mesh.group)))
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
        if packer is not None:
            batch = packer.unpack(batch)
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
            src_image_rgb=batch.src_image_rgb,
            src_fg_probability=batch.src_fg_probability,
            src_mask_crop=batch.src_mask_crop,
        )
        return {
            **scalar_metrics(preds),
            "images_render": preds["images_render"],
            "depths_render": preds["depths_render"],
            "masks_render": preds["masks_render"],
        }

    return eval_step
