"""Optimizer and LR policy (port of holo_diffusion_tpu/train/optimizer.py;
reference ImplicitronOptimizerFactory): Adam, SGD or Adagrad from
`torch.optim`, MultiStepLR / Exponential / LinearExponential learning rates
per step, optional clipping by global gradient norm, per-group learning
rates by parameter-name substring; a second optimizer for the parameters
of a discriminator (`with_discriminator_optimizer`).
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

Schedule = Callable[[int], float]


def make_lr_schedule(
    lr: float,
    lr_policy: str = "MultiStepLR",
    gamma: float = 0.1,
    multistep_lr_milestones: Sequence[int] = (),
    exponential_lr_step_size: int = 250,
    linear_exponential_lr_milestone: int = 200,
    linear_exponential_start_gamma: float = 0.1,
    max_epochs: int = 1000,
    steps_per_epoch: int = 1,
) -> Schedule:
    """step -> learning rate, the reference's per-epoch policies with
    `steps_per_epoch` optimizer steps in an epoch."""
    if lr_policy == "MultiStepLR":
        bounds = sorted(int(m) * steps_per_epoch for m in multistep_lr_milestones)
        return lambda step: lr * gamma ** sum(step >= b for b in bounds)
    if lr_policy == "Exponential":
        return lambda step: lr * gamma ** ((step / steps_per_epoch) / exponential_lr_step_size)
    if lr_policy == "LinearExponential":
        m, g0 = linear_exponential_lr_milestone, linear_exponential_start_gamma

        def sched(step):
            epoch = step / steps_per_epoch
            if epoch < m:
                return lr * min(g0 + (1 - g0) * (epoch / m), 1.0)
            return lr * gamma ** ((epoch - m) / (max_epochs - m))

        return sched
    raise ValueError(f"unknown lr_policy {lr_policy}")


class Optimizer:
    """A `torch.optim` optimizer with the LR schedule and gradient clipping
    of the JAX package's optax chain. `step()` clips, updates, and advances
    the schedule by one step."""

    def __init__(self, optimizer: torch.optim.Optimizer, lr: float, schedule: Optional[Schedule],
                 clip_grad: float):
        self.optimizer = optimizer
        self.schedule = schedule
        self.clip_grad = clip_grad
        self.base_lrs = [g["lr"] for g in optimizer.param_groups]
        self.lr0 = lr
        self.steps = 0
        self._set_lr()

    def params(self):
        """The parameters it updates, group by group."""
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def _set_lr(self):
        if self.schedule is None:
            return
        # each group keeps its ratio to the base learning rate
        scale = self.schedule(self.steps) / self.lr0
        for g, base in zip(self.optimizer.param_groups, self.base_lrs):
            g["lr"] = base * scale

    def load_state_dict(self, state_dict: dict, steps: int):
        """Restore the torch optimizer's state and the schedule's position."""
        self.optimizer.load_state_dict(state_dict)
        self.steps = steps
        self._set_lr()

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    def step(self):
        if self.clip_grad and self.clip_grad > 0:
            torch.nn.utils.clip_grad_norm_(self.params(), self.clip_grad)
        self.optimizer.step()
        self.steps += 1
        self._set_lr()


def make_optimizer(
    named_params: Iterable[Tuple[str, torch.nn.Parameter]],
    breed: str = "Adam",
    lr: float = 5e-5,
    betas=(0.9, 0.999),
    momentum: float = 0.9,
    weight_decay: float = 0.0,
    clip_grad: float = 0.0,
    schedule: Optional[Schedule] = None,
    group_learning_rates: Optional[Dict[str, float]] = None,
) -> Optimizer:
    """The optimizer over `named_params` (`model.named_parameters()`).
    Weight decay applies to Adam only (added to the gradient, as optax's
    `add_decayed_weights` before `adam`); Adagrad starts its accumulator at
    0.1 as optax's does. `group_learning_rates` {name substring: lr} puts a
    parameter in the group of the first substring its name contains."""
    groups: Dict[str, list] = {"": []}
    for name, p in named_params:
        if not p.requires_grad:
            continue
        key = next((k for k in (group_learning_rates or {}) if k in name), "")
        groups.setdefault(key, []).append(p)
    param_groups = [{"params": ps, "lr": lr if k == "" else group_learning_rates[k]}
                    for k, ps in groups.items() if ps]
    if breed == "Adam":
        opt = torch.optim.Adam(param_groups, lr=lr, betas=tuple(betas), eps=1e-8, weight_decay=weight_decay)
    elif breed == "SGD":
        opt = torch.optim.SGD(param_groups, lr=lr, momentum=momentum)
    elif breed == "Adagrad":
        opt = torch.optim.Adagrad(param_groups, lr=lr, initial_accumulator_value=0.1, eps=1e-7)
    else:
        raise ValueError(f"unknown optimizer breed {breed}")
    return Optimizer(opt, lr, schedule, clip_grad)


NamedParams = Iterable[Tuple[str, torch.nn.Parameter]]


class _TorchPair:
    """Two torch optimizers seen as one by the checkpoint and the mesh: their
    param_groups and state side by side, one state_dict holding both."""

    def __init__(self, main: torch.optim.Optimizer, disc: torch.optim.Optimizer):
        self.parts = (main, disc)

    @property
    def param_groups(self) -> List[dict]:
        return self.parts[0].param_groups + self.parts[1].param_groups

    @property
    def state(self) -> dict:
        return {**self.parts[0].state, **self.parts[1].state}

    def state_dict(self) -> dict:
        # empty top-level "state": each part's torch state_dict sits in "parts"
        return {"state": {}, "param_groups": [], "parts": [p.state_dict() for p in self.parts]}

    def load_state_dict(self, state_dict: dict) -> None:
        for opt, sd in zip(self.parts, state_dict["parts"]):
            for s in sd["state"].values():  # a non-capturable optimizer keeps its steps on the host
                if "step" in s:
                    s["step"] = s["step"].cpu()
            opt.load_state_dict(sd)


class DiscriminatorSplitOptimizer:
    """Two `Optimizer`s over disjoint parameters, each with its own schedule
    and clipping, stepped together: the `Optimizer` interface, with one
    state_dict (`optimizer`) for the checkpoint."""

    def __init__(self, main: Optimizer, disc: Optimizer):
        self.main, self.disc = main, disc
        self.optimizer = _TorchPair(main.optimizer, disc.optimizer)

    @property
    def steps(self) -> int:
        return self.main.steps

    @steps.setter
    def steps(self, value: int) -> None:
        self.main.steps = self.disc.steps = value

    def params(self):
        return self.main.params() + self.disc.params()

    def _set_lr(self):
        self.main._set_lr()
        self.disc._set_lr()

    def load_state_dict(self, state_dict: dict, steps: int):
        self.optimizer.load_state_dict(state_dict)
        self.steps = steps
        self._set_lr()

    def zero_grad(self):
        self.main.zero_grad()
        self.disc.zero_grad()

    def step(self):
        self.main.step()
        self.disc.step()


def with_discriminator_optimizer(
    main: Callable[[NamedParams], Optimizer],
    disc: Callable[[NamedParams], Optimizer],
    path_substring: str = "discriminator",
) -> Callable[[NamedParams], DiscriminatorSplitOptimizer]:
    """The reference's separate discriminator optimizer (training_loop.py:
    563-569; JAX optimizer.py:119-147): a factory of the optimizer over
    `named_params` in which the parameters whose name contains
    `path_substring` step under `disc` and the rest under `main`. `main` and
    `disc` build an `Optimizer` from named parameters, as
    `functools.partial(make_optimizer, breed=..., lr=...)` does. Both states
    go into the checkpoint's optimizer state. No release config has a
    discriminator."""

    def make(named_params: NamedParams) -> DiscriminatorSplitOptimizer:
        named = list(named_params)
        return DiscriminatorSplitOptimizer(main([(n, p) for n, p in named if path_substring not in n]),
                                           disc([(n, p) for n, p in named if path_substring in n]))

    return make
