"""Gaussian diffusion over a precomputed schedule (port of
holo_diffusion_tpu/models/diffusion.py: schedules, q_sample, p_mean_variance,
DDPM and DDIM sampling).

The schedule is computed in float64 numpy and stored as float32 tensors, as
in the reference. Random draws are injectable: `p_sample` takes `noise`, the
loops take the initial `noise` and a per-step `step_noise` sequence, so a
test can feed both packages the same numbers; otherwise they draw from an
explicit `torch.Generator`. Data layout is channels-last.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

PREVIOUS_X = "PREVIOUS_X"
START_X = "START_X"
EPSILON = "EPSILON"
SCALED_EPSILON_FOR_START_X = "SCALED_EPSILON_FOR_START_X"

FIXED_SMALL = "FIXED_SMALL"
FIXED_LARGE = "FIXED_LARGE"


def get_named_beta_schedule(
    schedule_name: str,
    num_diffusion_timesteps: int,
    beta_start_unscaled: float = 1e-4,
    beta_end_unscaled: float = 0.02,
) -> np.ndarray:
    """Named beta schedule in float64 (gaussian_diffusion.py:25-71)."""
    if schedule_name == "linear":
        scale = 1000.0 / num_diffusion_timesteps
        return np.linspace(
            scale * beta_start_unscaled, scale * beta_end_unscaled,
            num_diffusion_timesteps, dtype=np.float64,
        )
    if schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def betas_for_alpha_bar(num_diffusion_timesteps, alpha_bar, max_beta=0.999):
    ts = np.arange(num_diffusion_timesteps, dtype=np.float64)
    ab1 = np.array([alpha_bar(t) for t in ts / num_diffusion_timesteps])
    ab2 = np.array([alpha_bar(t) for t in (ts + 1) / num_diffusion_timesteps])
    return np.minimum(1 - ab2 / ab1, max_beta)


@dataclasses.dataclass
class DiffusionSchedule:
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    fixed_large_variance: torch.Tensor
    fixed_large_log_variance: torch.Tensor
    model_mean_type: str = START_X
    model_var_type: str = FIXED_SMALL

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]


def make_schedule(
    betas: np.ndarray,
    model_mean_type: str = START_X,
    model_var_type: str = FIXED_SMALL,
    device=None,
) -> DiffusionSchedule:
    """All schedule arrays, computed in float64 (gaussian_diffusion.py:150-187)."""
    betas = np.asarray(betas, dtype=np.float64)
    if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
        raise ValueError("betas must be a 1-D array in (0, 1]")
    alphas = 1.0 - betas
    ac = np.cumprod(alphas, axis=0)
    ac_prev = np.append(1.0, ac[:-1])
    post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
    fixed_large = np.append(post_var[1], betas[1:])
    arrays = dict(
        betas=betas,
        alphas_cumprod=ac,
        alphas_cumprod_prev=ac_prev,
        sqrt_alphas_cumprod=np.sqrt(ac),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - ac),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / ac),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / ac - 1),
        posterior_variance=post_var,
        posterior_log_variance_clipped=np.log(np.append(post_var[1], post_var[1:])),
        posterior_mean_coef1=betas * np.sqrt(ac_prev) / (1.0 - ac),
        posterior_mean_coef2=(1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac),
        fixed_large_variance=fixed_large,
        fixed_large_log_variance=np.log(fixed_large),
    )
    return DiffusionSchedule(
        **{k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in arrays.items()},
        model_mean_type=model_mean_type,
        model_var_type=model_var_type,
    )


def make_named_schedule(
    schedule_name: str = "linear",
    num_steps: int = 1000,
    beta_start_unscaled: float = 1e-4,
    beta_end_unscaled: float = 0.02,
    model_mean_type: str = START_X,
    model_var_type: str = FIXED_SMALL,
    device=None,
) -> DiffusionSchedule:
    return make_schedule(
        get_named_beta_schedule(schedule_name, num_steps, beta_start_unscaled, beta_end_unscaled),
        model_mean_type=model_mean_type,
        model_var_type=model_var_type,
        device=device,
    )


_SCHEDULE_CONFIG_KEYS = (
    "schedule_name", "num_steps", "beta_start_unscaled", "beta_end_unscaled",
    "model_mean_type", "model_var_type",
)


def make_named_schedule_from_config(diffusion_args, device=None) -> DiffusionSchedule:
    """Schedule from the model's `diffusion_args`, ignoring other keys."""
    return make_named_schedule(
        **{k: v for k, v in (diffusion_args or {}).items() if k in _SCHEDULE_CONFIG_KEYS},
        device=device,
    )


def _extract(arr: torch.Tensor, t: torch.Tensor, shape) -> torch.Tensor:
    """arr[t] reshaped to broadcast against `shape` (B, ...)."""
    return arr[t].reshape(t.shape[0], *([1] * (len(shape) - 1)))


def q_sample(sched: DiffusionSchedule, x_start, t, noise):
    """Sample q(x_t | x_0) with the given noise."""
    return (
        _extract(sched.sqrt_alphas_cumprod, t, x_start.shape) * x_start
        + _extract(sched.sqrt_one_minus_alphas_cumprod, t, x_start.shape) * noise
    )


def q_posterior_mean_variance(sched: DiffusionSchedule, x_start, x_t, t):
    mean = (
        _extract(sched.posterior_mean_coef1, t, x_t.shape) * x_start
        + _extract(sched.posterior_mean_coef2, t, x_t.shape) * x_t
    )
    variance = _extract(sched.posterior_variance, t, x_t.shape).expand(x_t.shape)
    log_variance = _extract(sched.posterior_log_variance_clipped, t, x_t.shape).expand(x_t.shape)
    return mean, variance, log_variance


def predict_xstart_from_eps(sched: DiffusionSchedule, x_t, t, eps):
    return (
        _extract(sched.sqrt_recip_alphas_cumprod, t, x_t.shape) * x_t
        - _extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.shape) * eps
    )


def predict_xstart_from_xprev(sched: DiffusionSchedule, x_t, t, xprev):
    return (
        _extract(1.0 / sched.posterior_mean_coef1, t, x_t.shape) * xprev
        - _extract(sched.posterior_mean_coef2 / sched.posterior_mean_coef1, t, x_t.shape) * x_t
    )


def predict_eps_from_xstart(sched: DiffusionSchedule, x_t, t, pred_xstart):
    return (
        _extract(sched.sqrt_recip_alphas_cumprod, t, x_t.shape) * x_t - pred_xstart
    ) / _extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.shape)


def p_mean_variance(
    sched: DiffusionSchedule,
    model_fn: Callable,
    x: torch.Tensor,
    t: torch.Tensor,
    clip_denoised: bool = True,
):
    """Mean/variance of p(x_{t-1} | x_t) and pred_xstart
    (gaussian_diffusion.py:253-355). The denoiser's output has the input's
    channels, so the variance is one of the fixed ones."""
    model_output = model_fn(x, t)
    shape = x.shape
    if sched.model_var_type == FIXED_LARGE:
        model_variance = _extract(sched.fixed_large_variance, t, shape).expand(shape)
        model_log_variance = _extract(sched.fixed_large_log_variance, t, shape).expand(shape)
    elif sched.model_var_type == FIXED_SMALL:
        model_variance = _extract(sched.posterior_variance, t, shape).expand(shape)
        model_log_variance = _extract(sched.posterior_log_variance_clipped, t, shape).expand(shape)
    else:
        raise NotImplementedError(sched.model_var_type)

    def process_xstart(x0):
        return torch.clamp(x0, -1.0, 1.0) if clip_denoised else x0

    if sched.model_mean_type == PREVIOUS_X:
        pred_xstart = process_xstart(predict_xstart_from_xprev(sched, x, t, model_output))
        model_mean = model_output
    else:
        if sched.model_mean_type == START_X:
            pred_xstart = process_xstart(model_output)
        elif sched.model_mean_type == SCALED_EPSILON_FOR_START_X:
            pred_xstart = process_xstart(x - model_output)
        elif sched.model_mean_type == EPSILON:
            pred_xstart = process_xstart(predict_xstart_from_eps(sched, x, t, model_output))
        else:
            raise NotImplementedError(sched.model_mean_type)
        model_mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x, t)
    return {
        "mean": model_mean,
        "variance": model_variance,
        "log_variance": model_log_variance,
        "pred_xstart": pred_xstart,
    }


def p_sample(
    sched: DiffusionSchedule,
    model_fn: Callable,
    x: torch.Tensor,
    t: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    clip_denoised: bool = True,
):
    """One DDPM ancestral step (gaussian_diffusion.py:459-508); `noise`
    overrides the draw from `generator`."""
    out = p_mean_variance(sched, model_fn, x, t, clip_denoised)
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    nonzero_mask = (t != 0).to(x.dtype).reshape(-1, *([1] * (x.ndim - 1)))
    sample = out["mean"] + nonzero_mask * torch.exp(0.5 * out["log_variance"]) * noise
    return {"sample": sample, "pred_xstart": out["pred_xstart"], "noise": noise}


def ddpm_timesteps(num_timesteps: int, max_iter: Optional[int] = None) -> list:
    """DDPM step sequence; `max_iter` < T runs the first max_iter - 1 steps of
    the schedule tail, then jumps to t=0 (reference p_sample_loop_progressive)."""
    T = num_timesteps
    if max_iter is None or max_iter >= T:
        return list(range(T - 1, -1, -1))
    return list(range(T - 1, T - max_iter, -1)) + [0]


def _initial_noise(shape, noise, generator, device):
    if noise is not None:
        return noise.to(device)
    return torch.randn(shape, generator=generator, device=device)


def p_sample_loop(
    sched: DiffusionSchedule,
    model_fn: Callable,
    shape,
    noise: Optional[torch.Tensor] = None,
    step_noise: Optional[Sequence[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    clip_denoised: bool = True,
    max_iter: Optional[int] = None,
    device=None,
):
    """DDPM ancestral sampling from x_T = `noise` (or a draw). `step_noise`
    gives one noise tensor per step of `ddpm_timesteps(T, max_iter)`."""
    device = device if device is not None else sched.betas.device
    x = _initial_noise(shape, noise, generator, device)
    ts = ddpm_timesteps(sched.num_timesteps, max_iter)
    if step_noise is not None and len(step_noise) != len(ts):
        raise ValueError(f"step_noise has {len(step_noise)} entries for {len(ts)} steps")
    for i, t_scalar in enumerate(ts):
        t = torch.full((shape[0],), t_scalar, dtype=torch.long, device=device)
        n = None if step_noise is None else step_noise[i].to(device)
        x = p_sample(sched, model_fn, x, t, n, generator, clip_denoised)["sample"]
    return x


def ddim_sample(
    sched: DiffusionSchedule,
    model_fn: Callable,
    x: torch.Tensor,
    t: torch.Tensor,
    clip_denoised: bool = True,
    t_prev: Optional[torch.Tensor] = None,
):
    """One deterministic (eta = 0) DDIM step t -> t_prev (-1 meaning x_0;
    default t - 1) (gaussian_diffusion.py:645-699)."""
    out = p_mean_variance(sched, model_fn, x, t, clip_denoised)
    eps = predict_eps_from_xstart(sched, x, t, out["pred_xstart"])
    if t_prev is None:
        alpha_bar_prev = _extract(sched.alphas_cumprod_prev, t, x.shape)
    else:
        acp1 = torch.cat([torch.ones_like(sched.alphas_cumprod[:1]), sched.alphas_cumprod])
        alpha_bar_prev = _extract(acp1, t_prev + 1, x.shape)
    sample = (
        out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
        + torch.sqrt(1 - alpha_bar_prev) * eps
    )
    return {"sample": sample, "pred_xstart": out["pred_xstart"]}


def ddim_timesteps(num_timesteps: int, num_steps: Optional[int] = None) -> np.ndarray:
    """Descending DDIM subsequence covering T-1 .. 0 (all steps when
    num_steps is None or >= T)."""
    T = num_timesteps
    if num_steps is None or num_steps >= T:
        return np.arange(T - 1, -1, -1)
    return np.unique(np.round(np.linspace(T - 1, 0, max(num_steps, 2))).astype(np.int64))[::-1]


def ddim_sample_loop(
    sched: DiffusionSchedule,
    model_fn: Callable,
    shape,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    clip_denoised: bool = True,
    num_steps: Optional[int] = None,
    device=None,
):
    """Deterministic (eta = 0) DDIM sampling from x_T = `noise` (or a draw
    from `generator`); `num_steps` < T strides evenly over T-1 .. 0."""
    device = device if device is not None else sched.betas.device
    x = _initial_noise(shape, noise, generator, device)
    ts = ddim_timesteps(sched.num_timesteps, num_steps)
    tprev = np.concatenate([ts[1:], [-1]])
    for t_scalar, tp_scalar in zip(ts.tolist(), tprev.tolist()):
        t = torch.full((shape[0],), t_scalar, dtype=torch.long, device=device)
        tp = torch.full((shape[0],), tp_scalar, dtype=torch.long, device=device)
        x = ddim_sample(sched, model_fn, x, t, clip_denoised, t_prev=tp)["sample"]
    return x
