"""Gaussian diffusion over a precomputed schedule (port of
holo_diffusion_tpu/models/diffusion.py): schedules, the q and p processes
with fixed and learned variances, DDPM and DDIM sampling, the diffusion
losses and bits/dim, and the timestep samplers of training (uniform, and
the loss-second-moment sampler with its state), plus the EMA update.

The schedule is computed in float64 numpy and stored as float32 tensors, as
in the reference. Random draws are injectable: `p_sample`/`ddim_sample` take
`noise`, the loops take the initial `noise` and a per-step `step_noise`
sequence, `calc_bpd_loop` a `(T, *shape)` noise tensor, and the samplers a
`Draws` (random_draws.py), so a test can feed both packages the same
numbers; otherwise they draw from an explicit `torch.Generator`. Data
layout is channels-last: learned variances are split off the LAST axis.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterator, Mapping, Optional, Sequence, Union

import numpy as np
import torch

PREVIOUS_X = "PREVIOUS_X"
START_X = "START_X"
EPSILON = "EPSILON"
SCALED_EPSILON_FOR_START_X = "SCALED_EPSILON_FOR_START_X"

LEARNED = "LEARNED"
FIXED_SMALL = "FIXED_SMALL"
FIXED_LARGE = "FIXED_LARGE"
LEARNED_RANGE = "LEARNED_RANGE"


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
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
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
    # t * 1000 / T before the model (gaussian_diffusion.py:417-419); off in
    # every HoloDiffusion config
    rescale_timesteps: bool = False

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]


def make_schedule(
    betas: np.ndarray,
    model_mean_type: str = START_X,
    model_var_type: str = FIXED_SMALL,
    rescale_timesteps: bool = False,
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
        alphas_cumprod_next=np.append(ac[1:], 0.0),
        sqrt_alphas_cumprod=np.sqrt(ac),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - ac),
        log_one_minus_alphas_cumprod=np.log(1.0 - ac),
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
        rescale_timesteps=rescale_timesteps,
    )


def _scale_timesteps(sched: DiffusionSchedule, t: torch.Tensor) -> torch.Tensor:
    """The timesteps the model sees: float t * 1000 / T when the schedule
    rescales them, else t as it is."""
    if sched.rescale_timesteps:
        return t.float() * (1000.0 / sched.num_timesteps)
    return t


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


# ---------------------------------------------------------------------------
# q (forward) process
# ---------------------------------------------------------------------------


def q_mean_variance(sched: DiffusionSchedule, x_start, t):
    """Mean, variance and log variance of q(x_t | x_0), broadcastable."""
    mean = _extract(sched.sqrt_alphas_cumprod, t, x_start.shape) * x_start
    variance = _extract(1.0 - sched.alphas_cumprod, t, x_start.shape)
    log_variance = _extract(sched.log_one_minus_alphas_cumprod, t, x_start.shape)
    return mean, variance, log_variance


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


# ---------------------------------------------------------------------------
# p (reverse) process
# ---------------------------------------------------------------------------


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
    denoised_fn: Optional[Callable] = None,
):
    """Mean/variance of p(x_{t-1} | x_t) and pred_xstart
    (gaussian_diffusion.py:253-355). With LEARNED or LEARNED_RANGE
    variances the model's output has 2C channels, split on the last axis
    into the mean output and the variance values; `denoised_fn` maps
    pred_xstart before the clip."""
    model_output = model_fn(x, _scale_timesteps(sched, t))
    shape = x.shape
    if sched.model_var_type in (LEARNED, LEARNED_RANGE):
        model_output, model_var_values = torch.split(model_output, shape[-1], dim=-1)
        if sched.model_var_type == LEARNED:
            model_log_variance = model_var_values
        else:
            min_log = _extract(sched.posterior_log_variance_clipped, t, shape)
            max_log = _extract(torch.log(sched.betas), t, shape)
            frac = (model_var_values + 1) / 2
            model_log_variance = frac * max_log + (1 - frac) * min_log
        model_variance = torch.exp(model_log_variance)
    elif sched.model_var_type == FIXED_LARGE:
        model_variance = _extract(sched.fixed_large_variance, t, shape).expand(shape)
        model_log_variance = _extract(sched.fixed_large_log_variance, t, shape).expand(shape)
    elif sched.model_var_type == FIXED_SMALL:
        model_variance = _extract(sched.posterior_variance, t, shape).expand(shape)
        model_log_variance = _extract(sched.posterior_log_variance_clipped, t, shape).expand(shape)
    else:
        raise NotImplementedError(sched.model_var_type)

    def process_xstart(x0):
        if denoised_fn is not None:
            x0 = denoised_fn(x0)
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


def condition_mean(sched: DiffusionSchedule, cond_fn, p_mean_var, x, t):
    """Sohl-Dickstein-style conditioning (gaussian_diffusion.py:420-436)."""
    return p_mean_var["mean"] + p_mean_var["variance"] * cond_fn(x, t)


def condition_score(sched: DiffusionSchedule, cond_fn, p_mean_var, x, t):
    """Song et al. score conditioning (gaussian_diffusion.py:438-457)."""
    alpha_bar = _extract(sched.alphas_cumprod, t, x.shape)
    eps = predict_eps_from_xstart(sched, x, t, p_mean_var["pred_xstart"])
    eps = eps - torch.sqrt(1 - alpha_bar) * cond_fn(x, t)
    out = dict(p_mean_var)
    out["pred_xstart"] = predict_xstart_from_eps(sched, x, t, eps)
    out["mean"], _, _ = q_posterior_mean_variance(sched, out["pred_xstart"], x, t)
    return out


def _draw_normal(shape, like: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=like.device, dtype=like.dtype)


def _step_mask(last: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """1 where the step adds noise, 0 where it lands on x_0, broadcastable."""
    return (~last).to(x.dtype).reshape(-1, *([1] * (x.ndim - 1)))


def p_sample(
    sched: DiffusionSchedule,
    model_fn: Callable,
    x: torch.Tensor,
    t: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    clip_denoised: bool = True,
    denoised_fn: Optional[Callable] = None,
    cond_fn: Optional[Callable] = None,
):
    """One DDPM ancestral step (gaussian_diffusion.py:459-508); `noise`
    overrides the draw from `generator`; `cond_fn(x, t)` shifts the mean by
    the variance times its gradient."""
    out = p_mean_variance(sched, model_fn, x, t, clip_denoised, denoised_fn)
    if noise is None:
        noise = _draw_normal(x.shape, x, generator)
    mean = out["mean"]
    if cond_fn is not None:
        mean = condition_mean(sched, cond_fn, out, x, t)
    sample = mean + _step_mask(t == 0, x) * torch.exp(0.5 * out["log_variance"]) * noise
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


def _check_step_noise(step_noise, n_steps: int) -> None:
    if step_noise is not None and len(step_noise) != n_steps:
        raise ValueError(f"step_noise has {len(step_noise)} entries for {n_steps} steps")


def p_sample_loop_progressive(
    sched: DiffusionSchedule,
    model_fn: Callable,
    shape,
    noise: Optional[torch.Tensor] = None,
    step_noise: Optional[Sequence[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    clip_denoised: bool = True,
    max_iter: Optional[int] = None,
    device=None,
    denoised_fn: Optional[Callable] = None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """DDPM ancestral sampling from x_T = `noise` (or a draw), yielding each
    step's `p_sample` output. `step_noise` gives one noise tensor per step
    of `ddpm_timesteps(T, max_iter)`."""
    device = device if device is not None else sched.betas.device
    x = _initial_noise(shape, noise, generator, device)
    ts = ddpm_timesteps(sched.num_timesteps, max_iter)
    _check_step_noise(step_noise, len(ts))
    for i, t_scalar in enumerate(ts):
        t = torch.full((shape[0],), t_scalar, dtype=torch.long, device=device)
        n = None if step_noise is None else step_noise[i].to(device)
        out = p_sample(sched, model_fn, x, t, n, generator, clip_denoised, denoised_fn)
        x = out["sample"]
        yield out


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
    denoised_fn: Optional[Callable] = None,
):
    """The final sample of `p_sample_loop_progressive`."""
    out = None
    for out in p_sample_loop_progressive(sched, model_fn, shape, noise, step_noise, generator,
                                         clip_denoised, max_iter, device, denoised_fn):
        pass
    return out["sample"]


def ddim_sample(
    sched: DiffusionSchedule,
    model_fn: Callable,
    x: torch.Tensor,
    t: torch.Tensor,
    clip_denoised: bool = True,
    t_prev: Optional[torch.Tensor] = None,
    eta: float = 0.0,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """One DDIM step t -> t_prev (-1 meaning x_0; default t - 1)
    (gaussian_diffusion.py:645-699). With `eta` > 0 the step adds
    sigma * `noise` (or a draw from `generator`), except into the final
    state: t_prev < 0, or t == 0 without t_prev. At eta 0 nothing is drawn."""
    out = p_mean_variance(sched, model_fn, x, t, clip_denoised)
    eps = predict_eps_from_xstart(sched, x, t, out["pred_xstart"])
    if t_prev is None:
        alpha_bar_prev = _extract(sched.alphas_cumprod_prev, t, x.shape)
    else:
        # concat([1], alphas_cumprod)[tp + 1]: alphas_cumprod_prev[tp + 1],
        # and 1 at tp == -1
        acp1 = torch.cat([torch.ones_like(sched.alphas_cumprod[:1]), sched.alphas_cumprod])
        alpha_bar_prev = _extract(acp1, t_prev + 1, x.shape)
    if eta == 0.0:
        sample = out["pred_xstart"] * torch.sqrt(alpha_bar_prev) + torch.sqrt(1 - alpha_bar_prev) * eps
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}
    alpha_bar = _extract(sched.alphas_cumprod, t, x.shape)
    sigma = (
        eta
        * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
        * torch.sqrt(1 - alpha_bar / alpha_bar_prev)
    )
    if noise is None:
        noise = _draw_normal(x.shape, x, generator)
    mean_pred = out["pred_xstart"] * torch.sqrt(alpha_bar_prev) + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps
    last = (t == 0) if t_prev is None else (t_prev < 0)
    sample = mean_pred + _step_mask(last, x) * sigma * noise
    return {"sample": sample, "pred_xstart": out["pred_xstart"]}


def ddim_reverse_sample(
    sched: DiffusionSchedule, model_fn: Callable, x, t, clip_denoised: bool = True
):
    """Deterministic encode x_t -> x_{t+1} (gaussian_diffusion.py:700-733)."""
    out = p_mean_variance(sched, model_fn, x, t, clip_denoised)
    eps = (
        _extract(sched.sqrt_recip_alphas_cumprod, t, x.shape) * x - out["pred_xstart"]
    ) / _extract(sched.sqrt_recipm1_alphas_cumprod, t, x.shape)
    alpha_bar_next = _extract(sched.alphas_cumprod_next, t, x.shape)
    mean_pred = out["pred_xstart"] * torch.sqrt(alpha_bar_next) + torch.sqrt(1 - alpha_bar_next) * eps
    return {"sample": mean_pred, "pred_xstart": out["pred_xstart"]}


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
    eta: float = 0.0,
    step_noise: Optional[Sequence[torch.Tensor]] = None,
):
    """DDIM sampling from x_T = `noise` (or a draw from `generator`);
    `num_steps` < T strides evenly over T-1 .. 0. With `eta` > 0 each step
    takes its noise from `step_noise` (one per step) or `generator`."""
    device = device if device is not None else sched.betas.device
    x = _initial_noise(shape, noise, generator, device)
    ts = ddim_timesteps(sched.num_timesteps, num_steps)
    tprev = np.concatenate([ts[1:], [-1]])
    _check_step_noise(step_noise, len(ts))
    for i, (t_scalar, tp_scalar) in enumerate(zip(ts.tolist(), tprev.tolist())):
        t = torch.full((shape[0],), t_scalar, dtype=torch.long, device=device)
        tp = torch.full((shape[0],), tp_scalar, dtype=torch.long, device=device)
        n = None if step_noise is None else step_noise[i].to(device)
        x = ddim_sample(sched, model_fn, x, t, clip_denoised, t_prev=tp, eta=eta, noise=n,
                        generator=generator)["sample"]
    return x


# ---------------------------------------------------------------------------
# Losses (losses.py + gaussian_diffusion.py:817-1043)
# ---------------------------------------------------------------------------

_LN2 = math.log(2.0)


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL between two diagonal gaussians (losses.py:18-45)."""
    return 0.5 * (
        -1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
        + ((mean1 - mean2) ** 2) * torch.exp(-logvar2)
    )


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, means, log_scales):
    """Log-likelihood of a discretized (255-bin) gaussian (losses.py:56-83)."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_cdf_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus, torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


def mean_flat(x):
    return torch.mean(x, dim=tuple(range(1, x.ndim)))


def huber(x, y, beta: float = 0.1):
    """Smooth L1 with `beta`."""
    diff = x - y
    abs_diff = torch.abs(diff)
    return torch.where(abs_diff < beta, 0.5 * diff ** 2 / beta, abs_diff - 0.5 * beta)


def vb_terms_bpd(sched: DiffusionSchedule, model_fn, x_start, x_t, t, clip_denoised=True):
    """The variational bound's term at t, in bits per dim
    (gaussian_diffusion.py:817-850): the decoder NLL at t == 0, else the KL."""
    true_mean, _, true_log_var = q_posterior_mean_variance(sched, x_start, x_t, t)
    out = p_mean_variance(sched, model_fn, x_t, t, clip_denoised)
    kl = mean_flat(normal_kl(true_mean, true_log_var, out["mean"], out["log_variance"])) / _LN2
    decoder_nll = -discretized_gaussian_log_likelihood(x_start, out["mean"], 0.5 * out["log_variance"])
    decoder_nll = mean_flat(decoder_nll) / _LN2
    return {"output": torch.where(t == 0, decoder_nll, kl), "pred_xstart": out["pred_xstart"]}


def training_losses(
    sched: DiffusionSchedule,
    model_fn,
    x_start,
    t,
    noise,
    loss_type: str = "MSE",
    huber_beta: float = 0.1,
):
    """Voxel-space diffusion losses at t (gaussian_diffusion.py:852-968):
    "MSE" or "HUBER" against the mean type's target, "KL" or "RESCALED_KL"
    (times T) through `vb_terms_bpd`."""
    x_t = q_sample(sched, x_start, t, noise)
    if loss_type in ("KL", "RESCALED_KL"):
        loss = vb_terms_bpd(sched, model_fn, x_start, x_t, t, clip_denoised=False)["output"]
        if loss_type == "RESCALED_KL":
            loss = loss * sched.num_timesteps
        return {"loss": loss}
    model_output = model_fn(x_t, _scale_timesteps(sched, t))
    if sched.model_mean_type == PREVIOUS_X:
        target = q_posterior_mean_variance(sched, x_start, x_t, t)[0]
    else:
        target = {START_X: x_start, EPSILON: noise, SCALED_EPSILON_FOR_START_X: x_t - x_start}[
            sched.model_mean_type]
    if loss_type == "HUBER":
        loss = mean_flat(huber(target, model_output, huber_beta))
    else:
        loss = mean_flat((target - model_output) ** 2)
    return {"loss": loss, "model_output": model_output, "x_t": x_t}


def calc_bpd_loop(
    sched: DiffusionSchedule,
    model_fn,
    x_start,
    noise: Union[torch.Tensor, torch.Generator, None] = None,
    clip_denoised: bool = True,
):
    """Total bits per dim over every timestep, t = T-1 down to 0
    (gaussian_diffusion.py:988-1043). `noise` is a (T, *x_start.shape)
    tensor (row i for the i-th step, t = T-1-i) or a generator to draw each
    step's noise from. Returns total_bpd, prior_bpd (B,) and vb, mse (B, T)."""
    B, T = x_start.shape[0], sched.num_timesteps
    total = torch.zeros((B,), dtype=x_start.dtype, device=x_start.device)
    vb, mse = [], []
    for i, t_scalar in enumerate(range(T - 1, -1, -1)):
        t = torch.full((B,), t_scalar, dtype=torch.long, device=x_start.device)
        n = noise[i].to(x_start.device) if isinstance(noise, torch.Tensor) else _draw_normal(
            x_start.shape, x_start, noise)
        x_t = q_sample(sched, x_start, t, n)
        out = vb_terms_bpd(sched, model_fn, x_start, x_t, t, clip_denoised)
        eps = predict_eps_from_xstart(sched, x_t, t, out["pred_xstart"])
        total = total + out["output"]
        vb.append(out["output"])
        mse.append(mean_flat((eps - n) ** 2))
    t_last = torch.full((B,), T - 1, dtype=torch.long, device=x_start.device)
    prior_mean, _, prior_logvar = q_mean_variance(sched, x_start, t_last)
    prior_logvar = prior_logvar.expand_as(prior_mean)
    prior_bpd = mean_flat(normal_kl(prior_mean, prior_logvar, torch.zeros_like(prior_mean),
                                    torch.zeros_like(prior_logvar))) / _LN2
    return {"total_bpd": total + prior_bpd, "prior_bpd": prior_bpd,
            "vb": torch.stack(vb, dim=1), "mse": torch.stack(mse, dim=1)}


# ---------------------------------------------------------------------------
# Timestep samplers (timestep_sampler.py) and the EMA
# ---------------------------------------------------------------------------


def uniform_sample_timesteps(sched: DiffusionSchedule, batch: int, draws, device):
    """UniformSampler (timestep_sampler.py:67-73): t ~ U{0, ..., T-1} of
    shape (batch,) from the draw `timesteps`, with unit importance weights."""
    t = draws.randint("timesteps", sched.num_timesteps, (batch,), device)
    return t, torch.ones((batch,), dtype=torch.float32, device=device)


@dataclasses.dataclass
class LossSecondMomentState:
    """State of the LossSecondMomentResampler (timestep_sampler.py:130-160):
    the last `history_per_term` losses of each timestep, a ring buffer
    (T, H) float32, and how many it holds (T,) int64. Both stay on the
    device and are updated with tensor operations only."""

    loss_history: torch.Tensor
    loss_counts: torch.Tensor

    @classmethod
    def create(cls, num_timesteps: int, history_per_term: int = 10, device=None) -> "LossSecondMomentState":
        return cls(
            loss_history=torch.zeros((num_timesteps, history_per_term), dtype=torch.float32, device=device),
            loss_counts=torch.zeros((num_timesteps,), dtype=torch.int64, device=device),
        )


def loss_aware_weights(state: LossSecondMomentState, uniform_prob: float = 0.001) -> torch.Tensor:
    """sqrt of each timestep's mean squared loss, normalised, mixed with
    `uniform_prob` of the uniform distribution; uniform until every
    timestep holds a full history (timestep_sampler.py:141-152). The
    warm-up test is a `torch.where`, so nothing is read on the host."""
    T, H = state.loss_history.shape
    warmed_up = torch.all(state.loss_counts == H)
    w = torch.sqrt(torch.mean(state.loss_history ** 2, dim=-1))
    w = w / torch.clamp(torch.sum(w), min=1e-12)
    w = w * (1 - uniform_prob) + uniform_prob / T
    return torch.where(warmed_up, w, torch.full_like(w, 1.0 / T))


def loss_aware_sample_timesteps(sched: DiffusionSchedule, state: LossSecondMomentState, batch: int, draws):
    """(batch,) timesteps drawn from `loss_aware_weights` (the draw
    `timesteps`) and their importance weights 1 / (T p[t])."""
    w = loss_aware_weights(state)
    t = draws.categorical("timesteps", w, (batch,))
    return t, 1.0 / (sched.num_timesteps * w[t])


def loss_aware_update(
    state: LossSecondMomentState,
    ts: torch.Tensor,
    losses: torch.Tensor,
    mask: Optional[Sequence[bool]] = None,
) -> LossSecondMomentState:
    """The state with each (t, loss) pair appended to t's history in order
    (the oldest entry shifted out of a full history). `mask`, one per pair,
    holds host booleans (a sequence or a CPU tensor), and a pair whose mask
    is False is skipped (the bootstrap timestep's credit, gated on the
    bootstrap coin, which the step reads on the host); a bool tensor on the
    card gates each pair's update on the card instead (the ranks' gathered
    flags, parallel/collectives.py), so nothing is read on the host. Device
    tensor operations only."""
    hist, counts = state.loss_history.clone(), state.loss_counts.clone()
    H = hist.shape[1]
    if isinstance(mask, torch.Tensor) and mask.device.type != "cpu":
        valid = list(mask.to(dtype=torch.bool).reshape(-1).unbind())
    else:
        valid = [True] * len(ts) if mask is None else [bool(m) for m in mask]
    if len(valid) != len(ts):
        raise ValueError(f"mask has {len(valid)} entries for {len(ts)} timesteps")
    for i, ok in enumerate(valid):
        if ok is False:
            continue
        t = ts[i:i + 1].to(device=hist.device, dtype=torch.long)
        loss = losses[i:i + 1].to(device=hist.device, dtype=hist.dtype)[:, None]
        cnt = counts[t]
        row = hist[t]
        shifted = torch.cat([row[:, 1:], loss], dim=1)
        appended = row.scatter(1, torch.clamp(cnt, max=H - 1)[:, None], loss)
        new_row, new_cnt = torch.where((cnt == H)[:, None], shifted, appended), torch.clamp(cnt + 1, max=H)
        if ok is not True:  # a device flag
            new_row, new_cnt = torch.where(ok, new_row, row), torch.where(ok, new_cnt, cnt)
        hist[t] = new_row
        counts[t] = new_cnt
    return LossSecondMomentState(loss_history=hist, loss_counts=counts)


@torch.no_grad()
def update_ema(ema: Dict[str, torch.Tensor], params: Mapping[str, torch.Tensor], rate: float = 0.9999):
    """ema <- ema * rate + (1 - rate) * params, in place, matched by name
    (nn.py:61-71 `update_ema`), as two `torch._foreach_*` calls over all
    tensors. Returns `ema`."""
    e = list(ema.values())
    torch._foreach_mul_(e, rate)
    torch._foreach_add_(e, [params[k].detach() for k in ema], alpha=1.0 - rate)
    return ema


def create_named_schedule_sampler(name: str, sched: DiffusionSchedule, device=None):
    """Name-based timestep-sampler factory (timestep_sampler.py:14-26):
    (sample_fn(batch, draws, state=None) -> (t, weights), initial state);
    the state is None for "uniform", a LossSecondMomentState on `device`
    for "loss-second-moment" (update it with `loss_aware_update`)."""
    if name == "uniform":
        return (lambda batch, draws, state=None: uniform_sample_timesteps(
            sched, batch, draws, sched.betas.device)), None
    if name == "loss-second-moment":
        state0 = LossSecondMomentState.create(sched.num_timesteps, device=device)
        return (lambda batch, draws, state: loss_aware_sample_timesteps(sched, state, batch, draws)), state0
    raise NotImplementedError(f"unknown schedule sampler: {name}")
