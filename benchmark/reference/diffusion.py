"""The linear-schedule Gaussian diffusion the release configs train and
sample with: q_sample, and the DDPM step of an x0-predicting model with the
posterior's (small) variance."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class Schedule:
    def __init__(self, num_steps: int, beta_start: float, beta_end: float, device):
        scale = 1000.0 / num_steps
        betas = np.linspace(scale * beta_start, scale * beta_end, num_steps, dtype=np.float64)
        ac = np.cumprod(1.0 - betas)
        ac_prev = np.append(1.0, ac[:-1])
        post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
        arrays = {
            "sqrt_ac": np.sqrt(ac), "sqrt_1m_ac": np.sqrt(1.0 - ac),
            "coef1": betas * np.sqrt(ac_prev) / (1.0 - ac),
            "coef2": (1.0 - ac_prev) * np.sqrt(1.0 - betas) / (1.0 - ac),
            "log_var": np.log(np.append(post_var[1], post_var[1:])),
        }
        for k, v in arrays.items():
            setattr(self, k, torch.as_tensor(v, dtype=torch.float32, device=device))


def q_sample(s: Schedule, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    return s.sqrt_ac[t].reshape(-1, 1, 1, 1, 1) * x0 + s.sqrt_1m_ac[t].reshape(-1, 1, 1, 1, 1) * noise


def p_sample(s: Schedule, unet, x: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One ancestral step from x (B, r, r, r, C) at t (B,): the clipped x0
    prediction and the sample x_{t-1} (no noise at t = 0)."""
    shape = (-1, 1, 1, 1, 1)
    x0 = torch.clamp(unet(x, t), -1.0, 1.0)
    mean = s.coef1[t].reshape(shape) * x0 + s.coef2[t].reshape(shape) * x
    keep = (t != 0).float().reshape(shape)
    return {"pred_xstart": x0, "sample": mean + keep * torch.exp(0.5 * s.log_var[t]).reshape(shape) * noise}
