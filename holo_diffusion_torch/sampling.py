"""Unconditional voxel-grid sampling through the denoiser (port of
holo_diffusion_tpu/sampling.py; reference holo_diffusion_model.py:173-199):
the whole chain, or a generator over its clipped intermediate states."""
from __future__ import annotations

from typing import Iterator, Optional, Sequence

import torch

from .device import DeviceLike, place
from .models import diffusion as gd
from .models.holo_model import HoloDiffusionModel


def _check_diffusion(model: HoloDiffusionModel) -> None:
    if not (model.net_3d_enabled and model.diffusion_enabled):
        raise ValueError("sampling needs a model with net_3d and diffusion enabled")


@torch.no_grad()
def sample_random_voxel_features(
    model: HoloDiffusionModel,
    generator: Optional[torch.Generator] = None,
    max_iter: Optional[int] = None,
    use_ddim: bool = False,
    n_samples: int = 1,
    noise: Optional[torch.Tensor] = None,
    step_noise: Optional[Sequence[torch.Tensor]] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Ancestral DDPM (or DDIM) sampling -> (n_samples, r, r, r, C) in [-1, 1].

    `max_iter` is the number of UNet evaluations in both modes: DDPM
    truncates the schedule tail (reference `max_iter`), DDIM strides over
    the whole trajectory. `noise` (x_T) and `step_noise` (one tensor per DDPM
    step) replace the draws from `generator`, which must live on `device`.
    The model moves to `device` (CUDA unless the caller passes "cpu").
    """
    _check_diffusion(model)
    dev = place(model, device)
    shape = (n_samples, model.resol, model.resol, model.resol, model.feature_size)
    sched = model.schedule
    if use_ddim:
        if step_noise is not None:
            raise ValueError("DDIM at eta=0 draws no per-step noise")
        x = gd.ddim_sample_loop(
            sched, model.apply_net_3d, shape, noise=noise, generator=generator,
            num_steps=max_iter, device=dev,
        )
    else:
        x = gd.p_sample_loop(
            sched, model.apply_net_3d, shape, noise=noise, step_noise=step_noise,
            generator=generator, max_iter=max_iter, device=dev,
        )
    return torch.clamp(x, -1.0, 1.0)


@torch.no_grad()
def sample_random_voxel_features_progressive(
    model: HoloDiffusionModel,
    generator: Optional[torch.Generator] = None,
    max_iter: Optional[int] = None,
    noise: Optional[torch.Tensor] = None,
    step_noise: Optional[Sequence[torch.Tensor]] = None,
    device: DeviceLike = None,
) -> Iterator[torch.Tensor]:
    """Generator over the DDPM chain's states after each step, each clipped
    to [-1, 1], (1, r, r, r, C): the progressive-denoise fly-around
    (flyaround.py:224-245). `max_iter` truncates the schedule as
    `sample_random_voxel_features` does; `noise` (x_T) and `step_noise` (one
    tensor per step) replace the draws from `generator`."""
    _check_diffusion(model)
    dev = place(model, device)
    shape = (1, model.resol, model.resol, model.resol, model.feature_size)
    for out in gd.p_sample_loop_progressive(
        model.schedule, model.apply_net_3d, shape, noise=noise, step_noise=step_noise,
        generator=generator, max_iter=max_iter, device=dev,
    ):
        yield torch.clamp(out["sample"], -1.0, 1.0)
