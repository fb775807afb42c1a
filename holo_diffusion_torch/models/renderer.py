"""Emission-absorption raymarching + the multi-pass renderer (port of
holo_diffusion_tpu/models/renderer.py): evaluation, and training with
density noise and stratified importance refinement.

    delta_i  = l_{i+1} - l_i           (last delta = background_opacity)
    sigma_i  = relu(raw_sigma_i [+ std * noise_i in training])
    cap_i    = 1 - exp(-sigma_i * delta_i)
    T_i      = exp(-sum_{j<i} sigma_j * delta_j)   [surface_thickness shift]
    w_i      = cap_i * T_i
    feature  = sum_i w_i f_i ; depth = sum_i w_i l_i ; mask = cap(sum sigma*delta)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from ..geometry.rays import RayBundle, importance_sample_lengths, ray_bundle_to_ray_points
from ..random_draws import Draws
from ..utils.profiling import span


@dataclasses.dataclass
class RendererOutput:
    features: torch.Tensor  # (B, N, C)
    depths: torch.Tensor  # (B, N, 1)
    masks: torch.Tensor  # (B, N, 1)
    normals: Optional[torch.Tensor] = None  # (B, N, 3)
    weights: Optional[torch.Tensor] = None  # (B, N, P)
    prev_stage: Optional["RendererOutput"] = None
    aux: Dict[str, Any] = dataclasses.field(default_factory=dict)


def emission_absorption_raymarcher(
    densities: torch.Tensor,
    features: torch.Tensor,
    lengths: torch.Tensor,
    surface_thickness: int = 1,
    background_opacity: float = 1e10,
    replicate_last_interval: bool = False,
    density_relu: bool = True,
    density_noise: Optional[torch.Tensor] = None,
):
    """densities (B, N, P, 1), features (B, N, P, C), lengths (B, N, P) ->
    (features (B, N, C), depths (B, N, 1), masks (B, N, 1), weights (B, N, P)).
    `density_noise` (B, N, P), already scaled, is added to the raw densities
    before the ReLU."""
    raw = densities[..., 0]
    diffs = torch.diff(lengths, dim=-1)
    if replicate_last_interval:
        last = diffs[..., -1:]
    else:
        last = torch.full_like(lengths[..., :1], background_opacity)
    deltas = torch.cat([diffs, last], dim=-1)
    if density_noise is not None:
        raw = raw + density_noise
    if density_relu:
        raw = torch.relu(raw)
    weighted = deltas * raw
    capped = 1.0 - torch.exp(-weighted)
    cumsum = torch.cumsum(weighted, dim=-1)
    opacity = 1.0 - torch.exp(-cumsum[..., -1:])
    trans = torch.exp(-cumsum)
    shifted = torch.cat(
        [torch.ones_like(trans[..., :surface_thickness]), trans[..., :-surface_thickness]],
        dim=-1,
    )
    weights = capped * shifted
    feat_out = torch.einsum("bnp,bnpc->bnc", weights, features)
    depth_out = torch.sum(weights * lengths, dim=-1, keepdim=True)
    return feat_out, depth_out, opacity, weights


def multipass_ea_render(
    implicit_fn: Callable,
    ray_bundle: RayBundle,
    n_pts_per_ray_fine: int,
    append_coarse_samples_to_fine: bool = True,
    surface_thickness: int = 1,
    background_opacity: float = 1e10,
    replicate_last_interval: bool = False,
    density_relu: bool = True,
    num_passes: int = 2,
    training: bool = False,
    density_noise_std_train: float = 1.0,
    stratified_sampling_coarse: Optional[bool] = None,
    draws: Optional[Draws] = None,
) -> RendererOutput:
    """Coarse -> (importance refine -> fine)^(num_passes-1) with the same
    implicit function each pass. Given `draws` (always in training), a
    stratified render refines with the uniforms `refine_u_{pass}`, else the
    refinement is deterministic; training (`draws` required) also adds
    `density_noise_std_train` x `density_noise_{pass}` to the densities, as
    the JAX package draws them (refine, then noise, per pass). The
    refinement sees detached weights.

    implicit_fn(points (B,N,P,3), directions (B,N,3), pass_number)
        -> (densities (B,N,P,1), features (B,N,P,C), aux dict)
    """
    if stratified_sampling_coarse is None:
        stratified_sampling_coarse = training
    noise_std = density_noise_std_train if training else 0.0
    lengths = ray_bundle.lengths
    B, N = lengths.shape[:2]
    output = None
    for pass_number in range(num_passes):
        with span("holo.render.coarse" if pass_number == 0 else "holo.render.fine"):
            if pass_number > 0:
                u = None
                if draws is not None and stratified_sampling_coarse:
                    u = draws.uniform(f"refine_u_{pass_number}", (B, N, n_pts_per_ray_fine), lengths.device)
                lengths = importance_sample_lengths(
                    lengths, output.weights.detach(), n_pts_per_ray_fine, u,
                    append_coarse=append_coarse_samples_to_fine,
                )
            bundle = ray_bundle.replace(lengths=lengths)
            densities, features, aux = implicit_fn(
                ray_bundle_to_ray_points(bundle), bundle.directions, pass_number
            )
            noise = None
            if noise_std > 0:
                noise = noise_std * draws.normal(f"density_noise_{pass_number}", lengths.shape, lengths.device)
            feat, depth, mask, weights = emission_absorption_raymarcher(
                densities, features, lengths,
                surface_thickness=surface_thickness,
                background_opacity=background_opacity,
                replicate_last_interval=replicate_last_interval,
                density_relu=density_relu,
                density_noise=noise,
            )
            normals = None
            if "normals" in aux:
                normals = torch.einsum("bnp,bnpc->bnc", weights, aux.pop("normals"))
            output = RendererOutput(
                features=feat, depths=depth, masks=mask, normals=normals,
                weights=weights, prev_stage=output, aux=aux,
            )
    return output
