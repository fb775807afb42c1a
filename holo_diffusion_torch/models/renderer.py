"""Emission-absorption raymarching + the multi-pass renderer (port of
holo_diffusion_tpu/models/renderer.py, evaluation mode).

    delta_i  = l_{i+1} - l_i           (last delta = background_opacity)
    sigma_i  = relu(raw_sigma_i)
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
):
    """densities (B, N, P, 1), features (B, N, P, C), lengths (B, N, P) ->
    (features (B, N, C), depths (B, N, 1), masks (B, N, 1), weights (B, N, P))."""
    raw = densities[..., 0]
    diffs = torch.diff(lengths, dim=-1)
    if replicate_last_interval:
        last = diffs[..., -1:]
    else:
        last = torch.full_like(lengths[..., :1], background_opacity)
    deltas = torch.cat([diffs, last], dim=-1)
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
) -> RendererOutput:
    """Coarse -> (importance refine -> fine)^(num_passes-1) with the same
    implicit function each pass; deterministic (evaluation) refinement.

    implicit_fn(points (B,N,P,3), directions (B,N,3), pass_number)
        -> (densities (B,N,P,1), features (B,N,P,C), aux dict)
    """
    lengths = ray_bundle.lengths
    output = None
    for pass_number in range(num_passes):
        if pass_number > 0:
            lengths = importance_sample_lengths(
                lengths, output.weights.detach(), n_pts_per_ray_fine,
                append_coarse=append_coarse_samples_to_fine,
            )
        bundle = ray_bundle.replace(lengths=lengths)
        densities, features, aux = implicit_fn(
            ray_bundle_to_ray_points(bundle), bundle.directions, pass_number
        )
        feat, depth, mask, weights = emission_absorption_raymarcher(
            densities, features, lengths,
            surface_thickness=surface_thickness,
            background_opacity=background_opacity,
            replicate_last_interval=replicate_last_interval,
            density_relu=density_relu,
        )
        normals = None
        if "normals" in aux:
            normals = torch.einsum("bnp,bnpc->bnc", weights, aux.pop("normals"))
        output = RendererOutput(
            features=feat, depths=depth, masks=mask, normals=normals,
            weights=weights, prev_stage=output, aux=aux,
        )
    return output
