"""Occupancy-grid empty-space skipping for evaluation renders (port of
holo_diffusion_tpu/ops/occupancy.py).

At evaluation the density field is deterministic, so most of a ray's
bounding-sphere interval can be seen to be empty before it is rendered:

  1. decode the raw densities once per voxel grid at a probe lattice
     (`render_eval.compute_occupancy`, one implicit-function call);
  2. threshold and dilate them into an occupancy mask
     (`occupancy_from_density`);
  3. probe the mask along each ray's [near, far] (nearest-cell lookups, no
     decode) and tighten the interval to the first..last occupied probe
     plus one step (`tighten_ray_bundle`); a ray that meets nothing keeps
     its interval;
  4. place the same number of points inside the tightened interval.

Per-ray bounds only, no per-ray point counts: the raymarcher is unchanged.
Plain PyTorch (the JAX module has no Pallas kernel).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..geometry.rays import RayBundle


def occupancy_from_density(raw_density: torch.Tensor, threshold: float = 0.0, dilate: int = 1) -> torch.Tensor:
    """(r, r, r) raw (pre-ReLU) densities -> (r, r, r) bool occupancy.

    `threshold` is in raw-density units (the raymarcher takes relu(raw), so
    0.0 keeps every cell that can contribute); `dilate` grows the mask by
    that many cells (a 3^3 max pool each, padded with -inf as XLA's
    reduce_window "SAME" pads), covering trilinear tails and the probes'
    rounding to cells."""
    occ = (raw_density > threshold).to(torch.float32)
    for _ in range(max(dilate, 0)):
        occ = F.max_pool3d(occ[None, None], kernel_size=3, stride=1, padding=1)[0, 0]
    return occ > 0.0


def tighten_ray_bundle(
    bundle: RayBundle,
    occupancy: torch.Tensor,
    extent: float,
    n_probe: int = 128,
    outside_occupied=False,
) -> RayBundle:
    """Re-space each ray's lengths over its occupied segment.

    occupancy: (r, r, r) bool over the voxel volume (cell centres at
    (i - (r-1)/2) * extent / r, x -> W, y -> H, z -> D, as
    `ops/voxel.py:voxel_coord_grid`). Keeps each ray's point count; a ray
    with no occupied probe keeps its interval. `outside_occupied` (bool or a
    0-d bool tensor): whether space outside the volume counts as occupied
    (`render_eval.compute_occupancy` probes it: the density net's bias can
    emit density where the features sample to zero)."""
    r = occupancy.shape[0]
    voxel_size = extent / r
    lengths = bundle.lengths
    dev, dt = lengths.device, lengths.dtype
    n_pts = lengths.shape[-1]
    near = lengths.min(dim=-1).values
    far = lengths.max(dim=-1).values

    t = torch.linspace(0.0, 1.0, n_probe, device=dev, dtype=dt)
    probe_len = near[..., None] + t * (far - near)[..., None]  # (B, N, n_probe)
    pts = bundle.origins[..., None, :] + probe_len[..., None] * bundle.directions[..., None, :]
    idx = torch.round(pts / voxel_size + (r - 1) / 2.0).to(torch.int64)
    inside = torch.all((idx >= 0) & (idx <= r - 1), dim=-1)
    ic = torch.clamp(idx, 0, r - 1)
    lin = (ic[..., 2] * r + ic[..., 1]) * r + ic[..., 0]  # (z * H + y) * W + x
    outside = torch.as_tensor(outside_occupied, dtype=torch.bool, device=dev)
    hits = (occupancy.reshape(-1)[lin] & inside) | (outside & ~inside)
    any_hit = torch.any(hits, dim=-1)

    # argmax of a bool tensor is not taken on the card: as uint8, the first
    # maximum is the first occupied probe
    h8 = hits.to(torch.uint8)
    i0 = torch.argmax(h8, dim=-1)
    i1 = (n_probe - 1) - torch.argmax(torch.flip(h8, dims=(-1,)), dim=-1)
    step = (far - near) / (n_probe - 1)
    t0 = near + torch.clamp(i0 - 1, min=0) * step
    t1 = near + torch.clamp(i1 + 1, max=n_probe - 1) * step
    t0 = torch.where(any_hit, t0, near)
    t1 = torch.where(any_hit, t1, far)

    tt = torch.linspace(0.0, 1.0, n_pts, device=dev, dtype=dt)
    return bundle.replace(lengths=t0[..., None] + tt * (t1 - t0)[..., None])
