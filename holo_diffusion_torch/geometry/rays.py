"""Ray sampling (port of holo_diffusion_tpu/geometry/rays.py): full-grid
rays, mask-sampled training rays, depth bounds with optional stratified
jitter, and the importance refinement of the multi-pass renderer. Random
draws (uniforms) are arguments: the caller passes them in.

Ray lengths parameterise z-depth (pytorch3d): direction = unproject(xy, 1)
- camera centre, so origin + length * direction has z_cam == length.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .cameras import PerspectiveCameras, camera_centers, unproject_ndc_points


@dataclasses.dataclass
class RayBundle:
    """origins, directions: (B, N, 3) (directions unnormalised, unit z-depth
    per step); lengths: (B, N, P); xys: (B, N, 2) NDC pixel positions."""

    origins: torch.Tensor
    directions: torch.Tensor
    lengths: torch.Tensor
    xys: torch.Tensor

    def replace(self, **changes) -> "RayBundle":
        return dataclasses.replace(self, **changes)

    def slice_rays(self, sl: slice) -> "RayBundle":
        """The rays `sl` of every bundle (slices the N axis)."""
        return RayBundle(*(getattr(self, f.name)[:, sl] for f in dataclasses.fields(self)))


def ray_bundle_to_ray_points(bundle: RayBundle) -> torch.Tensor:
    """(B, N, P, 3) world points: origins + lengths * directions."""
    return (
        bundle.origins[..., None, :]
        + bundle.lengths[..., :, None] * bundle.directions[..., None, :]
    )


def adaptive_depth_bounds(
    cameras: PerspectiveCameras,
    scene_center=(0.0, 0.0, 0.0),
    scene_extent: float = 4.0,
    min_near: float = 0.01,
):
    """Per-camera (near, far): the distance to the scene centre minus/plus the
    bounding-sphere radius scene_extent * sqrt(3)."""
    centers = camera_centers(cameras)
    center = torch.as_tensor(scene_center, dtype=centers.dtype, device=centers.device)
    d = torch.linalg.norm(centers - center, dim=-1)
    r = scene_extent * 3.0 ** 0.5
    return torch.clamp(d - r, min=min_near), d + r


def stratify_lengths(
    near: torch.Tensor,
    far: torch.Tensor,
    n_rays: int,
    n_pts: int,
    uniform: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B,) near/far -> (B, n_rays, n_pts) evenly spaced lengths; with
    `uniform` (B, n_rays, n_pts) in [0, 1) each length is jittered inside its
    bin (pytorch3d stratified sampling)."""
    t = torch.linspace(0.0, 1.0, n_pts, device=near.device, dtype=near.dtype)
    lengths = near[:, None, None] + t[None, None, :] * (far - near)[:, None, None]
    lengths = lengths.expand(near.shape[0], n_rays, n_pts)
    if uniform is not None:
        mids = 0.5 * (lengths[..., 1:] + lengths[..., :-1])
        upper = torch.cat([mids, lengths[..., -1:]], dim=-1)
        lower = torch.cat([lengths[..., :1], mids], dim=-1)
        lengths = lower + (upper - lower) * uniform
    return lengths


def pixel_grid_ndc(H: int, W: int, device=None) -> torch.Tensor:
    """(H, W, 2) NDC coords of pixel centres; row 0 / col 0 -> (+y, +x)."""
    x = 1.0 - (2.0 * torch.arange(W, device=device, dtype=torch.float32) + 1.0) / W
    y = 1.0 - (2.0 * torch.arange(H, device=device, dtype=torch.float32) + 1.0) / H
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx, yy], dim=-1)


def _xys_to_ray_bundle(
    cameras: PerspectiveCameras, xys: torch.Tensor, lengths: torch.Tensor
) -> RayBundle:
    B, N = xys.shape[:2]
    ones = torch.ones((B, N, 1), dtype=xys.dtype, device=xys.device)
    pts_at_1 = unproject_ndc_points(cameras, torch.cat([xys, ones], dim=-1))
    origins = camera_centers(cameras)[:, None, :].expand(B, N, 3)
    return RayBundle(origins=origins, directions=pts_at_1 - origins, lengths=lengths, xys=xys)


def sample_rays_full_grid(
    cameras: PerspectiveCameras,
    image_height: int,
    image_width: int,
    n_pts_per_ray: int,
    scene_center=(0.0, 0.0, 0.0),
    scene_extent: float = 4.0,
    length_uniform: Optional[torch.Tensor] = None,
) -> RayBundle:
    """Dense H*W ray grid (FULL_GRID mode); stratified when `length_uniform`
    (B, H*W, n_pts_per_ray) is given."""
    B = cameras.batch_size
    xys = pixel_grid_ndc(image_height, image_width, cameras.R.device).reshape(1, -1, 2)
    xys = xys.expand(B, image_height * image_width, 2)
    near, far = adaptive_depth_bounds(cameras, scene_center, scene_extent)
    lengths = stratify_lengths(near, far, xys.shape[1], n_pts_per_ray, length_uniform)
    return _xys_to_ray_bundle(cameras, xys, lengths)


def sample_rays_from_mask(
    cameras: PerspectiveCameras,
    mask: torch.Tensor,
    n_pts_per_ray: int,
    pixel_uniform: torch.Tensor,
    length_uniform: Optional[torch.Tensor] = None,
    scene_center=(0.0, 0.0, 0.0),
    scene_extent: float = 4.0,
) -> RayBundle:
    """MASK_SAMPLE (training): n_rays pixels per image drawn with replacement
    in proportion to `mask` (B, H, W), by inverse CDF of the uniforms
    `pixel_uniform` (B, n_rays); an all-zero mask samples uniformly. The
    coarse lengths are stratified when `length_uniform` (B, n_rays,
    n_pts_per_ray) is given."""
    B, H, W = mask.shape
    n_rays = pixel_uniform.shape[1]
    w = torch.clamp(mask.reshape(B, -1), min=0.0)
    all_zero = torch.all(w <= 0, dim=-1, keepdim=True)
    w = torch.where(all_zero, torch.ones_like(w), w)
    cdf = torch.cumsum(w, dim=-1)
    u = pixel_uniform * cdf[:, -1:]
    pix = torch.clamp(torch.searchsorted(cdf, u.contiguous(), right=True), max=H * W - 1)
    xys = pixel_grid_ndc(H, W, mask.device).reshape(-1, 2)[pix]
    near, far = adaptive_depth_bounds(cameras, scene_center, scene_extent)
    lengths = stratify_lengths(near, far, n_rays, n_pts_per_ray, length_uniform)
    return _xys_to_ray_bundle(cameras, xys, lengths)


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    uniform: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Inverse-CDF sampling of `n_samples` points from the piecewise-constant
    pdf `weights` (..., M-1) over bin edges `bins` (..., M) (pytorch3d
    `sample_pdf`). Deterministic (evenly spaced u) when `uniform` is None."""
    weights = weights + eps
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (..., M)
    if uniform is None:
        u = torch.linspace(0.0, 1.0, n_samples, device=cdf.device, dtype=cdf.dtype)
        u = u.expand(*cdf.shape[:-1], n_samples).contiguous()
    else:
        u = uniform
    M = cdf.shape[-1]
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=M - 1)
    cdf_below, cdf_above = cdf.gather(-1, below), cdf.gather(-1, above)
    bins_below, bins_above = bins.gather(-1, below), bins.gather(-1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-8, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def importance_sample_lengths(
    lengths: torch.Tensor,
    weights: torch.Tensor,
    n_fine: int,
    uniform: Optional[torch.Tensor] = None,
    append_coarse: bool = True,
) -> torch.Tensor:
    """RayPointRefiner: resample (B, N, n_fine) depths from the coarse
    raymarcher weights (B, N, P) over the midpoint bins; returns them sorted,
    with the coarse depths appended when `append_coarse`."""
    mids = 0.5 * (lengths[..., 1:] + lengths[..., :-1])
    fine = sample_pdf(mids, weights[..., 1:-1], n_fine, uniform)
    if append_coarse:
        fine = torch.cat([lengths, fine], dim=-1)
    return torch.sort(fine, dim=-1).values
