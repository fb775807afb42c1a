"""Rays, the trilinear decode written out in full, and the two-pass
emission-absorption render of the reference."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import cameras as cam
from .nets import RenderMLP


def pixel_ndc(H: int, W: int, device) -> torch.Tensor:
    """(H * W, 2) NDC of pixel centres, row-major; pixel (0, 0) at (+x, +y)."""
    x = 1.0 - (2.0 * torch.arange(W, device=device, dtype=torch.float32) + 1.0) / W
    y = 1.0 - (2.0 * torch.arange(H, device=device, dtype=torch.float32) + 1.0) / H
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx, yy], dim=-1).reshape(-1, 2)


def depth_bounds(cams: cam.Cameras, center, extent: float):
    c = cam.centers(cams)
    d = torch.linalg.norm(c - torch.tensor(center, dtype=c.dtype, device=c.device), dim=-1)
    r = extent * 3.0 ** 0.5
    return torch.clamp(d - r, min=0.01), d + r


def coarse_lengths(near, far, n_rays: int, n_pts: int, u: Optional[torch.Tensor]) -> torch.Tensor:
    t = torch.linspace(0.0, 1.0, n_pts, device=near.device)
    lengths = (near[:, None, None] + t * (far - near)[:, None, None]).expand(near.shape[0], n_rays, n_pts)
    if u is not None:
        mids = 0.5 * (lengths[..., 1:] + lengths[..., :-1])
        hi = torch.cat([mids, lengths[..., -1:]], dim=-1)
        lo = torch.cat([lengths[..., :1], mids], dim=-1)
        lengths = lo + (hi - lo) * u
    return lengths


def rays(cams: cam.Cameras, xys: torch.Tensor, lengths: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Rays through NDC xys (B, N, 2): origins, unnormalised directions of
    unit z-depth, lengths (B, N, P), xys."""
    B, N = xys.shape[:2]
    at1 = cam.unproject_ndc(cams, torch.cat([xys, torch.ones_like(xys[..., :1])], dim=-1))
    o = cam.centers(cams)[:, None].expand(B, N, 3)
    return {"origins": o, "directions": at1 - o, "lengths": lengths, "xys": xys}


def full_grid_rays(cams, H: int, W: int, n_pts: int, center, extent: float):
    B = cams["R"].shape[0]
    xys = pixel_ndc(H, W, cams["R"].device)[None].expand(B, H * W, 2)
    near, far = depth_bounds(cams, center, extent)
    return rays(cams, xys, coarse_lengths(near, far, H * W, n_pts, None))


def mask_rays(cams, mask: torch.Tensor, n_pts: int, pixel_u, length_u, center, extent: float):
    """Pixels drawn with replacement in proportion to mask (B, H, W) by the
    inverse CDF at the uniforms pixel_u (B, n)."""
    B, H, W = mask.shape
    w = torch.clamp(mask.reshape(B, -1), min=0.0)
    w = torch.where(torch.all(w <= 0, dim=-1, keepdim=True), torch.ones_like(w), w)
    cdf = torch.cumsum(w, dim=-1)
    pix = torch.clamp(torch.searchsorted(cdf, (pixel_u * cdf[:, -1:]).contiguous(), right=True), max=H * W - 1)
    xys = pixel_ndc(H, W, mask.device)[pix]
    near, far = depth_bounds(cams, center, extent)
    return rays(cams, xys, coarse_lengths(near, far, pixel_u.shape[1], n_pts, length_u))


def trilinear(grid: torch.Tensor, pts: torch.Tensor, extent: float) -> torch.Tensor:
    """grid (D, H, W, C) sampled at world pts (..., 3), align-corners voxel
    centres, zero outside: the 8 corners gathered and weighted."""
    D, H, W, C = grid.shape
    vs = extent / D
    idx = [pts[..., 0] / vs + (W - 1) / 2.0, pts[..., 1] / vs + (H - 1) / 2.0, pts[..., 2] / vs + (D - 1) / 2.0]
    base = [torch.floor(i) for i in idx]
    frac = [i - b for i, b in zip(idx, base)]
    flat = grid.reshape(-1, C)
    out = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                q = [base[0] + dx, base[1] + dy, base[2] + dz]
                w = ((frac[0] if dx else 1 - frac[0]) * (frac[1] if dy else 1 - frac[1])
                     * (frac[2] if dz else 1 - frac[2]))
                inside = ((q[0] >= 0) & (q[0] <= W - 1) & (q[1] >= 0) & (q[1] <= H - 1)
                          & (q[2] >= 0) & (q[2] <= D - 1))
                cell = ((q[2].clamp(0, D - 1) * H + q[1].clamp(0, H - 1)) * W + q[0].clamp(0, W - 1)).long()
                out = out + flat[cell] * (w * inside)[..., None]
    return out


def decode(mlp: RenderMLP, grid, pts, directions, extent: float, normals: bool):
    """pts (B, N, P, 3), per-ray directions (B, N, 3) -> densities
    (B, N, P, 1), rgb (B, N, P, 3) and, with `normals`, the unit gradient of
    the density pre-activation in space (B, N, P, 3), by autograd through the
    trilinear sample."""
    dirs = directions / torch.clamp(torch.linalg.norm(directions, dim=-1, keepdim=True), min=1e-12)
    dirs = dirs[..., None, :].expand(pts.shape)
    n = None
    if normals:
        with torch.enable_grad():
            p = pts.detach().requires_grad_(True)
            pre = mlp.density_pre(trilinear(grid.detach(), p, extent))[..., -1]
            (g,) = torch.autograd.grad(pre.sum(), p)
        n = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-12)
    dens, rgb = mlp(trilinear(grid, pts, extent), dirs)
    return dens, rgb, n


def raymarch(dens, feats, lengths, background_opacity: float, noise=None):
    """Emission-absorption with surface thickness 1 and the last interval
    `background_opacity`: (features, depth, opacity, weights)."""
    raw = dens[..., 0] if noise is None else dens[..., 0] + noise
    deltas = torch.cat([lengths[..., 1:] - lengths[..., :-1],
                        torch.full_like(lengths[..., :1], background_opacity)], dim=-1)
    wd = deltas * torch.relu(raw)
    cum = torch.cumsum(wd, dim=-1)
    trans = torch.cat([torch.ones_like(cum[..., :1]), torch.exp(-cum[..., :-1])], dim=-1)
    weights = (1.0 - torch.exp(-wd)) * trans
    return (torch.einsum("bnp,bnpc->bnc", weights, feats), torch.sum(weights * lengths, -1, keepdim=True),
            1.0 - torch.exp(-cum[..., -1:]), weights)


def refine(lengths, weights, n_fine: int, u: Optional[torch.Tensor], append: bool) -> torch.Tensor:
    """Inverse-CDF resampling over the coarse midpoints, sorted, the coarse
    lengths appended; evenly spaced u when `u` is None."""
    bins = 0.5 * (lengths[..., 1:] + lengths[..., :-1])
    w = weights[..., 1:-1] + 1e-5
    cdf = torch.cumsum(w / torch.sum(w, dim=-1, keepdim=True), dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    if u is None:
        u = torch.linspace(0.0, 1.0, n_fine, device=cdf.device).expand(*cdf.shape[:-1], n_fine).contiguous()
    M = cdf.shape[-1]
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    lo, hi = torch.clamp(inds - 1, min=0), torch.clamp(inds, max=M - 1)
    c_lo, c_hi = cdf.gather(-1, lo), cdf.gather(-1, hi)
    b_lo, b_hi = bins.gather(-1, lo), bins.gather(-1, hi)
    den = c_hi - c_lo
    den = torch.where(den < 1e-8, torch.ones_like(den), den)
    fine = b_lo + (u - c_lo) / den * (b_hi - b_lo)
    if append:
        fine = torch.cat([lengths, fine], dim=-1)
    return torch.sort(fine, dim=-1).values


def render(mlp: RenderMLP, grid, bundle, spec, training: bool, draws: Optional[Dict] = None,
           normals: bool = False):
    """The passes of the multi-pass render: a list, coarse first, of dicts
    {rgb, depth, mask, weights[, normals]}."""
    lengths = bundle["lengths"]
    B, N = lengths.shape[:2]
    n_fine = spec.n_fine_train if training else spec.n_fine_eval
    stratified = spec.stratified_train if training else spec.stratified_eval
    passes = []
    for k in range(spec.num_passes):
        if k > 0:
            u = draws[f"refine_u_{k}"] if (draws is not None and stratified) else None
            lengths = refine(lengths, passes[-1]["weights"].detach(), n_fine, u, spec.append_coarse)
        pts = bundle["origins"][..., None, :] + lengths[..., None] * bundle["directions"][..., None, :]
        dens, rgb, nrm = decode(mlp, grid, pts, bundle["directions"], spec.volume_extent, normals)
        noise = spec.density_noise_std * draws[f"density_noise_{k}"] if training else None
        feat, depth, mask, weights = raymarch(dens, rgb, lengths, spec.background_opacity, noise)
        out = {"rgb": feat, "depth": depth, "mask": mask, "weights": weights}
        if nrm is not None:
            out["normals"] = torch.einsum("bnp,bnpc->bnc", weights, nrm)
        passes.append(out)
    return passes


@torch.no_grad()
def render_frame(mlp: RenderMLP, grid: torch.Tensor, cams: cam.Cameras, spec, rays_per_block: int = 8192):
    """A dense H x W evaluation render of cams[0] (the frame's RGB, depth,
    opacity and, where the configuration renders them, normals), in blocks
    of rays, each ray on its own as in any chunking."""
    H, W = spec.render_height, spec.render_width
    bundle = full_grid_rays(cam.select(cams, 0), H, W, spec.n_pts_eval, spec.scene_center, spec.scene_extent)
    parts = {"rgb": [], "depth": [], "mask": [], "normals": []}
    for s in range(0, H * W, rays_per_block):
        chunk = {k: v[:, s:s + rays_per_block] for k, v in bundle.items()}
        last = render(mlp, grid, chunk, spec, training=False, normals=spec.render_normals)[-1]
        for k in parts:
            if k in last:
                parts[k].append(last[k][0])
    return {k: torch.cat(v).reshape(H, W, -1) for k, v in parts.items() if v}
