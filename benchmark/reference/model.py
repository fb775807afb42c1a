"""The reference model: pooling, the bootstrapped two-pass denoise, the
render and its loss; a training step with Adam; the DDPM step and the
evaluation frame. Batches are dicts of tensors (the benchmark's own frames),
draws a dict by name (timesteps, noise, noise2, take_boot, ray_pixel_u,
ray_length_u, refine_u_{k}, density_noise_{k})."""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import cameras as cam
from . import diffusion as diff
from . import net3d_plugin
from .nets import Extractor, Implicit, Pooler, sample_maps
from .render import mask_rays, render, render_frame
from .spec import Spec


def as_unit(x: torch.Tensor) -> torch.Tensor:
    return x.float() / 255.0 if x.dtype == torch.uint8 else x.float()


def voxel_centres(resol: int, extent: float, device) -> torch.Tensor:
    """(resol^3, 3) world xyz of the voxel centres, z-major."""
    c = (torch.arange(resol, device=device, dtype=torch.float32) - (resol - 1) / 2.0) * (extent / resol)
    zz, yy, xx = torch.meshgrid(c, c, c, indexing="ij")
    return torch.stack([xx, yy, zz], dim=-1).reshape(-1, 3)


def sample_image(image: torch.Tensor, xys: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) at NDC xys (B, N, 2) -> (B, N, C), bilinear."""
    return F.grid_sample(image.permute(0, 3, 1, 2), (-xys)[:, None], mode="bilinear", padding_mode="zeros",
                         align_corners=False)[:, :, 0].permute(0, 2, 1)


class Model(nn.Module):
    def __init__(self, spec: Spec):
        super().__init__()
        self.spec = spec
        self.image_feature_extractor = Extractor(spec.extractor)
        feat_dim = self.image_feature_extractor.feat_dim()
        self.view_pooler = Pooler(spec.aggregator, spec.aggregator_args, feat_dim)
        self.pooled_feature_mapper = nn.Linear(self.view_pooler.feature_aggregator.dim_out, spec.feature_size)
        self.net_3d = net3d_plugin("reference", spec.net_3d_type).build(spec.feature_size, spec.net_3d)
        self.implicit_function = Implicit(spec)

    def preprocess(self, batch: Dict[str, torch.Tensor]):
        s = self.spec
        image, fg = as_unit(batch["image_rgb"]), as_unit(batch["fg_probability"])
        mask = (fg > s.mask_threshold).float()
        bg = torch.tensor(s.bg_color, device=image.device)
        return image * mask + bg * (1.0 - mask), mask, as_unit(batch["mask_crop"])

    def pool(self, image, mask, cams) -> torch.Tensor:
        """Source views -> the voxel grid (1, r, r, r, C) in [-1, 1]."""
        s = self.spec
        feats = self.image_feature_extractor(image, mask)
        pts = voxel_centres(s.resol, s.volume_extent, image.device)
        sampled, valid = sample_maps(feats, cams, pts)
        pooled = self.view_pooler.feature_aggregator(sampled, valid, cams, pts)
        return torch.tanh(self.pooled_feature_mapper(pooled)).reshape(1, s.resol, s.resol, s.resol, -1)

    def objective(self, batch, draws, sched: diff.Schedule, ray_share: float = 1.0) -> torch.Tensor:
        """The training forward's objective. `ray_share` < 1 takes the loss
        over the first share of each target's rays only (a fault to plant)."""
        s = self.spec
        image, mask, crop = self.preprocess(batch)
        cams = {k: batch[k] for k in ("R", "T", "focal", "pp")}
        B = image.shape[0]
        nt = B if s.n_train_target_views <= 0 else min(s.n_train_target_views, B)
        nt = 1 if B <= nt else nt
        v = self.pool(image[nt:], mask[nt:], cam.select(cams, slice(nt, None)))
        t = draws["timesteps"]
        v = torch.clamp(self.net_3d(diff.q_sample(sched, v, t[:1], draws["noise"]), t[:1]), -1.0, 1.0)
        if s.enable_bootstrap and bool(draws["take_boot"]):
            v = torch.clamp(self.net_3d(diff.q_sample(sched, v, t[1:], draws["noise2"]), t[1:]), -1.0, 1.0)
        tcams = cam.select(cams, slice(0, nt))
        bundle = mask_rays(tcams, crop[:nt, ..., 0], s.n_pts_train, draws["ray_pixel_u"],
                           draws["ray_length_u"] if s.stratified_train else None, s.scene_center, s.scene_extent)
        passes = render(self.implicit_function.render_mlp, v[0], bundle, s, training=True, draws=draws)
        target = sample_image(image[:nt], bundle["xys"])
        n = max(1, int(round(target.shape[1] * ray_share)))
        total = 0.0
        for w, p in zip(s.rgb_weights, passes[::-1]):
            if w:
                total = total + w * torch.mean((p["rgb"][:, :n] - target[:, :n]) ** 2)
        return total

    def p_sample(self, sched: diff.Schedule, x, t, noise):
        return diff.p_sample(sched, self.net_3d, x, t, noise)

    def frame(self, grid: torch.Tensor, cams: cam.Cameras, rays_per_block: int = 8192):
        return render_frame(self.implicit_function.render_mlp, grid, cams, self.spec, rays_per_block)


class Adam:
    """Adam without weight decay, torch's arithmetic: p -= lr / (1 - b1^n) *
    m / (sqrt(v) / sqrt(1 - b2^n) + eps); parameters without a gradient are
    left alone."""

    def __init__(self, params: List[nn.Parameter], lr: float, betas, eps: float = 1e-8):
        self.params, self.lr, (self.b1, self.b2), self.eps = params, lr, betas, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.n = [0] * len(params)

    @torch.no_grad()
    def step(self):
        for i, p in enumerate(self.params):
            if p.grad is None:
                continue
            g = p.grad
            self.n[i] += 1
            self.m[i].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[i].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            bc1, bc2 = 1 - self.b1 ** self.n[i], 1 - self.b2 ** self.n[i]
            p.sub_(self.lr / bc1 * self.m[i] / (self.v[i].sqrt() / bc2 ** 0.5 + self.eps))


class Trainer:
    """The reference's training steps from given weights: each step's
    objective, the first step's gradient norm by leaf, and, after the
    steps, each leaf's change."""

    def __init__(self, model: Model, ray_share: float = 1.0):
        self.model = model
        self.sched = diff.Schedule(model.spec.num_steps, model.spec.beta_start, model.spec.beta_end,
                                   next(model.parameters()).device)
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self.start = [p.detach().clone() for p in self.params]
        self.adam = Adam(self.params, model.spec.lr, model.spec.betas)
        self.ray_share = ray_share
        self.losses: List[float] = []
        self.first_grad_norms: Optional[Dict[str, float]] = None

    def step(self, batch, draws):
        for p in self.params:
            p.grad = None
        loss = self.model.objective(batch, draws, self.sched, self.ray_share)
        loss.backward()
        if self.first_grad_norms is None:
            self.first_grad_norms = {n: float(p.grad.norm()) if p.grad is not None else 0.0
                                     for n, p in zip(self.names, self.params)}
        self.adam.step()
        self.losses.append(loss.item())

    def change_norms(self) -> Dict[str, float]:
        return {n: float((p.detach() - p0).norm()) for n, p, p0 in zip(self.names, self.params, self.start)}
