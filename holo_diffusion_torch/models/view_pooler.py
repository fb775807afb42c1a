"""View pooling: project 3D points into the source views, sample their
feature maps, aggregate over views (port of
holo_diffusion_tpu/models/view_pooler.py; Implicitron's ViewSampler +
FeatureAggregator). Parameter names are the reference's
(`feature_aggregator._first_sampled`, `_first_mean`, `_mlp`, `_last`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..geometry.cameras import PerspectiveCameras, camera_centers, project_points_ndc
from ..geometry.harmonic import HarmonicEmbedding
from ..ops.image import bilinear_sample_ndc
from .mlp import MLPWithInputSkips


def sample_view_features(
    feats: Dict[str, torch.Tensor],
    cameras: PerspectiveCameras,
    pts: torch.Tensor,
    masks: Optional[torch.Tensor] = None,
    masked_sampling: bool = False,
):
    """Sample every (S, h, w, c) map of `feats` (in sorted key order) at the
    projections of the world points `pts` (N, 3) into the S cameras.
    Returns (features (S, N, sum c), validity (S, N, 1)): in front of the
    camera and, with `masked_sampling`, inside `masks` (S, H, W, 1)."""
    S = cameras.batch_size
    ndc = project_points_ndc(cameras, pts[None].expand(S, *pts.shape))
    xy = ndc[..., :2]
    in_front = (ndc[..., 2:3] > 0.0).to(torch.float32)
    parts = []
    for key in sorted(feats):
        fmap = feats[key]
        parts.append(torch.stack([bilinear_sample_ndc(fmap[s], xy[s]) for s in range(S)]))
    feats_sampled = torch.cat(parts, dim=-1)
    valid = in_front
    if masked_sampling and masks is not None:
        m = torch.stack([bilinear_sample_ndc(masks[s], xy[s]) for s in range(S)])
        valid = (m > 0.5).to(torch.float32) * in_front
    return feats_sampled, valid


def point_to_camera_ray_dirs(cameras: PerspectiveCameras, pts: torch.Tensor) -> torch.Tensor:
    """Unit directions from each camera centre to each point, (S, N, 3)."""
    d = pts[None, :, :] - camera_centers(cameras)[:, None, :]
    return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)


class AngleWeightedReductionFeatureAggregator(nn.Module):
    """Reductions (AVG, STD, MAX) over views weighted by
    ((1 + cos(ray, first source's ray)) / 2 + min_weight) ** gamma."""

    def __init__(
        self,
        reduction_functions: Tuple[str, ...] = ("AVG", "STD"),
        weight_by_ray_angle_gamma: float = 1.0,
        min_ray_angle_weight: float = 0.1,
    ):
        super().__init__()
        self.reduction_functions = tuple(reduction_functions)
        self.gamma = weight_by_ray_angle_gamma
        self.min_weight = min_ray_angle_weight

    def get_aggregated_feature_dim(self, feat_dim: int) -> int:
        return feat_dim * len(self.reduction_functions)

    def forward(self, feats_sampled, masks_sampled, cameras, pts):
        """(S, N, F), (S, N, 1) -> (N, F * n_reductions)."""
        dirs = point_to_camera_ray_dirs(cameras, pts)
        cos = torch.sum(dirs * dirs[:1], dim=-1, keepdim=True)
        w = ((1.0 + cos) / 2.0 + self.min_weight) ** self.gamma * masks_sampled
        w_sum = torch.clamp(torch.sum(w, dim=0), min=1e-6)
        mean = torch.sum(feats_sampled * w, dim=0) / w_sum
        outs = []
        for red in self.reduction_functions:
            if red == "AVG":
                outs.append(mean)
            elif red == "STD":
                var = torch.sum((feats_sampled - mean[None]) ** 2 * w, dim=0) / w_sum
                outs.append(torch.sqrt(torch.clamp(var, min=1e-8)))
            elif red == "MAX":
                masked = torch.where(masks_sampled > 0, feats_sampled, torch.full_like(feats_sampled, -torch.inf))
                outs.append(torch.where(w_sum > 1e-5, masked.max(dim=0).values, torch.zeros_like(mean)))
            else:
                raise ValueError(f"unknown reduction {red}")
        return torch.cat(outs, dim=-1)


class MLPMeanFeatureAggregator(nn.Module):
    """Per-(point, view) features with harmonic ray directions; their
    weighted mean over views; first_sampled(x) + first_mean(mean) -> MLP ->
    last; a softmax of channel 0 over views weights the sum."""

    def __init__(self, feat_dim: int, n_hidden: int = 128, dim_out: int = 128, n_layers: int = 1,
                 n_harmonic_functions_ray: int = 3):
        super().__init__()
        self.harmonic = HarmonicEmbedding(n_harmonic_functions_ray)
        d_in = feat_dim + self.harmonic.get_output_dim(3)
        self.dim_out = dim_out
        self._first_sampled = nn.Linear(d_in, n_hidden)
        self._first_mean = nn.Linear(d_in, n_hidden)
        self._mlp = MLPWithInputSkips(
            n_layers=n_layers, input_dim=n_hidden, output_dim=n_hidden, skip_dim=n_hidden,
            hidden_dim=n_hidden, input_skips=(), hidden_activation="LEAKYRELU",
            last_activation="SOFTPLUS",
        )
        self._last = nn.Linear(n_hidden, dim_out)

    def get_aggregated_feature_dim(self, feat_dim: int) -> int:
        return self.dim_out

    def forward(self, feats_sampled, masks_sampled, cameras, pts):
        """(S, N, F), (S, N, 1) -> (N, dim_out)."""
        w = masks_sampled
        x = torch.cat([feats_sampled, self.harmonic(point_to_camera_ray_dirs(cameras, pts))], dim=-1) * w
        mean = torch.sum(x * w, dim=0, keepdim=True) / torch.clamp(torch.sum(w, dim=0), min=1e-4)
        out = self._last(self._mlp(self._first_sampled(x) + self._first_mean(mean)))
        attn = torch.softmax(out[..., :1], dim=0)
        return torch.sum(out * attn, dim=0)


AGGREGATORS = {
    "AngleWeightedReductionFeatureAggregator": AngleWeightedReductionFeatureAggregator,
    "MLPMeanFeatureAggregator": MLPMeanFeatureAggregator,
}


class ViewPooler(nn.Module):
    """ViewSampler + FeatureAggregator."""

    def __init__(self, feat_dim: int, aggregator_class_type: str = "AngleWeightedReductionFeatureAggregator",
                 aggregator_args: Optional[dict] = None, masked_sampling: bool = False):
        super().__init__()
        if aggregator_class_type not in AGGREGATORS:
            raise ValueError(aggregator_class_type)
        args = dict(aggregator_args or {})
        if aggregator_class_type == "MLPMeanFeatureAggregator":
            args["feat_dim"] = feat_dim
        self.feature_aggregator = AGGREGATORS[aggregator_class_type](**args)
        self.masked_sampling = masked_sampling
        self.out_dim = self.feature_aggregator.get_aggregated_feature_dim(feat_dim)

    def forward(self, feats, cameras, pts, masks=None):
        feats_sampled, valid = sample_view_features(feats, cameras, pts, masks, self.masked_sampling)
        return self.feature_aggregator(feats_sampled, valid, cameras, pts)
