"""The reference's networks but the denoiser, float32, channels-last at
their edges. The denoiser (`net_3d.*`) is the plug-in that the
configuration's `net_3d_class_type` names, `net3d_<class_type>.py`.

Parameter names are those of the released model (and so of its state
dict): `image_feature_extractor.net.layer{i}.{j}.conv1`, `view_pooler.
feature_aggregator._first_sampled`, `pooled_feature_mapper`,
`implicit_function.render_mlp._density_net.mlp.{i}.0`, so one state dict
loads into both sides.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from . import cameras as cam

RESNET34 = (3, 4, 6, 3)
WIDTHS = (64, 128, 256, 512)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def harmonic(x: torch.Tensor, n: int) -> torch.Tensor:
    """[sin(2^i x) | cos(2^i x) | x] with the d * n + i layout of pytorch3d."""
    freqs = 2.0 ** torch.arange(n, dtype=x.dtype, device=x.device)
    e = (x[..., :, None] * freqs).reshape(*x.shape[:-1], -1)
    return torch.cat([torch.sin(e), torch.cos(e), x], dim=-1)


# ---- image features


class FrozenBN(nn.BatchNorm2d):
    """BatchNorm on its running statistics in every mode (the release
    extractor's); scale and bias still train."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)


class Block(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = FrozenBN(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = FrozenBN(cout)
        self.downsample = None
        if cin != cout or stride != 1:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, 0, bias=False), FrozenBN(cout))

    def forward(self, x):
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class Trunk(nn.Module):
    def __init__(self, max_stage: int):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBN(64)
        cin = 64
        for li in range(1, max_stage + 1):
            blocks = []
            for bi in range(RESNET34[li - 1]):
                blocks.append(Block(cin, WIDTHS[li - 1], 2 if (bi == 0 and li > 1) else 1))
                cin = WIDTHS[li - 1]
            setattr(self, f"layer{li}", nn.Sequential(*blocks))


class Extractor(nn.Module):
    """ResNet34 stages, each projected, l2-normalised; plus the images and
    masks themselves."""

    def __init__(self, args: Dict):
        super().__init__()
        self.stages = tuple(args["stages"])
        self.rescale = float(args["image_rescale"])
        self.proj_dim = int(args["proj_dim"])
        self.normalize = bool(args["normalize_image"])
        self.max_pool = bool(args["first_max_pool"])
        self.l2 = bool(args["l2_norm"])
        self.add_masks = bool(args["add_masks"])
        self.add_images = bool(args["add_images"])
        self.feature_rescale = float(args["feature_rescale"])
        if self.proj_dim <= 0:
            raise NotImplementedError("the reference projects every stage (proj_dim > 0)")
        self.net = Trunk(max(self.stages))
        self.proj_layers = nn.ModuleDict({str(s - 1): nn.Conv2d(WIDTHS[s - 1], self.proj_dim, 1)
                                          for s in self.stages})

    def feat_dim(self) -> int:
        return len(self.stages) * self.proj_dim + int(self.add_masks) + 3 * int(self.add_images)

    def forward(self, images: torch.Tensor, masks: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images (S, H, W, 3), masks (S, H, W, 1) -> channels-last maps."""
        out = {}
        if self.add_images:
            out["images"] = images
        if self.add_masks:
            out["masks"] = masks
        S, H, W, _ = images.shape
        x = images.permute(0, 3, 1, 2)
        if self.rescale != 1.0:
            x = F.interpolate(x, size=(int(H * self.rescale), int(W * self.rescale)), mode="bilinear",
                              align_corners=False)
        if self.normalize:
            mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
            std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None]
            x = (x - mean) / std
        x = F.relu(self.net.bn1(self.net.conv1(x)))
        if self.max_pool:
            x = F.max_pool2d(x, 3, 2, 1)
        for li in range(1, max(self.stages) + 1):
            x = getattr(self.net, f"layer{li}")(x)
            if li in self.stages:
                f = self.proj_layers[str(li - 1)](x).permute(0, 2, 3, 1)
                if self.l2:
                    f = f / torch.clamp(torch.linalg.norm(f, dim=-1, keepdim=True), min=1e-6)
                out[f"res_layer_{li}"] = f * self.feature_rescale
        return out


def sample_maps(maps: Dict[str, torch.Tensor], cams: cam.Cameras, pts: torch.Tensor):
    """Every (S, h, w, c) map, in sorted key order, sampled bilinearly
    (zero outside) at the projections of world points pts (N, 3) ->
    (features (S, N, sum c), in front of the camera (S, N, 1))."""
    S = cams["R"].shape[0]
    ndc = cam.project_ndc(cams, pts[None].expand(S, *pts.shape))
    # pytorch3d NDC has +x left, +y up; grid_sample's grid is the other way
    grid = (-ndc[..., :2])[:, None]  # (S, 1, N, 2)
    parts = [F.grid_sample(maps[k].permute(0, 3, 1, 2), grid, mode="bilinear", padding_mode="zeros",
                           align_corners=False)[:, :, 0].permute(0, 2, 1) for k in sorted(maps)]
    return torch.cat(parts, dim=-1), (ndc[..., 2:3] > 0.0).float()


def view_dirs(cams: cam.Cameras, pts: torch.Tensor) -> torch.Tensor:
    d = pts[None] - cam.centers(cams)[:, None]
    return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)


class Seq1(nn.Module):
    """`mlp.{i}.0` naming of one linear layer."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.mlp = nn.ModuleList([nn.Sequential(nn.Linear(cin, cout))])


class MLPMean(nn.Module):
    def __init__(self, feat_dim: int, n_hidden: int = 128, dim_out: int = 128, n_layers: int = 1,
                 n_harmonic_functions_ray: int = 3):
        super().__init__()
        if n_layers != 1:
            raise NotImplementedError("the reference's MLPMean aggregator has one hidden layer")
        self.n_harm = n_harmonic_functions_ray
        d_in = feat_dim + 3 * (2 * self.n_harm + 1)
        self.dim_out = dim_out
        self._first_sampled = nn.Linear(d_in, n_hidden)
        self._first_mean = nn.Linear(d_in, n_hidden)
        self._mlp = Seq1(n_hidden, n_hidden)
        self._last = nn.Linear(n_hidden, dim_out)

    def forward(self, feats, valid, cams, pts):
        x = torch.cat([feats, harmonic(view_dirs(cams, pts), self.n_harm)], dim=-1) * valid
        mean = torch.sum(x * valid, dim=0, keepdim=True) / torch.clamp(torch.sum(valid, dim=0), min=1e-4)
        h = self._first_sampled(x) + self._first_mean(mean)
        # one layer, which is the last: the hidden activation (LeakyReLU)
        out = self._last(leaky(self._mlp.mlp[0][0](h)))
        return torch.sum(out * torch.softmax(out[..., :1], dim=0), dim=0)


class AngleWeighted(nn.Module):
    def __init__(self, feat_dim: int, reduction_functions=("AVG", "STD"), weight_by_ray_angle_gamma: float = 1.0,
                 min_ray_angle_weight: float = 0.1):
        super().__init__()
        self.reductions = tuple(reduction_functions)
        if not set(self.reductions) <= {"AVG", "STD"}:
            raise NotImplementedError(f"reductions {self.reductions}")
        self.gamma = weight_by_ray_angle_gamma
        self.min_weight = min_ray_angle_weight
        self.dim_out = feat_dim * len(self.reductions)

    def forward(self, feats, valid, cams, pts):
        d = view_dirs(cams, pts)
        cos = torch.sum(d * d[:1], dim=-1, keepdim=True)
        w = ((1.0 + cos) / 2.0 + self.min_weight) ** self.gamma * valid
        w_sum = torch.clamp(torch.sum(w, dim=0), min=1e-6)
        mean = torch.sum(feats * w, dim=0) / w_sum
        outs = []
        for red in self.reductions:
            if red == "AVG":
                outs.append(mean)
            else:
                var = torch.sum((feats - mean[None]) ** 2 * w, dim=0) / w_sum
                outs.append(torch.sqrt(torch.clamp(var, min=1e-8)))
        return torch.cat(outs, dim=-1)


class Pooler(nn.Module):
    def __init__(self, aggregator: str, args: Dict, feat_dim: int):
        super().__init__()
        if aggregator == "MLPMeanFeatureAggregator":
            self.feature_aggregator = MLPMean(feat_dim, **args)
        elif aggregator == "AngleWeightedReductionFeatureAggregator":
            self.feature_aggregator = AngleWeighted(feat_dim, **args)
        else:
            raise NotImplementedError(aggregator)


# ---- the decoder


class LinearStack(nn.Module):
    def __init__(self, dims):
        super().__init__()
        self.mlp = nn.ModuleList([nn.Sequential(nn.Linear(a, b)) for a, b in dims])


class RenderMLP(nn.Module):
    """Density net: linear layers with the input re-joined at the skips, one
    LeakyReLU at its output ([hidden | density]); radiance: one LeakyReLU
    layer on [hidden | harmonic(dir)], then a sigmoid."""

    def __init__(self, input_dims: int, args: Dict):
        super().__init__()
        self.n_dir = int(args["dir_emb_dims"])
        self.hidden = int(args["dnet_hidden_dim"])
        self.skips = tuple(args["dnet_input_skips"])
        n = int(args["dnet_num_layers"])
        dims = []
        for li in range(n):
            cin = input_dims if li == 0 else self.hidden
            if li > 0 and li in self.skips:
                cin += input_dims
            dims.append((cin, self.hidden + 1 if li == n - 1 else self.hidden))
        self._density_net = LinearStack(dims)
        self._radiance_net = LinearStack([(self.hidden + 3 * (2 * self.n_dir + 1), 3)])

    def density_pre(self, s: torch.Tensor) -> torch.Tensor:
        """The density net before its output activation, (..., hidden + 1)."""
        y = s
        for li, layer in enumerate(self._density_net.mlp):
            if li > 0 and li in self.skips:
                y = torch.cat([y, s], dim=-1)
            y = layer[0](y)
        return y

    def forward(self, s: torch.Tensor, dirs: torch.Tensor):
        h = leaky(self.density_pre(s))
        rgb = torch.sigmoid(leaky(self._radiance_net.mlp[0][0](
            torch.cat([h[..., :self.hidden], harmonic(dirs, self.n_dir)], dim=-1))))
        return h[..., self.hidden:], rgb


class Implicit(nn.Module):
    def __init__(self, spec):
        super().__init__()
        self.render_mlp = RenderMLP(spec.feature_size, spec.mlp)
