"""ResNet multi-stage image feature extractor (port of
holo_diffusion_tpu/models/feature_extractor.py; Implicitron's
`ResNetFeatureExtractor`): resnet18/34 stages, each stage projected to
`proj_dim` channels and l2-normalised, plus the images and masks themselves.

Inputs and outputs are channels-last (B, H, W, C), as in the JAX package;
the convolutions run channels-first inside. Parameter names are the
reference's: `net.conv1`, `net.bn1`, `net.layer{i}.{j}.conv1/bn1/conv2/bn2/
downsample.{0,1}`, `proj_layers.{stage - 1}`.

BatchNorm always normalises with its running statistics, also under
`model.train()`: the reference calls the extractor in eval mode while its
BN scale and bias still train (`RunningStatsBatchNorm2d`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.image import resize_image

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
RESNET_LAYERS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}
WIDTHS = (64, 128, 256, 512)


class RunningStatsBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d that normalises with its running statistics in every mode
    and never updates them."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, momentum=0.0, eps=self.eps)


def _conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=bias)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3, stride)
        self.bn1 = RunningStatsBatchNorm2d(cout)
        self.conv2 = _conv(cout, cout, 3)
        self.bn2 = RunningStatsBatchNorm2d(cout)
        self.downsample = None
        if cin != cout or stride != 1:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride), RunningStatsBatchNorm2d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(y + res)


class ResNetTrunk(nn.Module):
    """torchvision's ResNet up to the last stage that is read."""

    def __init__(self, layers: Tuple[int, ...], max_stage: int):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = RunningStatsBatchNorm2d(64)
        cin = 64
        for li in range(1, max_stage + 1):
            blocks = []
            for bi in range(layers[li - 1]):
                stride = 2 if (bi == 0 and li > 1) else 1
                blocks.append(BasicBlock(cin, WIDTHS[li - 1], stride))
                cin = WIDTHS[li - 1]
            setattr(self, f"layer{li}", nn.Sequential(*blocks))


class ResNetFeatureExtractor(nn.Module):
    def __init__(
        self,
        name_arch: str = "resnet34",
        stages: Tuple[int, ...] = (1, 2, 3, 4),
        normalize_image: bool = True,
        image_rescale: float = 0.32,
        first_max_pool: bool = True,
        proj_dim: int = 16,
        l2_norm: bool = True,
        add_masks: bool = True,
        add_images: bool = True,
        feature_rescale: float = 1.0,
        dtype: str = "float32",
    ):
        super().__init__()
        if dtype != "float32":
            raise NotImplementedError(f"extractor dtype {dtype!r}: the port computes in float32")
        self.stages = tuple(stages)
        self.normalize_image = normalize_image
        self.image_rescale = image_rescale
        self.first_max_pool = first_max_pool
        self.proj_dim = proj_dim
        self.l2_norm = l2_norm
        self.add_masks = add_masks
        self.add_images = add_images
        self.feature_rescale = feature_rescale
        self.net = ResNetTrunk(RESNET_LAYERS[name_arch], max(self.stages))
        if proj_dim > 0:
            self.proj_layers = nn.ModuleDict(
                {str(li - 1): nn.Conv2d(WIDTHS[li - 1], proj_dim, 1) for li in self.stages})
        self.register_buffer("_mean", torch.tensor(IMAGENET_MEAN), persistent=False)
        self.register_buffer("_std", torch.tensor(IMAGENET_STD), persistent=False)

    def get_feat_dims(self) -> int:
        """Channels of the view sampler's concatenation of every entry."""
        return len(self.stages) * self.proj_dim + int(self.add_masks) + 3 * int(self.add_images)

    def forward(self, images: torch.Tensor, masks: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """images (B, H, W, 3) in [0, 1], masks (B, H, W, 1) -> {"images",
        "masks", "res_layer_{i}"} of (B, h, w, c) maps."""
        B, H, W, _ = images.shape
        out: Dict[str, torch.Tensor] = {}
        if self.add_images:
            out["images"] = images
        if self.add_masks and masks is not None:
            out["masks"] = masks
        x = images
        if self.image_rescale != 1.0:
            x = resize_image(x, int(H * self.image_rescale), int(W * self.image_rescale))
        if self.normalize_image:
            x = (x - self._mean) / self._std
        net = self.net
        x = F.relu(net.bn1(net.conv1(x.permute(0, 3, 1, 2))))
        if self.first_max_pool:
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        for li in range(1, max(self.stages) + 1):
            x = getattr(net, f"layer{li}")(x)
            if li in self.stages:
                f = self.proj_layers[str(li - 1)](x) if self.proj_dim > 0 else x
                f = f.permute(0, 2, 3, 1)
                if self.l2_norm:
                    f = f / torch.clamp(torch.linalg.norm(f, dim=-1, keepdim=True), min=1e-6)
                out[f"res_layer_{li}"] = f * self.feature_rescale
        return out
