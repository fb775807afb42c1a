"""The FID InceptionV3 feature extractor (port of
holo_diffusion_tpu/models/inception.py): torchvision's inception_v3 graph
with pytorch-fid's patches (every mixed block's average pool leaves the
padding out of its count, Mixed_7c's pool branch takes a max pool), up to
the 2048-d pool3 features, inference only.

Modules carry torchvision's names (`Mixed_5b.branch1x1.conv.weight`,
`...bn.running_mean`, ...), so a pytorch-fid `pt_inception` state_dict loads
with `load_state_dict`; its `fc.` and `AuxLogits.` keys are ignored.

Input: (B, H, W, 3) in [0, 1], resized to 299^2 inside as the JAX package
resizes (`jax.image.resize(..., "bilinear")`: half-pixel centres,
antialiased when it shrinks) and scaled to [-1, 1].
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.image import resize_bilinear_antialiased
from .feature_extractor import RunningStatsBatchNorm2d


def _avg_pool_3x3_s1_nopad(x: torch.Tensor) -> torch.Tensor:
    """3x3 average pool, stride 1, padding 1, over (B, C, H, W); an edge
    window divides by its count of valid taps, not 9."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class BasicConv2d(nn.Module):
    """conv without bias, BN (eps 1e-3) on its running statistics in every
    mode, ReLU: torchvision's BasicConv2d cell at inference."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = RunningStatsBatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_s1_nopad(x))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(_avg_pool_3x3_s1_nopad(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for layer in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = layer(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    """`use_max_pool`: Mixed_7c's pool branch takes a max pool (pytorch-fid
    FIDInceptionE_2, as the TF weights were trained)."""

    def __init__(self, cin: int, use_max_pool: bool = False):
        super().__init__()
        self.use_max_pool = use_max_pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        pooled = F.max_pool2d(x, 3, stride=1, padding=1) if self.use_max_pool else _avg_pool_3x3_s1_nopad(x)
        return torch.cat([b1, b3, bd, self.branch_pool(pooled)], 1)


class FIDInceptionV3(nn.Module):
    """images (B, H, W, 3) in [0, 1] -> (B, 2048) pool3 features."""

    def __init__(self, resize_input: bool = True, normalize_input: bool = True):
        super().__init__()
        self.resize_input = resize_input
        self.normalize_input = normalize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, use_max_pool=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        if self.resize_input and (H, W) != (299, 299):
            x = resize_bilinear_antialiased(x, 299, 299)
        if self.normalize_input:
            x = 2.0 * x - 1.0
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b,
                      self.Mixed_6c, self.Mixed_6d, self.Mixed_6e, self.Mixed_7a, self.Mixed_7b,
                      self.Mixed_7c):
            x = block(x)
        return torch.mean(x, dim=(2, 3))  # adaptive_avg_pool2d(1) -> 2048

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """A pytorch-fid / torchvision inception state_dict, without its
        `fc.` head and `AuxLogits.` tower (off the feature path); a missing
        BN `num_batches_tracked` counter reads as 0."""
        sd = {k: v for k, v in state_dict.items() if not k.startswith(("fc.", "AuxLogits."))}
        for k in self.state_dict():
            if k.endswith("num_batches_tracked"):
                sd.setdefault(k, torch.zeros((), dtype=torch.long))
        return super().load_state_dict(sd, strict=strict, assign=assign)


def random_inception(seed: int = 0) -> FIDInceptionV3:
    """FIDInceptionV3 with He-normal conv weights from a seeded torch
    generator and identity BN (the protocol smoke extractor
    `random_inception`)."""
    model = FIDInceptionV3()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, (2.0 / m.weight[0].numel()) ** 0.5, generator=gen)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model


_JAX_LEAF = {("conv", "kernel"): "conv.weight", ("bn", "scale"): "bn.weight", ("bn", "bias"): "bn.bias",
             ("bn", "mean"): "bn.running_mean", ("bn", "var"): "bn.running_var"}


def inception_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's FIDInceptionV3 variables ({"params": ...,
    "batch_stats": ...}, HWIO kernels) -> this module's state_dict (OIHW):
    the inverse of the JAX package's `inception_params_from_torch`."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree, path: Tuple[str, ...]):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            arr = np.asarray(v, np.float32)
            if k == "kernel":
                arr = arr.transpose(3, 2, 0, 1)
            sd[".".join(path[:-1] + (_JAX_LEAF[(path[-1], k)],))] = torch.from_numpy(arr.copy())

    walk(variables["params"], ())
    walk(variables["batch_stats"], ())
    return sd
