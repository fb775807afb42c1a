"""LPIPS perceptual metric on a VGG16 trunk (port of
holo_diffusion_tpu/models/lpips.py).

`VGG16Features` is torchvision's `vgg16().features` in its own sequential
layout (`{idx}.weight`, `{idx}.bias`), so a torchvision state_dict loads with
`load_state_dict` and no renaming. `LPIPS` is the lpips package's v0.1 "vgg"
head over its five taps: unit-normalise the channels, square the
difference, weight the channels by |lin_k| and sum them, average over the
image, sum over the taps. Published weights are read only from paths the
caller gives (`load_lpips_from_torch_files`); with no LPIPS head file the
head weights are all ones, as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..device import DeviceLike, place

# torchvision vgg16.features: conv widths and 2x2 max pools ("M")
VGG16_CHANNELS: Sequence = (64, 64, "M", 128, 128, "M", 256, 256, 256,
                            "M", 512, 512, 512, "M", 512, 512, 512)
TAPS_AFTER_CONV = (1, 3, 6, 9, 12)  # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
TAP_DIMS = (64, 128, 256, 512, 512)

# LPIPS input normalisation (lpips.ScalingLayer), inputs in [-1, 1]
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _conv_sequence_indices() -> List[int]:
    """The sequential index of each conv in torchvision's features stack
    (a conv and its ReLU take two places, a pool one)."""
    idx, pos = [], 0
    for spec in VGG16_CHANNELS:
        if spec == "M":
            pos += 1
        else:
            idx.append(pos)
            pos += 2
    return idx


class VGG16Features(nn.Sequential):
    """VGG16's conv trunk: (B, H, W, 3) channels-last -> the five LPIPS taps
    (after conv 1, 3, 6, 9 and 12), each (B, h, w, C) channels-last."""

    def __init__(self):
        layers: List[nn.Module] = []
        cin = 3
        for spec in VGG16_CHANNELS:
            if spec == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, spec, 3, padding=1), nn.ReLU()]
                cin = spec
        super().__init__(*layers)

    def taps_nchw(self, x: torch.Tensor) -> List[torch.Tensor]:
        """(B, 3, H, W) -> the five taps, channels first."""
        taps = []
        conv_i = -1
        for layer in self:
            x = layer(x)
            if isinstance(layer, nn.Conv2d):
                conv_i += 1
            elif isinstance(layer, nn.ReLU) and conv_i in TAPS_AFTER_CONV:
                taps.append(x)
        return taps

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [t.permute(0, 2, 3, 1) for t in self.taps_nchw(x.permute(0, 3, 1, 2))]


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Unit length along the channel axis (1) of NCHW."""
    return x / torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + eps)


class LPIPS(nn.Module):
    """lpips(a, b): images (B, H, W, 3) in [0, 1] -> (B,) distances."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, c in enumerate(TAP_DIMS):
            setattr(self, f"lin{i}", nn.Parameter(torch.ones(c)))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.from_numpy(_SCALE).view(1, 3, 1, 1), persistent=False)

    def _prep(self, x: torch.Tensor) -> torch.Tensor:
        x = 2.0 * x.permute(0, 3, 1, 2) - 1.0  # [0, 1] -> [-1, 1] (lpips normalize=True)
        return (x - self.shift) / self.scale

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        B = a.shape[0]
        taps = self.vgg.taps_nchw(torch.cat([self._prep(a), self._prep(b)]))
        total = 0.0
        for i, f in enumerate(taps):
            d = (_unit_normalize(f[:B]) - _unit_normalize(f[B:])) ** 2
            # the "lin" head: a 1x1 conv without bias, non-negative weights
            w = torch.abs(getattr(self, f"lin{i}")).view(1, -1, 1, 1)
            total = total + torch.mean(torch.sum(d * w, dim=1), dim=(-2, -1))
        return total


def features_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A torchvision vgg16 state_dict's `features.` part, or the dict itself
    when its keys are bare (`{idx}.weight`)."""
    feats = {k[len("features."):]: v for k, v in sd.items() if k.startswith("features.")}
    return feats or sd


def load_lpips_model(vgg_path: str, lin_path: Optional[str] = None) -> LPIPS:
    """LPIPS on the CPU from torch files: `vgg_path` a torchvision vgg16
    state_dict (`features.{i}.weight` or bare `{i}.weight`); `lin_path` an
    lpips-package head state_dict (`lin{k}.model.1.weight`), or all-ones
    heads without one."""
    model = LPIPS()
    sd = torch.load(vgg_path, map_location="cpu", weights_only=True)
    model.vgg.load_state_dict(features_state_dict(sd))
    if lin_path:
        lin_sd = torch.load(lin_path, map_location="cpu", weights_only=True)
        with torch.no_grad():
            for i in range(len(TAP_DIMS)):
                getattr(model, f"lin{i}").copy_(lin_sd[f"lin{i}.model.1.weight"].reshape(-1))
    return model


def load_lpips_from_torch_files(vgg_path: str, lin_path: Optional[str] = None,
                                device: DeviceLike = None) -> Callable[[np.ndarray, np.ndarray], float]:
    """The perceptual fn (`make_lpips_fn`) of LPIPS read from torch files
    (`load_lpips_model`), on `device` (CUDA unless the caller passes "cpu")."""
    return make_lpips_fn(load_lpips_model(vgg_path, lin_path), device)


def make_lpips_fn(model: LPIPS, device: DeviceLike = None) -> Callable[[np.ndarray, np.ndarray], float]:
    """lpips(a, b) over (H, W, 3) numpy images in [0, 1] -> a Python float;
    the model moves to `device` (CUDA unless the caller passes "cpu")."""
    dev = place(model, device)
    model.eval()

    @torch.no_grad()
    def fn(a: np.ndarray, b: np.ndarray) -> float:
        ta = torch.as_tensor(np.asarray(a, np.float32), device=dev)[None]
        tb = torch.as_tensor(np.asarray(b, np.float32), device=dev)[None]
        return float(model(ta, tb)[0])

    return fn


def lpips_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's LPIPS variables ({"params": {"vgg": {"conv{i}":
    {"kernel" HWIO, "bias"}}, "lin{k}": (C,)}}) -> this LPIPS's state_dict
    (OIHW kernels at torchvision's sequential indices): the inverse of the
    JAX package's `lpips_params_from_torch`."""
    params = variables["params"]
    sd = {}
    for ci, si in enumerate(_conv_sequence_indices()):
        conv = params["vgg"][f"conv{ci}"]
        sd[f"vgg.{si}.weight"] = torch.from_numpy(np.asarray(conv["kernel"], np.float32).transpose(3, 2, 0, 1).copy())
        sd[f"vgg.{si}.bias"] = torch.from_numpy(np.asarray(conv["bias"], np.float32).copy())
    for i in range(len(TAP_DIMS)):
        sd[f"lin{i}"] = torch.from_numpy(np.asarray(params[f"lin{i}"], np.float32).reshape(-1).copy())
    return sd


def random_vgg_features(seed: int = 0) -> VGG16Features:
    """A VGG16 trunk with He-normal weights and zero biases from a seeded
    torch generator (the protocol smoke extractor `random_vgg`)."""
    model = VGG16Features()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=gen)
                m.bias.zero_()
    return model
