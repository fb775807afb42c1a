"""Weights for the port's `HoloDiffusionModel`: conversion from the JAX
model's variables and from a reference state_dict, a seeded initialisation,
and `.npz` load/save.

The port's parameter names are the reference torch names
(`net_3d.input_blocks.1.0.in_layers.2.weight`,
`implicit_function.render_mlp._density_net.mlp.0.0.weight`,
`image_feature_extractor.net.layer1.0.bn1.weight`,
`view_pooler.feature_aggregator._first_sampled.weight`, ...), except that the
reference nests the UNet as `net_3d._net` and the decoder as
`_implicit_functions.0._fn` (`state_dict_from_reference` renames those).
`state_dict_from_jax` is the inverse of
holo_diffusion_tpu/utils/torch_import.py.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

# JAX ResBlock3D submodule -> reference ResBlock layer
_RES_PARTS = {
    "in_gn/gn": "in_layers.0",
    "in_conv": "in_layers.2",
    "emb_dense": "emb_layers.1",
    "out_gn/gn": "out_layers.0",
    "out_conv": "out_layers.3",
    "skip_conv": "skip_connection",
}
_ATTN_PARTS = {"gn/gn": "norm", "qkv": "qkv", "proj": "proj_out"}
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _convert_leaf(leaf: str, value: np.ndarray, conv1d: bool) -> np.ndarray:
    if leaf != "kernel":
        return value
    if value.ndim == 5:  # conv DHWIO -> OIDHW
        return np.transpose(value, (4, 3, 0, 1, 2))
    if value.ndim == 4:  # conv HWIO -> OIHW
        return np.transpose(value, (3, 2, 0, 1))
    if value.ndim == 2:  # dense (in, out) -> Linear (out, in) / Conv1d (out, in, 1)
        return value.T[..., None] if conv1d else value.T
    raise ValueError(f"unexpected kernel rank {value.ndim}")


def _unet_key(path: str, flat_keys) -> tuple:
    """JAX `net_3d/...` module path (without the leaf) -> (torch module path,
    is_conv1d)."""
    fixed = {
        "time_dense_0": "time_embed.0",
        "time_dense_1": "time_embed.2",
        "in_conv": "input_blocks.0.0",
        "out_gn/gn": "out.0",
        "out_conv": "out.2",
    }
    if path in fixed:
        return fixed[path], False
    m = re.fullmatch(r"(input|output)_(\d+)_(res|attn|down|up)/(.+)", path)
    mm = re.fullmatch(r"middle_(res_0|attn|res_1)/(.+)", path)
    if m:
        side, idx, kind, rest = m.groups()
        base = f"{side}_blocks.{idx}"
        if kind == "res":
            return f"{base}.0.{_RES_PARTS[rest]}", False
        if kind == "attn":
            return f"{base}.1.{_ATTN_PARTS[rest]}", True
        if kind == "down":
            return f"{base}.0.op", False
        # up: after the res block and, when present, the attention block
        has_attn = any(k.startswith(f"net_3d/output_{idx}_attn/") for k in flat_keys)
        return f"{base}.{2 if has_attn else 1}.conv", False
    if mm:
        kind, rest = mm.groups()
        if kind == "attn":
            return f"middle_block.1.{_ATTN_PARTS[rest]}", True
        return f"middle_block.{0 if kind == 'res_0' else 2}.{_RES_PARTS[rest]}", False
    raise KeyError(f"unknown UNet parameter path net_3d/{path}")


# JAX extractor block part -> torchvision name
_BLOCK_PARTS = {"conv1": "conv1", "conv2": "conv2", "bn1": "bn1", "bn2": "bn2",
                "down_conv": "downsample.0", "down_bn": "downsample.1"}
_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _extractor_key(path: str) -> str:
    """JAX `feature_extractor/...` module path -> the port's module path."""
    if path == "stem_conv":
        return "image_feature_extractor.net.conv1"
    if path == "stem_bn":
        return "image_feature_extractor.net.bn1"
    m = re.fullmatch(r"layer(\d+)_block(\d+)/(\w+)", path)
    if m:
        li, bi, part = m.groups()
        return f"image_feature_extractor.net.layer{li}.{bi}.{_BLOCK_PARTS[part]}"
    m = re.fullmatch(r"proj_layer(\d+)", path)
    if m:
        return f"image_feature_extractor.proj_layers.{int(m.group(1)) - 1}"
    raise KeyError(f"unknown extractor parameter path feature_extractor/{path}")


def _module_key(module: str, flat_keys) -> tuple:
    """JAX module path -> (the port's module path, is_conv1d): a dense kernel
    of attention's qkv/proj_out becomes a Conv1d weight."""
    if module.startswith("net_3d/"):
        tpath, conv1d = _unet_key(module[len("net_3d/"):], flat_keys)
        return f"net_3d.{tpath}", conv1d
    if module.startswith("feature_extractor/"):
        return _extractor_key(module[len("feature_extractor/"):]), False
    if module == "pooled_feature_mapper":
        return module, False
    m = re.fullmatch(r"view_pooler/aggregator/(first_sampled|first_mean|last|mlp/linear_(\d+))", module)
    if m:
        name = m.group(1)
        tail = f"_mlp.mlp.{m.group(2)}.0" if m.group(2) is not None else f"_{name}"
        return f"view_pooler.feature_aggregator.{tail}", False
    m = re.fullmatch(r"implicit_function/render_mlp/(_\w+_net)/linear_(\d+)", module)
    if m:
        net, li = m.groups()
        return f"implicit_function.render_mlp.{net}.mlp.{li}.0", False
    raise KeyError(f"parameter {module} has no counterpart in the port")


def state_dict_from_jax(
    flat: Mapping[str, np.ndarray], batch_stats: Optional[Mapping[str, np.ndarray]] = None
) -> Dict[str, torch.Tensor]:
    """JAX model params flattened with '/' separators (as
    `flax.traverse_util.flatten_dict(params, sep="/")` gives, without the
    top-level "params"), and the flattened `batch_stats` of the extractor's
    BatchNorms when the model has one -> the port's state_dict. Conv kernels
    go DHWIO -> OIDHW and HWIO -> OIHW, dense kernels (in, out) -> Linear
    (out, in) or Conv1d (out, in, 1) for attention's qkv and proj_out,
    GroupNorm and BatchNorm scale -> weight, BN mean/var -> running_mean/var
    (with a zero `num_batches_tracked`)."""
    out: Dict[str, torch.Tensor] = {}
    keys = list(flat)
    for key, value in flat.items():
        module, leaf = key.rsplit("/", 1)
        tpath, conv1d = _module_key(module, keys)
        out[f"{tpath}.{_LEAF[leaf]}"] = torch.tensor(_convert_leaf(leaf, np.asarray(value), conv1d))
    for key, value in (batch_stats or {}).items():
        module, leaf = key.rsplit("/", 1)
        tpath, _ = _module_key(module, keys)
        out[f"{tpath}.{_BN_STATS[leaf]}"] = torch.tensor(np.asarray(value))
        out[f"{tpath}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return out


def state_dict_from_reference(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A reference HoloDiffusionModel state_dict -> the port's: `net_3d._net.`
    becomes `net_3d.`, `_implicit_functions.0._fn.` becomes
    `implicit_function.`; the harmonic embeddings' `_frequencies` (computed,
    not stored, in the port) are dropped."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if k.endswith("._frequencies"):
            continue
        k = re.sub(r"^net_3d\._net\.", "net_3d.", k)
        k = re.sub(r"^_implicit_functions\.0\._fn\.", "implicit_function.", k)
        out[k] = torch.as_tensor(np.asarray(v))
    return out


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded initialisation as the JAX model's initialisers: 2D convolutions
    (the image extractor) lecun-normal (flax's default, a truncated normal of
    variance 1 / fan_in), every other kernel xavier-uniform, biases 0,
    GroupNorm and BatchNorm scales 1, BN statistics mean 0 and var 1. Drawn
    on the CPU, so a seed gives the same weights on every device."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        for pname, p in mod.named_parameters(recurse=False):
            if pname == "bias":
                p.zero_()
            elif p.ndim == 1:  # GroupNorm / BatchNorm weight
                p.fill_(1.0)
            elif isinstance(mod, nn.Conv2d):
                # truncated to +-2 std, rescaled to keep the variance (flax's
                # variance_scaling "truncated_normal")
                std = (1.0 / (p.shape[1] * p.shape[2] * p.shape[3])) ** 0.5 / 0.87962566103423978
                w = torch.empty(p.shape)
                torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
                p.copy_(w * std)
            else:
                receptive = int(np.prod(p.shape[2:])) if p.ndim > 2 else 1
                fan_in, fan_out = p.shape[1] * receptive, p.shape[0] * receptive
                bound = (6.0 / (fan_in + fan_out)) ** 0.5
                p.copy_(torch.rand(p.shape, generator=gen) * (2 * bound) - bound)
        if isinstance(mod, nn.BatchNorm2d):
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    return model


def load_weights(model: nn.Module, path: str) -> nn.Module:
    """Load an `.npz` of the port's state_dict (strict)."""
    with np.load(path) as z:
        sd = {k: torch.from_numpy(z[k]) for k in z.files}
    model.load_state_dict(sd, strict=True)
    return model


def save_weights(model: nn.Module, path: str) -> None:
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in model.state_dict().items()})
