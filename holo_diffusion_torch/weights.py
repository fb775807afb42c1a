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

from .models.feature_extractor import ResNetFeatureExtractor
from .models.unet3d import zero_init_

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
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias", "embedding": "weight",
         "positional_embedding": "positional_embedding"}


def _convert_leaf(leaf: str, value: np.ndarray, dense_dims: int) -> np.ndarray:
    """A JAX leaf -> the torch tensor's layout. `dense_dims`: the number of
    trailing unit axes a dense kernel takes as the weight of a 1x..x1 conv
    (0 for a Linear)."""
    if leaf == "positional_embedding":  # (T + 1, C) -> the reference's (C, T + 1)
        return value.T
    if leaf != "kernel":
        return value
    if value.ndim == 2:  # dense (in, out) -> Linear (out, in) or a 1x..x1 conv
        return value.T.reshape(value.shape[1], value.shape[0], *([1] * dense_dims))
    if 3 <= value.ndim <= 5:  # conv (*spatial, I, O) -> (O, I, *spatial)
        return np.transpose(value, (value.ndim - 1, value.ndim - 2, *range(value.ndim - 2)))
    raise ValueError(f"unexpected kernel rank {value.ndim}")


def _split(key: str) -> tuple:
    module, _, leaf = key.rpartition("/")
    return module, leaf


def _unet_key(path: str, modules, dims: int = 3) -> tuple:
    """A module path of the JAX UNet family (UNetModel3D, EncoderUNetModel,
    AsymmetricUNetModel) without the leaf -> (torch module path, dense_dims).
    `modules`: every module path of that model, which places an output
    block's attention and upsampling after its ResBlocks."""
    fixed = {
        "time_dense_0": ("time_embed.0", 0),
        "time_dense_1": ("time_embed.2", 0),
        "label_emb": ("label_emb", 0),
        "in_conv": ("input_blocks.0.0", 0),
        "out_gn/gn": ("out.0", 0),
        "out_conv": ("out.2", 0),
        # the encoder's heads, in the reference's `out` sequentials
        "out_dense": ("out.3", dims),
        "attn_pool": ("out.2", 0),
        "attn_pool/qkv_proj": ("out.2.qkv_proj", 1),
        "attn_pool/c_proj": ("out.2.c_proj", 1),
        "spatial_dense_0": ("out.0", 0),
        "spatial_dense_1": ("out.2", 0),
    }
    if path in fixed:
        return fixed[path]
    m = re.fullmatch(r"(input|output)_(\d+)_(res\d*|attn|down|up)/(.+)", path)
    mm = re.fullmatch(r"middle_(res_0|attn|res_1)/(.+)", path)
    if m:
        side, idx, kind, rest = m.groups()
        base = f"{side}_blocks.{idx}"
        if kind.startswith("res"):
            return f"{base}.{int(kind[3:] or 0)}.{_RES_PARTS[rest]}", 0
        if kind == "down":
            return f"{base}.0.op", 0
        # attention after the block's ResBlocks, upsampling after both
        blocks = {re.match(r"[a-z]+_\d+_(\w+)/", p + "/").group(1) for p in modules
                  if p.startswith(f"{side}_{idx}_")}
        n_res = sum(b.startswith("res") for b in blocks)
        if kind == "attn":
            return f"{base}.{n_res}.{_ATTN_PARTS[rest]}", 1
        return f"{base}.{n_res + ('attn' in blocks)}.conv", 0
    if mm:
        kind, rest = mm.groups()
        if kind == "attn":
            return f"middle_block.1.{_ATTN_PARTS[rest]}", 1
        return f"middle_block.{0 if kind == 'res_0' else 2}.{_RES_PARTS[rest]}", 0
    raise KeyError(f"unknown UNet parameter path {path}")


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


def _module_key(module: str, modules) -> tuple:
    """A HoloDiffusionModel's JAX module path -> (the port's module path,
    dense_dims): a dense kernel of attention's qkv/proj_out becomes a Conv1d
    weight."""
    if module.startswith("net_3d/"):
        tpath, dense_dims = _unet_key(module[len("net_3d/"):], [p[len("net_3d/"):] for p in modules])
        return f"net_3d.{tpath}", dense_dims
    if module.startswith("feature_extractor/"):
        return _extractor_key(module[len("feature_extractor/"):]), 0
    if module == "pooled_feature_mapper":
        return module, 0
    m = re.fullmatch(r"view_pooler/aggregator/(first_sampled|first_mean|last|mlp/linear_(\d+))", module)
    if m:
        name = m.group(1)
        tail = f"_mlp.mlp.{m.group(2)}.0" if m.group(2) is not None else f"_{name}"
        return f"view_pooler.feature_aggregator.{tail}", 0
    m = re.fullmatch(r"implicit_function/render_mlp/(_\w+_net)/linear_(\d+)", module)
    if m:
        net, li = m.groups()
        return f"implicit_function.render_mlp.{net}.mlp.{li}.0", 0
    raise KeyError(f"parameter {module} has no counterpart in the port")


_KINDS = ("holo", "unet", "res_block", "attention", "attention_pool")
_BLOCK_PARTS_OF = {"res_block": (_RES_PARTS, 0), "attention": (_ATTN_PARTS, 1),
                   "attention_pool": ({"": "", "qkv_proj": "qkv_proj", "c_proj": "c_proj"}, 1)}


def _key_fn(kind: str, flat: Mapping[str, np.ndarray]):
    """JAX module path -> (the port's module path, dense_dims) for a JAX
    model of `kind` (see `state_dict_from_jax`)."""
    modules = [_split(k)[0] for k in flat]
    if kind == "holo":
        return lambda module: _module_key(module, modules)
    if kind == "unet":
        # SuperResModel nests its UNet as `unet`; the port's subclasses it
        def strip(p):
            return p[len("unet/"):] if p.startswith("unet/") else p

        rel = [strip(p) for p in modules]
        conv_in = [np.ndim(v) for k, v in flat.items() if strip(k) == "in_conv/kernel"]
        dims = conv_in[0] - 2 if conv_in else 3
        return lambda module: _unet_key(strip(module), rel, dims)
    if kind not in _BLOCK_PARTS_OF:
        raise ValueError(f"unknown kind {kind!r}: one of {_KINDS}")
    parts, dense_dims = _BLOCK_PARTS_OF[kind]
    return lambda module: (parts[module], dense_dims if module else 0)


def state_dict_from_jax(
    flat: Mapping[str, np.ndarray], batch_stats: Optional[Mapping[str, np.ndarray]] = None,
    kind: str = "holo",
) -> Dict[str, torch.Tensor]:
    """JAX model params flattened with '/' separators (as
    `flax.traverse_util.flatten_dict(params, sep="/")` gives, without the
    top-level "params"), and the flattened `batch_stats` of the extractor's
    BatchNorms when the model has one -> the port's state_dict. Conv kernels
    go (*spatial, I, O) -> (O, I, *spatial), dense kernels (in, out) ->
    Linear (out, in), or Conv1d (out, in, 1) for attention's qkv and
    proj_out, GroupNorm and BatchNorm scale -> weight, embeddings ->
    weight, an attention pool's positional embedding (T + 1, C) -> (C, T + 1),
    BN mean/var -> running_mean/var (with a zero `num_batches_tracked`).

    `kind` names the JAX model: "holo" a HoloDiffusionModel; "unet" a
    UNetModel3D, SuperResModel, EncoderUNetModel or AsymmetricUNetModel;
    "res_block" a ResBlock3D or ResBlockGigaGAN alone; "attention" an
    AttentionBlock3D or QKVLocalAttention alone; "attention_pool" an
    AttentionPool2d alone."""
    key_of = _key_fn(kind, flat)
    out: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        module, leaf = _split(key)
        tpath, dense_dims = key_of(module)
        name = f"{tpath}.{_LEAF[leaf]}" if tpath else _LEAF[leaf]
        out[name] = torch.tensor(_convert_leaf(leaf, np.asarray(value), dense_dims))
    for key, value in (batch_stats or {}).items():
        module, leaf = _split(key)
        tpath, _ = key_of(module)
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


_TORCHVISION_SKIP = re.compile(r"^fc\.")


def load_resnet_state_dict(extractor: ResNetFeatureExtractor, sd: Mapping[str, torch.Tensor]) -> None:
    """A torchvision resnet18/34 state_dict (conv1, bn1, layer{i}.{j}.conv1/
    bn1/conv2/bn2/downsample.{0,1}, fc) into the extractor's trunk
    (`extractor.net`, torchvision's names; JAX
    utils/torch_import.py:convert_resnet_state_dict): `fc` and the layers
    past the last stage read are left out; every other key must match, else
    KeyError naming each missing and unexpected key. The projections
    (`proj_layers`) are not torchvision's and keep their values."""
    last = max(extractor.stages)
    keep = {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()
            if not _TORCHVISION_SKIP.match(k)
            and not (k.startswith("layer") and int(k[len("layer")]) > last)}
    load_strict(extractor.net, keep, what="torchvision ResNet state_dict")


def check_keys(model: nn.Module, keys, what: str = "state_dict") -> None:
    """Raise KeyError naming every key of `model`'s state_dict that `keys`
    lacks and every key of `keys` it does not have."""
    own = model.state_dict().keys()
    missing, unexpected = sorted(own - set(keys)), sorted(set(keys) - own)
    if missing or unexpected:
        raise KeyError(f"{what} does not match the model: missing {missing}, unexpected {unexpected}")


def load_strict(model: nn.Module, sd: Mapping[str, torch.Tensor], what: str = "state_dict") -> None:
    """`model.load_state_dict(sd)` after `check_keys`."""
    check_keys(model, sd.keys(), what)
    model.load_state_dict(sd, strict=True)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded initialisation as the JAX model's initialisers: the image
    extractor's 2D convolutions lecun-normal (flax's default, a truncated
    normal of variance 1 / fan_in), embeddings normal of variance
    1 / features (flax's `nn.Embed`), every other kernel xavier-uniform,
    biases 0, GroupNorm and BatchNorm scales 1, BN statistics mean 0 and var
    1; then the zero initialisers the modules name (`simple_init=False`,
    `zero_last_conv`, the local attention's projection; unet3d.zero_init_).
    Drawn on the CPU, so a seed gives the same weights on every device."""
    gen = torch.Generator().manual_seed(seed)
    lecun = {id(m) for fe in model.modules() if isinstance(fe, ResNetFeatureExtractor)
             for m in fe.modules() if isinstance(m, nn.Conv2d)}
    for mod in model.modules():
        for pname, p in mod.named_parameters(recurse=False):
            if pname == "bias":
                p.zero_()
            elif p.ndim == 1:  # GroupNorm / BatchNorm weight
                p.fill_(1.0)
            elif id(mod) in lecun:
                # truncated to +-2 std, rescaled to keep the variance (flax's
                # variance_scaling "truncated_normal")
                std = (1.0 / (p.shape[1] * p.shape[2] * p.shape[3])) ** 0.5 / 0.87962566103423978
                w = torch.empty(p.shape)
                torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
                p.copy_(w * std)
            elif isinstance(mod, nn.Embedding):
                p.copy_(torch.randn(p.shape, generator=gen) / p.shape[1] ** 0.5)
            else:
                receptive = int(np.prod(p.shape[2:])) if p.ndim > 2 else 1
                fan_in, fan_out = p.shape[1] * receptive, p.shape[0] * receptive
                bound = (6.0 / (fan_in + fan_out)) ** 0.5
                p.copy_(torch.rand(p.shape, generator=gen) * (2 * bound) - bound)
        if isinstance(mod, nn.BatchNorm2d):
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    return zero_init_(model)


def load_weights(model: nn.Module, path: str) -> nn.Module:
    """Load an `.npz` of the port's state_dict (strict)."""
    with np.load(path) as z:
        sd = {k: torch.from_numpy(z[k]) for k in z.files}
    model.load_state_dict(sd, strict=True)
    return model


def save_weights(model: nn.Module, path: str) -> None:
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in model.state_dict().items()})
