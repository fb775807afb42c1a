"""Weights for the port's `HoloDiffusionModel`: conversion from the JAX
model's parameters, a seeded initialisation, and `.npz` load/save.

The port's parameter names are the reference torch names
(`net_3d.input_blocks.1.0.in_layers.2.weight`,
`implicit_function.render_mlp._density_net.mlp.0.0.weight`, ...), so a
reference state_dict loads as it is; `state_dict_from_jax` is the inverse of
holo_diffusion_tpu/utils/torch_import.py:40-184.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

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


def state_dict_from_jax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX model params flattened with '/' separators (as
    `flax.traverse_util.flatten_dict(params, sep="/")` gives, without the
    top-level "params") -> the port's state_dict for `net_3d` and
    `implicit_function`. Conv kernels go DHWIO -> OIDHW, dense kernels
    (in, out) -> Linear (out, in) or Conv1d (out, in, 1) for attention's qkv
    and proj_out, GroupNorm scale -> weight."""
    out: Dict[str, torch.Tensor] = {}
    keys = list(flat)
    for key, value in flat.items():
        module, leaf = key.rsplit("/", 1)
        value = np.asarray(value)
        if module.startswith("net_3d/"):
            tpath, conv1d = _unet_key(module[len("net_3d/"):], keys)
            tkey = f"net_3d.{tpath}.{_LEAF[leaf]}"
        else:
            m = re.fullmatch(r"implicit_function/render_mlp/(_\w+_net)/linear_(\d+)", module)
            if m is None:
                raise KeyError(f"parameter {key} has no counterpart in the port")
            net, li = m.groups()
            tkey, conv1d = f"implicit_function.render_mlp.{net}.mlp.{li}.0.{_LEAF[leaf]}", False
        out[tkey] = torch.tensor(_convert_leaf(leaf, value, conv1d))
    return out


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded initialisation as the JAX model's: xavier-uniform kernels, zero
    biases, unit GroupNorm scales. Drawn on the CPU, so a seed gives the same
    weights on every device."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif p.ndim == 1:  # GroupNorm weight
            p.fill_(1.0)
        else:
            receptive = int(np.prod(p.shape[2:])) if p.ndim > 2 else 1
            fan_in, fan_out = p.shape[1] * receptive, p.shape[0] * receptive
            bound = (6.0 / (fan_in + fan_out)) ** 0.5
            w = torch.rand(p.shape, generator=gen) * (2 * bound) - bound
            p.copy_(w)
    return model


def load_weights(model: nn.Module, path: str) -> nn.Module:
    """Load an `.npz` of the port's state_dict (strict)."""
    with np.load(path) as z:
        sd = {k: torch.from_numpy(z[k]) for k in z.files}
    model.load_state_dict(sd, strict=True)
    return model


def save_weights(model: nn.Module, path: str) -> None:
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in model.state_dict().items()})
