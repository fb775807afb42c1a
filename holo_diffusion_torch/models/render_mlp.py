"""RenderMLP — the voxel-feature decoder (port of
holo_diffusion_tpu/models/render_mlp.py; reference
holo_voxel_grid_implicit_function.py:48-145).

Density net (4 layers, hidden 256, skip at 2) outputs [hidden | density]
(the raymarcher applies ReLU to the density); the radiance net (1 layer)
maps [hidden | harmonic(view_dir)] to sigmoid RGB. The port renders colour
only: HoloDiffusion builds its decoder with no view-independent feature
head (holo_diffusion_model.py:157), so that head is not ported.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..geometry.harmonic import HarmonicEmbedding
from .mlp import _HIDDEN_ACTS, MLPWithInputSkips

COLOUR_DIMS = 3


class RenderMLP(nn.Module):
    def __init__(
        self,
        input_dims: int = 128,
        feat_emb_dims: int = 0,
        dir_emb_dims: int = 4,
        dnet_num_layers: int = 4,
        dnet_hidden_dim: int = 256,
        dnet_input_skips: Tuple[int, ...] = (2,),
        rnet_num_layers: int = 1,
        rnet_hidden_dim: int = 128,
        rnet_input_skips: Tuple[int, ...] = (),
        activation_fn: str = "LEAKYRELU",
    ):
        super().__init__()
        self.input_dims = input_dims
        self.feat_emb_dims = feat_emb_dims
        self.dnet_num_layers = dnet_num_layers
        self.dnet_hidden_dim = dnet_hidden_dim
        self.dnet_input_skips = tuple(dnet_input_skips)
        self.rnet_num_layers = rnet_num_layers
        self.rnet_input_skips = tuple(rnet_input_skips)
        self.activation_fn = activation_fn

        self._feats_encoder = HarmonicEmbedding(feat_emb_dims)
        self._dir_encoder = HarmonicEmbedding(dir_emb_dims)
        d_feat = self._feats_encoder.get_output_dim(input_dims)
        d_dir = self._dir_encoder.get_output_dim(3)
        self._density_net = MLPWithInputSkips(
            n_layers=dnet_num_layers,
            input_dim=d_feat,
            output_dim=dnet_hidden_dim + 1,
            skip_dim=d_feat,
            hidden_dim=dnet_hidden_dim,
            input_skips=dnet_input_skips,
            hidden_activation=activation_fn,
            last_activation="IDENTITY",
        )
        self._radiance_net = MLPWithInputSkips(
            n_layers=rnet_num_layers,
            input_dim=dnet_hidden_dim + d_dir,
            output_dim=COLOUR_DIMS,
            skip_dim=dnet_hidden_dim + d_dir,
            hidden_dim=rnet_hidden_dim,
            input_skips=rnet_input_skips,
            hidden_activation=activation_fn,
            last_activation="IDENTITY",
        )

    def forward(self, features: torch.Tensor, view_dirs: torch.Tensor):
        """Layer-by-layer decode: features (..., input_dims), view_dirs (..., 3)
        unit vectors -> (densities (..., 1), rgb (..., 3))."""
        return self._decode_tail(self._density_net(self._feats_encoder(features)), view_dirs)

    def _decode_tail(self, out: torch.Tensor, view_dirs: torch.Tensor):
        """Everything after the density net: split [hidden | density], run
        the radiance head -> (densities (..., 1), rgb (..., 3))."""
        mlp_feats, densities = out[..., :-1], out[..., -1:]
        radiance = self._radiance_net(
            torch.cat([mlp_feats, self._dir_encoder(view_dirs)], dim=-1)
        )
        return densities, torch.sigmoid(radiance)

    def density(self, features: torch.Tensor) -> torch.Tensor:
        """The density head alone (..., 1): what the normals differentiate
        when the density net is not collapsible."""
        return self._density_net(self._feats_encoder(features))[..., -1:]

    def decode_from_preactivation(self, pre: torch.Tensor, view_dirs: torch.Tensor):
        """Decode from the pre-activations `s @ A + c` of `density_affine`:
        the density net's output activation, then the radiance head."""
        return self._decode_tail(_HIDDEN_ACTS[self._density_net.hidden_activation](pre), view_dirs)

    @property
    def density_net_is_collapsible(self) -> bool:
        """True when the density net is an affine map of the raw features
        followed by one activation: no feature encoding (the reference
        activation order with last_activation IDENTITY makes layers 0..n-2
        linear)."""
        return self.feat_emb_dims == 0

    def density_affine(self):
        """Collapse the linear cascade into one affine map:
        density_net(s) == hidden_act(s @ A + c), A (input_dims, hidden+1)."""
        assert self.density_net_is_collapsible
        d_in = self.input_dims
        w0 = self._density_net.linear(0).weight
        eye = torch.eye(d_in, dtype=w0.dtype, device=w0.device)
        A = eye
        c = torch.zeros((1, d_in), dtype=w0.dtype, device=w0.device)
        for li in range(self.dnet_num_layers):
            if li > 0 and li in self.dnet_input_skips:
                A = torch.cat([A, eye], dim=1)
                c = torch.cat([c, torch.zeros((1, d_in), dtype=c.dtype, device=c.device)], dim=1)
            lin = self._density_net.linear(li)
            K = lin.weight.t()
            A = A @ K
            c = c @ K + lin.bias[None]
        return A, c[0]

    @property
    def decode_is_fusable(self) -> bool:
        """True when the whole decode has the fused kernel's shape: collapsible
        density net and one LEAKYRELU radiance layer to sigmoid RGB — the
        release config."""
        return (
            self.density_net_is_collapsible
            and self.rnet_num_layers == 1
            and self.rnet_input_skips == ()
            and self.activation_fn == "LEAKYRELU"
        )

    def encode_dirs(self, view_dirs: torch.Tensor) -> torch.Tensor:
        return self._dir_encoder(view_dirs)

    @property
    def pe_dim(self) -> int:
        """Width of `encode_dirs`' output: the radiance layer's extra inputs."""
        return self._dir_encoder.get_output_dim(3)

    def radiance_linear(self):
        """(kernel (hidden + pe_dim, 3), bias (3,)) of the radiance layer."""
        lin = self._radiance_net.linear(0)
        return lin.weight.t(), lin.bias
