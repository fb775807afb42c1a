"""MLPWithInputSkips (port of holo_diffusion_tpu/models/mlp.py; reference
custom_modules.py:44-160).

The reference swaps the activation branches relative to upstream pytorch3d:
the LAST layer gets `hidden_activation` and every earlier layer gets
`last_activation`. With the RenderMLP's settings (hidden=LEAKYRELU,
last=IDENTITY) the density net is a linear cascade with one LeakyReLU at the
output. HoloDiffusion trained with this order, so it is the only order here.
Parameter names match the reference: `mlp.{i}.0.weight/bias`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_HIDDEN_ACTS = {
    "RELU": F.relu,
    "SOFTPLUS": F.softplus,
    "LEAKYRELU": lambda x: F.leaky_relu(x, 0.2),
}
_LAST_ACTS = {
    "RELU": F.relu,
    "SOFTPLUS": F.softplus,
    "SIGMOID": torch.sigmoid,
    "IDENTITY": lambda x: x,
}


class MLPWithInputSkips(nn.Module):
    def __init__(
        self,
        n_layers: int = 8,
        input_dim: int = 39,
        output_dim: int = 256,
        skip_dim: int = 39,
        hidden_dim: int = 256,
        input_skips: Tuple[int, ...] = (5,),
        hidden_activation: str = "LEAKYRELU",
        last_activation: str = "SOFTPLUS",
    ):
        super().__init__()
        self.n_layers = n_layers
        self.input_skips = tuple(input_skips)
        self.hidden_activation = hidden_activation
        self.last_activation = last_activation
        layers = []
        for li in range(n_layers):
            dimin = input_dim if li == 0 else hidden_dim
            if li > 0 and li in self.input_skips:
                dimin += skip_dim
            dimout = output_dim if li + 1 >= n_layers else hidden_dim
            # one-element Sequential keeps the reference's `mlp.{i}.0` names
            layers.append(nn.Sequential(nn.Linear(dimin, dimout)))
        self.mlp = nn.ModuleList(layers)

    def linear(self, li: int) -> nn.Linear:
        return self.mlp[li][0]

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None) -> torch.Tensor:
        hidden_act = _HIDDEN_ACTS[self.hidden_activation]
        last_act = _LAST_ACTS[self.last_activation]
        if z is None:
            z = x
        y = x
        for li in range(self.n_layers):
            if li > 0 and li in self.input_skips:
                y = torch.cat([y, z], dim=-1)
            is_last = li + 1 >= self.n_layers
            y = self.linear(li)(y)
            # the reference's swapped order (module docstring)
            y = hidden_act(y) if is_last else last_act(y)
        return y
