"""Harmonic (positional) embedding — pytorch3d `HarmonicEmbedding` subset
(port of holo_diffusion_tpu/geometry/harmonic.py)."""
from __future__ import annotations

import torch
from torch import nn


def harmonic_embedding_dim(
    input_dims: int, n_harmonic_functions: int, append_input: bool = True
) -> int:
    return input_dims * (2 * n_harmonic_functions + int(append_input))


class HarmonicEmbedding(nn.Module):
    """[sin(f_i x) ... | cos(f_i x) ... | x], frequencies omega_0 * 2**i;
    within each trig block the layout is embed[..., d * N + i] (pytorch3d)."""

    def __init__(
        self,
        n_harmonic_functions: int = 6,
        omega_0: float = 1.0,
        logspace: bool = True,
        append_input: bool = True,
    ):
        super().__init__()
        self.n = n_harmonic_functions
        self.append_input = append_input
        if n_harmonic_functions > 0 and logspace:
            freqs = 2.0 ** torch.arange(n_harmonic_functions, dtype=torch.float32)
        elif n_harmonic_functions > 0:
            freqs = torch.linspace(
                1.0, 2.0 ** (n_harmonic_functions - 1), n_harmonic_functions
            )
        else:
            freqs = torch.zeros(0)
        # the reference registers `_frequencies` as a non-persistent buffer
        self.register_buffer("_frequencies", omega_0 * freqs, persistent=False)

    def get_output_dim(self, input_dims: int = 3) -> int:
        return harmonic_embedding_dim(input_dims, self.n, self.append_input)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., D) -> (..., D * (2N [+ 1]))."""
        if self.n == 0:
            return x if self.append_input else x[..., :0]
        embed = (x[..., :, None] * self._frequencies).reshape(*x.shape[:-1], -1)
        parts = [torch.sin(embed), torch.cos(embed)]
        if self.append_input:
            parts.append(x)
        return torch.cat(parts, dim=-1)
