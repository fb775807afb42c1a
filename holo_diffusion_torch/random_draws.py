"""The random draws of a training step, by name.

JAX's PRNG streams cannot be replayed in torch, so every random value the
training forward needs is asked for by name: a value passed in is used as
it is (the tests pass the JAX package's draws), any other comes from an
explicit `torch.Generator`. Names:

  timesteps          (2,) int64   diffusion t and bootstrap t2 (uniform, or
                                  categorical under the loss-aware sampler)
  noise, noise2      (1, r, r, r, C) q_sample noises of the two passes
  take_boot          bool         the bootstrap coin
  ray_pixel_u        (B, n_rays)  mask-sampling uniforms
  ray_length_u       (B, n_rays, n_pts) coarse stratification uniforms
  refine_u_{k}       (B, n_rays, n_fine) importance refinement, pass k >= 1
  density_noise_{k}  (B, n_rays, P) raymarcher density noise, pass k
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence, Union

import numpy as np
import torch


class Draws:
    def __init__(
        self,
        values: Optional[Mapping[str, Any]] = None,
        generator: Optional[torch.Generator] = None,
    ):
        self.values = dict(values or {})
        self.generator = generator

    @classmethod
    def of(cls, generator_or_draws: Union["Draws", torch.Generator, Mapping[str, Any], None]) -> "Draws":
        """A `Draws` from a generator, a mapping of injected values, or itself."""
        if isinstance(generator_or_draws, Draws):
            return generator_or_draws
        if isinstance(generator_or_draws, torch.Generator):
            return cls(generator=generator_or_draws)
        return cls(values=generator_or_draws)

    def _given(self, name: str, shape: Sequence[int], device, dtype) -> Optional[torch.Tensor]:
        if name not in self.values:
            if self.generator is None:
                raise ValueError(f"no value for the draw {name!r} and no generator")
            return None
        v = self.values[name]
        v = (v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))).to(device=device, dtype=dtype)
        if tuple(v.shape) != tuple(shape):
            raise ValueError(f"draw {name!r} has shape {tuple(v.shape)}, expected {tuple(shape)}")
        return v

    def uniform(self, name: str, shape: Sequence[int], device) -> torch.Tensor:
        """U[0, 1) float32."""
        v = self._given(name, shape, device, torch.float32)
        if v is None:
            v = torch.rand(tuple(shape), generator=self.generator, device=device)
        return v

    def normal(self, name: str, shape: Sequence[int], device) -> torch.Tensor:
        """N(0, 1) float32."""
        v = self._given(name, shape, device, torch.float32)
        if v is None:
            v = torch.randn(tuple(shape), generator=self.generator, device=device)
        return v

    def randint(self, name: str, high: int, shape: Sequence[int], device) -> torch.Tensor:
        """Integers uniform on [0, high), int64."""
        v = self._given(name, shape, device, torch.int64)
        if v is None:
            v = torch.randint(0, high, tuple(shape), generator=self.generator, device=device)
        return v

    def categorical(self, name: str, probs: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
        """Indices into `probs` (a (n,) distribution on its device) drawn
        with replacement, int64. Drawn by inverting the CDF at uniforms, so
        nothing is read on the host."""
        v = self._given(name, shape, probs.device, torch.int64)
        if v is None:
            cdf = torch.cumsum(probs, 0)
            u = torch.rand(tuple(shape), generator=self.generator, device=probs.device, dtype=cdf.dtype)
            v = torch.clamp(torch.searchsorted(cdf, u * cdf[-1], right=True), max=probs.shape[0] - 1)
        return v

    def coin(self, name: str, p: float) -> bool:
        """True with probability p. A drawn coin is read on the host (the
        caller branches on it)."""
        if name in self.values:
            return bool(self.values[name])
        if self.generator is None:
            raise ValueError(f"no value for the draw {name!r} and no generator")
        u = torch.rand((), generator=self.generator, device=self.generator.device)
        return bool(u < p)
