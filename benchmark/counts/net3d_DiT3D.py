"""FLOPs of the denoiser `DiT3D`, DiT-3D's transformer over (resol / patch)^3
patch tokens, from the configuration's shapes, in `counts.model`'s
categories: `conv` (the patch embedding, a Conv3d of kernel and stride p),
`linear` (each block's qkv, output projection and MLP over every token, its
adaLN modulation and the timestep MLP once a grid, the final adaLN and the
final Linear(d, p^3 C) over every token), `attention` (each block's q.k and
w.v products, 4 x d x T^2 a grid) and `layernorm` (the two LayerNorms of a
block and the final one, no affine: mean, centre, square, variance, scale,
5 an element). The modulation, gates, residual adds and activations are
not counted. Found by `net_3d_class_type` through
`benchmark.reference.net3d_plugin`."""
from __future__ import annotations

from collections import Counter

from benchmark.counts.model import conv, linear

FREQUENCIES = 256
LN_PER_ELEMENT = 5


def forward(spec, batch: int = 1) -> Counter:
    """One evaluation of the DiT at `batch` grids of resol^3 x C."""
    a = spec.net_3d
    d, depth, p = a["hidden_size"], a["depth"], a["patch_size"]
    hidden = int(d * a["mlp_ratio"])
    C, t = spec.feature_size, (spec.resol // p) ** 3
    n = batch * t  # tokens, all grids
    f: Counter = Counter()
    f["conv"] += conv(C, d, p, n, 3)
    f["linear"] += linear(FREQUENCIES, d, batch) + linear(d, d, batch)
    block = linear(d, 3 * d, n) + linear(d, d, n) + linear(d, hidden, n) + linear(hidden, d, n)
    f["linear"] += depth * (block + linear(d, 6 * d, batch))
    f["attention"] += depth * batch * 4 * d * t * t
    f["layernorm"] += (2 * depth + 1) * LN_PER_ELEMENT * n * d
    f["linear"] += linear(d, 2 * d, batch) + linear(d, p ** 3 * C, n)
    return f
