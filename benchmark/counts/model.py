"""Model FLOPs of the release configurations, from the configuration's layer
shapes (not from the program's modules), by category:

  conv       2 x multiply-adds of every convolution (bias not counted)
  linear     2 x in x out per row of every linear layer
  groupnorm  7 per element (mean, centre, square, variance, scale, gamma, beta)
  attention  the denoiser's attention products (q.k and w.v)
  decode     the render decode as `counts.decode` counts it

The denoiser, whichever the configuration's `net_3d_class_type` names, is
counted by its plug-in `counts/net3d_<class_type>.py` (`net_3d_forward`),
which may add categories of its own: the `mfu.*` readers sum them all.
The ResNet's BatchNorm, pooling, activations and the raymarcher's
elementwise work are not counted. A backward counts twice its forward (the
input and the weight cotangents), less the input cotangent of the
extractor's first convolution, whose input needs none; nothing is counted
for recomputation.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Tuple

from ..reference import net3d_plugin
from . import decode as dc

GN_PER_ELEMENT = 7
RESNET34 = (3, 4, 6, 3)
WIDTHS = (64, 128, 256, 512)


def conv(cin: int, cout: int, k: int, out_numel: int, dims: int) -> int:
    return 2 * cin * cout * k ** dims * out_numel


def linear(cin: int, cout: int, rows: int) -> int:
    return 2 * cin * cout * rows


def net_3d_forward(spec, batch: int = 1) -> Counter:
    """One evaluation of the denoiser at `batch` grids of resol^3 x C, as
    its plug-in `counts/net3d_<net_3d_class_type>.py` counts it."""
    return net3d_plugin("counts", spec.net_3d_type).forward(spec, batch)


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def extractor_forward(spec, n_images: int, height: int, width: int) -> Tuple[Counter, int]:
    """ResNet34 stages and their projections on n_images at height x width
    (before the extractor's rescale). Returns (flops, the first conv's)."""
    e = spec.extractor
    h, w = int(height * e["image_rescale"]), int(width * e["image_rescale"])
    stages, proj = tuple(e["stages"]), int(e["proj_dim"])
    f: Counter = Counter()
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    first = conv(3, 64, 7, n_images * h * w, 2)
    f["conv"] += first
    if e["first_max_pool"]:
        h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    cin = 64
    for li in range(1, max(stages) + 1):
        cout = WIDTHS[li - 1]
        for bi in range(RESNET34[li - 1]):
            s = 2 if (bi == 0 and li > 1) else 1
            h, w = _out(h, 3, s, 1), _out(w, 3, s, 1)
            n = n_images * h * w
            f["conv"] += conv(cin, cout, 3, n, 2) + conv(cout, cout, 3, n, 2)
            if cin != cout or s != 1:
                f["conv"] += conv(cin, cout, 1, n, 2)
            cin = cout
        if li in stages:
            f["conv"] += conv(cout, proj, 1, n_images * h * w, 2)
    return f, first


def feat_dim(spec) -> int:
    e = spec.extractor
    return len(e["stages"]) * int(e["proj_dim"]) + int(e["add_masks"]) + 3 * int(e["add_images"])


def pooling_forward(spec, n_sources: int) -> Counter:
    """The aggregator's layers and the mapper, at the resol^3 voxel centres."""
    n = spec.resol ** 3
    fd = feat_dim(spec)
    f: Counter = Counter()
    if spec.aggregator == "MLPMeanFeatureAggregator":
        a = spec.aggregator_args
        hid, out = a.get("n_hidden", 128), a.get("dim_out", 128)
        d_in = fd + 3 * (2 * a.get("n_harmonic_functions_ray", 3) + 1)
        f["linear"] += (linear(d_in, hid, n_sources * n) + linear(d_in, hid, n)
                        + linear(hid, hid, n_sources * n) + linear(hid, out, n_sources * n))
        agg_out = out
    else:
        agg_out = fd * len(spec.aggregator_args.get("reduction_functions", ("AVG", "STD")))
    f["linear"] += linear(agg_out, spec.feature_size, n)
    return f


def _decode(spec, n_rays: int, training: bool, backward: bool) -> int:
    hidden, pe = int(spec.mlp["dnet_hidden_dim"]), dc.pe_dim(spec)
    total = 0
    for pts, rays in dc.render_passes(spec, n_rays, training):
        total += dc.decode_cost(pts, rays, dc.grid_shape(spec), hidden, pe, spec.render_normals)[1]
        if backward:
            total += dc.decode_bwd_only_flops(pts, spec.feature_size, hidden, pe)
    return total


def train_step(spec, n_frames: int, height: int, width: int) -> Dict[str, float]:
    """Model FLOPs of one training step, forward and backward, by
    category; the second (bootstrap) denoiser pass counts with its
    probability."""
    nt = n_frames if spec.n_train_target_views <= 0 else min(spec.n_train_target_views, n_frames)
    ext, first = extractor_forward(spec, n_frames - nt, height, width)
    fwd = ext + pooling_forward(spec, n_frames - nt)
    passes = 1.0 + (spec.bootstrap_prob if spec.enable_bootstrap else 0.0)
    out = {k: 3.0 * v for k, v in fwd.items()}
    out["conv"] -= first  # the images need no cotangent
    for k, v in net_3d_forward(spec).items():
        out[k] = out.get(k, 0.0) + 3.0 * passes * v
    out["decode"] = float(_decode(spec, dc.train_rays(spec, n_frames), True, True))
    return out


def frame(spec) -> Dict[str, float]:
    """Model FLOPs of one evaluation frame: the decode of both passes."""
    return {"decode": float(_decode(spec, dc.frame_rays(spec), False, False))}


def ddpm_step(spec) -> Dict[str, float]:
    """Model FLOPs of one DDPM step at one grid: a denoiser evaluation."""
    return {k: float(v) for k, v in net_3d_forward(spec).items()}
