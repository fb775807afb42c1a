"""FLOPs of the denoiser `SimpleUnet3D`, the 3D UNet, from the
configuration's layer shapes, in `counts.model`'s categories: its
convolutions, linear layers (the timestep embedding and each ResBlock's
scale-shift), GroupNorm, and the attention blocks' q.k and w.v products,
4 x C x T^2 a block. Found by `net_3d_class_type` through
`benchmark.reference.net3d_plugin`."""
from __future__ import annotations

from collections import Counter

from benchmark.counts.model import GN_PER_ELEMENT, conv, linear


def forward(spec, batch: int = 1) -> Counter:
    """One evaluation of the UNet at `batch` grids of resol^3 x C."""
    u = spec.net_3d
    mc, mult, nres = u["model_channels"], tuple(u["channel_mult"]), u["num_res_blocks"]
    attn_at, C, r = tuple(u["attention_resolutions"]), spec.feature_size, spec.resol
    emb = 4 * mc
    f: Counter = Counter()

    def n_at(ds):  # positions at downsampling factor ds, all grids
        return batch * (r // ds) ** 3

    def res(cin, cout, ds):
        n = n_at(ds)
        f["groupnorm"] += GN_PER_ELEMENT * (cin + cout) * n
        f["conv"] += conv(cin, cout, 3, n, 3) + conv(cout, cout, 3, n, 3)
        f["linear"] += linear(emb, 2 * cout, batch)
        if cin != cout:
            f["conv"] += conv(cin, cout, 1, n, 3)

    def attn(c, ds):
        n = n_at(ds)
        t = n // batch
        f["groupnorm"] += GN_PER_ELEMENT * c * n
        f["conv"] += conv(c, 3 * c, 1, n, 1) + conv(c, c, 1, n, 1)
        f["attention"] += batch * 4 * c * t * t

    f["linear"] += linear(mc, emb, batch) + linear(emb, emb, batch)
    ch = mult[0] * mc
    f["conv"] += conv(C, ch, 3, n_at(1), 3)
    chans, ds = [ch], 1
    for level, m in enumerate(mult):
        for _ in range(nres):
            res(ch, m * mc, ds)
            ch = m * mc
            if ds in attn_at:
                attn(ch, ds)
            chans.append(ch)
        if level != len(mult) - 1:
            f["conv"] += conv(ch, ch, 3, n_at(2 * ds), 3)
            chans.append(ch)
            ds *= 2
    res(ch, ch, ds)
    attn(ch, ds)
    res(ch, ch, ds)
    for level, m in list(enumerate(mult))[::-1]:
        for i in range(nres + 1):
            res(ch + chans.pop(), mc * m, ds)
            ch = mc * m
            if ds in attn_at:
                attn(ch, ds)
            if level and i == nres:
                f["conv"] += conv(ch, ch, 3, n_at(ds // 2), 3)
                ds //= 2
    f["groupnorm"] += GN_PER_ELEMENT * ch * n_at(1)
    f["conv"] += conv(ch, C, 3, n_at(1), 3)
    return f
