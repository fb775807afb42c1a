"""The 3D convolutions of the denoiser `SimpleUnet3D` whose output has at
most 64 positions (batch x output voxels), from the configuration's layer
shapes alone, and the least time each needs on the card: bytes (the
weights of the taps that meet an in-bounds input voxel for some output,
the bias, the input and the output, each once) at 3.35 TB/s or FLOPs (2 x
the in-bounds multiply-adds) at 495 TFLOP/s, whichever is larger. Read by
`metrics/small_conv_roofline.sample.py`. The rule restates the program's
(a 1^3 or 3^3 kernel, padding k // 2, stride 1 or 2, at most 64 positions)
without reading the program's route."""
from __future__ import annotations

from typing import List, NamedTuple

from benchmark.counts.decode import least_seconds

MAX_POSITIONS = 64


class Conv(NamedTuple):
    """A 3D convolution of `k`^3 (padding k // 2) and `stride` on every axis,
    from an input of `n_in`^3 voxels and `cin` channels to `n_out`^3 and
    `cout`, at `batch` grids."""

    cin: int
    cout: int
    k: int
    stride: int
    n_in: int
    n_out: int
    batch: int

    @property
    def positions(self) -> int:
        return self.batch * self.n_out ** 3

    def _axis(self):
        """Per axis: the taps d that meet an in-bounds voxel for some output,
        and the (output, tap) pairs that do."""
        pad = self.k // 2
        hits = [[d for d in range(self.k) if 0 <= o * self.stride + d - pad < self.n_in] for o in range(self.n_out)]
        return len({d for h in hits for d in h}), sum(len(h) for h in hits)

    @property
    def used_weights(self) -> int:
        return self.cout * self.cin * self._axis()[0] ** 3

    def bytes(self) -> int:
        acts = self.batch * (self.cin * self.n_in ** 3 + self.cout * self.n_out ** 3)
        return 4 * (self.used_weights + self.cout + acts)

    def flops(self) -> int:
        return 2 * self.cout * self.cin * self.batch * self._axis()[1] ** 3

    def least_seconds(self, peak_flops: float, peak_bytes_per_s: float) -> float:
        return least_seconds(self.bytes(), self.flops(), peak_flops, peak_bytes_per_s)


def convs(spec, batch: int = 1) -> List[Conv]:
    """Every 3D convolution of one evaluation of the UNet at `batch` grids
    of resol^3 x C, in the order of the forward (the walk of
    `net3d_SimpleUnet3D.forward`); homogeneous resampling."""
    u = spec.net_3d
    if not u.get("homogeneous_resample", True):
        raise ValueError("the count takes homogeneous resampling only")
    mc, mult, nres = u["model_channels"], tuple(u["channel_mult"]), u["num_res_blocks"]
    C, r = spec.feature_size, spec.resol
    out: List[Conv] = []

    def conv(cin, cout, k, ds_in, ds_out):
        n_in, n_out = r // ds_in, r // ds_out
        out.append(Conv(cin, cout, k, ds_out // ds_in, n_in, n_out, batch))

    def res(cin, cout, ds):
        conv(cin, cout, 3, ds, ds)
        conv(cout, cout, 3, ds, ds)
        if cin != cout:
            conv(cin, cout, 1, ds, ds)

    ch = mult[0] * mc
    conv(C, ch, 3, 1, 1)
    chans, ds = [ch], 1
    for level, m in enumerate(mult):
        for _ in range(nres):
            res(ch, m * mc, ds)
            ch = m * mc
            chans.append(ch)
        if level != len(mult) - 1:
            conv(ch, ch, 3, ds, 2 * ds)
            chans.append(ch)
            ds *= 2
    res(ch, ch, ds)
    res(ch, ch, ds)
    for level, m in list(enumerate(mult))[::-1]:
        for i in range(nres + 1):
            res(ch + chans.pop(), mc * m, ds)
            ch = mc * m
            if level and i == nres:
                conv(ch, ch, 3, ds // 2, ds // 2)  # after the nearest x2: stride 1 at the finer level
                ds //= 2
    conv(ch, C, 3, 1, 1)
    return out


def small_convs(spec, batch: int = 1) -> List[Conv]:
    """The convolutions of `convs` whose output has at most 64 positions."""
    return [c for c in convs(spec, batch) if c.k in (1, 3) and c.positions <= MAX_POSITIONS]
