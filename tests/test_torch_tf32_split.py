"""The arithmetic of the fused decode's tensor-core products, pinned on the
CPU before the card runs it: the forward's affine (`csrc/fused_decode.cu`)
and the backward's dA = s^T d_pre and d_s = d_pre A^T
(`csrc/fused_decode_bwd.cu`); the lane layouts of the sampling kernels K4,
K7 and K6 (`ops/kron_sample.py:sample_layout`, `dpoints_layout`), and K5's
tiles and its run-merged scatter (`DGRID_TILE_LOG2`), emulated in the
kernel's order; and the kernels' build keys (`ops/_build.py`).

The kernel computes pre = s @ A + c with mma.sync TF32 products in the
3 x TF32 split: each float32 operand x = hi + lo with hi = tf32(x) and
lo = tf32(x - hi) (`cvt.rna.tf32.f32`: 10 mantissa bits, round to nearest,
ties away from zero), and pre = hi_s hi_A + hi_s lo_A + lo_s hi_A. The
tensor cores multiply TF32 parts exactly and add in float32; the emulation
here adds in float64, since the float32 summation order is the kind of
difference every kernel-vs-plain tolerance already covers. Inputs are shaped
as `chip_smoke.py`'s: the hydrant decoder (64 channels, 256 hidden units,
seeded weights) on a tanh(randn) 16^3 x 64 grid, points inside and beyond it.
"""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import pathlib
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from holo_diffusion_torch.models.render_mlp import RenderMLP
from holo_diffusion_torch.ops import fused_render as fr
from holo_diffusion_torch.ops import kron_sample as ks
from holo_diffusion_torch.ops.voxel import continuous_indices, hat_corners, sample_voxel_grid_world
from holo_diffusion_torch.weights import init_weights

# the port's float32 contract: `test_torch_kernels_cuda.py` holds K1/K3 to 1e-5
TOL = 1e-5
EXTENT, D, C, HIDDEN = 8.0, 16, 64, 256


def _chip_smoke():
    """The repository root's `chip_smoke.py`, imported without the card."""
    root = pathlib.Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    return chip_smoke


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 with the low 13 mantissa bits cleared, rounded to
    nearest with ties away from zero (`cvt.rna.tf32.f32`): adding half of
    the dropped place to the magnitude bits carries into the kept ones."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    (ah, al), (bh, bl) = split(a), split(b)
    d = torch.float64
    return ((ah.to(d) @ bh.to(d)) + (ah.to(d) @ bl.to(d)) + (al.to(d) @ bh.to(d))).float()


def matmul_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (tf32_round(a).double() @ tf32_round(b).double()).float()


def test_tf32_round_is_round_to_nearest_ties_away():
    ulp = 2.0 ** -10  # of a TF32 number in [1, 2)
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + 3 * ulp / 2, 1 + ulp / 2 - 2 ** -20, 1.0, 0.0,
                      (1 + ulp / 2) * 2 ** -40], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1 + 2 * ulp, 1.0, 1.0, 0.0, (1 + ulp) * 2 ** -40], dtype=torch.float32)
    assert torch.equal(tf32_round(x), want)
    # the parts are TF32 numbers and add back to x up to lo's own rounding
    v = torch.from_numpy(np.random.RandomState(0).randn(10000).astype(np.float32))
    hi, lo = split(v)
    assert torch.equal(tf32_round(hi), hi) and torch.equal(tf32_round(lo), lo)
    assert float(((hi.double() + lo.double()) - v.double()).abs().max()) <= float(v.abs().max()) * 2.0 ** -22


@pytest.fixture(scope="module")
def hydrant_decode():
    """The collapsed hydrant decoder on seeded samples: (s, A, c, Wr, br,
    pe) in float32, s from 4096 points of which some lie beyond the grid."""
    mlp = init_weights(RenderMLP(input_dims=C, dnet_hidden_dim=HIDDEN, rnet_hidden_dim=128), seed=0)
    rs = np.random.RandomState(1)
    grid = torch.from_numpy(np.tanh(rs.randn(D, D, D, C)).astype(np.float32))
    pts = torch.from_numpy(rs.uniform(-0.6 * EXTENT, 0.6 * EXTENT, (4096, 3)).astype(np.float32))
    dirs = torch.from_numpy(rs.randn(4096, 3).astype(np.float32))
    with torch.no_grad():
        A, c = mlp.density_affine()
        Wr, br = mlp.radiance_linear()
        s = sample_voxel_grid_world(grid, pts, EXTENT)
        pe = mlp.encode_dirs(dirs / dirs.norm(dim=-1, keepdim=True))
    return s, A.detach(), c.detach(), Wr.detach(), br.detach(), pe


def _decode(pre, Wr, br, pe):
    """The kernel's epilogue from the pre-activations, in float64."""
    pre, Wr, br, pe = (t.double() for t in (pre, Wr, br, pe))
    h = F.leaky_relu(pre, 0.2)
    rgb = torch.sigmoid(F.leaky_relu(h[:, :HIDDEN] @ Wr[:HIDDEN] + pe @ Wr[HIDDEN:] + br, 0.2))
    return h[:, HIDDEN], rgb


def _errors(matmul, s, A, c, Wr, br, pe):
    exact = s.double() @ A.double() + c.double()
    pre = matmul(s, A) + c
    dens, rgb = _decode(pre, Wr, br, pe)
    dens64, rgb64 = _decode(exact, Wr, br, pe)
    return {"pre": float((pre.double() - exact).abs().max()), "density": float((dens - dens64).abs().max()),
            "rgb": float((rgb - rgb64).abs().max()), "pre_scale": float(exact.abs().max())}


def test_three_tf32_products_keep_float32_accuracy(hydrant_decode):
    """The split's pre-activations, density and rgb within 1e-5 of float64,
    as is the plain float32 product itself."""
    s, A, c, Wr, br, pe = hydrant_decode
    assert s.shape == (4096, C) and A.shape == (C, HIDDEN + 1) and pe.shape[-1] + HIDDEN == Wr.shape[0]
    assert float(s.abs().max()) > 0.5 and float((s == 0).all(dim=-1).float().mean()) > 0.05
    split_err = _errors(matmul_3xtf32, s, A, c, Wr, br, pe)
    f32_err = _errors(lambda a, b: a @ b, s, A, c, Wr, br, pe)
    assert max(split_err[k] for k in ("pre", "density", "rgb")) <= TOL, split_err
    assert max(f32_err[k] for k in ("pre", "density", "rgb")) <= TOL, f32_err


def test_one_tf32_product_is_not_float32(hydrant_decode):
    """Why the kernel pays for three products: one TF32 pass rounds both
    operands to 11 significant bits and misses 1e-5 on the pre-activations
    and the density by far."""
    s, A, c, Wr, br, pe = hydrant_decode
    err = _errors(matmul_1xtf32, s, A, c, Wr, br, pe)
    assert err["pre"] > 10 * TOL and err["density"] > 10 * TOL, err


# ---- K6's layout


def lane_channels(C_, lane):
    """The channels lane `lane` of a K6 group reads, as the kernel walks
    them: units lane, lane + G, lane + 2G, ... of `dpoints_layout`'s width
    (`csrc/kron_sample.cu`, `kron_sample_dpoints_kernel`)."""
    lanes_log2, vec = ks.dpoints_layout(C_)
    return [vec * u + e for u in range(lane, C_ // vec, 1 << lanes_log2) for e in range(vec)]


@pytest.mark.parametrize("C_", [1, 2, 3, 4, 8, 64, 257])
def test_dpoints_layout_covers_every_channel_once(C_):
    lanes_log2, vec = ks.dpoints_layout(C_)
    G = 1 << lanes_log2
    assert 0 <= lanes_log2 <= 5 and vec == (4 if C_ % 4 == 0 else 1)
    owned = [lane_channels(C_, lane) for lane in range(G)]
    flat = sorted(c for lane in owned for c in lane)
    assert flat == list(range(C_))
    # about 16 channels a lane: no lane owns more than ceil(C / G) rounded
    # up to the unit, and more lanes only where a lane would own more than 16
    assert max(len(o) for o in owned) <= -(-C_ // (G * vec)) * vec
    assert G == 1 or -(-C_ // (G // 2)) > ks.DPOINTS_LANE_CHANNELS
    # K4 and K7 share `sample_layout`
    assert fr.sample_layout is ks.sample_layout


def test_sample_layout_at_the_shapes_the_port_runs():
    # C 64: 4 lanes of four float4 units; C 257 (the collapsed density
    # affine): 8 lanes of scalars, lane 0 with the 257th channel
    assert ks.sample_layout(64) == (2, 4)
    assert ks.sample_layout(257) == (3, 1)
    assert sample_lane_channels(64, 1) == [4, 5, 6, 7, 20, 21, 22, 23, 36, 37, 38, 39, 52, 53, 54, 55]
    assert len(sample_lane_channels(257, 0)) == 33 and len(sample_lane_channels(257, 7)) == 32


def test_dpoints_layout_at_the_shapes_the_port_runs():
    # C 1: the normals' field, one lane of scalars; C 64: 4 lanes of four
    # float4 units; C 257: a warp of scalars
    assert ks.dpoints_layout(1) == (0, 1)
    assert ks.dpoints_layout(64) == (2, 4)
    assert ks.dpoints_layout(257) == (5, 1)
    assert lane_channels(64, 1) == [4, 5, 6, 7, 20, 21, 22, 23, 36, 37, 38, 39, 52, 53, 54, 55]


def test_grid_offsets_must_fit_32_bits():
    ks.check_flat_index((16, 16, 16, 64))
    with pytest.raises(ValueError, match="32-bit"):
        ks.check_flat_index((1024, 1024, 1024, 2))


# ---- K4's layout


def sample_lane_channels(C_, lane):
    """The channels lane `lane` of a K4 group computes, as the kernel walks
    them (`kron_sample_fwd_kernel`): units lane, lane + G, ... of
    `sample_layout`'s width."""
    lanes_log2, vec = ks.sample_layout(C_)
    return [vec * u + e for u in range(lane, C_ // vec, 1 << lanes_log2) for e in range(vec)]


@pytest.mark.parametrize("C_", [1, 2, 3, 4, 8, 64, 257])
def test_sample_layout_covers_every_channel_once(C_):
    lanes_log2, vec = ks.sample_layout(C_)
    G = 1 << lanes_log2
    assert 0 <= lanes_log2 <= 5 and vec == (4 if C_ % 4 == 0 else 1)
    owned = [sample_lane_channels(C_, lane) for lane in range(G)]
    assert sorted(c for lane in owned for c in lane) == list(range(C_))
    # at least SAMPLE_LANE_CHANNELS a lane, and twice the lanes would leave
    # a lane fewer; at most a warp
    least = ks.SAMPLE_LANE_CHANNELS[vec]
    assert max(len(o) for o in owned) <= -(-C_ // (G * vec)) * vec
    assert G == 1 or min(len(o) for o in owned) >= least
    assert G == 32 or C_ // (2 * G) < least
    # consecutive lanes own consecutive units of a row (coalesced stores)
    assert [o[0] for o in owned if o] == [vec * lane for lane in range(min(G, C_ // vec))]


# ---- K2's products: dA = s^T d_pre, d_s = d_pre A^T


def _d_pre(s, A, c, Wr, br, pe, g):
    """The backward's d_pre (float32), as `fused_sample_decode_bwd_reference`
    computes it from the samples s and the cotangent g (n, 4)."""
    pre = s @ A + c
    rin = torch.cat([F.leaky_relu(pre[:, :HIDDEN], 0.2), pe], dim=-1)
    rpre = rin @ Wr + br
    rgb = torch.sigmoid(F.leaky_relu(rpre, 0.2))
    slope = lambda x: torch.where(x >= 0, torch.ones_like(x), torch.full_like(x, 0.2))  # noqa: E731
    d_rpre = g[:, 1:4] * rgb * (1.0 - rgb) * slope(rpre)
    d_h = torch.cat([d_rpre @ Wr[:HIDDEN].t(), g[:, 0:1]], dim=-1)
    return d_h * slope(pre)


def _product_errors(matmul, s, A, d_pre):
    """Largest error of dA and d_s against float64, relative to each one's
    largest magnitude."""
    out = {}
    for name, a, b in (("dA", s.t(), d_pre), ("d_s", d_pre, A.t())):
        exact = a.double() @ b.double()
        out[name] = float((matmul(a, b).double() - exact).abs().max()) / float(exact.abs().max())
    return out


# the backward's products in the 3 x TF32 split, over 4,096 points at
# hydrant width: within 1e-6 of each result's scale (the emulation reads
# 0.7e-7 for dA and 1.2e-7 for d_s, float32's own products 1.7e-7 and
# 1.4e-7), where one TF32 pass is off by 2.0e-4 and 3.6e-4
SPLIT_BWD_REL = 1e-6


def test_backward_products_keep_float32_accuracy_in_three_tf32_passes(hydrant_decode):
    s, A, c, Wr, br, pe = hydrant_decode
    g = torch.from_numpy(np.random.RandomState(2).randn(s.shape[0], 4).astype(np.float32))
    d_pre = _d_pre(s, A, c, Wr, br, pe, g)
    assert d_pre.shape == (4096, HIDDEN + 1) and float(d_pre.abs().max()) > 0
    split_err = _product_errors(matmul_3xtf32, s, A, d_pre)
    one_err = _product_errors(matmul_1xtf32, s, A, d_pre)
    assert max(split_err.values()) <= SPLIT_BWD_REL, split_err
    assert min(one_err.values()) > 10 * SPLIT_BWD_REL, one_err


# ---- the kernels' build keys


def test_library_key_covers_the_headers(tmp_path, monkeypatch):
    """An edited header under csrc/ changes every library's key, so each
    source that includes it rebuilds; an edited source only its own."""
    from holo_diffusion_torch.ops import _build

    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    (tmp_path / "h.cuh").write_text("int h;\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    keys = {n: _build.library_path(n) for n in ("a", "b")}
    (tmp_path / "h.cuh").write_text("int h2;\n")
    after_header = {n: _build.library_path(n) for n in ("a", "b")}
    assert all(after_header[n] != keys[n] for n in keys)
    (tmp_path / "b.cu").write_text("int b2;\n")
    assert _build.library_path("a") == after_header["a"] and _build.library_path("b") != after_header["b"]


def test_backward_errors_apart_from_near_zero_pre_activations():
    """`chip_smoke.decode_bwd_errors` counts the nonzero pre-activations
    within 1e-6 of 0 and holds d_grid apart from the corner cells of their
    points: an error in such a cell leaves that measure at 0, an error in a
    cell no such point reaches shows in it."""
    decode_bwd_errors = _chip_smoke().decode_bwd_errors
    rs = np.random.RandomState(4)
    D, C_, extent = 4, 8, 4.0
    grid = torch.from_numpy(rs.randn(D, D, D, C_).astype(np.float32))
    A = torch.from_numpy(rs.randn(C_, 5).astype(np.float32))
    # voxel centres at -1.5 .. 1.5: every point among the first 3^3 cells,
    # point 0 in the first voxel
    pts = torch.from_numpy(rs.uniform(-1.4, 0.4, (6, 3)).astype(np.float32))
    pts[0] = -1.2
    s = sample_voxel_grid_world(grid, pts, extent)
    c = torch.full((5,), 3.0 * float(s.abs().sum(-1).max()) * float(A.abs().max()))
    c[0] = 5e-7 - float((s @ A)[0, 0])
    assert 0 < float((s @ A + c)[0, 0]) < 1e-6
    args = (grid, A, c, None, None, pts, None, extent)
    want = [torch.from_numpy(rs.randn(*shape).astype(np.float32)) for shape in ((D, D, D, C_), (C_, 5), (5,))]
    for cell, apart in ((0, False), (D ** 3 - 1, True)):
        got = [w.clone() for w in want]
        got[0].view(-1, C_)[cell, 3] += 1e-3
        _, rel, near_zero, away = decode_bwd_errors(args, got, want)
        assert near_zero == 1
        assert rel["d_grid"] > 0 and rel["dA"] == rel["dc"] == 0
        assert (away == rel["d_grid"]) if apart else away == 0


def test_slope_safe_cotangent_zeroes_the_points_near_a_slope_change():
    """`chip_smoke.slope_safe_cotangent` zeroes the cotangent of exactly the
    points with a nonzero pre-activation within 1e-5 of 0, in the density
    net or in the radiance head, and keeps the rest; with it, moving such
    pre-activations across 0 leaves the plain backward's cotangents
    unchanged."""
    from holo_diffusion_torch.ops import fused_decode as fd

    slope_safe_cotangent = _chip_smoke().slope_safe_cotangent
    rs = np.random.RandomState(6)
    D, C_, hidden, pe_dim, extent, R, P = 4, 8, 6, 3, 4.0, 3, 4
    grid = torch.from_numpy(rs.randn(D, D, D, C_).astype(np.float32))
    A = torch.from_numpy(rs.randn(C_, hidden + 1).astype(np.float32))
    c = torch.from_numpy(rs.randn(hidden + 1).astype(np.float32))
    Wr = torch.from_numpy(rs.randn(hidden + pe_dim, 3).astype(np.float32))
    br = torch.zeros(3)
    pe = torch.from_numpy(rs.randn(R, pe_dim).astype(np.float32))
    pts = torch.from_numpy(rs.uniform(-1.4, 1.4, (R, P, 3)).astype(np.float32))
    s = sample_voxel_grid_world(grid, pts.reshape(-1, 3), extent)
    # point 5's density column 2 a hair above 0, point 7's column 4 a hair
    # below; point 9's radiance output 1 a hair above 0
    c[2] = 4e-6 - float((s @ A)[5, 2])
    c[4] = -8e-6 - float((s @ A)[7, 4])
    pre = s @ A + c
    rin = torch.cat([F.leaky_relu(pre[:, :hidden], 0.2), pe[:, None].expand(R, P, pe_dim).reshape(-1, pe_dim)], -1)
    br[1] = 3e-6 - float((rin @ Wr)[9, 1])
    rpre = rin @ Wr + br
    near = ((pre != 0) & (pre.abs() < 1e-5)).any(-1) | ((rpre != 0) & (rpre.abs() < 1e-5)).any(-1)
    assert bool(near[5]) and bool(near[7]) and bool(near[9])
    g = torch.from_numpy(rs.randn(R, P, 4).astype(np.float32))
    args = (grid, A, c, Wr, br, pts, pe, extent, hidden)
    safe, zeroed = slope_safe_cotangent(g, args)
    assert zeroed == int(near.sum())
    assert torch.equal(safe.reshape(-1, 4)[near], torch.zeros(zeroed, 4))
    assert torch.equal(safe.reshape(-1, 4)[~near], g.reshape(-1, 4)[~near])
    want = fd.fused_sample_decode_bwd_reference(*args, safe)
    # the same pre-activations across 0: c and br moved by twice the gap
    c_flip, br_flip = c.clone(), br.clone()
    c_flip[2] -= 8e-6
    c_flip[4] += 16e-6
    br_flip[1] -= 6e-6
    got = fd.fused_sample_decode_bwd_reference(grid, A, c_flip, Wr, br_flip, pts, pe, extent, hidden, safe)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    # the full cotangent sees the flips
    full = fd.fused_sample_decode_bwd_reference(*args, g)
    flipped = fd.fused_sample_decode_bwd_reference(grid, A, c_flip, Wr, br_flip, pts, pe, extent, hidden, g)
    assert float((full[1] - flipped[1]).abs().max()) > 1e-2


# ---- K5's tiles and its run-merged scatter


@pytest.mark.parametrize("C_", [1, 3, 8, 64, 257])
def test_dgrid_layout_fits_a_block(C_):
    """K5 (`launch_dgrid`): whole runs in a tile, and a block's shared
    memory (each staged row at most 256 floats, split evenly into chunks,
    plus 8 cells and weights a point) within the 48 KB a block gets without
    opting in."""
    tile_log2, run_log2 = ks.DGRID_TILE_LOG2, ks.DGRID_RUN_LOG2
    assert 0 <= run_log2 <= tile_log2 <= 10
    vec = 4 if C_ % 4 == 0 else 1
    units = C_ // vec
    n_chunks = -(-units // (256 // vec))
    chunk = -(-units // n_chunks)
    assert chunk * vec <= 256 and (n_chunks - 1) * chunk < units <= n_chunks * chunk
    assert (chunk * vec * 4 + 8 * 8) << tile_log2 <= 48 * 1024


def run_merged_dgrid(points, g, grid_shape, extent, run):
    """K5's scatter as `kron_sample_dgrid_kernel` walks it: consecutive
    points in runs of `run` (a tile holds whole runs, so tiles do not
    matter); for each run and corner, the weighted cotangent rows summed in
    point order while the corner's cell stays the same, and one addition
    into d_grid each time the cell changes (none for a corner outside the
    grid, cell -1). Returns (d_grid, the additions per channel unit)."""
    D_, H, W, C_ = grid_shape
    cells, hats, _ = hat_corners(points, D_, H, W, extent)
    w = hats.prod(-1)
    base = [torch.floor(i) for i in continuous_indices(points, D_, H, W, extent)]
    inside = torch.stack([
        (base[0] + (k & 1) >= 0) & (base[0] + (k & 1) <= W - 1)
        & (base[1] + ((k >> 1) & 1) >= 0) & (base[1] + ((k >> 1) & 1) <= H - 1)
        & (base[2] + (k >> 2) >= 0) & (base[2] + (k >> 2) <= D_ - 1) for k in range(8)], dim=-1)
    cells = torch.where(inside, cells, -1)
    n = points.shape[0]
    pad = -n % run  # past the last point: cell -1, as if the run ended there
    cells = F.pad(cells, (0, 0, 0, pad), value=-1).reshape(-1, run, 8)
    w = F.pad(w, (0, 0, 0, pad)).reshape(-1, run, 8)
    g = F.pad(g, (0, 0, 0, pad)).reshape(-1, run, C_)
    d_grid = torch.zeros((D_ * H * W, C_), dtype=g.dtype)
    cur = torch.full(cells[:, 0].shape, -1)
    acc = torch.zeros(cur.shape + (C_,), dtype=g.dtype)
    adds = 0

    def flush(mask):
        nonlocal adds
        m = mask & (cur >= 0)
        d_grid.index_add_(0, cur[m], acc[m])
        adds += int(m.sum())

    for j in range(run):
        change = cells[:, j] != cur
        flush(change)
        acc = torch.where(change[..., None], torch.zeros_like(acc), acc)
        cur = torch.where(change, cells[:, j], cur)
        acc = acc + w[:, j, :, None] * g[:, j, None, :]
    flush(torch.ones_like(cur, dtype=torch.bool))
    return d_grid.reshape(grid_shape), adds


@pytest.mark.parametrize("C_", [8, 64])
@pytest.mark.parametrize("points", ["random", "ray_ordered", "one_voxel"])
def test_run_merged_scatter_is_the_grid_cotangent(points, C_):
    """The run-merged scatter equals `kron_sample_dgrid_reference` within
    1e-6 of scale on 3,072 points (24 rays of 128 depths, as a training
    pass lays them out, or the same number uniformly random, or all in one
    voxel), both in float64, so that only the merge rule and not the
    summation order can move the result. On ray-ordered points it adds less
    than half as often as on random ones; in one voxel once per run and
    corner."""
    gen = torch.Generator().manual_seed(8)
    R, P = 24, 128
    if points == "ray_ordered":
        pts = _chip_smoke().ray_ordered_points(gen, R, P, EXTENT).reshape(-1, 3)
    elif points == "random":
        pts = (torch.rand((R * P, 3), generator=gen) * 2 - 1) * 0.6 * EXTENT
    else:
        vs = EXTENT / D
        pts = (torch.tensor([5.0, 7.0, 9.0]) - 0.5 * (D - 1) + 0.05 + 0.9 * torch.rand((R * P, 3), generator=gen)) * vs
    g = torch.randn((R * P, C_), generator=gen)
    pts, g = pts.double(), g.double()
    run = 1 << ks.DGRID_RUN_LOG2
    got, adds = run_merged_dgrid(pts, g, (D, D, D, C_), EXTENT, run)
    want = ks.kron_sample_dgrid_reference(pts, g, (D, D, D, C_), EXTENT)
    scale = float(want.abs().max())
    assert scale > 0 and float((got - want).abs().max()) <= 1e-6 * scale
    runs = -(-R * P // run)
    if points == "one_voxel":
        assert adds == 8 * runs
    elif points == "ray_ordered":
        random_pts = (torch.rand((R * P, 3), generator=gen, dtype=torch.float64) * 2 - 1) * 0.6 * EXTENT
        assert adds < 0.5 * run_merged_dgrid(random_pts, g, (D, D, D, C_), EXTENT, run)[1]
