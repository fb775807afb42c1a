"""The arithmetic of the fused decode's tensor-core affine (`csrc/fused_decode.cu`),
pinned on the CPU before the card runs it, and the lane layout of the points
cotangent kernel K6 (`ops/kron_sample.py:dpoints_layout`).

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
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from holo_diffusion_torch.models.render_mlp import RenderMLP
from holo_diffusion_torch.ops import kron_sample as ks
from holo_diffusion_torch.ops.voxel import sample_voxel_grid_world
from holo_diffusion_torch.weights import init_weights

# the port's float32 contract: `test_torch_kernels_cuda.py` holds K1/K3 to 1e-5
TOL = 1e-5
EXTENT, D, C, HIDDEN = 8.0, 16, 64, 256


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
    # K4, K5 and K7 keep their own layout: the smallest power of two >= C
    assert ks.group_log2(C_) == {1: 0, 2: 1, 3: 2, 4: 2, 8: 3, 64: 5, 257: 5}[C_]


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
