"""The CUDA kernels of holo_diffusion_torch (the fused decode forward, K1/K3,
and its backward) against their plain PyTorch versions, on the card. Every test here is marked `cuda` and skips without a
CUDA device. The file imports neither JAX nor the JAX package, so it also
runs where JAX is not installed, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -m cuda -q
"""
import numpy as np
import pytest
import torch

from holo_diffusion_torch.ops import fused_decode as fd

EXTENT, PE_DIM = 4.0, 27
SHAPES = {
    "C32": dict(D=8, C=32, hidden=48, R=6, P=9),
    # the hydrant decode: 16^3 x 64 grid, 256 hidden units, 128 points per ray
    "C64_hydrant": dict(D=16, C=64, hidden=256, R=64, P=128),
}


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(seed, D, C, hidden, R, P):
    rs = np.random.RandomState(seed)
    grid = np.tanh(rs.randn(D, D, D, C))
    A = rs.randn(C, hidden + 1) / np.sqrt(C)
    c = rs.randn(hidden + 1) * 0.1
    Wr = rs.randn(hidden + PE_DIM, 3) / np.sqrt(hidden + PE_DIM)
    br = rs.randn(3) * 0.1
    # voxel centres span +-0.5 * EXTENT * (D - 1) / D: points inside and beyond
    pts = rs.uniform(-0.6 * EXTENT, 0.6 * EXTENT, (R, P, 3))
    pe = rs.randn(R, PE_DIM)
    return [torch.from_numpy(x.astype(np.float32)) for x in (grid, A, c, Wr, br, pts, pe)]


def _g1(grid, A):
    return torch.einsum("dhwc,c->dhw", grid, A[:, -1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("normals", [False, True], ids=["K1", "K3"])
def test_kernel_matches_plain_on_card(shape, normals):
    """float32 on both sides (TF32 is off for matmuls by default); the kernel
    sums the affine in another order than cuBLAS: 1e-5."""
    dev = _device()
    sh = SHAPES[shape]
    grid, A, c, Wr, br, pts, pe = (x.to(dev) for x in _inputs(11, **sh))
    kw = {"g1": _g1(grid, A)} if normals else {}
    name = fd.ENTRY_POINTS[int(normals)]
    before = fd.launch_counts()[name]
    out = fd.fused_sample_decode(grid, A, c, Wr, br, pts, pe, EXTENT, sh["hidden"], **kw)
    ref = fd.fused_sample_decode_reference(grid, A, c, Wr, br, pts, pe, EXTENT, sh["hidden"], **kw)
    torch.cuda.synchronize()
    assert fd.launch_counts()[name] == before + 1
    assert len(out) == len(ref) == (3 if normals else 2)
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kernel_takes_strided_points_and_empty_input():
    """Non-contiguous points give the contiguous result; no rays launch
    nothing and count nothing."""
    dev = _device()
    sh = SHAPES["C32"]
    grid, A, c, Wr, br, pts, pe = (x.to(dev) for x in _inputs(12, **sh))
    strided = pts.transpose(0, 1).contiguous().transpose(0, 1)
    assert not strided.is_contiguous()
    args = (grid, A, c, Wr, br)
    out = fd.fused_sample_decode(*args, strided, pe, EXTENT, sh["hidden"], g1=_g1(grid, A))
    ref = fd.fused_sample_decode(*args, pts, pe, EXTENT, sh["hidden"], g1=_g1(grid, A))
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    before = fd.launch_counts()
    empty = fd.fused_sample_decode(*args, pts[:0], pe[:0], EXTENT, sh["hidden"])
    assert [tuple(x.shape) for x in empty] == [(0, sh["P"], 1), (0, sh["P"], 3)]
    assert fd.launch_counts() == before


def _cotangent(seed, R, P):
    return torch.from_numpy(np.random.RandomState(seed).randn(R, P, 4).astype(np.float32))


def _assert_cotangents_close(got, want, rel):
    for name, a, b in zip(("d_grid", "dA", "dc", "dWr", "dbr"), got, want):
        assert a.shape == b.shape, name
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= rel * scale, f"{name}: max|diff| {err:.3e} > {rel} x {scale:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_backward_kernel_matches_plain_on_card(shape):
    """The five cotangents against the plain backward on the card: 1e-3 of
    each cotangent's largest magnitude, under the 2e-3 the JAX package holds
    its training gradients to. Both sum float32 over every point in orders
    that differ (atomics in the kernel, cuBLAS in the plain version), and a
    pre-activation that each computes within rounding of 0 can take the
    leaky-ReLU slope 1 in one and 0.2 in the other, which moves one point's
    contribution (chip_smoke.py counts such pre-activations)."""
    dev = _device()
    sh = SHAPES[shape]
    grid, A, c, Wr, br, pts, pe = (x.to(dev) for x in _inputs(13, **sh))
    g = _cotangent(14, sh["R"], sh["P"]).to(dev)
    before = fd.launch_counts()["fused_decode_bwd"]
    args = (grid, A, c, Wr, br, pts, pe, EXTENT, sh["hidden"], g)
    got = fd._fused_sample_decode_bwd_cuda(*args)
    want = fd.fused_sample_decode_bwd_reference(*args)
    torch.cuda.synchronize()
    assert fd.launch_counts()["fused_decode_bwd"] == before + 1
    _assert_cotangents_close(got, want, 1e-3)


@pytest.mark.cuda
def test_autograd_function_launches_forward_and_backward_kernels():
    """`fused_sample_decode` with inputs that require grad runs K3 forward
    and the backward kernel, and its gradients are the plain backward's
    (1e-3 of scale, as above)."""
    dev = _device()
    sh = SHAPES["C64_hydrant"]
    grid, A, c, Wr, br, pts, pe = (x.to(dev) for x in _inputs(15, **sh))
    g = _cotangent(16, sh["R"], sh["P"]).to(dev)
    params = [x.clone().requires_grad_(True) for x in (grid, A, c, Wr, br)]
    before = fd.launch_counts()
    dens, rgb, _ = fd.fused_sample_decode(*params, pts, pe, EXTENT, sh["hidden"], g1=_g1(grid, A))
    torch.autograd.backward((dens, rgb), (g[..., :1], g[..., 1:4]))
    torch.cuda.synchronize()
    after = fd.launch_counts()
    assert after["fused_decode_fwd_normals"] == before["fused_decode_fwd_normals"] + 1
    assert after["fused_decode_bwd"] == before["fused_decode_bwd"] + 1
    want = fd.fused_sample_decode_bwd_reference(grid, A, c, Wr, br, pts, pe, EXTENT, sh["hidden"], g)
    _assert_cotangents_close([p.grad for p in params], want, 1e-3)
