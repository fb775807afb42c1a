"""The CUDA kernels of holo_diffusion_torch against their plain PyTorch
versions, on the card. Every test here is marked `cuda` and skips without a
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
