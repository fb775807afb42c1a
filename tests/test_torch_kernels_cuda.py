"""The CUDA kernels of holo_diffusion_torch (the fused decode forward, K1/K3,
and its backward K2, also where points share voxels; the trilinear sample K4 with its grid and points
cotangents K5/K6; the one-hot-formulation sample K7) against their plain
PyTorch versions, on the card; and the training loop of the tiny synthetic
experiment (run, checkpoint, resume) on the card. Every test here is marked `cuda` and skips without a
CUDA device. The file imports neither JAX nor the JAX package, so it also
runs where JAX is not installed, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -m cuda -q
"""
import numpy as np
import pytest
import torch

from holo_diffusion_torch.ops import fused_decode as fd
from holo_diffusion_torch.ops import fused_render as fr
from holo_diffusion_torch.ops import kron_sample as ks

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


# the hydrant render's two chunk shapes (640 rays x 64 coarse points, x 128
# after the fine pass): the persistent grid walks 2,560 and 5,120 warp tiles
RENDER_CHUNKS = {"coarse": 64, "fine": 128}


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", list(RENDER_CHUNKS))
@pytest.mark.parametrize("normals", [False, True], ids=["K1", "K3"])
def test_kernel_matches_plain_at_render_chunks(chunk, normals):
    """K1/K3 at hydrant width (16^3 x 64 grid, hidden 256) on both render
    chunks: the 3 x TF32 split holds float32's 1e-5."""
    dev = _device()
    sh = dict(D=16, C=64, hidden=256, R=640, P=RENDER_CHUNKS[chunk])
    grid, A, c, Wr, br, pts, pe = (x.to(dev) for x in _inputs(17, **sh))
    kw = {"g1": _g1(grid, A)} if normals else {}
    out = fd.fused_sample_decode(grid, A, c, Wr, br, pts, pe, EXTENT, sh["hidden"], **kw)
    ref = fd.fused_sample_decode_reference(grid, A, c, Wr, br, pts, pe, EXTENT, sh["hidden"], **kw)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _lattice_points(D, seed):
    """Points whose x lies exactly on a voxel plane (ix an integer, the
    grid's faces ix = 0 and D - 1 included) with y and z off the planes, and
    points beyond the grid on every axis. EXTENT / D is a power of two, so
    x / (EXTENT / D) is exact in float32 on every device."""
    rs = np.random.RandomState(seed)
    vs = EXTENT / D
    ix = np.concatenate([np.arange(D), [0, D - 1] * 8]).astype(np.float64)
    on_plane = np.stack([(ix - 0.5 * (D - 1)) * vs,
                         rs.uniform(-0.45, 0.45, ix.shape) * EXTENT,
                         rs.uniform(-0.45, 0.45, ix.shape) * EXTENT], axis=-1)
    # beyond the grid: every index below -1 or above D
    far = rs.uniform(0.5 * (D + 2) * vs, EXTENT, (32, 3)) * rs.choice([-1.0, 1.0], (32, 3))
    return [torch.from_numpy(x.astype(np.float32)) for x in (on_plane, far)]


@pytest.mark.cuda
def test_fused_decode_on_voxel_planes_and_outside_the_grid():
    """K3 at points exactly on x voxel planes and on the grid's faces: the
    field gradient's x slope is exactly 0 there; beyond the grid the sample
    is zero, so the density is leaky_relu(c[hidden]) and the gradient 0;
    every output as the plain version's."""
    dev = _device()
    sh = dict(D=16, C=64, hidden=256, R=1, P=1)
    grid, A, c, Wr, br, _, _ = (x.to(dev) for x in _inputs(18, **sh))
    on_plane, far = (x.to(dev) for x in _lattice_points(16, 19))
    for name, pts in (("on_plane", on_plane), ("outside", far)):
        pts = pts[:, None, :]
        pe = torch.randn((pts.shape[0], PE_DIM), generator=torch.Generator().manual_seed(20)).to(dev)
        args = (grid, A, c, Wr, br, pts, pe, EXTENT, sh["hidden"])
        out = fd.fused_sample_decode(*args, g1=_g1(grid, A))
        ref = fd.fused_sample_decode_reference(*args, g1=_g1(grid, A))
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)
        dens, _, grads = out
        if name == "on_plane":
            assert bool((grads[..., 0] == 0).all()), "slope 0 on a voxel plane"
        else:
            assert bool((grads == 0).all()), "zero gradient outside the grid"
            want = torch.nn.functional.leaky_relu(c[sh["hidden"]], fd.NEG_SLOPE)
            torch.testing.assert_close(dens, want.expand_as(dens), rtol=1e-6, atol=1e-6)


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


# ---- the sampling kernels: every channel count the unfused path uses
# (1: the normals' field; 64: hydrant; 257: the collapsed density affine)
SAMPLE_SHAPES = {"C1": (16, 1, 5000), "C8": (8, 8, 3000), "C64": (16, 64, 20000), "C257": (16, 257, 4000)}


def _sample_inputs(seed, D, C, n, dev):
    g = torch.Generator().manual_seed(seed)
    grid = torch.tanh(torch.randn((D, D, D, C), generator=g))
    # voxel centres span +-0.5 * EXTENT * (D - 1) / D: points inside and beyond
    pts = (torch.rand((n, 3), generator=g) * 2 - 1) * 0.6 * EXTENT
    cot = torch.randn((n, C), generator=g)
    return grid.to(dev), pts.to(dev), cot.to(dev)


def _assert_rel_close(got, want, rel, name):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * scale, f"{name}: max|diff| {err:.3e} > {rel} x {scale:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SAMPLE_SHAPES))
def test_sampling_kernels_match_plain_on_card(shape):
    """K4 and K7 within 1e-5 of their plain versions (8 float32 products
    summed in another order); K5 and K6 within 1e-4 of each cotangent's
    scale (K5 sums ~100 points per voxel with atomics in no fixed order)."""
    dev = _device()
    D, C, n = SAMPLE_SHAPES[shape]
    grid, pts, cot = _sample_inputs(21, D, C, n, dev)
    before_ks, before_fr = ks.launch_counts(), fr.launch_counts()
    out = ks.kron_sample_fwd(grid, pts, EXTENT)
    onehot = fr.trilinear_sample_pallas(grid, pts, EXTENT)
    d_grid = ks.kron_sample_dgrid(pts, cot, grid.shape, EXTENT)
    d_pts = ks.kron_sample_dpoints(grid, pts, cot, EXTENT)
    field_grad = ks.kron_sample_dpoints(grid, pts, None, EXTENT)
    torch.cuda.synchronize()
    after = ks.launch_counts()
    assert after["kron_sample_fwd"] == before_ks["kron_sample_fwd"] + 1
    assert after["kron_sample_dgrid"] == before_ks["kron_sample_dgrid"] + 1
    assert after["kron_sample_dpoints"] == before_ks["kron_sample_dpoints"] + 2
    assert fr.launch_counts()["trilinear_sample_onehot"] == before_fr["trilinear_sample_onehot"] + 1
    torch.testing.assert_close(out, ks.kron_sample_fwd_reference(grid, pts, EXTENT), rtol=0, atol=1e-5)
    torch.testing.assert_close(onehot, fr.trilinear_sample_onehot_reference(grid, pts, EXTENT), rtol=0, atol=1e-5)
    _assert_rel_close(d_grid, ks.kron_sample_dgrid_reference(pts, cot, grid.shape, EXTENT), 1e-4, "d_grid")
    _assert_rel_close(d_pts, ks.kron_sample_dpoints_reference(grid, pts, cot, EXTENT), 1e-4, "d_points")
    _assert_rel_close(field_grad, ks.kron_sample_dpoints_reference(grid, pts, None, EXTENT), 1e-4, "field")


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 3, 8, 64, 257])
@pytest.mark.parametrize("with_cot", [False, True], ids=["ones", "cotangent"])
def test_dpoints_kernel_matches_plain_by_channels(C, with_cot):
    """K6 at every layout of `dpoints_layout` (one lane of scalars at C 1 and
    3, one lane of float4 units at C 8, 4 lanes at C 64, 32 scalar lanes at
    C 257), with the all-ones and with a random cotangent: 1e-4 of scale."""
    dev = _device()
    grid, pts, cot = _sample_inputs(24, 16, C, 6000, dev)
    before = ks.launch_counts()["kron_sample_dpoints"]
    g = cot if with_cot else None
    got = ks.kron_sample_dpoints(grid, pts, g, EXTENT)
    want = ks.kron_sample_dpoints_reference(grid, pts, g, EXTENT)
    torch.cuda.synchronize()
    assert ks.launch_counts()["kron_sample_dpoints"] == before + 1
    _assert_rel_close(got, want, 1e-4, f"d_points C {C}")


@pytest.mark.cuda
def test_dpoints_kernel_takes_an_unaligned_cotangent():
    """A cotangent view that starts off a 16-byte boundary takes the scalar
    channel loop at C 64, with the float4 path's result."""
    dev = _device()
    grid, pts, cot = _sample_inputs(25, 16, 64, 3000, dev)
    backing = torch.empty(cot.numel() + 1, device=dev)
    shifted = backing[1:].view(cot.shape)
    shifted.copy_(cot)
    assert shifted.data_ptr() % 16 != 0
    got = ks.kron_sample_dpoints(grid, pts, shifted, EXTENT)
    want = ks.kron_sample_dpoints(grid, pts, cot, EXTENT)
    torch.cuda.synchronize()
    _assert_rel_close(got, want, 1e-6, "unaligned cotangent")


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 64])
def test_dpoints_on_voxel_planes_and_outside_the_grid(C):
    """K6 at points exactly on x voxel planes and on the grid's faces: the x
    cotangent is exactly 0 (the hat's slope is 0 on a plane); beyond the grid
    every component is exactly 0 (zero padding); both as the plain version."""
    dev = _device()
    grid, _, _ = _sample_inputs(26, 16, C, 1, dev)
    on_plane, far = (x.to(dev) for x in _lattice_points(16, 27))
    for name, pts in (("on_plane", on_plane), ("outside", far)):
        cot = torch.randn((pts.shape[0], C), generator=torch.Generator().manual_seed(28)).to(dev)
        for g in (None, cot):
            got = ks.kron_sample_dpoints(grid, pts, g, EXTENT)
            want = ks.kron_sample_dpoints_reference(grid, pts, g, EXTENT)
            torch.cuda.synchronize()
            if name == "on_plane":
                _assert_rel_close(got, want, 1e-4, name)
                assert bool((got[:, 0] == 0).all()) and bool((want[:, 0] == 0).all()), "slope 0 on a plane"
            else:
                assert bool((got == 0).all()) and bool((want == 0).all()), "zero outside the grid"


@pytest.mark.cuda
def test_kron_sample_autograd_launches_only_the_cotangents_asked_for():
    """`trilinear_sample_fused` on the card: a grid-only backward launches
    K5 and no K6; `trilinear_point_gradient` one K6; gradients as the
    plain versions'."""
    dev = _device()
    grid, pts, cot = _sample_inputs(22, 16, 64, 4096, dev)
    g = grid.clone().requires_grad_(True)
    before = ks.launch_counts()
    (ks.trilinear_sample_fused(g, pts.reshape(64, 64, 3), EXTENT) * cot.reshape(64, 64, 64)).sum().backward()
    ks.trilinear_point_gradient(grid[..., :1], pts, EXTENT)
    torch.cuda.synchronize()
    after = ks.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "kron_sample_fwd": 1, "kron_sample_dgrid": 1, "kron_sample_dpoints": 1}
    _assert_rel_close(g.grad, ks.kron_sample_dgrid_reference(pts, cot, grid.shape, EXTENT), 1e-4, "d_grid")


@pytest.mark.cuda
def test_sampling_kernels_take_empty_and_strided_input():
    dev = _device()
    grid, pts, cot = _sample_inputs(23, 8, 8, 100, dev)
    before = ks.launch_counts()
    assert ks.kron_sample_fwd(grid, pts[:0], EXTENT).shape == (0, 8)
    assert ks.launch_counts() == before
    strided = pts.t().contiguous().t()
    assert not strided.is_contiguous()
    torch.testing.assert_close(ks.kron_sample_fwd(grid, strided, EXTENT), ks.kron_sample_fwd(grid, pts, EXTENT),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 3, 8, 64, 257])
def test_sample_kernel_matches_plain_by_channels(C):
    """K4 at every layout of `sample_layout` (one lane of scalars at C 1 and
    3, one lane of two float4 units at C 8, 4 lanes at C 64, 8 scalar lanes
    at C 257) on random points, on points exactly on x voxel planes and the
    grid's faces, and beyond the grid (exactly 0): 1e-5 absolute."""
    dev = _device()
    grid, pts, _ = _sample_inputs(29, 16, C, 6000, dev)
    on_plane, far = (x.to(dev) for x in _lattice_points(16, 30))
    before = ks.launch_counts()["kron_sample_fwd"]
    for name, p in (("random", pts), ("on_plane", on_plane), ("outside", far)):
        got = ks.kron_sample_fwd(grid, p, EXTENT)
        want = ks.kron_sample_fwd_reference(grid, p, EXTENT)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5, msg=name)
        if name == "outside":
            assert bool((got == 0).all()), "zero outside the grid"
    assert ks.launch_counts()["kron_sample_fwd"] == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("C", [64, 257])
def test_sample_kernel_takes_strided_empty_and_unaligned_input(C):
    """K4 on strided points gives the contiguous result; no points launch
    nothing; a grid view that starts off a 16-byte boundary takes single
    channels at C 64, with the float4 path's result."""
    dev = _device()
    grid, pts, _ = _sample_inputs(31, 16, C, 3000, dev)
    before = ks.launch_counts()
    assert ks.kron_sample_fwd(grid, pts[:0], EXTENT).shape == (0, C)
    assert ks.launch_counts() == before
    strided = pts.t().contiguous().t()
    assert not strided.is_contiguous()
    want = ks.kron_sample_fwd(grid, pts, EXTENT)
    torch.testing.assert_close(ks.kron_sample_fwd(grid, strided, EXTENT), want, rtol=0, atol=0)
    backing = torch.empty(grid.numel() + 1, device=dev)
    shifted = backing[1:].view(grid.shape)
    shifted.copy_(grid)
    assert shifted.data_ptr() % 16 != 0
    torch.testing.assert_close(ks.kron_sample_fwd(shifted, pts, EXTENT), want, rtol=0, atol=1e-6)


def _ray_points(seed, R, P):
    """(R, P, 3) points in depth order along R rays: origins at distance
    EXTENT in random directions, aimed within a quarter EXTENT of the
    centre, P sorted depths over [0.25, 1.75] x EXTENT."""
    rs = np.random.RandomState(seed)
    o = rs.randn(R, 3)
    o = EXTENT * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rs.uniform(-0.25, 0.25, (R, 3)) * EXTENT - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rs.uniform(0.25, 1.75, (R, P)), axis=-1) * EXTENT
    return torch.from_numpy((o[:, None] + t[..., None] * d[:, None]).astype(np.float32))


def _one_voxel_points(seed, R, P, D):
    """(R, P, 3) points that all lie strictly inside one voxel of a D^3 grid
    (every point shares the same 8 corner cells)."""
    rs = np.random.RandomState(seed)
    vs = EXTENT / D
    corner = (np.array([5, 7, 9]) - 0.5 * (D - 1)) * vs
    return torch.from_numpy((corner + rs.uniform(0.05, 0.95, (R, P, 3)) * vs).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("points", ["ray_ordered", "one_voxel"])
def test_backward_kernel_where_points_share_voxels(points):
    """K2 at hydrant width where consecutive points share corner cells, so
    its scatter merges them before the atomic: 24 rays of 128 points in
    depth order, and one 32-point tile (2 rays x 16) whose points all lie in
    one voxel. The five cotangents within 1e-3 of each one's scale, as on
    random points. (Over many points in one voxel, some pre-activation of
    nearly every column lies within rounding of 0, where the kernel and
    cuBLAS may take different leaky-ReLU slopes: the exception the tolerance
    states.) The one-voxel tile has no pre-activation within 3e-5 of 0, so
    there d_grid, dA and dc hold 1e-5 of scale: the three products keep
    float32 accuracy in the 3 x TF32 split, where one TF32 pass is off by
    about 2e-4 (`tests/test_torch_tf32_split.py`)."""
    dev = _device()
    R, P = (24, 128) if points == "ray_ordered" else (2, 16)
    sh = dict(D=16, C=64, hidden=256, R=R, P=P)
    grid, A, c, Wr, br, _, pe = (x.to(dev) for x in _inputs(32, **sh))
    pts = (_ray_points(33, R, P) if points == "ray_ordered" else _one_voxel_points(33, R, P, 16)).to(dev)
    g = _cotangent(34, R, P).to(dev)
    args = (grid, A, c, Wr, br, pts, pe, EXTENT, sh["hidden"], g)
    got = fd._fused_sample_decode_bwd_cuda(*args)
    want = fd.fused_sample_decode_bwd_reference(*args)
    torch.cuda.synchronize()
    assert float(want[0].abs().max()) > 0
    _assert_cotangents_close(got, want, 1e-3)
    if points == "one_voxel":
        _assert_cotangents_close(got[:3], want[:3], 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [32, 64])
def test_backward_kernel_with_a_ragged_last_tile(C):
    """K2 on 7 x 45 = 315 points, not a multiple of its 32-point tile:
    the last tile's missing points contribute nothing (1e-3 of scale)."""
    dev = _device()
    sh = dict(D=8 if C == 32 else 16, C=C, hidden=48 if C == 32 else 256, R=7, P=45)
    grid, A, c, Wr, br, pts, pe = (x.to(dev) for x in _inputs(35, **sh))
    g = _cotangent(36, 7, 45).to(dev)
    args = (grid, A, c, Wr, br, pts, pe, EXTENT, sh["hidden"], g)
    got = fd._fused_sample_decode_bwd_cuda(*args)
    want = fd.fused_sample_decode_bwd_reference(*args)
    torch.cuda.synchronize()
    _assert_cotangents_close(got, want, 1e-3)


@pytest.mark.cuda
def test_synthetic_scene_defaults_to_the_card():
    """`make_synthetic_scene` with no device builds its batch on the card."""
    _device()
    from holo_diffusion_torch.data.synthetic import make_synthetic_scene

    scene = make_synthetic_scene(n_views=2, image_size=8)
    assert scene.image_rgb.device.type == "cuda" and scene.camera.R.device.type == "cuda"


# ---- K7 on K4's layout and K5's run-merged scatter, at every layout they take


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 3, 8, 64, 257])
def test_onehot_sample_kernel_matches_plain_by_channels(C):
    """K7 at every layout of `sample_layout` on random points, on points
    exactly on x voxel planes and the grid's faces, and beyond the grid
    (exactly 0): 1e-5 absolute."""
    dev = _device()
    grid, pts, _ = _sample_inputs(37, 16, C, 6000, dev)
    on_plane, far = (x.to(dev) for x in _lattice_points(16, 38))
    before = fr.launch_counts()["trilinear_sample_onehot"]
    for name, p in (("random", pts), ("on_plane", on_plane), ("outside", far)):
        got = fr.trilinear_sample_pallas(grid, p, EXTENT)
        want = fr.trilinear_sample_onehot_reference(grid, p, EXTENT)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5, msg=name)
        if name == "outside":
            assert bool((got == 0).all()), "zero outside the grid"
    assert fr.launch_counts()["trilinear_sample_onehot"] == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("C", [64, 257])
def test_onehot_sample_kernel_takes_strided_empty_and_unaligned_input(C):
    """K7 on strided points gives the contiguous result; no points launch
    nothing; a grid view off a 16-byte boundary takes single channels at
    C 64, with the float4 path's result."""
    dev = _device()
    grid, pts, _ = _sample_inputs(39, 16, C, 3000, dev)
    before = fr.launch_counts()
    assert fr.trilinear_sample_pallas(grid, pts[:0], EXTENT).shape == (0, C)
    assert fr.launch_counts() == before
    strided = pts.t().contiguous().t()
    want = fr.trilinear_sample_pallas(grid, pts, EXTENT)
    torch.testing.assert_close(fr.trilinear_sample_pallas(grid, strided, EXTENT), want, rtol=0, atol=0)
    backing = torch.empty(grid.numel() + 1, device=dev)
    shifted = backing[1:].view(grid.shape)
    shifted.copy_(grid)
    assert shifted.data_ptr() % 16 != 0
    torch.testing.assert_close(fr.trilinear_sample_pallas(shifted, pts, EXTENT), want, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 3, 8, 64, 257])
def test_dgrid_kernel_matches_plain_by_channels(C):
    """K5 with float4 units (C 8, 64), single floats (C 1, 3) and two
    chunks of a row's units (C 257), on random points, on points exactly on
    x voxel planes and the grid's faces, and beyond the grid (exactly 0):
    1e-4 of scale (atomics in no fixed order)."""
    dev = _device()
    _, pts, cot = _sample_inputs(40, 16, C, 6000, dev)
    on_plane, far = (x.to(dev) for x in _lattice_points(16, 41))
    before = ks.launch_counts()["kron_sample_dgrid"]
    for name, p in (("random", pts), ("on_plane", on_plane), ("outside", far)):
        g = cot[:p.shape[0]]
        got = ks.kron_sample_dgrid(p, g, (16, 16, 16, C), EXTENT)
        want = ks.kron_sample_dgrid_reference(p, g, (16, 16, 16, C), EXTENT)
        torch.cuda.synchronize()
        if name == "outside":
            assert bool((got == 0).all()) and bool((want == 0).all()), "nothing outside the grid"
        else:
            _assert_rel_close(got, want, 1e-4, f"d_grid C {C} {name}")
    assert ks.launch_counts()["kron_sample_dgrid"] == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("C", [64, 257])
def test_dgrid_kernel_takes_strided_empty_and_unaligned_input(C):
    """K5 on strided points gives the contiguous result up to the atomics'
    order; no points launch nothing and give zeros; a cotangent view off a
    16-byte boundary takes single floats at C 64 with the float4 result."""
    dev = _device()
    _, pts, cot = _sample_inputs(42, 16, C, 3000, dev)
    shape = (16, 16, 16, C)
    before = ks.launch_counts()
    empty = ks.kron_sample_dgrid(pts[:0], cot[:0], shape, EXTENT)
    assert ks.launch_counts() == before and bool((empty == 0).all())
    want = ks.kron_sample_dgrid(pts, cot, shape, EXTENT)
    _assert_rel_close(ks.kron_sample_dgrid(pts.t().contiguous().t(), cot, shape, EXTENT), want, 1e-6, "strided")
    backing = torch.empty(cot.numel() + 1, device=dev)
    shifted = backing[1:].view(cot.shape)
    shifted.copy_(cot)
    assert shifted.data_ptr() % 16 != 0
    _assert_rel_close(ks.kron_sample_dgrid(pts, shifted, shape, EXTENT), want, 1e-6, "unaligned cotangent")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("points", ["ray_ordered", "one_voxel"])
def test_dgrid_kernel_where_points_share_cells(points):
    """K5 at C 64 where consecutive points share corner cells, so runs merge
    their atomics: 48 rays of 128 points in depth order, and 4,096 points
    in one voxel, where one run covers each whole tile (1e-4 of scale)."""
    dev = _device()
    pts = (_ray_points(43, 48, 128) if points == "ray_ordered" else _one_voxel_points(43, 32, 128, 16))
    pts = pts.reshape(-1, 3).to(dev)
    cot = torch.randn((pts.shape[0], 64), generator=torch.Generator().manual_seed(44)).to(dev)
    got = ks.kron_sample_dgrid(pts, cot, (16, 16, 16, 64), EXTENT)
    want = ks.kron_sample_dgrid_reference(pts, cot, (16, 16, 16, 64), EXTENT)
    torch.cuda.synchronize()
    assert float(want.abs().max()) > 0
    _assert_rel_close(got, want, 1e-4, points)


# ---- "auto" against what the fused-decode kernels launch


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [279, 280])
def test_auto_fused_decode_launches_only_what_the_kernels_take(hidden):
    """At C 64 with a 279-wide density net `kernels_take` holds and a
    forward and backward through "auto" launch K3 and K2; at 280 K2 cannot
    launch, so "auto" decodes layer by layer (K4, K5, K6) and no
    fused-decode kernel runs. Gradients as the plain path's on the CPU:
    1e-3 of scale."""
    from holo_diffusion_torch.models.implicit import VoxelGridImplicitFunction
    from holo_diffusion_torch.weights import init_weights

    dev = _device()
    fn = init_weights(VoxelGridImplicitFunction(
        resol=16, volume_extent=EXTENT, n_hidden=64, render_normals=True,
        render_mlp_args=dict(dnet_hidden_dim=hidden, rnet_hidden_dim=16)), seed=0)
    assert fd.kernels_take(64, hidden, fn.render_mlp.pe_dim) == (hidden == 279)
    grid, _, _ = _sample_inputs(45, 16, 64, 1, dev)
    pts = _ray_points(46, 8, 32)
    dirs = torch.randn((8, 3), generator=torch.Generator().manual_seed(47))
    grads = {}
    for label, d in (("card", dev), ("cpu", torch.device("cpu"))):
        f = fn.to(d)
        f.zero_grad()
        g = grid.to(d).clone().requires_grad_(True)
        before = {**fd.launch_counts(), **ks.launch_counts()}
        dens, rgb, _ = f(g, pts.to(d), dirs.to(d))
        (dens.square().sum() + rgb.sum()).backward()
        if d.type == "cuda":
            torch.cuda.synchronize()
            after = {**fd.launch_counts(), **ks.launch_counts()}
            launched = {k for k in after if after[k] > before[k]}
            if hidden == 279:
                assert launched == {"fused_decode_fwd_normals", "fused_decode_bwd"}
            else:
                assert launched == {"kron_sample_fwd", "kron_sample_dgrid", "kron_sample_dpoints"}
        grads[label] = [g.grad.cpu()] + [p.grad.cpu() for p in f.parameters()]
    for a, b in zip(grads["card"], grads["cpu"]):
        _assert_rel_close(a, b, 1e-3, "gradient")


@pytest.mark.cuda
def test_golden_toy_model_renders_on_the_card_with_default_arguments():
    """The goldens' toy model (C 8, default fuse_decode) renders on the card:
    "auto" takes the layer-by-layer decode, K4 samples, no fused-decode
    kernel launches, and the frame is the CPU's within 2e-3."""
    from torch_toy_model import TOY

    from holo_diffusion_torch.models.holo_model import HoloDiffusionModel
    from holo_diffusion_torch.render_eval import render_image_chunked
    from holo_diffusion_torch.utils.flyaround import simple_360_cameras
    from holo_diffusion_torch.weights import init_weights

    dev = _device()
    model = init_weights(HoloDiffusionModel(**TOY), seed=0).eval()
    grid = torch.tanh(torch.randn((8, 8, 8, 8), generator=torch.Generator().manual_seed(48)))
    cam = simple_360_cameras(1, dist=4.0)
    before = {**fd.launch_counts(), **ks.launch_counts()}
    with torch.no_grad():
        card = render_image_chunked(model.to(dev), cam, grid.to(dev), device=dev)
        torch.cuda.synchronize()
        after = {**fd.launch_counts(), **ks.launch_counts()}
        cpu = render_image_chunked(model.cpu(), cam, grid, device="cpu")
    assert all(after[k] == before[k] for k in fd.ENTRY_POINTS)
    assert after["kron_sample_fwd"] > before["kron_sample_fwd"]
    assert set(card) == set(cpu)
    for k in cpu:
        assert bool(torch.isfinite(card[k]).all())
        torch.testing.assert_close(card[k].cpu(), cpu[k], rtol=0, atol=2e-3, msg=k)


@pytest.mark.cuda
def test_experiment_runs_and_resumes_on_the_card(tmp_path):
    """The tiny synthetic experiment with no device given (the card): two
    epochs with validation, whose training steps launch the fused-decode
    backward twice each; the checkpoint restores run A's final state
    bitwise; a new run resumes and takes only epoch 2's steps."""
    from torch_tiny_config import LOOP, tiny_cfg

    from holo_diffusion_torch.experiment import Experiment
    from holo_diffusion_torch.train.checkpoint import restore_checkpoint

    dev = _device()
    cfg = tiny_cfg(tmp_path / "exp", ["disable_validation=false", LOOP + "visualize_interval=0"])
    before = fd.launch_counts()["fused_decode_bwd"]
    state, stats = Experiment(cfg).run(max_epochs=2)
    torch.cuda.synchronize()
    assert state.step == 4 and stats.epoch == 1
    assert next(state.model.parameters()).device.type == dev.type
    assert fd.launch_counts()["fused_decode_bwd"] - before == 2 * state.step
    assert all(np.isfinite(v) for e in stats.history for s in ("train", "val") for v in e[s].values())

    exp = Experiment(cfg)
    restored, epoch = restore_checkpoint(exp.exp_dir, exp.init_state())
    assert epoch == 1 and restored.step == 4 and restored.optimizer.steps == 4
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, restored.model.state_dict()[k]), k
    saved = state.optimizer.optimizer.state_dict()["state"]
    got = restored.optimizer.optimizer.state_dict()["state"]
    assert set(saved) == set(got) and saved
    for i, s in saved.items():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(s[name], got[i][name]), (i, name)

    resumed, stats = Experiment(cfg).run(max_epochs=3)
    assert resumed.step == 6 and resumed.optimizer.steps == 6
    assert [e["epoch"] for e in stats.history] == [0, 1, 2]


@pytest.mark.cuda
def test_pinned_batch_copy_is_bitwise_and_not_overwritten(tmp_path):
    """A CO3D batch (uint8 images and masks, float16 depths) goes to the
    card through `FrameData.pin_memory()` and a `non_blocking` copy, as the
    loop's loader thread sends it, bitwise. Its pinned buffer, freed right
    after the copy is queued behind a long kernel, is not handed out again
    before the copy reads it: buffers taken and overwritten meanwhile leave
    the card's copy intact."""
    from holo_diffusion_torch.data.co3d import CO3DDataProvider
    from holo_diffusion_torch.data.synthetic_co3d import write_synthetic_co3d

    dev = _device()
    write_synthetic_co3d(str(tmp_path), n_seq=1, n_frames=4, H=90, W=120, seed=1)
    batch = CO3DDataProvider(category="synthball", dataset_root=str(tmp_path), image_height=256,
                             image_width=256).train.sample_batch(np.random.RandomState(0), 4)
    assert batch.image_rgb.dtype == torch.uint8 and batch.depth_map.dtype == torch.float16
    want = batch.image_rgb.clone()
    a = torch.randn(4096, 4096, device=dev)
    for _ in range(8):  # keep the stream busy, so the copy waits
        a = a @ a / 64.0
    pinned = batch.pin_memory()
    assert pinned.image_rgb.is_pinned() and pinned.camera.R.is_pinned()
    on_card = pinned.to(dev, non_blocking=True)
    del pinned
    for _ in range(4):
        junk = torch.empty(batch.image_rgb.shape, dtype=torch.uint8, pin_memory=True)
        junk.fill_(7)
    torch.cuda.synchronize()
    for f in ("image_rgb", "fg_probability", "mask_crop", "depth_map", "sequence_id"):
        assert torch.equal(getattr(on_card, f).cpu(), getattr(batch, f)), f
    assert torch.equal(on_card.image_rgb.cpu(), want)
    assert torch.equal(on_card.camera.T.cpu(), batch.camera.T)


@pytest.mark.cuda
def test_co3d_experiment_runs_on_the_card(tmp_path):
    """The tiny experiment on a CO3D tree with no device given: host-cached
    uint8/float16 batches pinned and copied by the loader, two steps with
    validation, the fused-decode backward twice a step; a resume takes one
    more epoch."""
    from torch_tiny_config import tiny_co3d_cfg

    from holo_diffusion_torch.data.synthetic_co3d import write_synthetic_co3d
    from holo_diffusion_torch.experiment import Experiment

    _device()
    root = str(tmp_path / "co3d")
    write_synthetic_co3d(root, n_seq=2, n_frames=6, H=48, W=64, seed=3)
    extra = ["disable_validation=false", "training_loop_ImplicitronTrainingLoop_args.visualize_interval=0"]
    cfg = tiny_co3d_cfg(tmp_path / "exp", root, extra=extra)
    before = fd.launch_counts()["fused_decode_bwd"]
    state, stats = Experiment(cfg).run(max_epochs=1)
    torch.cuda.synchronize()
    assert state.step == 2 and fd.launch_counts()["fused_decode_bwd"] - before == 4
    assert all(np.isfinite(v) for e in stats.history for s in ("train", "val") for v in e[s].values())
    state, stats = Experiment(cfg).run(max_epochs=2)
    assert state.step == 4 and [e["epoch"] for e in stats.history] == [0, 1]
