"""The backward of the port's fused sample+decode
(holo_diffusion_torch/ops/fused_decode.py: `fused_sample_decode_bwd_reference`
and the `FusedSampleDecode` autograd Function) against the JAX package's
custom VJP, which runs its Pallas backward kernel in interpret mode, and
against torch autograd of the plain forward. The CUDA kernel itself runs
only on the card: tests/test_torch_kernels_cuda.py and chip_smoke.py hold it
against the plain version there."""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holo_diffusion_tpu.ops.pallas.fused_decode import fused_sample_decode as jax_fused
from holo_diffusion_torch.ops import _build
from holo_diffusion_torch.ops import fused_decode as fd

D, C, HIDDEN, PE_DIM, EXTENT = 8, 32, 48, 27, 4.0
R, P = 6, 9
NAMES = ("d_grid", "dA", "dc", "dWr", "dbr")
# float32 on both sides, summed in other orders (gathers + matmuls here, a
# one-hot MXU product in the interpreted Pallas kernel); relative to each
# cotangent's largest magnitude
REL_TOL = 1e-5


def _inputs(seed, channels=C):
    rs = np.random.RandomState(seed)
    grid = np.tanh(rs.randn(D, D, D, channels)).astype(np.float32)
    A = (rs.randn(channels, HIDDEN + 1) / 6).astype(np.float32)
    c = (rs.randn(HIDDEN + 1) * 0.1).astype(np.float32)
    Wr = (rs.randn(HIDDEN + PE_DIM, 3) / 8).astype(np.float32)
    br = (rs.randn(3) * 0.1).astype(np.float32)
    # world range +-2.3: points inside the grid (voxel centres span +-1.75)
    # and outside it; the last ray sits exactly on voxel planes
    pts = rs.uniform(-2.3, 2.3, (R, P, 3)).astype(np.float32)
    vs = EXTENT / D
    pts[-1] = ((rs.randint(-1, D + 1, (P, 3)) - (D - 1) / 2.0) * vs).astype(np.float32)
    pe = rs.randn(R, PE_DIM).astype(np.float32)
    g = rs.randn(R, P, 7).astype(np.float32)  # [density | rgb | normals]
    return grid, A, c, Wr, br, pts, pe, g


def _assert_close(got, want, tol=REL_TOL):
    for name, a, b in zip(NAMES, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        scale = max(float(np.abs(b).max()), 1e-12)
        err = float(np.abs(a - b).max())
        assert err <= tol * scale, f"{name}: max|diff| {err:.3e} > {tol} x {scale:.3e}"


def _jax_vjp(grid, A, c, Wr, br, pts, pe, g, normals):
    g1 = jnp.asarray(np.einsum("dhwc,c->dhw", grid, A[:, -1])) if normals else None
    pe_pts = jnp.asarray(np.broadcast_to(pe[:, None], (R, P, PE_DIM)))

    def f(*params):
        return jax_fused(*params, jnp.asarray(pts), pe_pts, extent=EXTENT, hidden=HIDDEN,
                         interpret=True, precision="highest", g1=g1)

    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (grid, A, c, Wr, br)))
    cot = (jnp.asarray(g[..., :1]), jnp.asarray(g[..., 1:4]))
    if normals:
        cot = cot + (jnp.asarray(g[..., 4:7]),)
    return [np.asarray(x) for x in vjp(cot)]


@pytest.mark.parametrize("normals", [False, True], ids=["K1", "K3"])
@pytest.mark.parametrize("channels", [C, 128])
def test_plain_backward_matches_jax_kernel(normals, channels):
    """With g1 the forward has a normals output; its cotangent (random here)
    is dropped by both. At C 128 (the reference model's grid width) too."""
    grid, A, c, Wr, br, pts, pe, g = _inputs(3, channels)
    want = _jax_vjp(grid, A, c, Wr, br, pts, pe, g, normals)
    got = fd.fused_sample_decode_bwd_reference(
        *(torch.from_numpy(x) for x in (grid, A, c, Wr, br, pts, pe)), EXTENT, HIDDEN,
        torch.from_numpy(g if normals else g[..., :4]))
    _assert_close([x.numpy() for x in got], want)


def _autograd_of_plain_forward(inputs, g):
    grid, A, c, Wr, br, pts, pe = inputs
    params = [x.clone().requires_grad_(True) for x in (grid, A, c, Wr, br)]
    dens, rgb = fd.fused_sample_decode_reference(*params, pts, pe, EXTENT, HIDDEN)
    torch.autograd.backward((dens, rgb), (g[..., :1], g[..., 1:4]))
    return [p.grad for p in params]


def test_plain_backward_matches_autograd_of_plain_forward():
    """torch's leaky_relu backward has slope 0.2 at exactly 0, the kernels
    (and JAX's `_dlrelu`) slope 1; random inputs put no pre-activation at
    exactly 0, so the two agree here."""
    grid, A, c, Wr, br, pts, pe, g = (torch.from_numpy(x) for x in _inputs(5))
    inputs = (grid, A, c, Wr, br, pts, pe)
    want = _autograd_of_plain_forward(inputs, g)
    got = fd.fused_sample_decode_bwd_reference(*inputs, EXTENT, HIDDEN, g[..., :4])
    _assert_close([x.numpy() for x in got], [x.numpy() for x in want])


def test_plain_backward_follows_the_kernel_subgradient_at_zero():
    """A pre-activation at exactly 0 takes slope 1 (the kernel's choice)."""
    grid, A, c, Wr, br, pts, pe, g = (torch.from_numpy(x) for x in _inputs(6))
    A = torch.zeros_like(A)
    c = torch.zeros_like(c)  # pre == 0 for every point and column
    got = fd.fused_sample_decode_bwd_reference(grid, A, c, Wr, br, pts, pe, EXTENT, HIDDEN, g[..., :4])
    torch.testing.assert_close(got[2][HIDDEN], g[..., 0].sum(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("normals", [False, True], ids=["K1", "K3"])
def test_autograd_function_on_cpu(normals):
    """`fused_sample_decode` with inputs that require grad goes through the
    Function: its gradients are the plain backward's, bit for bit, and match
    JAX; points, pe_dirs and g1 get none; no kernel launch is counted."""
    arrays = _inputs(7)
    grid, A, c, Wr, br, pts, pe, g = (torch.from_numpy(x) for x in arrays)
    params = [x.clone().requires_grad_(True) for x in (grid, A, c, Wr, br)]
    pts = pts.clone().requires_grad_(False)
    g1 = torch.einsum("dhwc,c->dhw", grid, A[:, -1]) if normals else None
    _build.reset_launch_counts()
    out = fd.fused_sample_decode(*params, pts, pe, EXTENT, HIDDEN, g1=g1)
    assert out[0].grad_fn is not None
    if normals:
        assert not out[2].requires_grad
    torch.autograd.backward(out[:2], (g[..., :1], g[..., 1:4]))
    plain = fd.fused_sample_decode_bwd_reference(grid, A, c, Wr, br, pts, pe, EXTENT, HIDDEN, g[..., :4])
    for p, want in zip(params, plain):
        assert torch.equal(p.grad, want)
    _assert_close([p.grad.numpy() for p in params], _jax_vjp(*arrays[:-1], np.asarray(g), normals))
    assert pts.grad is None
    assert not any(_build.launch_counts().values())


def test_no_grad_call_bypasses_the_function():
    grid, A, c, Wr, br, pts, pe, _ = (torch.from_numpy(x) for x in _inputs(8))
    A.requires_grad_(True)
    with torch.no_grad():
        dens, _ = fd.fused_sample_decode(grid, A, c, Wr, br, pts, pe, EXTENT, HIDDEN)
    assert dens.grad_fn is None


@pytest.mark.parametrize("bad", ["cotangent_shape", "channels"])
def test_backward_wrapper_rejects_what_the_kernel_does_not_take(bad):
    """The argument checks run before any library is loaded."""
    grid, A, c, Wr, br, pts, pe, g = (torch.from_numpy(x) for x in _inputs(9))
    g = g[..., :4]
    if bad == "cotangent_shape":
        g, err = g[:, :-1], ValueError
    else:
        grid, A, err = grid[..., :24].contiguous(), A[:24], NotImplementedError
    with pytest.raises(err):
        fd._fused_sample_decode_bwd_cuda(grid, A, c, Wr, br, pts, pe, EXTENT, HIDDEN, g)
