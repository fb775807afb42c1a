"""The port's sampling kernels' plain versions (holo_diffusion_torch:
ops/kron_sample.py, K4/K5/K6; ops/fused_render.py, K7; the packed sampler
of ops/voxel.py) against the JAX package on the same numpy inputs, on the
CPU: JAX runs its Pallas kernels in interpret mode at precision="highest".
The CUDA kernels run only on the card (tests/test_torch_kernels_cuda.py and
chip_smoke.py hold them against these plain versions)."""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holo_diffusion_tpu.ops.pallas import fused_render as jfr
from holo_diffusion_tpu.ops.pallas import kron_sample as jks
from holo_diffusion_tpu.ops import voxel as jvoxel
from holo_diffusion_torch.ops import _build
from holo_diffusion_torch.ops import fused_render as fr
from holo_diffusion_torch.ops import kron_sample as ks
from holo_diffusion_torch.ops import voxel

EXTENT = 4.0


def _data(D, C, n, seed, off_planes=False):
    """A grid and world points inside it and up to 30 % beyond it. With
    `off_planes` no coordinate lies within 1e-3 voxels of a voxel plane
    (where the hat slope's subgradient is a matter of rounding)."""
    rs = np.random.RandomState(seed)
    grid = rs.randn(D, D, D, C).astype(np.float32)
    half = EXTENT * (D - 1) / D / 2 * 1.3
    pts = rs.uniform(-half, half, (n, 3)).astype(np.float32)
    if off_planes:
        vs = EXTENT / D
        idx = pts / vs + (D - 1) / 2.0
        frac = idx - np.floor(idx)
        idx = np.where(frac < 1e-3, idx + 2e-3, np.where(frac > 1 - 1e-3, idx - 2e-3, idx))
        pts = ((idx - (D - 1) / 2.0) * vs).astype(np.float32)
    return grid, pts


@pytest.mark.parametrize("D,C", [(4, 8), (8, 32), (16, 64)])
def test_k4_plain_matches_jax_kernel(D, C):
    grid, pts = _data(D, C, 300, seed=D)
    want = jks.trilinear_sample_fused(jnp.asarray(grid), jnp.asarray(pts), EXTENT, block_n=64, interpret=True,
                                      precision="highest")
    got = ks.trilinear_sample_fused(torch.from_numpy(grid), torch.from_numpy(pts), EXTENT)
    assert tuple(got.shape) == (300, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _jax_grads(grid, pts, ct):
    def loss(g, p):
        return jnp.sum(jks.trilinear_sample_fused(g, p, EXTENT, block_n=64, interpret=True, precision="highest")
                       * ct)

    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(grid), jnp.asarray(pts))


def test_k5_k6_plain_through_autograd_match_jax_grad():
    """The grid cotangent (K5's plain version) and the points cotangent
    (K6's) through `KronSample` against `jax.grad` of sum(out * ct), points
    reshaped to (2, 5, 20, 3): 1e-4 absolute and relative."""
    grid, pts = _data(8, 16, 200, seed=3, off_planes=True)
    ct = np.random.RandomState(4).randn(200, 16).astype(np.float32)
    j_dgrid, j_dpts = _jax_grads(grid, pts, ct)
    g = torch.from_numpy(grid).requires_grad_(True)
    p = torch.from_numpy(pts).reshape(2, 5, 20, 3).requires_grad_(True)
    out = ks.trilinear_sample_fused(g, p, EXTENT)
    assert tuple(out.shape) == (2, 5, 20, 16)
    (out * torch.from_numpy(ct).reshape(2, 5, 20, 16)).sum().backward()
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(j_dgrid), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(p.grad.reshape(200, 3).numpy(), np.asarray(j_dpts), atol=1e-4, rtol=1e-4)


def test_backward_launches_only_what_needs_a_gradient(monkeypatch):
    """`KronSample.backward` calls the grid cotangent (K5) only for a grid
    that needs a gradient and the points cotangent (K6) only for points
    that do, as XLA drops the unused d_points call in the JAX package: a
    grid-only backward leaves the points' gradient None."""
    calls = []
    for name in ("kron_sample_dgrid", "kron_sample_dpoints"):
        fn = getattr(ks, name)
        monkeypatch.setattr(ks, name, lambda *a, _fn=fn, _name=name: calls.append(_name) or _fn(*a))
    grid, pts = _data(4, 8, 50, seed=5)
    ct = torch.from_numpy(np.random.RandomState(6).randn(50, 8).astype(np.float32))
    g = torch.from_numpy(grid).requires_grad_(True)
    p = torch.from_numpy(pts)
    (ks.trilinear_sample_fused(g, p, EXTENT) * ct).sum().backward()
    assert calls == ["kron_sample_dgrid"] and p.grad is None and g.grad is not None
    p = torch.from_numpy(pts).requires_grad_(True)
    (ks.trilinear_sample_fused(torch.from_numpy(grid), p, EXTENT) * ct).sum().backward()
    assert calls == ["kron_sample_dgrid", "kron_sample_dpoints"] and p.grad.shape == p.shape
    assert not any(_build.launch_counts().values())


@pytest.mark.parametrize("off_planes", [True, False], ids=["off_planes", "random"])
def test_trilinear_point_gradient_matches_jax(off_planes):
    """The C = 1 field gradient (K6 with the ones cotangent) against JAX's
    direct `_dpoints_kernel` call, on (3, 40, 3) points: 1e-4. Random points
    sit on no plane exactly, so both sides take the same slopes."""
    grid, pts = _data(8, 1, 120, seed=7, off_planes=off_planes)
    pts = pts.reshape(3, 40, 3)
    want = jks.trilinear_point_gradient(jnp.asarray(grid), jnp.asarray(pts), EXTENT, block_n=64, interpret=True,
                                        precision="highest")
    g = torch.from_numpy(grid).requires_grad_(True)
    got = ks.trilinear_point_gradient(g, torch.from_numpy(pts), EXTENT)
    assert tuple(got.shape) == (3, 40, 3) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_point_gradient_is_zero_along_an_axis_on_its_plane():
    """A coordinate exactly on a voxel plane has hat slope 0 along it."""
    D = 8
    grid = torch.from_numpy(np.random.RandomState(8).randn(D, D, D, 3).astype(np.float32))
    vs = EXTENT / D
    pts = torch.tensor([[(2 - (D - 1) / 2.0) * vs, 0.13, -0.41]], dtype=torch.float32)
    d = ks.kron_sample_dpoints_reference(grid, pts, None, EXTENT)
    assert float(d[0, 0]) == 0.0 and float(d[0, 1]) != 0.0 and float(d[0, 2]) != 0.0


@pytest.mark.parametrize("shape", [(300,), (2, 8, 16)], ids=["flat", "multidim"])
def test_k7_plain_matches_jax_pallas_interpret(shape):
    n = int(np.prod(shape))
    grid, pts = _data(8, 16, n, seed=9)
    pts = pts.reshape(*shape, 3)
    want = jfr.trilinear_sample_pallas(jnp.asarray(grid), jnp.asarray(pts), EXTENT, block_n=64, interpret=True)
    got = fr.trilinear_sample_pallas(torch.from_numpy(grid), torch.from_numpy(pts), EXTENT)
    assert tuple(got.shape) == (*shape, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert not any(_build.launch_counts().values())


def test_k7_is_forward_only():
    grid, pts = _data(4, 8, 10, seed=10)
    g = torch.from_numpy(grid).requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        fr.trilinear_sample_pallas(g, torch.from_numpy(pts), EXTENT)
    with torch.no_grad():
        assert fr.trilinear_sample_pallas(g, torch.from_numpy(pts), EXTENT).shape == (10, 8)


def test_onehot_xla_matches_jax():
    grid, pts = _data(8, 16, 300, seed=11)
    want = jfr.trilinear_sample_onehot_xla(jnp.asarray(grid), jnp.asarray(pts), EXTENT, block_n=128)
    got = fr.trilinear_sample_onehot_xla(torch.from_numpy(grid), torch.from_numpy(pts), EXTENT, block_n=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_packed_sampler_matches_jax():
    grid, pts = _data(8, 16, 300, seed=12)
    packed = voxel.pack_corner_grid(torch.from_numpy(grid))
    j_packed = jvoxel.pack_corner_grid(jnp.asarray(grid))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(j_packed))
    got = voxel.sample_packed_voxel_grid_world(packed, torch.from_numpy(pts).reshape(3, 100, 3), EXTENT)
    want = jvoxel.sample_packed_voxel_grid_world(j_packed, jnp.asarray(pts).reshape(3, 100, 3), EXTENT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("bad", ["dtype", "device_mismatch", "cotangent_shape", "points_shape"])
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(bad):
    """The argument checks run before any library is loaded."""
    grid, pts = (torch.from_numpy(x) for x in _data(4, 8, 10, seed=13))
    g = torch.zeros((10, 8))
    if bad == "dtype":
        grid, err = grid.double(), TypeError
    elif bad == "device_mismatch":
        grid, err = grid.to("meta"), ValueError
    elif bad == "cotangent_shape":
        g, err = g[:, :7], ValueError
    else:
        pts, err = pts[:, :2], ValueError
    with pytest.raises(err):
        ks._dpoints_cuda(grid, pts, g, EXTENT)
