"""The port's fused sample+decode (holo_diffusion_torch/ops/fused_decode.py)
against the JAX Pallas kernel in interpret mode, and the trilinear sampler
against the JAX gather sampler. The CUDA kernel itself runs only on the card:
tests/test_torch_kernels_cuda.py and chip_smoke.py hold it against the plain
version there."""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holo_diffusion_tpu.ops.pallas.fused_decode import fused_sample_decode as jax_fused
from holo_diffusion_tpu.ops.voxel import sample_voxel_grid_world as jax_sample
from holo_diffusion_tpu.ops.voxel import voxel_coord_grid as jax_coord_grid
from holo_diffusion_torch.ops import fused_decode as fd
from holo_diffusion_torch.ops.voxel import sample_voxel_grid_world, voxel_coord_grid

D, C, HIDDEN, PE_DIM, EXTENT = 8, 32, 48, 27, 4.0
R, P = 6, 9


def _inputs(seed, on_planes=False, channels=C):
    rs = np.random.RandomState(seed)
    grid = np.tanh(rs.randn(D, D, D, channels)).astype(np.float32)
    A = (rs.randn(channels, HIDDEN + 1) / 6).astype(np.float32)
    c = (rs.randn(HIDDEN + 1) * 0.1).astype(np.float32)
    Wr = (rs.randn(HIDDEN + PE_DIM, 3) / 8).astype(np.float32)
    br = (rs.randn(3) * 0.1).astype(np.float32)
    # world range +-2.3 covers the grid (+-1.75 at voxel centres) and beyond
    pts = rs.uniform(-2.3, 2.3, (R, P, 3)).astype(np.float32)
    if on_planes:
        # every coordinate exactly on a voxel plane: the hat derivative is 0
        vs = EXTENT / D
        pts = ((rs.randint(-1, D + 1, (R, P, 3)) - (D - 1) / 2.0) * vs).astype(np.float32)
    pe = rs.randn(R, PE_DIM).astype(np.float32)
    return grid, A, c, Wr, br, pts, pe


def _run_both(inputs, normals):
    grid, A, c, Wr, br, pts, pe = inputs
    g1 = np.einsum("dhwc,c->dhw", grid, A[:, -1]) if normals else None
    j_out = jax_fused(
        *(jnp.asarray(x) for x in (grid, A, c, Wr, br, pts)),
        jnp.asarray(np.broadcast_to(pe[:, None], (R, P, PE_DIM))),
        extent=EXTENT, hidden=HIDDEN, interpret=True, precision="highest",
        g1=None if g1 is None else jnp.asarray(g1),
    )
    t_out = fd.fused_sample_decode(
        *(torch.from_numpy(x) for x in (grid, A, c, Wr, br, pts, pe)),
        EXTENT, HIDDEN, g1=None if g1 is None else torch.from_numpy(g1),
    )
    return [np.asarray(x) for x in j_out], [x.numpy() for x in t_out]


@pytest.mark.parametrize("normals", [False, True], ids=["K1", "K3"])
@pytest.mark.parametrize("on_planes", [False, True], ids=["off_planes", "on_planes"])
@pytest.mark.parametrize("channels", [C, 128])
def test_plain_matches_jax_kernel(normals, on_planes, channels):
    """Both float32 (JAX at precision="highest"); the kernels sum in another
    order than the gather + matmul, so 1e-5 relative with a 1e-6 floor. At
    C 128 (the reference model's grid width) too: 8^3 x 128 is within the
    JAX package's size limit for its fused decode."""
    j_out, t_out = _run_both(_inputs(3, on_planes, channels), normals)
    assert len(t_out) == (3 if normals else 2)
    for a, b in zip(j_out, t_out):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_sample_voxel_grid_world_matches_jax():
    grid, *_, pts, _ = _inputs(5)
    a = np.asarray(jax_sample(jnp.asarray(grid), jnp.asarray(pts), EXTENT))
    b = sample_voxel_grid_world(torch.from_numpy(grid), torch.from_numpy(pts), EXTENT).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def test_voxel_coord_grid_matches_jax_and_samples_the_centres():
    """The voxel centres in the grid's (D, H, W) order: sampling there gives
    the grid back."""
    coords = voxel_coord_grid(D, EXTENT)
    np.testing.assert_allclose(coords.numpy(), np.asarray(jax_coord_grid(D, EXTENT)), atol=1e-6)
    grid = torch.from_numpy(_inputs(6)[0])
    np.testing.assert_allclose(sample_voxel_grid_world(grid, coords, EXTENT).numpy(), grid.numpy(), atol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper is the plain version, bit for bit, and no
    kernel launch is counted."""
    grid, A, c, Wr, br, pts, pe = (torch.from_numpy(x) for x in _inputs(7))
    g1 = torch.einsum("dhwc,c->dhw", grid, A[:, -1])
    fd.reset_launch_counts()
    out = fd.fused_sample_decode(grid, A, c, Wr, br, pts, pe, EXTENT, HIDDEN, g1=g1)
    ref = fd.fused_sample_decode_reference(grid, A, c, Wr, br, pts, pe, EXTENT, HIDDEN, g1=g1)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert fd.launch_counts() == {name: 0 for name in fd.ENTRY_POINTS}


@pytest.mark.parametrize("bad", ["dtype", "channels", "pe_per_point", "misaligned"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad):
    """The argument checks run before any library is loaded."""
    grid, A, c, Wr, br, pts, pe = (torch.from_numpy(x) for x in _inputs(9))
    if bad == "dtype":
        grid = grid.double()
        err = TypeError
    elif bad == "channels":
        grid, A = grid[..., :24].contiguous(), A[:24]
        err = NotImplementedError
    elif bad == "pe_per_point":
        pe = pe[:, None].expand(R, P, PE_DIM)
        err = ValueError
    else:
        # a contiguous view 4 bytes into its storage: no float4 reads
        grid = torch.cat([grid.new_zeros(1), grid.reshape(-1)])[1:].view(grid.shape)
        err = ValueError
    with pytest.raises(err, match="16-byte" if bad == "misaligned" else None):
        fd._fused_sample_decode_cuda(grid, A, c, Wr, br, pts, pe, EXTENT, HIDDEN, None)
