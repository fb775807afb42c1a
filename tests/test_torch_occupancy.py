"""The evaluation-only empty-space skip of the port (holo_diffusion_torch:
ops/occupancy.py, render_eval.compute_occupancy and the occupancy arguments
of render_image_chunked) against the JAX package's, on the CPU, with the JAX
model's weights carried across.

Tolerances: the occupancy mask from the same raw densities is bitwise (a
threshold and max pools); tightened lengths 1e-5 (linspace and float32
arithmetic in another order); the probe's raw densities 1e-5, and its masks
equal at every cell whose raw density is more than 1e-4 from the threshold;
renders 2e-4 on images, masks and normals and 1e-3 on depths, as the
serving slice's chunked renders (tests/test_torch_slice.py)."""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from holo_diffusion_torch.geometry.cameras import PerspectiveCameras
from holo_diffusion_torch.geometry.rays import RayBundle
from holo_diffusion_torch.models.holo_model import HoloDiffusionModel
from holo_diffusion_torch.ops import _build
from holo_diffusion_torch.ops.occupancy import occupancy_from_density, tighten_ray_bundle
from holo_diffusion_torch.render_eval import compute_occupancy, render_image_chunked
from holo_diffusion_torch.weights import state_dict_from_jax
from holo_diffusion_tpu.geometry.rays import RayBundle as JRayBundle
from holo_diffusion_tpu.models.holo_model import HoloDiffusionModel as JModel
from holo_diffusion_tpu.ops import occupancy as jocc
from holo_diffusion_tpu.ops.voxel import voxel_coord_grid as j_voxel_grid
from holo_diffusion_tpu.render_eval import compute_occupancy as j_compute_occupancy
from holo_diffusion_tpu.render_eval import render_image_chunked as j_render_chunked
from holo_diffusion_tpu.utils.flyaround import simple_360_cameras as j_simple_360

# the JAX occupancy test's model (tests/test_flyaround.py TINY), serving only
TINY = dict(
    resol=4, volume_extent=3.0, feature_size=32, n_pts_per_ray_evaluation=8, n_pts_per_ray_fine_evaluation=4,
    render_image_height=12, render_image_width=12, scene_extent=1.2, chunk_size_grid=48, render_normals=True,
    net_3d_enabled=False, diffusion_enabled=False, view_pooler_enabled=False,
    render_mlp_args=dict(dnet_hidden_dim=16, rnet_hidden_dim=16),
)
R_PROBE = 8


def _port_cam(jc):
    return PerspectiveCameras(*(torch.from_numpy(np.array(getattr(jc, f)))
                                for f in ("R", "T", "focal_length", "principal_point")))


def _probe_points():
    """compute_occupancy's probe: the lattice's voxel centres, then one
    point far outside the volume."""
    return np.concatenate([np.asarray(j_voxel_grid(R_PROBE, 3.0)).reshape(-1, 3),
                           np.full((1, 3), 1e6, np.float32)])


@pytest.fixture(scope="module")
def models():
    jm = JModel(**TINY)
    cam = j_simple_360(2, dist=3.0, up=(0.0, 1.0, 0.0))
    variables = jax.jit(lambda k, c, v: jm.init(k, camera=c, voxel_features=v, training=False))(
        jax.random.PRNGKey(0), cam[:1], jnp.zeros((1, 4, 4, 4, 32)))
    flat = {k: np.asarray(v) for k, v in flatten_dict(variables["params"], sep="/").items()}
    tm = HoloDiffusionModel(**TINY)
    tm.load_state_dict(state_dict_from_jax(flat), strict=True)
    tm.eval()
    grid = np.tanh(np.random.RandomState(2).randn(4, 4, 4, 32) * 2.0).astype(np.float32)
    return jm, variables, tm, cam, grid


@pytest.mark.parametrize("dilate", [0, 1, 2])
def test_occupancy_from_density_is_bitwise_jax(dilate):
    raw = np.random.RandomState(dilate).randn(9, 9, 9).astype(np.float32) - 1.5
    for thr in (0.0, 0.5):
        got = occupancy_from_density(torch.from_numpy(raw), thr, dilate)
        want = jocc.occupancy_from_density(jnp.asarray(raw), thr, dilate)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("outside", [False, True])
def test_tighten_ray_bundle_matches_jax(outside):
    """Rays from random origins outside an 8^3 mask with a few occupied
    cells: some rays hit, some miss (and keep their interval)."""
    rs = np.random.RandomState(3)
    B, N, P = 1, 40, 16
    origins = rs.uniform(-6, 6, (B, N, 3)).astype(np.float32)
    directions = (-origins / np.linalg.norm(origins, axis=-1, keepdims=True)
                  + 0.3 * rs.randn(B, N, 3)).astype(np.float32)
    near = rs.uniform(0.5, 2.0, (B, N, 1))
    lengths = (near + np.linspace(0, 1, P) * 10.0).astype(np.float32)
    xys = np.zeros((B, N, 2), np.float32)
    occ = rs.rand(8, 8, 8) > 0.9
    tb = tighten_ray_bundle(RayBundle(*(torch.from_numpy(x) for x in (origins, directions, lengths, xys))),
                            torch.from_numpy(occ), 4.0, n_probe=64, outside_occupied=outside)
    jb = jocc.tighten_ray_bundle(JRayBundle(*(jnp.asarray(x) for x in (origins, directions, lengths, xys))),
                                 jnp.asarray(occ), 4.0, n_probe=64, outside_occupied=outside)
    np.testing.assert_allclose(tb.lengths.numpy(), np.asarray(jb.lengths), atol=1e-5)
    changed = np.abs(tb.lengths.numpy() - lengths).max(-1) > 1e-4
    if not outside:
        assert 0 < changed.sum() < N
    np.testing.assert_array_equal(tb.origins.numpy(), origins)


def test_compute_occupancy_matches_jax(models):
    """The probe's raw densities (a 512-point lattice + the far point, each
    a ray of one point) and its mask and outside flag."""
    jm, variables, tm, _, grid = models
    pts = _probe_points()
    want = np.asarray(jm.apply(variables, jnp.asarray(grid), jnp.asarray(pts), method=JModel.query_density))
    _build.reset_launch_counts()
    got = tm.query_density(torch.from_numpy(grid), torch.from_numpy(pts)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    for thr in (0.0, float(np.median(want))):
        occ, outside = compute_occupancy(tm, torch.from_numpy(grid), R_PROBE, threshold=thr)
        jocc_mask, joutside = j_compute_occupancy(jm, variables, jnp.asarray(grid), R_PROBE, threshold=thr)
        assert occ.shape == (R_PROBE,) * 3 and occ.dtype == torch.bool and outside.shape == ()
        assert bool(outside) == bool(joutside)
        # a cell's mask is its 3^3 neighbourhood's: compare where none of
        # the neighbourhood lies within 1e-4 of the threshold
        near = torch.from_numpy(np.abs(want[:-1] - thr).reshape((R_PROBE,) * 3) <= 1e-4).float()
        clear = torch.nn.functional.max_pool3d(near[None, None], 3, 1, 1)[0, 0] == 0
        np.testing.assert_array_equal(occ.numpy()[clear.numpy()], np.asarray(jocc_mask)[clear.numpy()])
    assert not any(_build.launch_counts().values())


def test_empty_space_skip_invariance_gates(models):
    """JAX's two gates through the port's render_image_chunked: an
    all-occupied mask (outside too) and a no-hit mask reproduce the dense
    render; and the dense render is JAX's."""
    jm, variables, tm, cam, grid = models
    tcam = _port_cam(cam)[1]
    dense = render_image_chunked(tm, tcam, torch.from_numpy(grid), device="cpu")
    j_dense = j_render_chunked(jm, variables, cam[1], jnp.asarray(grid))
    assert set(dense) == set(j_dense) == {"images_render", "depths_render", "masks_render", "normals_render"}
    for k in dense:
        np.testing.assert_allclose(dense[k].numpy(), j_dense[k], atol=1e-3 if k == "depths_render" else 2e-4)
    r = 8
    for occ in ((torch.ones((r,) * 3, dtype=torch.bool), torch.tensor(True)),
                (torch.zeros((r,) * 3, dtype=torch.bool), torch.tensor(False)),
                torch.zeros((r,) * 3, dtype=torch.bool)):
        skip = render_image_chunked(tm, tcam, torch.from_numpy(grid), device="cpu", occupancy=occ)
        np.testing.assert_allclose(skip["images_render"].numpy(), dense["images_render"].numpy(), atol=1e-4)
        np.testing.assert_allclose(skip["depths_render"].numpy(), dense["depths_render"].numpy(), atol=1e-3)


def test_chunked_render_with_a_probed_mask_matches_jax(models):
    """Each side probes its own mask (threshold between two of the raw
    densities, away from every one, so that part of the lattice and the
    outside are empty and rays are tightened), then renders with it."""
    jm, variables, tm, cam, grid = models
    raw = tm.query_density(torch.from_numpy(grid), torch.from_numpy(_probe_points())).detach().numpy()
    lattice = np.sort(raw[:-1])
    lo = max(int(np.searchsorted(lattice, raw[-1])) + 1, len(lattice) // 2)
    gaps = np.diff(lattice[lo - 1:])
    i = lo - 1 + int(np.argmax(gaps[: max(1, len(gaps) // 2)]))
    thr = float(0.5 * (lattice[i] + lattice[i + 1]))
    assert raw[-1] < thr
    kw = dict(occupancy_resolution=R_PROBE, occupancy_threshold=thr, occupancy_probes=32)
    tcam = _port_cam(cam)[1]
    got = render_image_chunked(tm, tcam, torch.from_numpy(grid), device="cpu", empty_space_skip=True, **kw)
    want = j_render_chunked(jm, variables, cam[1], jnp.asarray(grid), empty_space_skip=True, **kw)
    dense = render_image_chunked(tm, tcam, torch.from_numpy(grid), device="cpu")
    # the skip changed the render (a threshold above 0 drops real density)
    assert float((got["depths_render"] - dense["depths_render"]).abs().max()) > 1e-3
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-3 if k == "depths_render" else 2e-4)
