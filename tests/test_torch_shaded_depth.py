"""Shaded depth of the port (holo_diffusion_torch/utils/shaded_depth.py,
ops/knn.py, utils/mesh_render.py) against the JAX package's on the same
numpy inputs, on the CPU.

Tolerances: the gradient shading, the shading from normals, the depth image
and the outlier mask are the same float32 arithmetic in another order: 1e-5.
KNN is compared by the selected neighbours' sorted distances (points at equal
distances may be taken in another order), 1e-5. Point-cloud normals by |n_z|
(an eigenvector's sign is the solver's): 1e-4 on a jittered depth map, where
every neighbourhood's smallest eigenvalue is well apart from the next. The
mesh path: the grid mesh bitwise, vertex normals and Gouraud colours 1e-5;
the soft rasterizer 1e-4 on colours and alpha and 1e-3 on depth: its blend
weights exp((z_inv - z_inv_max) / gamma) with gamma 1e-4 scale the float32
rounding of each face's interpolated depth by 1e4."""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holo_diffusion_torch.geometry.cameras import PerspectiveCameras
from holo_diffusion_torch.ops import knn
from holo_diffusion_torch.utils import mesh_render as mr
from holo_diffusion_torch.utils import shaded_depth as sd
from holo_diffusion_tpu.ops import knn as jknn
from holo_diffusion_tpu.utils import mesh_render as jmr
from holo_diffusion_tpu.utils import shaded_depth as jsd
from holo_diffusion_tpu.utils.flyaround import simple_360_cameras as j_simple_360

H = W = 16

# the JAX functions compiled whole, one compile each
j_outlier = jax.jit(jsd.depth_laplacian_outlier_mask)
j_depth_image = jax.jit(jsd.make_depth_image)
j_shaded = jax.jit(jsd.depth_to_shaded, static_argnames=("method", "knn_k"))
j_from_normals = jax.jit(jsd.shaded_from_normals)
j_knn = jax.jit(jknn.knn_points, static_argnames=("k", "block_q"))
j_normals = jax.jit(jknn.estimate_pointcloud_normals, static_argnums=(1,))
j_pcl_shaded = jax.jit(jknn.pointcloud_shaded_grid, static_argnums=(2,))
j_raster = jax.jit(jmr.soft_rasterize, static_argnums=(3,), static_argnames=("topk", "block_pixels"))
j_mesh = jax.jit(jmr.mesh_render_shaded, static_argnames=("topk",))


def _cams():
    jc = j_simple_360(3, dist=4.0, up=(0.0, 1.0, 0.0))[1]
    tc = PerspectiveCameras(*(torch.from_numpy(np.array(getattr(jc, f)))
                              for f in ("R", "T", "focal_length", "principal_point")))
    return jc, tc


def _depth_and_mask(jitter=0.0, seed=0):
    """A bumpy surface about 4 units away with a step (an outlier edge), and
    a disc mask."""
    rs = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W), indexing="ij")
    depth = 4.0 + 0.3 * np.sin(3 * xx) * np.cos(2 * yy) + 0.8 * (xx > 0.6)
    depth = depth + jitter * rs.randn(H, W)
    mask = ((xx ** 2 + yy ** 2) < 0.8).astype(np.float32)
    return depth.astype(np.float32), mask


def _t(x):
    return torch.from_numpy(np.array(x))


def test_outlier_mask_and_depth_image_match_jax():
    depth, mask = _depth_and_mask()
    np.testing.assert_array_equal(sd.depth_laplacian_outlier_mask(_t(depth)).numpy(),
                                  np.asarray(j_outlier(jnp.asarray(depth))))
    for m in (mask, np.zeros_like(mask)):
        np.testing.assert_allclose(sd.make_depth_image(_t(depth), _t(m), 0.5).numpy(),
                                   np.asarray(j_depth_image(jnp.asarray(depth), jnp.asarray(m), 0.5)),
                                   atol=1e-5)


def test_gradient_shading_and_shading_from_normals_match_jax():
    jc, tc = _cams()
    depth, mask = _depth_and_mask()
    got = sd.depth_to_shaded(_t(depth), _t(mask), tc, method="gradient")
    want = j_shaded(jnp.asarray(depth), jnp.asarray(mask), jc, method="gradient")
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    normals = np.random.RandomState(1).randn(H, W, 3).astype(np.float32)
    got = sd.shaded_from_normals(_t(normals), _t(mask), tc, _t(depth))
    want = j_from_normals(jnp.asarray(normals), jnp.asarray(mask), jc, jnp.asarray(depth))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the background and the masked-out pixels take bg_value
    assert float(got[0, 0, 0]) == 1.0


@pytest.mark.parametrize("case", ["random", "regular_grid"])
def test_knn_points_selects_the_same_distances_as_jax(case):
    rs = np.random.RandomState(2)
    if case == "random":
        pts = rs.randn(300, 3).astype(np.float32)
        q = rs.randn(70, 3).astype(np.float32)
    else:
        # a regular grid: neighbours at exactly equal distances (ties)
        g = np.stack(np.meshgrid(*[np.arange(6.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
        pts = q = (0.5 * g).astype(np.float32)
    k = 7
    got = knn.knn_points(_t(q), _t(pts), k, block_q=32).numpy()
    want = np.asarray(j_knn(jnp.asarray(q), jnp.asarray(pts), k=k, block_q=32))
    assert got.shape == want.shape == (len(q), k)

    def dists(idx):
        return np.sort(((q[:, None].astype(np.float64) - pts[idx]) ** 2).sum(-1), axis=1)

    np.testing.assert_allclose(dists(got), dists(want), atol=1e-5)


def test_pointcloud_normals_and_shading_match_jax_by_abs_nz():
    jc, tc = _cams()
    depth, mask = _depth_and_mask(jitter=0.01, seed=3)
    pcl = sd._unproject_view_space(_t(depth), tc)
    jpcl = jsd._unproject_view_space(jnp.asarray(depth), jc)
    np.testing.assert_allclose(pcl.numpy(), np.asarray(jpcl), atol=1e-5)
    n = knn.estimate_pointcloud_normals(pcl.reshape(-1, 3), 12)
    jn = j_normals(jpcl.reshape(-1, 3), 12)
    np.testing.assert_allclose(n.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(n[:, 2].abs().numpy(), np.abs(np.asarray(jn[:, 2])), atol=1e-4)
    got = knn.pointcloud_shaded_grid(pcl, _t(mask), 12)
    want = j_pcl_shaded(jpcl, jnp.asarray(mask), 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _bumpy_grid(n=12):
    yy, xx = np.meshgrid(np.linspace(-0.5, 0.5, n), np.linspace(-0.5, 0.5, n), indexing="ij")
    z = 3.0 + 0.2 * np.sin(4 * xx) * np.cos(4 * yy)
    pcl = np.stack([xx * z, yy * z, z], -1).astype(np.float32)
    mask = ((xx ** 2 + yy ** 2) < 0.2).astype(np.float32)
    return pcl, mask


def test_grid_mesh_normals_and_colors_match_jax():
    pcl, mask = _bumpy_grid()
    verts, faces, ok = mr.grid_mesh_from_points(_t(pcl), _t(mask))
    jverts, jfaces, jok = jmr.grid_mesh_from_points(jnp.asarray(pcl), jnp.asarray(mask))
    np.testing.assert_array_equal(verts.numpy(), np.asarray(jverts))
    np.testing.assert_array_equal(faces.numpy(), np.asarray(jfaces))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    n = mr.vertex_normals(verts, faces, ok)
    jn = jmr.vertex_normals(jverts, jfaces, jok)
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), atol=1e-5)
    for name, mat in mr.MATERIALS.items():
        assert mat == jmr.MATERIALS[name]
        col = mr.gouraud_vertex_colors(verts, n, torch.ones_like(verts), **mat)
        jcol = jmr.gouraud_vertex_colors(jverts, jn, jnp.ones_like(jverts), **mat)
        np.testing.assert_allclose(col.numpy(), np.asarray(jcol), atol=1e-5)
    p = np.random.RandomState(4).randn(5, 7, 2).astype(np.float32)
    a, b = np.float32([0.1, -0.3]), np.float32([0.7, 0.2])
    np.testing.assert_allclose(mr._edge_dist_sq(_t(p), _t(a), _t(b)).numpy(),
                               np.asarray(jmr._edge_dist_sq(jnp.asarray(p), jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-6)


# the JAX package's own test geometries (tests/test_mesh_render.py)
_FAR = [[-10.0, -10.0, 4.0], [10.0, -10.0, 4.0], [0.0, 20.0, 4.0]]
_NEAR = [[-10.0, -10.0, 2.0], [10.0, -10.0, 2.0], [0.0, 20.0, 2.0]]
RASTER_CASES = {
    "covering": (_NEAR, [[0, 1, 2]], np.full((3, 3), 0.7), (16, 16), 1),
    "occlusion": (_FAR + _NEAR, [[0, 1, 2], [3, 4, 5]], np.r_[np.zeros((3, 3)), np.ones((3, 3))], (8, 8), 2),
    # more faces than K hit a pixel, and pixels no face covers (top-K then
    # picks non-hits, which the blend must zero)
    "small_triangles": ([[-0.5, -0.5, 2.0], [0.5, -0.4, 2.1], [0.0, 0.6, 2.2],
                         [-0.6, 0.0, 3.0], [0.4, 0.5, 2.5], [0.2, -0.7, 2.8]],
                        [[0, 1, 2], [3, 4, 5], [0, 4, 5], [1, 3, 2]],
                        np.random.RandomState(5).rand(6, 3), (12, 10), 3),
}


@pytest.mark.parametrize("case", list(RASTER_CASES))
def test_soft_rasterize_matches_jax(case):
    verts, faces, colors, size, topk = RASTER_CASES[case]
    verts, faces, colors = (np.asarray(x, dt) for x, dt in ((verts, np.float32), (faces, np.int64),
                                                             (colors, np.float32)))
    got = mr.soft_rasterize(_t(verts), _t(faces), _t(colors), size, topk=topk, block_pixels=64)
    want = j_raster(jnp.asarray(verts), jnp.asarray(faces, jnp.int32), jnp.asarray(colors), size,
                    topk=topk, block_pixels=64)
    for g, w, tol in zip(got, want, (1e-4, 1e-4, 1e-3)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol)
    if case == "covering":
        np.testing.assert_allclose(got[1].numpy(), 1.0, atol=1e-4)
        np.testing.assert_allclose(got[0].numpy(), 0.7, atol=1e-3)


def test_mesh_render_shaded_matches_jax():
    pcl, mask = _bumpy_grid(24)
    got = mr.mesh_render_shaded(_t(pcl), _t(mask), topk=4, block_pixels=100)
    want = j_mesh(jnp.asarray(pcl), jnp.asarray(mask), topk=4)
    assert float(got[1].sum()) > 20
    for g, w, tol in zip(got, want, (1e-4, 0.0, 1e-3)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol)


@pytest.mark.parametrize("method", ["gradient", "pointcloud", "mesh"])
def test_depth_to_shaded_dispatch_matches_jax(method):
    """The three methods of `depth_to_shaded` on one jittered depth map and
    camera (the pointcloud method compared as shaded |n_z|, 1e-4; the mesh
    method at the rasterizer's 1e-4)."""
    jc, tc = _cams()
    depth, mask = _depth_and_mask(jitter=0.01, seed=6)
    got = sd.depth_to_shaded(_t(depth), _t(mask), tc, method=method, knn_k=12)
    want = j_shaded(jnp.asarray(depth), jnp.asarray(mask), jc, method=method, knn_k=12)
    assert got.shape == (H, W, 3) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5 if method == "gradient" else 1e-4)
    with pytest.raises(ValueError, match="unknown shaded depth method"):
        sd.depth_to_shaded(_t(depth), _t(mask), tc, method="phong")
