"""The port's render stack against the JAX package on the CPU: rays, the
importance refinement, the two-pass render through the fused-decode
implicit function (JAX runs its Pallas kernel in interpret mode), and the
chunked full-image render. Weights come from the JAX model through
`state_dict_from_jax`; the RenderMLP is also held against the reference
torch golden."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from holo_diffusion_tpu.geometry import rays as jrays
from holo_diffusion_tpu.geometry.cameras import PerspectiveCameras as JCams
from holo_diffusion_tpu.geometry.cameras import look_at_view_transform as j_look_at
from holo_diffusion_tpu.models.holo_model import HoloDiffusionModel as JModel
from holo_diffusion_tpu.render_eval import render_image_chunked as j_render_chunked
from holo_diffusion_torch.geometry import rays as trays
from holo_diffusion_torch.geometry.cameras import PerspectiveCameras, look_at_view_transform
from holo_diffusion_torch.models.holo_model import HoloDiffusionModel
from holo_diffusion_torch.models.mlp import MLPWithInputSkips
from holo_diffusion_torch.models.render_mlp import RenderMLP
from holo_diffusion_torch.render_eval import render_image_chunked
from holo_diffusion_torch.weights import state_dict_from_jax

GOLD = np.load(os.path.join(os.path.dirname(__file__), "goldens", "mlp_goldens.npz"))

COMMON = dict(
    resol=8,
    volume_extent=4.0,
    feature_size=32,
    num_passes=2,
    net_3d_enabled=False,
    diffusion_enabled=False,
    n_pts_per_ray_evaluation=8,
    n_pts_per_ray_fine_evaluation=8,
    render_image_height=10,
    render_image_width=10,
    scene_extent=2.0,
    render_mlp_args=dict(dnet_hidden_dim=48, rnet_hidden_dim=16),
)


def _cameras(n=2):
    R, T = j_look_at(dist=4.5, elev=jnp.asarray([20.0, -10.0][:n]), azim=jnp.asarray([30.0, 200.0][:n]))
    return JCams(R=R, T=T, focal_length=jnp.full((n, 2), 2.0), principal_point=jnp.zeros((n, 2)))


def _port_cams(jc):
    return PerspectiveCameras(*(torch.from_numpy(np.array(x)) for x in (jc.R, jc.T, jc.focal_length, jc.principal_point)))


def _bundle(jb):
    return trays.RayBundle(*(torch.from_numpy(np.array(x)) for x in (jb.origins, jb.directions, jb.lengths, jb.xys)))


@functools.lru_cache(maxsize=None)
def _pair(render_normals, chunk_size_grid=0):
    """(JAX model, variables, port model with the same weights, grid); one
    JAX init per setting for the whole module."""
    extra = dict(chunk_size_grid=chunk_size_grid)
    grid = np.tanh(np.random.RandomState(0).randn(8, 8, 8, 32)).astype(np.float32)
    jm = JModel(**COMMON, **extra, view_pooler_enabled=False, fuse_decode="on",
                render_normals=render_normals)
    # initialising through render_rays creates every implicit-function param
    bundle = jrays.sample_rays_full_grid(_cameras(1), 2, 2, 4, scene_extent=2.0)
    variables = jax.jit(lambda key, g, b: jm.init(key, g, b, method=JModel.render_rays))(
        jax.random.PRNGKey(1), jnp.asarray(grid), bundle)
    flat = {k: np.asarray(v) for k, v in flatten_dict(variables["params"], sep="/").items()}
    tm = HoloDiffusionModel(**COMMON, **extra, view_pooler_enabled=False, render_normals=render_normals)
    tm.load_state_dict(state_dict_from_jax(flat), strict=True)
    return jm, variables, tm, grid


def test_full_grid_rays_match_jax():
    jc = _cameras(2)
    jb = jrays.sample_rays_full_grid(jc, 6, 7, 5, scene_extent=2.0)
    tb = trays.sample_rays_full_grid(_port_cams(jc), 6, 7, 5, scene_extent=2.0)
    for name in ("origins", "directions", "lengths", "xys"):
        np.testing.assert_allclose(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), rtol=1e-5, atol=1e-5)


def test_look_at_view_transform_matches_jax():
    R, T = j_look_at(dist=[3.0, 7.0], elev=[10.0, 80.0], azim=[0.0, 135.0])
    Rt, Tt = look_at_view_transform(dist=[3.0, 7.0], elev=[10.0, 80.0], azim=[0.0, 135.0])
    np.testing.assert_allclose(Rt.numpy(), np.asarray(R), atol=1e-6)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(T), atol=1e-5)


@pytest.mark.parametrize("drawn", [False, True], ids=["midpoints", "drawn_u"])
def test_sample_pdf_and_importance_lengths_match_jax(drawn):
    """searchsorted + gathers against the JAX one-hot matmul formulation;
    with `drawn` both get the same uniforms (JAX draws them from its key)."""
    rs = np.random.RandomState(4)
    lengths = np.sort(rs.uniform(1.0, 6.0, (2, 5, 12)), axis=-1).astype(np.float32)
    weights = (rs.rand(2, 5, 12) ** 3).astype(np.float32)
    key = jax.random.PRNGKey(3) if drawn else None
    u = torch.from_numpy(np.array(jax.random.uniform(key, (2, 5, 16)))) if drawn else None
    j = jrays.importance_sample_lengths(jnp.asarray(lengths), jnp.asarray(weights), 16, key)
    t = trays.importance_sample_lengths(torch.from_numpy(lengths), torch.from_numpy(weights), 16, u)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-5)
    mids = 0.5 * (lengths[..., 1:] + lengths[..., :-1])
    jp = jrays.sample_pdf(jnp.asarray(mids), jnp.asarray(weights[..., 1:-1]), 16, key)
    tp = trays.sample_pdf(torch.from_numpy(mids), torch.from_numpy(weights[..., 1:-1]), 16, u)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("render_normals", [False, True], ids=["K1", "K3"])
def test_multipass_render_matches_jax(render_normals):
    """Two passes (coarse 8 + fine 8+8 points) through the fused decode; the
    second pass resamples from the first, so float32 differences compound:
    2e-5 absolute on features/masks, 1e-4 on depths (~5 world units)."""
    jm, variables, tm, grid = _pair(render_normals)
    jb = jrays.sample_rays_full_grid(_cameras(1), 10, 10, 8, scene_extent=2.0)
    j = jax.jit(lambda v, g, b: jm.apply(v, g, b, False, None, method=JModel.render_rays))(
        variables, jnp.asarray(grid), jb)
    with torch.no_grad():
        t = tm.render_rays(torch.from_numpy(grid), _bundle(jb))
    j_stage, t_stage = j, t
    while j_stage is not None:
        np.testing.assert_allclose(t_stage.features.numpy(), np.asarray(j_stage.features), atol=2e-5)
        np.testing.assert_allclose(t_stage.masks.numpy(), np.asarray(j_stage.masks), atol=2e-5)
        np.testing.assert_allclose(t_stage.depths.numpy(), np.asarray(j_stage.depths), atol=1e-4)
        assert (t_stage.normals is None) == (not render_normals)
        if render_normals:
            # normalising a near-zero field gradient amplifies float32 noise
            np.testing.assert_allclose(t_stage.normals.numpy(), np.asarray(j_stage.normals), atol=1e-4)
        j_stage, t_stage = j_stage.prev_stage, t_stage.prev_stage
    assert t_stage is None
    assert float(t.masks.max()) > 0.05  # the rays do hit the volume


@pytest.mark.parametrize("render_normals", [False, True], ids=["K1", "K3"])
def test_query_density_matches_jax(render_normals):
    """Raw densities at free world points (the leaky-relu'd density lane)."""
    jm, variables, tm, grid = _pair(render_normals)
    pts = np.random.RandomState(8).uniform(-2.3, 2.3, (5, 7, 3)).astype(np.float32)
    j = jm.apply(variables, jnp.asarray(grid), jnp.asarray(pts), method=JModel.query_density)
    with torch.no_grad():
        t = tm.query_density(torch.from_numpy(grid), torch.from_numpy(pts))
    assert tuple(t.shape) == (5, 7)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


def test_render_image_chunked_matches_jax_with_ragged_chunk():
    """9 x 11 = 99 rays in chunks of 40 // 8 = 5 rays: the last chunk holds 4."""
    jm, variables, tm, grid = _pair(True, chunk_size_grid=40)
    jc = _cameras(2)
    j = j_render_chunked(jm, variables, jc[1], jnp.asarray(grid), image_height=9, image_width=11)
    t = render_image_chunked(tm, _port_cams(jc)[1], torch.from_numpy(grid), image_height=9,
                             image_width=11, device="cpu")
    assert set(t) == set(j) == {"images_render", "depths_render", "masks_render", "normals_render"}
    for k in j:
        assert tuple(t[k].shape) == j[k].shape
        np.testing.assert_allclose(t[k].numpy(), j[k], atol=1e-4 if k == "depths_render" else 2e-5)


def test_mlp_with_input_skips_matches_reference_golden():
    mlp = MLPWithInputSkips(n_layers=4, input_dim=16, output_dim=8, skip_dim=16, hidden_dim=32,
                            input_skips=(2,), hidden_activation="LEAKYRELU", last_activation="IDENTITY")
    mlp.load_state_dict({k[len("mlp_sd::"):]: torch.from_numpy(GOLD[k]) for k in GOLD.files
                         if k.startswith("mlp_sd::")})
    with torch.no_grad():
        y = mlp(torch.from_numpy(GOLD["mlp_x"]))
    np.testing.assert_allclose(y.numpy(), GOLD["mlp_y"], atol=1e-5)


def test_render_mlp_golden_loads_and_collapses():
    """The reference RenderMLP state_dict loads as it is (its `_frequencies`
    are constants the port keeps as non-persistent buffers); the layer-by-
    layer decode matches the golden, and the collapsed affine + radiance
    linear reproduce it — the algebra the fused kernel relies on."""
    rmlp = RenderMLP(input_dims=32, dnet_hidden_dim=64, rnet_hidden_dim=48)
    sd = {k[len("rmlp_sd::"):]: torch.from_numpy(GOLD[k]) for k in GOLD.files if k.startswith("rmlp_sd::")}
    for k in [k for k in sd if k.endswith("_frequencies")]:
        np.testing.assert_allclose(sd.pop(k).numpy(), dict(rmlp.named_buffers())[k].numpy())
    rmlp.load_state_dict(sd, strict=True)
    feats, dirs = torch.from_numpy(GOLD["rmlp_feats"]), torch.from_numpy(GOLD["rmlp_dirs"])
    with torch.no_grad():
        dens, rad = rmlp(feats, dirs)
        A, c = rmlp.density_affine()
        Wr, br = rmlp.radiance_linear()
        h = torch.nn.functional.leaky_relu(feats @ A + c, 0.2)
        rgb = torch.sigmoid(torch.nn.functional.leaky_relu(
            torch.cat([h[..., :64], rmlp.encode_dirs(dirs)], -1) @ Wr + br, 0.2))
    assert rmlp.decode_is_fusable
    np.testing.assert_allclose(dens.numpy(), GOLD["rmlp_densities"], atol=1e-5)
    np.testing.assert_allclose(rad.numpy(), GOLD["rmlp_radiance"], atol=1e-5)
    # the reference applies LeakyReLU to the density lane too (swapped order)
    np.testing.assert_allclose(h[..., 64:].numpy(), GOLD["rmlp_densities"], atol=1e-5)
    np.testing.assert_allclose(rgb.numpy(), GOLD["rmlp_radiance"], atol=1e-5)
