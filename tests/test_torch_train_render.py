"""The training render of the port (holo_diffusion_torch: mask-sampled rays,
stratified lengths, the two-pass render with density noise and stratified
refinement, the MC splat, view metrics and the objective) against the JAX
package on the CPU, with the same weights and the same draws: the JAX side
draws from its keys (split as holo_model.py:498-500 and renderer.py:120-139
split them), and the port is given those values."""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from holo_diffusion_tpu.geometry import rays as jrays
from holo_diffusion_tpu.geometry.cameras import PerspectiveCameras as JCams
from holo_diffusion_tpu.geometry.cameras import look_at_view_transform as j_look_at
from holo_diffusion_tpu.models import metrics as jmetrics
from holo_diffusion_tpu.models.holo_model import HoloDiffusionModel as JModel
from holo_diffusion_tpu.ops.splat import rasterize_sparse_rays as j_rasterize
from holo_diffusion_torch.geometry import rays as trays
from holo_diffusion_torch.geometry.cameras import PerspectiveCameras
from holo_diffusion_torch.models import metrics as tmetrics
from holo_diffusion_torch.models.holo_model import HoloDiffusionModel
from holo_diffusion_torch.ops import _build
from holo_diffusion_torch.ops.splat import rasterize_sparse_rays
from holo_diffusion_torch.weights import state_dict_from_jax

B, N_RAYS, N_PTS, N_FINE = 2, 24, 8, 6
COMMON = dict(
    resol=8, volume_extent=4.0, feature_size=32, net_3d_enabled=False, n_pts_per_ray_training=N_PTS,
    n_rays_per_image=N_RAYS,
    n_pts_per_ray_fine_training=N_FINE, stratified_point_sampling_training=True, density_noise_std_train=1.0,
    scene_extent=2.0, render_normals=True, render_mlp_args=dict(dnet_hidden_dim=48, rnet_hidden_dim=16),
)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _cams(n=B):
    R, T = j_look_at(dist=4.5, elev=jnp.asarray([20.0, -10.0, 5.0][:n]), azim=jnp.asarray([30.0, 200.0, 90.0][:n]))
    return JCams(R=R, T=T, focal_length=jnp.full((n, 2), 2.0), principal_point=jnp.zeros((n, 2)))


def _port_cams(jc):
    return PerspectiveCameras(*(_t(x) for x in (jc.R, jc.T, jc.focal_length, jc.principal_point)))


def _mask():
    """Image 0 a blob, image 1 all zero (the uniform fallback)."""
    yy, xx = np.mgrid[:12, :14]
    blob = np.exp(-((yy - 5.0) ** 2 + (xx - 8.0) ** 2) / 8.0) * ((yy + xx) % 3 != 0)
    return np.stack([blob, np.zeros_like(blob)]).astype(np.float32)


def test_sample_rays_from_mask_matches_jax():
    """Inverse-CDF pixel choice and stratified lengths from JAX's uniforms:
    the same pixels exactly; lengths, origins and directions within 1e-5."""
    jc, mask = _cams(), _mask()
    key = jax.random.PRNGKey(0)
    jb = jrays.sample_rays_from_mask(jc, jnp.asarray(mask), N_RAYS, N_PTS, key, (0.0, 0.0, 0.0), 2.0, True)
    k_pix, k_len = jax.random.split(key)
    tb = trays.sample_rays_from_mask(
        _port_cams(jc), torch.from_numpy(mask), N_PTS, _t(jax.random.uniform(k_pix, (B, N_RAYS))),
        _t(jax.random.uniform(k_len, (B, N_RAYS, N_PTS))), (0.0, 0.0, 0.0), 2.0)
    np.testing.assert_array_equal(tb.xys.numpy(), np.asarray(jb.xys))
    for name in ("origins", "directions", "lengths"):
        np.testing.assert_allclose(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), atol=1e-5)
    # no ray of image 0 lands where its mask is 0
    H, W = mask.shape[1:]
    col = np.round((1.0 - tb.xys[0, :, 0].numpy()) * W / 2 - 0.5).astype(int)
    row = np.round((1.0 - tb.xys[0, :, 1].numpy()) * H / 2 - 0.5).astype(int)
    assert (mask[0][row, col] > 0).all()


def test_stratify_lengths_matches_jax():
    near, far = jnp.asarray([1.0, 2.5]), jnp.asarray([6.0, 4.0])
    key = jax.random.PRNGKey(1)
    j = jrays.stratify_lengths(near, far, 5, 7, key)
    t = trays.stratify_lengths(_t(near), _t(far), 5, 7, _t(jax.random.uniform(key, (2, 5, 7))))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    assert (np.diff(t.numpy(), axis=-1) >= 0).all()


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX model with the fused decode, its variables, the port model with
    the same weights, a tanh-bounded grid)."""
    grid = np.tanh(np.random.RandomState(2).randn(8, 8, 8, 32)).astype(np.float32)
    jm = JModel(**COMMON, view_pooler_enabled=False, fuse_decode="on")
    bundle = jrays.sample_rays_full_grid(_cams(1), 2, 2, 4, scene_extent=2.0)
    variables = jax.jit(lambda key, g, b: jm.init(key, g, b, method=JModel.render_rays))(
        jax.random.PRNGKey(3), jnp.asarray(grid), bundle)
    flat = {k: np.asarray(v) for k, v in flatten_dict(variables["params"], sep="/").items()}
    tm = HoloDiffusionModel(**COMMON, view_pooler_enabled=False)
    tm.load_state_dict(state_dict_from_jax(flat), strict=True)
    return jm, variables, tm, grid


def _render_draws(key):
    """The draws of the JAX training render from `key`: per pass, the
    refinement uniforms (pass >= 1), then the density noise."""
    key, noise0 = jax.random.split(key)
    key, refine1 = jax.random.split(key)
    key, noise1 = jax.random.split(key)
    return {
        "density_noise_0": np.asarray(jax.random.normal(noise0, (B, N_RAYS, N_PTS))),
        "refine_u_1": np.asarray(jax.random.uniform(refine1, (B, N_RAYS, N_FINE))),
        "density_noise_1": np.asarray(jax.random.normal(noise1, (B, N_RAYS, N_PTS + N_FINE))),
    }


def test_training_render_and_its_grid_gradient_match_jax():
    """The two-pass training render (noise std 1.0, stratified refinement)
    of a mask-sampled bundle: every pass's features, depths and masks within
    2e-5 (1e-4 on depths, ~5 world units). Then the gradient of a loss of
    the final pass with respect to the grid, through the port's
    `FusedSampleDecode` (plain backward on the CPU) and through JAX's custom
    VJP (its Pallas backward kernel interpreted): 1e-4 of its scale."""
    jm, variables, tm, grid = _pair()
    jc = _cams()
    bundle = jrays.sample_rays_from_mask(jc, jnp.asarray(_mask()), N_RAYS, N_PTS, jax.random.PRNGKey(4),
                                         (0.0, 0.0, 0.0), 2.0, True)
    key = jax.random.PRNGKey(5)
    w_rgb = np.random.RandomState(6).randn(B, N_RAYS, 3).astype(np.float32)

    def j_loss(g):
        out = jm.apply(variables, g, bundle, True, key, method=JModel.render_rays)
        return jnp.sum(out.features * w_rgb) + jnp.sum(out.masks), out

    (_, j_out), j_grad = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(jnp.asarray(grid))
    t_bundle = trays.RayBundle(*(_t(getattr(bundle, f)) for f in ("origins", "directions", "lengths", "xys")))
    t_grid = torch.from_numpy(grid).requires_grad_(True)
    _build.reset_launch_counts()
    t_out = tm.render_rays(t_grid, t_bundle, training=True, draws=_render_draws(key))
    (torch.sum(t_out.features * torch.from_numpy(w_rgb)) + torch.sum(t_out.masks)).backward()
    j_stage, t_stage = j_out, t_out
    while j_stage is not None:
        np.testing.assert_allclose(t_stage.features.detach().numpy(), np.asarray(j_stage.features), atol=2e-5)
        np.testing.assert_allclose(t_stage.masks.detach().numpy(), np.asarray(j_stage.masks), atol=2e-5)
        np.testing.assert_allclose(t_stage.depths.detach().numpy(), np.asarray(j_stage.depths), atol=1e-4)
        j_stage, t_stage = j_stage.prev_stage, t_stage.prev_stage
    assert t_stage is None
    scale = float(np.abs(np.asarray(j_grad)).max())
    assert scale > 0
    np.testing.assert_allclose(t_grid.grad.numpy(), np.asarray(j_grad), atol=1e-4 * scale)
    assert not any(_build.launch_counts().values())


def test_rasterize_sparse_rays_matches_jax():
    """Rays splatted to their nearest pixel, colliding rays averaged by their
    mask weight: 1e-6."""
    rs = np.random.RandomState(7)
    xys = rs.uniform(-1.1, 1.1, (2, 50, 2)).astype(np.float32)
    xys[:, 25:] = xys[:, :25]  # collisions
    feats, depths, masks = (rs.rand(2, 50, c).astype(np.float32) for c in (3, 1, 1))
    j = j_rasterize(*(jnp.asarray(x) for x in (xys, feats)), (6, 5), jnp.asarray(depths), jnp.asarray(masks))
    t = rasterize_sparse_rays(*(torch.from_numpy(x) for x in (xys, feats)), (6, 5), torch.from_numpy(depths),
                              torch.from_numpy(masks))
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_view_metrics_and_objective_match_jax():
    """Every metric of two passes (rgb, mask and depth terms with fg and
    depth targets) and the weighted objective: 1e-5 relative."""
    rs = np.random.RandomState(8)
    img, fg, depth = rs.rand(B, 10, 12, 3), (rs.rand(B, 10, 12, 1) > 0.4), rs.rand(B, 10, 12, 1) * 3
    j_in = jmetrics.preprocess_input(jnp.asarray(img, jnp.float32), jnp.asarray(fg, jnp.float32),
                                     jnp.asarray(depth, jnp.float32), True, True, 0.5, (1.0, 0.5, 0.0))
    t_in = tmetrics.preprocess_input(_t(img), _t(fg), _t(depth), True, True, 0.5, (1.0, 0.5, 0.0))
    for a, b in zip(t_in, j_in):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    xys = rs.uniform(-1.0, 1.0, (B, 30, 2)).astype(np.float32)

    class Stage:
        def __init__(self, prev, f, d, m):
            self.prev_stage, self.features, self.depths, self.masks = prev, f, d, m

    def stages(conv):
        out = None
        for s in range(2):
            r = np.random.RandomState(10 + s)
            out = Stage(out, *(conv(r.rand(B, 30, c).astype(np.float32)) for c in (3, 1, 1)))
        return out

    j = jmetrics.multipass_view_metrics(stages(jnp.asarray), jnp.asarray(xys), *(j_in[0], j_in[2], j_in[1]))
    t = tmetrics.multipass_view_metrics(stages(torch.from_numpy), torch.from_numpy(xys), *(t_in[0], t_in[2], t_in[1]))
    assert sorted(t) == sorted(j) and len(t) == 20
    for k in j:
        np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    weights = {"loss_rgb_mse": 1.0, "loss_prev_stage_rgb_mse": 0.5, "loss_mask_bce": 0.0, "loss_absent": 3.0}
    np.testing.assert_allclose(float(tmetrics.get_objective(t, weights)), float(jmetrics.get_objective(j, weights)),
                               rtol=1e-6)
