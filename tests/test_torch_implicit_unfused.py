"""The port's unfused implicit function (holo_diffusion_torch/models/implicit.py
with fuse_decode="off": a sampler, then the RenderMLP layer by layer, or the
collapsed density affine) against the JAX package on the CPU, with the same
parameters (`state_dict_from_jax`) and the same inputs. JAX runs its Pallas
sampling kernels in interpret mode; the port its kernels' plain versions.
Then a narrow model with sampler="fused", fuse_decode="off": a chunked
render, and the training render's objective and gradients with the same
draws. Tolerances are the JAX package's own for these paths
(tests/test_pallas_kernels.py): loss 1e-5 relative; gradients 5e-4
absolute + 2e-3 relative; normals 5e-5 + 1e-4."""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from holo_diffusion_tpu.config.config import _CONFIG_DIR as J_CONFIG_DIR
from holo_diffusion_tpu.config.config import load_config as j_load_config
from holo_diffusion_tpu.config.config import model_args_from_config as j_model_args
from holo_diffusion_tpu.geometry import rays as jrays
from holo_diffusion_tpu.geometry.cameras import PerspectiveCameras as JCams
from holo_diffusion_tpu.geometry.cameras import look_at_view_transform as j_look_at
from holo_diffusion_tpu.models import metrics as jmetrics
from holo_diffusion_tpu.models.holo_model import HoloDiffusionModel as JModel
from holo_diffusion_tpu.models.implicit import VoxelGridImplicitFunction as JImplicit
from holo_diffusion_tpu.models.render_mlp import RenderMLP as JRenderMLP
from holo_diffusion_tpu.ops.pallas import fused_render as jfr
from holo_diffusion_tpu.render_eval import render_image_chunked as j_render_chunked
from holo_diffusion_torch.config import load_config, model_args_from_config
from holo_diffusion_torch.config.config import CONFIG_DIR
from holo_diffusion_torch.geometry.cameras import PerspectiveCameras
from holo_diffusion_torch.models import metrics as tmetrics
from holo_diffusion_torch.models.holo_model import HoloDiffusionModel
from holo_diffusion_torch.models.implicit import VoxelGridImplicitFunction
from holo_diffusion_torch.models.render_mlp import RenderMLP
from holo_diffusion_torch.ops import _build
from holo_diffusion_torch.ops import fused_decode as fd
from holo_diffusion_torch.ops import kron_sample as ks
from holo_diffusion_torch.render_eval import render_image_chunked
from holo_diffusion_torch.weights import state_dict_from_jax

D, C, EXTENT = 8, 32, 4.0
MLP = dict(dnet_hidden_dim=48, rnet_hidden_dim=16, dnet_num_layers=4, dnet_input_skips=(2,))
LOSS_TOL, GRAD_TOL, NORMALS_TOL = dict(rtol=1e-5), dict(atol=5e-4, rtol=2e-3), dict(atol=5e-5, rtol=1e-4)


def _no_launches():
    return not any(_build.launch_counts().values())


def _inputs(seed=29):
    rs = np.random.RandomState(seed)
    grid = np.tanh(rs.randn(D, D, D, C)).astype(np.float32)
    # voxel centres span +-1.75: points inside and beyond, none on a plane
    pts = rs.uniform(-1.93, 1.97, (2, 20, 9, 3)).astype(np.float32)
    dirs = rs.randn(2, 20, 3).astype(np.float32)
    return grid, pts, dirs


def _unflatten(flat):
    """'/'-flattened numpy params -> the nested dict of JAX arrays flax takes."""
    out = {}
    for k, v in flat.items():
        node = out
        for part in k.split("/")[:-1]:
            node = node.setdefault(part, {})
        node[k.split("/")[-1]] = jnp.asarray(v)
    return out


def _port_params(flat_jax, prefix="implicit_function."):
    sd = state_dict_from_jax({f"implicit_function/{k}": v for k, v in flat_jax.items()})
    return {k[len(prefix):]: v for k, v in sd.items()}


@functools.lru_cache(maxsize=None)
def _pair(render_normals, mlp_items, **modes):
    """(JAX implicit function, its variables with random biases, the port's
    with the same parameters). Non-zero biases keep every pre-activation off
    0, where torch's leaky-ReLU derivative (0.2) and JAX's (1) differ."""
    modes = dict(modes)
    grid, pts, dirs = _inputs()
    kw = dict(resol=D, volume_extent=EXTENT, n_hidden=C, render_normals=render_normals,
              render_mlp_args=dict(mlp_items))
    jfn = JImplicit(**kw, feature_dim=0, **modes)
    variables = jfn.init(jax.random.PRNGKey(0), jnp.asarray(grid), jnp.asarray(pts), jnp.asarray(dirs))
    rs = np.random.RandomState(1)
    flat = {k: (rs.randn(*v.shape).astype(np.float32) * 0.1 if k.endswith("bias") else np.asarray(v))
            for k, v in flatten_dict(variables["params"], sep="/").items()}
    tfn = VoxelGridImplicitFunction(**kw, **modes)
    tfn.load_state_dict(_port_params(flat), strict=True)
    return jfn, {"params": _unflatten(flat)}, tfn


def _jax_loss_fn(jfn):
    def loss(v, g, pts, dirs):
        dens, feats, aux = jfn.apply(v, g, pts, dirs)
        return jnp.sum(dens ** 2) + 2.0 * jnp.sum(feats ** 2), aux

    return loss


def _check_against_jax(render_normals, mlp_args, grads=True, normals_by_jax_grad=True, **modes):
    jfn, variables, tfn = _pair(render_normals, tuple(sorted(mlp_args.items())), **modes)
    grid, pts, dirs = _inputs()
    jargs = (variables, jnp.asarray(grid), jnp.asarray(pts), jnp.asarray(dirs))
    loss = _jax_loss_fn(jfn)
    j_grads = None
    if grads and normals_by_jax_grad:
        (j_loss, j_aux), j_grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(*jargs)
    else:
        j_loss, j_aux = jax.jit(loss)(*jargs)
    if grads and not normals_by_jax_grad:
        # JAX cannot take the outer gradient through its autodiff normals
        # (the sampler's custom VJP is first order): its gradients come from
        # the same function without normals, which add no parameter
        jfn_plain, _, _ = _pair(False, tuple(sorted(mlp_args.items())), **modes)
        j_grads = jax.jit(jax.grad(lambda *a: _jax_loss_fn(jfn_plain)(*a)[0], argnums=(0, 1)))(*jargs)
    tg = torch.from_numpy(grid).requires_grad_(grads)
    for p in tfn.parameters():
        p.grad = None
    dens, feats, aux = tfn(tg, torch.from_numpy(pts), torch.from_numpy(dirs))
    t_loss = (dens ** 2).sum() + 2.0 * (feats ** 2).sum()
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), **LOSS_TOL)
    assert ("normals" in aux) == render_normals
    if render_normals:
        assert tuple(aux["normals"].shape) == pts.shape and not aux["normals"].requires_grad
        np.testing.assert_allclose(aux["normals"].numpy(), np.asarray(j_aux["normals"]), **NORMALS_TOL)
    if not grads:
        return tfn
    t_loss.backward()
    want = _port_params(flatten_dict(j_grads[0]["params"], sep="/"))
    got = dict(tfn.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), **GRAD_TOL, err_msg=name)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(j_grads[1]), **GRAD_TOL)
    return tfn


@pytest.mark.parametrize("render_normals", [False, True], ids=["no_normals", "normals"])
@pytest.mark.parametrize("sampler", ["fused", "packed", "gather"])
def test_unfused_decode_matches_jax(sampler, render_normals):
    """Layer-by-layer decode through each sampler; normals (collapsible
    density net) are the analytic field gradient, one K6 call."""
    _check_against_jax(render_normals, MLP, sampler=sampler, fuse_decode="off", collapse_density="off")
    assert _no_launches()


def test_collapsed_density_matches_jax():
    """collapse_density="on": the grid projected to hidden + 1 = 49 channels,
    sampled by K4's plain version, gradients through K5's."""
    _check_against_jax(True, MLP, sampler="fused", fuse_decode="off", collapse_density="on")


def test_pallas_sampler_matches_jax_forward_and_refuses_gradients(monkeypatch):
    """K7's plain version in the decode against JAX's Pallas kernel, which
    runs on the CPU only in interpret mode (its implicit function asks for
    the compiled kernel, so the test passes interpret=True); asking the
    port for a gradient raises."""
    monkeypatch.setattr(jfr, "trilinear_sample_pallas",
                        functools.partial(jfr.trilinear_sample_pallas, block_n=64, interpret=True))
    tfn = _check_against_jax(True, MLP, grads=False, sampler="pallas", fuse_decode="off")
    grid, pts, dirs = (torch.from_numpy(x) for x in _inputs())
    with pytest.raises(RuntimeError, match="forward only"):
        tfn(grid.requires_grad_(True), pts, dirs)


def test_non_collapsible_decoder_normals_through_autograd_match_jax():
    """feat_emb_dims=2: no collapse and no fused decode; the normals are
    autograd of the density head through `KronSample` (K6's plain version
    from its backward), never carrying a gradient."""
    _check_against_jax(True, {**MLP, "feat_emb_dims": 2}, normals_by_jax_grad=False, sampler="fused",
                       fuse_decode="auto")


def test_two_layer_radiance_net_matches_jax():
    _check_against_jax(True, {**MLP, "rnet_num_layers": 2}, sampler="fused", fuse_decode="auto")


@pytest.mark.parametrize("args", [
    MLP, {**MLP, "feat_emb_dims": 2}, {**MLP, "rnet_num_layers": 2}, {**MLP, "activation_fn": "RELU"},
    {"dnet_hidden_dim": 256, "rnet_hidden_dim": 128},
], ids=["release", "feat_emb", "rnet2", "relu", "hydrant"])
def test_decoder_predicates_match_jax(args):
    """`density_net_is_collapsible` and `decode_is_fusable` as the JAX
    RenderMLP has them, for every decoder these tests use."""
    jm = JRenderMLP(input_dims=C, output_vp_independent_feature_dims=0, **args)
    bound = jm.bind(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, C)), jnp.ones((1, 3))))
    tm = RenderMLP(input_dims=C, **args)
    assert tm.density_net_is_collapsible == bound.density_net_is_collapsible
    assert tm.decode_is_fusable == bound.decode_is_fusable


def test_auto_modes_resolve_as_on_the_accelerator():
    """"auto": the fused decode for a fusable decoder on a grid of at most
    DEFAULT_MAX_GC values, else the layer-by-layer decode with the fused
    sampler ("packed" above that size); unknown modes raise."""
    grid, pts, dirs = (torch.from_numpy(x) for x in _inputs())
    calls = []
    fn = VoxelGridImplicitFunction(resol=D, volume_extent=EXTENT, n_hidden=C, render_mlp_args=MLP)
    fn._fused_decode = lambda *a: calls.append("fused_decode") or (None, None, {})
    with torch.no_grad():
        fn(grid, pts, dirs)
    fn = VoxelGridImplicitFunction(resol=D, volume_extent=EXTENT, n_hidden=C,
                                   render_mlp_args={**MLP, "feat_emb_dims": 1})
    fn._sample = lambda g, p, _s=fn._sample: calls.append("sample") or _s(g, p)
    with torch.no_grad():
        fn(grid, pts, dirs)
    assert calls == ["fused_decode", "sample"]
    assert ks.DEFAULT_MAX_GC == 16 ** 3 * 64
    with pytest.raises(ValueError, match="sampler"):
        VoxelGridImplicitFunction(sampler="bilinear")
    with pytest.raises(ValueError, match="fuse_decode"):
        VoxelGridImplicitFunction(fuse_decode="yes")


# ---- "auto" takes the fused decode only where its kernels launch

PE_DIM = 27  # dir_emb_dims 4: 3 x (2 x 4 + 1), every repo config


@pytest.mark.parametrize("C_, hidden, takes", [
    (8, 256, False), (32, 256, True), (64, 256, True), (257, 256, False),
    (64, 279, True), (64, 280, False), (64, 303, False), (64, 304, False),
], ids=["C8", "C32", "C64", "C257", "C64_h279", "C64_h280", "C64_h303", "C64_h304"])
def test_fused_decode_kernels_take_only_their_shapes(C_, hidden, takes):
    """`kernels_take`: C 32 or 64, and both K1/K3's and K2's shared memory
    within the 227 KB a block may opt into. At C 64, K2's edge is hidden
    279 and K1/K3's 303, so 280-303 run forward only and "auto" refuses
    them."""
    assert fd.kernels_take(C_, hidden, PE_DIM) == takes
    if C_ == 64 and hidden in (279, 280):
        assert (fd.bwd_smem_bytes(C_, hidden, PE_DIM) <= fd.SMEM_OPTIN_BYTES) == (hidden == 279)
    if C_ == 64 and hidden in (303, 304):
        assert (fd.fwd_smem_bytes(C_, hidden, PE_DIM) <= fd.SMEM_OPTIN_BYTES) == (hidden == 303)


def test_decode_shared_memory_as_the_kernels_report_it():
    """The hydrant layouts (C 64, hidden 256) as ptxas and the launches
    report them on an H100: K1/K3 214,784 bytes, K2 217,328; at C 32 the
    backward's column limit (320) refuses hidden 320 before its memory."""
    assert fd.fwd_smem_bytes(64, 256, PE_DIM) == 214_784
    assert fd.bwd_smem_bytes(64, 256, PE_DIM) == 217_328
    assert fd.kernels_take(32, 319, PE_DIM) and not fd.kernels_take(32, 320, PE_DIM)
    assert fd.bwd_smem_bytes(32, 320, PE_DIM) <= fd.SMEM_OPTIN_BYTES


def _resolved_decode(fn, grid):
    """Which branch `fn` takes on `grid`: "fused_decode" or "sample"."""
    calls = []
    fn._fused_decode = lambda *a: calls.append("fused_decode") or (None, None, {})
    fn._sample = lambda g, p, _s=fn._sample: calls.append("sample") or _s(g, p)
    pts = torch.zeros((1, 2, 3))
    with torch.no_grad():
        fn(grid, pts, torch.ones((1, 3)))
    return calls[0]


@pytest.mark.parametrize("model, hidden, want", [
    ("toy", None, "sample"), ("hydrant", None, "fused_decode"),
    ("hydrant", 279, "fused_decode"), ("hydrant", 280, "sample"),
], ids=["toy_C8", "hydrant_C64", "hydrant_h279", "hydrant_h280"])
def test_auto_resolves_by_the_kernels_predicate(model, hidden, want):
    """On the CPU, "auto" takes the branch the card would: the golden toy
    model (tests/test_torch_train_step.py TOY, C 8) decodes layer by layer,
    as does hydrant with a 280-wide density net (K2 cannot launch); hydrant
    itself, and at hidden 279, the fused decode."""
    if model == "toy":
        from torch_toy_model import TOY as GOLDEN_TOY

        fn = HoloDiffusionModel(**{**GOLDEN_TOY, "view_pooler_enabled": False}).implicit_function
        grid = torch.zeros((8, 8, 8, 8))
    else:
        args = model_args_from_config(load_config("hydrant"))
        mlp = {**args["render_mlp_args"], **({} if hidden is None else {"dnet_hidden_dim": hidden})}
        fn = VoxelGridImplicitFunction(resol=args["resol"], volume_extent=args["volume_extent"],
                                       n_hidden=args["feature_size"], render_mlp_args=mlp)
        grid = torch.zeros((16, 16, 16, args["feature_size"]))
    assert fn.fuse_decode == "auto" and fn.render_mlp.decode_is_fusable
    assert _resolved_decode(fn, grid) == want


def test_auto_fused_decode_matches_jax():
    """A fusable decoder at C 32, hidden 48 (which the kernels take) with
    "auto": the port takes the fused decode's plain version, the JAX package
    on the CPU its layer-by-layer decode; the same function, at the
    tolerances above."""
    assert fd.kernels_take(C, MLP["dnet_hidden_dim"], PE_DIM)
    _check_against_jax(True, MLP, sampler="fused", fuse_decode="auto")
    fn = VoxelGridImplicitFunction(resol=D, volume_extent=EXTENT, n_hidden=C, render_mlp_args=MLP)
    assert _resolved_decode(fn, torch.zeros((D, D, D, C))) == "fused_decode"


# ---- a narrow model with sampler="fused", fuse_decode="off"

B, N_RAYS, N_PTS, N_FINE = 2, 24, 8, 6
TOY = dict(
    resol=8, volume_extent=4.0, feature_size=32, net_3d_enabled=False, n_pts_per_ray_training=N_PTS,
    n_rays_per_image=N_RAYS, n_pts_per_ray_fine_training=N_FINE, stratified_point_sampling_training=True,
    density_noise_std_train=1.0, n_pts_per_ray_evaluation=8, n_pts_per_ray_fine_evaluation=8,
    scene_extent=2.0, render_normals=True, chunk_size_grid=40, render_mlp_args=dict(dnet_hidden_dim=48, rnet_hidden_dim=16),
    view_pooler_enabled=False, sampler="fused", fuse_decode="off",
)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _cams(n):
    R, T = j_look_at(dist=4.5, elev=jnp.asarray([20.0, -10.0][:n]), azim=jnp.asarray([30.0, 200.0][:n]))
    return JCams(R=R, T=T, focal_length=jnp.full((n, 2), 2.0), principal_point=jnp.zeros((n, 2)))


def _port_cams(jc):
    return PerspectiveCameras(*(_t(x) for x in (jc.R, jc.T, jc.focal_length, jc.principal_point)))


@functools.lru_cache(maxsize=None)
def _models():
    rs = np.random.RandomState(2)
    grid = np.tanh(rs.randn(8, 8, 8, 32)).astype(np.float32)
    jm = JModel(**TOY)
    bundle = jrays.sample_rays_full_grid(_cams(1), 2, 2, 4, scene_extent=2.0)
    variables = jax.jit(lambda key, g, b: jm.init(key, g, b, method=JModel.render_rays))(
        jax.random.PRNGKey(3), jnp.asarray(grid), bundle)
    flat = {k: (rs.randn(*v.shape).astype(np.float32) * 0.1 if k.endswith("bias") else np.asarray(v))
            for k, v in flatten_dict(variables["params"], sep="/").items()}
    variables = {"params": _unflatten(flat)}
    tm = HoloDiffusionModel(**TOY)
    tm.load_state_dict(state_dict_from_jax(flat), strict=True)
    return jm, variables, tm, grid


def test_model_chunked_render_matches_jax():
    """9 x 11 rays in chunks of 5 through two passes with normals: 2e-5 on
    images, masks and normals, 1e-4 on depths (as the fused path's test)."""
    jm, variables, tm, grid = _models()
    jc = _cams(2)
    j = j_render_chunked(jm, variables, jc[1], jnp.asarray(grid), image_height=9, image_width=11)
    _build.reset_launch_counts()
    t = render_image_chunked(tm, _port_cams(jc)[1], torch.from_numpy(grid), image_height=9, image_width=11,
                             device="cpu")
    assert set(t) == set(j) == {"images_render", "depths_render", "masks_render", "normals_render"}
    for k in j:
        np.testing.assert_allclose(t[k].numpy(), j[k], atol=1e-4 if k in ("depths_render", "normals_render")
                                   else 2e-5, err_msg=k)
    assert float(t["masks_render"].max()) > 0.05
    assert _no_launches()


def _mask():
    yy, xx = np.mgrid[:12, :14]
    blob = np.exp(-((yy - 5.0) ** 2 + (xx - 8.0) ** 2) / 8.0) * ((yy + xx) % 3 != 0)
    return np.stack([blob, np.ones_like(blob)]).astype(np.float32)


def test_model_training_objective_and_gradients_match_jax():
    """The toy's training step without pooling and denoiser (it has
    neither): mask-sampled stratified rays, the two-pass render with density
    noise and stratified refinement, the view metrics and the weighted
    objective, with the JAX draws (split as holo_model.py:390 and
    rays.py:150). Objective 1e-5 relative; the gradient of every parameter
    and of the grid 5e-4 + 2e-3 relative."""
    jm, variables, tm, grid = _models()
    jc = _cams(B)
    mask = _mask()
    rs = np.random.RandomState(4)
    img, fg = rs.rand(B, 12, 14, 3).astype(np.float32), (rs.rand(B, 12, 14, 1) > 0.3).astype(np.float32)
    rng = jax.random.PRNGKey(5)

    def j_objective(v, g):
        rendered, bundle = jm.apply(v, g, jc, True, rng, jnp.asarray(mask[..., None]), method=JModel.render)
        m = jmetrics.multipass_view_metrics(rendered, bundle.xys, jnp.asarray(img), None, jnp.asarray(fg))
        return jmetrics.get_objective(m, tm.loss_weights), rendered.features

    (j_obj, j_feats), j_grads = jax.jit(jax.value_and_grad(j_objective, argnums=(0, 1), has_aux=True))(
        variables, jnp.asarray(grid))
    rng_rays, rng_render = jax.random.split(rng)
    k_pix, k_len = jax.random.split(rng_rays)
    draws = {
        "ray_pixel_u": np.asarray(jax.random.uniform(k_pix, (B, N_RAYS))),
        "ray_length_u": np.asarray(jax.random.uniform(k_len, (B, N_RAYS, N_PTS))),
    }
    key, noise0 = jax.random.split(rng_render)
    key, refine1 = jax.random.split(key)
    key, noise1 = jax.random.split(key)
    draws.update(density_noise_0=np.asarray(jax.random.normal(noise0, (B, N_RAYS, N_PTS))),
                 refine_u_1=np.asarray(jax.random.uniform(refine1, (B, N_RAYS, N_FINE))),
                 density_noise_1=np.asarray(jax.random.normal(noise1, (B, N_RAYS, N_PTS + N_FINE))))
    tg = torch.from_numpy(grid).requires_grad_(True)
    tm.zero_grad()
    rendered, bundle = tm.render(tg, _port_cams(jc), True, draws, torch.from_numpy(mask[..., None]))
    m = tmetrics.multipass_view_metrics(rendered, bundle.xys, torch.from_numpy(img), None, torch.from_numpy(fg))
    t_obj = tmetrics.get_objective(m, tm.loss_weights)
    t_obj.backward()
    np.testing.assert_allclose(rendered.features.detach().numpy(), np.asarray(j_feats), atol=2e-5)
    np.testing.assert_allclose(float(t_obj.detach()), float(j_obj), **LOSS_TOL)
    want = state_dict_from_jax(flatten_dict(j_grads[0]["params"], sep="/"))
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), **GRAD_TOL, err_msg=name)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(j_grads[1]), **GRAD_TOL)
    assert _no_launches()


@pytest.mark.parametrize("config", sorted(n[:-len(".yaml")] for n in os.listdir(CONFIG_DIR) if n.endswith(".yaml")))
def test_model_args_read_the_sampler_as_jax(config):
    """Each YAML of the port gives JAX's `sampler` ("packed" when the YAML
    names none), with or without an override; no config key sets
    fuse_decode or collapse_density. A YAML of the port alone (the
    reference model's 32^3 x 128 grid, `hydrant_g32c128`) is read by JAX's
    loader and translator from the port's file; where its denoiser is the
    port's alone (DiT3D), JAX reads it with its own, the UNet."""
    model = "model_factory_ImplicitronModelFactory_args.model_HoloDiffusionModel_args."
    override = [model + "implicit_function_HoloVoxelGridImplicitFunction_args.sampler=fused"]
    port_only = not os.path.exists(os.path.join(J_CONFIG_DIR, config + ".yaml"))
    j_name = os.path.join(CONFIG_DIR, config + ".yaml") if port_only else config
    j_net = [] if model_args_from_config(load_config(config))["net_3d_class_type"] == "SimpleUnet3D" else [
        model + "net_3d_class_type=SimpleUnet3D"]
    for ov in ([], override):
        t = model_args_from_config(load_config(config, ov))
        j = j_model_args(j_load_config(j_name, j_net + ov))
        assert t["sampler"] == j["sampler"] == ("fused" if ov else "packed")
        assert "fuse_decode" not in t and "collapse_density" not in t
