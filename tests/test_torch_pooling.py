"""View pooling of the port (holo_diffusion_torch: ops/image.py,
models/feature_extractor.py, models/view_pooler.py and
`HoloDiffusionModel.pool_features`) against the JAX package on the same
numpy inputs with converted weights, on the CPU. Float32 on both sides."""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

sys.path.insert(0, os.path.dirname(__file__))

from test_holo_forward_parity import GOLD, _model  # noqa: E402

from holo_diffusion_tpu.geometry.cameras import PerspectiveCameras as JCams  # noqa: E402
from holo_diffusion_tpu.geometry.cameras import look_at_view_transform as j_look_at  # noqa: E402
from holo_diffusion_tpu.models import view_pooler as jvp  # noqa: E402
from holo_diffusion_tpu.models.feature_extractor import ResNetFeatureExtractor as JExtractor  # noqa: E402
from holo_diffusion_tpu.models.holo_model import HoloDiffusionModel as JModel  # noqa: E402
from holo_diffusion_tpu.ops import image as jimage  # noqa: E402
from holo_diffusion_torch.geometry.cameras import PerspectiveCameras  # noqa: E402
from holo_diffusion_torch.models import view_pooler as tvp  # noqa: E402
from holo_diffusion_torch.models.feature_extractor import ResNetFeatureExtractor  # noqa: E402
from holo_diffusion_torch.models.holo_model import HoloDiffusionModel  # noqa: E402
from holo_diffusion_torch.ops import image as timage  # noqa: E402
from holo_diffusion_torch.weights import init_weights, state_dict_from_jax, state_dict_from_reference  # noqa: E402

from test_torch_train_step import TOY  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _cams(n):
    R, T = j_look_at(dist=4.0, elev=jnp.linspace(-20.0, 40.0, n), azim=jnp.linspace(0.0, 300.0, n))
    return JCams(R=R, T=T, focal_length=jnp.full((n, 2), 2.2), principal_point=jnp.full((n, 2), 0.05))


def _port_cams(jc):
    return PerspectiveCameras(*(_t(x) for x in (jc.R, jc.T, jc.focal_length, jc.principal_point)))


@pytest.mark.parametrize("size", [(7, 5), (20, 26)], ids=["down", "up"])
def test_resize_image_matches_jax(size):
    """Bilinear, half-pixel centres, no antialiasing, in float32: 1e-6."""
    img = np.random.RandomState(0).rand(2, 12, 10, 3).astype(np.float32)
    j = jimage.resize_image(jnp.asarray(img), *size)
    t = timage.resize_image(torch.from_numpy(img), *size)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)


def test_bilinear_sample_ndc_matches_jax():
    """Points inside, on the border and outside (zero padding): 1e-6."""
    rs = np.random.RandomState(1)
    img = rs.rand(9, 11, 4).astype(np.float32)
    xys = rs.uniform(-1.3, 1.3, (5, 7, 2)).astype(np.float32)
    j = jimage.bilinear_sample_ndc(jnp.asarray(img), jnp.asarray(xys))
    t = timage.bilinear_sample_ndc(torch.from_numpy(img), torch.from_numpy(xys))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)


def _randomised(variables, seed):
    """JAX variables with random BN scales, biases and running statistics,
    so that the BN arithmetic is exercised."""
    rs = np.random.RandomState(seed)
    params = flatten_dict(variables["params"], sep="/")
    stats = flatten_dict(variables["batch_stats"], sep="/")
    for k in params:
        if k.endswith("scale"):
            params[k] = rs.uniform(0.5, 1.5, params[k].shape).astype(np.float32)
        elif k.endswith("bias"):
            params[k] = rs.normal(0, 0.1, params[k].shape).astype(np.float32)
    for k in stats:
        stats[k] = (rs.uniform(0.5, 1.5, stats[k].shape) if k.endswith("var")
                    else rs.normal(0, 0.2, stats[k].shape)).astype(np.float32)
    from flax.traverse_util import unflatten_dict

    return {"params": unflatten_dict(params, sep="/"), "batch_stats": unflatten_dict(stats, sep="/")}


def _extractor_pair(kwargs, shape, seed):
    rs = np.random.RandomState(seed)
    imgs = rs.rand(*shape, 3).astype(np.float32)
    masks = (rs.rand(*shape, 1) > 0.5).astype(np.float32)
    jm = JExtractor(**kwargs)
    variables = _randomised(jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(imgs), jnp.asarray(masks)), seed)
    prefix = lambda tree: {f"feature_extractor/{k}": np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}
    sd = state_dict_from_jax(prefix(variables["params"]), prefix(variables["batch_stats"]))
    tm = ResNetFeatureExtractor(**kwargs)
    tm.load_state_dict({k[len("image_feature_extractor."):]: v for k, v in sd.items()}, strict=True)
    return jm, variables, tm, imgs, masks


@pytest.mark.parametrize("arch", ["resnet18_stage1", "resnet34_stages1234"])
def test_feature_extractor_matches_jax(arch):
    """Every output map against JAX's: the l2-normalised projections within
    1e-5 (float32 convolutions summed in other orders), images and masks
    passed through as they are."""
    if arch == "resnet18_stage1":
        kwargs, shape = dict(name_arch="resnet18", stages=(1,), proj_dim=4, image_rescale=0.5), (3, 32, 32)
    else:
        kwargs, shape = dict(name_arch="resnet34", stages=(1, 2, 3, 4), proj_dim=16, image_rescale=0.32), (2, 64, 64)
    jm, variables, tm, imgs, masks = _extractor_pair(kwargs, shape, 2)
    j = jax.jit(jm.apply)(variables, jnp.asarray(imgs), jnp.asarray(masks))
    t = tm(torch.from_numpy(imgs), torch.from_numpy(masks))
    assert sorted(t) == sorted(j)
    for k in j:
        np.testing.assert_allclose(t[k].detach().numpy(), np.asarray(j[k]), atol=1e-5, err_msg=k)


def test_batch_norm_keeps_running_statistics_in_train_mode():
    """`model.train()` does not switch the extractor's BN to batch
    statistics (the reference calls it in eval mode) nor update them."""
    _, _, tm, imgs, masks = _extractor_pair(dict(name_arch="resnet18", stages=(1,), proj_dim=4), (2, 32, 32), 3)
    stats = {k: v.clone() for k, v in tm.state_dict().items() if "running" in k}
    tm.eval()
    want = tm(torch.from_numpy(imgs), torch.from_numpy(masks))["res_layer_1"]
    tm.train()
    got = tm(torch.from_numpy(imgs), torch.from_numpy(masks))["res_layer_1"]
    assert torch.equal(got, want)
    assert all(torch.equal(v, tm.state_dict()[k]) for k, v in stats.items())


def _feats_and_points(S, seed):
    rs = np.random.RandomState(seed)
    feats = {"images": rs.rand(S, 20, 24, 3), "masks": rs.rand(S, 20, 24, 1), "res_layer_1": rs.randn(S, 5, 6, 4)}
    feats = {k: v.astype(np.float32) for k, v in feats.items()}
    pts = rs.uniform(-1.5, 1.5, (40, 3)).astype(np.float32)
    return feats, pts


def test_sample_view_features_matches_jax():
    """Projection of the points into 4 views and the sampling of every map
    (the JAX package samples small maps by a matmul, the port by gathers:
    the same values): 1e-5."""
    jc = _cams(4)
    feats, pts = _feats_and_points(4, 4)
    j_f, j_m = jax.jit(jvp.sample_view_features)({k: jnp.asarray(v) for k, v in feats.items()}, jc, jnp.asarray(pts))
    t_f, t_m = tvp.sample_view_features({k: torch.from_numpy(v) for k, v in feats.items()}, _port_cams(jc),
                                        torch.from_numpy(pts))
    np.testing.assert_allclose(t_f.numpy(), np.asarray(j_f), atol=1e-5)
    np.testing.assert_array_equal(t_m.numpy(), np.asarray(j_m))


@pytest.mark.parametrize("aggregator", ["MLPMeanFeatureAggregator", "AngleWeightedReductionFeatureAggregator"])
def test_view_pooler_matches_jax(aggregator):
    """Sampling + aggregation over 4 views with converted weights: 1e-5."""
    jc = _cams(4)
    feats, pts = _feats_and_points(4, 5)
    args = dict(n_hidden=16, dim_out=12) if aggregator == "MLPMeanFeatureAggregator" else {}
    jm = jvp.ViewPooler(aggregator_class_type=aggregator, aggregator_args=args)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jfeats, jc, jnp.asarray(pts))
    tm = tvp.ViewPooler(feat_dim=8, aggregator_class_type=aggregator, aggregator_args=args)
    flat = {f"view_pooler/{k}": np.asarray(v) for k, v in flatten_dict(variables.get("params", {}), sep="/").items()}
    tm.load_state_dict({k[len("view_pooler."):]: v for k, v in state_dict_from_jax(flat).items()}, strict=True)
    j = jax.jit(jm.apply)(variables, jfeats, jc, jnp.asarray(pts))
    t = tm({k: torch.from_numpy(v) for k, v in feats.items()}, _port_cams(jc), torch.from_numpy(pts))
    assert t.shape == j.shape == (40, tm.out_dim)
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-5)


def test_pool_features_matches_jax_and_golden():
    """The whole pooling half of the toy model (extractor, sampling at the
    voxel centres, MLPMean, mapper, tanh) from the golden's reference
    weights, against JAX's `pool_features` and the golden's pooled grid:
    1e-4 (the JAX package's own bound against this golden)."""
    from holo_diffusion_tpu.utils.torch_import import convert_holo_model_state_dict

    jc = JCams(*(jnp.asarray(GOLD[k]) for k in ("cam_R", "cam_T", "cam_focal", "cam_pp")))
    img = GOLD["image_rgb"]
    fg = (GOLD["fg_probability"] > 0.5).astype(np.float32)
    img = img * fg + (1.0 - fg)
    jm = _model()
    args = (jnp.asarray(img[1:]), jc[1:], jnp.asarray(fg[1:]), None)
    base = jax.jit(lambda k, a: jm.init(k, *a, method=JModel.pool_features))(jax.random.PRNGKey(0), args)
    sd = {k[4:]: GOLD[k] for k in GOLD.files if k.startswith("sd::")}
    variables = convert_holo_model_state_dict(
        sd, base, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions=(2,), dnet_num_layers=4,
        rnet_num_layers=1, resnet_layers=(2, 2, 2, 2), resnet_stages=(1,))
    variables = {c: {k: v for k, v in tree.items() if k in base[c]} for c, tree in variables.items()}
    j = jax.jit(lambda v, a: jm.apply(v, *a, method=JModel.pool_features))(variables, args)
    tm = HoloDiffusionModel(**TOY)
    tm.load_state_dict(state_dict_from_reference(sd), strict=True)
    t_cams = PerspectiveCameras(*(torch.from_numpy(GOLD[k]) for k in ("cam_R", "cam_T", "cam_focal", "cam_pp")))
    with torch.no_grad():
        t = tm.pool_features(torch.from_numpy(img[1:]), t_cams[1:], torch.from_numpy(fg[1:]))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4)
    np.testing.assert_allclose(t.numpy(), GOLD["eval_grid_pooled"], atol=1e-4)


def test_init_weights_follows_the_jax_initialisers():
    """Seeded: extractor convolutions lecun-normal (std 1/sqrt(fan_in)),
    linear layers xavier-uniform, BN at weight 1, bias 0, mean 0, var 1."""
    tm = init_weights(HoloDiffusionModel(**TOY), seed=0)
    w = tm.image_feature_extractor.net.layer1[0].conv1.weight.detach()
    assert abs(w.std().item() - (1.0 / (64 * 9)) ** 0.5) < 0.1 * (1.0 / (64 * 9)) ** 0.5
    lin = tm.view_pooler.feature_aggregator._first_sampled.weight.detach()
    assert float(lin.abs().max()) <= (6.0 / sum(lin.shape)) ** 0.5
    bn = tm.image_feature_extractor.net.bn1
    assert torch.equal(bn.weight, torch.ones(64)) and torch.equal(bn.running_var, torch.ones(64))
    assert torch.equal(bn.bias, torch.zeros(64)) and torch.equal(bn.running_mean, torch.zeros(64))
    again = init_weights(HoloDiffusionModel(**TOY), seed=0)
    assert all(torch.equal(a, b) for a, b in zip(tm.state_dict().values(), again.state_dict().values()))
