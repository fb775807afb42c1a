"""The port's sample-quality evaluation (holo_diffusion_torch/evaluation_fid.py,
evaluate_samples.py and `cli.evaluate_samples_main`) against the JAX
package's on the same inputs: the FID/KID statistics on the same features
(1e-9 relative: both are the same float64 numpy), the VGG feature function
on converted weights (1e-5 of the features' scale), the real image set
(1e-5), the sample set of a tiny diffusion model with injected noise
against JAX's `p_sample` with the same noise then `model.apply` per pose
(2e-4 on images, 1e-3 on depths), the extractor factory, the whole
protocol and the CLI on a tiny trained run. Random extractors draw their
weights from torch generators, so they are checked for determinism, never
against JAX's."""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import json
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

sys.path.insert(0, os.path.dirname(__file__))
from test_inception import _rand_sd  # noqa: E402
from test_torch_lpips import _random_vgg_sd  # noqa: E402
from test_torch_slice import SHAPE, TINY, UNET, _port_cam  # noqa: E402
from torch_tiny_config import tiny_cfg  # noqa: E402

from holo_diffusion_torch import cli  # noqa: E402
from holo_diffusion_torch import evaluate_samples as tes  # noqa: E402
from holo_diffusion_torch import evaluation_fid as tf  # noqa: E402
from holo_diffusion_torch.experiment import Experiment  # noqa: E402
from holo_diffusion_torch.models.holo_model import HoloDiffusionModel  # noqa: E402
from holo_diffusion_torch.models.inception import random_inception  # noqa: E402
from holo_diffusion_torch.models.lpips import VGG16Features, random_vgg_features  # noqa: E402
from holo_diffusion_torch.weights import state_dict_from_jax  # noqa: E402
from holo_diffusion_tpu import evaluate_samples as jes  # noqa: E402
from holo_diffusion_tpu import evaluation_fid as jf  # noqa: E402
from holo_diffusion_tpu.models import diffusion as jgd  # noqa: E402
from holo_diffusion_tpu.models.holo_model import HoloDiffusionModel as JModel  # noqa: E402
from holo_diffusion_tpu.models.lpips import TAP_DIMS, lpips_params_from_torch  # noqa: E402
from holo_diffusion_tpu.utils.flyaround import CANONICAL_CO3D_UP_AXIS  # noqa: E402
from holo_diffusion_tpu.utils.flyaround import simple_360_cameras as j_simple_360  # noqa: E402

STATS_TOL = 1e-9  # relative; the same float64 numpy on both sides
FEATURE_TOL = 1e-5  # of the features' scale
REAL_TOL = 1e-5
IMAGE_TOL, DEPTH_TOL = 2e-4, 1e-3  # as tests/test_torch_slice.py: 6 UNet steps, a 2-pass render
# the keys of the JAX package's evaluate_samples result (evaluate_samples.py:226-237)
RESULT_KEYS = ("{}_fid", "{}_kid_mean", "{}_kid_std", "n_generated", "n_real", "num_samples",
               "poses_per_sample", "extractor", "comparable_to_inception_fid")


def _features(seed, n, d=16, shift=0.0):
    return np.random.RandomState(seed).randn(n, d) + shift


def test_feature_stats_fid_and_kid_match_jax():
    a, b = _features(0, 40), _features(1, 50, shift=0.5)
    ident = lambda x: x  # noqa: E731
    for (mu, sig, f), (jmu, jsig, jfeat) in zip(
            (tf.compute_feature_stats(a, ident, 7), tf.compute_feature_stats(b, ident, 64)),
            (jf.compute_feature_stats(a, ident, 7), jf.compute_feature_stats(b, ident, 64))):
        np.testing.assert_allclose(mu, jmu, rtol=STATS_TOL)
        np.testing.assert_allclose(sig, jsig, rtol=STATS_TOL)
        np.testing.assert_array_equal(f, jfeat)
    (mu_a, sig_a, fa), (mu_b, sig_b, fb) = tf.compute_feature_stats(a, ident), tf.compute_feature_stats(b, ident)
    assert tf.frechet_distance(mu_a, sig_a, mu_b, sig_b) == pytest.approx(
        jf.frechet_distance(mu_a, sig_a, mu_b, sig_b), rel=STATS_TOL)
    for kw in (dict(n_subsets=10, subset_size=20), dict(n_subsets=5, subset_size=None, seed=3)):
        got, want = tf.kid_score(fa, fb, **kw), jf.kid_score(fa, fb, **kw)
        assert got == pytest.approx(want, rel=STATS_TOL)
    np.testing.assert_allclose(tf._sqrtm_psd(sig_a), jf._sqrtm_psd(sig_a), rtol=STATS_TOL, atol=1e-12)


def test_fid_closed_forms():
    """FID of a Gaussian with itself is 0; for diagonal Gaussians it is
    |dmu|^2 + sum (sqrt(s1) - sqrt(s2))^2; KID separates shifted sets."""
    rs = np.random.RandomState(0)
    m = rs.randn(8, 8)
    sigma = m @ m.T + np.eye(8)
    assert tf.frechet_distance(np.zeros(8), sigma, np.zeros(8), sigma) == pytest.approx(0.0, abs=1e-6)
    got = tf.frechet_distance(np.zeros(2), np.diag([4.0, 9.0]), np.array([1.0, -2.0]), np.diag([1.0, 16.0]))
    assert got == pytest.approx(7.0, rel=1e-9)
    same, _ = tf.kid_score(_features(1, 600), _features(2, 600), n_subsets=20, subset_size=100)
    apart, _ = tf.kid_score(_features(1, 600), _features(3, 600, shift=1.5), n_subsets=20, subset_size=100)
    assert abs(same) < 0.05 and apart > 0.5


def test_fid_kid_between_image_sets_matches_jax():
    rs = np.random.RandomState(2)
    imgs_a = rs.rand(40, 8, 8, 3).astype(np.float32)
    imgs_b = np.clip(imgs_a + 0.3 * rs.randn(40, 8, 8, 3), 0, 1).astype(np.float32)
    proj = np.random.RandomState(3).randn(8 * 8 * 3, 12)

    def feature_fn(x):
        return x.reshape(len(x), -1) @ proj

    got = tf.fid_kid_between_image_sets(imgs_a, imgs_b, feature_fn, kid_subsets=10, kid_subset_size=20)
    want = jf.fid_kid_between_image_sets(imgs_a, imgs_b, feature_fn, kid_subsets=10, kid_subset_size=20)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=STATS_TOL), k
    same = tf.fid_kid_between_image_sets(imgs_a, imgs_a, feature_fn, kid_subsets=10, kid_subset_size=20)
    assert same["fid"] == pytest.approx(0.0, abs=1e-6) and got["fid"] > same["fid"]


@pytest.fixture(scope="module")
def vgg_weights():
    sd = _random_vgg_sd(4)
    jvars = {"params": lpips_params_from_torch(sd, [np.ones(c, np.float32) for c in TAP_DIMS])["params"]["vgg"]}
    vgg = VGG16Features()
    vgg.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return sd, jvars, vgg


@pytest.mark.parametrize("size", [(32, 40), (64, 64)])
def test_vgg_pooled_features_match_jax(vgg_weights, size):
    """32 x 40 grows to 64 x 80 (short side to 64, aspect kept); 64^2 goes
    in as it is."""
    _, jvars, vgg = vgg_weights
    x = np.random.RandomState(5).rand(3, *size, 3).astype(np.float32)
    want = jf.vgg_pooled_feature_fn(jvars)(x)
    got = tf.vgg_pooled_feature_fn(vgg)(x)
    assert got.shape == want.shape == (3, 512)
    np.testing.assert_allclose(got, want, atol=FEATURE_TOL * np.abs(want).max(), rtol=0)


def test_real_image_set_matches_jax():
    """Two scenes of 3 frames at 20 x 24, fg-masked onto white, shrunk to
    12 x 16; `n_real` 4 stops after the second scene and cuts it."""
    rs = np.random.RandomState(6)
    frames = [(rs.rand(3, 20, 24, 3).astype(np.float32), rs.rand(3, 20, 24, 1).astype(np.float32))
              for _ in range(2)]
    model = SimpleNamespace(mask_images=True, mask_depths=True, mask_threshold=0.5, bg_color=(1.0, 1.0, 1.0))
    for n_real in (4, None):
        want = jes._real_image_set([SimpleNamespace(image_rgb=jnp.asarray(i), fg_probability=jnp.asarray(f))
                                    for i, f in frames], (12, 16), model, n_real)
        got = tes._real_image_set([SimpleNamespace(image_rgb=torch.from_numpy(i), fg_probability=torch.from_numpy(f))
                                   for i, f in frames], (12, 16), model, n_real, device="cpu")
        assert got.shape == want.shape == (n_real or 6, 12, 16, 3)
        np.testing.assert_allclose(got, want, atol=REAL_TOL, rtol=0)


@pytest.fixture(scope="module")
def tiny_models():
    """The serving slice test's tiny diffusion model (6 DDPM steps, 8^2
    renders) with JAX's initial weights on both sides."""
    jm = JModel(**TINY, net_3d_args=dict(UNET, use_remat=False), view_pooler_enabled=False, fuse_decode="on")
    cam = j_simple_360(1, dist=4.5, up=(0.0, 1.0, 0.0))
    variables = jax.jit(lambda k, c, v: jm.init(k, camera=c, voxel_features=v, training=False))(
        jax.random.PRNGKey(0), cam, jnp.zeros(SHAPE))
    flat = {k: np.asarray(v) for k, v in flatten_dict(variables["params"], sep="/").items()}
    tm = HoloDiffusionModel(**TINY, net_3d_args=UNET, view_pooler_enabled=False)
    tm.load_state_dict(state_dict_from_jax(flat), strict=True)
    return jm, variables, tm.eval()


def test_render_sample_set_matches_jax(tiny_models):
    """2 samples x 2 poses: each sample's 6 DDPM steps with injected noise,
    then one forward a pose on the sample's turned orbit; JAX runs
    `p_sample` with the same noise, then `model.apply` per pose, as its
    `_render_sample_set` does."""
    jm, variables, tm = tiny_models
    n, poses, dist = 2, 2, 4.5
    rs = np.random.RandomState(7)
    x_T = [rs.randn(*SHAPE).astype(np.float32) for _ in range(n)]
    step_noise = [[rs.randn(*SHAPE).astype(np.float32) for _ in range(6)] for _ in range(n)]
    got = tes._render_sample_set(tm, n, poses, dist, noise=[torch.from_numpy(x) for x in x_T],
                                 step_noise=[[torch.from_numpy(s) for s in ss] for ss in step_noise], device="cpu")

    net = jax.jit(lambda x, t: jm.apply(variables, x, t, method=JModel.apply_net_3d))
    fwd = jax.jit(lambda c, g: jm.apply(variables, camera=c, voxel_features=g, training=False))
    sched = jgd.make_named_schedule_from_config(jm.diffusion_args)
    want, depths = [], []
    for i in range(n):
        x = jnp.asarray(x_T[i])
        for t_scalar, s in zip(range(5, -1, -1), step_noise[i]):
            x = jgd.p_sample(sched, net, x, jnp.full((1,), t_scalar, jnp.int32), None, noise=jnp.asarray(s))["sample"]
        grid = jnp.clip(x, -1.0, 1.0)
        cams = j_simple_360(poses, dist=dist, up=CANONICAL_CO3D_UP_AXIS, azimuth_offset=360.0 * i / n)
        tcams = _port_cam(cams)
        for p in range(poses):
            preds = fwd(cams[p], grid)
            want.append(np.asarray(jnp.clip(preds["images_render"][0], 0.0, 1.0)))
            with torch.no_grad():
                tpreds = tm(tcams[p], torch.from_numpy(np.asarray(grid).copy()))
            depths.append((tpreds["depths_render"].numpy(), np.asarray(preds["depths_render"])))
    assert got.shape == (n * poses, 8, 8, 3)
    np.testing.assert_allclose(got, np.stack(want), atol=IMAGE_TOL, rtol=0)
    for t_depth, j_depth in depths:
        np.testing.assert_allclose(t_depth, j_depth, atol=DEPTH_TOL, rtol=0)
    assert float(got.std()) > 0.0


def test_feature_fn_factory(vgg_weights, tmp_path):
    """The JAX package's errors; `vgg` and `inception` read torch files (a
    full torchvision vgg16 state_dict, a pytorch-fid one); the random
    extractors are deterministic in their seed."""
    for extractor, match in (("vgg", "extractor='vgg' needs vgg_weights_path"),
                             ("inception", "extractor='inception' needs weights_path"),
                             ("alexnet", "unknown extractor 'alexnet'")):
        with pytest.raises(ValueError, match=match):
            tes._make_feature_fn(extractor, None, device="cpu")
        with pytest.raises(ValueError, match=match):
            jes._make_feature_fn(extractor, None, (8, 8))
    sd, _, vgg = vgg_weights
    torch.save({f"features.{k}": torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "vgg.pth")
    torch.save({k: torch.from_numpy(v) for k, v in _rand_sd(np.random.RandomState(0)).items()}, tmp_path / "inc.pth")
    x = np.random.RandomState(8).rand(1, 24, 24, 3).astype(np.float32)
    fn, label = tes._make_feature_fn("vgg", str(tmp_path / "vgg.pth"), device="cpu")
    assert label == "vgg"
    np.testing.assert_array_equal(fn(x), tf.vgg_pooled_feature_fn(vgg)(x))
    fn, label = tes._make_feature_fn("inception", str(tmp_path / "inc.pth"), device="cpu")
    assert label == "inception" and fn(x).shape == (1, 2048)
    for extractor, dim, make in (("random_vgg", 512, random_vgg_features), ("random_inception", 2048, random_inception)):
        fn, label = tes._make_feature_fn(extractor, None, device="cpu")
        f = fn(x)
        assert label == extractor and f.shape == (1, dim) and np.isfinite(f).all()
        weights = [next(iter(make(seed).parameters())) for seed in (0, 0, 1)]
        assert torch.equal(weights[0], weights[1]) and not torch.equal(weights[0], weights[2])


def test_evaluate_samples_end_to_end(tiny_models, tmp_path):
    """The protocol on the tiny model: 2 samples (1 DDPM step each) x 2
    poses against 2 scenes of 3 frames, with the random VGG; JAX's keys and
    counts, the dump, the phases' seconds, the same result again for the
    same seed; a given feature_fn labelled "inception" is comparable to
    Inception-FID; a non-diffusion model is refused."""
    _, _, tm = tiny_models
    rs = np.random.RandomState(9)
    scenes = [SimpleNamespace(image_rgb=torch.from_numpy(rs.rand(3, 12, 12, 3).astype(np.float32)),
                              fg_probability=torch.from_numpy(rs.rand(3, 12, 12, 1).astype(np.float32)))
              for _ in range(2)]
    timings = {}
    kw = dict(num_samples=2, poses_per_sample=2, trajectory_distance=4.5, max_iter=1, kid_subset_size=2, device="cpu")
    res = tes.evaluate_samples(tm, scenes, extractor="random_vgg", generator=torch.Generator().manual_seed(2),
                               dump_path=str(tmp_path / "e.json"), timings=timings, **kw)
    assert set(res) == {k.format("random_vgg") for k in RESULT_KEYS}
    assert (res["n_generated"], res["n_real"], res["extractor"]) == (4, 6, "random_vgg")
    assert res["comparable_to_inception_fid"] is False
    assert np.isfinite(res["random_vgg_fid"]) and res["random_vgg_fid"] >= 0
    assert np.isfinite(res["random_vgg_kid_mean"])
    assert json.load(open(tmp_path / "e.json")) == res
    assert sorted(timings) == ["features_s", "fid_kid_s", "frames_s", "real_s", "sample_s"]
    proj = np.random.RandomState(10).randn(8 * 8 * 3, 6)  # renders and real frames at 8^2
    flagged, again = (tes.evaluate_samples(tm, scenes, extractor="inception", generator=torch.Generator().manual_seed(2),
                                           feature_fn=lambda x: x.reshape(len(x), -1) @ proj, **kw)
                      for _ in range(2))
    assert again == flagged  # the same seed, the same result
    assert set(flagged) == {k.format("inception") for k in RESULT_KEYS}
    assert flagged["comparable_to_inception_fid"] is True
    with pytest.raises(AssertionError, match="needs a diffusion model"):
        tes.evaluate_samples(HoloDiffusionModel(**{**TINY, "diffusion_enabled": False}, net_3d_args=UNET,
                                                view_pooler_enabled=False), scenes, device="cpu")


@pytest.fixture(scope="module")
def trained_exp(tmp_path_factory):
    exp_dir = tmp_path_factory.mktemp("fid") / "exp"
    Experiment(tiny_cfg(exp_dir), device="cpu").run(max_epochs=1)
    return exp_dir


@pytest.mark.parametrize("extractor", ["random_vgg", "vgg"])
def test_cli_on_a_trained_run(trained_exp, extractor, vgg_weights, tmp_path):
    """`evaluate_samples_main` on the tiny run's checkpoint with JAX's
    key=value arguments (`vgg_weights_path` the alias of `weights_path`).
    The Inception extractors are held by the factory test: their 2048-d
    FID is seconds of host float64 on its own."""
    args = [f"exp_dir={trained_exp}", "num_samples=2", "poses_per_sample=2", "max_iter=1", "n_real=4",
            "device=cpu", f"extractor={extractor}", f"dump_path={tmp_path / 'r.json'}"]
    if extractor == "vgg":
        torch.save({k: torch.from_numpy(v) for k, v in vgg_weights[0].items()}, tmp_path / "vgg.pth")
        args.append(f"vgg_weights_path={tmp_path / 'vgg.pth'}")
    res = cli.evaluate_samples_main(args)
    assert set(res) == {k.format(extractor) for k in RESULT_KEYS}
    assert (res["n_generated"], res["n_real"]) == (4, 4)
    assert np.isfinite(res[f"{extractor}_fid"]) and np.isfinite(res[f"{extractor}_kid_mean"])
    assert res["comparable_to_inception_fid"] is False
    assert json.load(open(tmp_path / "r.json")) == res
    with pytest.raises(ValueError, match="unknown args"):
        cli.evaluate_samples_main([f"exp_dir={trained_exp}", "device=cpu", "n_fakes=3"])


def test_cli_default_dump_and_no_cuda(trained_exp, monkeypatch):
    res = cli.evaluate_samples_main([f"exp_dir={trained_exp}", "num_samples=1", "poses_per_sample=2",
                                     "max_iter=1", "n_real=2", "device=cpu"])
    assert json.load(open(trained_exp / "sample_eval_results.json")) == res
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: cli.evaluate_samples_main([f"exp_dir={trained_exp}"]),
                 lambda: tes._make_feature_fn("random_vgg", None)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
