"""Compact-source batches of the port (data/compact.py, the model's compact
branch, FrameData's `src_*` fields) against the JAX package on the CPU:

  * the C++ composite + resize bitwise JAX's library on odd frame sizes,
    with and without fg, masking on and off, two background colours;
  * `SourceCompactor` bitwise JAX's with "native", within 1 uint8 level with
    "exact" (torch's and XLA's float32 bilinear round differently); its
    split table, no-op cases and `drop_depth`;
  * `CompactSceneSampler` bitwise JAX's on the same scenes and RandomState,
    and bitwise the port's own per-batch transform;
  * the compact `pool_features` and training forward of the goldens' toy
    model against JAX's compact path at 1e-4 (the forward parity tests'
    bound, tests/test_torch_pooling.py);
  * port-compact against port-full at JAX's own bounds
    (tests/test_compact_sources.py:125-146: grid max 0.3, mean 0.02,
    objective within 10 %);
  * a compact training step and compact `Experiment.run`s (scene cache,
    per-batch transform, chunked compact validation).
"""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_holo_forward_parity import GOLD  # noqa: E402
from test_holo_forward_parity import _model as j_toy_model  # noqa: E402
from test_torch_train_full import _model_draws  # noqa: E402
from test_torch_train_step import _golden_model  # noqa: E402
from torch_tiny_config import MODEL, tiny_cfg  # noqa: E402

from holo_diffusion_torch import native as tnative  # noqa: E402
from holo_diffusion_torch.data.compact import CompactSceneSampler, SourceCompactor  # noqa: E402
from holo_diffusion_torch.data.frame_data import FrameData  # noqa: E402
from holo_diffusion_torch.data.source import SceneDataset  # noqa: E402
from holo_diffusion_torch.data.synthetic import make_synthetic_scene  # noqa: E402
from holo_diffusion_torch.experiment import Experiment  # noqa: E402
from holo_diffusion_torch.geometry.cameras import PerspectiveCameras  # noqa: E402
from holo_diffusion_torch.models.holo_model import HoloDiffusionModel  # noqa: E402
from holo_diffusion_torch.parallel.train_step import TrainState, make_train_step  # noqa: E402
from holo_diffusion_torch.train.optimizer import make_optimizer  # noqa: E402
from holo_diffusion_torch.weights import init_weights  # noqa: E402
from holo_diffusion_tpu import native as jnative  # noqa: E402
from holo_diffusion_tpu.data.compact import CompactSceneSampler as JCompactSceneSampler  # noqa: E402
from holo_diffusion_tpu.data.compact import SourceCompactor as JSourceCompactor  # noqa: E402
from holo_diffusion_tpu.data.frame_data import FrameData as JFrameData  # noqa: E402
from holo_diffusion_tpu.data.source import SceneDataset as JSceneDataset  # noqa: E402
from holo_diffusion_tpu.geometry.cameras import PerspectiveCameras as JCameras  # noqa: E402
from holo_diffusion_tpu.utils.torch_import import convert_holo_model_state_dict  # noqa: E402

FWD_TOL = 1e-4
KW = dict(n_train_target_views=2, image_rescale=0.5, mask_images=True, mask_threshold=0.5,
          bg_color=(1.0, 1.0, 1.0))
CAMS = ("R", "T", "focal_length", "principal_point")


def _frames(seed, n, H, W):
    """uint8 frames, fg probabilities, mask_crops, float32 depths and cameras."""
    rs = np.random.RandomState(seed)
    return dict(image_rgb=rs.randint(0, 256, (n, H, W, 3), dtype=np.uint8),
                fg_probability=rs.randint(0, 256, (n, H, W, 1), dtype=np.uint8),
                mask_crop=(rs.rand(n, H, W, 1) > 0.2).astype(np.uint8) * 255,
                depth_map=rs.rand(n, H, W, 1).astype(np.float32),
                sequence_id=np.full((n,), seed, np.int32),
                R=rs.randn(n, 3, 3).astype(np.float32), T=rs.randn(n, 3).astype(np.float32),
                focal_length=rs.rand(n, 2).astype(np.float32) + 1, principal_point=rs.rand(n, 2).astype(np.float32))


def _port(f):
    return FrameData(PerspectiveCameras(*(torch.from_numpy(f[k].copy()) for k in CAMS)),
                     **{k: torch.from_numpy(f[k].copy()) for k in
                        ("image_rgb", "fg_probability", "mask_crop", "depth_map", "sequence_id")})


def _jax(f):
    return JFrameData(camera=JCameras(*(f[k] for k in CAMS)),
                      **{k: f[k] for k in ("image_rgb", "fg_probability", "mask_crop", "depth_map", "sequence_id")})


def _assert_same_batch(t, j):
    """Every field of the port's FrameData bitwise the JAX one's."""
    for k in CAMS:
        np.testing.assert_array_equal(getattr(t.camera, k).numpy(), np.asarray(getattr(j.camera, k)), err_msg=k)
    for k in ("image_rgb", "fg_probability", "mask_crop", "depth_map", "sequence_id", "src_image_rgb",
              "src_fg_probability", "src_mask_crop"):
        a, b = getattr(t, k), getattr(j, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.numpy().dtype == np.asarray(b).dtype, k
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)


@pytest.mark.parametrize("with_fg", [True, False])
@pytest.mark.parametrize("mask_images", [True, False])
@pytest.mark.parametrize("bg", [(1.0, 1.0, 1.0), (0.2, 0.7, 0.0)])
def test_native_compaction_is_bitwise_jax(with_fg, mask_images, bg):
    rs = np.random.RandomState(hash((with_fg, mask_images, bg)) % 2 ** 31)
    imgs = rs.randint(0, 256, (3, 37, 29, 3), dtype=np.uint8)
    fgs = rs.randint(0, 256, (3, 37, 29, 1), dtype=np.uint8) if with_fg else None
    for out_hw in ((11, 9), (40, 31)):
        t = tnative.compact_source_batch_u8(imgs, fgs, out_hw, 0.45, bg, mask_images)
        j = jnative.compact_source_batch_u8(imgs, fgs, out_hw, 0.45, bg, mask_images)
        np.testing.assert_array_equal(t[0], j[0])
        assert (t[1] is None) == (j[1] is None) == (not with_fg)
        if with_fg:
            np.testing.assert_array_equal(t[1], j[1])


@pytest.mark.parametrize("host_resize", ["native", "exact"])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_source_compactor_matches_jax(host_resize, dtype):
    f = _frames(1, 6, 27, 33)
    if dtype == "float32":
        for k in ("image_rgb", "fg_probability", "mask_crop"):
            f[k] = f[k].astype(np.float32) / 255.0
    t = SourceCompactor(**KW, host_resize=host_resize)(_port(f))
    j = JSourceCompactor(**KW, host_resize=host_resize)(_jax(f))
    assert t.src_image_rgb.shape == (4, 13, 16, 3) and t.src_image_rgb.dtype == torch.uint8
    assert t.image_rgb.shape[0] == 2 and t.camera.batch_size == 6
    if host_resize == "native":
        _assert_same_batch(t, j)
        return
    for k in ("src_image_rgb", "src_fg_probability", "src_mask_crop"):
        diff = np.abs(getattr(t, k).numpy().astype(int) - np.asarray(getattr(j, k)).astype(int))
        assert diff.max() <= 1, k


def test_split_table_matches_jax():
    for n_train in (0, 1, 3, 6):
        t, j = SourceCompactor(**{**KW, "n_train_target_views": n_train}), JSourceCompactor(
            **{**KW, "n_train_target_views": n_train})
        assert [t.n_targets(b) for b in range(1, 40)] == [j.n_targets(b) for b in range(1, 40)]
    # JAX's table (tests/test_compact_sources.py:138-153)
    t3 = SourceCompactor(**{**KW, "n_train_target_views": 3})
    assert [t3.n_targets(b) for b in (33, 4, 3, 2, 1)] == [3, 3, 1, 1, 1]
    assert SourceCompactor(**{**KW, "n_train_target_views": 0}).n_targets(5) == 1
    with pytest.raises(ValueError):
        SourceCompactor(**KW, host_resize="bicubic")


def test_no_op_cases_and_drop_depth():
    f = _frames(2, 4, 16, 16)
    batch = _port(f)
    comp = SourceCompactor(**KW)
    one = batch[torch.tensor([0])]
    assert comp(one) is one  # a single frame has no sources
    # 2 frames with 2 target views: the split falls back to 1 target, 1 source
    assert comp(batch[torch.tensor([0, 1])]).src_image_rgb.shape[0] == 1
    no_img = FrameData(batch.camera)
    assert comp(no_img) is no_img
    compact = comp(batch)
    assert comp(compact) is compact  # compact already
    assert compact.depth_map is not None
    assert SourceCompactor(**KW, drop_depth=True)(batch).depth_map is None
    with pytest.raises(ValueError, match="compact batch"):
        compact[torch.tensor([0])]


def test_compact_frame_data_moves_and_stacks():
    compact = SourceCompactor(**KW)(_port(_frames(3, 5, 12, 10)))
    moved = compact.to("cpu")
    assert torch.equal(moved.src_image_rgb, compact.src_image_rgb)
    stacked = FrameData.stack_steps([compact, compact])
    assert stacked.src_fg_probability.shape == (2, *compact.src_fg_probability.shape)
    assert torch.equal(stacked.step(1).src_mask_crop, compact.src_mask_crop)


def test_compact_scene_sampler_matches_jax_and_the_transform():
    scenes = [_frames(10, 6, 21, 19), _frames(11, 5, 21, 19), _frames(12, 7, 21, 19)]
    tds, jds = SceneDataset([_port(f) for f in scenes]), JSceneDataset([_jax(f) for f in scenes])
    comp, jcomp = SourceCompactor(**KW), JSourceCompactor(**KW)
    sampler = CompactSceneSampler(tds, comp, max_cached_scenes=2)
    jsampler = JCompactSceneSampler(jds, jcomp, max_cached_scenes=2)
    for k, B in [(0, 5), (1, 4), (2, 5), (3, 2), (4, 1), (5, 9), (0, 5)]:
        t = sampler.sample_batch(np.random.RandomState(k), B)
        _assert_same_batch(t, jsampler.sample_batch(np.random.RandomState(k), B))
        _assert_same_batch(comp(tds.sample_batch(np.random.RandomState(k), B)), jsampler.sample_batch(
            np.random.RandomState(k), B))
    # the LRU holds 2 scenes; the (0, 5) repeat and scenes seen last hit it
    assert len(sampler._cache) == 2 and sampler.misses > 0 and sampler.hits > 0
    assert sampler.hits + sampler.misses == 6  # the B = 1 batch compacts nothing

    calls = []

    class Lazy(SceneDataset):
        def get_scene(self, i):
            calls.append(i)
            return self.scenes[i]

    out = CompactSceneSampler(Lazy([_port(scenes[0])]), comp).sample_batch(np.random.RandomState(0), 5)
    assert calls == [0] and out.src_image_rgb.dtype == torch.uint8 and out.image_rgb.shape[0] == 2


@pytest.fixture(scope="module")
def toy():
    """The goldens' toy model with the golden's weights on both sides, and
    its 5-frame batch compacted by both packages' "native" compactors."""
    sd = {k[4:]: GOLD[k] for k in GOLD.files if k.startswith("sd::")}
    jm = j_toy_model()
    jcams = JCameras(*(jnp.asarray(GOLD[k]) for k in ("cam_R", "cam_T", "cam_focal", "cam_pp")))
    base = jax.jit(lambda key: jm.init(key, camera=jcams, image_rgb=jnp.asarray(GOLD["image_rgb"]),
                                       fg_probability=jnp.asarray(GOLD["fg_probability"]),
                                       mask_crop=jnp.asarray(GOLD["mask_crop"]), training=False,
                                       rng=None))(jax.random.PRNGKey(0))
    variables = convert_holo_model_state_dict(
        sd, base, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions=(2,), dnet_num_layers=4,
        rnet_num_layers=1, resnet_layers=(2, 2, 2, 2), resnet_stages=(1,))
    f = {"image_rgb": GOLD["image_rgb"], "fg_probability": GOLD["fg_probability"], "mask_crop": GOLD["mask_crop"],
         "R": GOLD["cam_R"], "T": GOLD["cam_T"], "focal_length": GOLD["cam_focal"],
         "principal_point": GOLD["cam_pp"]}
    tb = FrameData(PerspectiveCameras(*(torch.from_numpy(f[k]) for k in CAMS)),
                   **{k: torch.from_numpy(f[k]) for k in ("image_rgb", "fg_probability", "mask_crop")})
    jb = JFrameData(camera=jcams, **{k: jnp.asarray(f[k]) for k in ("image_rgb", "fg_probability", "mask_crop")})
    tm = _golden_model()
    tcb = SourceCompactor.from_model(tm)(tb)
    jcb = JSourceCompactor.from_model(jm)(jax.tree.map(np.asarray, jb))
    _assert_same_batch(tcb, jcb)
    return dict(jm=jm, variables=variables, tm=tm, tcb=tcb, jcb=jcb)


def test_compact_pool_features_matches_jax(toy):
    tcb, jcb, jm = toy["tcb"], toy["jcb"], toy["jm"]
    from holo_diffusion_tpu.models.holo_model import HoloDiffusionModel as JModel

    n_t = tcb.image_rgb.shape[0]
    j = jax.jit(lambda v: jm.apply(v, jcb.src_image_rgb, jcb.camera[n_t:], jcb.src_fg_probability,
                                   jcb.src_mask_crop, True, method=JModel.pool_features))(toy["variables"])
    with torch.no_grad():
        t = toy["tm"].pool_features(tcb.src_image_rgb, tcb.camera[n_t:], tcb.src_fg_probability,
                                    tcb.src_mask_crop, prerescaled=True)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=FWD_TOL)


def test_compact_training_forward_matches_jax(toy):
    """The whole compact training forward (pool, two-pass denoise, mask
    render, objective) with JAX's key and the port's draws derived from it."""
    tcb, jcb, jm = toy["tcb"], toy["jcb"], toy["jm"]
    rng = jax.random.PRNGKey(127)
    timesteps = jnp.asarray([400, 90])
    j = jax.jit(lambda v: jm.apply(
        v, camera=jcb.camera, image_rgb=jcb.image_rgb, fg_probability=jcb.fg_probability,
        mask_crop=jcb.mask_crop, src_image_rgb=jcb.src_image_rgb, src_fg_probability=jcb.src_fg_probability,
        src_mask_crop=jcb.src_mask_crop, training=True, rng=rng, timesteps=timesteps))(toy["variables"])
    draws = {"timesteps": np.asarray(timesteps), **_model_draws(rng)}
    with torch.no_grad():
        t = toy["tm"](camera=tcb.camera, image_rgb=tcb.image_rgb, fg_probability=tcb.fg_probability,
                      mask_crop=tcb.mask_crop, src_image_rgb=tcb.src_image_rgb,
                      src_fg_probability=tcb.src_fg_probability, src_mask_crop=tcb.src_mask_crop,
                      training=True, draws=draws)
    np.testing.assert_allclose(t["voxel_features"].numpy(), np.asarray(j["voxel_features"]), atol=FWD_TOL)
    for k in ("objective", "loss_rgb_mse", "loss_prev_stage_rgb_mse"):
        np.testing.assert_allclose(float(t[k]), float(j[k]), atol=FWD_TOL, err_msg=k)


# tests/test_compact_sources.py's TINY model in the port's arguments
TINY = dict(resol=8, volume_extent=3.0, feature_size=32, num_passes=2, n_train_target_views=2,
            n_pts_per_ray_training=16, n_pts_per_ray_fine_training=8, n_pts_per_ray_evaluation=16,
            n_pts_per_ray_fine_evaluation=8, n_rays_per_image=64, render_image_height=16, render_image_width=16,
            scene_extent=1.2, net_3d_enabled=False, diffusion_enabled=False,
            image_feature_extractor_args=dict(name_arch="resnet18", stages=(1, 2), proj_dim=8, image_rescale=0.5),
            view_pooler_args=dict(aggregator_class_type="AngleWeightedReductionFeatureAggregator"),
            render_mlp_args=dict(dnet_hidden_dim=32, rnet_hidden_dim=16))


@pytest.fixture(scope="module")
def tiny():
    model = init_weights(HoloDiffusionModel(**TINY), seed=0)
    return model, make_synthetic_scene(n_views=6, image_size=24, device="cpu")


def _forward(model, b, seed=2):
    with torch.no_grad():
        return model(camera=b.camera, image_rgb=b.image_rgb, fg_probability=b.fg_probability,
                     mask_crop=b.mask_crop, depth_map=b.depth_map, src_image_rgb=b.src_image_rgb,
                     src_fg_probability=b.src_fg_probability, src_mask_crop=b.src_mask_crop, training=True,
                     draws=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("host_resize", ["exact", "native"])
def test_compact_forward_is_close_to_full(tiny, host_resize):
    """JAX's bounds for its own compact approximation: the pooled grid
    within 0.3 (max) and 0.02 (mean), the objective within 10 %."""
    model, scene = tiny
    full = _forward(model, scene)
    cb = SourceCompactor.from_model(model, host_resize=host_resize)(scene)
    assert cb.image_rgb.shape[0] == 2 and cb.src_image_rgb.shape == (4, 12, 12, 3)
    out = _forward(model, cb)
    d = (full["voxel_features"] - out["voxel_features"]).abs()
    assert float(d.max()) < 0.3 and float(d.mean()) < 0.02
    assert abs(float(full["objective"]) - float(out["objective"])) < 0.1 * (abs(float(full["objective"])) + 1e-3)


def test_extractor_skips_its_resize_for_prerescaled_images(tiny):
    """The feature branch fed images resized beforehand with
    `rescale_done` is the branch that resizes them itself."""
    from holo_diffusion_torch.ops.image import resize_image

    ex = tiny[0].image_feature_extractor
    img, fg = tiny[1].image_rgb[:3], tiny[1].fg_probability[:3]
    with torch.no_grad():
        full = ex(img, fg)
        comp = ex(resize_image(img, 12, 12), resize_image(fg, 12, 12), rescale_done=True)
    for k in ("res_layer_1", "res_layer_2"):
        torch.testing.assert_close(comp[k], full[k], atol=1e-5, rtol=0)
    assert comp["images"].shape == (3, 12, 12, 3) and full["images"].shape == (3, 24, 24, 3)


def test_compact_train_step_moves_the_parameters(tiny):
    model, scene = tiny
    model = init_weights(HoloDiffusionModel(**TINY), seed=1)
    opt = make_optimizer(model.named_parameters(), lr=1e-3)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, metrics = make_train_step(model, opt)(TrainState.create(model, opt),
                                                 SourceCompactor.from_model(model)(scene),
                                                 torch.Generator().manual_seed(3))
    assert np.isfinite(float(metrics["objective"])) and state.step == 1
    moved = [n for n, p in model.named_parameters() if not torch.equal(p, before[n])]
    assert any(n.startswith("image_feature_extractor.") for n in moved)
    assert any(n.startswith("implicit_function.") for n in moved)


@pytest.mark.parametrize("extra", [
    [],  # the scene cache, compact validation batches through the eval step
    ["compact_scene_cache=false"],  # the transform on each batch
    [MODEL + "chunk_size_grid=64", "compact_host_resize=exact"],  # chunked compact validation
])
def test_compact_experiment_runs(tmp_path, extra):
    cfg = tiny_cfg(tmp_path / "exp", ["compact_sources=true", "disable_validation=false",
                                      "training_loop_ImplicitronTrainingLoop_args.visualize_interval=0", *extra])
    exp = Experiment(cfg, device="cpu")
    state, stats = exp.run(max_epochs=1)
    assert state.step == 2 and [e["epoch"] for e in stats.history] == [0]
    assert all(np.isfinite(v) for e in stats.history for s in ("train", "val") for v in e[s].values())
    if "compact_scene_cache=false" in extra:
        assert exp._val_data is None
    else:
        assert isinstance(exp._val_data, CompactSceneSampler) and exp._val_data.misses >= 1
    # the tiny objective weighs no depth: the compactor drops the target depths
    assert exp.compactor.drop_depth
