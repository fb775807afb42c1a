"""The training loop's host side in the port against the JAX package, on the
CPU: `Stats`, the loop's and the data source's config translators, the key
audit, the synthetic data source and its loaders (same seeds, same frames),
checkpoint names, purge, resume and IO errors, a bitwise save/restore round
trip, the config keys of features the port lacks (each raises, naming its
ROADMAP item), and the package data that the CUDA build needs."""
import copy
import fnmatch
import glob
import logging
import os
import re
import sys
import tomllib

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from torch_tiny_config import LOOP, MODEL, tiny_cfg  # noqa: E402

import holo_diffusion_torch.config.config as tcfg  # noqa: E402
import holo_diffusion_tpu.config.config as jcfg  # noqa: E402
from holo_diffusion_torch.data import source as tsource  # noqa: E402
from holo_diffusion_torch.experiment import Experiment  # noqa: E402
from holo_diffusion_torch.train import checkpoint as tckpt  # noqa: E402
from holo_diffusion_torch.train.stats import Stats  # noqa: E402
from holo_diffusion_tpu.data import source as jsource  # noqa: E402
from holo_diffusion_tpu.train.stats import Stats as JStats  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ["base", "hydrant", "synthetic_debug"]
DS = "data_source_ImplicitronDataSource_args."


def _updates(seed):
    rs = np.random.RandomState(seed)
    return [{"objective": float(rs.rand()), "loss_rgb_mse": float(rs.rand()), "loss_rgb_psnr": float(10 * rs.rand()),
             "loss_mask_bce": float(rs.rand()), "images_render": np.zeros((2, 2)), "note": "text"}
            for _ in range(5)]


def _no_clock(d):
    return {k: v for k, v in d.items() if k != "sec/it"}


@pytest.mark.parametrize("log_vars", [None, ["objective", "loss_rgb_psnr"]], ids=["all", "log_vars"])
def test_stats_match_jax(log_vars, tmp_path):
    """Two epochs of train and val updates: the averages, the history and
    the status lines (without the clock's sec/it) equal JAX's; save/load
    and load_or_new of a corrupt file behave as JAX's."""
    stats, jstats = Stats(log_vars), JStats(log_vars)
    for epoch in range(2):
        for st in (stats, jstats):
            st.new_epoch()
        for i, u in enumerate(_updates(epoch)):
            for st in (stats, jstats):
                st.update(u, "train" if i < 3 else "val")
        for stat_set in ("train", "val"):
            assert _no_clock(stats.averages(stat_set)) == _no_clock(jstats.averages(stat_set))
            assert "sec/it" in stats.averages(stat_set)
            line = re.sub(r" sec/it=\S+", "", stats.status_line(stat_set))
            assert line == re.sub(r" sec/it=\S+", "", jstats.status_line(stat_set))
        for st in (stats, jstats):
            st.finalize_epoch()
    hist = [{k: _no_clock(v) if isinstance(v, dict) else v for k, v in e.items()} for e in stats.history]
    jhist = [{k: _no_clock(v) if isinstance(v, dict) else v for k, v in e.items()} for e in jstats.history]
    assert hist == jhist and len(hist) == 2
    stats.save(str(tmp_path / "p.json"))
    jstats.save(str(tmp_path / "j.json"))
    back, jback = Stats.load(str(tmp_path / "p.json")), JStats.load(str(tmp_path / "j.json"))
    assert (back.epoch, back.log_vars) == (jback.epoch, jback.log_vars) == (1, log_vars)
    assert back.history == stats.history and jback.history == jstats.history
    (tmp_path / "bad.json").write_text("{not json")
    fresh = Stats.load_or_new(str(tmp_path / "bad.json"), log_vars=log_vars)
    assert (fresh.epoch, fresh.history, fresh.log_vars) == (-1, [], log_vars)


@pytest.mark.parametrize("config", CONFIGS)
def test_loop_and_data_args_match_jax(config):
    cfg = tcfg.load_config(config)
    jc = jcfg.load_config(config)
    assert tcfg.training_loop_args_from_config(cfg) == jcfg.training_loop_args_from_config(jc)
    assert tcfg.data_source_args_from_config(cfg) == jcfg.data_source_args_from_config(jc)


@pytest.mark.parametrize("config", CONFIGS)
def test_audit_flags_the_same_keys_as_jax(config):
    """A config with an unknown root key, an unknown nested key, a
    recognised-but-ignored reference key and an inert unselected-class
    subtree: both audits report the same keys (and none on the plain
    config)."""
    extra = {
        "mystery_root": 1,
        "visdom_env": "x",
        "training_loop_ImplicitronTrainingLoop_args": {"mystery_loop_knob": 3},
        "model_factory_ImplicitronModelFactory_args": {"model_HoloDiffusionModel_args": {
            "raysampler_AdaptiveRaySampler_args": {"mystery_ray_knob": 2}}},
        "data_source_ImplicitronDataSource_args": {"dataset_map_provider_OtherProvider_args": {"a": 1}},
    }
    for base in (tcfg.load_config(config), jcfg.load_config(config)):
        assert tcfg.audit_unconsumed_keys(base, warn=lambda m: None) == []
    got = tcfg.audit_unconsumed_keys(tcfg._deep_update(tcfg.load_config(config), copy.deepcopy(extra)),
                                     warn=lambda m: None)
    want = jcfg.audit_unconsumed_keys(jcfg._deep_update(jcfg.load_config(config), copy.deepcopy(extra)),
                                      warn=lambda m: None)
    assert got == want
    assert {"mystery_root", "visdom_env", "training_loop_ImplicitronTrainingLoop_args.mystery_loop_knob"} <= set(got)


def _assert_same_frames(t, j):
    """Images and depths to 2e-5: the two packages' cameras agree to an ulp
    (4.8e-7 at |T| = 4), and the ray-sphere hit point amplifies that up to
    ~2e-5 near the silhouette."""
    np.testing.assert_allclose(t.image_rgb.numpy(), np.asarray(j.image_rgb), atol=2e-5)
    np.testing.assert_allclose(t.depth_map.numpy(), np.asarray(j.depth_map), atol=5e-5)
    for name in ("fg_probability", "mask_crop", "sequence_id"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    np.testing.assert_allclose(t.camera.R.numpy(), np.asarray(j.camera.R), atol=1e-6)
    np.testing.assert_allclose(t.camera.T.numpy(), np.asarray(j.camera.T), atol=1e-5)


def _frame_ids(batch, dataset):
    """(scene, view) of each frame of `batch`, found by exact image match in
    the dataset the batch was drawn from."""
    imgs = np.stack([np.asarray(s.image_rgb) for s in dataset.scenes])  # (S, V, H, W, 3)
    out = []
    for frame in np.asarray(batch.image_rgb):
        hits = np.argwhere((imgs == frame).all(axis=(2, 3, 4)))
        assert len(hits) == 1
        out.append(tuple(int(i) for i in hits[0]))
    return out


@pytest.mark.parametrize("batch_size", [3, 6], ids=["subset", "with_replacement"])
def test_loaders_give_jax_frames(batch_size):
    """Same seed: `epoch_loader` and `WholeDatasetLoader` draw the JAX
    package's (scene, view) sequence exactly, and the frames agree."""
    kw = dict(n_scenes=3, n_views_per_scene=4, image_size=16, seed=5)
    tp = tsource.SyntheticDataProvider(device="cpu", **kw)
    jp = jsource.SyntheticDataProvider(**kw)
    assert (len(tp.train), len(tp.val)) == (len(jp.train), len(jp.val)) == (3, 1)
    for t, j in zip(tp.train.scenes + tp.val.scenes, jp.train.scenes + jp.val.scenes):
        _assert_same_frames(t, j)
    pairs = list(zip(tsource.epoch_loader(tp.train, batch_size, 4, 9),
                     jsource.epoch_loader(jp.train, batch_size, 4, 9)))
    pairs += list(zip(tsource.WholeDatasetLoader(tp.train, batch_size, 2, 3),
                      jsource.WholeDatasetLoader(jp.train, batch_size, 2, 3)))
    assert len(pairs) == 6
    drawn = set()
    for t, j in pairs:
        assert t.batch_size == batch_size
        ids = _frame_ids(t, tp.train)
        assert ids == _frame_ids(j, jp.train)
        assert len({s for s, _ in ids}) == 1  # one scene a batch
        drawn |= set(ids)
        _assert_same_frames(t, j)
    assert len({s for s, _ in drawn}) > 1


def test_async_loader_transfers_in_order_and_reraises():
    seen = []

    def transfer(x):
        seen.append(x)
        return x * 10

    assert list(tsource.AsyncLoader(iter(range(7)), prefetch=2, transfer=transfer)) == [10 * i for i in range(7)]
    assert seen == list(range(7))

    def failing():
        yield 1
        raise KeyError("boom")

    it = iter(tsource.AsyncLoader(failing()))
    assert next(it) == 1
    with pytest.raises(KeyError, match="boom"):
        next(it)


@pytest.fixture()
def tiny_exp(tmp_path):
    return Experiment(tiny_cfg(tmp_path / "exp"), device="cpu")


def _train_two_steps(exp, state):
    from holo_diffusion_torch.parallel.train_step import make_train_step

    step = make_train_step(exp.model, state.optimizer)
    gen = torch.Generator().manual_seed(0)
    for batch in tsource.epoch_loader(exp.data.train, exp.batch_size, 2, 0):
        state, _ = step(state, batch, gen)
    return state


def test_checkpoint_names_list_and_purge(tiny_exp, tmp_path):
    exp_dir = str(tmp_path / "ck")
    assert tckpt.checkpoint_dir(exp_dir, 7) == os.path.join(exp_dir, "model_epoch_00000007")
    assert tckpt.list_checkpoints(exp_dir) == [] and tckpt.find_last_checkpoint(exp_dir) is None
    state = tiny_exp.init_state()
    for epoch in (0, 1, 2):
        tckpt.save_checkpoint(exp_dir, epoch, state, Stats(), purge=2)
    assert [e for e, _ in tckpt.list_checkpoints(exp_dir)] == [1, 2]
    os.makedirs(os.path.join(exp_dir, "model_epoch_5"))  # not 8 digits: not a checkpoint
    tckpt.save_checkpoint(exp_dir, 3, state, purge=0)
    assert [e for e, _ in tckpt.list_checkpoints(exp_dir)] == [1, 2, 3]
    assert tckpt.find_last_checkpoint(exp_dir) == (3, tckpt.checkpoint_dir(exp_dir, 3))
    assert os.path.exists(os.path.join(exp_dir, "train_stats.json"))
    assert tckpt.restore_checkpoint(exp_dir, state, epoch=9) == (None, -1)
    assert tckpt.restore_checkpoint(exp_dir, state, epoch=2)[1] == 2
    assert tckpt.restore_checkpoint(str(tmp_path / "none"), state) == (None, -1)


def test_checkpoint_io_error_warns_and_does_not_raise(tiny_exp, tmp_path, caplog):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    state = tiny_exp.init_state()
    with caplog.at_level(logging.WARNING, logger="holo_diffusion_torch.train.checkpoint"):
        tckpt.save_checkpoint(str(blocker / "exp"), 0, state, Stats())
    assert any("checkpoint save failed" in r.getMessage() for r in caplog.records)


def test_force_resume_without_checkpoint_raises(tmp_path):
    cfg = tiny_cfg(tmp_path / "exp", ["model_factory_ImplicitronModelFactory_args.force_resume=true"])
    with pytest.raises(FileNotFoundError, match="force_resume"):
        Experiment(cfg, device="cpu").run(max_epochs=1)


def test_save_restore_is_bitwise(tiny_exp, tmp_path):
    """After two Adam steps: parameters, BN statistics, both Adam moments,
    the step counts and the LR schedule's position come back bitwise into a
    freshly initialised state."""
    exp_dir = str(tmp_path / "rt")
    state = _train_two_steps(tiny_exp, tiny_exp.init_state())
    assert state.step == 2 and state.optimizer.steps == 2
    tckpt.save_checkpoint(exp_dir, 4, state)
    saved_model = {k: v.clone() for k, v in state.model.state_dict().items()}
    saved_opt = copy.deepcopy(state.optimizer.optimizer.state_dict())
    lr = [g["lr"] for g in state.optimizer.optimizer.param_groups]

    other = Experiment(tiny_cfg(tmp_path / "other"), device="cpu")
    fresh = other.init_state()
    fresh.model.state_dict()[next(iter(saved_model))].add_(1.0)
    restored, epoch = tckpt.restore_checkpoint(exp_dir, fresh)
    assert epoch == 4 and restored is fresh
    assert restored.step == 2 and restored.optimizer.steps == 2
    for k, v in restored.model.state_dict().items():
        assert torch.equal(v, saved_model[k]), k
    got = restored.optimizer.optimizer.state_dict()
    assert set(got["state"]) == set(saved_opt["state"]) and got["state"]
    for i, s in saved_opt["state"].items():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(got["state"][i][name], s[name]), (i, name)
            assert got["state"][i][name].device == s[name].device
    assert [g["lr"] for g in restored.optimizer.optimizer.param_groups] == lr


def test_lr_milestones_count_epochs(tmp_path):
    """A MultiStepLR milestone of 1 epoch fires after the epoch's 2 steps,
    not after 1 step: the Experiment gives the schedule its steps per
    epoch."""
    exp = Experiment(tiny_cfg(tmp_path / "exp", [
        "optimizer_factory_ImplicitronOptimizerFactory_args.multistep_lr_milestones=[1]",
        "optimizer_factory_ImplicitronOptimizerFactory_args.gamma=0.5"]), device="cpu")
    state = exp.init_state()
    lr0 = exp.opt_args["optimizer"]["lr"]
    lrs = [state.optimizer.optimizer.param_groups[0]["lr"]]
    for _ in range(2):
        state.optimizer.step()
        lrs.append(state.optimizer.optimizer.param_groups[0]["lr"])
    assert exp.n_batches_train == 2
    assert lrs == [lr0, lr0, lr0 * 0.5]


_STRATIFIED_EVAL = MODEL + "raysampler_AdaptiveRaySampler_args.stratified_point_sampling_evaluation=true"
_UNPORTED = {
    # EMA, the loss-aware sampler and steps per dispatch are ported
    # (tests/test_torch_train_full.py); asked for beside compact sources,
    # they do not hide its refusal
    "ema": (["ema_rate=0.5", "compact_sources=true"], 3),
    "loss_second_moment": ([MODEL + "diffusion_args.schedule_sampler_type=loss-second-moment",
                            "compact_sources=true"], 3),
    "steps_per_dispatch": (["steps_per_dispatch=2", "compact_sources=true"], 3),
    # the CO3D provider itself is ported (tests/test_torch_co3d.py); its
    # compact-source path is not
    "co3d": ([DS + "dataset_map_provider_class_type=JsonIndexDatasetMapProviderV2", "compact_sources=true"], 3),
    "compact_sources": (["compact_sources=true"], 3),
    "packed_transfer": (["packed_transfer=true"], 3),
    # evaluation and its stratified sampling are ported
    # (tests/test_torch_evaluation.py, tests/test_torch_eval_sampling.py);
    # asked for beside compact sources, they do not hide its refusal
    "eval_only": ([LOOP + "eval_only=true", _STRATIFIED_EVAL, "compact_sources=true"], 3),
    "test_interval": (["disable_testing=false", LOOP + "test_interval=1", _STRATIFIED_EVAL,
                       "compact_sources=true"], 3),
    "test_when_finished": (["disable_testing=false", LOOP + "test_when_finished=true", _STRATIFIED_EVAL,
                            "compact_sources=true"], 3),
    "profile": ([LOOP + "profile=true"], 6),
    "visualize": (["disable_validation=false", LOOP + "visualize_interval=1"], 6),
}


@pytest.mark.parametrize("case", list(_UNPORTED))
def test_unported_features_raise(case, tmp_path):
    overrides, item = _UNPORTED[case]
    with pytest.raises(NotImplementedError, match=rf"ROADMAP.md §1 item {item}\b"):
        Experiment(tiny_cfg(tmp_path / "exp", overrides), device="cpu")


def test_ported_settings_of_those_keys_do_not_raise(tmp_path):
    """The same keys at the values the port runs: validation without
    visualizations, test settings while testing is disabled; then the
    features ported since: EMA, the loss-aware sampler, steps per dispatch,
    eval_only, test evaluation and stratified evaluation sampling."""
    Experiment(tiny_cfg(tmp_path / "exp", [
        "disable_validation=false", LOOP + "visualize_interval=0", LOOP + "test_interval=1",
        "ema_rate=0.0", "steps_per_dispatch=1", "compact_sources=false"]), device="cpu")
    exp = Experiment(tiny_cfg(tmp_path / "exp2", [
        "ema_rate=0.5", MODEL + "diffusion_args.schedule_sampler_type=loss-second-moment", "steps_per_dispatch=2",
        LOOP + "eval_only=true", "disable_testing=false", LOOP + "test_interval=1",
        LOOP + "test_when_finished=true", _STRATIFIED_EVAL]), device="cpu")
    assert (exp.ema_rate, exp.schedule_sampler, exp.steps_per_dispatch) == (0.5, "loss-second-moment", 2)


def test_load_experiment_rejects_ema(tmp_path):
    """use_ema on a run trained without EMA raises (the JAX package's
    checkpoint_utils.py:47-53)."""
    from holo_diffusion_torch.utils.checkpoint_utils import load_experiment

    Experiment(tiny_cfg(tmp_path / "exp"), device="cpu").run(max_epochs=1)
    with pytest.raises(ValueError, match="trained without EMA"):
        load_experiment(str(tmp_path / "exp"), use_ema=True, device="cpu")


def test_package_data_ships_every_included_header():
    """Every `#include "..."` of csrc/*.cu names a file in the package, and
    the package-data globs of pyproject.toml match it."""
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"]["holo_diffusion_torch"]
    pkg = os.path.join(REPO, "holo_diffusion_torch")
    sources = sorted(glob.glob(os.path.join(pkg, "csrc", "*.cu")))
    assert sources
    included = set()
    for src in sources:
        included |= set(re.findall(r'^\s*#include\s+"([^"]+)"', open(src).read(), flags=re.M))
    assert included >= {"sample_gather.cuh", "tf32_mma.cuh"}
    for rel in [os.path.relpath(s, pkg) for s in sources] + [f"csrc/{n}" for n in sorted(included)]:
        assert os.path.exists(os.path.join(pkg, rel)), rel
        assert any(fnmatch.fnmatch(rel, g) for g in globs), f"{rel} is not in package-data {globs}"
