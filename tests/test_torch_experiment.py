"""The training-loop slice of the port as a whole, on the CPU, on the tiny
synthetic experiment of tests/test_experiment.py (`_tiny_synthetic_cfg`):

  (a) the validation epoch's averages against the JAX Experiment's, at the
      JAX Experiment's initial weights carried across, unchunked and
      chunked, at 16 px and at 12 px renders of 16 px frames (the chunked
      path's antialiased resize of the target): 1e-4 relative;
  (b) `Experiment.run` adds nothing to the steps: one epoch equals
      `make_train_step` called by hand on `epoch_loader`'s batches, bitwise;
  (c) resume: two epochs straight equal one epoch, then a new Experiment
      that resumes and runs one more, bitwise, stats included;
  (d) the port learns: an overfit run raises the train PSNR;
  (e) the train CLI, then sampling from its exp_dir.
"""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import copy
import os
import sys

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

sys.path.insert(0, os.path.dirname(__file__))

from test_experiment import _tiny_synthetic_cfg  # noqa: E402
from torch_tiny_config import LOOP, MODEL, TINY_OVERRIDES, tiny_cfg  # noqa: E402

from holo_diffusion_torch import cli  # noqa: E402
from holo_diffusion_torch.data.source import epoch_loader  # noqa: E402
from holo_diffusion_torch.experiment import Experiment  # noqa: E402
from holo_diffusion_torch.parallel.train_step import make_eval_step, make_train_step  # noqa: E402
from holo_diffusion_torch.train.checkpoint import list_checkpoints  # noqa: E402
from holo_diffusion_torch.train.stats import Stats  # noqa: E402
from holo_diffusion_torch.utils.checkpoint_utils import load_experiment  # noqa: E402
from holo_diffusion_torch.weights import state_dict_from_jax  # noqa: E402
from holo_diffusion_tpu.experiment import Experiment as JExperiment  # noqa: E402
from holo_diffusion_tpu.parallel import make_eval_step as j_make_eval_step  # noqa: E402
from holo_diffusion_tpu.train.stats import Stats as JStats  # noqa: E402

VAL_CASES = {
    "unchunked": {},
    "chunked": {"chunk_size_grid": 256},
    "unchunked_12px": {"render_image_height": 12, "render_image_width": 12},
    "chunked_12px": {"chunk_size_grid": 256, "render_image_height": 12, "render_image_width": 12},
}
VAL_RTOL = 1e-4
VALIDATE = ["disable_validation=false", LOOP + "visualize_interval=0"]


@pytest.fixture(scope="module")
def jax_val(tmp_path_factory):
    """The JAX Experiment's initial weights as the port's state_dict, and
    its val averages in each case (one JAX init for all of them)."""
    tmp = tmp_path_factory.mktemp("jax_val")
    cfg = _tiny_synthetic_cfg(tmp)
    exp = JExperiment(cfg)
    state = exp.init_state()
    sd = state_dict_from_jax(flatten_dict(jax.device_get(state.params), sep="/"),
                             flatten_dict(jax.device_get(state.model_state["batch_stats"]), sep="/"))
    base = exp.model
    averages = {}
    for case, changes in VAL_CASES.items():
        exp.model, exp._encode_jit = base.clone(**changes), None
        stats = JStats()
        stats.new_epoch()
        exp._val_epoch(state, stats, jax.random.PRNGKey(0), j_make_eval_step(exp.model), 0)
        averages[case] = {k: v for k, v in stats.averages("val").items() if k != "sec/it"}
    return cfg, sd, averages


def test_tiny_config_is_the_jax_tests(tmp_path):
    assert tiny_cfg(f"{tmp_path}/exp") == _tiny_synthetic_cfg(tmp_path)


@pytest.mark.parametrize("case", list(VAL_CASES))
def test_val_epoch_matches_jax(case, jax_val, tmp_path):
    cfg, sd, averages = jax_val
    cfg = copy.deepcopy(cfg)
    cfg["model_factory_ImplicitronModelFactory_args"]["model_HoloDiffusionModel_args"].update(VAL_CASES[case])
    cfg["exp_dir"] = str(tmp_path / "exp")
    exp = Experiment(cfg, device="cpu")
    state = exp.init_state()
    state.model.load_state_dict(sd, strict=True)
    state.model.eval()
    stats = Stats()
    stats.new_epoch()
    out = exp._val_epoch(state, stats, make_eval_step(state.model), 0)
    got = {k: v for k, v in stats.averages("val").items() if k != "sec/it"}
    want = averages[case]
    assert set(got) == set(want)
    keys = {"loss_rgb_mse", "loss_rgb_psnr"} | ({"objective"} if "unchunked" in case else {"loss_rgb_psnr_fg"})
    assert keys <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=VAL_RTOL, err_msg=k)
    h = VAL_CASES[case].get("render_image_height", 16)
    assert tuple(out["images_render"].shape) == (1, h, h, 3)


def _params_and_moments(state):
    sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    opt = state.optimizer.optimizer.state_dict()["state"]
    return sd, {i: {n: t.clone() for n, t in s.items()} for i, s in opt.items()}


def _assert_bitwise(a, b):
    (sa, oa), (sb, ob) = a, b
    assert set(sa) == set(sb) and set(oa) == set(ob) and oa
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for i in oa:
        for n in oa[i]:
            assert torch.equal(oa[i][n], ob[i][n]), (i, n)


def test_run_equals_hand_called_steps(tmp_path):
    exp = Experiment(tiny_cfg(tmp_path / "run"), device="cpu")
    state, stats = exp.run(max_epochs=1)
    assert state.step == exp.n_batches_train == 2 and stats.epoch == 0

    ref = Experiment(tiny_cfg(tmp_path / "hand"), device="cpu")
    hand = ref.init_state()
    step = make_train_step(ref.model, hand.optimizer)
    gen = torch.Generator().manual_seed(ref.seed + 0)
    for batch in epoch_loader(ref.data.train, ref.batch_size, ref.n_batches_train, ref.seed + 0):
        hand, _ = step(hand, batch, gen)
    _assert_bitwise(_params_and_moments(state), _params_and_moments(hand))


def test_resume_equals_uninterrupted_run(tmp_path):
    """With validation on; the stats' averages (not their clock) agree too."""
    straight, s_stats = Experiment(tiny_cfg(tmp_path / "straight", VALIDATE), device="cpu").run(max_epochs=2)
    first, _ = Experiment(tiny_cfg(tmp_path / "resumed", VALIDATE), device="cpu").run(max_epochs=1)
    assert first.step == 2
    exp = Experiment(tiny_cfg(tmp_path / "resumed", VALIDATE), device="cpu")
    resumed, r_stats = exp.run(max_epochs=2)
    assert resumed.step == straight.step == 4 and resumed.optimizer.steps == 4
    assert [e for e, _ in list_checkpoints(exp.exp_dir)] == [1]  # purge keeps 1
    _assert_bitwise(_params_and_moments(straight), _params_and_moments(resumed))

    def no_clock(history):
        return [{k: ({m: x for m, x in v.items() if m != "sec/it"} if isinstance(v, dict) else v)
                 for k, v in e.items()} for e in history]

    assert [e["epoch"] for e in r_stats.history] == [0, 1]
    assert {"train", "val"} <= set(r_stats.history[1])
    assert no_clock(r_stats.history) == no_clock(s_stats.history)


def test_overfit_run_raises_train_psnr(tmp_path):
    """One scene, one batch replayed (`whole_dataset_batch`), lr 0.001 (the
    config's 5e-5 moves too little in 8 steps): the train PSNR of the last
    of 4 epochs is at least 0.5 dB above the first's."""
    cfg = tiny_cfg(tmp_path / "fit", [
        LOOP + "whole_dataset_batch=true", LOOP + "store_checkpoints=false",
        "data_source_ImplicitronDataSource_args.dataset_map_provider_SyntheticDataProvider_args.n_scenes=1",
        "optimizer_factory_ImplicitronOptimizerFactory_args.lr=0.001"])
    _, stats = Experiment(cfg, device="cpu").run(max_epochs=4)
    psnr = [e["train"]["loss_rgb_psnr"] for e in stats.history]
    assert len(psnr) == 4 and all(np.isfinite(psnr))
    assert psnr[-1] - psnr[0] >= 0.5, psnr


def test_train_cli_then_sample_from_its_exp_dir(tmp_path):
    exp_dir = str(tmp_path / "cli")
    state, stats = cli.train_main(["--config-name", "synthetic_debug.yaml", "--device", "cpu",
                                   "--max-epochs", "1", f"exp_dir={exp_dir}", *TINY_OVERRIDES])
    assert stats.epoch == 0 and state.step == 2
    assert os.path.exists(os.path.join(exp_dir, "expconfig.yaml"))
    _, restored = load_experiment(exp_dir, device="cpu")
    for (k, a), b in zip(state.model.state_dict().items(), restored.model.state_dict().values()):
        assert torch.equal(a, b), k

    out = str(tmp_path / "samples")
    results = cli.generate_samples_main([
        f"exp_dir={exp_dir}", "device=cpu", "num_samples=1", "n_flyaround_poses=1",
        "render_size=[16,16]", "use_ddim=true", "max_iter=2", f"output_directory={out}",
        "save_voxel_features=true"])
    assert set(results) == {"sample_00000"}
    assert set(results["sample_00000"]) == {"images_render", "masks_render", "depths_render", "shaded_depth_render"}
    grid = np.load(os.path.join(out, "sample_00000", "voxel_features.npy"))
    assert grid.shape == (1, 4, 4, 4, 32) and np.isfinite(grid).all() and np.abs(grid).max() <= 1.0
    with pytest.raises(ValueError, match="not both"):
        cli.generate_samples_main([f"exp_dir={exp_dir}", "config=hydrant", "device=cpu"])
    # an exp_dir with a config and no checkpoint
    bare = tmp_path / "bare"
    bare.mkdir()
    (bare / "expconfig.yaml").write_text(open(os.path.join(exp_dir, "expconfig.yaml")).read())
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        load_experiment(str(bare), device="cpu")
