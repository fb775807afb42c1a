"""The whole training step of the port (parallel/train_step.py: the
loss-second-moment sampler, the EMA, steps per call) against the JAX
package's `make_train_step` on the goldens' toy model, on the CPU, and its
use by the loop and at inference:

  (a) two SGD steps in one call (`steps_per_call` 2) with the sampler
      warmed from a seeded loss history and `ema_rate` 0.9, every draw of
      the port derived from JAX's keys in `parallel/train_step.py`'s split
      order (per-step keys, then `rng_t` first, then the model's):
      objective, every parameter, the EMA and the sampler state after the
      call;
  (b) `importance_scale` and `ts_validity_mask` (tests/test_parallel.py:188);
  (c) K steps in one call equal K calls of one step, bitwise;
  (d) a resumed run with EMA, sampler and K 2 equals a straight one,
      bitwise, EMA and sampler state included; a checkpoint without EMA or
      sampler state (the format before them) restores where the run keeps
      neither, and raises, naming the file, where it keeps them;
  (e) `load_experiment(use_ema=True)` swaps the EMA in, and raises without;
  (f) the uniform, no-EMA, one-step path through `make_train_step` still
      gives tests/goldens/holo_backward_goldens.npz's objective and
      gradients.

Tolerances (stated in each test): the objective 1e-4 and the gradients 2e-3
of each leaf's scale, as the JAX package holds its own training step to
these goldens (tests/test_holo_grad_parity.py); an SGD update is the
gradient times the rate, so updates are held at 2e-3 of their scale too."""
import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

sys.path.insert(0, os.path.dirname(__file__))

from test_holo_forward_parity import GOLD  # noqa: E402
from test_holo_forward_parity import _model as j_toy_model  # noqa: E402
from test_torch_train_step import BGOLD, _assert_grads, _golden_draws, _golden_model, _reference_name  # noqa: E402
from torch_tiny_config import MODEL, tiny_cfg  # noqa: E402

from holo_diffusion_torch.data.frame_data import FrameData  # noqa: E402
from holo_diffusion_torch.experiment import Experiment  # noqa: E402
from holo_diffusion_torch.geometry.cameras import PerspectiveCameras  # noqa: E402
from holo_diffusion_torch.models import diffusion as gd  # noqa: E402
from holo_diffusion_torch.parallel.train_step import (  # noqa: E402
    TrainState, importance_scale, make_train_step, ts_validity_mask)
from holo_diffusion_torch.train.checkpoint import CHECKPOINT_FILE, checkpoint_dir  # noqa: E402
from holo_diffusion_torch.train.optimizer import make_optimizer  # noqa: E402
from holo_diffusion_torch.utils.checkpoint_utils import load_experiment  # noqa: E402
from holo_diffusion_torch.weights import state_dict_from_jax  # noqa: E402
from holo_diffusion_tpu.data.frame_data import FrameData as JFrameData  # noqa: E402
from holo_diffusion_tpu.geometry.cameras import PerspectiveCameras as JCameras  # noqa: E402
from holo_diffusion_tpu.models import diffusion as jgd  # noqa: E402
from holo_diffusion_tpu.parallel.train_step import TrainState as JTrainState  # noqa: E402
from holo_diffusion_tpu.parallel.train_step import make_train_step as j_make_train_step  # noqa: E402
from holo_diffusion_tpu.train.optimizer import make_optimizer as j_make_optimizer  # noqa: E402
from holo_diffusion_tpu.utils.torch_import import convert_holo_model_state_dict  # noqa: E402

OBJ_TOL = 1e-4
REL_TOL = 2e-3
LR = 0.05
EMA_RATE = 0.9
T, H = 1000, 10
LOSS_AWARE = [MODEL + "diffusion_args.schedule_sampler_type=loss-second-moment"]


def _frames(order):
    """The goldens' 5-frame batch with its frames in `order` (numpy)."""
    return {k: GOLD[k][order] for k in ("image_rgb", "fg_probability", "mask_crop", "cam_R", "cam_T",
                                        "cam_focal", "cam_pp")}


def _port_batch(f):
    return FrameData(PerspectiveCameras(*(torch.from_numpy(f[k]) for k in ("cam_R", "cam_T", "cam_focal", "cam_pp"))),
                     image_rgb=torch.from_numpy(f["image_rgb"]), fg_probability=torch.from_numpy(f["fg_probability"]),
                     mask_crop=torch.from_numpy(f["mask_crop"]))


def _jax_batch(f):
    return JFrameData(camera=JCameras(*(jnp.asarray(f[k]) for k in ("cam_R", "cam_T", "cam_focal", "cam_pp"))),
                      image_rgb=jnp.asarray(f["image_rgb"]), fg_probability=jnp.asarray(f["fg_probability"]),
                      mask_crop=jnp.asarray(f["mask_crop"]))


def _warm_history():
    """A full (T, H) loss history, uneven across timesteps."""
    rs = np.random.RandomState(21)
    return (rs.rand(T, H) * np.linspace(0.2, 2.0, T)[:, None]).astype(np.float32)


def _model_draws(rng):
    """The toy model's draws from the key it is applied with
    (holo_model.py:498-500, :232; the render key -> (rays, render), rays ->
    (pixels, lengths)), as tests/test_torch_train_step.py derives them."""
    _, rng_denoise, rng_render = jax.random.split(rng, 3)
    _, rng_n, _, rng_n2, rng_b = jax.random.split(rng_denoise, 5)
    shape = (1, 8, 8, 8, 8)
    rng_rays, _ = jax.random.split(rng_render)
    rng_pix, _ = jax.random.split(rng_rays)
    return {
        "noise": np.asarray(jax.random.normal(rng_n, shape)),
        "noise2": np.asarray(jax.random.normal(rng_n2, shape)),
        "take_boot": bool(jax.random.uniform(rng_b, ()) < 0.5),
        "ray_pixel_u": np.asarray(jax.random.uniform(rng_pix, (2, 64))),
    }


def _jax_state_dict(params):
    return {k: v.numpy() for k, v in state_dict_from_jax(flatten_dict(jax.device_get(params), sep="/")).items()}


@pytest.fixture(scope="module")
def two_steps():
    """JAX's loss-aware, EMA, K 2 step on the toy model, and the port's on
    the same weights, batches and (derived) draws."""
    jmodel = j_toy_model()
    cams0 = _jax_batch(_frames(np.arange(5))).camera
    base = jax.jit(lambda key: jmodel.init(key, camera=cams0, image_rgb=jnp.asarray(GOLD["image_rgb"]),
                                           fg_probability=jnp.asarray(GOLD["fg_probability"]),
                                           mask_crop=jnp.asarray(GOLD["mask_crop"]), training=False,
                                           rng=None))(jax.random.PRNGKey(0))
    sd = {k[4:]: GOLD[k] for k in GOLD.files if k.startswith("sd::")}
    variables = convert_holo_model_state_dict(
        sd, base, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions=(2,), dnet_num_layers=4,
        rnet_num_layers=1, resnet_layers=(2, 2, 2, 2), resnet_stages=(1,))
    hist = _warm_history()
    jsampler = jgd.LossSecondMomentState(loss_history=jnp.asarray(hist), loss_counts=jnp.full((T,), H, jnp.int32))
    tx = j_make_optimizer(breed="SGD", lr=LR, momentum=0.0)
    jstate = JTrainState.create(variables, tx, sampler_state=jsampler, ema=True)
    frames = [_frames(np.arange(5)), _frames(np.array([4, 3, 2, 1, 0]))]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *[_jax_batch(f) for f in frames])
    key = jax.random.PRNGKey(31)
    jstep = j_make_train_step(jmodel, tx, mesh=None, donate=False, steps_per_call=2,
                              schedule_sampler="loss-second-moment", ema_rate=EMA_RATE)
    jafter, jmetrics = jstep(jstate, stacked, key)

    # the port's draws, step by step: JAX splits K per-step keys; each step
    # splits rng_t first and applies the model with the rest
    tm = _golden_model()
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    opt = make_optimizer(tm.named_parameters(), breed="SGD", lr=LR, momentum=0.0)
    sampler = gd.LossSecondMomentState(torch.from_numpy(hist.copy()), torch.full((T,), H, dtype=torch.int64))
    state = TrainState.create(tm, opt, sampler_state=sampler, ema=True)
    step1 = make_train_step(tm, opt, schedule_sampler="loss-second-moment", ema_rate=EMA_RATE)
    jsched = jgd.make_named_schedule()
    draws, js = [], jsampler
    for k, rng in enumerate(jax.random.split(key, 2)):
        rng, rng_t = jax.random.split(rng)
        ts, _ = jgd.loss_aware_sample_timesteps(jsched, js, 2, rng_t)
        draws.append({"timesteps": np.asarray(ts), **_model_draws(rng)})
        if k == 0:
            # the sampler's state after step 0 holds step 0's objective: a
            # copy of the port takes the step to give it
            probe = copy.deepcopy(state)
            probe_step = make_train_step(probe.model, probe.optimizer, schedule_sampler="loss-second-moment",
                                         ema_rate=EMA_RATE)
            obj0 = float(probe_step(probe, _port_batch(frames[0]), draws[0])[1]["objective"])
            js = jgd.loss_aware_update(js, ts, jnp.full((2,), obj0), mask=jnp.array([True, draws[0]["take_boot"]]))
    del step1
    step = make_train_step(tm, opt, schedule_sampler="loss-second-moment", ema_rate=EMA_RATE, steps_per_call=2)
    state, metrics = step(state, FrameData.stack_steps([_port_batch(f) for f in frames]), draws)
    return dict(jbefore=_jax_state_dict(variables["params"]), jafter=jafter, jmetrics=jmetrics,
                before=before, state=state, metrics=metrics, draws=draws)


def _assert_updates(got_after, got_before, want_after, want_before, what):
    """Each leaf's change within REL_TOL of its scale. A change is read as
    the difference of two float32 tensors, so it also carries their
    rounding: 2 float32 epsilons of the leaf's largest value."""
    bad = []
    for n, after in got_after.items():
        ref = _reference_name(n)
        du = (after.detach() - got_before[n]).numpy()
        dw = want_after[n] - want_before[n]
        scale = float(np.abs(dw).max())
        err = float(np.abs(du - dw).max())
        rounding = 2 * float(np.finfo(np.float32).eps) * float(np.abs(want_after[n]).max())
        if err > max(REL_TOL * scale, rounding):
            bad.append(f"{what} {ref}: {err:.3e} > {REL_TOL} x {scale:.3e}")
    assert not bad, "\n".join(bad)


def test_two_loss_aware_ema_steps_match_jax(two_steps):
    s = two_steps
    state, jafter = s["state"], s["jafter"]
    assert state.step == int(jafter.step) == 2
    assert {bool(d["take_boot"]) for d in s["draws"]} == {True, False}  # both branches ran
    # the weights both sides start from
    for n, p in s["before"].items():
        np.testing.assert_allclose(p.numpy(), s["jbefore"][n], atol=1e-6, err_msg=n)
    # unweighted metrics, averaged over the two steps: 1e-4
    for k, v in s["jmetrics"].items():
        np.testing.assert_allclose(float(s["metrics"][k]), float(v), atol=OBJ_TOL, err_msg=k)
    _assert_updates(dict(state.model.named_parameters()), s["before"], _jax_state_dict(jafter.params),
                    s["jbefore"], "param")
    _assert_updates(state.ema, s["before"], _jax_state_dict(jafter.ema_params), s["jbefore"], "ema")
    # the sampler credited the unweighted objectives to the drawn timesteps
    np.testing.assert_array_equal(state.sampler_state.loss_counts.numpy(), np.asarray(jafter.sampler_state.loss_counts))
    np.testing.assert_allclose(state.sampler_state.loss_history.numpy(),
                               np.asarray(jafter.sampler_state.loss_history), atol=OBJ_TOL)
    changed = np.nonzero((state.sampler_state.loss_history.numpy() != _warm_history()).any(1))[0]
    drawn = {int(d["timesteps"][0]) for d in s["draws"]} | {
        int(d["timesteps"][1]) for d in s["draws"] if d["take_boot"]}
    assert set(changed.tolist()) == drawn


def test_importance_scale_and_validity_mask():
    w = torch.tensor([2.0, 0.5])
    assert float(importance_scale(w, False)) == pytest.approx(2.0)
    assert float(importance_scale(w, torch.tensor(True))) == pytest.approx(1.0)
    assert ts_validity_mask(False).tolist() == [True, False]
    assert ts_validity_mask(torch.tensor(True)).tolist() == [True, True]


def test_steps_per_call_equals_sequential_steps():
    """One call of K 2 steps equals two calls of one step, bitwise, with
    the sampler and the EMA on (JAX's test_multi_step_scan_matches_sequential)."""
    frames = [_port_batch(_frames(np.roll(np.arange(5), i))) for i in range(2)]
    results = []
    for k in (1, 2):
        tm = _golden_model()
        opt = make_optimizer(tm.named_parameters(), breed="SGD", lr=LR, momentum=0.0)
        sampler = gd.LossSecondMomentState(torch.from_numpy(_warm_history()), torch.full((T,), H, dtype=torch.int64))
        state = TrainState.create(tm, opt, sampler_state=sampler, ema=True)
        step = make_train_step(tm, opt, schedule_sampler="loss-second-moment", ema_rate=EMA_RATE, steps_per_call=k)
        gen = torch.Generator().manual_seed(4)
        objs = []
        if k == 1:
            for b in frames:
                objs.append(step(state, b, gen)[1]["objective"])
        else:
            state, metrics = step(state, FrameData.stack_steps(frames), gen)
        results.append((state, torch.stack(objs).mean(0) if objs else metrics["objective"]))
    (a, obj_a), (b, obj_b) = results
    assert a.step == b.step == 2 and torch.equal(obj_a, obj_b)
    for n, p in a.model.named_parameters():
        assert torch.equal(p, dict(b.model.named_parameters())[n]), n
        assert torch.equal(a.ema[n], b.ema[n]), n
    assert torch.equal(a.sampler_state.loss_history, b.sampler_state.loss_history)
    assert torch.equal(a.sampler_state.loss_counts, b.sampler_state.loss_counts)
    with pytest.raises(ValueError, match="2 mappings of draws"):
        step(b, FrameData.stack_steps(frames), {"timesteps": [1, 2]})


FULL = ["ema_rate=0.5", "steps_per_dispatch=2", *LOSS_AWARE]


def _everything(state):
    out = {f"model.{k}": v.clone() for k, v in state.model.state_dict().items()}
    out.update({f"ema.{k}": v.clone() for k, v in state.ema.items()})
    out["sampler.history"] = state.sampler_state.loss_history.clone()
    out["sampler.counts"] = state.sampler_state.loss_counts.clone()
    for i, s in state.optimizer.optimizer.state_dict()["state"].items():
        out.update({f"opt.{i}.{n}": t.clone() for n, t in s.items()})
    return out


def test_resume_with_ema_and_sampler_equals_straight_run(tmp_path):
    straight, _ = Experiment(tiny_cfg(tmp_path / "straight", FULL), device="cpu").run(max_epochs=2)
    Experiment(tiny_cfg(tmp_path / "resumed", FULL), device="cpu").run(max_epochs=1)
    resumed, _ = Experiment(tiny_cfg(tmp_path / "resumed", FULL), device="cpu").run(max_epochs=2)
    # n_batches_train 2 at K 2: one call of two optimizer steps an epoch
    assert resumed.step == straight.step == 4 and resumed.optimizer.steps == 4
    a, b = _everything(straight), _everything(resumed)
    assert set(a) == set(b) and any(k.startswith("ema.") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert int(straight.sampler_state.loss_counts.sum()) >= 4
    ema_lags = [n for n, p in straight.model.named_parameters() if not torch.equal(p.detach(), straight.ema[n])]
    assert ema_lags


def test_checkpoint_without_ema_restores_only_where_none_is_kept(tmp_path):
    """The checkpoint format before EMA and sampler state (neither key)
    restores into a run that keeps neither; a run that keeps them refuses it
    and names the file."""
    exp = Experiment(tiny_cfg(tmp_path / "old"), device="cpu")
    exp.run(max_epochs=1)
    path = os.path.join(checkpoint_dir(exp.exp_dir, 0), CHECKPOINT_FILE)
    ckpt = torch.load(path, weights_only=True)
    assert set(ckpt) == {"model", "optimizer", "optimizer_steps", "step", "epoch"}
    resumed, _ = Experiment(tiny_cfg(tmp_path / "old"), device="cpu").run(max_epochs=2)
    assert resumed.step == 4 and resumed.ema is None and resumed.sampler_state is None
    for extra in (["ema_rate=0.5"], LOSS_AWARE):
        with pytest.raises(ValueError, match=rf"{checkpoint_dir(exp.exp_dir, 1)}.*holds no"):
            Experiment(tiny_cfg(tmp_path / "old", extra), device="cpu").run(max_epochs=3)


def test_load_experiment_swaps_in_the_ema(tmp_path):
    cfg = tiny_cfg(tmp_path / "ema", ["ema_rate=0.5"])
    state, _ = Experiment(cfg, device="cpu").run(max_epochs=1)
    _, raw = load_experiment(str(tmp_path / "ema"), device="cpu")
    _, avg = load_experiment(str(tmp_path / "ema"), use_ema=True, device="cpu")
    moved = 0
    for n, p in avg.model.named_parameters():
        assert torch.equal(p, raw.ema[n]), n
        moved += not torch.equal(p, dict(raw.model.named_parameters())[n])
    assert moved  # the EMA lags the parameters
    # the BN statistics are not averaged: they stay the model's
    for n, b in avg.model.named_buffers():
        assert torch.equal(b, dict(raw.model.named_buffers())[n]), n
    Experiment(tiny_cfg(tmp_path / "plain"), device="cpu").run(max_epochs=1)
    with pytest.raises(ValueError, match="trained without EMA"):
        load_experiment(str(tmp_path / "plain"), use_ema=True, device="cpu")


def test_uniform_one_step_path_keeps_the_golden():
    """The default step (uniform timesteps, no EMA, one step a call) on the
    golden toy model and draws: the objective within 2e-4 of the golden
    (the JAX package's bound for this forward), the gradients the step
    left within 2e-3 of each leaf's scale, and the SGD update made from
    them."""
    tm = _golden_model()
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    opt = make_optimizer(tm.named_parameters(), breed="SGD", lr=LR, momentum=0.0)
    state = TrainState.create(tm, opt)
    assert state.ema is None and state.sampler_state is None
    _, metrics = make_train_step(tm, opt)(state, _port_batch(_frames(np.arange(5))),
                                          {**_golden_draws(), "timesteps": GOLD["train_timesteps"]})
    np.testing.assert_allclose(float(metrics["objective"]), float(BGOLD["objective"]), atol=2e-4)
    grads = {_reference_name(n): p.grad.numpy() for n, p in tm.named_parameters()}
    _assert_grads(grads, {k: BGOLD[f"gd::{k}"] for k in grads}, tol=REL_TOL)
    for n, p in tm.named_parameters():  # SGD, within the rounding of p - lr g
        want = before[n] - LR * p.grad
        assert float((p.detach() - want).abs().max()) <= 2 * torch.finfo(torch.float32).eps * float(
            want.abs().max()), n
