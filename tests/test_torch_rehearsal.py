"""The release rehearsals of the port (`holo_diffusion_torch/rehearsal.py`,
the counterpart of scripts/release_rehearsal*.py) against the JAX package,
on the CPU, and the training trajectory the long rehearsal's curve rests on:

  (a) `pooled_grid` against JAX's `preprocess_input` +
      `HoloDiffusionModel.pool_features` (full variables: the extractor's
      BatchNorm on its running statistics), composed as
      scripts/release_rehearsal_long.py:110-126 composes them, on the
      goldens' toy model and batch: 1e-5 of the grid's scale; the model's
      mode and BN statistics are left as they were;
  (b) `denoise_leg_mse` at the five probe timesteps against JAX's
      `q_sample` + `p_mean_variance(clip_denoised=True)` through
      `apply_net_3d` (:128-145) with the same numpy noise: 1e-4 relative;
  (c) `run_rehearsal` 2 epochs x 2 steps on a small CO3D tree at a tiny
      width: `curve.json` with the JAX script's keys, (H, W, 3) PNGs, and
      per-epoch stats equal bitwise (resume is exact on the CPU) to those of
      the rehearsal without its probes, one straight
      `Experiment.run(max_epochs=2)`;
  (d) `main()` raises without CUDA when no device is given, and an epoch's
      TrainState does not outlive its `Experiment.run` call through a
      warning that a handler keeps;
  (e) 8 Adam steps with the loss-second-moment sampler and the EMA through
      JAX's `make_train_step` and the port's, the port's draws derived from
      JAX's keys in `parallel/train_step.py`'s split order (the call's key
      -> (model key, sampler key)): the objective at every step, and every
      parameter, the EMA and the sampler state after step 8 (tolerances in
      the test's docstring).

JAX's variables come from the goldens' torch state_dict through JAX's own
converter on a `jax.eval_shape` tree, so no JAX `init` is compiled; the one
JAX compile is the train step's."""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import gc
import json
import logging
import os
import sys
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from PIL import Image

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_train_full import (  # noqa: E402
    GOLD, _frames, _jax_batch, _model_draws, _port_batch, _warm_history, j_toy_model)
from test_torch_train_step import _golden_model, _reference_name  # noqa: E402
from torch_tiny_config import MODEL, TINY_OVERRIDES, tiny_cfg  # noqa: E402

from holo_diffusion_torch import experiment, rehearsal  # noqa: E402
from holo_diffusion_torch.data.synthetic_co3d import write_synthetic_co3d  # noqa: E402
from holo_diffusion_torch.experiment import Experiment  # noqa: E402
from holo_diffusion_torch.models import diffusion as gd  # noqa: E402
from holo_diffusion_torch.parallel.train_step import TrainState, make_train_step  # noqa: E402
from holo_diffusion_torch.train.optimizer import make_optimizer  # noqa: E402
from holo_diffusion_tpu.models import diffusion as jgd  # noqa: E402
from holo_diffusion_tpu.models.holo_model import HoloDiffusionModel as JHolo  # noqa: E402
from holo_diffusion_tpu.models.metrics import preprocess_input as j_preprocess_input  # noqa: E402
from holo_diffusion_tpu.parallel.train_step import TrainState as JTrainState  # noqa: E402
from holo_diffusion_tpu.parallel.train_step import make_train_step as j_make_train_step  # noqa: E402
from holo_diffusion_tpu.train.optimizer import make_optimizer as j_make_optimizer  # noqa: E402
from holo_diffusion_tpu.utils.torch_import import convert_holo_model_state_dict  # noqa: E402
from holo_diffusion_torch.weights import state_dict_from_jax  # noqa: E402

# the keys of a record of scripts/release_rehearsal_long.py:181-200 and of
# its summary (:207-212)
JAX_RECORD_KEYS = {"epoch", "train_psnr", "val_psnr", "objective", "prev_stage_rgb_mse", "prev_stage_rgb_psnr",
                   "denoise_mse_per_t", "denoise_mse_mean", "pooled_grid_var", "denoise_mse_rel", "sample_png",
                   "sample_render_mean"}
JAX_SUMMARY_KEYS = {"max_epochs", "steps", "wall_s", "curve"}
T, H = 1000, 10


@pytest.fixture(scope="module")
def toy():
    """The goldens' toy model in both packages with the goldens' weights;
    JAX's variables converted onto a `jax.eval_shape` tree."""
    jmodel = j_toy_model()
    cams = _jax_batch(_frames(np.arange(5))).camera
    base = jax.eval_shape(lambda key: jmodel.init(
        key, camera=cams, image_rgb=jnp.asarray(GOLD["image_rgb"]), fg_probability=jnp.asarray(GOLD["fg_probability"]),
        mask_crop=jnp.asarray(GOLD["mask_crop"]), training=False, rng=None), jax.random.PRNGKey(0))
    sd = {k[4:]: GOLD[k] for k in GOLD.files if k.startswith("sd::")}
    variables = convert_holo_model_state_dict(
        sd, base, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions=(2,), dnet_num_layers=4,
        rnet_num_layers=1, resnet_layers=(2, 2, 2, 2), resnet_stages=(1,))
    assert not [leaf for leaf in jax.tree.leaves(variables) if isinstance(leaf, jax.ShapeDtypeStruct)]
    return jmodel, variables


def _scale_err(got, want):
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _jax_pooled_grid(jmodel, variables, f):
    """scripts/release_rehearsal_long.py:110-126 on the frames `f`."""

    @jax.jit
    def pooled_grid(variables, camera, image_rgb, fg, mask_crop):
        img, fg2, _ = j_preprocess_input(image_rgb, fg, None, jmodel.mask_images, jmodel.mask_depths,
                                         jmodel.mask_threshold, jmodel.bg_color)
        return jmodel.apply(variables, img, camera, fg2, mask_crop, method=JHolo.pool_features)

    return np.asarray(pooled_grid(variables, _jax_batch(f).camera, jnp.asarray(f["image_rgb"]),
                                  jnp.asarray(f["fg_probability"]), jnp.asarray(f["mask_crop"])))


def test_pooled_grid_matches_jax(toy):
    jmodel, variables = toy
    f = _frames(np.arange(5))
    want = _jax_pooled_grid(jmodel, variables, f)
    tm = _golden_model().train()
    buffers = {n: b.clone() for n, b in tm.named_buffers()}
    got = rehearsal.pooled_grid(tm, _port_batch(f))
    assert got.shape == want.shape == (8, 8, 8, 8) and not got.requires_grad
    assert _scale_err(got.numpy(), want) <= 1e-5
    # the probe leaves the model in its mode and its BN statistics as they were
    assert tm.training
    for n, b in tm.named_buffers():
        assert torch.equal(b, buffers[n]), n


def test_denoise_leg_mse_matches_jax(toy):
    """The probe at PROBE_TS with one fixed noise (the JAX script draws it
    once from its key; here numpy draws it for both)."""
    jmodel, variables = toy
    v = np.array(_jax_pooled_grid(jmodel, variables, _frames(np.arange(5)))[None])
    noise = np.random.RandomState(5).randn(*v.shape).astype(np.float32)
    jsched = jgd.make_named_schedule_from_config(jmodel.diffusion_args or {})

    net = jax.jit(lambda x, t: jmodel.apply(variables, x, t, method=JHolo.apply_net_3d))

    def model_fn(x, t):
        return net(x, t)

    want = []
    for t_scalar in rehearsal.PROBE_TS:
        t = jnp.full((1,), t_scalar, jnp.int32)
        x_t = jgd.q_sample(jsched, jnp.asarray(v), t, jnp.asarray(noise))
        out = jgd.p_mean_variance(jsched, model_fn, x_t, t, clip_denoised=True)
        want.append(float(jnp.mean((out["pred_xstart"] - v) ** 2)))
    tm = _golden_model()
    got = rehearsal.denoise_leg_mse(tm, tm.schedule, torch.from_numpy(v), torch.from_numpy(noise))
    assert got.shape == (len(rehearsal.PROBE_TS),)
    np.testing.assert_allclose(got.numpy(), np.array(want), rtol=1e-4)


_DS = "data_source_ImplicitronDataSource_args."
_SIZE = _DS + "dataset_map_provider_JsonIndexDatasetMapProviderV2_args.dataset_JsonIndexDataset_args."
# the tiny width of tests/torch_tiny_config.py on hydrant.yaml, with the
# 1000-step schedule the probe's timesteps need and 3-frame val batches
TINY_HYDRANT = [o for o in TINY_OVERRIDES
                if not any(k in o for k in ("SyntheticDataProvider", "dataset_length", "num_steps", "beta_"))] + [
    _SIZE + "image_height=16", _SIZE + "image_width=16",
    _DS + "data_loader_map_provider_SequenceDataLoaderMapProvider_args.dataset_length_val=3",
    MODEL + "net_3d_SimpleUnet3D_args.num_res_blocks=1", MODEL + "net_3d_SimpleUnet3D_args.model_channels=32",
]


def _history(exp_dir):
    """Each epoch's train and val stats from the loop's stats file, its
    timings dropped."""
    with open(os.path.join(exp_dir, "train_stats.json")) as f:
        hist = json.load(f)["history"]
    return [{s: {k: v for k, v in h[s].items() if k != "sec/it"} for s in ("train", "val")} for h in hist]


def test_run_rehearsal_writes_jax_curve_and_resumes_exactly(tmp_path):
    root = str(tmp_path / "tree")
    write_synthetic_co3d(root, n_seq=2, n_frames=6, H=48, W=64, seed=0, n_val_frames=2)
    out, exp_dir = str(tmp_path / "out"), str(tmp_path / "exp")
    summary, epochs = rehearsal.run_rehearsal(2, out, exp_dir, steps_per_epoch=2, render_size=16, device="cpu",
                                              root=root, overrides=TINY_HYDRANT)
    with open(os.path.join(out, "curve.json")) as f:
        curve = json.load(f)
    assert set(curve) == JAX_SUMMARY_KEYS and curve["max_epochs"] == 2 and curve["steps"] == 4
    assert curve["curve"] == json.loads(json.dumps(summary["curve"]))
    for epoch, rec in enumerate(curve["curve"]):
        assert set(rec) == JAX_RECORD_KEYS and rec["epoch"] == epoch
        assert list(rec["denoise_mse_per_t"]) == [str(t) for t in rehearsal.PROBE_TS]
        assert all(np.isfinite(x) for k, x in rec.items() if isinstance(x, float))
        img = np.asarray(Image.open(rec["sample_png"]))
        assert img.shape == (16, 16, 3) and img.dtype == np.uint8
        assert rec["sample_render_mean"] == pytest.approx(img.mean() / 255.0, abs=1 / 255)
    # every epoch resumed from the one before: 2 steps an epoch
    assert [e["step"] for e in epochs] == [2, 4]

    # without the probes: one straight `Experiment.run(max_epochs=2)` of the
    # same config, the same stats bitwise
    straight = str(tmp_path / "straight")
    summary, epochs = rehearsal.run_rehearsal(2, str(tmp_path / "out2"), straight, probes=False, steps_per_epoch=2,
                                              device="cpu", root=root, overrides=TINY_HYDRANT)
    assert set(summary) == {"max_epochs", "steps", "wall_s", "history"} and summary["steps"] == 4
    assert [e["step"] for e in epochs] == [4] and not os.path.exists(tmp_path / "out2" / "curve.json")
    assert _history(exp_dir) == _history(straight)


def test_an_epoch_leaves_no_state_behind_a_kept_warning(monkeypatch, tmp_path):
    """The rehearsal calls `Experiment.run` once an epoch. Where matplotlib
    is missing (as on the card's machine) every checkpoint logs a warning;
    a handler that keeps records (such as chip_smoke.py's) must not keep
    the epoch's TrainState alive through it, or each epoch adds an Adam
    state to the card's memory."""
    def no_matplotlib(*args, **kwargs):
        raise ImportError("No module named 'matplotlib'", name="matplotlib")

    monkeypatch.setattr(experiment, "plot_stats_pdf", no_matplotlib)
    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    log = logging.getLogger("holo_diffusion_torch.experiment")
    log.addHandler(handler)
    try:
        exp = Experiment(tiny_cfg(tmp_path / "exp"), device="cpu")
        optimizers = []
        for epoch in range(2):
            state, _ = exp.run(max_epochs=epoch + 1)
            optimizers.append(weakref.ref(state.optimizer.optimizer))
            del state
            gc.collect()
    finally:
        log.removeHandler(handler)
    assert [r.getMessage() for r in records] == ["stats plot failed: No module named 'matplotlib'"] * 2
    assert [o() is None for o in optimizers] == [True, True]


def test_main_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rehearsal.main(["1", "--out", str(tmp_path / "out"), "--exp-dir", str(tmp_path / "exp")])
    assert not os.path.exists(tmp_path / "out") and not os.path.exists(tmp_path / "exp")


LR = 1e-3
EMA_RATE = 0.9
N_STEPS = 8
QUIET = 1e-3


@pytest.fixture(scope="module")
def trajectory(toy):
    """8 Adam steps (lr 1e-3) with the loss-second-moment sampler (warmed
    from a seeded history) and the EMA at 0.9, one step a call, each on the
    goldens' 5 frames in another order: JAX's `make_train_step`, and the
    port's with the draws of JAX's keys (the timesteps drawn from JAX's
    sampler state before the step)."""
    jmodel, variables = toy
    hist = _warm_history()
    tx = j_make_optimizer(breed="Adam", lr=LR)
    jstate = JTrainState.create(variables, tx, ema=True, sampler_state=jgd.LossSecondMomentState(
        loss_history=jnp.asarray(hist), loss_counts=jnp.full((T,), H, jnp.int32)))
    jstep = j_make_train_step(jmodel, tx, mesh=None, donate=False, schedule_sampler="loss-second-moment",
                              ema_rate=EMA_RATE)
    jsched = jgd.make_named_schedule_from_config(jmodel.diffusion_args or {})

    tm = _golden_model()
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    opt = make_optimizer(tm.named_parameters(), breed="Adam", lr=LR)
    sampler = gd.LossSecondMomentState(torch.from_numpy(hist.copy()), torch.full((T,), H, dtype=torch.int64))
    state = TrainState.create(tm, opt, sampler_state=sampler, ema=True)
    step = make_train_step(tm, opt, schedule_sampler="loss-second-moment", ema_rate=EMA_RATE)

    params = dict(tm.named_parameters())
    # per leaf: its largest gradient over the steps, and each element's
    # least ratio of its gradient RMS so far (Adam's bias-corrected sqrt(v))
    # to the leaf's largest gradient of that step
    gmax = {n: 0.0 for n in params}
    rms_ratio = {n: torch.full_like(p, float("inf")) for n, p in params.items()}
    objs, jobjs, boots = [], [], []
    for k, key in enumerate(jax.random.split(jax.random.PRNGKey(31), N_STEPS)):
        f = _frames(np.roll(np.arange(5), k))
        rng, rng_t = jax.random.split(key)
        ts, _ = jgd.loss_aware_sample_timesteps(jsched, jstate.sampler_state, 2, rng_t)
        draws = {"timesteps": np.asarray(ts), **_model_draws(rng)}
        boots.append(draws["take_boot"])
        jstate, jmetrics = jstep(jstate, _jax_batch(f), key)
        state, metrics = step(state, _port_batch(f), draws)
        jobjs.append(float(jmetrics["objective"]))
        objs.append(float(metrics["objective"]))
        for n, p in params.items():
            g = float(p.grad.abs().max())
            gmax[n] = max(gmax[n], g)
            v_hat = opt.optimizer.state[p]["exp_avg_sq"] / (1.0 - 0.999 ** (k + 1))
            rms_ratio[n] = torch.minimum(rms_ratio[n], v_hat.sqrt() / g)
    return dict(jstate=jstate, state=state, before=before, objs=np.array(objs), jobjs=np.array(jobjs), boots=boots,
                jbefore=_jax_params(variables["params"]), gmax=gmax, rms_ratio=rms_ratio)


def _jax_params(params):
    return {k: v.numpy() for k, v in state_dict_from_jax(flatten_dict(jax.device_get(params), sep="/")).items()}


def test_eight_adam_steps_follow_jax(trajectory):
    """The objective at every step within 1e-4 relative of JAX's, step 1's
    bound at every step: the parameters the later steps start from differ
    from JAX's by less than 2e-3 of 8 updates of lr 1e-3 (about 2e-5), a
    perturbation whose effect on the objective lies far inside the bound
    the forward itself is held to (measured: 1.1e-6 at step 8).

    After step 8, each leaf's change from the initial weights (parameters
    and EMA) within 2e-3 of the largest change JAX made to that leaf, the
    sampler's counts equal and its history within 2e-3 of its scale.
    Excluded from the leaf comparison, by two rules:
    (i) leaves whose gradient vanishes up to rounding at every step (its
        largest is below 1e-6 of the largest of any leaf: the conv biases
        right before a GroupNorm, as chip_smoke.py's train_check_phase
        excludes them);
    (ii) elements whose gradient RMS so far (Adam's bias-corrected
        sqrt(v)) fell below QUIET (1e-3) of their leaf's largest gradient
        at some step, 3.3 % of the elements (about 1.4 % of them with an
        exactly zero gradient).
    Adam's update is lr m / (sqrt(v) + eps): it carries a gradient's
    difference between the packages into the update divided by that
    element's RMS, so where the gradient is near zero (a sign flipped by
    rounding) the two updates differ by up to ~lr a step however close the
    gradients are; without (ii) the largest difference is 6.7e-3 of a
    leaf's scale."""
    s = trajectory
    jstate, state = s["jstate"], s["state"]
    assert state.step == int(jstate.step) == N_STEPS
    assert set(s["boots"]) == {True, False}  # both branches of the bootstrap pass ran
    rel = np.abs(s["objs"] - s["jobjs"]) / np.abs(s["jobjs"])
    assert rel.max() <= 1e-4, rel

    largest = max(s["gmax"].values())
    jafter, jema = _jax_params(jstate.params), _jax_params(jstate.ema_params)
    bad, n_quiet, n_all = [], 0, 0
    for what, got_after, want_after in (("param", dict(state.model.named_parameters()), jafter),
                                        ("ema", state.ema, jema)):
        for n, after in got_after.items():
            if s["gmax"][n] <= 1e-6 * largest:
                continue
            live = (s["rms_ratio"][n] >= QUIET).numpy()
            if what == "param":
                n_quiet, n_all = n_quiet + int((~live).sum()), n_all + live.size
            du = after.detach().numpy() - s["before"][n].numpy()
            dw = want_after[n] - s["jbefore"][n]
            scale = float(np.abs(dw).max())
            err = float(np.abs(du - dw)[live].max(initial=0.0))
            if err > 2e-3 * scale:
                bad.append(f"{what} {_reference_name(n)}: {err:.3e} > 2e-3 x {scale:.3e}")
    assert not bad, "\n".join(bad)
    assert n_quiet <= 0.05 * n_all, (n_quiet, n_all)  # the rule leaves nearly every element compared
    got, want = state.sampler_state, jstate.sampler_state
    np.testing.assert_array_equal(got.loss_counts.numpy(), np.asarray(want.loss_counts))
    hist = np.asarray(want.loss_history)
    assert float(np.abs(got.loss_history.numpy() - hist).max()) <= 2e-3 * float(np.abs(hist).max())
