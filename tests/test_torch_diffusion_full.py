"""The rest of the port's diffusion library (holo_diffusion_torch/models/
diffusion.py) against the JAX package's on the same numpy inputs, on the
CPU: the schedule's remaining arrays and `rescale_timesteps`, the q process,
learned and learned-range variances through a 2C-channel model, `denoised_fn`
and `cond_fn`, conditioning, progressive DDPM, DDIM with eta > 0 (the JAX
package's per-step draws injected), the DDIM reverse step, the losses and
bits/dim, the loss-second-moment sampler and the EMA; then the JAX tests'
behaviours (tests/test_diffusion.py:208-313) on the port.

Tolerances: float32 arithmetic in another order on O(1) values, 1e-5
absolute (1e-6 relative on top); sums over ten steps and log-likelihoods
in bits 2e-5; exact where both sides compute integers or copy values."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holo_diffusion_tpu.models import diffusion as jgd
from holo_diffusion_torch.models import diffusion as gd
from holo_diffusion_torch.random_draws import Draws

ATOL, RTOL = 1e-5, 1e-6
SUM_ATOL = 2e-5
MEAN_TYPES = [gd.START_X, gd.EPSILON, gd.PREVIOUS_X, gd.SCALED_EPSILON_FOR_START_X]
VAR_TYPES = [gd.FIXED_SMALL, gd.FIXED_LARGE, gd.LEARNED, gd.LEARNED_RANGE]
SHAPE = (2, 3, 3, 3, 4)
BETAS = np.linspace(1e-4, 0.2, 10)


def _scheds(mean_type=gd.START_X, var_type=gd.FIXED_SMALL, rescale=False, betas=BETAS):
    return (jgd.make_schedule(betas, mean_type, var_type, rescale_timesteps=rescale),
            gd.make_schedule(betas, mean_type, var_type, rescale_timesteps=rescale))


def _models(learned=False):
    """The same smooth model in both packages: C channels out, or 2C for a
    learned variance (the second half in [-1, 1]); t enters as a float."""

    def jfn(x, t):
        tt = t.astype(jnp.float32).reshape(-1, 1, 1, 1, 1)
        out = jnp.tanh(0.7 * x + 0.01 * tt)
        return jnp.concatenate([out, jnp.sin(x - 0.02 * tt)], axis=-1) if learned else out

    def tfn(x, t):
        tt = t.float().reshape(-1, 1, 1, 1, 1)
        out = torch.tanh(0.7 * x + 0.01 * tt)
        return torch.cat([out, torch.sin(x - 0.02 * tt)], dim=-1) if learned else out

    return jfn, tfn


def _inputs(seed=0, shape=SHAPE):
    rs = np.random.RandomState(seed)
    return rs.randn(*shape).astype(np.float32), rs.randn(*shape).astype(np.float32)


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach()) if isinstance(got, torch.Tensor) else got,
                               np.asarray(want), atol=atol, rtol=rtol, err_msg=msg)


def _t(t):
    return torch.as_tensor(np.asarray(t), dtype=torch.long)


def test_schedule_arrays_match_jax():
    js, ts = _scheds()
    for f in ("alphas_cumprod_next", "log_one_minus_alphas_cumprod", "alphas_cumprod_prev",
              "fixed_large_variance", "fixed_large_log_variance"):
        _close(getattr(ts, f), getattr(js, f), atol=0, rtol=0, msg=f)
    assert not ts.rescale_timesteps and not gd.make_named_schedule().rescale_timesteps


def test_rescale_timesteps_feeds_the_model_float_t():
    js, ts = _scheds(rescale=True)
    seen = {}

    def tfn(x, t):
        seen["t"] = t
        return torch.tanh(x)

    x, _ = _inputs()
    gd.p_mean_variance(ts, tfn, torch.from_numpy(x), _t([3, 9]))
    assert seen["t"].dtype == torch.float32
    np.testing.assert_array_equal(seen["t"].numpy(), np.asarray(jgd._scale_timesteps(js, jnp.array([3, 9]))))
    np.testing.assert_allclose(seen["t"].numpy(), [300.0, 900.0])


def test_unet_takes_float_timesteps():
    """With rescaling on, the UNet's timestep embedding sees t * 1000 / T."""
    from holo_diffusion_torch.models.unet3d import timestep_embedding

    a = timestep_embedding(torch.tensor([300.0, 900.0]), 8)
    b = timestep_embedding(torch.tensor([300, 900]), 8)
    assert torch.equal(a, b)
    assert not torch.equal(timestep_embedding(torch.tensor([0.5]), 8), timestep_embedding(torch.tensor([0]), 8))


def test_q_mean_variance_matches_jax():
    js, ts = _scheds()
    x, _ = _inputs()
    t = np.array([0, 7])
    for got, want in zip(gd.q_mean_variance(ts, torch.from_numpy(x), _t(t)),
                         jgd.q_mean_variance(js, jnp.asarray(x), jnp.asarray(t))):
        _close(got, want)


@pytest.mark.parametrize("var_type", VAR_TYPES)
@pytest.mark.parametrize("mean_type", MEAN_TYPES)
def test_p_mean_variance_matches_jax(mean_type, var_type):
    """Every mean type with every variance type; learned variances through a
    2C-channel model split on the last axis; `denoised_fn` before the clip;
    timesteps rescaled."""
    learned = var_type in (gd.LEARNED, gd.LEARNED_RANGE)
    js, ts = _scheds(mean_type, var_type, rescale=True)
    jfn, tfn = _models(learned)
    x, _ = _inputs(1)
    t = np.array([0, 6])
    j = jgd.p_mean_variance(js, jfn, jnp.asarray(x), jnp.asarray(t), True, denoised_fn=lambda v: 1.5 * v)
    o = gd.p_mean_variance(ts, tfn, torch.from_numpy(x), _t(t), True, denoised_fn=lambda v: 1.5 * v)
    for k in ("mean", "variance", "log_variance", "pred_xstart"):
        want = np.broadcast_to(np.asarray(j[k]), x.shape)
        _close(o[k].expand(x.shape), want, atol=2e-5 if mean_type == gd.PREVIOUS_X else ATOL, rtol=1e-5, msg=k)


def test_condition_mean_and_score_match_jax():
    js, ts = _scheds(gd.EPSILON)
    jfn, tfn = _models()
    x, _ = _inputs(2)
    t = np.array([2, 8])
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jpmv = jgd.p_mean_variance(js, jfn, jx, jnp.asarray(t))
    tpmv = gd.p_mean_variance(ts, tfn, tx, _t(t))
    jcond = lambda v, tt: jnp.cos(v)  # noqa: E731
    tcond = lambda v, tt: torch.cos(v)  # noqa: E731
    _close(gd.condition_mean(ts, tcond, tpmv, tx, _t(t)), jgd.condition_mean(js, jcond, jpmv, jx, jnp.asarray(t)))
    j = jgd.condition_score(js, jcond, jpmv, jx, jnp.asarray(t))
    o = gd.condition_score(ts, tcond, tpmv, tx, _t(t))
    for k in ("mean", "pred_xstart", "variance"):
        _close(o[k], j[k], atol=1e-4, rtol=1e-5, msg=k)


def test_p_sample_with_cond_and_denoised_fn_matches_jax():
    js, ts = _scheds()
    jfn, tfn = _models()
    x, noise = _inputs(3)
    t = np.array([0, 5])
    j = jgd.p_sample(js, jfn, jnp.asarray(x), jnp.asarray(t), None, True, denoised_fn=lambda v: 0.5 * v,
                     cond_fn=lambda v, tt: -v, noise=jnp.asarray(noise))
    o = gd.p_sample(ts, tfn, torch.from_numpy(x), _t(t), torch.from_numpy(noise), None, True,
                    denoised_fn=lambda v: 0.5 * v, cond_fn=lambda v, tt: -v)
    for k in ("sample", "pred_xstart"):
        _close(o[k], j[k], msg=k)


def test_p_sample_loop_progressive_matches_jax_steps():
    """Each yielded step equals JAX's `p_sample` stepped with the same
    noise (the JAX generator draws its own), over a truncated sequence."""
    js, ts = _scheds()
    jfn, tfn = _models()
    rs = np.random.RandomState(4)
    x_T = rs.randn(*SHAPE).astype(np.float32)
    steps = gd.ddpm_timesteps(10, 4)
    noise = [rs.randn(*SHAPE).astype(np.float32) for _ in steps]
    outs = list(gd.p_sample_loop_progressive(ts, tfn, SHAPE, noise=torch.from_numpy(x_T),
                                             step_noise=[torch.from_numpy(n) for n in noise], max_iter=4))
    assert len(outs) == len(steps) == 4
    xj = jnp.asarray(x_T)
    for out, t_scalar, n in zip(outs, steps, noise):
        j = jgd.p_sample(js, jfn, xj, jnp.full((2,), t_scalar), None, noise=jnp.asarray(n))
        xj = j["sample"]
        _close(out["sample"], xj, atol=SUM_ATOL)
        _close(out["pred_xstart"], j["pred_xstart"], atol=SUM_ATOL)
    last = gd.p_sample_loop(ts, tfn, SHAPE, noise=torch.from_numpy(x_T),
                            step_noise=[torch.from_numpy(n) for n in noise], max_iter=4)
    assert torch.equal(last, outs[-1]["sample"])


@pytest.mark.parametrize("strided", [False, True])
def test_ddim_eta_step_matches_jax(strided):
    """eta 0.5 with the noise JAX draws from its step key injected: a
    middle step, and the last step (t 0, or t_prev -1 on a strided
    sequence), which adds no noise."""
    js, ts = _scheds()
    jfn, tfn = _models()
    x, _ = _inputs(5)
    key = jax.random.PRNGKey(7)
    noise = np.array(jax.random.normal(key, x.shape, jnp.float32))
    for t, tp in (([6, 6], [3, 3]), ([0, 0], [-1, -1])) if strided else (([6, 6], None), ([0, 0], None)):
        jtp = None if tp is None else jnp.asarray(tp)
        j = jgd.ddim_sample(js, jfn, jnp.asarray(x), jnp.asarray(t), key, True, 0.5, t_prev=jtp)
        o = gd.ddim_sample(ts, tfn, torch.from_numpy(x), _t(t), True, t_prev=None if tp is None else _t(tp),
                           eta=0.5, noise=torch.from_numpy(noise))
        _close(o["sample"], j["sample"], msg=str(t))
        _close(o["pred_xstart"], j["pred_xstart"])
        if t[0] == 0:
            quiet = gd.ddim_sample(ts, tfn, torch.from_numpy(x), _t(t), True,
                                   t_prev=None if tp is None else _t(tp), eta=0.5, noise=torch.zeros(x.shape))
            assert torch.equal(quiet["sample"], o["sample"])


@pytest.mark.parametrize("num_steps", [None, 4])
def test_ddim_eta_loop_matches_jax(num_steps):
    """The loop at eta 0.5, each step's noise drawn from JAX's step keys
    (rng -> (rng, rng_init), split(rng, n_steps)), strided and unstrided."""
    js, ts = _scheds()
    jfn, tfn = _models()
    x_T, _ = _inputs(6)
    key = jax.random.PRNGKey(9)
    rng, _ = jax.random.split(key)
    n = len(gd.ddim_timesteps(10, num_steps))
    step_noise = [torch.from_numpy(np.array(jax.random.normal(k, SHAPE, jnp.float32)))
                  for k in jax.random.split(rng, n)]
    j = jgd.ddim_sample_loop(js, jfn, SHAPE, key, noise=jnp.asarray(x_T), eta=0.5, num_steps=num_steps)
    o = gd.ddim_sample_loop(ts, tfn, SHAPE, noise=torch.from_numpy(x_T), eta=0.5, num_steps=num_steps,
                            step_noise=step_noise)
    _close(o, j, atol=SUM_ATOL)


def test_ddim_eta_zero_draws_nothing():
    ts = _scheds()[1]
    _, tfn = _models()
    x_T, _ = _inputs(6)
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    gd.ddim_sample_loop(ts, tfn, SHAPE, noise=torch.from_numpy(x_T), generator=g, num_steps=4)
    assert torch.equal(g.get_state(), state)


def test_ddim_reverse_sample_matches_jax():
    js, ts = _scheds()
    jfn, tfn = _models()
    x, _ = _inputs(7)
    t = np.array([1, 8])
    j = jgd.ddim_reverse_sample(js, jfn, jnp.asarray(x), jnp.asarray(t), clip_denoised=False)
    o = gd.ddim_reverse_sample(ts, tfn, torch.from_numpy(x), _t(t), clip_denoised=False)
    for k in ("sample", "pred_xstart"):
        _close(o[k], j[k], msg=k)


def test_loss_primitives_match_jax():
    rs = np.random.RandomState(8)
    a, b, c, d = (rs.randn(*SHAPE).astype(np.float32) for _ in range(4))
    ja, jb, jc, jd = map(jnp.asarray, (a, b, c, d))
    ta, tb, tc, td = map(torch.from_numpy, (a, b, c, d))
    _close(gd.normal_kl(ta, tb, tc, td), jgd.normal_kl(ja, jb, jc, jd), atol=1e-4, rtol=1e-5)
    _close(gd.approx_standard_normal_cdf(ta), jgd.approx_standard_normal_cdf(ja))
    # means near x, as a decoder's are: the bins' probabilities are not
    # differences of two saturated CDFs (whose logs neither side resolves)
    x = np.clip(a, -1, 1)
    x[0, 0, 0, 0] = [-1.0, 1.0, 0.9995, -0.9995]
    means, log_scales = x + 0.05 * b, 0.3 * c - 2.0
    _close(gd.discretized_gaussian_log_likelihood(*map(torch.from_numpy, (x, means, log_scales))),
           jgd.discretized_gaussian_log_likelihood(*map(jnp.asarray, (x, means, log_scales))), atol=1e-4, rtol=1e-5)
    _close(gd.mean_flat(ta), jgd.mean_flat(ja))
    _close(gd.huber(ta, tb, 0.3), jgd.huber(ja, jb, 0.3))


def test_vb_terms_bpd_matches_jax():
    js, ts = _scheds(gd.EPSILON, gd.LEARNED_RANGE)
    jfn, tfn = _models(learned=True)
    x0, noise = _inputs(9)
    x0 = np.clip(x0, -1, 1)
    t = np.array([0, 4])
    x_t = np.asarray(jgd.q_sample(js, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise)))
    j = jgd.vb_terms_bpd(js, jfn, jnp.asarray(x0), jnp.asarray(x_t), jnp.asarray(t))
    o = gd.vb_terms_bpd(ts, tfn, torch.from_numpy(x0), torch.from_numpy(x_t), _t(t))
    _close(o["output"], j["output"], atol=SUM_ATOL, rtol=1e-5)
    _close(o["pred_xstart"], j["pred_xstart"])


@pytest.mark.parametrize("mean_type", MEAN_TYPES)
@pytest.mark.parametrize("loss_type", ["MSE", "HUBER", "KL", "RESCALED_KL"])
def test_training_losses_match_jax(loss_type, mean_type):
    js, ts = _scheds(mean_type, rescale=True)
    jfn, tfn = _models()
    x0, noise = _inputs(10)
    x0 = np.clip(x0, -1, 1)
    # the KL losses at t 0 are the decoder NLL, whose logs of differences of
    # saturated CDFs (a model far from x_0) neither package resolves in
    # float32; that term is held in test_vb_terms_bpd and
    # test_calc_bpd_loop_matches_jax, where the EPSILON parameterisation
    # keeps the decoder's mean near x_0 at t 0
    t = np.array([1, 7]) if "KL" in loss_type else np.array([0, 7])
    j = jgd.training_losses(js, jfn, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise), loss_type, 0.2)
    o = gd.training_losses(ts, tfn, torch.from_numpy(x0), _t(t), torch.from_numpy(noise), loss_type, 0.2)
    assert set(o) == set(j)
    tol = 2e-4 if loss_type == "RESCALED_KL" else (SUM_ATOL if loss_type == "KL" else ATOL)
    for k in j:
        _close(o[k], j[k], atol=tol, rtol=1e-5, msg=k)


def test_calc_bpd_loop_matches_jax():
    """A 10-step schedule; each step's noise from JAX's keys
    (split(rng, T), in the loop's order t = T-1 .. 0)."""
    js, ts = _scheds(gd.EPSILON)
    jfn, tfn = _models()
    x0, _ = _inputs(11)
    x0 = np.clip(x0, -1, 1)
    key = jax.random.PRNGKey(13)
    noise = np.stack([np.asarray(jax.random.normal(k, SHAPE)) for k in jax.random.split(key, 10)])
    j = jgd.calc_bpd_loop(js, jfn, jnp.asarray(x0), key)
    o = gd.calc_bpd_loop(ts, tfn, torch.from_numpy(x0), torch.from_numpy(noise))
    for k in ("total_bpd", "prior_bpd", "vb", "mse"):
        assert tuple(o[k].shape) == tuple(j[k].shape), k
        _close(o[k], j[k], atol=1e-4 if k == "total_bpd" else SUM_ATOL, rtol=1e-5, msg=k)


# ---- the loss-second-moment sampler and the EMA


def _ring_sequences():
    """(ts, losses, mask) sequences that fill, wrap and mask the ring buffer
    of a (10, 3) history, repeated timesteps included."""
    rs = np.random.RandomState(12)
    seqs = [(np.array([3, 3, 5, 5, 3]), rs.rand(5).astype(np.float32), None),
            (np.arange(10).repeat(3), rs.rand(30).astype(np.float32), None),
            (np.array([4, 4, 4, 7]), rs.rand(4).astype(np.float32), np.array([True, False, True, False])),
            (np.array([9, 9]), rs.rand(2).astype(np.float32) * 10, np.array([True, True]))]
    return seqs


def test_loss_aware_update_and_weights_match_jax():
    jst = jgd.LossSecondMomentState.create(10, history_per_term=3)
    tst = gd.LossSecondMomentState.create(10, history_per_term=3)
    assert tst.loss_history.dtype == torch.float32 and tst.loss_counts.dtype == torch.int64
    for ts_, losses, mask in _ring_sequences():
        jst = jgd.loss_aware_update(jst, jnp.asarray(ts_), jnp.asarray(losses),
                                    None if mask is None else jnp.asarray(mask))
        tst = gd.loss_aware_update(tst, torch.from_numpy(ts_), torch.from_numpy(losses),
                                   None if mask is None else mask.tolist())
        np.testing.assert_array_equal(tst.loss_history.numpy(), np.asarray(jst.loss_history))
        np.testing.assert_array_equal(tst.loss_counts.numpy(), np.asarray(jst.loss_counts))
        _close(gd.loss_aware_weights(tst), jgd.loss_aware_weights(jst), atol=1e-7, rtol=1e-6)
    assert bool((tst.loss_counts == 3).all())  # warmed up: weights no longer uniform
    assert float(gd.loss_aware_weights(tst).std()) > 0


def test_loss_aware_sample_timesteps_matches_jax():
    """Under an injected draw of JAX's categorical timesteps, the weights
    1 / (T p[t]) agree; the port's own draws follow the distribution."""
    jst = jgd.LossSecondMomentState.create(10, history_per_term=3)
    tst = gd.LossSecondMomentState.create(10, history_per_term=3)
    for ts_, losses, mask in _ring_sequences()[:2]:
        jst = jgd.loss_aware_update(jst, jnp.asarray(ts_), jnp.asarray(losses))
        tst = gd.loss_aware_update(tst, torch.from_numpy(ts_), torch.from_numpy(losses))
    js, ts = _scheds()
    key = jax.random.PRNGKey(3)
    jt, jw = jgd.loss_aware_sample_timesteps(js, jst, 6, key)
    tt, tw = gd.loss_aware_sample_timesteps(ts, tst, 6, Draws({"timesteps": np.asarray(jt)}))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    _close(tw, jw, atol=0, rtol=1e-6)
    drawn, _ = gd.loss_aware_sample_timesteps(ts, tst, 20000, Draws(generator=torch.Generator().manual_seed(0)))
    freq = np.bincount(drawn.numpy(), minlength=10) / 20000
    assert 0.5 * np.abs(freq - gd.loss_aware_weights(tst).numpy()).sum() < 0.02


def test_loss_aware_update_reads_nothing_from_the_device():
    """The mask is host booleans; a CUDA-free check that the update's
    arithmetic takes tensors only: it runs on views of the inputs."""
    st = gd.LossSecondMomentState.create(4, history_per_term=2)
    ts_, losses = torch.tensor([1, 1]), torch.tensor([0.5, 0.25])
    new = gd.loss_aware_update(st, ts_, losses.expand(2), [True, True])
    assert new.loss_history[1].tolist() == [0.5, 0.25] and new.loss_counts.tolist() == [0, 2, 0, 0]
    assert st.loss_counts.sum() == 0  # the input state is unchanged
    with pytest.raises(ValueError, match="mask has 1 entries"):
        gd.loss_aware_update(st, ts_, losses, [True])


def test_update_ema_matches_jax():
    rs = np.random.RandomState(14)
    ema = {"a": rs.randn(3, 4).astype(np.float32), "b": rs.randn(5).astype(np.float32)}
    params = {k: rs.randn(*v.shape).astype(np.float32) for k, v in ema.items()}
    j = jgd.update_ema({k: jnp.asarray(v) for k, v in ema.items()}, {k: jnp.asarray(v) for k, v in params.items()},
                       rate=0.9)
    t_ema = {k: torch.from_numpy(v.copy()) for k, v in ema.items()}
    out = gd.update_ema(t_ema, {k: torch.from_numpy(v) for k, v in params.items()}, rate=0.9)
    assert out is t_ema
    for k in ema:
        _close(t_ema[k], j[k], atol=1e-6, rtol=1e-6, msg=k)


def test_create_named_schedule_sampler():
    ts = _scheds()[1]
    fn, state = gd.create_named_schedule_sampler("uniform", ts)
    assert state is None
    t, w = fn(7, Draws(generator=torch.Generator().manual_seed(0)))
    assert t.shape == (7,) and torch.equal(w, torch.ones(7))
    fn, state = gd.create_named_schedule_sampler("loss-second-moment", ts)
    assert tuple(state.loss_history.shape) == (10, 10)
    t, w = fn(5, Draws({"timesteps": np.array([0, 1, 2, 3, 9])}), state)
    np.testing.assert_allclose(w.numpy(), 1.0)  # uniform before warm-up: 1 / (T / T)
    with pytest.raises(NotImplementedError):
        gd.create_named_schedule_sampler("nope", ts)


# ---- the JAX tests' behaviours (tests/test_diffusion.py:208-313)


def test_progressive_generator_yields_all_steps():
    small = gd.make_schedule(np.linspace(1e-4, 0.02, 5))
    outs = list(gd.p_sample_loop_progressive(small, lambda x, t: torch.zeros_like(x), (1, 2, 2, 2, 1),
                                             generator=torch.Generator().manual_seed(2)))
    assert len(outs) == 5
    assert torch.allclose(outs[-1]["sample"], torch.zeros(()), atol=1e-6)


def test_training_losses_start_x_perfect_model():
    small = gd.make_schedule(np.linspace(1e-4, 0.02, 10))
    x0 = torch.ones((2, 4, 4, 4, 3)) * 0.5
    out = gd.training_losses(small, lambda x, tt: x0.expand(x.shape), x0, torch.tensor([3, 7]),
                             torch.randn(x0.shape, generator=torch.Generator().manual_seed(0)))
    np.testing.assert_allclose(out["loss"].numpy(), 0.0, atol=1e-6)


def test_loss_aware_sampler_warmup_and_weighting():
    sched10 = gd.make_schedule(np.linspace(1e-4, 0.02, 10))
    state = gd.LossSecondMomentState.create(10, history_per_term=2)
    np.testing.assert_allclose(gd.loss_aware_weights(state).numpy(), 0.1, atol=1e-6)
    ts_ = torch.tensor([3, 3, 5, 5] + [i for i in range(10) for _ in range(2)])
    state = gd.loss_aware_update(state, ts_, torch.where(ts_ == 3, 10.0, 0.1))
    w = gd.loss_aware_weights(state)
    assert w[3] > w[5]
    np.testing.assert_allclose(float(w.sum()), 1.0, atol=1e-5)
    t, _ = gd.loss_aware_sample_timesteps(sched10, state, 256, Draws(generator=torch.Generator().manual_seed(1)))
    assert (t == 3).float().mean() > (t == 5).float().mean()


def test_loss_aware_update_mask_skips_entries():
    state = gd.LossSecondMomentState.create(10, history_per_term=2)
    masked = gd.loss_aware_update(state, torch.tensor([3, 7]), torch.tensor([1.0, 2.0]), mask=[True, False])
    assert int(masked.loss_counts[3]) == 1 and int(masked.loss_counts[7]) == 0
    assert float(torch.sum(masked.loss_history[7] ** 2)) == 0.0
    assert int(gd.loss_aware_update(state, torch.tensor([3, 7]), torch.tensor([1.0, 2.0])).loss_counts[7]) == 1
    same_t = gd.loss_aware_update(state, torch.tensor([4, 4, 4]), torch.tensor([1.0, 2.0, 3.0]),
                                  mask=[True, False, True])
    assert int(same_t.loss_counts[4]) == 2
    np.testing.assert_allclose(same_t.loss_history[4].numpy(), [1.0, 3.0])


def test_ddim_reverse_then_forward_roundtrip():
    small = gd.make_schedule(np.linspace(1e-4, 0.02, 50))

    def model(x, t):
        return torch.clamp(x * 0.9, -1, 1)

    x0 = torch.clamp(torch.randn((1, 4, 4, 4, 2), generator=torch.Generator().manual_seed(0)), -1, 1)
    x = x0
    for i in range(3):
        x = gd.ddim_reverse_sample(small, model, x, torch.tensor([i]), clip_denoised=False)["sample"]
    y = x
    for i in range(2, -1, -1):
        y = gd.ddim_sample(small, model, y, torch.tensor([i + 1]), clip_denoised=False)["sample"]
    assert np.corrcoef(x0.numpy().ravel(), y.numpy().ravel())[0, 1] > 0.9


def test_calc_bpd_loop_runs():
    small = gd.make_schedule(np.linspace(1e-4, 0.02, 6))
    out = gd.calc_bpd_loop(small, lambda x, t: torch.zeros_like(x), torch.zeros((2, 2, 2, 2, 1)),
                           torch.Generator().manual_seed(0))
    assert out["total_bpd"].shape == (2,) and bool(torch.isfinite(out["total_bpd"]).all())
    assert out["vb"].shape == (2, 6)


def test_update_ema():
    out = gd.update_ema({"w": torch.zeros(3)}, {"w": torch.ones(3)}, rate=0.9)
    np.testing.assert_allclose(out["w"].numpy(), 0.1, atol=1e-6)


def test_condition_score_changes_mean():
    sched_ = gd.make_schedule(np.linspace(1e-4, 0.02, 10))
    x = torch.randn((1, 2, 2, 2, 1), generator=torch.Generator().manual_seed(0))
    t = torch.tensor([5])
    pmv = gd.p_mean_variance(sched_, lambda xx, tt: torch.tanh(xx), x, t)
    out = gd.condition_score(sched_, lambda xx, tt: torch.ones_like(xx), pmv, x, t)
    assert float((out["mean"] - pmv["mean"]).abs().max()) > 0
    assert bool(torch.isfinite(out["pred_xstart"]).all())
