"""The port's UNet and diffusion sampling against the JAX package and the
reference torch goldens, on the CPU. Random draws are injected: the same
numpy noise goes to both sides."""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from holo_diffusion_tpu.models import diffusion as jgd
from holo_diffusion_tpu.models.unet3d import UNetModel3D as JUNet
from holo_diffusion_torch.models import diffusion as gd
from holo_diffusion_torch.models.unet3d import UNetModel3D, timestep_embedding
from holo_diffusion_torch.weights import state_dict_from_jax

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
UNET_GOLD = np.load(os.path.join(GOLDENS, "unet_goldens.npz"))
DIFF_GOLD = np.load(os.path.join(GOLDENS, "diffusion_goldens.npz"))

SMALL = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2)
C, R = 32, 8


@pytest.fixture(scope="module")
def unets():
    """(JAX apply fn, port UNet) with the same weights: C=32 at 8^3."""
    jm = JUNet(in_channels=C, out_channels=C, use_remat=False, **SMALL)
    x0 = jnp.zeros((1, R, R, R, C))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), x0, jnp.zeros((1,), jnp.int32))
    flat = {"net_3d/" + k: np.asarray(v) for k, v in flatten_dict(params["params"], sep="/").items()}
    sd = {k[len("net_3d."):]: v for k, v in state_dict_from_jax(flat).items()}
    tm = UNetModel3D(in_channels=C, out_channels=C, **SMALL)
    tm.load_state_dict(sd, strict=True)
    tm.eval()
    japply = jax.jit(lambda x, t: jm.apply(params, x, t))
    return japply, tm


def _noise(rs, shape):
    return rs.randn(*shape).astype(np.float32)


def _torch_fn(tm):
    def fn(x, t):
        with torch.no_grad():
            return tm(x, t)
    return fn


def _jax_fn(japply):
    return lambda x, t: japply(x, t.astype(jnp.int32))


def test_unet_matches_jax(unets):
    """float32 convolutions on both sides, different summation orders through
    ~20 layers: 1e-4 absolute on O(1) outputs."""
    japply, tm = unets
    x = _noise(np.random.RandomState(0), (2, R, R, R, C))
    t = np.array([3, 700])
    y_j = np.asarray(japply(jnp.asarray(x), jnp.asarray(t, jnp.int32)))
    with torch.no_grad():
        y_t = tm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert y_t.shape == (2, R, R, R, C)
    np.testing.assert_allclose(y_t, y_j, atol=1e-4, rtol=1e-4)


def test_unet_loads_reference_golden_state_dict():
    """The reference torch state_dict loads by name, no conversion; the same
    tolerance as the JAX package's own golden test."""
    tm = UNetModel3D(in_channels=16, out_channels=16, **SMALL)
    tm.load_state_dict(
        {k[4:]: torch.from_numpy(UNET_GOLD[k]) for k in UNET_GOLD.files if k.startswith("sd::")},
        strict=True,
    )
    x = np.moveaxis(UNET_GOLD["unet_x"], 1, -1)  # NCDHW -> NDHWC
    with torch.no_grad():
        y = tm(torch.from_numpy(np.ascontiguousarray(x)), torch.from_numpy(UNET_GOLD["unet_t"]))
    np.testing.assert_allclose(y.numpy(), np.moveaxis(UNET_GOLD["unet_y"], 1, -1), atol=2e-4, rtol=1e-3)


def test_timestep_embedding_matches_reference():
    t = torch.from_numpy(DIFF_GOLD["temb_t"])
    np.testing.assert_allclose(timestep_embedding(t, 256).numpy(), DIFF_GOLD["temb_256"], atol=1e-4)
    np.testing.assert_allclose(timestep_embedding(t, 64).numpy(), DIFF_GOLD["temb_64"], atol=1e-5)


@pytest.mark.parametrize("name,T", [("linear", 1000), ("linear", 100), ("cosine", 1000)])
def test_beta_schedules_match_reference(name, T):
    np.testing.assert_allclose(gd.get_named_beta_schedule(name, T), DIFF_GOLD[f"betas_{name}_{T}"], rtol=1e-10)


def test_schedule_and_q_sample_match_reference():
    sched = gd.make_named_schedule("linear", 1000)
    for k in ("alphas_cumprod", "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
              "posterior_variance", "posterior_log_variance_clipped", "posterior_mean_coef1",
              "posterior_mean_coef2"):
        np.testing.assert_allclose(getattr(sched, k).numpy(), DIFF_GOLD[f"sched_{k}"], rtol=2e-6, err_msg=k)
    cl = lambda a: torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, 1, -1)))
    t = torch.from_numpy(DIFF_GOLD["q_t"])
    x_t = gd.q_sample(sched, cl(DIFF_GOLD["q_x0"]), t, cl(DIFF_GOLD["q_noise"]))
    np.testing.assert_allclose(x_t.numpy(), cl(DIFF_GOLD["q_sample"]).numpy(), rtol=1e-4, atol=1e-5)
    toy = lambda x, tt: torch.tanh(x * 0.5 + tt.float().reshape(-1, 1, 1, 1, 1) / 1000.0)
    out = gd.p_mean_variance(sched, toy, x_t, t)
    np.testing.assert_allclose(out["mean"].numpy(), cl(DIFF_GOLD["pmv_mean"]).numpy(), atol=1e-5)
    np.testing.assert_allclose(out["log_variance"].numpy(), cl(DIFF_GOLD["pmv_logvar"]).numpy(), atol=1e-4)
    ddim = gd.ddim_sample(sched, toy, x_t, t)["sample"]
    np.testing.assert_allclose(ddim.numpy(), cl(DIFF_GOLD["ddim_sample"]).numpy(), atol=1e-5)


def test_p_sample_matches_jax(unets):
    japply, tm = unets
    rs = np.random.RandomState(1)
    x, noise = _noise(rs, (2, R, R, R, C)), _noise(rs, (2, R, R, R, C))
    t = np.array([17, 941])
    js, ts = jgd.make_named_schedule("linear", 1000), gd.make_named_schedule("linear", 1000)
    j = jgd.p_sample(js, _jax_fn(japply), jnp.asarray(x), jnp.asarray(t), None, noise=jnp.asarray(noise))
    o = gd.p_sample(ts, _torch_fn(tm), torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(noise))
    for k in ("sample", "pred_xstart"):
        np.testing.assert_allclose(o[k].numpy(), np.asarray(j[k]), atol=1e-4, rtol=1e-4)


def test_p_sample_loop_10_steps_matches_jax(unets):
    """max_iter=10: t = 999..991 then 0, one injected noise per step; JAX's
    p_sample stepped in a Python loop with the same noise."""
    japply, tm = unets
    rs = np.random.RandomState(2)
    shape = (1, R, R, R, C)
    x_T = _noise(rs, shape)
    ts = gd.ddpm_timesteps(1000, 10)
    assert ts == list(range(999, 990, -1)) + [0]
    step_noise = [_noise(rs, shape) for _ in ts]
    js = jgd.make_named_schedule("linear", 1000)
    xj = jnp.asarray(x_T)
    for t_scalar, n in zip(ts, step_noise):
        xj = jgd.p_sample(js, _jax_fn(japply), xj, jnp.full((1,), t_scalar, jnp.int32), None,
                          noise=jnp.asarray(n))["sample"]
    xt = gd.p_sample_loop(gd.make_named_schedule("linear", 1000), _torch_fn(tm), shape,
                          noise=torch.from_numpy(x_T), step_noise=[torch.from_numpy(n) for n in step_noise],
                          max_iter=10)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=2e-4, rtol=1e-4)


def test_ddim_sample_loop_matches_jax(unets):
    """eta=0 DDIM is deterministic given x_T: 6 strided steps over T-1..0."""
    japply, tm = unets
    shape = (1, R, R, R, C)
    x_T = _noise(np.random.RandomState(3), shape)
    xj = jgd.ddim_sample_loop(jgd.make_named_schedule("linear", 1000), _jax_fn(japply), shape,
                              jax.random.PRNGKey(0), noise=jnp.asarray(x_T), num_steps=6)
    xt = gd.ddim_sample_loop(gd.make_named_schedule("linear", 1000), _torch_fn(tm), shape,
                             noise=torch.from_numpy(x_T), num_steps=6)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=2e-4, rtol=1e-4)
