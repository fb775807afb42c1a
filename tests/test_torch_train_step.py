"""The training slice of the port as a whole, on the CPU: one training
step of `HoloDiffusionModel` (pool, two-pass denoise, mask-sampled
two-pass render, photometric objective, backward, Adam) against the torch
goldens of the reference (tests/goldens/holo_backward_goldens.npz, made by
tests/make_goldens_holo_backward.py, which the JAX package's `jax.grad`
matches in tests/test_holo_grad_parity.py), with the same weights and the
same random draws; and `make_train_step` on a synthetic scene. (The
training render's stratified and noisy draws are held against JAX in
tests/test_torch_train_render.py: a whole-model `jax.grad` through the
interpreted Pallas decode takes minutes on the CPU.)"""
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
from torch_toy_model import TOY  # noqa: E402

from holo_diffusion_torch.data.synthetic import make_synthetic_scene  # noqa: E402
from holo_diffusion_torch.geometry.cameras import PerspectiveCameras  # noqa: E402
from holo_diffusion_torch.models.holo_model import HoloDiffusionModel  # noqa: E402
from holo_diffusion_torch.ops import _build
from holo_diffusion_torch.ops import fused_decode as fd  # noqa: E402
from holo_diffusion_torch.parallel.train_step import TrainState, make_train_step  # noqa: E402
from holo_diffusion_torch.train.optimizer import make_optimizer  # noqa: E402
from holo_diffusion_torch.weights import init_weights, state_dict_from_reference  # noqa: E402

BGOLD = np.load(os.path.join(os.path.dirname(__file__), "goldens", "holo_backward_goldens.npz"))

# reference state_dict prefix -> the port's (weights.state_dict_from_reference)
_TO_REFERENCE = (("net_3d.", "net_3d._net."), ("implicit_function.", "_implicit_functions.0._fn."))


def _reference_name(port_name):
    for port, ref in _TO_REFERENCE:
        if port_name.startswith(port):
            return ref + port_name[len(port):]
    return port_name


def _golden_model():
    tm = HoloDiffusionModel(**TOY)
    sd = {k[4:]: GOLD[k] for k in GOLD.files if k.startswith("sd::")}
    tm.load_state_dict(state_dict_from_reference(sd), strict=True)
    return tm


def _cams():
    return PerspectiveCameras(*(torch.from_numpy(GOLD[k]) for k in ("cam_R", "cam_T", "cam_focal", "cam_pp")))


def _golden_draws():
    """The draws of the golden's training forward, by the JAX package's split
    order (holo_model.py:498-500, :232; renderer and rays: render key ->
    (rays, render), rays -> (pixels, lengths)); tests/make_goldens_holo_backward.py
    derives the same."""
    rng = jax.random.PRNGKey(127)
    _, rng_denoise, rng_render = jax.random.split(rng, 3)
    _, rng_n, _, rng_n2, rng_b = jax.random.split(rng_denoise, 5)
    shape = (1, 8, 8, 8, 8)
    rng_rays, _ = jax.random.split(rng_render)
    rng_pix, _ = jax.random.split(rng_rays)
    return {
        "timesteps": np.asarray(GOLD["train_timesteps"]),
        "noise": np.asarray(jax.random.normal(rng_n, shape)),
        "noise2": np.asarray(jax.random.normal(rng_n2, shape)),
        "take_boot": bool(jax.random.uniform(rng_b, ()) < 0.5),
        "ray_pixel_u": np.asarray(jax.random.uniform(rng_pix, (2, 64))),
    }


def _batch_kwargs():
    return dict(image_rgb=torch.from_numpy(GOLD["image_rgb"]), fg_probability=torch.from_numpy(GOLD["fg_probability"]),
                mask_crop=torch.from_numpy(GOLD["mask_crop"]))


@pytest.fixture(scope="module")
def golden_step():
    """Forward + backward of the port at the golden's weights and draws."""
    tm = _golden_model()
    draws = _golden_draws()
    assert draws["take_boot"] == bool(GOLD["train_take_boot"])
    _build.reset_launch_counts()
    preds = tm(_cams(), training=True, draws=draws, **_batch_kwargs())
    preds["objective"].backward()
    return tm, preds


def _assert_grads(named_grads, want, tol=2e-3):
    """Every gradient within `tol` of its leaf's largest magnitude (the JAX
    package's own budget against these goldens, test_holo_grad_parity.py)."""
    bad = []
    for name, g in named_grads.items():
        w = want[name]
        scale = float(np.abs(w).max())
        if scale == 0.0:
            if float(np.abs(g).max()) > 1e-7:
                bad.append(f"{name}: golden 0, port max {np.abs(g).max():.2e}")
            continue
        err = float(np.abs(g - w).max())
        if err > max(tol * scale, 1e-8):
            bad.append(f"{name}: max|diff| {err:.3e} > {tol} x {scale:.3e}")
    assert not bad, "gradient mismatches:\n" + "\n".join(bad)


def test_objective_and_every_gradient_match_golden(golden_step):
    """The rays are the golden's; objective within 2e-4 (the JAX package's
    bound for the same forward: float32 through two UNet passes and two
    render passes); every parameter's gradient at 2e-3 of its scale."""
    tm, preds = golden_step
    np.testing.assert_allclose(preds["ray_bundle"].xys.numpy(), GOLD["train_xys"], atol=1e-6)
    assert bool(preds["diffusion_take_boot"])
    np.testing.assert_allclose(preds["diffusion_x_t"].detach().numpy(), GOLD["train_x_t"], atol=1e-4)
    np.testing.assert_allclose(preds["voxel_features"].detach().numpy(), GOLD["train_voxel_features"], atol=2e-4)
    np.testing.assert_allclose(preds["objective"].item(), float(BGOLD["objective"]), atol=2e-4)
    np.testing.assert_allclose(preds["images_render"].detach().numpy(), GOLD["train_images_render"], atol=2e-4)
    grads = {_reference_name(n): p.grad.numpy() for n, p in tm.named_parameters()}
    assert set(grads) == {k[4:] for k in BGOLD.files if k.startswith("gd::")}
    _assert_grads(grads, {k: BGOLD[f"gd::{k}"] for k in grads})
    # the CPU path launched no kernel
    assert not any(_build.launch_counts().values())


def test_adam_step_matches_golden(golden_step):
    """One Adam(5e-5) step from the port's gradients against the golden's
    torch step, compared as updates where the gradient is well above Adam's
    eps (the JAX package's own rule, test_holo_grad_parity.py:139-178):
    within 0.5 % of the lr-bounded update."""
    tm, _ = golden_step
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    opt = make_optimizer(tm.named_parameters(), breed="Adam", lr=5e-5)
    opt.step()
    bad = []
    for n, p in tm.named_parameters():
        ref = _reference_name(n)
        up_t = (p.detach() - before[n]).numpy()
        up_g = BGOLD[f"ps::{ref}"] - before[n].numpy()
        g = np.abs(BGOLD[f"gd::{ref}"])
        mask = g > 10.0 * np.sqrt(1e-8 * max(float(g.max()), 1e-12))
        if mask.any() and float(np.abs(up_t - up_g)[mask].max()) > 5e-3 * 5e-5:
            bad.append(n)
    assert not bad, bad


def test_train_step_on_a_synthetic_scene():
    """Two steps of `make_train_step` at the toy width with hydrant's random
    settings (stratified rays, density noise) from a generator: finite
    objectives, every parameter group moved, no kernel launched."""
    scene = make_synthetic_scene(n_views=4, image_size=24, seed=1, device="cpu")
    tm = init_weights(HoloDiffusionModel(**{**TOY, "stratified_point_sampling_training": True,
                                            "density_noise_std_train": 1.0, "n_rays_per_image": 32}), seed=3)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    opt = make_optimizer(tm.named_parameters(), breed="Adam", lr=1e-3)
    state = TrainState(tm, opt)
    step = make_train_step(tm, opt)
    gen = torch.Generator().manual_seed(0)
    _build.reset_launch_counts()
    objectives = []
    for _ in range(2):
        state, metrics = step(state, scene, gen)
        objectives.append(float(metrics["objective"]))
    assert state.step == 2 and opt.steps == 2
    assert all(np.isfinite(objectives))
    moved = {n.split(".")[0] for n, p in tm.named_parameters() if not torch.equal(p, before[n])}
    assert moved == {"image_feature_extractor", "view_pooler", "pooled_feature_mapper", "net_3d",
                     "implicit_function"}
    assert not any(_build.launch_counts().values())


def test_eval_forward_and_encode_match_golden():
    """The evaluation forward from images (pool the sources, t=0 denoise +
    tanh, full-grid two-pass render of the first frame, metrics) and
    `encode_eval`, against the golden's evaluation outputs at the JAX
    package's own bounds (tests/test_holo_forward_parity.py)."""
    tm = _golden_model()
    with torch.no_grad():
        preds = tm(_cams(), training=False, **_batch_kwargs())
        grid = tm.encode_eval(_cams()[1:], torch.from_numpy(GOLD["image_rgb"][1:]),
                              torch.from_numpy(GOLD["fg_probability"][1:]))
    np.testing.assert_allclose(preds["voxel_features"][0].numpy(), GOLD["eval_grid_denoised"], atol=1e-4)
    np.testing.assert_allclose(grid.numpy(), GOLD["eval_grid_denoised"], atol=1e-4)
    np.testing.assert_allclose(preds["images_render"].numpy(), GOLD["eval_image"], atol=1e-4)
    np.testing.assert_allclose(preds["depths_render"].numpy(), GOLD["eval_depth"], atol=1e-3)
    np.testing.assert_allclose(preds["masks_render"].numpy(), GOLD["eval_mask"], atol=1e-4)
    np.testing.assert_allclose(float(preds["loss_rgb_mse"]), float(GOLD["eval_rgb_mse"]), atol=1e-5)
    np.testing.assert_allclose(float(preds["objective"]), float(GOLD["eval_objective"]), atol=2e-5)


@pytest.mark.parametrize("case", ["adam_multistep", "adam_decay_clip", "sgd_exponential", "adam_groups_linexp"])
def test_optimizer_matches_optax(case):
    """Three steps of the port's optimizer and LR policy against the JAX
    package's optax chain on the same gradients: 1e-6 of the parameters
    (float32; clipping differs by torch's 1e-6 in the norm's denominator)."""
    import optax

    from holo_diffusion_tpu.train.optimizer import make_lr_schedule as j_sched
    from holo_diffusion_tpu.train.optimizer import make_optimizer as j_opt
    from holo_diffusion_torch.train.optimizer import make_lr_schedule

    kw, skw = {
        "adam_multistep": (dict(breed="Adam", lr=1e-2), dict(lr_policy="MultiStepLR", multistep_lr_milestones=(2,))),
        "adam_decay_clip": (dict(breed="Adam", lr=1e-2, weight_decay=0.1, clip_grad=0.5), dict()),
        "sgd_exponential": (dict(breed="SGD", lr=1e-1, momentum=0.8),
                            dict(lr_policy="Exponential", gamma=0.5, exponential_lr_step_size=2)),
        "adam_groups_linexp": (dict(breed="Adam", lr=1e-2, group_learning_rates={"second": 3e-2}),
                               dict(lr_policy="LinearExponential", linear_exponential_lr_milestone=2, max_epochs=6)),
    }[case]
    rs = np.random.RandomState(0)
    params = {"first": rs.randn(3, 4).astype(np.float32), "second": rs.randn(5).astype(np.float32)}
    grads = [{k: rs.randn(*v.shape).astype(np.float32) for k, v in params.items()} for _ in range(3)]
    tx = j_opt(**kw, schedule=j_sched(kw["lr"], **skw) if skw else None)
    jp, state = {k: jnp.asarray(v) for k, v in params.items()}, None
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_optimizer(tp.items(), **kw, schedule=make_lr_schedule(kw["lr"], **skw) if skw else None)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-6, err_msg=k)


def test_optimizer_args_match_jax_config():
    """The hydrant optimizer settings read as the JAX package reads them."""
    from holo_diffusion_tpu.config.config import load_config as j_load
    from holo_diffusion_tpu.config.config import optimizer_args_from_config as j_args
    from holo_diffusion_tpu.config.config import training_loop_args_from_config as j_loop
    from holo_diffusion_torch.config import load_config, optimizer_args_from_config

    t = optimizer_args_from_config(load_config("hydrant"))
    j = {**j_args(j_load("hydrant")), "clip_grad": j_loop(j_load("hydrant"))["clip_grad"]}
    for part in t.values():
        for k, v in part.items():
            if k != "max_epochs":
                assert v == (tuple(j[k]) if isinstance(j[k], list) else j[k]), k
    assert t["optimizer"]["lr"] == 4e-5 and t["schedule"]["multistep_lr_milestones"] == (500,)
