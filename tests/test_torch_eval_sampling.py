"""Evaluation sampling of the port (holo_diffusion_torch/models/holo_model.py:
`stratified_point_sampling_evaluation` and `sampling_mode_evaluation:
mask_sample`) against the JAX package's `HoloDiffusionModel` on the CPU: the
evaluation forward of one scene (pool the sources, render the target,
score it) with the JAX model's weights and the draws JAX takes from its
evaluation key, injected by name. Then the port's validation epoch with
mask-sampled evaluation, which draws from a generator.

Tolerances: ray lengths and pixel positions 1e-5; renders 2e-4 on images and
masks and 1e-3 on depths (the chunked renders' tolerances,
tests/test_torch_slice.py); the objective and the view metrics 1e-4, the
depth metrics 1e-3 as the depths they average. One metric is left out in
full-grid mode: `loss*_depth_abs` counts a ray where its bilinearly sampled
target depth is > 0, and at a pixel centre beside the mask the outside
neighbour's weight is zero only up to rounding; compiled by XLA it comes out
a few ulps above zero and JAX counts one pixel more than eager arithmetic
does (the port, and JAX's own function called eagerly). The same error on
the mask's rays, `loss*_depth_abs_fg`, is compared, and `depth_abs` in the
mask_sample cases."""
import os
import sys

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

sys.path.insert(0, os.path.dirname(__file__))

from test_evaluation import TINY  # noqa: E402
from torch_tiny_config import LOOP, MODEL, tiny_cfg  # noqa: E402

from holo_diffusion_torch.experiment import Experiment  # noqa: E402
from holo_diffusion_torch.geometry.cameras import PerspectiveCameras  # noqa: E402
from holo_diffusion_torch.models.holo_model import HoloDiffusionModel  # noqa: E402
from holo_diffusion_torch.weights import state_dict_from_jax  # noqa: E402
from holo_diffusion_tpu.data import make_synthetic_scene as j_make_scene  # noqa: E402
from holo_diffusion_tpu.models.holo_model import HoloDiffusionModel as JModel  # noqa: E402

N_RAYS = 24
CASES = {
    "full_grid_stratified": dict(sampling_mode_evaluation="full_grid", stratified_point_sampling_evaluation=True),
    "mask_sample": dict(sampling_mode_evaluation="mask_sample", stratified_point_sampling_evaluation=False),
    "mask_sample_stratified": dict(sampling_mode_evaluation="mask_sample", stratified_point_sampling_evaluation=True),
}


@pytest.fixture(scope="module")
def weights():
    """The JAX evaluator test's tiny model (pooler, no denoiser), its
    weights as the port's state_dict, and a 4-view scene at 12 px."""
    js = j_make_scene(n_views=4, image_size=12)
    jm = JModel(**TINY)
    variables = jax.jit(lambda k, s: jm.init(k, camera=s.camera, image_rgb=s.image_rgb, fg_probability=s.fg_probability,
                                             mask_crop=s.mask_crop, training=False))(jax.random.PRNGKey(0), js)
    sd = state_dict_from_jax(flatten_dict(jax.device_get(variables["params"]), sep="/"),
                             flatten_dict(jax.device_get(variables["batch_stats"]), sep="/"))
    return variables, sd, js


def _draws(key, case, n_pts, n_fine):
    """JAX's evaluation draws for one target (holo_model.py: key -> (pool,
    denoise, render); render -> (rays, passes); mask sampling: rays ->
    (pixels, lengths), else the lengths from the rays key; the second pass's
    refinement from passes -> (passes, refine))."""
    _, _, rng_render = jax.random.split(key, 3)
    rng_rays, rng_passes = jax.random.split(rng_render)
    mask_sample = CASES[case]["sampling_mode_evaluation"] == "mask_sample"
    n_rays = N_RAYS if mask_sample else TINY["render_image_height"] * TINY["render_image_width"]
    draws = {}
    rng_len = rng_rays
    if mask_sample:
        rng_pix, rng_len = jax.random.split(rng_rays)
        draws["ray_pixel_u"] = np.asarray(jax.random.uniform(rng_pix, (1, n_rays)))
    if CASES[case]["stratified_point_sampling_evaluation"]:
        draws["ray_length_u"] = np.asarray(jax.random.uniform(rng_len, (1, n_rays, n_pts)))
        _, refine = jax.random.split(rng_passes)
        draws["refine_u_1"] = np.asarray(jax.random.uniform(refine, (1, n_rays, n_fine)))
    return draws


@pytest.mark.parametrize("case", list(CASES))
def test_evaluation_forward_matches_jax(case, weights):
    variables, sd, js = weights
    args = {**TINY, **CASES[case], "n_rays_per_image": N_RAYS}
    jm = JModel(**args)
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda v, s, k: jm.apply(
        v, camera=s.camera, image_rgb=s.image_rgb, fg_probability=s.fg_probability, mask_crop=s.mask_crop,
        depth_map=s.depth_map, training=False, rng=k))(variables, js, key)
    tm = HoloDiffusionModel(**args)
    tm.load_state_dict(sd, strict=True)
    tm.eval()
    cam = PerspectiveCameras(*(torch.from_numpy(np.array(getattr(js.camera, f)))
                               for f in ("R", "T", "focal_length", "principal_point")))
    batch = {f: torch.from_numpy(np.array(getattr(js, f)))
             for f in ("image_rgb", "fg_probability", "mask_crop", "depth_map")}
    draws = _draws(key, case, args["n_pts_per_ray_evaluation"], args["n_pts_per_ray_fine_evaluation"])
    with torch.no_grad():
        got = tm(cam, training=False, draws=draws, **batch)

    for f in ("xys", "lengths"):
        np.testing.assert_allclose(getattr(got["ray_bundle"], f).numpy(), np.asarray(getattr(want["ray_bundle"], f)),
                                   atol=1e-5, err_msg=f)
    for k in ("images_render", "masks_render", "depths_render"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-3 if k == "depths_render" else 2e-4,
                                   err_msg=k)
    metrics = [k for k in want if (k.startswith("loss_") or k == "objective")
               and not (k.endswith("depth_abs") and case == "full_grid_stratified")]
    assert "loss_rgb_mse" in metrics
    for k in metrics:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-3 if "depth" in k else 1e-4, err_msg=k)
    # the draws changed the render: stratified lengths are not the grid's
    if CASES[case]["stratified_point_sampling_evaluation"]:
        lengths = got["ray_bundle"].lengths[0, 0]
        assert float(torch.diff(lengths).std()) > 1e-4
    if case == "mask_sample":
        with pytest.raises(ValueError, match="no value for the draw 'ray_pixel_u'"):
            tm(cam, training=False, draws={}, **batch)


def test_validation_epoch_with_mask_sampled_stratified_evaluation(tmp_path):
    """The port's loop: a validation epoch with mask-sampled, stratified
    evaluation draws from its own generator, the same on a second run."""
    extra = ["disable_validation=false", LOOP + "visualize_interval=0",
             MODEL + "sampling_mode_evaluation=mask_sample",
             MODEL + "raysampler_AdaptiveRaySampler_args.stratified_point_sampling_evaluation=true"]
    vals = []
    for run in ("a", "b"):
        _, stats = Experiment(tiny_cfg(tmp_path / run, extra), device="cpu").run(max_epochs=1)
        vals.append(stats.history[-1]["val"]["loss_rgb_psnr"])
    assert np.isfinite(vals[0]) and vals[0] == vals[1]
