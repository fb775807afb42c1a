"""The fly-around of the port (holo_diffusion_torch/utils/flyaround.py,
sampling.sample_random_voxel_features_progressive, cli.generate_samples_main
and cli.visualize_reconstruction_main) against the JAX package's, on the CPU,
with the JAX models' weights carried across: fitted trajectories, every
stream of sample mode (normals on and off, with the empty-space skip),
progressive sampling with JAX's draws injected in its split order,
reconstruction mode through the chunked renderer and through the forward;
then both CLIs end to end on tiny checkpoints.

Frames are compared as the floats handed to the video writer. Tolerances:
cameras 1e-5; frames 2e-4 on images and masks, 1e-3 on the depth streams
and the shaded depth (the depth is the chunked render's, which the serving
slice holds at 1e-3: tests/test_torch_slice.py); progressive frames 1e-3,
their grids going through float32 UNet steps on both sides (2e-4 there); the
pooled grid of reconstruction mode 1e-4, as tests/test_torch_pooling.py
holds it."""
import os
import struct
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from holo_diffusion_torch import cli
from holo_diffusion_torch.data.frame_data import FrameData
from holo_diffusion_torch.geometry.cameras import PerspectiveCameras
from holo_diffusion_torch.models.holo_model import HoloDiffusionModel
from holo_diffusion_torch.models.metrics import preprocess_input
from holo_diffusion_torch.sampling import sample_random_voxel_features
from holo_diffusion_torch.utils import flyaround as tfa
from holo_diffusion_torch.weights import state_dict_from_jax
from holo_diffusion_tpu.data import make_synthetic_scene as j_make_scene
from holo_diffusion_tpu.models.holo_model import HoloDiffusionModel as JModel
from holo_diffusion_tpu.models.metrics import preprocess_input as j_preprocess_input
from holo_diffusion_tpu.utils import flyaround as jfa

sys.path.insert(0, os.path.dirname(__file__))
from torch_tiny_config import MODEL, tiny_cfg  # noqa: E402

# the JAX fly-around tests' model (tests/test_flyaround.py TINY)
BASE = dict(
    resol=4, volume_extent=3.0, feature_size=32, n_train_target_views=1, n_pts_per_ray_evaluation=8,
    n_pts_per_ray_fine_evaluation=4, render_image_height=12, render_image_width=12, scene_extent=1.2,
    diffusion_args=dict(num_steps=6, beta_start_unscaled=6e-7, beta_end_unscaled=1.2e-4),
    render_mlp_args=dict(dnet_hidden_dim=16, rnet_hidden_dim=16),
)
UNET = dict(model_channels=32, num_res_blocks=1, channel_mult=(1,), attention_resolutions=())
EXTRACTOR = dict(name_arch="resnet18", stages=(1,), proj_dim=4, image_rescale=0.5)
# one set of weights for both modes: a denoiser, the pooler and a
# normals-rendering decoder; reconstruction mode switches diffusion and the
# normals off (as unet_with_no_diffusion.yaml on base.yaml)
SAMPLE = dict(BASE, chunk_size_grid=48, render_normals=True, image_feature_extractor_args=EXTRACTOR)
RECON = dict(SAMPLE, diffusion_enabled=False, enable_bootstrap=False, render_normals=False)
STREAMS = {"images_render", "masks_render", "depths_render", "shaded_depth_render"}
SHAPE = (1, 4, 4, 4, 32)


def _sd(variables):
    return state_dict_from_jax(
        flatten_dict(jax.device_get(variables["params"]), sep="/"),
        flatten_dict(jax.device_get(variables["batch_stats"]), sep="/") if "batch_stats" in variables else None)


def _port_cam(jc):
    return PerspectiveCameras(*(torch.from_numpy(np.array(getattr(jc, f)))
                                for f in ("R", "T", "focal_length", "principal_point")))


def _port_scene(js):
    return FrameData(_port_cam(js.camera), *(torch.from_numpy(np.array(getattr(js, f)))
                                             for f in ("image_rgb", "fg_probability", "mask_crop", "depth_map")))


@pytest.fixture(scope="module")
def models():
    """The JAX model's weights (one init) in both packages' sample-mode
    models, and a 5-view synthetic scene for reconstruction."""
    js = j_make_scene(n_views=5, image_size=12)
    jm = JModel(**SAMPLE, net_3d_args=dict(UNET, use_remat=False))
    variables = jax.jit(lambda k, s: jm.init(k, camera=s.camera, image_rgb=s.image_rgb, fg_probability=s.fg_probability,
                                             mask_crop=s.mask_crop, training=False))(jax.random.PRNGKey(0), js)
    sd = _sd(variables)
    return jm, variables, sd, js


def _pair(sd, **changes):
    """The JAX and the port's model with `changes` to SAMPLE, same weights."""
    args = {**SAMPLE, **changes}
    tm = HoloDiffusionModel(**args, net_3d_args=UNET)
    tm.load_state_dict(sd, strict=True)
    return JModel(**args, net_3d_args=dict(UNET, use_remat=False)), tm.eval()


class _Capture:
    """A video writer that keeps each stream's float frames."""

    def __init__(self, store):
        self.store = store

    def __call__(self, out_path, fps=20, **_):
        key = os.path.basename(out_path)[:-len(".mp4")]
        store = self.store

        class Writer:
            def write_frame(self, frame):
                store.setdefault(key, []).append(np.array(frame, np.float32))

            def get_video(self):
                return key

        return Writer()


def _frames(monkeypatch, module, fn):
    store = {}
    monkeypatch.setattr(module, "VideoWriter", _Capture(store))
    fn()
    return store


def _assert_frames(got, want, image_tol=2e-4, depth_tol=1e-3):
    assert set(got) == set(want) == STREAMS
    for k in STREAMS:
        assert len(got[k]) == len(want[k])
        for i, (g, w) in enumerate(zip(got[k], want[k])):
            assert g.shape == w.shape, k
            tol = image_tol if k in ("images_render", "masks_render") else depth_tol
            np.testing.assert_allclose(g, w, atol=tol, err_msg=f"{k} frame {i}")


@pytest.mark.parametrize("trajectory", tfa.TRAJECTORIES)
def test_fitted_trajectory_cameras_match_jax(trajectory):
    train = jfa.simple_360_cameras(12, dist=4.0, elevation=20.0)
    want = jfa.fitted_trajectory_cameras(train, n_poses=7, trajectory_type=trajectory)
    got = tfa.fitted_trajectory_cameras(_port_cam(train), n_poses=7, trajectory_type=trajectory)
    for f in ("R", "T", "focal_length", "principal_point"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), atol=1e-5, err_msg=f)
    with pytest.raises(ValueError, match="unknown trajectory"):
        tfa.fitted_trajectory_cameras(_port_cam(train), trajectory_type="spiral")


@pytest.mark.parametrize("variant", ["normals", "no_normals", "normals_skip"])
def test_sample_mode_streams_match_jax(variant, models, monkeypatch, tmp_path):
    """A given grid along a 2-pose orbit: the four streams, the shaded depth
    from the rendered normals (hydrant) or from the depth by gradients."""
    _, variables, sd, _ = models
    jm, tm = _pair(sd, render_normals=variant != "no_normals")
    grid = np.tanh(np.random.RandomState(5).randn(*SHAPE) * 2.0).astype(np.float32)
    kw = dict(n_flyaround_poses=2, trajectory_distance=4.0, empty_space_skip=variant == "normals_skip")
    want = _frames(monkeypatch, jfa, lambda: jfa.render_flyaround(
        jm, variables, str(tmp_path / "j"), voxel_features=jnp.asarray(grid), **kw))
    got = _frames(monkeypatch, tfa, lambda: tfa.render_flyaround(
        tm, str(tmp_path / "t"), voxel_features=torch.from_numpy(grid), device="cpu", **kw))
    _assert_frames(got, want)
    assert np.ptp(got["shaded_depth_render"][0]) > 0.05


def test_progressive_mode_matches_jax(models, monkeypatch, tmp_path):
    """3 poses, 2 DDPM steps a pose, of the 6-step schedule; the port gets
    the draws JAX takes for seed 0 (render_flyaround: key -> (key, sample
    key); the generator: sample key -> (key, init key), x_T from the init
    key, then key -> (key, step key) a step)."""
    _, variables, sd, _ = models
    jm, tm = _pair(sd)
    _, sample_rng = jax.random.split(jax.random.PRNGKey(0))
    rng, rng_init = jax.random.split(sample_rng)
    x_T = np.array(jax.random.normal(rng_init, SHAPE))
    step_noise = []
    for _ in range(6):
        rng, step_rng = jax.random.split(rng)
        step_noise.append(torch.from_numpy(np.array(jax.random.normal(step_rng, SHAPE))))
    kw = dict(n_flyaround_poses=3, trajectory_distance=4.0, progressive_sampling_steps_per_render=2)
    want = _frames(monkeypatch, jfa, lambda: jfa.render_flyaround(jm, variables, str(tmp_path / "j"), **kw))
    got = _frames(monkeypatch, tfa, lambda: tfa.render_flyaround(
        tm, str(tmp_path / "t"), sample_noise=torch.from_numpy(x_T), sample_step_noise=step_noise,
        device="cpu", save_voxel_features=True, **kw))
    _assert_frames(got, want, image_tol=1e-3)
    # the poses show successive states of the chain: 1, 3 and 5 steps in
    assert np.abs(got["images_render"][0] - got["images_render"][2]).max() > 1e-3
    v = np.load(tmp_path / "t" / "voxel_features.npy")
    assert v.shape == SHAPE and np.abs(v).max() <= 1.0


@pytest.mark.parametrize("renderer", ["chunked", "forward"])
def test_reconstruction_mode_matches_jax(renderer, models, monkeypatch, tmp_path):
    """3 of 5 source views chosen by the seed, pooled once, rendered along a
    circle fitted to the scene's cameras: through the chunked renderer (the
    pooled grid as it is) or the forward (the UNet at t=0, then tanh)."""
    _, variables, sd, js = models
    jm, tm = _pair(sd, **{k: v for k, v in RECON.items() if SAMPLE.get(k) != v},
                   chunk_size_grid=48 if renderer == "chunked" else 0)
    ts = _port_scene(js)
    sel = tfa.source_view_indices(ts.batch_size, 3, seed=4)
    assert list(sel) == list(np.random.RandomState(4).choice(5, size=3, replace=False))
    src = js[jnp.asarray(sel)]
    img, fg, _ = j_preprocess_input(src.image_rgb, src.fg_probability, None, True, True, 0.5, (1.0, 1.0, 1.0))
    j_grid = jax.jit(lambda v, *a: jm.apply(v, *a, method=JModel.pool_features))(
        variables, img, src.camera, fg, src.mask_crop)
    tsrc = ts[torch.as_tensor(sel)]
    timg, tfg, _ = preprocess_input(tsrc.image_rgb, tsrc.fg_probability, None, True, True, 0.5, (1.0, 1.0, 1.0))
    with torch.no_grad():
        t_grid = tm.pool_features(timg, tsrc.camera, tfg, tsrc.mask_crop)
    np.testing.assert_allclose(t_grid.numpy(), np.asarray(j_grid), atol=1e-4)

    kw = dict(sample_mode=False, n_flyaround_poses=2, n_source_views=3, trajectory_type="circular_lsq_fit", seed=4)
    want = _frames(monkeypatch, jfa, lambda: jfa.render_flyaround(jm, variables, str(tmp_path / "j"), scene=js, **kw))
    got = _frames(monkeypatch, tfa, lambda: tfa.render_flyaround(tm, str(tmp_path / "t"), scene=ts, device="cpu", **kw))
    _assert_frames(got, want)
    assert float(np.mean(got["masks_render"][0])) > 0.01


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Tiny synthetic experiments trained 1 epoch on the CPU: a diffusion
    model, and a reconstruction model without diffusion (as
    unet_with_no_diffusion.yaml)."""
    from holo_diffusion_torch.experiment import Experiment

    root = tmp_path_factory.mktemp("ckpts")
    dirs = {}
    for name, extra in (("diffusion", []), ("recon", [MODEL + "diffusion_enabled=false",
                                                       MODEL + "enable_bootstrap=false"])):
        dirs[name] = str(root / name)
        Experiment(tiny_cfg(dirs[name], extra), device="cpu").run(max_epochs=1)
    return dirs


def _png_size(stream_dir):
    """(height, width) from the first frame's PNG header."""
    with open(os.path.join(stream_dir, "frame_00000.png"), "rb") as f:
        w, h = struct.unpack(">II", f.read(24)[16:24])
    return h, w


def test_generate_samples_cli_at_the_jax_defaults(checkpoints, tmp_path):
    """exp_dir= takes the JAX CLI's defaults (3 samples at 256^2);
    progressive sampling with the skip; 2 grids a sampling call, the second
    sample's grid the call's second; a non-diffusion checkpoint refused."""
    exp_dir = checkpoints["diffusion"]
    out = tmp_path / "prog"
    res = cli.generate_samples_main([f"exp_dir={exp_dir}", "device=cpu", "n_flyaround_poses=1",
                                     "progressive_sampling_steps_per_render=3", "empty_space_skip=true",
                                     f"output_directory={out}"])
    assert sorted(res) == ["sample_00000", "sample_00001", "sample_00002"]
    assert all(set(r) == STREAMS for r in res.values())
    assert _png_size(res["sample_00002"]["shaded_depth_render"]) == (256, 256)

    out = tmp_path / "batched"
    res = cli.generate_samples_main([f"exp_dir={exp_dir}", "device=cpu", "num_samples=2", "n_flyaround_poses=1",
                                     "render_size=[8,8]", "sample_batch_size=2", "save_voxel_features=true",
                                     f"output_directory={out}"])
    from holo_diffusion_torch.utils.checkpoint_utils import load_experiment

    model = load_experiment(exp_dir, device="cpu")[1].model.eval()
    both = sample_random_voxel_features(model, torch.Generator().manual_seed(0), n_samples=2, device="cpu")
    for i in range(2):
        np.testing.assert_array_equal(np.load(out / f"sample_{i:05d}" / "voxel_features.npy"), both[i:i + 1].numpy())
    with pytest.raises(ValueError, match="needs a diffusion model"):
        cli.generate_samples_main([f"exp_dir={checkpoints['recon']}", "device=cpu"])


def test_visualize_reconstruction_cli(checkpoints, tmp_path):
    out = tmp_path / "recon"
    res = cli.visualize_reconstruction_main([
        f"exp_dir={checkpoints['recon']}", "device=cpu", "n_flyaround_poses=2", "render_size=[16,16]",
        "n_eval_sequences=1", "n_source_views=3", "trajectory_type=trefoil_knot", "empty_space_skip=true",
        f"output_directory={out}"])
    assert list(res) == ["sequence_000"] and set(res["sequence_000"]) == STREAMS
    assert _png_size(res["sequence_000"]["images_render"]) == (16, 16)
    assert len(os.listdir(res["sequence_000"]["images_render"])) == 2
    with pytest.raises(ValueError, match="needs a non-diffusion model"):
        cli.visualize_reconstruction_main([f"exp_dir={checkpoints['diffusion']}", "device=cpu"])
    with pytest.raises(ValueError, match="unknown args"):
        cli.visualize_reconstruction_main([f"exp_dir={checkpoints['recon']}", "device=cpu", "num_samples=2"])
