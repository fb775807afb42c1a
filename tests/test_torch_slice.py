"""The serving slice of the port as a whole, on the CPU: DDPM sampling with
injected noise, then renders of the sampled grid (chunked renderer, and the
model forward with its t=0 re-denoise), against the JAX package with the
same weights. Also: entry points refuse to run without CUDA unless asked for
the CPU, the port imports nothing of JAX, no kernel launch is counted on
the CPU, the config translation and the CLI."""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax.traverse_util import flatten_dict

from holo_diffusion_tpu.config.config import load_config as j_load_config
from holo_diffusion_tpu.config.config import model_args_from_config as j_model_args
from holo_diffusion_tpu.models import diffusion as jgd
from holo_diffusion_tpu.models.holo_model import HoloDiffusionModel as JModel
from holo_diffusion_tpu.render_eval import render_image_chunked as j_render_chunked
from holo_diffusion_tpu.utils.flyaround import simple_360_cameras as j_simple_360
from holo_diffusion_torch import cli
from holo_diffusion_torch.config import apply_dotted_overrides, load_config, model_args_from_config
from holo_diffusion_torch.data.synthetic import make_synthetic_scene
from holo_diffusion_torch.experiment import Experiment
from holo_diffusion_torch.geometry.cameras import PerspectiveCameras
from holo_diffusion_torch.models.holo_model import HoloDiffusionModel
from holo_diffusion_torch.ops import _build
from holo_diffusion_torch.render_eval import render_image_chunked
from holo_diffusion_torch.sampling import sample_random_voxel_features
from holo_diffusion_torch.utils.checkpoint_utils import load_experiment
from holo_diffusion_torch.utils.flyaround import render_flyaround, simple_360_cameras
from holo_diffusion_torch.weights import init_weights, save_weights, state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNET = dict(model_channels=32, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions=(2,))
TINY = dict(
    resol=8,
    volume_extent=4.0,
    feature_size=32,
    n_pts_per_ray_evaluation=8,
    n_pts_per_ray_fine_evaluation=8,
    render_image_height=8,
    render_image_width=8,
    scene_extent=2.0,
    chunk_size_grid=96,
    render_normals=True,
    diffusion_args=dict(num_steps=6, beta_start_unscaled=6e-7, beta_end_unscaled=1.2e-4),
    render_mlp_args=dict(dnet_hidden_dim=48, rnet_hidden_dim=16),
)
SHAPE = (1, 8, 8, 8, 32)


@pytest.fixture(scope="module")
def models():
    jm = JModel(**TINY, net_3d_args=dict(UNET, use_remat=False), view_pooler_enabled=False,
                fuse_decode="on")
    cam = j_simple_360(2, dist=4.5, up=(0.0, 1.0, 0.0))
    variables = jax.jit(lambda k, c, v: jm.init(k, camera=c, voxel_features=v, training=False))(
        jax.random.PRNGKey(0), cam[:1], jnp.zeros(SHAPE))
    flat = {k: np.asarray(v) for k, v in flatten_dict(variables["params"], sep="/").items()}
    tm = HoloDiffusionModel(**TINY, net_3d_args=UNET, view_pooler_enabled=False)
    tm.load_state_dict(state_dict_from_jax(flat), strict=True)
    tm.eval()
    return jm, variables, tm, cam


def _port_cam(jc):
    return PerspectiveCameras(*(torch.from_numpy(np.array(x)) for x in (jc.R, jc.T, jc.focal_length, jc.principal_point)))


def test_sample_then_render_matches_jax(models, tmp_path):
    """6 DDPM steps (all of the 6-step schedule) with the same injected
    noise, then chunked 8x8 renders of each side's grid (ragged: 64 rays in
    chunks of 12), and the forward path that re-denoises at t=0. Float32 on
    both sides, differences compound through the UNet steps and the
    two-pass render: 2e-4 on grids and images, 1e-3 on depths."""
    jm, variables, tm, cam = models
    rs = np.random.RandomState(0)
    x_T = rs.randn(*SHAPE).astype(np.float32)
    step_noise = [rs.randn(*SHAPE).astype(np.float32) for _ in range(6)]

    _build.reset_launch_counts()
    v_t = sample_random_voxel_features(
        tm, noise=torch.from_numpy(x_T), step_noise=[torch.from_numpy(n) for n in step_noise], device="cpu")
    net = jax.jit(lambda x, t: jm.apply(variables, x, t, method=JModel.apply_net_3d))
    sched = jgd.make_named_schedule_from_config(jm.diffusion_args)
    x = jnp.asarray(x_T)
    for t_scalar, n in zip(range(5, -1, -1), step_noise):
        x = jgd.p_sample(sched, net, x, jnp.full((1,), t_scalar, jnp.int32), None, noise=jnp.asarray(n))["sample"]
    v_j = np.asarray(jnp.clip(x, -1.0, 1.0))
    assert tuple(v_t.shape) == SHAPE
    np.testing.assert_allclose(v_t.numpy(), v_j, atol=2e-4)

    j_img = j_render_chunked(jm, variables, cam[1], jnp.asarray(v_j[0]))
    t_img = render_image_chunked(tm, _port_cam(cam)[1], v_t[0], device="cpu")
    assert set(t_img) == set(j_img)
    for k in j_img:
        np.testing.assert_allclose(t_img[k].numpy(), j_img[k], atol=1e-3 if k == "depths_render" else 2e-4)
    assert float(t_img["masks_render"].max()) > 0.01

    j_fwd = jax.jit(lambda v, c, g: jm.apply(v, camera=c, voxel_features=g, training=False))(
        variables, cam[1], jnp.asarray(v_j))
    with torch.no_grad():
        t_fwd = tm(_port_cam(cam)[1], torch.from_numpy(v_j.copy()))
    for k in ("images_render", "masks_render", "normals_render", "depths_render"):
        np.testing.assert_allclose(t_fwd[k].numpy(), np.asarray(j_fwd[k]),
                                   atol=1e-3 if k == "depths_render" else 2e-4)

    paths = render_flyaround(tm, str(tmp_path), n_flyaround_poses=2, voxel_features=v_t,
                             save_voxel_features=True, device="cpu")
    assert sorted(paths) == ["depths_render", "images_render", "masks_render", "shaded_depth_render"]
    assert len(os.listdir(paths["images_render"])) == 2 or paths["images_render"].endswith(".mp4")
    assert os.path.exists(tmp_path / "voxel_features.npy")
    # every launch path above took the plain version: no kernel on the CPU
    assert not any(_build.launch_counts().values())


def test_simple_360_cameras_match_jax():
    up = (-0.0396, -0.8306, -0.5554)
    j = j_simple_360(5, dist=15.0, up=up)
    t = simple_360_cameras(5, dist=15.0, up=up)
    np.testing.assert_allclose(t.R.numpy(), np.asarray(j.R), atol=1e-5)
    np.testing.assert_allclose(t.T.numpy(), np.asarray(j.T), atol=1e-4)


def test_entry_points_raise_without_cuda(models, tmp_path, monkeypatch):
    """No device given and no CUDA: raise, never fall back to the CPU."""
    _, _, tm, _ = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    grid = torch.zeros(SHAPE[1:])
    cam = simple_360_cameras(1)
    calls = [
        lambda: sample_random_voxel_features(tm, max_iter=1),
        lambda: render_image_chunked(tm, cam, grid),
        lambda: render_flyaround(tm, str(tmp_path), n_flyaround_poses=1, voxel_features=grid[None]),
        lambda: cli.generate_samples_main(["config=base", f"output_directory={tmp_path}"]),
        lambda: make_synthetic_scene(n_views=2, image_size=8),
        lambda: Experiment(load_config("synthetic_debug", [f"exp_dir={tmp_path}/exp"])),
        lambda: load_experiment(str(tmp_path / "exp")),
        lambda: cli.train_main(["--config-name", "synthetic_debug.yaml", "--max-epochs", "1",
                                f"exp_dir={tmp_path}/exp"]),
        lambda: cli.generate_samples_main([f"exp_dir={tmp_path}/exp"]),
        lambda: cli.visualize_reconstruction_main([f"exp_dir={tmp_path}/exp"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax():
    """An AST scan (sys.modules cannot tell: jax may be imported at startup)."""
    files = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "kernel_sweep.py")]
    for root, _, names in os.walk(os.path.join(REPO, "holo_diffusion_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for new in ("models/lpips.py", "models/inception.py", "evaluation_fid.py", "evaluate_samples.py",
                "utils/vis.py", "utils/profiling.py", "data/compact.py", "data/packing.py", "parallel/launch.py",
                "parallel/mesh.py", "parallel/collectives.py", "parallel/spatial.py", "models/unet_variants.py",
                "models/unet_gigagan.py", "import_reference_checkpoint.py", "rehearsal.py",
                "data/synthetic_co3d.py"):
        assert os.path.join(REPO, "holo_diffusion_torch", new) in files, new
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "holo_diffusion_tpu", "bench", "scripts")
    for path in files:
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in banned, f"{path} imports {mod}"


@pytest.mark.parametrize("config", ["base", "hydrant"])
def test_model_args_match_jax_config(config):
    """The port's copies of the YAMLs and its translator give the JAX
    translator's values for every key the port reads."""
    t = model_args_from_config(load_config(config))
    j = j_model_args(j_load_config(config))
    for k, v in t.items():
        if k == "net_3d_args":
            assert v == {kk: j[k][kk] for kk in v}
        elif k == "diffusion_args":
            assert v == {kk: j[k][kk] for kk in v}
        elif k == "net_3d_class_type":  # the port's key; JAX admits the UNet alone
            assert v == "SimpleUnet3D"
        else:
            assert v == j[k], k
    assert t["chunk_size_grid"] == (40960 if config == "hydrant" else 0)
    assert t["render_normals"] is (config == "hydrant")


def test_dotted_overrides():
    cfg = {"a": {"b": 1}, "seed": 0}
    apply_dotted_overrides(cfg, ["a.c=[1, 2]", "+new.x=true", "seed=3"])
    assert cfg == {"a": {"b": 1, "c": [1, 2]}, "new": {"x": True}, "seed": 3}
    with pytest.raises(ValueError, match="unknown config key"):
        apply_dotted_overrides(cfg, ["typo=1"])
    with pytest.raises(ValueError, match="not a dict"):
        apply_dotted_overrides(cfg, ["seed.x=1"])


def test_cli_on_cpu(tmp_path):
    """generate_samples_main end to end on a tiny config: weights from an
    .npz, 2 DDPM evaluations, a 2-pose fly-around at 6x6."""
    cfg = load_config("base")
    m = cfg["model_factory_ImplicitronModelFactory_args"]["model_HoloDiffusionModel_args"]
    m.update(resol=8, feature_size=32, chunk_size_grid=48)
    m["net_3d_SimpleUnet3D_args"].update(model_channels=32, channel_mult=[1, 2], attention_resolutions=[2],
                                         num_res_blocks=1)
    m["implicit_function_HoloVoxelGridImplicitFunction_args"]["render_mlp_args"] = dict(
        dnet_hidden_dim=32, rnet_hidden_dim=16)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    model = cli.build_model(str(path))
    save_weights(init_weights(model, seed=5), str(tmp_path / "w.npz"))
    out = cli.generate_samples_main([
        f"config={path}", f"weights={tmp_path / 'w.npz'}", "device=cpu", "max_iter=2",
        "n_flyaround_poses=2", "render_size=[6,6]", f"output_directory={tmp_path / 'out'}",
        "save_voxel_features=true",
    ])
    assert list(out) == ["sample_00000"]
    v = np.load(tmp_path / "out" / "sample_00000" / "voxel_features.npy")
    assert v.shape == (1, 8, 8, 8, 32) and np.isfinite(v).all() and np.abs(v).max() <= 1.0
