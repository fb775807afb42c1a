"""DiT-3D (`holo_diffusion_torch/models/dit3d.py`) on the CPU at a tiny size
(hidden 48, depth 2, 4 heads, patch 2, an 8^3 x 8 grid, batch 2) against the
benchmark's plain reference (`benchmark/reference/net3d_DiT3D.py`), with
seeded random weights that redraw every leaf, adaLN-Zero's zeros included:
the forward and every leaf's gradient; the state dict's names and shapes
and the sin-cos table outside it; the yaml's translation, and the refusal
of an unknown class type, an unknown key and the windowed attention; the
training step (`parallel/train_step.py`) and DDPM steps (`sampling.py`)
with the DiT against the reference's; the routes, spans and counters;
spatial sharding refusing a DiT by name; and one epoch through the training
CLI, then sampling and a fly-around from its exp_dir. The JAX package has
no DiT, so no JAX here."""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import math
import os

import numpy as np
import pytest
import torch

from holo_diffusion_torch.config import load_config, model_args_from_config
from holo_diffusion_torch.models import dit3d
from holo_diffusion_torch.models.dit3d import DiT3D
from holo_diffusion_torch.models.holo_model import HoloDiffusionModel
from holo_diffusion_torch.utils.profiling import counters, reset_counters

TINY = dict(hidden_size=48, depth=2, num_heads=4, patch_size=2, mlp_ratio=4.0)
XL2 = dict(hidden_size=1152, depth=28, num_heads=16, patch_size=2, mlp_ratio=4.0)
R, C, B = 8, 8, 2
SEED = 2 ** 31 + 2626
CONFIG = "hydrant_g32c128_dit3d_xl2"
MODEL = "model_factory_ImplicitronModelFactory_args.model_HoloDiffusionModel_args."
# the tiny model as a yaml override of the XL/2 configuration
TINY_OVERRIDES = [MODEL + f"resol={R}", MODEL + f"feature_size={C}", MODEL + "view_pooler_enabled=false"] + [
    MODEL + f"net_3d_DiT3D_args.{k}={v}" for k, v in TINY.items()]


def _reference():
    from benchmark.reference import net3d_plugin

    return net3d_plugin("reference", "DiT3D")


def _pair(seed=SEED):
    """The program's DiT and the reference's, loaded with one state dict
    made by the benchmark's weights from `seed` (every leaf redrawn)."""
    from benchmark.harness.weights import make_state_dict, shapes_of

    ref = _reference().build(C, TINY)
    sd = make_state_dict(shapes_of(ref), seed, "cpu")
    ref.load_state_dict(sd, strict=True)
    net = DiT3D(in_channels=C, input_size=R, **TINY)
    net.load_state_dict(sd, strict=True)
    return net, ref, sd


def _inputs(seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, R, R, R, C, generator=g), torch.tensor([999, 37])


def _counted(fn):
    """fn()'s result and the counters it added while a profiler recorded."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        reset_counters()
        out = fn()
        got = counters()
    return out, got, prof


def test_forward_and_every_gradient_match_the_reference():
    net, ref, sd = _pair()
    assert all(v.abs().sum() > 0 for k, v in sd.items() if "adaLN_modulation" in k or "final_layer" in k)
    x, t = _inputs()
    got, want = net(x, t), ref(x, t)
    assert got.shape == x.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    w = torch.randn(got.shape, generator=torch.Generator().manual_seed(3))
    (got * w).sum().backward()
    (want * w).sum().backward()
    ref_grads = dict(ref.named_parameters())
    for name, p in net.named_parameters():
        g, r = p.grad, ref_grads[name].grad
        assert r.norm() > 0, name
        assert (g - r).norm() <= 1e-4 * r.norm(), (name, float((g - r).norm() / r.norm()))


def test_state_dict_names_and_shapes_are_the_references():
    net, ref, _ = _pair()
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert "pos_embed" not in got and "pos_embed" in dict(net.named_buffers())
    d, p = TINY["hidden_size"], TINY["patch_size"]
    assert got["x_embedder.proj.weight"] == (d, C, p, p, p)
    assert got["blocks.1.adaLN_modulation.1.weight"] == (6 * d, d)
    assert got["final_layer.linear.weight"] == (p ** 3 * C, d)
    with torch.device("meta"):
        xl = DiT3D()
    assert sum(v.numel() for v in xl.state_dict().values()) == 675_986_560


def _sincos_numpy(dim, grid):
    """DiT-3D's get_3d_sincos_pos_embed, in numpy: a third of the width an
    axis, [sin | cos] of pos * 10000^(-2i / (dim / 3)), tokens by the 'ij'
    mesh of the three axes."""
    def one(d, pos):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    g = np.arange(grid, dtype=np.float32)
    mesh = np.stack(np.meshgrid(g, g, g, indexing="ij"), axis=0).reshape(3, -1)
    return np.concatenate([one(dim // 3, mesh[i]) for i in range(3)], axis=1)


@pytest.mark.parametrize("dim, grid", [(48, 4), (1152, 16)])
def test_sincos_table_is_its_formula(dim, grid):
    want = _sincos_numpy(dim, grid)
    np.testing.assert_allclose(dit3d.sincos_table_3d(dim, grid).numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(_reference().sincos_positions(dim, grid, "cpu").numpy(), want, atol=1e-6, rtol=0)


def test_construction_keeps_adaln_zero():
    """DiT's initialisation: every adaLN modulation and the final linear
    zero, so a new DiT predicts 0; `init_weights` keeps those zeros."""
    from holo_diffusion_torch.weights import init_weights

    torch.manual_seed(0)
    net = DiT3D(in_channels=C, input_size=R, **TINY)
    zero = [k for k, v in net.state_dict().items() if not v.any()]
    assert sorted(zero) == sorted(
        [f"blocks.{i}.adaLN_modulation.1.{w}" for i in range(2) for w in ("weight", "bias")]
        + [f"final_layer.{m}.{w}" for m in ("adaLN_modulation.1", "linear") for w in ("weight", "bias")]
        + ["x_embedder.proj.bias", "t_embedder.mlp.0.bias", "t_embedder.mlp.2.bias"]
        + [f"blocks.{i}.{m}.bias" for i in range(2) for m in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")])
    x, t = _inputs()
    assert not net(x, t).any()
    init_weights(net, seed=4)
    assert not net(x, t).any()
    assert net.blocks[0].attn.qkv.weight.any()


def test_yaml_translates_to_xl2_and_builds_a_dit():
    args = model_args_from_config(load_config(CONFIG))
    assert (args["resol"], args["feature_size"]) == (32, 128)
    assert args["net_3d_class_type"] == "DiT3D" and args["net_3d_args"] == XL2
    model = HoloDiffusionModel(**model_args_from_config(load_config(CONFIG, TINY_OVERRIDES)))
    assert isinstance(model.net_3d, DiT3D)
    assert len(model.net_3d.blocks) == 2 and model.net_3d.grid == R // 2
    assert model_args_from_config(load_config("hydrant_g32c128"))["net_3d_class_type"] == "SimpleUnet3D"


@pytest.mark.parametrize("override, error, match", [
    (MODEL + "net_3d_class_type=DiT3DWindowed", NotImplementedError, "DiT3DWindowed"),
    (MODEL + "net_3d_DiT3D_args.learn_sigma=true", ValueError, "learn_sigma"),
    (MODEL + "net_3d_DiT3D_args.window_size=4", NotImplementedError, "windowed attention"),
    (MODEL + "net_3d_DiT3D_args.window_block_indexes=[0,3]", NotImplementedError, "windowed attention"),
], ids=["class_type", "unknown_key", "window_size", "window_block_indexes"])
def test_translation_refuses(override, error, match):
    with pytest.raises(error, match=match):
        model_args_from_config(load_config(CONFIG, [override]))


def test_model_refuses_an_unknown_denoiser():
    with pytest.raises(NotImplementedError, match="NoSuchNet"):
        HoloDiffusionModel(resol=R, feature_size=C, view_pooler_enabled=False, net_3d_class_type="NoSuchNet")


def test_forward_refuses_another_grid():
    net = DiT3D(in_channels=C, input_size=R, **TINY)
    with pytest.raises(ValueError, match="grids"):
        net(torch.zeros(1, 2 * R, 2 * R, 2 * R, C), torch.tensor([3]))


def test_plain_attention_is_the_softmax_of_the_scores():
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(2, 3, 10, 12, generator=g) for _ in range(3))
    want = torch.empty_like(q)
    for b in range(2):
        for h in range(3):
            s = q[b, h] @ k[b, h].T / math.sqrt(12)
            want[b, h] = torch.softmax(s, dim=-1) @ v[b, h]
    (got, counted, _) = _counted(lambda: dit3d.attention(q, k, v))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert counted == {"dit_attn_plain": 1}


def test_spans_and_counters_of_a_forward():
    net, _, _ = _pair()
    x, t = _inputs()
    with torch.no_grad():
        _, counted, prof = _counted(lambda: net(x, t))
    assert counted == {"dit_forwards": 1, "dit_attn_plain": 2}
    names = [e.name for e in prof.events()]
    assert [names.count(s) for s in ("holo.dit", "holo.dit.attn", "holo.dit.mlp")] == [1, 2, 2]


def test_training_steps_match_the_reference():
    """The benchmark's configuration of this DiT cut to its tiny size (an 8^3
    x 32 grid, hidden 48) with 2 frames of 32^2: three program training steps
    (`make_train_step`, Adam) against the reference from the same weights,
    batches and draws, by the training cell's readings, at the CPU's
    float32 tolerances; every DiT leaf moves on both sides."""
    from benchmark.harness.kinds import train
    from benchmark.harness.manifest import Manifest
    from benchmark.harness.program import Context
    from benchmark.tests.tiny import tiny_program_config

    conf = Manifest().config(CONFIG)
    conf["program_config"] = tiny_program_config(conf["program_config"], 1)
    conf["data"] = {"frames": 2, "image_size": 32}
    mix = {"kind": "train", "pool_batches": 3, "check_steps": 3, "trace_units": 3}
    cell = train.Cell(Context(conf, mix, {}, SEED, torch.device("cpu")))
    assert cell.ctx.spec.net_3d == TINY
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        reset_counters()
        cell.setup()
        counted = counters()
    assert isinstance(cell.model.net_3d, DiT3D)
    passes = counted["dit_forwards"]
    assert 3 <= passes <= 6 and counted["dit_attn_plain"] == 2 * passes and "dit_attn_fused" not in counted
    cell.release()
    ref = cell.reference_run()
    tol = {"loss1_gap": 1e-5, "loss_gap": 1e-5, "grad_gap": 1e-4, "grad_median_gap": 1e-4, "change_gap": 1e-3,
           "change_median_gap": 1e-3}
    readings = cell.readings(cell.program_record(), ref)
    for name, value in readings.items():
        assert math.isfinite(value) and value <= tol[name], (name, value)
    dit_leaves = [k for k in cell.change if k.startswith("net_3d.")]
    assert len(dit_leaves) == len(dict(DiT3D(in_channels=32, input_size=R, **TINY).named_parameters()))
    assert all(cell.change[k] > 0 and ref["change"][k] > 0 for k in dit_leaves)


def test_ddpm_steps_match_the_reference_p_sample():
    """Three DDPM steps (t 999, 998, then 0) through `sampling.py` with the
    DiT against the reference's `p_sample` from the same x_T and noise."""
    from benchmark.reference import diffusion as rdiff
    from holo_diffusion_torch.models import diffusion as gd
    from holo_diffusion_torch.sampling import sample_random_voxel_features

    net, ref, sd = _pair()
    model = HoloDiffusionModel(**model_args_from_config(load_config(CONFIG, TINY_OVERRIDES)))
    model.net_3d.load_state_dict(sd, strict=True)
    g = torch.Generator().manual_seed(11)
    shape = (1, R, R, R, C)
    x_t, step_noise = torch.randn(shape, generator=g), [torch.randn(shape, generator=g) for _ in range(3)]
    got = sample_random_voxel_features(model.eval(), max_iter=3, noise=x_t, step_noise=step_noise, device="cpu")
    sched = rdiff.Schedule(1000, 1e-4, 0.02, "cpu")
    x = x_t
    with torch.no_grad():
        for t, n in zip(gd.ddpm_timesteps(1000, 3), step_noise):
            x = rdiff.p_sample(sched, ref, x, torch.tensor([t]), n)["sample"]
    assert gd.ddpm_timesteps(1000, 3) == [999, 998, 0]
    torch.testing.assert_close(got, torch.clamp(x, -1.0, 1.0), rtol=1e-5, atol=1e-5)


def test_spatial_sharding_refuses_a_dit_by_name():
    from holo_diffusion_torch.parallel.spatial import make_sharded_denoiser

    model = HoloDiffusionModel(**model_args_from_config(load_config(CONFIG, TINY_OVERRIDES)))
    for target in (model, model.net_3d):
        with pytest.raises(NotImplementedError, match="DiT3D"):
            make_sharded_denoiser(target, None)


def test_train_cli_then_sample_and_render_with_a_dit(tmp_path):
    """The port's entry points with the DiT as the denoiser: `cli.train_main`
    (Experiment's loop) one epoch on the tiny synthetic config, then
    `cli.generate_samples_main` from its exp_dir: DDPM steps through
    `sampling.py` and a fly-around through `render_eval.py`."""
    from holo_diffusion_torch import cli
    from holo_diffusion_torch.utils.checkpoint_utils import load_experiment
    from torch_tiny_config import MODEL as M
    from torch_tiny_config import TINY_OVERRIDES as SYNTHETIC

    exp_dir = str(tmp_path / "dit")
    dit = [M + "net_3d_class_type=DiT3D", M + "net_3d_DiT3D_args={" + ", ".join(f"{k}: {v}" for k, v in TINY.items())
           + "}"]
    state, stats = cli.train_main(["--config-name", "synthetic_debug.yaml", "--device", "cpu", "--max-epochs", "1",
                                   f"exp_dir={exp_dir}", *SYNTHETIC, *dit])
    assert isinstance(state.model.net_3d, DiT3D) and state.step == 2
    _, restored = load_experiment(exp_dir, device="cpu")
    assert isinstance(restored.model.net_3d, DiT3D)
    out = str(tmp_path / "samples")
    results = cli.generate_samples_main([
        f"exp_dir={exp_dir}", "device=cpu", "num_samples=1", "n_flyaround_poses=1", "render_size=[16,16]",
        "max_iter=3", f"output_directory={out}", "save_voxel_features=true"])
    assert set(results["sample_00000"]) == {"images_render", "masks_render", "depths_render", "shaded_depth_render"}
    grid = np.load(os.path.join(out, "sample_00000", "voxel_features.npy"))
    assert grid.shape == (1, 4, 4, 4, 32) and np.isfinite(grid).all() and np.abs(grid).max() <= 1.0
