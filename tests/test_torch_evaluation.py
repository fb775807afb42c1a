"""Novel-view evaluation of the port (holo_diffusion_torch/evaluation.py,
`Experiment.run_eval_only`, test evaluation in `Experiment.run`) against the
JAX package's on the CPU: SSIM, camera difficulty and its bins on the same
numpy inputs; `evaluate_new_view_synthesis` at 24 px on a two-scene set
with the JAX model's weights carried across (`weights.state_dict_from_jax`),
in both protocols (seeded random targets, and eval batches with the target
at row 0); then the JSON the loop's evaluations write.

Tolerances: SSIM is the same float64 numpy code on both sides, 1e-12 on the
same images; on rendered images, which differ by float32 rounding, PSNR
within 1e-3 dB, SSIM within 1e-5, depth error within 1e-4 and camera
difficulty within 1e-6, with every bin's membership exact."""
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

sys.path.insert(0, os.path.dirname(__file__))

from test_evaluation import TINY  # noqa: E402
from torch_tiny_config import LOOP, tiny_cfg, tiny_co3d_cfg  # noqa: E402

from holo_diffusion_torch import evaluation as ev  # noqa: E402
from holo_diffusion_torch.data.frame_data import FrameData  # noqa: E402
from holo_diffusion_torch.data.synthetic_co3d import write_synthetic_co3d  # noqa: E402
from holo_diffusion_torch.experiment import Experiment  # noqa: E402
from holo_diffusion_torch.geometry.cameras import PerspectiveCameras  # noqa: E402
from holo_diffusion_torch.models.holo_model import HoloDiffusionModel  # noqa: E402
from holo_diffusion_torch.utils.checkpoint_utils import load_experiment  # noqa: E402
from holo_diffusion_torch.weights import state_dict_from_jax  # noqa: E402
from holo_diffusion_tpu import evaluation as jev  # noqa: E402
from holo_diffusion_tpu.data import make_synthetic_scene as j_make_scene  # noqa: E402
from holo_diffusion_tpu.models.holo_model import HoloDiffusionModel as JHoloDiffusionModel  # noqa: E402

PSNR_TOL, SSIM_TOL, DEPTH_TOL, DIFFICULTY_TOL = 1e-3, 1e-5, 1e-4, 1e-6
CO3D_EVAL = "data_source_ImplicitronDataSource_args.dataset_map_provider_JsonIndexDatasetMapProviderV2_args."


def _port_scene(js):
    """A JAX FrameData's numbers as the port's FrameData."""
    cam = PerspectiveCameras(*(torch.from_numpy(np.array(getattr(js.camera, f)))
                               for f in ("R", "T", "focal_length", "principal_point")))
    return FrameData(cam, *(None if getattr(js, f) is None else torch.from_numpy(np.array(getattr(js, f)))
                            for f in ("image_rgb", "fg_probability", "mask_crop", "depth_map")))


def test_ssim_matches_jax():
    rs = np.random.RandomState(0)
    for shape in [(24, 24, 3), (8, 8, 3), (30, 17, 1)]:
        a = rs.rand(*shape).astype(np.float32)
        b = np.clip(a + 0.2 * rs.randn(*shape), 0, 1).astype(np.float32)
        assert ev.ssim(a, b) == pytest.approx(jev.ssim(a, b), abs=1e-12)
        assert ev.ssim(a, a) == pytest.approx(1.0, abs=1e-5)
    assert ev.ssim(a, b) < 0.9


def test_camera_difficulty_and_bins_match_jax():
    js = j_make_scene(n_views=6, image_size=8)
    ts = _port_scene(js)
    for target, sources in [(0, None), (0, [1, 2]), (3, [0, 5]), (5, [4])]:
        assert ev.camera_difficulty(ts, target, sources) == pytest.approx(
            jev.camera_difficulty(js, target, sources), abs=DIFFICULTY_TOL)
    for breaks in [(0.97, 0.98), (0.5, 0.9)]:
        assert ev.camera_difficulty_bin_edges(breaks) == jev.camera_difficulty_bin_edges(breaks)


@pytest.fixture(scope="module")
def tiny_models():
    """The JAX evaluator test's tiny model (no denoiser) and the port's with
    its weights, and a two-scene set of 5 views at 24 px."""
    jscenes = [j_make_scene(n_views=5, image_size=24, seed=i) for i in range(2)]
    jm = JHoloDiffusionModel(**TINY)
    s0 = jscenes[0]
    variables = jax.jit(lambda key, cam, img, fg, mc: jm.init(
        key, camera=cam, image_rgb=img, fg_probability=fg, mask_crop=mc, training=False, rng=None))(
        jax.random.PRNGKey(0), s0.camera, s0.image_rgb, s0.fg_probability, s0.mask_crop)
    sd = state_dict_from_jax(flatten_dict(jax.device_get(variables["params"]), sep="/"),
                             flatten_dict(jax.device_get(variables["batch_stats"]), sep="/"))
    tm = HoloDiffusionModel(**TINY)
    tm.load_state_dict(sd, strict=True)
    tm.eval()
    return jm, variables, tm, jscenes, [_port_scene(s) for s in jscenes]


EVAL_KW = dict(n_source_views=3, n_eval_targets_per_seq=2, seed=5)


@pytest.fixture(scope="module")
def jax_results(tiny_models):
    """The JAX evaluator's results in both protocols."""
    jm, variables, _, jscenes, _ = tiny_models
    return {"random_targets": jev.evaluate_new_view_synthesis(jm, variables, jscenes, **EVAL_KW),
            "eval_batches": jev.evaluate_new_view_synthesis(jm, variables, [], eval_batches=jscenes, **EVAL_KW)}


@pytest.mark.parametrize("protocol", ["random_targets", "eval_batches"])
def test_evaluate_new_view_synthesis_matches_jax(protocol, tiny_models, jax_results, tmp_path):
    _, _, tm, _, tscenes = tiny_models
    want = jax_results[protocol]
    if protocol == "eval_batches":
        got = ev.evaluate_new_view_synthesis(tm, [], eval_batches=tscenes, device="cpu",
                                             dump_path=str(tmp_path / "e.json"), **EVAL_KW)
    else:
        got = ev.evaluate_new_view_synthesis(tm, tscenes, device="cpu", dump_path=str(tmp_path / "e.json"),
                                             **EVAL_KW)
    assert got["protocol"] == want["protocol"] == protocol
    assert got["n_evals"] == want["n_evals"] == (2 if protocol == "eval_batches" else 4)
    assert set(got) == set(want)
    for r, w in zip(got["records"], want["records"]):
        assert set(r) == set(w)
        assert (r["seq"], r["target"], r["lpips"]) == (w["seq"], w["target"], None)
        assert r["difficulty"] == pytest.approx(w["difficulty"], abs=DIFFICULTY_TOL)
        assert r["psnr"] == pytest.approx(w["psnr"], abs=PSNR_TOL)
        assert r["psnr_fg"] == pytest.approx(w["psnr_fg"], abs=PSNR_TOL)
        assert r["ssim"] == pytest.approx(w["ssim"], abs=SSIM_TOL)
        assert r["mask_iou"] == w["mask_iou"]
        assert r["depth_abs_fg"] == pytest.approx(w["depth_abs_fg"], abs=DEPTH_TOL)
    for name, agg in want["per_bin"].items():  # the same records in each bin
        assert set(got["per_bin"][name]) == set(agg), name
        for k, v in agg.items():
            assert got["per_bin"][name][k] == pytest.approx(v, abs=PSNR_TOL), (name, k)
    assert json.load(open(tmp_path / "e.json")).keys() == want.keys()


def test_evaluation_times_its_phases(tiny_models):
    _, _, tm, _, tscenes = tiny_models
    timings = {}
    res = ev.evaluate_new_view_synthesis(tm, tscenes[:1], n_eval_targets_per_seq=2, device="cpu", timings=timings)
    assert sorted(timings) == ["metrics_s", "pool_s", "render_s"]
    assert all(len(v) == res["n_evals"] == 2 for v in timings.values())


def test_evaluation_scores_uint8_frames_as_float(tiny_models):
    """Frames in the CO3D cache's storage (uint8 image and mask) are scored
    as their float values."""
    _, _, tm, _, tscenes = tiny_models
    s = tscenes[0]
    q = FrameData(s.camera, (s.image_rgb * 255).round().to(torch.uint8),
                  (s.fg_probability * 255).round().to(torch.uint8), s.mask_crop, s.depth_map)
    f = FrameData(s.camera, q.image_rgb.float() / 255, q.fg_probability.float() / 255, s.mask_crop, s.depth_map)
    a = ev.evaluate_new_view_synthesis(tm, [q], device="cpu")
    b = ev.evaluate_new_view_synthesis(tm, [f], device="cpu")
    assert a["records"] == b["records"]


def _jax_result_keys(jax_results):
    want = jax_results["random_targets"]
    return set(want), set(want["records"][0])


def test_run_eval_only_with_and_without_ema_writes_jax_keys(jax_results, tmp_path):
    keys, rec_keys = _jax_result_keys(jax_results)
    cfg = tiny_cfg(tmp_path / "exp", ["ema_rate=0.5"])
    Experiment(cfg, device="cpu").run(max_epochs=1)
    results = {}
    for use_ema in (False, True):
        res = Experiment(tiny_cfg(tmp_path / "exp", ["ema_rate=0.5"]), device="cpu").run_eval_only(use_ema=use_ema)
        dumped = json.load(open(tmp_path / "exp" / "eval_results_epoch_00000000.json"))
        assert set(dumped) == keys and set(dumped["records"][0]) == rec_keys
        assert dumped["n_evals"] == res["n_evals"] > 0 and np.isfinite(res["overall"]["psnr"])
        results[use_ema] = res
    # the EMA lags the trained weights, so its renders differ
    assert results[True]["records"] != results[False]["records"]
    # eval_use_ema in the config, through run() with eval_only
    res = Experiment(tiny_cfg(tmp_path / "exp", ["ema_rate=0.5", "eval_use_ema=true", LOOP + "eval_only=true"]),
                     device="cpu").run()
    assert res["records"] == results[True]["records"]
    # an EMA evaluation of a run without one raises
    Experiment(tiny_cfg(tmp_path / "plain"), device="cpu").run(max_epochs=1)
    with pytest.raises(ValueError, match="no EMA"):
        Experiment(tiny_cfg(tmp_path / "plain"), device="cpu").run_eval_only(use_ema=True)


def test_test_evaluation_in_run_writes_jax_keys(jax_results, tmp_path):
    keys, rec_keys = _jax_result_keys(jax_results)
    exp = Experiment(tiny_cfg(tmp_path / "exp", ["disable_testing=false", LOOP + "test_interval=1",
                                                  LOOP + "test_when_finished=true"]), device="cpu")
    exp.run(max_epochs=2)
    names = sorted(n for n in os.listdir(exp.exp_dir) if n.startswith("eval"))
    assert names == ["eval_epoch_00000000.json", "eval_epoch_00000001.json", "eval_final.json"]
    for n in names:
        dumped = json.load(open(os.path.join(exp.exp_dir, n)))
        assert set(dumped) == keys and set(dumped["records"][0]) == rec_keys
        # the first 4 eval scenes (the tiny val split holds 1), 2 targets each
        assert dumped["n_evals"] == 2 and dumped["protocol"] == "random_targets"
    # off by default (disable_testing: true)
    quiet = Experiment(tiny_cfg(tmp_path / "quiet", [LOOP + "test_interval=1"]), device="cpu")
    quiet.run(max_epochs=1)
    assert not [n for n in os.listdir(quiet.exp_dir) if n.startswith("eval")]


def test_eval_only_uses_dataset_eval_batches(tmp_path):
    """With load_eval_batches the evaluator takes the dataset's eval batches
    (target first), as the JAX test of the same name."""
    root = str(tmp_path / "data")
    cat = write_synthetic_co3d(root, n_seq=2, n_frames=6, H=120, W=160, seed=7, n_val_frames=1,
                               n_known_per_eval_batch=3)
    exp = Experiment(tiny_co3d_cfg(tmp_path / "eb", root, cat, [
        CO3D_EVAL + "load_eval_batches=true", CO3D_EVAL + "n_known_frames_for_test=1",
        CO3D_EVAL + "dataset_JsonIndexDataset_args.image_height=24",
        CO3D_EVAL + "dataset_JsonIndexDataset_args.image_width=24", LOOP + "eval_only=true"]), device="cpu")
    assert len(exp.data.eval_batches) == 2
    res = exp.run()
    assert res["protocol"] == "eval_batches" and res["n_evals"] == 2
    assert np.isfinite(res["overall"]["psnr"])
    assert exp.data.get_eval_batch(0).batch_size == 5


def test_lpips_weights_raise_naming_their_item(tmp_path):
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md §1 item 6\b"):
        Experiment(tiny_cfg(tmp_path / "exp", ["lpips_vgg_weights_path=/nonexistent/vgg.pth"]), device="cpu")


def test_evaluation_entry_points_raise_without_cuda(tiny_models, tmp_path, monkeypatch):
    """No device given and no CUDA: raise, never fall back to the CPU."""
    _, _, tm, _, tscenes = tiny_models
    Experiment(tiny_cfg(tmp_path / "exp", ["ema_rate=0.5"]), device="cpu").run(max_epochs=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: ev.evaluate_new_view_synthesis(tm, tscenes),
                 lambda: load_experiment(str(tmp_path / "exp"), use_ema=True),
                 lambda: Experiment(tiny_cfg(tmp_path / "exp", [LOOP + "eval_only=true"])).run()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
