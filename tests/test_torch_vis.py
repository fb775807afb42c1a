"""The training loop's outputs in the port (holo_diffusion_torch/utils/vis.py,
utils/profiling.py, their wiring in `Experiment.run`) against the JAX
package's: `feats_to_rgb` with JAX's projection injected (1e-6),
`image_grid` exactly, `visualize_preds`' files and pixels, the dashboard's
payload on the same Stats history, the stats PDF, the profiler's traces,
the denoising video, and a tiny run to one checkpoint with validation,
visualizations, the denoising video and `profile` on, which leaves
train_stats.pdf, dashboard.html, the PNGs and a trace where the JAX loop
writes them (JAX experiment.py:593-723)."""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import copy
import json
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_slice import SHAPE, TINY, UNET  # noqa: E402
from torch_tiny_config import LOOP, tiny_cfg  # noqa: E402

from holo_diffusion_torch import experiment as texp  # noqa: E402
from holo_diffusion_torch.experiment import Experiment  # noqa: E402
from holo_diffusion_torch.models.holo_model import HoloDiffusionModel  # noqa: E402
from holo_diffusion_torch.render_eval import render_image_chunked  # noqa: E402
from holo_diffusion_torch.sampling import sample_random_voxel_features_progressive  # noqa: E402
from holo_diffusion_torch.train.stats import Stats  # noqa: E402
from holo_diffusion_torch.utils import profiling as tp  # noqa: E402
from holo_diffusion_torch.utils import vis as tv  # noqa: E402
from holo_diffusion_torch.utils.flyaround import simple_360_cameras  # noqa: E402
from holo_diffusion_torch.weights import init_weights  # noqa: E402
from holo_diffusion_tpu.train.stats import Stats as JStats  # noqa: E402
from holo_diffusion_tpu.utils import vis as jv  # noqa: E402

RGB_TOL = 1e-6


def test_feats_to_rgb_matches_jax_with_its_projection():
    f = np.random.RandomState(0).randn(5, 6, 32).astype(np.float32)
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(42), (32, 3), jnp.float32))
    want = np.asarray(jv.feats_to_rgb(jnp.asarray(f)))
    got = tv.feats_to_rgb(torch.from_numpy(f), proj=torch.from_numpy(w.copy())).numpy()
    np.testing.assert_allclose(got, want, atol=RGB_TOL, rtol=0)
    own = tv.feats_to_rgb(torch.from_numpy(f))  # the port's own seeded projection
    assert own.shape == (5, 6, 3) and float(own.min()) >= 0.0 and float(own.max()) <= 1.0
    assert torch.equal(own, tv.feats_to_rgb(torch.from_numpy(f)))


@pytest.mark.parametrize("n", [1, 5, 8, 11])
def test_image_grid_matches_jax(n):
    imgs = np.random.RandomState(n).rand(n, 4, 6, 3).astype(np.float32)
    np.testing.assert_array_equal(tv.image_grid(imgs), jv.image_grid(imgs))
    np.testing.assert_array_equal(tv.image_grid(imgs, pad=1, max_cols=3), jv.image_grid(imgs, pad=1, max_cols=3))


def _read_png(path):
    return np.asarray(Image.open(path).convert("RGB"))


def test_visualize_preds_matches_jax(tmp_path):
    """The same files, pixel for pixel, for renders, masks and depths (one
    channel scaled by its maximum); a diffusion_x_t grid's slice too (its
    projection is each package's own, so only its file is compared)."""
    rs = np.random.RandomState(1)
    preds = {"images_render": rs.rand(2, 6, 5, 3).astype(np.float32),
             "masks_render": rs.rand(2, 6, 5, 1).astype(np.float32),
             "depths_render": 3 * rs.rand(2, 6, 5, 1).astype(np.float32),
             "diffusion_x_t": rs.randn(1, 4, 4, 4, 8).astype(np.float32),
             "objective": np.float32(1.0)}
    want = jv.visualize_preds(preds, str(tmp_path / "jax"), "val", 3)
    got = tv.visualize_preds({k: torch.from_numpy(np.asarray(v)) for k, v in preds.items()},
                             str(tmp_path / "port"), "val", 3)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert os.path.basename(got[-1]) == "val_00000003_x_t.png"
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(_read_png(g), _read_png(w))
    assert _read_png(got[-1]).shape == _read_png(want[-1]).shape == (4, 4, 3)


def _history():
    st = Stats()
    for e in range(3):
        st.new_epoch()
        st.update({"objective": 1.0 / (e + 1), "loss_rgb_psnr": 10.0 + e}, "train")
        st.update({"loss_rgb_psnr": 9.0 + e}, "val")
        st.finalize_epoch()
    return st


def _payload(path):
    line = next(ln for ln in open(path).read().splitlines() if ln.startswith("const D = "))
    return json.loads(line[len("const D = "):-1])


def test_dashboard_payload_matches_jax(tmp_path):
    st = _history()
    jst = JStats()
    jst.history = copy.deepcopy(st.history)
    for d in ("port", "jax"):
        os.makedirs(tmp_path / d / "visuals")
        for i in range(10):
            (tmp_path / d / "visuals" / f"val_{i:08d}_images_render.png").write_bytes(b"")
        (tmp_path / d / "visuals" / "zz_notes.txt").write_text("x")
    got = tv.write_dashboard_html(st, str(tmp_path / "port"))
    want = jv.write_dashboard_html(jst, str(tmp_path / "jax"))
    assert os.path.basename(got) == os.path.basename(want) == "dashboard.html"
    assert _payload(got) == _payload(want)
    assert len(_payload(got)["images"]) == 7  # the last 8 entries, PNGs only
    html = open(got).read()
    assert "polyline" in html and "loss_rgb_psnr" in html and "objective" in html


def test_stats_pdf(tmp_path):
    path = tv.plot_stats_pdf(_history(), str(tmp_path / "out" / "train_stats.pdf"))
    assert open(path, "rb").read(5) == b"%PDF-"
    assert tv.plot_stats_pdf(Stats(), str(tmp_path / "empty.pdf")) is None


def _traces(d):
    return [f for f in os.listdir(d) if f.endswith(".json")] if os.path.isdir(d) else []


def test_profiler_traces(tmp_path):
    """Dispatches 1..n_steps traced, dispatch 0 not; a single-dispatch epoch
    still leaves a trace; `profile_trace` traces a block; the Timer."""
    x = torch.ones(64)
    prof = tp.SteadyStateProfiler(str(tmp_path / "a"), n_steps=2)
    for it in range(4):
        prof.before_dispatch(it)
        x = x * 1.5
        prof.after_dispatch(it, {"x": x})
        assert bool(_traces(tmp_path / "a")) == (it >= 2)
    prof.finish(x)
    assert len(_traces(tmp_path / "a")) == 1
    events = json.load(open(tmp_path / "a" / _traces(tmp_path / "a")[0]))["traceEvents"]
    assert any("mul" in e.get("name", "") for e in events)
    single = tp.SteadyStateProfiler(str(tmp_path / "b"))
    single.before_dispatch(0)
    single.after_dispatch(0, x)
    single.finish(x)
    assert len(_traces(tmp_path / "b")) == 1
    with tp.profile_trace(str(tmp_path / "c")):
        torch.ones(3).sum()
    assert len(_traces(tmp_path / "c")) == 1
    tp.Timer.reset()
    with tp.Timer("x", sync_value=x):
        pass
    assert set(tp.Timer.averages()) == {"x"}


def test_denoising_video_frames(tmp_path):
    """One frame every `steps_per_frame` DDPM steps, each the chunked render
    of that step's grid."""
    model = init_weights(HoloDiffusionModel(**TINY, net_3d_args=UNET, view_pooler_enabled=False), seed=3).eval()
    rs = np.random.RandomState(4)
    x_T = torch.from_numpy(rs.randn(*SHAPE).astype(np.float32))
    noise = [torch.from_numpy(rs.randn(*SHAPE).astype(np.float32)) for _ in range(6)]
    cam = simple_360_cameras(1, dist=4.5)
    out = tv.denoising_video(model, str(tmp_path / "d.mp4"), cam, steps_per_frame=4, noise=x_T, step_noise=noise,
                             device="cpu")
    frames = sorted(os.listdir(out)) if os.path.isdir(out) else None
    if frames is None:  # ffmpeg joined them; the frames stay beside the video
        frames = sorted(os.listdir(tmp_path / "d_frames"))
    assert frames == ["frame_00000.png", "frame_00001.png"]
    chain = list(sample_random_voxel_features_progressive(model, noise=x_T, step_noise=noise, device="cpu"))
    want = render_image_chunked(model, cam, chain[4][0], device="cpu")["images_render"].numpy()
    want = (np.clip(want, 0.0, 1.0) * 255).astype(np.uint8)
    np.testing.assert_array_equal(_read_png(tmp_path / "d_frames" / "frame_00001.png"), want)


def _files(root):
    return sorted(os.path.relpath(os.path.join(r, f), root) for r, _, fs in os.walk(root) for f in fs)


def test_loop_writes_its_outputs(tmp_path, caplog):
    """The repair of the loop that wrote no train_stats.pdf or
    dashboard.html: one epoch with validation, visualizations every epoch,
    the denoising video and `profile` (2 dispatches traced of 2); the files
    lie where the JAX loop writes them."""
    exp_dir = tmp_path / "exp"
    cfg = tiny_cfg(exp_dir, ["disable_validation=false", LOOP + "visualize_interval=1",
                             "visualize_denoising_video=true", LOOP + "profile=true", LOOP + "profile_steps=2"])
    Experiment(cfg, device="cpu").run(max_epochs=1)
    files = _files(exp_dir)
    for want in ("train_stats.pdf", "dashboard.html", "visuals/val_00000000_images_render.png",
                 "visuals/val_00000000_masks_render.png", "visuals/val_00000000_depths_render.png",
                 "visuals/denoising_00000000_frames/frame_00000.png"):
        assert want in files, (want, files)
    assert open(exp_dir / "train_stats.pdf", "rb").read(5) == b"%PDF-"
    traces = _traces(exp_dir / "traces")
    assert len(traces) == 1 and os.path.getsize(exp_dir / "traces" / traces[0]) > 0
    assert _payload(exp_dir / "dashboard.html")["images"] == [
        f"visuals/val_00000000_{k}_render.png" for k in ("depths", "images", "masks")]


def test_loop_plot_warns_only_for_a_missing_matplotlib(tmp_path, monkeypatch, caplog):
    """A missing matplotlib costs the PDF and the dashboard with a warning,
    as in the JAX loop; any other ImportError is raised."""
    def no_matplotlib(*_):
        raise ModuleNotFoundError("No module named 'matplotlib'", name="matplotlib")

    monkeypatch.setattr(texp, "plot_stats_pdf", no_matplotlib)
    with caplog.at_level(logging.WARNING, logger="holo_diffusion_torch.experiment"):
        Experiment(tiny_cfg(tmp_path / "a"), device="cpu").run(max_epochs=1)
    assert "stats plot failed" in caplog.text
    assert not (tmp_path / "a" / "dashboard.html").exists()

    def broken(*_):
        raise ImportError("cannot import name 'x'", name="numpy")

    monkeypatch.setattr(texp, "plot_stats_pdf", broken)
    with pytest.raises(ImportError, match="cannot import name"):
        Experiment(tiny_cfg(tmp_path / "b"), device="cpu").run(max_epochs=1)
