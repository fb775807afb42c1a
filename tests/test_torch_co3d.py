"""The port's CO3Dv2 data path against the JAX package's, on the CPU, on
small release-format trees (2 sequences of 6 frames at 48 x 64, written by
both packages' synthetic writers, and hand-made frames):

  - the writer: a frame's pixels bitwise JAX's for the same pose and draws;
    the tree's annotations, set lists and eval batches equal (R and T to
    1e-6: the packages' look-at trigonometry differs by a float32 ulp),
    masks and JPEG bytes identical, depths within one float16 ulp (that ulp
    of T moves the rounding of a depth to float16 on a pixel or two);
  - annotations, set lists, eval batches and `get_eval_batch` rows exactly;
    `_to_isotropic_ndc` and `crop_intrinsics` to 1e-6; `mask_bbox` and
    `expand_bbox` exactly;
  - `load_frame_data` on a square box (the native crop/resize: bitwise) and
    on a padded, non-square one (image and mask within 1 level, depth
    bitwise), and the pixel projection through crop, pad and resize;
  - the selection knobs, the LRU cache, the decode pool, the frame order
    `sample_batch` draws for a seed (the same frames as JAX's);
  - a tiny `Experiment.run` on a CO3D tree, with resume, and the hydrant
    config with the CO3D provider.
"""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import gzip
import json
import logging
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.dirname(__file__))

from test_co3d_convention import FOCAL_NDC, OUT, PP_NDC, _extrinsics, _project_px_pytorch3d  # noqa: E402
from test_co3d_convention import _write_dataset as _write_convention_frame  # noqa: E402
from torch_tiny_config import tiny_co3d_cfg  # noqa: E402

from holo_diffusion_torch.config import audit_unconsumed_keys, load_config  # noqa: E402
from holo_diffusion_torch.data import co3d as tco3d  # noqa: E402
from holo_diffusion_torch.data.source import epoch_loader  # noqa: E402
from holo_diffusion_torch.data.synthetic_co3d import write_synthetic_co3d as t_write  # noqa: E402
from holo_diffusion_torch.experiment import Experiment  # noqa: E402
from holo_diffusion_torch.geometry.cameras import project_points_ndc  # noqa: E402
from holo_diffusion_torch.train.checkpoint import list_checkpoints  # noqa: E402
from holo_diffusion_tpu.data import co3d as jco3d  # noqa: E402
from holo_diffusion_tpu.data.synthetic_co3d import write_synthetic_co3d as j_write  # noqa: E402

H, W, N_SEQ, N_FRAMES = 48, 64, 2, 6
CAM_TOL = 1e-6  # R, T, focal, principal point: float32 rounding of the same formulas
FIELDS = ("image_rgb", "fg_probability", "mask_crop", "depth_map")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same tree written by the JAX package's writer and by the port's."""
    roots = {}
    for name, write in (("jax", j_write), ("torch", t_write)):
        root = str(tmp_path_factory.mktemp(f"co3d_{name}"))
        assert write(root, n_seq=N_SEQ, n_frames=N_FRAMES, H=H, W=W, seed=3) == "synthball"
        roots[name] = root
    return roots


def _providers(root, **kw):
    args = dict(category="synthball", dataset_root=root, image_height=24, image_width=24, **kw)
    return tco3d.CO3DDataProvider(**args), jco3d.CO3DDataProvider(**args)


def _levels(a):
    a = np.asarray(a)
    return a.astype(np.int64) if a.dtype == np.uint8 else np.round(a.astype(np.float64) * 255).astype(np.int64)


def _assert_frames_match(t, j, exact_image=False):
    """A port frame batch against JAX's: cameras to CAM_TOL; image within
    1 level (0 where `exact_image`); mask within 1 level; mask_crop and
    depth bitwise; sequence ids equal."""
    for f in ("R", "T", "focal_length", "principal_point"):
        np.testing.assert_allclose(getattr(t.camera, f).numpy(), np.asarray(getattr(j.camera, f)),
                                   rtol=0, atol=CAM_TOL, err_msg=f)
    for f in FIELDS:
        a, b = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
    img = np.abs(_levels(t.image_rgb.numpy()) - _levels(j.image_rgb)).max()
    assert img <= (0 if exact_image else 1), img
    assert np.abs(_levels(t.fg_probability.numpy()) - _levels(j.fg_probability)).max() <= 1
    np.testing.assert_array_equal(t.mask_crop.numpy(), np.asarray(j.mask_crop))
    np.testing.assert_array_equal(t.depth_map.numpy(), np.asarray(j.depth_map))
    np.testing.assert_array_equal(t.sequence_id.numpy(), np.asarray(j.sequence_id))


# ---- the writer and the annotation files


def test_writer_renders_jax_pixels():
    """For the same pose and generator state, the port's sphere frame is
    JAX's, bitwise (image, mask, depth) and leaves the generator in the
    same state."""
    from holo_diffusion_torch.data.synthetic_co3d import _render_sphere_frame as t_render
    from holo_diffusion_tpu.data.synthetic_co3d import _render_sphere_frame as j_render

    T = np.array([0.07, -0.11, 4.3], np.float32)
    focal, pp = np.array([2.05, 2.05]), np.array([0.03, -0.02])
    rt, rj = np.random.RandomState(9), np.random.RandomState(9)
    for a, b in zip(t_render(T, focal, pp, 90, 120, 1.3, rt), j_render(np.eye(3), T, focal, pp, 90, 120, 1.3, rj)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert rt.randint(1 << 30) == rj.randint(1 << 30)


def test_writer_tree_matches_jax(trees):
    cat = "synthball"
    with gzip.open(os.path.join(trees["torch"], cat, "frame_annotations.jgz"), "rt") as f:
        ta = json.load(f)
    with gzip.open(os.path.join(trees["jax"], cat, "frame_annotations.jgz"), "rt") as f:
        ja = json.load(f)
    assert len(ta) == len(ja) == N_SEQ * N_FRAMES
    for t, j in zip(ta, ja):
        for k in ("R", "T"):
            np.testing.assert_allclose(t["viewpoint"].pop(k), j["viewpoint"].pop(k), rtol=0, atol=CAM_TOL)
        assert t == j
    for rel in ("set_lists/set_lists_fewview_dev.json", "eval_batches/eval_batches_fewview_dev.json"):
        with open(os.path.join(trees["torch"], cat, rel)) as f, open(os.path.join(trees["jax"], cat, rel)) as g:
            assert json.load(f) == json.load(g), rel
    for a in ta:
        for key in ("image", "mask", "depth"):
            rel = a[key]["path"]
            with Image.open(os.path.join(trees["torch"], rel)) as p, Image.open(os.path.join(trees["jax"], rel)) as q:
                assert p.mode == q.mode and p.size == q.size == (W, H)
                pa, qa = np.asarray(p), np.asarray(q)
            if key == "depth":  # float16 bits: at most one ulp apart
                assert np.abs(pa.astype(np.int64) - qa.astype(np.int64)).max() <= 1, rel
                np.testing.assert_allclose(pa.view(np.float16), qa.view(np.float16), rtol=2 ** -10, atol=0)
            else:
                np.testing.assert_array_equal(pa, qa, err_msg=rel)
        img = a["image"]["path"]
        assert open(os.path.join(trees["torch"], img), "rb").read() == open(os.path.join(trees["jax"], img), "rb").read()


def test_annotations_set_lists_and_eval_batches_match_jax(trees):
    cat_root = os.path.join(trees["jax"], "synthball")
    tf, jf = tco3d.load_frame_annotations(cat_root), jco3d.load_frame_annotations(cat_root)
    assert len(tf) == len(jf)
    for t, j in zip(tf, jf):
        for k, v in vars(j).items():
            if isinstance(v, np.ndarray):
                assert getattr(t, k).dtype == v.dtype
                np.testing.assert_array_equal(getattr(t, k), v, err_msg=k)
            else:
                assert getattr(t, k) == v, k
    assert tco3d.load_set_lists(cat_root, "fewview_dev") == jco3d.load_set_lists(cat_root, "fewview_dev")
    assert tco3d.load_eval_batches_file(cat_root, "fewview_dev") == jco3d.load_eval_batches_file(cat_root, "fewview_dev")
    assert tco3d.load_eval_batches_file(cat_root, "nope") is None


@pytest.mark.parametrize("fmt", ["ndc_isotropic", "ndc_norm_image_bounds"])
def test_isotropic_ndc_and_crop_intrinsics_match_jax(fmt):
    rs = np.random.RandomState(0)
    for _ in range(20):
        hw = tuple(int(v) for v in rs.randint(20, 1500, 2))
        focal, pp = rs.uniform(0.5, 4, 2), rs.uniform(-0.3, 0.3, 2)
        for a, b in zip(tco3d._to_isotropic_ndc(focal, pp, hw, fmt), jco3d._to_isotropic_ndc(focal, pp, hw, fmt)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        x0, y0 = int(rs.randint(0, hw[1] // 2)), int(rs.randint(0, hw[0] // 2))
        box = (x0, y0, int(rs.randint(x0 + 1, hw[1] + 1)), int(rs.randint(y0 + 1, hw[0] + 1)))
        f32 = focal.astype(np.float32), pp.astype(np.float32)
        for a, b in zip(tco3d.crop_intrinsics(*f32, hw, box), jco3d.crop_intrinsics(*f32, hw, box)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_mask_bbox_and_expand_bbox_match_jax():
    rs = np.random.RandomState(1)
    for _ in range(30):
        mask = np.zeros((37, 53), np.float32)
        y0, x0 = rs.randint(0, 30), rs.randint(0, 45)
        mask[y0:y0 + rs.randint(1, 8), x0:x0 + rs.randint(1, 9)] = rs.rand()
        thr = float(rs.choice([0.0, 0.4, 0.9]))
        box = tco3d.mask_bbox(mask, thr)
        assert box == jco3d.mask_bbox(mask, thr)
        if box is not None:
            ctx = float(rs.uniform(0, 1))
            assert tco3d.expand_bbox(box, ctx, mask.shape) == jco3d.expand_bbox(box, ctx, mask.shape)
    assert tco3d.mask_bbox(np.zeros((4, 4), np.float32)) is None


# ---- load_frame_data


def _hand_frame(root, rect, size_hw=(60, 80), depth=True, jpeg=True):
    """One frame whose mask is the rectangle `rect` (x0, y0, x1, y1): a JPEG
    (or PNG) image with texture, an 8-bit mask, a float16 depth PNG."""
    rs = np.random.RandomState(sum(rect))
    h, w = size_hw
    img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    mask = np.zeros((h, w), np.uint8)
    x0, y0, x1, y1 = rect
    mask[y0:y1, x0:x1] = 255
    mask[y0, x0] = 100  # a soft edge
    d = np.where(mask > 0, rs.uniform(1.0, 3.0, (h, w)), 0.0).astype(np.float16).view(np.uint16)
    names = {"image": f"f_{x0}_{y0}.{'jpg' if jpeg else 'png'}", "mask": f"m_{x0}_{y0}.png", "depth": f"d_{x0}_{y0}.png"}
    Image.fromarray(img).save(os.path.join(root, names["image"]), **({"quality": 90} if jpeg else {}))
    Image.fromarray(mask).save(os.path.join(root, names["mask"]))
    if depth:
        Image.fromarray(d, mode="I;16").save(os.path.join(root, names["depth"]))
    kw = dict(sequence_name="s", frame_number=0, frame_timestamp=0.0, image_path=names["image"],
              image_size_hw=size_hw, mask_path=names["mask"], depth_path=names["depth"] if depth else None,
              depth_scale_adjustment=1.5, R=np.eye(3, dtype=np.float32), T=np.array([0.1, -0.2, 3.0], np.float32),
              focal_length=np.array([2.0, 2.0], np.float32), principal_point=np.array([0.05, -0.1], np.float32))
    return tco3d.CO3DFrame(**kw), jco3d.CO3DFrame(**kw)


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@pytest.mark.parametrize("case,rect,out", [
    ("square", (20, 15, 40, 35), 32),        # native crop/resize
    ("square_grow", (30, 20, 42, 32), 40),
    ("wide_padded", (10, 22, 60, 38), 32),    # padded, then resized
    ("tall_padded_grow", (35, 5, 47, 55), 72),
])
@pytest.mark.parametrize("compact", [True, False])
def test_load_frame_data_matches_jax(tmp_path, case, rect, out, compact):
    """Square boxes take the native path: every field bitwise (the mask goes
    through `image_io.resize`, within 1 float32 ulp of PIL in float, equal
    after quantisation here). Padded boxes: the image's uint8 resize within
    1 level of PIL's, the mask within 1 level, depth bitwise (PIL's
    nearest); intrinsics to 1e-6."""
    tf, jf = _hand_frame(str(tmp_path), rect)
    kw = dict(image_height=out, image_width=out, compact=compact)
    t = tco3d.load_frame_data(tf, str(tmp_path), **kw)
    j = jco3d.load_frame_data(jf, str(tmp_path), **kw)
    assert set(t) == set(j)
    for k in ("focal_length", "principal_point"):
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-6)
    for k in FIELDS:
        assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
    np.testing.assert_array_equal(t["depth_map"], j["depth_map"])
    np.testing.assert_array_equal(t["mask_crop"], j["mask_crop"])
    square = case.startswith("square")
    if square:
        np.testing.assert_array_equal(t["image_rgb"], j["image_rgb"])
    assert np.abs(_levels(t["image_rgb"]) - _levels(j["image_rgb"])).max() <= 1
    if compact:
        assert np.abs(_levels(t["fg_probability"]) - _levels(j["fg_probability"])).max() <= 1
    else:
        np.testing.assert_allclose(t["fg_probability"], j["fg_probability"], rtol=0, atol=6e-8)


def test_load_frame_data_without_box_or_depth(tmp_path):
    """No box crop and no depth file: the whole frame (a PNG image), padded,
    and a zero depth map, as in JAX."""
    tf, jf = _hand_frame(str(tmp_path), (5, 5, 30, 20), depth=False, jpeg=False)
    kw = dict(image_height=20, image_width=20, box_crop=False, compact=True)
    t, j = tco3d.load_frame_data(tf, str(tmp_path), **kw), jco3d.load_frame_data(jf, str(tmp_path), **kw)
    assert not t["depth_map"].any() and t["depth_map"].dtype == np.float16
    assert np.abs(_levels(t["image_rgb"]) - _levels(j["image_rgb"])).max() <= 1
    np.testing.assert_allclose(t["principal_point"], j["principal_point"], rtol=0, atol=1e-6)


def test_unreadable_depth_warns_naming_the_file(tmp_path, caplog):
    """JAX drops a bad depth silently; the port keeps the zero depth map and
    logs a warning that names the file."""
    tf, _ = _hand_frame(str(tmp_path), (20, 15, 40, 35))
    with open(os.path.join(str(tmp_path), tf.depth_path), "wb") as f:
        f.write(b"not a png")
    with caplog.at_level(logging.WARNING, logger="holo_diffusion_torch.data.co3d"):
        out = tco3d.load_frame_data(tf, str(tmp_path), image_height=16, image_width=16)
    assert not out["depth_map"].any()
    assert any(tf.depth_path in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("fmt", ["ndc_isotropic", "ndc_norm_image_bounds"])
def test_pixel_projection_through_crop_pad_resize(tmp_path, fmt):
    """tests/test_co3d_convention.py's independent pixel-space derivation,
    held to the port's loader and cameras (0.02 px)."""
    root = str(tmp_path / fmt)
    rect = (18, 30, 66, 90)
    cat = _write_convention_frame(root, fmt, rect)
    provider = tco3d.CO3DDataProvider(category=cat, dataset_root=root, image_height=OUT, image_width=OUT,
                                      box_crop=True, box_crop_context=0.0)
    scene = provider.train.get_scene(0)
    assert tuple(scene.image_rgb.shape) == (1, OUT, OUT, 3)
    R, T = _extrinsics()
    pts = np.array([[0.0, 0.0, 0.0], [0.25, -0.18, 0.1], [-0.2, 0.3, -0.15]], np.float64)
    px_orig = _project_px_pytorch3d(R, T, FOCAL_NDC, PP_NDC, (120, 84), fmt, pts)
    x0, y0, x1, y1 = rect
    size = max(y1 - y0, x1 - x0)
    pad = np.array([(size - (x1 - x0)) // 2, (size - (y1 - y0)) // 2], np.float64)
    px_final = (px_orig - np.array([x0, y0], np.float64) + pad) * (OUT / size)
    ndc = project_points_ndc(scene.camera, torch.from_numpy(pts.astype(np.float32))[None])[0].double().numpy()
    px_loaded = OUT / 2.0 - OUT / 2.0 * ndc[:, :2]
    np.testing.assert_allclose(px_loaded, px_final, atol=0.02)
    fg = scene.fg_probability[0, ..., 0].numpy()
    for x, y in px_loaded:
        assert fg[int(y), int(x)] > 127, (x, y)


# ---- the datasets and the provider


def _rewrite_masses(root, zero):
    path = os.path.join(root, "synthball", "frame_annotations.jgz")
    with gzip.open(path, "rt") as f:
        annos = json.load(f)
    for a in annos:
        a["mask"]["mass"] = 0 if (a["sequence_name"], a["frame_number"]) in zero else 100
    with gzip.open(path, "wt") as f:
        json.dump(annos, f)


@pytest.mark.parametrize("knobs", [
    {},
    {"pick_sequence": ["seq_001"]},
    {"exclude_sequence": ["seq_000"]},
    {"limit_sequences_to": 1},
    {"sort_frames": True},
    {"remove_empty_masks": False},
    {"test_on_train": False, "n_frames_per_sequence": 3},
])
def test_selection_knobs_match_jax(tmp_path, knobs):
    """Sequences and their frames, in order, for each knob; the set list
    shuffled and two frames' annotated mask mass 0."""
    root = str(tmp_path)
    t_write(root, n_seq=N_SEQ, n_frames=N_FRAMES, H=H, W=W, seed=4)
    _rewrite_masses(root, {("seq_000", 1), ("seq_001", 4)})
    sl = os.path.join(root, "synthball", "set_lists", "set_lists_fewview_dev.json")
    with open(sl) as f:
        lists = json.load(f)
    lists["train"] = lists["train"][::-1]
    with open(sl, "w") as f:
        json.dump(lists, f)
    t, j = _providers(root, **knobs)
    for split in ("train", "val"):
        td, jd = getattr(t, split), getattr(j, split)
        assert td._seq_names == jd._seq_names
        assert {s: [f.frame_number for f in fs] for s, fs in td._frames_by_seq.items()} == \
            {s: [f.frame_number for f in fs] for s, fs in jd._frames_by_seq.items()}
    _assert_frames_match(t.val.get_scene(0), j.val.get_scene(0))


def test_scenes_match_jax_compact_and_float(trees):
    for compact in (True, False):
        t, j = _providers(trees["jax"], compact_cache=compact)
        for i in range(len(t.train)):
            _assert_frames_match(t.train.get_scene(i), j.train.get_scene(i))
        assert t.train.get_scene(0).image_rgb.dtype == (torch.uint8 if compact else torch.float32)
        assert t.train.get_scene(0).depth_map.dtype == (torch.float16 if compact else torch.float32)


def test_lru_cache_evicts_as_jax(trees):
    t, j = _providers(trees["jax"], max_cached_scenes=1)
    order = [0, 1, 1, 0, 1]
    for i in order:
        a, b = t.train.get_scene(i), j.train.get_scene(i)
        assert list(t.train._cache) == list(j.train._cache)
    assert list(t.train._cache) == ["seq_001"]
    t2, _ = _providers(trees["jax"], max_cached_scenes=2)
    first = t2.train.get_scene(0)
    t2.train.get_scene(1)
    assert t2.train.get_scene(0) is first  # cached: not decoded again
    t2.train.get_scene(1)
    assert list(t2.train._cache) == ["seq_000", "seq_001"]
    assert a.sequence_id[0] == b.sequence_id[0] == 1


def test_decode_pool_matches_serial(trees):
    pooled = tco3d.CO3DDataProvider(category="synthball", dataset_root=trees["jax"], image_height=24,
                                    image_width=24, num_workers=4).train.get_scene(1)
    serial = tco3d.CO3DDataProvider(category="synthball", dataset_root=trees["jax"], image_height=24,
                                    image_width=24, num_workers=1).train.get_scene(1)
    for f in FIELDS + ("sequence_id",):
        assert torch.equal(getattr(pooled, f), getattr(serial, f)), f
    assert torch.equal(pooled.camera.R, serial.camera.R)


@pytest.mark.parametrize("batch_size", [3, 8])
def test_sample_batch_draws_jax_frames(trees, batch_size):
    """`epoch_loader` over the port's dataset and over JAX's, from one seed:
    the same scenes and frames in the same order (8 > 4 frames a scene:
    with replacement)."""
    t, j = _providers(trees["jax"])
    tb = list(epoch_loader(t.train, batch_size, 8, seed=11))
    rng = np.random.RandomState(11)
    jb = [j.train.sample_batch(rng, batch_size) for _ in range(8)]
    for a, b in zip(tb, jb):
        assert a.batch_size == batch_size and a.device.type == "cpu"
        _assert_frames_match(a, b)
    assert len({int(b.sequence_id[0]) for b in tb}) == 2  # both scenes drawn


def test_eval_batches_match_jax(trees):
    t, j = _providers(trees["jax"], load_eval_batches=True, n_known_frames_for_test=2)
    assert t.eval_batches == j.eval_batches and len(t.eval_batches) == N_SEQ * 2
    for i in range(len(t.eval_batches)):
        _assert_frames_match(t.get_eval_batch(i), j.get_eval_batch(i))
    with pytest.raises(KeyError, match="not in this split"):
        t.train.get_frames("seq_000", [N_FRAMES - 1])  # a val frame
    bare, _ = _providers(trees["jax"])
    with pytest.raises(RuntimeError, match="load_eval_batches"):
        bare.get_eval_batch(0)


def test_missing_eval_batches_warn(trees, tmp_path, caplog):
    root = str(tmp_path)
    t_write(root, n_seq=1, n_frames=3, H=24, W=32, seed=5)
    os.remove(os.path.join(root, "synthball", "eval_batches", "eval_batches_fewview_dev.json"))
    with caplog.at_level(logging.WARNING, logger="holo_diffusion_torch.data.co3d"):
        p = tco3d.CO3DDataProvider(category="synthball", dataset_root=root, load_eval_batches=True)
    assert p.eval_batches is None and "random-targets" in caplog.text


# ---- the training loop on CO3D


def test_tiny_experiment_runs_and_resumes_on_co3d(trees, tmp_path):
    """1 epoch of 1 step (batches of 3 of a sequence's 4 training frames at
    16 px) with validation, then a new Experiment resumes for epoch 1; the
    resumed run equals 2 epochs straight, bitwise."""
    extra = ["data_source_ImplicitronDataSource_args.data_loader_map_provider_SequenceDataLoaderMapProvider_args."
             "dataset_length_train=3", "disable_validation=false",
             "training_loop_ImplicitronTrainingLoop_args.visualize_interval=0"]
    straight, s_stats = Experiment(tiny_co3d_cfg(tmp_path / "straight", trees["torch"], extra=extra),
                                   device="cpu").run(max_epochs=2)
    exp = Experiment(tiny_co3d_cfg(tmp_path / "resumed", trees["torch"], extra=extra), device="cpu")
    assert exp.n_batches_train == 1 and len(exp.data.train) == N_SEQ
    first, stats = exp.run(max_epochs=1)
    assert first.step == 1 and stats.epoch == 0 and "val" in stats.history[0]
    resumed, r_stats = Experiment(tiny_co3d_cfg(tmp_path / "resumed", trees["torch"], extra=extra),
                                  device="cpu").run(max_epochs=2)
    assert resumed.step == straight.step == 2
    assert [e for e, _ in list_checkpoints(str(tmp_path / "resumed"))] == [1]
    for (n, a), b in zip(straight.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), n
    assert all(np.isfinite(v) for e in r_stats.history for v in e["train"].values())
    assert r_stats.history[1]["train"]["loss_rgb_psnr"] == s_stats.history[1]["train"]["loss_rgb_psnr"]


def test_hydrant_with_the_co3d_provider_builds(trees, tmp_path):
    """hydrant.yaml's data section, pointed at a tree: no NotImplementedError,
    no unconsumed key; compact_sources and packed_transfer, once refused,
    build with compaction (mirroring hydrant's split and resize) or packing
    set up."""
    ds = "data_source_ImplicitronDataSource_args.dataset_map_provider_JsonIndexDatasetMapProviderV2_args."
    base = [f"{ds}dataset_root={trees['torch']}", f"{ds}category=synthball", f"exp_dir={tmp_path}"]
    cfg = load_config("hydrant", base)
    assert cfg["data_source_ImplicitronDataSource_args"]["dataset_map_provider_class_type"] == \
        "JsonIndexDatasetMapProviderV2"
    assert audit_unconsumed_keys(cfg, warn=lambda msg: None) == []
    exp = Experiment(cfg, device="cpu")
    assert isinstance(exp.data, tco3d.CO3DDataProvider) and exp.batch_size == 33
    assert exp.data.eval_batches is not None and len(exp.data.train) == N_SEQ
    compact = Experiment(load_config("hydrant", base + ["compact_sources=true"]), device="cpu")
    comp = compact.compactor
    assert (comp.n_train_target_views, comp.image_rescale, comp.n_targets(33)) == (
        compact.model.n_train_target_views, 0.32, compact.model.n_train_target_views)
    packed = Experiment(load_config("hydrant", base + ["packed_transfer=true"]), device="cpu")
    assert packed.compactor is None and packed._make_packer() is not None


def test_host_batches_go_to_the_device_through_the_loop(trees, tmp_path):
    """Experiment._to_device leaves a CPU run's batch on the CPU (nothing to
    pin) and keeps the compact dtypes the model converts."""
    exp = Experiment(tiny_co3d_cfg(tmp_path, trees["torch"]), device="cpu")
    batch = exp.data.train.sample_batch(np.random.RandomState(0), 3)
    moved = exp._to_device(batch)
    assert moved.device.type == "cpu" and moved.image_rgb.dtype == torch.uint8
    assert torch.equal(moved.image_rgb, batch.image_rgb)
