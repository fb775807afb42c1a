"""The CO3D loader's host code in the port: the C++ crop/resize and mask box
(`holo_diffusion_torch/native`, built by g++ through `ops/_build.py`)
against the JAX package's library, bitwise; the PNG reader and writer
(`data/image_io.py`) against PIL, bitwise; the JPEG path (PIL, as in JAX);
`image_io.resize` against PIL's resize at stated tolerances; the build's
failure without a compiler; the package data."""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import fnmatch
import glob
import os
import tomllib
import zlib

import numpy as np
import pytest
from PIL import Image

from holo_diffusion_torch import native as tnative
from holo_diffusion_torch.data import image_io
from holo_diffusion_torch.ops import _build
from holo_diffusion_tpu import native as jnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_lib():
    """The JAX package's library (built by its own g++ call). The port's
    build needs g++ too, so a None here is a failure, not a skip."""
    lib = jnative.get_lib()
    assert lib is not None, "the JAX package's native library did not build"
    return lib


def _frame(rs, H, W, C=3):
    return rs.randint(0, 256, (H, W, C)).astype(np.uint8)


@pytest.mark.parametrize("box,out_hw", [
    ((0, 0, 33, 33), (16, 16)),        # square box, shrink
    ((5, 3, 29, 27), (48, 48)),        # square box, grow
    ((2, 4, 40, 20), (24, 31)),        # any box and output
    ((0, 0, 41, 33), (33, 41)),        # the whole frame
])
def test_crop_resize_matches_jax_bitwise(jax_lib, box, out_hw):
    """Tolerance: 0 (the same source compiled with the same flags)."""
    rs = np.random.RandomState(0)
    src = _frame(rs, 33, 41)
    np.testing.assert_array_equal(tnative.crop_resize_u8(src, box, out_hw), jnative.crop_resize_u8(src, box, out_hw))
    np.testing.assert_array_equal(tnative.crop_resize_u8_out(src, box, out_hw),
                                  jnative.crop_resize_u8_out(src, box, out_hw))
    srcs = [src, _frame(rs, 40, 45)]
    boxes = np.array([box, (1, 1, 30, 30)], np.int32)
    np.testing.assert_array_equal(tnative.crop_resize_batch_u8(srcs, boxes, out_hw, n_threads=2),
                                  jnative.crop_resize_batch_u8(srcs, boxes, out_hw, n_threads=2))


def test_crop_resize_u8_out_is_the_quantised_float_path():
    src = _frame(np.random.RandomState(1), 30, 30)
    f32 = tnative.crop_resize_u8(src, (3, 2, 27, 26), (20, 20))
    want = np.clip(np.round(f32 * np.float32(255.0)), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(tnative.crop_resize_u8_out(src, (3, 2, 27, 26), (20, 20)), want)


def test_crop_box_outside_the_frame_raises():
    with pytest.raises(ValueError, match="outside"):
        tnative.crop_resize_u8(np.zeros((8, 8, 3), np.uint8), (0, 0, 9, 8), (4, 4))


@pytest.mark.parametrize("thr,context", [(0.4, 0.3), (0.5, 0.0), (0.1, 0.7)])
def test_mask_bbox_native_matches_jax(jax_lib, thr, context):
    rs = np.random.RandomState(2)
    mask = np.zeros((40, 50), np.float32)
    mask[7:23, 11:36] = rs.rand(16, 25)
    assert tnative.mask_bbox_native(mask, thr, context) == jnative.mask_bbox_native(mask, thr, context)
    assert tnative.mask_bbox_native(np.zeros((5, 5), np.float32), thr, context) is None


# ---- PNG


def _pil_png(tmp_path, name, a, mode):
    path = str(tmp_path / name)
    Image.fromarray(a, mode=mode).save(path)
    return path


def _gray_images(rs):
    yy, xx = np.mgrid[0:37, 0:53]
    blob = (((yy - 18) ** 2 + (xx - 25) ** 2) < 200).astype(np.uint8) * 255
    ramp = ((yy * 7 + xx * 3) % 256).astype(np.uint8)
    noise = rs.randint(0, 256, (37, 53)).astype(np.uint8)
    depth = np.where(blob > 0, 2.0 + np.sin(xx / 5.0) * np.cos(yy / 7.0), 0.0).astype(np.float16).view(np.uint16)
    return {"blob": (blob, "L"), "ramp": (ramp, "L"), "noise": (noise, "L"), "depth": (depth, "I;16"),
            "depth_noise": (rs.randint(0, 65536, (37, 53)).astype(np.uint16), "I;16")}


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@pytest.mark.parametrize("case", ["blob", "ramp", "noise", "depth", "depth_noise"])
def test_png_reader_matches_pil_on_pil_written_files(tmp_path, case):
    """PIL picks a filter per row (adaptive): the files hold filter types
    1-4. Tolerance: 0."""
    a, mode = _gray_images(np.random.RandomState(3))[case]
    path = _pil_png(tmp_path, f"{case}.png", a, mode)
    got = image_io.read_png(path)
    with Image.open(path) as im:
        want = np.asarray(im)
    assert got.dtype == want.dtype and got.dtype == a.dtype
    np.testing.assert_array_equal(got, want)


def _filter_rows(rows: np.ndarray, bpp: int, types) -> bytes:
    """The PNG filters of the spec (section 9), in numpy, one type a row."""
    h, stride = rows.shape
    out = []
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        x = rows[y].astype(np.int64)
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        b = prev
        t = types[y % len(types)]
        if t == 0:
            f = x
        elif t == 1:
            f = x - a
        elif t == 2:
            f = x - b
        elif t == 3:
            f = x - (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            f = x - np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out.append(bytes([t]) + (f % 256).astype(np.uint8).tobytes())
        prev = x
    return b"".join(out)


@pytest.mark.parametrize("bits", [8, 16])
def test_png_reader_undoes_every_filter_type(tmp_path, bits):
    """Rows filtered by the spec's five filters in turn (and in other orders)
    read back exactly."""
    import struct

    rs = np.random.RandomState(4)
    dtype = np.uint8 if bits == 8 else np.uint16
    img = rs.randint(0, 2 ** bits, (23, 19)).astype(dtype)
    rows = img.astype(">u2").view(np.uint8).reshape(23, -1) if bits == 16 else img
    for k, types in enumerate(([0, 1, 2, 3, 4], [4, 3, 2, 1, 0], [4], [3])):
        raw = _filter_rows(rows, bits // 8, types)

        def chunk(tag, body):
            return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

        path = tmp_path / f"f{k}.png"
        path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 19, 23, bits, 0, 0, 0, 0))
                         + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
        np.testing.assert_array_equal(image_io.read_png(str(path)), img)
        with Image.open(path) as im:
            np.testing.assert_array_equal(np.asarray(im), img)


@pytest.mark.parametrize("case", ["blob", "noise", "depth"])
def test_png_writer_reads_back_in_pil(tmp_path, case):
    a, mode = _gray_images(np.random.RandomState(5))[case]
    path = str(tmp_path / "w.png")
    image_io.write_png(path, a)
    with Image.open(path) as im:
        assert im.mode == mode
        np.testing.assert_array_equal(np.asarray(im), a)
    np.testing.assert_array_equal(image_io.read_png(path), a)


def test_png_reader_names_the_file_it_refuses(tmp_path):
    rgb = _pil_png(tmp_path, "rgb.png", np.zeros((4, 5, 3), np.uint8), "RGB")
    with pytest.raises(ValueError, match=r"rgb\.png.*color type 2"):
        image_io.read_png(rgb)
    laced = tmp_path / "laced.png"
    png = image_io.png_bytes(np.zeros((9, 9), np.uint8), 0)
    ihdr = bytearray(png[8:33])  # length, tag, 13-byte body, crc
    ihdr[20] = 1  # the interlace method
    ihdr[21:25] = zlib.crc32(bytes(ihdr[4:21])).to_bytes(4, "big")
    laced.write_bytes(png[:8] + bytes(ihdr) + png[33:])
    with Image.open(laced) as im:
        assert im.info.get("interlace") == 1
    laced = str(laced)
    with pytest.raises(ValueError, match=r"laced\.png.*interlaced"):
        image_io.read_png(laced)
    bad = tmp_path / "bad.png"
    data = bytearray(open(_pil_png(tmp_path, "ok.png", np.zeros((4, 4), np.uint8), "L"), "rb").read())
    data[30] ^= 0xFF  # inside IHDR's body
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=r"bad\.png.*CRC"):
        image_io.read_png(str(bad))


def test_rgb_png_bytes_are_the_video_writers(tmp_path):
    """`utils/video.py:write_png` writes through `image_io.png_bytes`: 8-bit
    RGB, filter 0 on every row; PIL reads it back exactly."""
    from holo_diffusion_torch.utils.video import write_png

    frame = np.random.RandomState(6).randint(0, 256, (7, 9, 3)).astype(np.uint8)
    path = str(tmp_path / "f.png")
    write_png(path, frame)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), frame)


# ---- JPEG and resize


def test_jpeg_is_decoded_and_encoded_by_pil(tmp_path):
    """Step 0 found Pillow on the card's machine: JPEG goes through PIL in
    both packages, so the decode equals PIL's bitwise (tolerance 0)."""
    img = np.random.RandomState(7).randint(0, 256, (30, 41, 3)).astype(np.uint8)
    path = str(tmp_path / "f.jpg")
    image_io.write_jpeg(path, img)
    ref = str(tmp_path / "ref.jpg")
    Image.fromarray(img).save(ref, quality=90)
    assert open(path, "rb").read() == open(ref, "rb").read()
    with Image.open(path) as im:
        np.testing.assert_array_equal(image_io.read_image_rgb(path), np.asarray(im.convert("RGB")))


@pytest.mark.parametrize("shape", [(617, 617), (700, 933), (1013, 1013), (40, 52), (64, 64)])
def test_resize_against_pil(shape):
    """Against PIL's resize as JAX's `_resize` calls it. Tolerances: float
    bilinear 1 float32 ulp at 1.0 (6e-8; torch in float64 against PIL's
    doubles, the rounding of PIL's float32 intermediate row apart); nearest
    0 (64 -> 48 puts source coordinates on integers, where torch's
    "nearest-exact" picks other pixels than PIL on 20 % of the frame); uint8 RGB 1 level (PIL's fixed point against torch's: 0.1-0.2 % of
    the pixels of these noise frames shrunk to 800^2 differ, 1.9 % of the
    40 x 52 frame grown to 48^2)."""
    from holo_diffusion_tpu.data.co3d import _resize as jax_resize

    rs = np.random.RandomState(8)
    out = (800, 800) if shape[0] > 100 else (48, 48)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    mask = (((yy - shape[0] / 2) ** 2 + (xx - shape[1] / 2) ** 2) < (min(shape) / 3) ** 2).astype(np.float32)
    np.testing.assert_allclose(image_io.resize(mask, out), jax_resize(mask, out), rtol=0, atol=6e-8)
    depth = rs.rand(*shape).astype(np.float32)
    np.testing.assert_array_equal(image_io.resize(depth, out, nearest=True), jax_resize(depth, out, nearest=True))
    img = rs.rand(*shape, 3).astype(np.float32)
    got, want = image_io.resize(img, out), jax_resize(img, out)
    assert np.abs(np.round(got * 255) - np.round(want * 255)).max() <= 1


# ---- the build


def test_host_build_raises_without_a_compiler(tmp_path, monkeypatch):
    """No g++ on PATH: the build raises; it never returns a library-less
    path (the JAX package's `get_lib` returns None there)."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.build(["preprocess"])


def test_host_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="broken.*error"):
        _build.build(["broken"])
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("call", ["load", "build"])
def test_host_library_from_two_threads_against_an_empty_build_dir(tmp_path, monkeypatch, call):
    """Two threads of one process that first ask for the same host library
    at once, as the loader's threads do, both get it: `load` builds it once
    and each gets the one loaded library; `build` called from both compiles
    into a temporary file of each thread before publishing the library."""
    import threading

    (tmp_path / "twice.cpp").write_text('extern "C" int twice(int x) { return 2 * x; }\n')
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    start = threading.Barrier(2)
    got, errors = [], []

    def ask():
        start.wait()
        try:
            got.append(_build.load("twice") if call == "load" else _build.build(["twice"]))
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(e)

    threads = [threading.Thread(target=ask) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert errors == []
    assert [p.name for p in (tmp_path / "build").iterdir() if p.suffix != ".log"] == [_build.library_path("twice").name]
    if call == "load":
        assert got[0] is got[1] and got[0].twice(21) == 42


def test_host_library_key_covers_source_and_flags(tmp_path, monkeypatch):
    (tmp_path / "p.cpp").write_text("int p;\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    key = _build.library_path("p")
    (tmp_path / "h.cuh").write_text("int h;\n")
    assert _build.library_path("p") == key  # CUDA headers do not enter a .cpp's key
    monkeypatch.setattr(_build, "HOST_FLAGS", _build.HOST_FLAGS + ("-g",))
    assert _build.library_path("p") != key
    (tmp_path / "p.cpp").write_text("int p2;\n")
    assert _build.library_path("p") != key


def test_package_data_ships_the_host_source():
    """pyproject.toml's package-data of holo_diffusion_torch matches every
    csrc/*.cpp, as it matches the .cu and .cuh files."""
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"]["holo_diffusion_torch"]
    pkg = os.path.join(REPO, "holo_diffusion_torch")
    sources = [os.path.relpath(p, pkg) for p in glob.glob(os.path.join(pkg, "csrc", "*.cpp"))]
    assert sources == ["csrc/preprocess.cpp"]
    for rel in sources:
        assert any(fnmatch.fnmatch(rel, g) for g in globs), f"{rel} is not in package-data {globs}"
    assert "preprocess" in _build.HOST_SOURCES


def test_unfilter_rejects_an_unknown_filter_type():
    data = np.array([5, 1, 2, 3], np.uint8)
    with pytest.raises(ValueError, match="filter type 5"):
        tnative.png_unfilter(data, 1, 3, 1)
    np.testing.assert_array_equal(tnative.png_unfilter(np.array([0, 7], np.uint8), 1, 1, 1), [[7]])
