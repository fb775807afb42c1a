"""The data path's C++ host code, bound with ctypes (port of
holo_diffusion_tpu/native/__init__.py): the CO3D loader's crop/resize and
mask box, PNG row unfiltering, and the compact-source composite + resize
(data/compact.py).

`csrc/preprocess.cpp` is compiled with g++ at first use by `ops/_build.py`
into `build/holo_diffusion_torch/`. A failed build raises with the
compiler's output: there is no other path behind it. Every function takes
and returns numpy arrays; ctypes releases the interpreter lock during each
call, so the loader's decode threads run them in parallel.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np

from ..ops import _build

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int)
_lib: Optional[ctypes.CDLL] = None


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if the build fails."""
    global _lib
    if _lib is None:
        lib = _build.load("preprocess")
        crop = [_U8P] + [ctypes.c_int] * 7
        lib.hd_crop_resize_u8.argtypes = crop + [_F32P, ctypes.c_int, ctypes.c_int, ctypes.c_float]
        lib.hd_crop_resize_u8.restype = None
        lib.hd_crop_resize_u8_out.argtypes = crop + [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_float]
        lib.hd_crop_resize_u8_out.restype = None
        lib.hd_crop_resize_batch_u8.argtypes = [
            ctypes.POINTER(_U8P), _I32P, _I32P, ctypes.c_int, ctypes.c_int,
            _F32P, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ]
        lib.hd_crop_resize_batch_u8.restype = None
        lib.hd_compact_source_batch_u8.argtypes = [
            ctypes.POINTER(_U8P), ctypes.POINTER(_U8P), _I32P, ctypes.c_int, ctypes.c_int,
            _U8P, _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_float, _F32P, ctypes.c_int, ctypes.c_int,
        ]
        lib.hd_compact_source_batch_u8.restype = None
        lib.hd_mask_bbox.argtypes = [_F32P, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, _I32P]
        lib.hd_mask_bbox.restype = ctypes.c_int
        lib.hd_png_unfilter.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P]
        lib.hd_png_unfilter.restype = ctypes.c_int
        _lib = lib
    return _lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def _check_box(src: np.ndarray, box: Tuple[int, int, int, int]) -> None:
    H, W = src.shape[:2]
    x0, y0, x1, y1 = box
    if not (0 <= x0 < x1 <= W and 0 <= y0 < y1 <= H):
        raise ValueError(f"crop box {box} outside a {H}x{W} frame")


def crop_resize_u8(
    src: np.ndarray, box: Tuple[int, int, int, int], out_hw: Tuple[int, int], scale: float = 1.0 / 255.0,
) -> np.ndarray:
    """Crop `box` (x0, y0, x1, y1) of one (H, W, C) uint8 frame and resize
    it bilinearly (half-pixel centres, no antialiasing) to (outH, outW, C)
    float32, times `scale`."""
    src = np.ascontiguousarray(src, np.uint8)
    _check_box(src, box)
    H, W, C = src.shape
    dst = np.empty((*out_hw, C), np.float32)
    get_lib().hd_crop_resize_u8(_ptr(src, _U8P), H, W, C, *box, _ptr(dst, _F32P), *out_hw, scale)
    return dst


def crop_resize_u8_out(
    src: np.ndarray, box: Tuple[int, int, int, int], out_hw: Tuple[int, int], scale: float = 1.0 / 255.0,
) -> np.ndarray:
    """`crop_resize_u8` with uint8 output, bitwise
    `clip(round(crop_resize_u8(...) * 255), 0, 255)` (the compact cache)."""
    src = np.ascontiguousarray(src, np.uint8)
    _check_box(src, box)
    H, W, C = src.shape
    dst = np.empty((*out_hw, C), np.uint8)
    get_lib().hd_crop_resize_u8_out(_ptr(src, _U8P), H, W, C, *box, _ptr(dst, _U8P), *out_hw, scale)
    return dst


def crop_resize_batch_u8(
    srcs: Sequence[np.ndarray], boxes: np.ndarray, out_hw: Tuple[int, int],
    scale: float = 1.0 / 255.0, n_threads: int = 8,
) -> np.ndarray:
    """`crop_resize_u8` over a list of (H_i, W_i, C) uint8 frames on the
    library's thread pool; boxes (N, 4). Returns (N, outH, outW, C) float32."""
    srcs = [np.ascontiguousarray(s, np.uint8) for s in srcs]
    boxes = np.ascontiguousarray(boxes, np.int32).reshape(len(srcs), 4)
    for s, b in zip(srcs, boxes):
        _check_box(s, tuple(b))
    N, C = len(srcs), srcs[0].shape[2]
    if any(s.shape[2] != C for s in srcs):
        raise ValueError("frames of a batch must have the same channels")
    hws = np.asarray([s.shape[:2] for s in srcs], np.int32).reshape(-1)
    ptrs = (_U8P * N)(*[_ptr(s, _U8P) for s in srcs])
    dst = np.empty((N, *out_hw, C), np.float32)
    get_lib().hd_crop_resize_batch_u8(ptrs, _ptr(hws, _I32P), _ptr(boxes, _I32P), N, C,
                                      _ptr(dst, _F32P), *out_hw, scale, n_threads)
    return dst


def compact_source_batch_u8(
    imgs: np.ndarray, fgs: Optional[np.ndarray], out_hw: Tuple[int, int], thr: float, bg_color,
    mask_images: bool, n_threads: int = 8,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """The compact-source preprocess in one pass over each frame: where
    fg > thr fails at a bilinear corner read, that corner reads `bg_color`
    (with `mask_images`), which is compositing at full resolution and then
    resizing, without the full-resolution intermediate; uint8 out, rounded
    to nearest. imgs (N, H, W, C) uint8, C <= 4; fgs (N, H, W[, 1]) uint8 or
    None (no masking). Returns (img (N, outH, outW, C), fg (N, outH, outW,
    1) or None), both uint8: the fg output is the resized binarised mask."""
    imgs = np.ascontiguousarray(imgs, np.uint8)
    N, H, W, C = imgs.shape
    if C > 4:
        raise ValueError(f"compact sources take at most 4 channels, got {C}")
    img_dst = np.empty((N, *out_hw, C), np.uint8)
    hws = np.asarray([[H, W]] * N, np.int32).reshape(-1)
    img_ptrs = (_U8P * N)(*[_ptr(imgs[i], _U8P) for i in range(N)])
    fg_ptrs = fg_dst = None
    if fgs is not None:
        fgs = np.ascontiguousarray(np.asarray(fgs, np.uint8).reshape(N, H, W))
        fg_ptrs = (_U8P * N)(*[_ptr(fgs[i], _U8P) for i in range(N)])
        fg_dst = np.empty((N, *out_hw), np.uint8)
    bg = np.asarray(np.clip(np.round(np.asarray(bg_color, np.float64) * 255.0), 0, 255), np.float32)
    if bg.size < C:
        raise ValueError(f"bg_color has {bg.size} channels for frames of {C}")
    get_lib().hd_compact_source_batch_u8(
        img_ptrs, fg_ptrs, _ptr(hws, _I32P), N, C, _ptr(img_dst, _U8P),
        None if fg_dst is None else _ptr(fg_dst, _U8P), *out_hw, float(thr) * 255.0,
        _ptr(bg, _F32P), int(bool(mask_images)), n_threads)
    return img_dst, None if fg_dst is None else fg_dst[..., None]


def mask_bbox_native(mask: np.ndarray, thr: float, context: float) -> Optional[Tuple[int, int, int, int]]:
    """The (x0, y0, x1, y1) box of mask > thr grown by `context` and clamped
    (data/co3d.py mask_bbox then expand_bbox); None for an empty mask."""
    mask = np.ascontiguousarray(mask, np.float32)
    H, W = mask.shape
    box = np.zeros(4, np.int32)
    ok = get_lib().hd_mask_bbox(_ptr(mask, _F32P), H, W, thr, context, _ptr(box, _I32P))
    return tuple(int(v) for v in box) if ok else None


def png_unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the row filters of decompressed PNG data (`h` rows of one
    filter-type byte and `stride` bytes). Returns (h, stride) uint8; raises
    ValueError on a filter type outside 0-4."""
    data = np.ascontiguousarray(data, np.uint8)
    if data.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {data.size} bytes, expected {h} rows of {stride + 1}")
    out = np.empty((h, stride), np.uint8)
    bad = get_lib().hd_png_unfilter(_ptr(data, _U8P), h, stride, bpp, _ptr(out, _U8P))
    if bad >= 0:
        raise ValueError(f"PNG row {bad}: filter type {int(data[bad * (stride + 1)])} is not 0-4")
    return out
