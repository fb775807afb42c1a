"""Image files and resizing for the CO3D loader and its synthetic writer
(the counterparts of the PIL calls inlined in holo_diffusion_tpu/data/co3d.py
and data/synthetic_co3d.py).

- JPEG (and any other image file of a frame) is decoded and encoded with
  PIL, as the JAX package does: `read_image_rgb`, `write_jpeg`.
- PNG masks (8-bit gray) and depths (16-bit gray) go through this module's
  own reader and writer: zlib, numpy, and the row unfiltering of
  `csrc/preprocess.cpp` (filters 3 and 4 are sequential along a row, which
  numpy cannot vectorise).
- `resize` replaces `PIL.Image.resize`: torch's antialiased bilinear
  (PIL's algorithm), in float64 for float images as PIL computes them, on
  uint8 for RGB frames; nearest (depths) picks PIL's source rows and
  columns exactly (`_nearest_index`).
"""
from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def read_image_rgb(path: str) -> np.ndarray:
    """An (H, W, 3) uint8 frame, decoded by PIL (JPEG or PNG)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def write_jpeg(path: str, img_u8: np.ndarray, quality: int = 90) -> None:
    """Encode an (H, W, 3) uint8 frame with PIL at `quality`."""
    from PIL import Image

    Image.fromarray(img_u8).save(path, quality=quality)


def read_png(path: str) -> np.ndarray:
    """A gray PNG as (H, W) uint8 (8-bit) or native-endian uint16 (16-bit,
    big-endian in the file), as PIL's "L" and "I;16" give them. Raises
    ValueError naming the file for any other color type or bit depth, for
    interlaced files, a bad chunk CRC or a filter type outside 0-4."""
    from ..native import png_unfilter

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + body) != crc:
            raise ValueError(f"{path}: bad CRC in chunk {tag!r}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if color != 0 or depth not in (8, 16):
        raise ValueError(f"{path}: color type {color} at {depth} bits; only 8- and 16-bit gray PNGs are read")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not read")
    bpp = depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    try:
        rows = png_unfilter(raw, h, w * bpp, bpp)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    if bpp == 1:
        return rows
    return rows.view(">u2").astype(np.uint16)


def png_bytes(img: np.ndarray, color_type: int) -> bytes:
    """A PNG file of (H, W) uint8/uint16 gray (color type 0) or (H, W, 3)
    uint8 RGB (color type 2), every row with filter 0, zlib level 6."""
    h, w = img.shape[:2]
    bits = 16 if img.dtype == np.uint16 else 8
    if img.dtype == np.uint16:
        img = img.astype(">u2")
    rows = np.ascontiguousarray(img).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(tag: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    return (_PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, color_type, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W) uint8 (an "L" mask) or uint16 (an "I;16" depth) as a
    gray PNG."""
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes (H, W) uint8 or uint16, got {img.shape} {img.dtype}")
    with open(path, "wb") as f:
        f.write(png_bytes(img, 0))


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """The source index of each output pixel of PIL's nearest resize: PIL
    steps a float64 coordinate from scale / 2 by scale = n_in / n_out and
    truncates it. torch's "nearest-exact" computes the same product in
    float32 and picks the other pixel wherever it lands on an integer."""
    scale = n_in / n_out
    coord = np.cumsum(np.concatenate([[scale * 0.5], np.full(n_out - 1, scale)]))
    return np.minimum(coord.astype(np.int64), n_in - 1)


def resize(img: np.ndarray, hw: Tuple[int, int], nearest: bool = False) -> np.ndarray:
    """`PIL.Image.resize` as JAX's `_resize` calls it, to float32 (H, W[, 3]):

    - (H, W) float, bilinear: antialiased bilinear in float64, as PIL
      computes float images (within 1 float32 ulp of PIL);
    - (H, W) float, nearest: PIL's nearest (bitwise);
    - (H, W, 3) in [0, 1]: quantised to uint8 by truncation as JAX does,
      antialiased bilinear on uint8 (within 1 level of PIL's fixed point),
      back to [0, 1].
    """
    if img.ndim == 2 and nearest:
        return np.asarray(img, np.float32)[np.ix_(_nearest_index(img.shape[0], hw[0]),
                                                   _nearest_index(img.shape[1], hw[1]))]
    if img.ndim == 2:
        x = torch.from_numpy(np.ascontiguousarray(img))[None, None]
        y = F.interpolate(x.to(torch.float64), size=hw, mode="bilinear", align_corners=False, antialias=True)
        return y[0, 0].to(torch.float32).numpy()
    u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    x = torch.from_numpy(u8).permute(2, 0, 1)[None]
    y = F.interpolate(x, size=hw, mode="bilinear", align_corners=False, antialias=True)
    return y[0].permute(1, 2, 0).numpy().astype(np.float32) / 255.0
