"""Release-format synthetic CO3Dv2 tree writer (port of
holo_diffusion_tpu/data/synthetic_co3d.py, with the same numpy draws).

Writes a dataset in the on-disk CO3Dv2 format that `data/co3d.py` reads:
JPEG frames (PIL, quality 90), 8-bit gray mask PNGs, float16-in-uint16 depth
PNGs (both written by `data/image_io.py`), `frame_annotations.jgz` with
`ndc_norm_image_bounds` intrinsics, `set_lists_fewview_dev.json` and the
challenge's `eval_batches_fewview_dev.json`, so the hydrant recipe (batches
of 33 same-sequence 800^2 frames through box crop and resize) runs end to
end without CO3D.

The scenes are shaded spheres with a procedural texture and sensor noise
(so a JPEG decodes at a realistic cost), seen from a fly-around of poses at
CO3D's portrait aspect (900 x 1200).
"""
from __future__ import annotations

import gzip
import json
import os
from typing import Tuple

import numpy as np

from ..geometry.cameras import look_at_view_transform
from .image_io import write_jpeg, write_png


def _render_sphere_frame(
    cam_T: np.ndarray,
    focal_ndc_iso: np.ndarray,
    pp_ndc_iso: np.ndarray,
    H: int,
    W: int,
    radius: float,
    rng: np.random.RandomState,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """An analytic shaded sphere at the world origin -> (rgb u8, mask u8,
    depth float32). The projection follows the loader's screen convention:
    x_px = c_x - s * (f_x * X/Z + p_x), s = min(H, W) / 2; the world origin
    lies at camera-space `cam_T`."""
    z0 = float(cam_T[2])
    s = min(H, W) / 2.0
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    u0 = cam_T[0] / z0
    v0 = cam_T[1] / z0
    px = cx - s * (focal_ndc_iso[0] * u0 + pp_ndc_iso[0])
    py = cy - s * (focal_ndc_iso[1] * v0 + pp_ndc_iso[1])
    r_px = s * float(focal_ndc_iso[0]) * radius / z0

    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    d2 = ((xx - px) ** 2 + (yy - py) ** 2) / max(r_px, 1.0) ** 2
    inside = d2 < 1.0
    nz = np.sqrt(np.clip(1.0 - d2, 0.0, 1.0))  # the sphere normal's z (approximate)

    # lambertian shading and procedural bands
    light = np.clip(0.25 + 0.75 * nz, 0.0, 1.0) * (
        0.8 + 0.2 * np.sin(0.15 * (xx - px)) * np.cos(0.11 * (yy - py)))
    base = rng.uniform(0.3, 0.9, size=3)
    img = np.zeros((H, W, 3), np.float32)
    for c in range(3):
        img[..., c] = light * base[c]
    img += rng.normal(0.0, 0.01, img.shape).astype(np.float32)  # sensor noise
    img = np.where(inside[..., None], img, rng.uniform(0.02, 0.08))
    img_u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    mask_u8 = (inside * 255).astype(np.uint8)
    depth = np.where(inside, z0 - radius * nz, 0.0).astype(np.float32)
    return img_u8, mask_u8, depth


def write_synthetic_co3d(
    root: str,
    category: str = "synthball",
    n_seq: int = 4,
    n_frames: int = 40,
    H: int = 900,
    W: int = 1200,
    radius: float = 1.3,
    dist: float = 4.0,
    seed: int = 0,
    with_depth: bool = True,
    n_val_frames: int = 2,
    n_known_per_eval_batch: int = 4,
) -> str:
    """Write the tree under `root/category`; returns `category`. The last
    `n_val_frames` frames of each sequence form the val split."""
    cat_dir = os.path.join(root, category)
    os.makedirs(os.path.join(cat_dir, "set_lists"), exist_ok=True)
    rng = np.random.RandomState(seed)
    annos = []
    set_lists = {"train": [], "val": [], "test": []}
    s = min(H, W)
    # ndc_norm_image_bounds: each axis normalised by its own half-extent
    bounds_scale = np.array([s / W, s / H], np.float64)

    for si in range(n_seq):
        seq = f"seq_{si:03d}"
        for d in ("images", "masks", "depths"):
            os.makedirs(os.path.join(cat_dir, seq, d), exist_ok=True)
        for fi in range(n_frames):
            R, T = look_at_view_transform(
                dist=dist * rng.uniform(0.9, 1.15),
                elev=rng.uniform(-25.0, 35.0),
                azim=360.0 * fi / n_frames + rng.uniform(-3, 3),
            )
            Rn, Tn = R[0].numpy(), T[0].numpy()
            focal_iso = np.array([2.1 * rng.uniform(0.95, 1.05)] * 2, np.float64)
            pp_iso = rng.uniform(-0.06, 0.06, size=2)
            img_u8, mask_u8, depth = _render_sphere_frame(Tn, focal_iso, pp_iso, H, W, radius, rng)

            img_rel = f"{category}/{seq}/images/frame{fi:06d}.jpg"
            mask_rel = f"{category}/{seq}/masks/frame{fi:06d}.png"
            dep_rel = f"{category}/{seq}/depths/frame{fi:06d}.png"
            write_jpeg(os.path.join(root, img_rel), img_u8, quality=90)
            write_png(os.path.join(root, mask_rel), mask_u8)
            anno = {
                "sequence_name": seq,
                "frame_number": fi,
                "frame_timestamp": float(fi),
                "image": {"path": img_rel, "size": [H, W]},
                "mask": {"path": mask_rel},
                "viewpoint": {
                    "R": Rn.tolist(),
                    "T": Tn.tolist(),
                    "focal_length": (focal_iso * bounds_scale).tolist(),
                    "principal_point": (pp_iso * bounds_scale).tolist(),
                    "intrinsics_format": "ndc_norm_image_bounds",
                },
            }
            if with_depth:
                # CO3D's depth convention: float16 bits in a 16-bit PNG
                write_png(os.path.join(root, dep_rel), depth.astype(np.float16).view(np.uint16))
                anno["depth"] = {"path": dep_rel, "scale_adjustment": 1.0}
            annos.append(anno)
            split = "val" if fi >= n_frames - n_val_frames else "train"
            set_lists[split].append([seq, fi, img_rel])

    with gzip.open(os.path.join(cat_dir, "frame_annotations.jgz"), "wt") as f:
        json.dump(annos, f)
    with open(os.path.join(cat_dir, "set_lists", "set_lists_fewview_dev.json"), "w") as f:
        json.dump(set_lists, f)

    # the CO3Dv2 challenge's eval batches: lists of [sequence_name,
    # frame_number, image_path], the eval target first, then known frames
    eval_batches = []
    by_seq_split = {"train": {}, "val": {}}
    for split in ("train", "val"):
        for seq, fi, rel in set_lists[split]:
            by_seq_split[split].setdefault(seq, []).append([seq, fi, rel])
    for seq, targets in by_seq_split["val"].items():
        known = by_seq_split["train"].get(seq, [])[:n_known_per_eval_batch]
        for target in targets:
            eval_batches.append([target] + known)
    os.makedirs(os.path.join(cat_dir, "eval_batches"), exist_ok=True)
    with open(os.path.join(cat_dir, "eval_batches", "eval_batches_fewview_dev.json"), "w") as f:
        json.dump(eval_batches, f)
    return category
