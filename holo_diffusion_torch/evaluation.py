"""Novel-view evaluation (port of holo_diffusion_tpu/evaluation.py;
Implicitron's ImplicitronEvaluator as the reference configures it,
training_loop.py:53-54, 181-188, 273-279, base.yaml:186-191).

For each target view: pool a voxel grid from the source views on the card
(`preprocess_input`, then `model.pool_features`), render the target densely
through `render_image_chunked` (the decode kernels on CUDA), and score it on
the host: PSNR, foreground PSNR, SSIM (float64 numpy), mask IoU and, where
depths exist, the foreground depth error. Records are aggregated overall
and into camera-difficulty bins and dumped as JSON with the JAX package's
keys. LPIPS needs pretrained VGG weights: `perceptual_fn` computes it when
given, and it is reported as null without one.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from .data.frame_data import FrameData
from .device import DeviceLike, place
from .geometry.cameras import camera_centers
from .models.holo_model import HoloDiffusionModel
from .models.metrics import calc_psnr, preprocess_input
from .render_eval import render_image_chunked

logger = logging.getLogger(__name__)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float64)


def _filter2d_valid(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 'valid' 2-D gaussian filtering of (H, W, C)."""
    size = len(k)
    H, W, C = img.shape
    out = np.zeros((H, W - size + 1, C), np.float64)
    for i in range(size):
        out += k[i] * img[:, i:i + W - size + 1]
    out2 = np.zeros((H - size + 1, out.shape[1], C), np.float64)
    for i in range(size):
        out2 += k[i] * out[i:i + H - size + 1]
    return out2


def ssim(a: np.ndarray, b: np.ndarray, C1=0.01 ** 2, C2=0.03 ** 2, win_size: int = 11, sigma: float = 1.5) -> float:
    """Windowed SSIM (Wang et al. 2004) in float64: 11 x 11 gaussian window
    (sigma 1.5), 'valid' padding, averaged over pixels and channels (the
    skimage / pytorch-msssim protocol). Images (H, W, C) in [0, 1]."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    # images smaller than the window: the largest odd window that fits
    win_size = min(win_size, a.shape[0], a.shape[1])
    win_size -= 1 - win_size % 2
    k = _gaussian_kernel(win_size, sigma)
    mu_a = _filter2d_valid(a, k)
    mu_b = _filter2d_valid(b, k)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sigma_a = _filter2d_valid(a * a, k) - mu_aa
    sigma_b = _filter2d_valid(b * b, k) - mu_bb
    sigma_ab = _filter2d_valid(a * b, k) - mu_ab
    s = ((2 * mu_ab + C1) * (2 * sigma_ab + C2)) / ((mu_aa + mu_bb + C1) * (sigma_a + sigma_b + C2))
    return float(s.mean())


def camera_difficulty(scene: FrameData, target_idx: int, source_idx=None) -> float:
    """Implicitron's `calc_camera_difficulty`: the largest cosine between the
    normalised world camera centre of the target and those of the source
    views (every other frame when `source_idx` is None). Near 1: a source
    nearly coincides with the target's direction (easy)."""
    centers = camera_centers(scene.camera).cpu().numpy()
    d = centers / np.maximum(np.linalg.norm(centers, axis=-1, keepdims=True), 1e-8)
    if source_idx is None:
        source_idx = [i for i in range(len(centers)) if i != target_idx]
    cos = d[np.asarray(source_idx)] @ d[target_idx]
    return float(cos.max())


def camera_difficulty_bin_edges(bin_breaks=(0.97, 0.98)):
    """Implicitron's `get_camera_difficulty_bin_edges`: hard [0.5, b0),
    medium [b0, b1), easy [b1, 1 + eps). A target below 0.5 lies in no
    named bin (it still counts toward "overall")."""
    eps = 1e-5
    b0, b1 = bin_breaks
    return [(0.5, b0), (b0, b1), (b1, 1.0 + eps)], ["hard", "medium", "easy"]


def _unit_float(x: torch.Tensor) -> np.ndarray:
    """A host array in [0, 1]: uint8 (the CO3D cache's storage) / 255."""
    x = x.cpu().numpy()
    return x.astype(np.float32) / 255.0 if x.dtype == np.uint8 else x


@torch.no_grad()
def evaluate_new_view_synthesis(
    model: HoloDiffusionModel,
    scenes: Iterable[FrameData],
    n_source_views: int = 9,
    n_eval_targets_per_seq: int = 2,
    difficulty_bin_breaks=(0.97, 0.98),
    perceptual_fn: Optional[Callable] = None,
    dump_path: Optional[str] = None,
    seed: int = 0,
    eval_batches: Optional[Iterable[FrameData]] = None,
    device: DeviceLike = None,
    timings: Optional[Dict[str, List[float]]] = None,
) -> Dict:
    """Few-view reconstruction evaluation: pool a grid from source views,
    render held-out targets at the frames' size, score each. Returns the
    overall and per-bin aggregates, the protocol and the records.

    With `eval_batches` (the CO3D challenge protocol, `load_eval_batches`)
    each batch's row 0 is the target and the rest its known frames;
    otherwise `np.random.RandomState(seed)` picks targets in each scene and
    up to `n_source_views` of the other frames as sources. The model runs
    on `device` (CUDA unless the caller passes "cpu"); scenes may lie on
    the host. `timings`, when given, receives the seconds of each target's
    pooling, render and host metrics under "pool_s", "render_s" and
    "metrics_s" (each phase waits for the device).
    """
    dev = place(model, device)
    rng = np.random.RandomState(seed)
    if eval_batches is not None:
        scenes = eval_batches
    if timings is not None:
        for key in ("pool_s", "render_s", "metrics_s"):
            timings.setdefault(key, [])

    records = []
    for si, scene in enumerate(scenes):
        n = scene.batch_size
        if eval_batches is not None:
            targets = [0]
        else:
            targets = rng.choice(n, size=min(n_eval_targets_per_seq, n), replace=False)
        for ti in targets:
            ti = int(ti)
            sources = np.array([i for i in range(n) if i != ti])
            if eval_batches is None and len(sources) > n_source_views:
                sources = rng.choice(sources, n_source_views, replace=False)
            t0 = time.perf_counter()
            src = scene[torch.as_tensor(sources, device=scene.device)].to(dev)
            img, fg_src, _ = preprocess_input(src.image_rgb, src.fg_probability, None, model.mask_images,
                                              model.mask_depths, model.mask_threshold, model.bg_color)
            grid = model.pool_features(img, src.camera, fg_src, src.mask_crop)
            if timings is not None and dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            H, W = int(scene.image_rgb.shape[1]), int(scene.image_rgb.shape[2])
            out = render_image_chunked(model, scene.camera[ti], grid, image_height=H, image_width=W, device=dev)
            out = {k: v.cpu().numpy() for k, v in out.items()}
            t2 = time.perf_counter()
            gt = _unit_float(scene.image_rgb[ti])
            fg = _unit_float(scene.fg_probability[ti, ..., 0]) > model.mask_threshold
            # composite the target onto white, as preprocess_input does
            gt_m = np.where(fg[..., None], gt, 1.0)
            pred = out["images_render"]
            mse = float(((pred - gt_m) ** 2).mean())
            mse_fg = float((((pred - gt_m) ** 2) * fg[..., None]).sum() / max(fg.sum() * 3, 1))
            pred_mask = out["masks_render"][..., 0] > 0.5
            inter = float(np.minimum(pred_mask, fg).sum())
            union = float(np.maximum(pred_mask, fg).sum())
            rec = {
                "seq": si,
                "target": ti,
                "difficulty": camera_difficulty(scene, ti, sources),
                "psnr": float(calc_psnr(torch.tensor(mse, dtype=torch.float32))),
                "psnr_fg": float(calc_psnr(torch.tensor(mse_fg, dtype=torch.float32))),
                "ssim": ssim(pred, gt_m),
                "mask_iou": inter / max(union, 1.0),
                "lpips": float(perceptual_fn(pred, gt_m)) if perceptual_fn else None,
            }
            if scene.depth_map is not None:
                d_gt = scene.depth_map[ti, ..., 0].cpu().numpy().astype(np.float32)
                valid = (d_gt > 0) & fg
                if valid.sum() > 0:
                    rec["depth_abs_fg"] = float(np.abs(out["depths_render"][..., 0] - d_gt)[valid].mean())
            records.append(rec)
            if timings is not None:
                timings["pool_s"].append(t1 - t0)
                timings["render_s"].append(t2 - t1)
                timings["metrics_s"].append(time.perf_counter() - t2)

    # bins: >= low, < high; a target below the hard bin's floor is in none
    edges, names = camera_difficulty_bin_edges(tuple(difficulty_bin_breaks))
    bins: Dict[str, List[Dict]] = {name: [] for name in names}
    for r in records:
        for (lo, hi), name in zip(edges, names):
            if lo <= r["difficulty"] < hi:
                bins[name].append(r)
                break

    def agg(rs):
        if not rs:
            return {}
        keys = ["psnr", "psnr_fg", "ssim", "mask_iou", "depth_abs_fg"]
        return {k: float(np.mean([r[k] for r in rs if r.get(k) is not None]))
                for k in keys if any(r.get(k) is not None for r in rs)}

    result = {
        "overall": agg(records),
        "per_bin": {k: agg(v) for k, v in bins.items()},
        "n_evals": len(records),
        "protocol": "eval_batches" if eval_batches is not None else "random_targets",
        "records": records,
    }
    if dump_path:
        os.makedirs(os.path.dirname(os.path.abspath(dump_path)), exist_ok=True)
        with open(dump_path, "w") as f:
            json.dump(result, f, indent=2)
        logger.info("eval results -> %s", dump_path)
    return result
