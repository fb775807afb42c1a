"""Sample-quality evaluation: FID / KID of generated renders against the
dataset's frames (port of holo_diffusion_tpu/evaluate_samples.py), the
paper's headline metric.

Protocol: sample `num_samples` voxel grids with the trained diffusion model
(DDPM, `sampling.sample_random_voxel_features`), render each from
`poses_per_sample` poses of a simple_360 orbit (each sample's orbit turned
by 360 i / num_samples degrees) in one forward of the model a pose, and
score the pooled renders against the dataset's frames (fg-masked onto the
background, resized to the render size) with
`evaluation_fid.fid_kid_between_image_sets`.

Feature extractors:
  * "inception"  the standard FID extractor, FID-InceptionV3 pool3
                 (`models/inception.py`) with a pytorch-fid pt_inception
                 state_dict from `weights_path`: paper-comparable numbers;
  * "random_inception"  the same net, random weights from a seeded torch
                 generator: a protocol smoke test;
  * "vgg"        VGG16 relu5_3 averaged, torchvision vgg16 weights from
                 `weights_path`: "VGG-FID", not on the Inception scale;
  * "random_vgg" VGG16 with seeded random weights: a protocol smoke test.
A custom `feature_fn=` can be given instead.

Random draws: a `torch.Generator` (seeded 0 when none is given), or the
injected per-sample x_T (`noise`) and per-step noise (`step_noise`).
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import DeviceLike, place, resolve_device
from .evaluation_fid import fid_kid_between_image_sets, inception_pooled_feature_fn, vgg_pooled_feature_fn
from .models.holo_model import HoloDiffusionModel
from .models.inception import FIDInceptionV3, random_inception
from .models.lpips import VGG16Features, features_state_dict, random_vgg_features
from .models.metrics import preprocess_input
from .ops.image import resize_bilinear_antialiased
from .sampling import sample_random_voxel_features
from .utils.flyaround import CANONICAL_CO3D_UP_AXIS, simple_360_cameras

logger = logging.getLogger(__name__)

EXTRACTORS = ("vgg", "random_vgg", "inception", "random_inception")


def _add_time(timings: Optional[Dict[str, float]], key: str, t0: float, dev: torch.device) -> float:
    """Add the seconds since `t0` (the device synchronised) to `timings[key]`;
    returns the time now."""
    if timings is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    now = time.perf_counter()
    if timings is not None:
        timings[key] = timings.get(key, 0.0) + now - t0
    return now


@torch.no_grad()
def _real_image_set(scenes, size: Tuple[int, int], model: HoloDiffusionModel, n_real: Optional[int],
                    device: DeviceLike = None) -> np.ndarray:
    """Dataset frames -> (N, H, W, 3) in [0, 1], preprocessed as the model
    sees them (fg-masked onto its background, `preprocess_input`), resized
    to the render size (antialiased, as the JAX package's resize), clipped;
    reading stops once `n_real` frames are in. Computed on `device`."""
    dev = resolve_device(device)
    H, W = size
    images: List[np.ndarray] = []
    for scene in scenes:
        fg = None if scene.fg_probability is None else scene.fg_probability.to(dev)
        img, _, _ = preprocess_input(scene.image_rgb.to(dev), fg, None, model.mask_images, model.mask_depths,
                                     model.mask_threshold, model.bg_color)
        img = resize_bilinear_antialiased(img, H, W)
        images.append(torch.clamp(img, 0.0, 1.0).cpu().numpy())
        if n_real is not None and sum(len(x) for x in images) >= n_real:
            break
    out = np.concatenate(images, axis=0)
    return out[:n_real] if n_real is not None else out


@torch.no_grad()
def _render_sample_set(
    model: HoloDiffusionModel,
    num_samples: int,
    poses_per_sample: int,
    trajectory_distance: float,
    max_iter: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Sequence[torch.Tensor]] = None,
    step_noise: Optional[Sequence[Sequence[torch.Tensor]]] = None,
    device: DeviceLike = None,
    timings: Optional[Dict[str, float]] = None,
) -> np.ndarray:
    """Sample grids and render them -> (num_samples * poses, H, W, 3) in
    [0, 1]. Sample i draws from `generator`, or takes `noise[i]` (x_T) and
    `step_noise[i]` (one tensor a DDPM step). `timings` gathers "sample_s"
    and "frames_s"."""
    dev = place(model, device)
    renders = []
    for i in range(num_samples):
        t0 = time.perf_counter()
        grid = sample_random_voxel_features(
            model, generator, max_iter=max_iter,
            noise=None if noise is None else noise[i],
            step_noise=None if step_noise is None else step_noise[i], device=dev)
        t0 = _add_time(timings, "sample_s", t0, dev)
        # each sample's orbit turned, so few poses a sample still cover it
        cams = simple_360_cameras(poses_per_sample, dist=trajectory_distance, up=CANONICAL_CO3D_UP_AXIS,
                                  azimuth_offset=360.0 * i / max(num_samples, 1))
        for p in range(poses_per_sample):
            preds = model(cams[p].to(dev), voxel_features=grid, training=False)
            renders.append(torch.clamp(preds["images_render"][0], 0.0, 1.0).cpu().numpy())
        _add_time(timings, "frames_s", t0, dev)
        logger.info("sample %d/%d rendered", i + 1, num_samples)
    return np.stack(renders)


def _make_feature_fn(extractor: str, vgg_weights_path: Optional[str], device: DeviceLike = None,
                     seed: int = 0) -> Tuple[Callable, str]:
    """(feature_fn over (B, H, W, 3) in [0, 1] -> (B, D), label); the
    extractor lives on `device` (CUDA unless the caller passes "cpu"). The
    random extractors draw their weights from a torch generator seeded
    `seed`."""
    if extractor not in EXTRACTORS:
        raise ValueError(
            f"unknown extractor {extractor!r} "
            "(vgg | random_vgg | inception | random_inception)"
        )
    if extractor == "vgg" and not vgg_weights_path:
        raise ValueError(
            "extractor='vgg' needs vgg_weights_path (torchvision vgg16 "
            "state_dict); use extractor='random_vgg' for a weights-free "
            "protocol smoke test"
        )
    if extractor == "inception" and not vgg_weights_path:
        raise ValueError(
            "extractor='inception' needs weights_path (pytorch-fid "
            "pt_inception state_dict); use 'random_inception' for a "
            "weights-free protocol smoke test"
        )
    dev = resolve_device(device)
    if extractor == "vgg":
        vgg = VGG16Features()
        vgg.load_state_dict(features_state_dict(torch.load(vgg_weights_path, map_location="cpu", weights_only=True)))
        return vgg_pooled_feature_fn(vgg.to(dev)), extractor
    if extractor == "random_vgg":
        return vgg_pooled_feature_fn(random_vgg_features(seed).to(dev)), extractor
    if extractor == "inception":
        inception = FIDInceptionV3()
        inception.load_state_dict(torch.load(vgg_weights_path, map_location="cpu", weights_only=True))
        return inception_pooled_feature_fn(inception.to(dev)), extractor
    return inception_pooled_feature_fn(random_inception(seed).to(dev)), extractor


def evaluate_samples(
    model: HoloDiffusionModel,
    scenes,
    num_samples: int = 8,
    poses_per_sample: int = 4,
    trajectory_distance: float = 15.0,
    extractor: str = "random_vgg",
    vgg_weights_path: Optional[str] = None,
    feature_fn: Optional[Callable] = None,
    n_real: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    max_iter: Optional[int] = None,
    kid_subset_size: Optional[int] = None,
    dump_path: Optional[str] = None,
    device: DeviceLike = None,
    noise: Optional[Sequence[torch.Tensor]] = None,
    step_noise: Optional[Sequence[Sequence[torch.Tensor]]] = None,
    timings: Optional[Dict[str, float]] = None,
) -> Dict:
    """Sample -> render -> FID/KID against the dataset frames, on `device`
    (CUDA unless the caller passes "cpu").

    Returns {"<label>_fid", "<label>_kid_mean", "<label>_kid_std", the
    counts, the protocol}; the metric keys carry the extractor's label
    because VGG-FID and Inception-FID live on different scales. `timings`
    receives the seconds of "sample_s", "frames_s", "real_s", "features_s"
    and "fid_kid_s" (the host statistics).
    """
    assert model.net_3d_enabled and model.diffusion_enabled, (
        "sample evaluation needs a diffusion model (the reference's "
        "generate_samples.py:90-92 contract)"
    )
    dev = place(model, device)
    model.eval()
    if generator is None and noise is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    size = (model.render_image_height, model.render_image_width)

    fake = _render_sample_set(model, num_samples, poses_per_sample, trajectory_distance, max_iter=max_iter,
                              generator=generator, noise=noise, step_noise=step_noise, device=dev,
                              timings=timings)
    t0 = time.perf_counter()
    real = _real_image_set(scenes, size, model, n_real, device=dev)
    _add_time(timings, "real_s", t0, dev)
    if feature_fn is None:
        feature_fn, label = _make_feature_fn(extractor, vgg_weights_path, device=dev)
    else:
        label = extractor
    features_s = [0.0]

    def extract(imgs):
        t = time.perf_counter()
        out = feature_fn(imgs)
        features_s[0] += time.perf_counter() - t
        return out

    n = min(len(fake), len(real))
    t0 = time.perf_counter()
    scores = fid_kid_between_image_sets(fake, real, extract, kid_subset_size=kid_subset_size or max(2, min(100, n)))
    if timings is not None:
        timings["features_s"] = features_s[0]
        timings["fid_kid_s"] = time.perf_counter() - t0 - features_s[0]
    result = {
        f"{label}_fid": scores["fid"],
        f"{label}_kid_mean": scores["kid_mean"],
        f"{label}_kid_std": scores["kid_std"],
        "n_generated": int(scores["n_a"]),
        "n_real": int(scores["n_b"]),
        "num_samples": num_samples,
        "poses_per_sample": poses_per_sample,
        "extractor": label,
        # True only for FID-InceptionV3 with imported weights: those numbers
        # live on the paper's Inception-FID scale
        "comparable_to_inception_fid": label == "inception",
    }
    if dump_path:
        os.makedirs(os.path.dirname(dump_path) or ".", exist_ok=True)
        with open(dump_path, "w") as f:
            json.dump(result, f, indent=2)
        logger.info("sample-eval results -> %s", dump_path)
    return result
