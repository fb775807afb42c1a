"""FID and KID, the paper's sample-quality metrics (port of
holo_diffusion_tpu/evaluation_fid.py).

The statistics are host float64 numpy, as in the JAX package:
`compute_feature_stats` (features -> mean, covariance), `frechet_distance`
(the matrix square root by a symmetric eigendecomposition), `kid_score`
(unbiased polynomial-kernel MMD^2 over random subsets drawn with
`np.random.RandomState(seed)`, so the subsets are the JAX package's own) and
`fid_kid_between_image_sets`. The feature functions run their extractor on
its device under `torch.no_grad()` and return numpy:
`inception_pooled_feature_fn` (FID-InceptionV3 pool3, the standard
protocol) and `vgg_pooled_feature_fn` (VGG16 relu5_3, globally averaged:
"VGG-FID", on another scale).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .device import module_device
from .models.inception import FIDInceptionV3
from .models.lpips import VGG16Features


def compute_feature_stats(
    images: np.ndarray,
    feature_fn: Callable[[np.ndarray], np.ndarray],
    batch_size: int = 32,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """images: (N, H, W, 3) in [0, 1] -> (mu (D,), sigma (D, D), feats (N, D)).

    feature_fn maps a (B, H, W, 3) batch to (B, D) features."""
    feats = []
    for i in range(0, len(images), batch_size):
        f = np.asarray(feature_fn(images[i:i + batch_size]))
        assert f.ndim == 2, f.shape
        feats.append(f.astype(np.float64))
    feats = np.concatenate(feats, axis=0)
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(sigma), feats


def _sqrtm_psd(m: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Symmetric PSD matrix square root via eigendecomposition."""
    vals, vecs = np.linalg.eigh((m + m.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals + eps)) @ vecs.T


def frechet_distance(
    mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray
) -> float:
    """FID = |mu1-mu2|^2 + tr(S1 + S2 - 2 (S1^{1/2} S2 S1^{1/2})^{1/2}); the
    symmetric product keeps the eigendecomposition real."""
    diff = mu1 - mu2
    s1h = _sqrtm_psd(sigma1)
    covmean = _sqrtm_psd(s1h @ sigma2 @ s1h)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def kid_score(
    feats_a: np.ndarray,
    feats_b: np.ndarray,
    n_subsets: int = 100,
    subset_size: Optional[int] = None,
    seed: int = 0,
) -> Tuple[float, float]:
    """KID: unbiased MMD^2 with the kernel k(x, y) = (x.y / D + 1)^3,
    averaged over random subsets (Binkowski et al. 2018). Returns (mean,
    std) over the subsets."""
    rng = np.random.RandomState(seed)
    n = min(len(feats_a), len(feats_b))
    m = subset_size or min(1000, n)
    D = feats_a.shape[1]

    def poly(x, y):
        return (x @ y.T / D + 1.0) ** 3

    def sum_off(k):  # the mean of the off-diagonal entries
        return (k.sum() - np.trace(k)) / (m * (m - 1))

    scores = []
    for _ in range(n_subsets):
        x = feats_a[rng.choice(len(feats_a), m, replace=False)]
        y = feats_b[rng.choice(len(feats_b), m, replace=False)]
        scores.append(sum_off(poly(x, x)) + sum_off(poly(y, y)) - 2.0 * poly(x, y).mean())
    return float(np.mean(scores)), float(np.std(scores))


def fid_kid_between_image_sets(
    images_a: np.ndarray,
    images_b: np.ndarray,
    feature_fn: Callable[[np.ndarray], np.ndarray],
    batch_size: int = 32,
    kid_subset_size: Optional[int] = None,
    kid_subsets: int = 100,
) -> Dict[str, float]:
    """FID and KID between two (N, H, W, 3) image stacks in [0, 1]."""
    mu_a, sig_a, fa = compute_feature_stats(images_a, feature_fn, batch_size)
    mu_b, sig_b, fb = compute_feature_stats(images_b, feature_fn, batch_size)
    kid_mean, kid_std = kid_score(fa, fb, n_subsets=kid_subsets, subset_size=kid_subset_size)
    return {
        "fid": frechet_distance(mu_a, sig_a, mu_b, sig_b),
        "kid_mean": kid_mean,
        "kid_std": kid_std,
        "n_a": len(fa),
        "n_b": len(fb),
    }


def vgg_pooled_feature_fn(model: VGG16Features, min_input_size: int = 64) -> Callable[[np.ndarray], np.ndarray]:
    """feature_fn of VGG16 relu5_3, globally averaged (label the numbers
    "VGG-FID"/"VGG-KID"), on the model's device. An input whose short side
    is below `min_input_size` is first upsampled bilinearly, aspect kept, so
    that short side reaches it (VGG's four 2x pools leave no relu5_3 map
    below 16 px); only upsampling, so no antialiasing."""
    dev = module_device(model)
    model.eval()

    @torch.no_grad()
    def fn(imgs: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(imgs, np.float32), device=dev)
        _, H, W, _ = x.shape
        if min(H, W) < min_input_size:
            scale = min_input_size / min(H, W)
            nh = max(min_input_size, int(round(H * scale)))
            nw = max(min_input_size, int(round(W * scale)))
            x = F.interpolate(x.permute(0, 3, 1, 2), size=(nh, nw), mode="bilinear",
                              align_corners=False).permute(0, 2, 3, 1)
        relu5_3 = model.taps_nchw(x.permute(0, 3, 1, 2))[-1]
        return torch.mean(relu5_3, dim=(2, 3)).cpu().numpy()

    return fn


def inception_pooled_feature_fn(model: FIDInceptionV3) -> Callable[[np.ndarray], np.ndarray]:
    """feature_fn of FID-InceptionV3 pool3 (2048-d; inputs resized to 299^2
    inside the model), on the model's device. With the published
    pt_inception weights the numbers are the paper's Inception-FID; with
    random weights a protocol smoke extractor."""
    dev = module_device(model)
    model.eval()

    @torch.no_grad()
    def fn(imgs: np.ndarray) -> np.ndarray:
        return model(torch.as_tensor(np.asarray(imgs, np.float32), device=dev)).cpu().numpy()

    return fn
