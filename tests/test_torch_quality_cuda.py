"""The sample-quality extractors and LPIPS on the card against the CPU on the
same seeded random weights and inputs: FID-InceptionV3 pool3 features of
two 512^2 images (2e-3 absolute and relative, the JAX package's tolerance
for this net), VGG16 relu5_3 pooled features at 512^2 (1e-3 of their
scale) and LPIPS of an 800^2 pair (1e-4 relative), all in full float32.
These are marked `cuda` and skip without a card. The last test runs on any
machine: the extractors asked for the card where there is none raise. No
JAX here, so the file also runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_quality_cuda.py -q
"""
import numpy as np
import pytest
import torch

from holo_diffusion_torch import evaluate_samples as tes
from holo_diffusion_torch.device import set_full_precision
from holo_diffusion_torch.evaluation_fid import inception_pooled_feature_fn, vgg_pooled_feature_fn
from holo_diffusion_torch.models.inception import random_inception
from holo_diffusion_torch.models.lpips import LPIPS, make_lpips_fn, random_vgg_features

INCEPTION_TOL = 2e-3
VGG_TOL = 1e-3
LPIPS_TOL = 1e-4


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_full_precision()
    return torch.device("cuda")


def _images(seed, n, size):
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(np.float32)


@pytest.mark.cuda
def test_inception_features_card_match_cpu():
    dev = _device()
    x = _images(0, 2, 512)
    cpu = inception_pooled_feature_fn(random_inception(1))(x)
    card = inception_pooled_feature_fn(random_inception(1).to(dev))(x)
    assert card.shape == (2, 2048) and np.isfinite(card).all()
    np.testing.assert_allclose(card, cpu, atol=INCEPTION_TOL, rtol=INCEPTION_TOL)


@pytest.mark.cuda
def test_vgg_features_card_match_cpu():
    dev = _device()
    x = _images(1, 2, 512)
    cpu = vgg_pooled_feature_fn(random_vgg_features(1))(x)
    card = vgg_pooled_feature_fn(random_vgg_features(1).to(dev))(x)
    assert card.shape == (2, 512) and np.isfinite(card).all()
    np.testing.assert_allclose(card, cpu, atol=VGG_TOL * np.abs(cpu).max(), rtol=0)


@pytest.mark.cuda
def test_lpips_card_matches_cpu():
    dev = _device()
    a = _images(2, 1, 800)[0]
    b = np.clip(a + 0.1 * np.random.RandomState(3).randn(*a.shape), 0, 1).astype(np.float32)

    def model():
        m = LPIPS()
        m.vgg.load_state_dict(random_vgg_features(2).state_dict())
        return m

    cpu = make_lpips_fn(model(), "cpu")(a, b)
    card = make_lpips_fn(model(), dev)(a, b)
    assert np.isfinite(card) and card > 0
    assert card == pytest.approx(cpu, rel=LPIPS_TOL)


def test_extractors_raise_without_cuda(monkeypatch):
    """Asked for the card (no device given) where there is none: raise,
    never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tes._make_feature_fn("random_vgg", None),
                 lambda: tes._make_feature_fn("random_inception", None),
                 lambda: make_lpips_fn(LPIPS())):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
