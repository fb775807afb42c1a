"""The port's FID InceptionV3 (holo_diffusion_torch/models/inception.py)
against the JAX package's on the same random pytorch-fid-layout weights
(the JAX package's own test's `_rand_sd`, through `inception_params_from_torch`,
never `init`): pool3 features of one 64^2 input (upsampled to 299^2) and of
one 320^2 input (shrunk, antialiased as `jax.image.resize` shrinks) at
2e-3 (the JAX package's tolerance for this 94-conv net), the count-excluding
average pool at 1e-6, the 299^2 resize alone, and the weight loading and
converters."""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import os
import sys

import jax
import jax.image
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(__file__))
from test_inception import _rand_sd  # noqa: E402

from holo_diffusion_torch.models import inception as ti  # noqa: E402
from holo_diffusion_torch.ops.image import resize_bilinear_antialiased  # noqa: E402
from holo_diffusion_tpu.models import inception as ji  # noqa: E402

FEATURE_TOL = 2e-3  # abs + rel, as tests/test_inception.py holds JAX to torch
POOL_TOL = 1e-6
RESIZE_TOL = 2e-5  # float32 rounding of the filter weights (1.2e-5 seen shrinking 320 -> 299)


@pytest.fixture(scope="module")
def weights():
    sd = _rand_sd(np.random.RandomState(0))
    return sd, ji.inception_params_from_torch(sd)


def _port_model(sd):
    model = ti.FIDInceptionV3()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model.eval()


@pytest.mark.parametrize("size", [64, 320])
def test_pool3_features_match_jax(weights, size):
    """B 1: 64^2 grows to 299^2, 320^2 shrinks to it."""
    sd, variables = weights
    x = np.random.RandomState(size).uniform(0, 1, (1, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(ji.FIDInceptionV3().apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_model(sd)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 2048)
    np.testing.assert_allclose(got, want, atol=FEATURE_TOL, rtol=FEATURE_TOL)


def test_avg_pool_nopad_matches_jax():
    x = np.random.RandomState(1).normal(size=(2, 7, 9, 4)).astype(np.float32)
    want = np.asarray(ji._avg_pool_3x3_s1_nopad(jnp.asarray(x)))
    got = ti._avg_pool_3x3_s1_nopad(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=POOL_TOL, rtol=0)


@pytest.mark.parametrize("size", [(64, 80), (320, 320), (512, 512)])
def test_resize_to_299_matches_jax(size):
    """`jax.image.resize(..., "bilinear")`, which the JAX package's extractor
    calls, antialiases when it shrinks; the port's resize does the same.
    Without antialiasing a shrink from 512^2 lands far from it."""
    x = np.random.RandomState(2).uniform(0, 1, (1, *size, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 299, 299, 3), "bilinear"))
    got = resize_bilinear_antialiased(torch.from_numpy(x), 299, 299).numpy()
    np.testing.assert_allclose(got, want, atol=RESIZE_TOL, rtol=0)
    plain = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(299, 299), mode="bilinear",
                          align_corners=False).permute(0, 2, 3, 1).numpy()
    if size[0] > 299:
        assert np.abs(plain - want).max() > 0.1
    else:
        np.testing.assert_allclose(plain, want, atol=RESIZE_TOL, rtol=0)


def test_state_dict_from_jax_inverts_the_jax_converter(weights):
    sd, variables = weights
    back = ti.inception_state_dict_from_jax(variables)
    assert set(back) == {k for k in sd if not k.startswith(("fc.", "AuxLogits."))}
    for k, v in back.items():
        assert torch.equal(v, torch.from_numpy(sd[k])), k
    ti.FIDInceptionV3().load_state_dict(back)  # strict


def test_loads_a_pytorch_fid_state_dict(weights):
    """The fc head and the AuxLogits tower are ignored; every feature-path
    key is required; an unknown key raises, as in the JAX converter."""
    sd, _ = weights
    full = {k: torch.from_numpy(v) for k, v in sd.items()}
    assert {"fc.weight", "fc.bias", "AuxLogits.conv0.conv.weight"} <= set(full)
    model = ti.FIDInceptionV3()
    model.load_state_dict(full)
    assert torch.equal(model.Mixed_7c.branch_pool.bn.running_var, full["Mixed_7c.branch_pool.bn.running_var"])
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict({k: v for k, v in full.items() if not k.startswith("Mixed_7c.")})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        model.load_state_dict({**full, "Mixed_8a.conv.weight": torch.zeros(1)})


def test_bn_stays_on_running_statistics(weights):
    """In train mode too (the FID net is inference only)."""
    sd, _ = weights
    model = _port_model(sd)
    x = torch.rand(2, 75, 75, 3)
    with torch.no_grad():
        a = model(x)
        model.train()
        b = model(x)
    assert torch.equal(a, b)
