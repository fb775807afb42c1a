"""The port's LPIPS (holo_diffusion_torch/models/lpips.py) against the JAX
package's on the same torchvision-layout random weights: the five VGG16
taps (1e-5 of each tap's scale) and the distance (1e-5 absolute) at 32 and
64 px, the weight converters both ways, the torch-file loader with and
without an LPIPS head file, and LPIPS in `Experiment.run_eval_only`. The
JAX side gets its variables through `lpips_params_from_torch`, never
`init`."""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_tiny_config import LOOP, tiny_cfg  # noqa: E402

from holo_diffusion_torch.experiment import Experiment  # noqa: E402
from holo_diffusion_torch.models import lpips as tl  # noqa: E402
from holo_diffusion_tpu.models import lpips as jl  # noqa: E402

TAP_TOL = 1e-5  # relative to each tap's largest magnitude; 13 float32 conv layers
DIST_TOL = 1e-5


def _random_vgg_sd(seed=0):
    """A torchvision `vgg16().features` state_dict of random weights, scaled
    like the JAX package's LPIPS test so activations stay O(1)."""
    rs = np.random.RandomState(seed)
    sd, cin = {}, 3
    for si, spec in zip(tl._conv_sequence_indices(), [s for s in tl.VGG16_CHANNELS if s != "M"]):
        sd[f"{si}.weight"] = (0.2 * rs.randn(spec, cin, 3, 3) * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
        sd[f"{si}.bias"] = (0.05 * rs.randn(spec)).astype(np.float32)
        cin = spec
    return sd


def _lins(seed=1):
    rs = np.random.RandomState(seed)
    return [rs.rand(c).astype(np.float32) for c in tl.TAP_DIMS]


def _images(seed, size, n=1):
    rs = np.random.RandomState(seed)
    a = rs.rand(n, size, size, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rs.randn(n, size, size, 3), 0, 1).astype(np.float32)
    return a, b


@pytest.fixture(scope="module")
def weights():
    sd = _random_vgg_sd()
    lins = _lins()
    return sd, lins, jl.lpips_params_from_torch(sd, lins)


def _port_lpips(sd, lins):
    model = tl.LPIPS()
    model.vgg.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.no_grad():
        for i, w in enumerate(lins):
            getattr(model, f"lin{i}").copy_(torch.from_numpy(w))
    return model.eval()


@pytest.mark.parametrize("size", [32, 64])
def test_vgg_taps_match_jax(weights, size):
    sd, _, variables = weights
    x, _ = _images(size, size, n=2)
    want = jl.VGG16Features().apply({"params": variables["params"]["vgg"]}, jnp.asarray(x))
    vgg = tl.VGG16Features()
    vgg.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.no_grad():
        got = vgg(torch.from_numpy(x))
    assert [tuple(t.shape) for t in got] == [w.shape for w in want]
    assert [t.shape[-1] for t in got] == list(tl.TAP_DIMS)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=TAP_TOL * np.abs(w).max(), rtol=0)


@pytest.mark.parametrize("size", [32, 64])
def test_lpips_distance_matches_jax(weights, size):
    sd, lins, variables = weights
    a, b = _images(10 + size, size, n=2)
    want = np.asarray(jl.LPIPS().apply(variables, jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = _port_lpips(sd, lins)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (2,)
    np.testing.assert_allclose(got, want, atol=DIST_TOL, rtol=0)
    with torch.no_grad():
        same = _port_lpips(sd, lins)(torch.from_numpy(a), torch.from_numpy(a))
    assert float(same.abs().max()) < 1e-6


def test_state_dict_from_jax_inverts_the_jax_converter(weights):
    sd, lins, variables = weights
    back = tl.lpips_state_dict_from_jax(variables)
    model = tl.LPIPS()
    model.load_state_dict(back)  # strict: every key, no extra
    for k, v in sd.items():
        assert torch.equal(back[f"vgg.{k}"], torch.from_numpy(v)), k
    for i, w in enumerate(lins):
        assert torch.equal(back[f"lin{i}"], torch.from_numpy(w))


@pytest.mark.parametrize("layout", ["features_prefixed", "bare_with_head", "bare_no_head"])
def test_loader_from_torch_files_matches_jax(weights, layout, tmp_path):
    """`load_lpips_from_torch_files` on the same files as the JAX loader:
    a full torchvision vgg16 state_dict (`features.` keys and a classifier)
    or the bare features; with an lpips head file, or all-ones heads."""
    sd, lins, _ = weights
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    if layout == "features_prefixed":
        tsd = {**{f"features.{k}": v for k, v in tsd.items()}, "classifier.0.weight": torch.zeros(4, 4)}
    torch.save(tsd, tmp_path / "vgg.pth")
    lin_path = None
    if layout == "bare_with_head":
        torch.save({f"lin{i}.model.1.weight": torch.from_numpy(w).reshape(1, -1, 1, 1) for i, w in enumerate(lins)},
                   tmp_path / "lin.pth")
        lin_path = str(tmp_path / "lin.pth")
    j_fn = jl.load_lpips_from_torch_files(str(tmp_path / "vgg.pth"), lin_path)
    t_fn = tl.load_lpips_from_torch_files(str(tmp_path / "vgg.pth"), lin_path, device="cpu")
    a, b = _images(5, 32)
    got, want = t_fn(a[0], b[0]), j_fn(a[0], b[0])
    assert isinstance(got, float) and got > 0
    assert got == pytest.approx(want, abs=DIST_TOL)


def test_lpips_entry_points_raise_without_cuda(weights, tmp_path, monkeypatch):
    sd, _, _ = weights
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "vgg.pth")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tl.load_lpips_from_torch_files(str(tmp_path / "vgg.pth")),
                 lambda: tl.make_lpips_fn(tl.LPIPS())):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_run_eval_only_reports_lpips(weights, tmp_path):
    """`lpips_vgg_weights_path` (and `lpips_lin_weights_path`) give every
    evaluated target a finite LPIPS, timed apart under "lpips_s"."""
    sd, lins, _ = weights
    torch.save({f"features.{k}": torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "vgg.pth")
    torch.save({f"lin{i}.model.1.weight": torch.from_numpy(w).reshape(1, -1, 1, 1) for i, w in enumerate(lins)},
               tmp_path / "lin.pth")
    exp = Experiment(tiny_cfg(tmp_path / "exp", [f"lpips_vgg_weights_path={tmp_path / 'vgg.pth'}",
                                        f"lpips_lin_weights_path={tmp_path / 'lin.pth'}",
                                        LOOP + "eval_only=true"]), device="cpu")
    timings = {}
    res = exp.run_eval_only(timings=timings)
    values = [r["lpips"] for r in res["records"]]
    assert len(values) == res["n_evals"] > 0 and all(np.isfinite(v) and v > 0 for v in values)
    assert len(timings["lpips_s"]) == len(values)
