"""The program's plain path (the CPU versions of its kernels) against the
benchmark's reference at a tiny size of both configurations: a training
step and its Adam update, a chunked frame, DDPM steps. Weights, batches,
draws and the grid come from the harness, as in a run on the card."""
import json
import math

import pytest
import torch

from benchmark.harness.manifest import Manifest
from benchmark.harness.runner import make_cell, run_units
from benchmark.reference import cameras as cam
from benchmark.reference.model import Adam
from benchmark.tests.tiny import make_tiny_root

# float32 on the CPU, the same arithmetic in other orders
TOL = {"loss1_gap": 1e-5, "loss_gap": 1e-5, "grad_gap": 1e-4, "grad_median_gap": 1e-4, "change_gap": 1e-3,
       "change_median_gap": 1e-3, "rgb_gap": 1e-5, "normals_gap": 1e-5,
       "pred_gap": 1e-5, "sample_gap": 1e-5}


@pytest.fixture(scope="module")
def man(tmp_path_factory):
    torch.set_num_threads(2)
    return Manifest(make_tiny_root(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("workload,units", [("hydrant.train", 0), ("teddybear.train", 0),
                                            ("hydrant.frames", 3), ("hydrant.sample", 12)])
def test_program_agrees_with_reference(man, workload, units):
    _, cell = make_cell(man, workload, 2 ** 31 + 77, "cpu")
    cell.setup()
    run_units(cell, units)
    cell.release()
    readings = cell.check()["program"]
    assert readings, "no readings"
    for name, value in readings.items():
        assert math.isfinite(value) and value <= TOL[name], (workload, name, value)


def test_training_moves_every_leaf(man):
    """The check steps change each parameter on both sides, and the
    harness read the first gradient of every leaf."""
    _, cell = make_cell(man, "hydrant.train", 5, "cpu")
    cell.setup()
    cell.release()
    ref = cell.reference_run()
    assert set(cell.first_grad) == set(ref["grad"])
    moved = [k for k, v in cell.change.items() if v > 0]
    assert len(moved) == len(cell.change)
    assert all(ref["change"][k] > 0 for k in moved)


def test_orbit_matches_program_poses():
    from holo_diffusion_torch.utils.flyaround import CANONICAL_CO3D_UP_AXIS, simple_360_cameras

    mix = json.loads((Manifest().bench_dir / "mixes" / "frames.json").read_text())
    ours = cam.orbit_cameras(mix["poses"], mix["distance"], mix["elevation"], mix["up"], mix["focal"])
    theirs = simple_360_cameras(mix["poses"], dist=mix["distance"], elevation=mix["elevation"],
                                up=CANONICAL_CO3D_UP_AXIS, focal=mix["focal"])
    assert tuple(mix["up"]) == tuple(CANONICAL_CO3D_UP_AXIS)
    torch.testing.assert_close(ours["R"], theirs.R, atol=1e-6, rtol=0)
    torch.testing.assert_close(ours["T"], theirs.T, atol=1e-5, rtol=0)
    torch.testing.assert_close(ours["focal"], theirs.focal_length)


def test_adam_matches_torch():
    g = torch.Generator().manual_seed(3)
    a = [torch.nn.Parameter(torch.randn(5, 4, generator=g)) for _ in range(2)]
    b = [torch.nn.Parameter(p.detach().clone()) for p in a]
    ours, theirs = Adam(a, 4e-5, (0.9, 0.999)), torch.optim.Adam(b, lr=4e-5, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(3):
        grads = [torch.randn(5, 4, generator=g) for _ in a]
        for p, q, gr in zip(a, b, grads):
            p.grad, q.grad = gr.clone(), gr.clone()
        ours.step()
        theirs.step()
    for p, q in zip(a, b):
        torch.testing.assert_close(p, q, atol=1e-9, rtol=1e-6)
