"""The controls on the card, at the cell's own size: the reference in TF32
(the precision below the configurations' float32) put in the program's
place fails at least one of the cell's numbers, while the program on the
same seed passes them all. Needs a CUDA device (run on the GPU with
`python -m pytest benchmark/tests -m cuda`)."""
import pytest
import torch

from benchmark.calibrate import calibrate
from benchmark.harness.manifest import Manifest

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("workload", ["hydrant.train", "hydrant.frames", "teddybear.train", "hydrant.sample"])
def test_control_fails_and_program_passes(card, workload):
    man = Manifest()
    limits = man.limits(workload)
    rows, _ = calibrate(man, workload, [2 ** 31 + 91], 1, device=card)
    row = rows[0]
    assert all(row["program"][k] <= v for k, v in limits.items()), row["program"]
    assert any(row["tf32"][k] > v for k, v in limits.items()), row["tf32"]
    if "half_batch" in row:
        assert any(row["half_batch"][k] > v for k, v in limits.items()), row["half_batch"]
