"""The UNet's graph route (holo_diffusion_torch/models/unet3d.py) on the
CPU, where its CUDA graphs do not engage: the route refuses a CPU input,
a grad-enabled forward and a forward made while the current stream
captures, each with its reason; a CPU forward runs the eager body and
counts `unet_eager`; the graphs' cache key follows where the weights are
stored, not their values; and the benchmark's `graphed_unet.sample`
reads the counters' share. The card's side is
tests/test_torch_unet_graph_cuda.py."""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import types

import pytest
import torch

from benchmark.harness.manifest import Manifest
from holo_diffusion_torch.models import unet3d
from holo_diffusion_torch.models.unet3d import UNetModel3D
from holo_diffusion_torch.utils.profiling import count, counters, reset_counters

CUDA = torch.device("cuda")  # a device object alone: no card is touched


def _unet():
    torch.manual_seed(0)
    return UNetModel3D(in_channels=8, model_channels=32, out_channels=8, channel_mult=(1, 2),
                       attention_resolutions=(2,), num_heads=2).eval()


def _inputs(batch=1):
    g = torch.Generator().manual_seed(1)
    return torch.randn(batch, 4, 4, 4, 8, generator=g), torch.tensor([17, 940][:batch])


@pytest.mark.parametrize("device, grad, capturing, reason", [
    (torch.device("cpu"), False, False, "not a CUDA device"),
    (CUDA, True, False, "grad is enabled"),
    (CUDA, False, True, "capturing"),
    (CUDA, False, False, None),
], ids=["cpu-input", "grad-enabled", "capturing", "graphed"])
def test_route_refuses_with_a_reason(monkeypatch, device, grad, capturing, reason):
    """Each refusal names its cause; a no-grad CUDA forward outside a
    capture is the one that replays a graph."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    with torch.set_grad_enabled(grad):
        got = unet3d.graph_refusal(device)
    if reason is None:
        assert got is None
    else:
        assert reason in got


@pytest.mark.parametrize("grad", [False, True], ids=["no-grad", "grad"])
def test_cpu_forward_runs_eagerly_and_counts_it(grad):
    """A CPU forward, with grad off or on, adds 1 to `unet_eager` while a
    profiler records and gives the eager body's output; nothing is
    captured or replayed off the card."""
    model, (x, t) = _unet(), _inputs(2)
    with torch.no_grad():
        want = model._forward(x, t)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        reset_counters()
        with torch.set_grad_enabled(grad):
            got = model(x, t)
            got = model(x, t)
        counted = counters()
    assert counted == {"unet_eager": 2}
    assert got.requires_grad == grad
    assert torch.equal(got.detach(), want)
    assert unet3d._UNetGraphs._of.get(model) is None


def test_graph_key_follows_the_weights_storage_not_their_values():
    """Weights updated in place (an optimizer step, `load_state_dict`) keep
    the key, so a graph reads them live; weights stored anew, or the other
    train/eval mode, change it, so the graphs are captured again."""
    model = _unet()
    key = unet3d._graph_key(model)
    w = model.out[2].weight
    with torch.no_grad():
        w.add_(1.0)
    model.load_state_dict(_unet().state_dict())
    assert unet3d._graph_key(model) == key

    w.data = w.data.clone()
    moved = unet3d._graph_key(model)
    assert moved != key
    model.train()
    assert unet3d._graph_key(model) not in (key, moved)


def test_inputs_key_names_shapes_dtypes_and_absent_inputs():
    x, t = _inputs(1)
    key = unet3d._inputs_key((x, t, None, None))
    assert key == (((1, 4, 4, 4, 8), torch.float32), ((1,), torch.int64), None, None)
    assert unet3d._inputs_key((x, t.float(), None, None)) != key
    assert unet3d._inputs_key((x, t, x, None)) != key


@pytest.mark.parametrize("graphed, eager, want", [(20, 0, 100.0), (15, 5, 75.0), (0, 20, 0.0), (0, 0, None)],
                         ids=["all", "three-quarters", "none", "no-counters"])
def test_graphed_unet_metric_reads_the_counters_share(graphed, eager, want):
    """`graphed_unet.sample` is unet_graphed / (unet_graphed + unet_eager)
    in %, None where the program counted neither, or without a trace."""
    reader = Manifest().metric_reader("graphed_unet.sample")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        reset_counters()
        for name, n in (("unet_graphed", graphed), ("unet_eager", eager)):
            if n:
                count(name, n)
    run = types.SimpleNamespace(trace=object(), units=20)
    assert reader.read(run) == want
    assert reader.read(types.SimpleNamespace(trace=None, units=20)) is None
    reset_counters()
