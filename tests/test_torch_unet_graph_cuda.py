"""The UNet's CUDA graphs (holo_diffusion_torch/models/unet3d.py) on the
card, at the hydrant release config (16^3 x 64) and at the reference
model's 32^3 x 128 grid, each built with the benchmark's weights from a
seed: a graphed no-grad forward bitwise the eager body's; a 20-step DDPM
chain from one seeded generator bitwise with and without the graphs;
outputs of successive calls that do not alias; an in-place weight change
read by the next replay without a capture; moved weights captured anew;
and a grad-enabled forward that runs eagerly and back-propagates. Every
test here is marked `cuda` and skips without a CUDA device. The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_unet_graph_cuda.py -m cuda -q
"""
import itertools

import pytest
import torch

from holo_diffusion_torch.models import diffusion as gd
from holo_diffusion_torch.models import unet3d
from holo_diffusion_torch.utils.profiling import counters, reset_counters

SEED = 2 ** 31 + 2411


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


_models = {}


def _model(config):
    """The program's model of the benchmark's configuration `config`, with
    the benchmark's weights from SEED, in eval mode."""
    if config not in _models:
        from benchmark.harness.manifest import Manifest
        from benchmark.harness.program import Context, program_model

        man = Manifest()
        ctx = Context(man.config(config), man.mix("sample"), man.limits("hydrant.sample"), SEED, _device())
        _models[config] = program_model(ctx, ctx.weights()).eval()
    return _models[config]


def _inputs(model, batch, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r, C = model.resol, model.feature_size
    x = torch.randn(batch, r, r, r, C, generator=g, device="cuda")
    return x, torch.tensor([999, 412][:batch], device="cuda")


def _eager(unet, x, t):
    with torch.no_grad():
        return unet._forward(x, t)


def _graphs(unet):
    return unet3d._UNetGraphs._of[unet][torch.device("cuda", torch.cuda.current_device())]


def _counted(fn):
    """fn()'s result and the counters it added while a profiler recorded."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        reset_counters()
        out = fn()
        torch.cuda.synchronize()
        got = counters()
    return out, got


@pytest.mark.cuda
@pytest.mark.parametrize("config, batch", [("hydrant", 1), ("hydrant", 2), ("hydrant_g32c128", 1)],
                         ids=["16x64-b1", "16x64-b2", "32x128-b1"])
def test_graphed_forward_equals_eager_bitwise(config, batch):
    _device()
    unet = _model(config).net_3d
    x, t = _inputs(_model(config), batch)
    with torch.no_grad():
        got, counted = _counted(lambda: unet(x, t))
        again, counted_again = _counted(lambda: unet(x, t))
    assert counted["unet_graphed"] == 1 and "unet_eager" not in counted
    assert counted_again == {"unet_graphed": 1}
    want = _eager(unet, x, t)
    assert got.shape == want.shape == x.shape
    assert torch.equal(got, want) and torch.equal(again, want)


@pytest.mark.cuda
def test_ddpm_chain_is_bitwise_with_and_without_the_graph():
    """20 steps of `p_sample_loop_progressive` from one seeded generator:
    the same samples and x0 predictions, and the same draws, whether the
    UNet replays its graph or runs its eager body."""
    _device()
    model = _model("hydrant")
    shape = (1, model.resol, model.resol, model.resol, model.feature_size)

    def chain(fn):
        g = torch.Generator(device="cuda").manual_seed(SEED)
        with torch.no_grad():
            steps = gd.p_sample_loop_progressive(model.schedule, fn, shape, generator=g, device="cuda")
            return [(s["sample"], s["pred_xstart"]) for s in itertools.islice(steps, 20)]

    graphed, counted = _counted(lambda: chain(model.apply_net_3d))
    eager = chain(lambda x, t: model.net_3d._forward(x, t))
    assert counted["unet_graphed"] == 20 and "unet_eager" not in counted
    for k, ((gs, gp), (es, ep)) in enumerate(zip(graphed, eager)):
        assert torch.equal(gp, ep), f"pred_xstart, step {k}"
        assert torch.equal(gs, es), f"sample, step {k}"


@pytest.mark.cuda
def test_successive_calls_do_not_alias():
    _device()
    unet = _model("hydrant").net_3d
    x, t = _inputs(_model("hydrant"), 1)
    y, s = _inputs(_model("hydrant"), 1, seed=1)
    with torch.no_grad():
        a = unet(x, t)
        a_copy = a.clone()
        b = unet(y, s)
    torch.cuda.synchronize()
    assert torch.equal(a, a_copy) and not torch.equal(a, b)
    ptrs = {a.untyped_storage().data_ptr(), b.untyped_storage().data_ptr()}
    static = {g[2].untyped_storage().data_ptr() for g in _graphs(unet).graphs.values()}
    assert len(ptrs) == 2 and not ptrs & static


@pytest.mark.cuda
def test_in_place_weight_change_is_read_without_a_capture():
    """An in-place change of the last conv's weight (as an optimizer step
    or `load_state_dict` makes) shows in the next replay; nothing is
    captured again."""
    _device()
    unet = _model("hydrant").net_3d
    x, t = _inputs(_model("hydrant"), 1)
    w = unet.out[2].weight
    held = w.detach().clone()
    with torch.no_grad():
        before = unet(x, t)
        w.mul_(0.5)
        try:
            after, counted = _counted(lambda: unet(x, t))
            want = _eager(unet, x, t)
        finally:
            w.copy_(held)
    assert counted == {"unet_graphed": 1}
    assert torch.equal(after, want) and not torch.equal(after, before)


@pytest.mark.cuda
def test_moved_weights_capture_anew():
    """The weights moved off the card and back (their old storage held, so
    the new one lies elsewhere): one new capture, its output bitwise the
    eager body's. The capture's warm-up and the capture each count the
    routes of hydrant's 82 3D convolutions: 51 of at most 64 positions on
    K9, 31 on cuDNN."""
    dev = _device()
    unet = _model("hydrant").net_3d
    x, t = _inputs(_model("hydrant"), 1)
    with torch.no_grad():
        unet(x, t)
    held = [p.detach() for p in unet.parameters()]
    old = dict(_graphs(unet).graphs)
    unet.to("cpu").to(dev)
    with torch.no_grad():
        got, counted = _counted(lambda: unet(x, t))
    del held
    assert counted == {"unet_graph_captures": 1, "unet_graphed": 1, "conv3d_small": 2 * 51, "conv3d_cudnn": 2 * 31}
    assert not any(g[0] is o[0] for g in _graphs(unet).graphs.values() for o in old.values())
    assert torch.equal(got, _eager(unet, x, t))


@pytest.mark.cuda
def test_grad_enabled_forward_runs_eagerly_and_backpropagates():
    """With grad on the forward takes the eager body (counted `unet_eager`),
    gives its output and the same gradients as the body called directly."""
    _device()
    unet = _model("hydrant").net_3d
    x, t = _inputs(_model("hydrant"), 1)
    w = unet.out[2].weight

    def grads(fn):
        unet.zero_grad(set_to_none=True)
        xg = x.clone().requires_grad_(True)
        out = fn(xg, t)
        out.square().mean().backward()
        return out.detach(), xg.grad, w.grad.clone()

    (out, gx, gw), counted = _counted(lambda: grads(unet))
    want_out, want_gx, want_gw = grads(unet._forward)
    unet.zero_grad(set_to_none=True)
    assert counted["unet_eager"] == 1 and "unet_graphed" not in counted
    assert torch.equal(out, want_out)
    for got, want in ((gx, want_gx), (gw, want_gw)):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
