"""The small-volume convolution K9 (`csrc/small_conv3d.cu`,
`small_conv3d`) on the card, at every call the route takes in a no-grad
forward of the hydrant UNet (51 calls, 16^3 x 64) and of the reference
model's 32^3 x 128 UNet (35), inputs from a seeded forward and the
benchmark's weights from a seed: bitwise `F.conv3d` (cuDNN, float32, TF32
off), bias included, and bitwise itself on a second run; the route's
counters and launches in a no-grad forward; a refused call raising
rather than falling back; and shapes the UNets do not call (boxes at
batch > 1, a halo at 8^3) against float64. Every test here is marked `cuda` and skips
without a CUDA device. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_small_conv3d_cuda.py -m cuda -q

No tolerance at the UNets' calls: K9 forms each output as cuDNN's kernel
for these shapes does, one chain of fused multiply-adds channel by
channel, tap by tap, then the bias, so the two agree bit for bit; a sum
in any other order would be 1e-7 of scale away.
"""
import pytest
import torch
import torch.nn.functional as F

from holo_diffusion_torch.device import set_full_precision
from holo_diffusion_torch.models.unet3d import RoutedConv3d
from holo_diffusion_torch.ops import _build
from holo_diffusion_torch.ops import small_conv3d as sc
from holo_diffusion_torch.utils.profiling import counters, reset_counters

SEED = 2 ** 31 + 2727
ROUTED = {"hydrant": 51, "hydrant_g32c128": 35}


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_full_precision()
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


def _inputs(model):
    g = torch.Generator(device="cuda").manual_seed(SEED)
    r, C = model.resol, model.feature_size
    return torch.randn(1, r, r, r, C, generator=g, device="cuda"), torch.tensor([640], device="cuda")


_calls = {}


def _routed_calls(config):
    """(input, conv) of every call the route takes in an eager no-grad
    forward of `config`'s UNet."""
    if config not in _calls:
        model = _model(config)
        found = []

        def grab(conv, args):
            if sc.refusal(args[0].shape, args[0].device, args[0].dtype, conv) is None:
                found.append((args[0].clone(), conv))

        hooks = [m.register_forward_pre_hook(grab) for m in model.net_3d.modules() if isinstance(m, RoutedConv3d)]
        try:
            with torch.no_grad():
                model.net_3d._forward(*_inputs(model))
        finally:
            for h in hooks:
                h.remove()
        _calls[config] = found
    return _calls[config]


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(ROUTED))
def test_kernel_is_conv3d_bitwise_and_reruns_bitwise(config):
    _device()
    calls = _routed_calls(config)
    assert len(calls) == ROUTED[config]
    with torch.no_grad():
        for i, (x, conv) in enumerate(calls):
            k = conv.kernel_size[0]
            got = sc.small_conv3d(x, conv.weight, conv.bias, conv.stride)
            again = sc.small_conv3d(x, conv.weight, conv.bias, conv.stride)
            want = F.conv3d(x, conv.weight, conv.bias, conv.stride, k // 2)
            assert got.shape == want.shape, i
            assert torch.equal(got, want), (i, float((got - want).abs().max()))
            assert torch.equal(got, again), i


@pytest.mark.cuda
def test_no_grad_forward_routes_the_small_convs_to_the_kernel():
    """An eager no-grad hydrant forward: 51 calls counted `conv3d_small`,
    each one launch of K9, and only the 31 calls of more than 64 positions
    (8^3 and 16^3) counted `conv3d_cudnn`; with grad on, every call takes
    cuDNN, and the output is the no-grad one's bit for bit."""
    _device()
    model = _model("hydrant")
    x, t = _inputs(model)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        reset_counters()
        _build.reset_launch_counts()
        with torch.no_grad():
            got = model.net_3d._forward(x, t)
        torch.cuda.synchronize()
        seen, launched = counters(), _build.launch_counts()
        reset_counters()
        want = model.net_3d._forward(x, t)
        seen_grad = counters()
    assert seen == {"conv3d_small": 51, "conv3d_cudnn": 31}
    assert launched["small_conv3d"] == 51
    assert seen_grad == {"conv3d_cudnn": 82}
    assert torch.equal(got, want.detach())


@pytest.mark.cuda
def test_refused_call_raises_on_the_card():
    dev = _device()
    w = torch.randn(8, 8, 3, 3, 3, device=dev)
    with torch.no_grad():
        with pytest.raises(ValueError, match="65 output positions"):
            sc.small_conv3d(torch.randn(65, 8, 1, 1, 1, device=dev), w, None, (1, 1, 1))
        with pytest.raises(ValueError, match="no box walk"):
            sc.small_conv3d(torch.randn(1, 8, 2, 4, 4, device=dev), w, None, (1, 1, 1))
        with pytest.raises(ValueError, match="bfloat16"):
            sc.small_conv3d(torch.randn(1, 8, 2, 2, 2, device=dev, dtype=torch.bfloat16), w, None, (1, 1, 1))
    with pytest.raises(ValueError, match="grad is enabled"):
        sc.small_conv3d(torch.randn(1, 8, 2, 2, 2, device=dev), w, None, (1, 1, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("shape, cout, k, stride", [
    ((2, 40, 4, 4, 4), 24, 3, (2, 2, 2)),
    ((8, 48, 2, 2, 2), 16, 3, (1, 1, 1)),
    ((64, 33, 1, 1, 1), 12, 3, (1, 1, 1)),
    ((1, 6, 8, 8, 8), 9, 3, (2, 2, 2)),
    ((4, 10, 4, 4, 2), 8, 1, (1, 2, 2)),
], ids=["b2-4^3-s2", "b8-2^3", "b64-1^3", "8^3-s2", "k1-s2"])
def test_kernel_at_other_shapes(shape, cout, k, stride):
    """Shapes the UNets do not call (boxes at batch > 1, a halo at 8^3, a
    1^3 kernel at stride 2 on two axes): K9 against `F.conv3d` in float64 within 2e-6 of the
    outputs' scale (a float32 chain of at most 27 x Cin FMAs; cuDNN may
    take another kernel, and another order, at these shapes), and bitwise
    itself on a second run."""
    dev = _device()
    g = torch.Generator(device="cuda").manual_seed(SEED + sum(shape))
    x = torch.randn(shape, generator=g, device=dev)
    w = torch.randn(cout, shape[1], k, k, k, generator=g, device=dev)
    b = torch.randn(cout, generator=g, device=dev)
    with torch.no_grad():
        assert sc.refusal(shape, x.device, x.dtype, torch.nn.Conv3d(shape[1], cout, k, stride, k // 2)) is None
        got = sc.small_conv3d(x, w, b, stride)
        again = sc.small_conv3d(x, w, b, stride)
    want = F.conv3d(x.double(), w.double(), b.double(), stride, k // 2)
    assert got.shape == want.shape
    assert float((got.double() - want).abs().max()) <= 2e-6 * float(want.abs().max())
    assert torch.equal(got, again)
