"""DiT-3D-XL/2 (`holo_diffusion_torch/models/dit3d.py`) on the card at its
published widths on the 32^3 x 128 grid (4,096 tokens, 16 heads of 72),
float32 with TF32 off, with the benchmark's weights from a seed (every leaf
redrawn): the forward and one backward against the benchmark's plain
reference (`benchmark/reference/net3d_DiT3D.py`) on the card, inside limits
that the reference in TF32 (the precision below the configuration's) fails;
a device trace of a forward that shows the memory-efficient attention
kernel and no softmax of written-out scores; and 28 fused attention calls a
pass. Every test here is marked `cuda` and skips without a CUDA device. The
file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dit3d_cuda.py -m cuda -q
"""
import pytest
import torch

from holo_diffusion_torch.device import set_full_precision
from holo_diffusion_torch.models.dit3d import DiT3D
from holo_diffusion_torch.utils.profiling import counters, reset_counters

SEED = 2 ** 31 + 2627
XL2 = dict(hidden_size=1152, depth=28, num_heads=16, patch_size=2, mlp_ratio=4.0)
R, C = 32, 128
# the program against the float32 reference on the card: the widest output
# gap over the output's largest value, and the widest leaf gap of the
# gradient over that leaf's norm. The attention kernel splits its float32
# products into three TF32 ones, cuBLAS and the reference's head-by-head
# matmuls sum in other orders: float32 rounding through 28 blocks. TF32
# alone keeps ~3 decimal digits, and the control below must fail.
FWD_TOL = 2e-5
GRAD_TOL = 2e-5


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


_nets = {}


def _pair():
    """(program, reference) at XL/2 on the card with one seeded state dict."""
    if not _nets:
        from benchmark.harness.weights import make_state_dict, shapes_of
        from benchmark.reference import net3d_plugin

        dev = _device()
        set_full_precision()
        with torch.device(dev):
            ref = net3d_plugin("reference", "DiT3D").build(C, XL2)
            net = DiT3D(in_channels=C, input_size=R, **XL2)
        sd = make_state_dict(shapes_of(ref), SEED, dev)
        ref.load_state_dict(sd, strict=True)
        net.load_state_dict(sd, strict=True)
        _nets["pair"] = net, ref
    return _nets["pair"]


def _inputs():
    g = torch.Generator(device="cuda").manual_seed(5)
    return torch.randn(1, R, R, R, C, generator=g, device="cuda"), torch.tensor([612], device="cuda")


def _run(net, x, t, w):
    """The output and every leaf's gradient of sum(out * w)."""
    for p in net.parameters():
        p.grad = None
    out = net(x, t)
    (out * w).sum().backward()
    return out.detach(), {n: p.grad.detach().clone() for n, p in net.named_parameters()}


def _gaps(got, want):
    out, grads = got
    ref_out, ref_grads = want
    fwd = float((out - ref_out).abs().max() / ref_out.abs().max())
    grad = max(float((grads[n] - g).norm() / g.norm()) for n, g in ref_grads.items())
    return fwd, grad


@pytest.mark.cuda
def test_forward_and_backward_match_the_reference():
    from benchmark.reference.spec import precision

    net, ref = _pair()
    x, t = _inputs()
    w = torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(9), device="cuda")
    with precision(tf32=False):
        want = _run(ref, x, t, w)
        got = _run(net, x, t, w)
    with precision(tf32=True):
        control = _run(ref, x, t, w)
    fwd, grad = _gaps(got, want)
    tf32_fwd, tf32_grad = _gaps(control, want)
    print(f"program: forward {fwd!r}, gradient {grad!r}; TF32 reference: forward {tf32_fwd!r}, "
          f"gradient {tf32_grad!r}")
    assert all(g.norm() > 0 for g in want[1].values())
    assert fwd <= FWD_TOL and grad <= GRAD_TOL
    assert tf32_fwd > FWD_TOL or tf32_grad > GRAD_TOL


@pytest.mark.cuda
def test_a_forward_runs_the_fused_attention_kernel_28_times():
    from torch.profiler import ProfilerActivity, profile

    net, _ = _pair()
    x, t = _inputs()
    with torch.no_grad():
        net(x, t)  # warm-up
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            reset_counters()
            net(x, t)
            torch.cuda.synchronize()
            counted = counters()
    assert counted == {"dit_forwards": 1, "dit_attn_fused": 28}
    names = [e.name for e in prof.events()]
    fused = [n for n in names if "fmha_cutlassF" in n]
    assert len(fused) == 28, sorted(set(n for n in names if "fmha" in n or "attention" in n.lower()))
    assert not [n for n in names if "softmax" in n.lower()], "a softmax of written-out scores ran"
    assert names.count("holo.dit") >= 1
    assert names.count("holo.dit.attn") >= 28 and names.count("holo.dit.mlp") >= 28
