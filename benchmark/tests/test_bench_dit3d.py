"""The DiT-3D-XL/2 configuration in the benchmark: its FLOP count at XL/2
pinned to literals worked from the shapes and held at a tiny size to a
count by hooks on the program; the cell's tiny cut through the harness's
`train` kind on the CPU, correct, every DiT leaf moving; and the two
metrics of the DiT's attention read from a synthetic run."""
import types

import pytest
import torch

from benchmark.counts import model as counts
from benchmark.harness.manifest import Manifest
from benchmark.harness.peaks import PEAK_FLOPS
from benchmark.harness.runner import Record, make_cell
from benchmark.harness.trace import TraceSummary
from benchmark.reference import net3d_plugin
from benchmark.reference.spec import Spec
from benchmark.tests.tiny import make_tiny_root

CONFIG = "hydrant_g32c128_dit3d_xl2"
WORKLOAD = CONFIG + ".train"
D, T, DEPTH = 1152, 16 ** 3, 28  # hidden, tokens, blocks at XL/2 on the 32^3 grid


def test_counts_at_xl2():
    """Each block's qkv, projection and MLP over 4,096 tokens, 28 times;
    the final Linear(1152, 1024) over the tokens; the modulations and the
    timestep MLP once a grid; attention 4 d T^2 a block; the patch
    embedding as a Conv3d; three LayerNorms of 5 an element."""
    spec = Spec.from_config(Manifest().config(CONFIG)["program_config"])
    assert (spec.net_3d_type, spec.resol, spec.feature_size) == ("DiT3D", 32, 128)
    f = counts.net_3d_forward(spec)
    blocks = 3_652_869_685_248  # 28 x 2 x 4096 x 1152 x (3456 + 1152 + 4608 + 4608)
    assert blocks == DEPTH * 2 * T * D * (3 * D + D + 4 * D + 4 * D)
    final, modulation, timestep = 9_663_676_416, 445_906_944 + 5_308_416, 3_244_032
    assert f == {"linear": blocks + final + modulation + timestep, "attention": 2_164_663_517_184,
                 "conv": 9_663_676_416, "layernorm": 1_344_798_720}
    assert f["attention"] == DEPTH * 4 * D * T * T
    step = counts.train_step(spec, 33, 800, 800)
    assert sum(step.values()) == 27_515_071_315_968.0
    assert sum(3.0 * 1.5 * v for v in f.values()) / sum(step.values()) > 0.95


def test_counts_match_hooks_on_the_program():
    """At the tiny size (hidden 48, 2 blocks, 4 heads, patch 2, an 8^3 x 8
    grid, 2 grids): the plug-in's count equals one taken by forward hooks
    on the program's Linear, Conv3d and LayerNorm modules and a wrapper of
    its attention."""
    from holo_diffusion_torch.models import dit3d

    args = net3d_plugin("reference", "DiT3D").tiny({})
    net = dit3d.DiT3D(in_channels=8, input_size=8, **args)
    got = {"linear": 0, "conv": 0, "layernorm": 0, "attention": 0}

    def hook(mod, inp, out):
        x = inp[0]
        if isinstance(mod, torch.nn.Linear):
            got["linear"] += 2 * mod.in_features * mod.out_features * (x.numel() // mod.in_features)
        elif isinstance(mod, torch.nn.Conv3d):
            k = mod.kernel_size[0] ** 3
            got["conv"] += 2 * mod.in_channels * mod.out_channels * k * (out.numel() // mod.out_channels)
        elif isinstance(mod, torch.nn.LayerNorm):
            got["layernorm"] += 5 * x.numel()

    for m in net.modules():
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv3d, torch.nn.LayerNorm)):
            m.register_forward_hook(hook)
    plain = dit3d.attention

    def attention(q, k, v):
        B, H, t, hd = q.shape
        got["attention"] += 4 * B * H * hd * t * t
        return plain(q, k, v)

    dit3d.attention = attention
    try:
        with torch.no_grad():
            net(torch.randn(2, 8, 8, 8, 8), torch.tensor([5, 900]))
    finally:
        dit3d.attention = plain
    spec = types.SimpleNamespace(net_3d=args, feature_size=8, resol=8)
    assert dict(net3d_plugin("counts", "DiT3D").forward(spec, batch=2)) == got


@pytest.fixture(scope="module")
def man(tmp_path_factory):
    torch.set_num_threads(2)
    return Manifest(make_tiny_root(tmp_path_factory.mktemp("tiny")))


def test_tiny_cell_is_correct_and_moves_every_dit_leaf(man):
    _, cell = make_cell(man, WORKLOAD, 2 ** 31 + 4242, "cpu")
    assert cell.ctx.spec.net_3d == net3d_plugin("reference", "DiT3D").tiny({})
    cell.setup()
    cell.release()
    out = cell.check()
    limits = man.limits(WORKLOAD)
    assert set(limits) == {"loss1_gap", "grad_median_gap", "change_gap"}
    assert all(out["program"][k] <= v for k, v in limits.items()), out["program"]
    dit = [k for k in cell.change if k.startswith("net_3d.")]
    assert dit and all(cell.change[k] > 0 for k in dit)
    assert any(k.startswith("net_3d.blocks.1.adaLN_modulation") for k in dit)


def _record(device_s, counted):
    """A synthetic traced run of 3 steps of the XL/2 cell, with the program's
    counters as `counted` leaves them."""
    from holo_diffusion_torch.utils.profiling import count, reset_counters

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        reset_counters()
        for name, n in counted.items():
            count(name, n)
    conf = Manifest().config(CONFIG)
    trace = TraceSummary(window_s=3.0, busy_s=2.9, launches=1000, device_s_by_name=device_s, idle_by_host=[])
    return Record(WORKLOAD, Spec.from_config(conf["program_config"]), conf, 3, trace, {}, {})


FMHA = {"fmha_cutlassF_f32_aligned_64x64_rf_sm80(PyTorchMemEffAttention::AttentionKernel<float>::Params)": 0.4,
        "fmha_cutlassB_f32_aligned_64x64_k128_sm80(PyTorchMemEffAttention::AttentionBackwardKernel<float>)": 1.1,
        "ampere_sgemm_128x64_nn": 2.0}


def test_attention_roofline_reads_the_passes_over_the_fused_kernels():
    reader = Manifest().metric_reader("dit_attn_roofline.train")
    assert reader.UNIT == "%"
    rec = _record(FMHA, {"dit_forwards": 5, "dit_attn_fused": 140})
    want = 100.0 * 3 * DEPTH * 4 * D * T * T * 5 / PEAK_FLOPS / 1.5
    assert reader.read(rec) == pytest.approx(want, rel=1e-12)
    assert 0 < want < 100
    assert reader.read(_record({"ampere_sgemm_128x64_nn": 2.0}, {"dit_forwards": 5})) is None
    assert reader.read(_record(FMHA, {})) is None


def test_plain_attention_calls_a_step():
    reader = Manifest().metric_reader("dit_attn_plain.train")
    assert reader.UNIT == "calls"
    assert reader.read(_record(FMHA, {"dit_forwards": 5, "dit_attn_fused": 140})) == 0.0
    assert reader.read(_record({}, {"dit_forwards": 4, "dit_attn_plain": 112})) == pytest.approx(112 / 3)
    assert reader.read(_record(FMHA, {"decodes_fused": 6})) is None
