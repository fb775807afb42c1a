"""The port's spans and counters (holo_diffusion_torch/utils/profiling.py):
without a profiler `span` is one shared no-op and `count` counts nothing;
under torch.profiler (CPU activity) each layer's `holo.*` span appears as
often as its unit has it, nested in the span of the layer that calls it."""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import functools
import itertools
import json
import logging
import math
import os
import re
import sys
import types
from collections import Counter

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(__file__))
from torch_toy_model import TOY  # noqa: E402

from holo_diffusion_torch.data.source import AsyncLoader  # noqa: E402
from holo_diffusion_torch.data.synthetic import make_synthetic_scene  # noqa: E402
from holo_diffusion_torch.experiment import Experiment  # noqa: E402
from holo_diffusion_torch.models import diffusion as gd  # noqa: E402
from holo_diffusion_torch.models.holo_model import HoloDiffusionModel  # noqa: E402
from holo_diffusion_torch.ops import _build  # noqa: E402
from holo_diffusion_torch.ops import fused_decode as fd  # noqa: E402
from holo_diffusion_torch.parallel.collectives import mean_over_ranks  # noqa: E402
from holo_diffusion_torch.parallel.train_step import TrainState, make_train_step  # noqa: E402
from holo_diffusion_torch.render_eval import render_image_chunked  # noqa: E402
from holo_diffusion_torch.train.optimizer import make_optimizer  # noqa: E402
from holo_diffusion_torch.utils import profiling as tp  # noqa: E402
from holo_diffusion_torch.utils.flyaround import simple_360_cameras  # noqa: E402
from holo_diffusion_torch.weights import init_weights  # noqa: E402

ALL_THREADS = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)


def test_span_and_count_do_nothing_without_a_profiler():
    tp.reset_counters()
    assert tp.span("holo.step") is tp.span("holo.chunk")
    with tp.span("holo.step") as s:
        assert s is None
    tp.count("h2d_bytes", 10)
    assert tp.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        assert tp.span("holo.step") is not tp.span("holo.chunk")
        tp.count("h2d_bytes", 10)
        tp.count("h2d_bytes", 5)
    tp.count("h2d_bytes", 10)
    assert tp.counters() == {"h2d_bytes": 15}
    tp.reset_counters()
    assert tp.counters() == {}


def _model(**over):
    return init_weights(HoloDiffusionModel(**{**TOY, **over}), seed=3)


def _train_step(bootstrap_prob):
    """One step fed as the loop feeds it: the loader's thread copies the
    batch through `Experiment._to_device`, the step waits for it. (The toy's
    decoder decodes layer by layer: no fused backward here.)"""
    model = _model(bootstrap_prob=bootstrap_prob)
    opt = make_optimizer(model.named_parameters(), breed="Adam", lr=1e-3)
    step = make_train_step(model, opt)
    scene = make_synthetic_scene(n_views=4, image_size=24, seed=1, device="cpu")
    transfer = functools.partial(Experiment._to_device, types.SimpleNamespace(device=torch.device("cpu")))

    def run():
        batch = next(iter(AsyncLoader(iter([scene]), transfer=transfer)))
        step(TrainState(model, opt), batch, torch.Generator().manual_seed(0))

    counts = {"holo.data.wait": 1, "holo.data.to_device": 1, "holo.step": 1, "holo.extract": 1, "holo.pool": 1,
              "holo.unet": 1 + int(bootstrap_prob == 1.0), "holo.render": 1, "holo.render.coarse": 1,
              "holo.render.fine": 1, "holo.decode": 2, "holo.loss": 1, "holo.backward": 1, "holo.optimizer": 1}
    nested = {"holo.extract": "holo.step", "holo.pool": "holo.step", "holo.unet": "holo.step",
              "holo.render": "holo.step", "holo.render.coarse": "holo.render", "holo.render.fine": "holo.render",
              "holo.decode": {"holo.render.coarse", "holo.render.fine"}, "holo.loss": "holo.step",
              "holo.backward": "holo.step", "holo.optimizer": "holo.step",
              "holo.step": None, "holo.data.wait": None, "holo.data.to_device": None}
    return run, counts, nested


def _chunked_render():
    model = _model(chunk_size_grid=8 * 40).eval()
    grid = torch.randn(8, 8, 8, 8, generator=torch.Generator().manual_seed(2)) * 0.5
    cam = simple_360_cameras(1, dist=4.5)
    chunks = math.ceil(16 * 16 / 40)

    def run():
        with torch.no_grad():
            render_image_chunked(model, cam, grid, device="cpu")

    counts = {"holo.chunk": chunks, "holo.render.coarse": chunks, "holo.render.fine": chunks,
              "holo.decode": 2 * chunks}
    nested = {"holo.chunk": None, "holo.render.coarse": "holo.chunk", "holo.render.fine": "holo.chunk",
              "holo.decode": {"holo.render.coarse", "holo.render.fine"}}
    return run, counts, nested


def _ddpm_steps():
    model = _model().eval()

    def run():
        chain = gd.p_sample_loop_progressive(model.schedule, model.apply_net_3d, (1, 8, 8, 8, 8),
                                             generator=torch.Generator().manual_seed(4), device="cpu")
        with torch.no_grad():
            list(itertools.islice(chain, 3))

    return run, {"holo.ddpm": 3, "holo.unet": 3}, {"holo.ddpm": None, "holo.unet": "holo.ddpm"}


def _decode_backward():
    g = torch.Generator().manual_seed(5)
    C, hidden, pe = 8, 16, 15
    params = [torch.randn(*s, generator=g).requires_grad_(True)
              for s in ((4, 4, 4, C), (C, hidden + 1), (hidden + 1,), (hidden + pe, 3), (3,))]
    pts = torch.rand(2, 6, 5, 3, generator=g) * 2.0 - 1.0
    dirs = torch.randn(2, 6, pe, generator=g)

    def run():
        dens, rgb = fd.fused_sample_decode(*params, pts, dirs, extent=1.5, hidden=hidden)
        (dens.sum() + rgb.sum()).backward()

    return run, {"holo.decode.bwd": 1}, {"holo.decode.bwd": None}


def _all_reduce(tmp_path):
    def run():
        dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
        try:
            mean_over_ranks([torch.ones(3), torch.zeros(2)])
        finally:
            dist.destroy_process_group()

    return run, {"holo.allreduce": 1}, {"holo.allreduce": None}


CASES = {
    "train_step_bootstrap": lambda tmp: _train_step(1.0),
    "train_step_one_pass": lambda tmp: _train_step(0.0),
    "chunked_render": lambda tmp: _chunked_render(),
    "ddpm_steps": lambda tmp: _ddpm_steps(),
    "decode_backward": lambda tmp: _decode_backward(),
    "all_reduce": _all_reduce,
}


def _holo_parent(event):
    p = event.cpu_parent
    while p is not None and not p.name.startswith("holo."):
        p = p.cpu_parent
    return None if p is None else p.name


@pytest.mark.parametrize("case", list(CASES))
def test_spans_under_a_profiler(case, tmp_path):
    """Every `holo.*` span of the unit with its count, and no other; each
    inside the nearest `holo.*` span the table names (None: outermost)."""
    run, counts, nested = CASES[case](tmp_path)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=ALL_THREADS) as prof:
        run()
    spans = [e for e in prof.events() if e.name.startswith("holo.")]
    assert Counter(e.name for e in spans) == counts
    for e in spans:
        want = nested[e.name]
        assert _holo_parent(e) in (want if isinstance(want, set) else {want}), (e.name, _holo_parent(e))


def test_operator_trace_without_the_all_threads_setting(tmp_path, monkeypatch, caplog):
    """On a torch whose profiler lacks `profile_all_threads`, the operator's
    trace still traces the calling thread, with its spans, and says what
    it leaves out."""
    class Old:
        def __init__(self, **kw):
            if "profile_all_threads" in kw:
                raise TypeError("unexpected keyword argument 'profile_all_threads'")

    monkeypatch.setattr(torch._C._profiler, "_ExperimentalConfig", Old)
    with caplog.at_level(logging.WARNING, logger=tp.logger.name):
        with tp.profile_trace(str(tmp_path)):
            with tp.span("holo.step"):
                torch.ones(3).sum()
    assert "calling thread alone" in caplog.text
    (name,) = os.listdir(tmp_path)
    events = json.load(open(tmp_path / name))["traceEvents"]
    assert sum(e.get("name") == "holo.step" and e.get("ph") == "X" for e in events) == 1


def test_chip_smoke_device_rows_leave_out_the_spans_device_mirrors():
    """`chip_smoke.py` sums device time and launches over `device_rows`: the
    device mirror of a `holo.*` span covers the kernels under it and is not
    counted again."""
    from torch.autograd import DeviceType

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)

    row = lambda key, dev, annotation: types.SimpleNamespace(key=key, device_type=dev, is_user_annotation=annotation)
    rows = [row("fused_decode_kernel", DeviceType.CUDA, False), row("holo.decode", DeviceType.CUDA, True),
            row("holo.decode", DeviceType.CPU, True), row("aten::mm", DeviceType.CPU, False),
            row("Memset (Device)", DeviceType.CUDA, False)]
    prof = types.SimpleNamespace(key_averages=lambda: rows)
    assert [e.key for e in chip_smoke.device_rows(prof)] == ["fused_decode_kernel", "Memset (Device)"]


def test_chip_smoke_counts_kernels_by_their_traced_names():
    """`_build.traced_launch_counts` counts a graphed path's launches by the
    names a device trace gives the kernels (as `chip_smoke.py` reads them):
    each of csrc/ as the entry point that launches it, with its channel
    count where the name holds it; other device work is not counted."""
    names = ["void (anonymous namespace)::fused_decode_kernel<64, true>((anonymous namespace)::Params)"] * 3 + [
        "void (anonymous namespace)::fused_decode_kernel<32, false>((anonymous namespace)::Params)",
        "void (anonymous namespace)::fused_decode_bwd_kernel<64>((anonymous namespace)::Params)",
        "void (anonymous namespace)::decode_c128_fwd_kernel<true>((anonymous namespace)::FwdParams)",
        "(anonymous namespace)::decode_c128_bwd_kernel((anonymous namespace)::BwdParams)",
        "void kron_sample_fwd_kernel<1, 2>(float const*, float const*, float*, sample_gather::Geometry)",
        "void trilinear_sample_onehot_kernel<4, 1>(float const*, float const*, float*, sample_gather::Geometry)",
        "void view_sample_bwd_kernel(Table, Points, float const*)",
        "Memcpy DtoD (Device -> Device)",
        "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>(int, float*)",
    ]
    assert _build.traced_launch_counts(names) == {
        "fused_decode_fwd_normals": 4, "fused_decode_fwd_normals@C64": 3, "fused_decode_fwd_normals@C128": 1,
        "fused_decode_fwd": 1, "fused_decode_fwd@C32": 1, "fused_decode_bwd": 2, "fused_decode_bwd@C64": 1,
        "fused_decode_bwd@C128": 1, "kron_sample_fwd": 1, "trilinear_sample_onehot": 1, "view_sample_bwd": 1}


def test_chip_smoke_refuses_a_kernel_it_cannot_name():
    """A kernel of csrc/ that no pattern names fails the count rather than
    going uncounted."""
    with pytest.raises(AssertionError, match="fused_decode_split_kernel"):
        _build.traced_launch_counts(["void fused_decode_split_kernel<64>(Params)"])


def _traced_names(source):
    """The names a device trace gives each `__global__` kernel of a CUDA
    source: every bool template parameter both ways, every int one 64."""
    kernels = re.findall(r"(?:template\s*<([^>]*)>\s*)?__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(",
                         source)
    for params, name in kernels:
        values = [("true", "false") if p.split()[0] == "bool" else ("64",) for p in params.split(",") if p.strip()]
        for args in itertools.product(*values):
            yield f"void (anonymous namespace)::{name}<{', '.join(args)}>(Params)" if args else f"{name}(Params)"


def test_every_kernel_and_symbol_of_csrc_is_in_the_table():
    """Each `__global__` kernel of csrc/*.cu matches exactly one traced
    pattern of `_build.KERNELS`, every pattern matches one, and a kernel
    renamed out of the table is refused; each entry point's C symbol is an
    `extern "C"` function of its library's source, whose parameters are the
    entry's argument types and the stream."""
    patterns = [(re.compile(p), entry) for entry, k in _build.KERNELS.items() for p, _ in k.traced]
    used, kernels, n_global = set(), set(), 0
    for src in sorted(_build.CSRC_DIR.glob("*.cu")):
        n_global += src.read_text().count("__global__")
        for name in _traced_names(src.read_text()):
            kernels.add(name.split("<")[0])
            hits = [(p.pattern, entry) for p, entry in patterns if p.search(name)]
            assert len(hits) == 1, (name, hits)
            used.add(hits[0][0])
            assert _build.traced_launch_counts([name])[hits[0][1]] == 1
            with pytest.raises(AssertionError, match="matches no traced pattern"):
                _build.traced_launch_counts([name.replace("_kernel", "_unlisted_kernel")])
    assert len(kernels) == n_global
    assert used == {p.pattern for p, _ in patterns}
    externs = {src.stem: {f: len(args.split(",")) for f, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                                                           src.read_text())}
               for src in _build.CSRC_DIR.glob("*.cu")}
    for entry, kernel in _build.KERNELS.items():
        for library, symbol in kernel.functions.values():
            assert externs[library].get(symbol) == len(kernel.argtypes) + 1, (entry, library, symbol)
