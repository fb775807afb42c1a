"""`harness/spans.py` on a synthetic trace: a span's host, self and
device figures on its own thread, children included; the autograd
thread's launches under `holo.backward` and `holo.step`; a thread that
is neither (the loader's) credited to no span; the idle gaps credited by
their labels' threads. And `trace.summarize` reads the same totals with
the program's annotations and their device mirrors as without them."""
import dataclasses

import pytest

from benchmark.harness.spans import reduce_spans
from benchmark.harness.trace import summarize

MAIN, AUTOGRAD, LOADER = 101, 202, 303  # system thread ids
TID = {MAIN: 1, AUTOGRAD: 2, LOADER: 1}  # the profiler's own ids (the loader's unrecorded)


@dataclasses.dataclass
class Ev:
    n: str
    start: int
    dur: int
    thread: int = MAIN
    corr: int = 0
    fwd: int = 0
    device: bool = False

    def name(self):
        return self.n

    def device_type(self):
        return "DeviceType.CUDA" if self.device else "DeviceType.CPU"

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur

    def correlation_id(self):
        return self.corr

    def device_resource_id(self):
        return 7 if self.device else self.thread

    def start_thread_id(self):
        return TID.get(self.thread, 0)

    def fwd_thread_id(self):
        return self.fwd


def kernel(start, dur, corr, name="void kernel"):
    return Ev(name, start, dur, corr=corr, device=True)


BASE = [
    Ev("bench.window", 0, 1000),
    Ev("aten::mul", 210, 40),
    Ev("cudaLaunchKernel", 220, 10, corr=7),
    kernel(400, 50, 7, "void mul_kernel"),
    Ev("MulBackward0", 550, 150, AUTOGRAD, fwd=1),
    Ev("cudaLaunchKernel", 570, 5, AUTOGRAD, corr=9),
    kernel(600, 100, 9, "void decode_bwd"),
    Ev("cudaLaunchKernel", 680, 5, AUTOGRAD, corr=11),
    kernel(720, 40, 11, "void add_kernel"),
    Ev("cudaMemcpyAsync", 590, 10, LOADER, corr=13),
    kernel(610, 10, 13, "Memcpy HtoD (Pinned -> Device)"),
]
SPANS = [
    Ev("holo.step", 100, 800),
    Ev("holo.loss", 200, 100),
    Ev("holo.backward", 500, 300),
    Ev("holo.decode.bwd", 560, 90, AUTOGRAD),
    Ev("holo.data.wait", 920, 50),
    # the device's mirrors of annotations, as kineto records them
    Ev("holo.step", 400, 360, device=True),
    Ev("holo.decode.bwd", 600, 100, device=True),
]


def test_crediting_rules():
    rep = reduce_spans(BASE + SPANS)
    got = {k: dataclasses.astuple(v) for k, v in rep.spans.items()}
    ns = 1e-9
    want = {
        # count, host, self, device, launches, idle
        "holo.step": (1, 800 * ns, 400 * ns, 190 * ns, 3, 410 * ns),
        "holo.loss": (1, 100 * ns, 100 * ns, 50 * ns, 1, 0.0),
        "holo.backward": (1, 300 * ns, 300 * ns, 140 * ns, 2, 260 * ns),
        "holo.decode.bwd": (1, 90 * ns, 90 * ns, 100 * ns, 1, 0.0),
        "holo.data.wait": (1, 50 * ns, 50 * ns, 0.0, 0, 0.0),
    }
    assert set(got) == set(want)
    for name, row in want.items():
        assert got[name] == pytest.approx(row, abs=1e-15), name
    # gaps [0, 400) (no host event running: the window's thread, no span
    # open), [450, 600) (holo.step), [700, 720) and [760, 1000) (holo.backward
    # running: step and backward)
    assert rep.idle_s == pytest.approx(810 * ns, abs=1e-15)
    assert rep.idle_credited_s == pytest.approx(410 * ns, abs=1e-15)


def test_a_span_clipped_to_the_window():
    rep = reduce_spans([Ev("bench.window", 100, 200), Ev("holo.chunk", 50, 100), Ev("holo.chunk", 150, 100),
                        Ev("holo.decode", 160, 20)])
    chunk = rep.spans["holo.chunk"]
    assert chunk.count == 2
    assert chunk.host_s == pytest.approx(150e-9) and chunk.self_s == pytest.approx(130e-9)


def test_summarize_reads_the_same_totals_with_spans():
    plain, traced = summarize(BASE), summarize(BASE + SPANS)
    for field in ("window_s", "busy_s", "launches", "device_s_by_name"):
        assert getattr(traced, field) == getattr(plain, field), field
    assert sum(s for _, s in traced.idle_by_host) == pytest.approx(sum(s for _, s in plain.idle_by_host))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    import torch

    from benchmark.harness.manifest import Manifest
    from benchmark.tests.tiny import make_tiny_root

    torch.set_num_threads(2)
    return Manifest(make_tiny_root(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("workload", ["hydrant.train", "hydrant.frames", "hydrant.sample"])
def test_span_report_of_a_tiny_cell_on_the_cpu(tiny, workload):
    """Each layer's reading from its spans is a number, and the unit's
    outermost spans cover most of the window."""
    from benchmark.span_report import READINGS, ROOTS, report

    kind = tiny.mix(tiny.workload(workload)["traffic"])["kind"]
    out = report(tiny, workload, 12345678901, "cpu")
    for name in READINGS[kind]:
        assert out["readings"][name] is not None and out["readings"][name] >= 0.0, name
    assert set(ROOTS[kind]) <= set(out["spans"])
    assert 0.5 < out["root_host_share"] <= 1.0
