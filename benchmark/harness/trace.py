"""The traced window: torch.profiler over a fixed number of units, reduced
to what the per-layer metrics read. Everything comes from the one window:
its host wall time (the `bench.window` annotation), the device's busy time
(the union of every kernel, copy and set interval in it), the device
operations (count and seconds by name) and the idle gaps between them,
each named by the latest-started host operation (of any thread) still
running when it began."""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Tuple

WINDOW = "bench.window"
TOP = 10


def _ns(e, which: str) -> int:
    f = getattr(e, f"{which}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{which}_us")() * 1000)


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    launches: int
    device_s_by_name: Dict[str, float]
    idle_by_host: List[Tuple[str, float]]

    def device_seconds(self, *parts: str) -> float:
        """Device seconds of the operations whose name holds any of `parts`."""
        return sum(s for k, s in self.device_s_by_name.items() if any(p in k for p in parts))

    def breakdown(self) -> Dict[str, list]:
        ops = sorted(self.device_s_by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k[:160], s] for k, s in ops], "idle_gaps": [[k[:160], s] for k, s in
                                                                           self.idle_by_host[:TOP]]}


def _on_device(e) -> bool:
    return "CUDA" in str(e.device_type())


def summarize(events) -> TraceSummary:
    """Reduce the profiler's kineto events to a TraceSummary of the
    `bench.window` annotation's interval. Device operations are the
    device's events other than annotations; host operations the host's."""
    # a record_function annotation appears on the host and again on the
    # device's timeline: a device event that shares a host event's name is
    # an annotation, not an operation (kernel and copy names never do)
    host_names = {e.name() for e in events if not _on_device(e)}
    win = [e for e in events if e.name() == WINDOW and not _on_device(e)]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} host '{WINDOW}' annotations, expected 1")
    w0 = _ns(win[0], "start")
    w1 = w0 + int(win[0].duration_ns())
    dev, host = [], []
    for e in events:
        s = _ns(e, "start")
        t = s + int(e.duration_ns())
        if t <= w0 or s >= w1 or e is win[0]:
            continue
        if _on_device(e):
            if e.name() not in host_names:
                dev.append((max(s, w0), min(t, w1), e.name()))
        else:
            host.append((s, t, e.name()))
    by_name: Dict[str, float] = defaultdict(float)
    for s, t, name in dev:
        by_name[name] += (t - s) / 1e9
    # the union of the device intervals, and the gaps between them
    busy, gaps, cursor = 0, [], w0
    for s, t, _ in sorted(dev):
        if s > cursor:
            gaps.append((cursor, s))
        if t > cursor:
            busy += t - max(s, cursor)
            cursor = t
    if cursor < w1:
        gaps.append((cursor, w1))
    host.sort()
    starts = [h[0] for h in host]
    idle: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        label = "(host between operations)"
        i = bisect.bisect_right(starts, g0) - 1
        # the latest-starting host operation still running at g0: the
        # innermost one of the thread that started it last
        for j in range(i, max(i - 4096, -1), -1):
            if host[j][1] > g0:
                label = host[j][2]
                break
        idle[label] += (g1 - g0) / 1e9
    return TraceSummary(
        window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, launches=len(dev), device_s_by_name=dict(by_name),
        idle_by_host=sorted(idle.items(), key=lambda kv: -kv[1]))


def traced(run_units, activities=None):
    """Run `run_units()` (which runs and drains the window's units) under
    torch.profiler inside the `bench.window` annotation -> TraceSummary."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = activities or [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            run_units()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return summarize(prof.profiler.kineto_results.events())
