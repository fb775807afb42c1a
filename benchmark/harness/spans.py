"""The program's `holo.*` spans in the traced window (`span` in
`holo_diffusion_torch/utils/profiling.py`: `record_function` annotations,
on only while a profiler records), reduced from the same kineto events as
`trace.summarize`, on the same clock.

For each span name:

- `count`: the spans that overlap the window;
- `host_s`: the sum of their durations, clipped to the window;
- `self_s`: `host_s` less the part their child `holo.*` spans cover on the
  same thread;
- `device_s`, `launches`: the device operations (as `summarize` counts
  them) whose launching runtime call, the host event of the same
  correlation id, started while the span was open on the launching thread;
- `idle_s`: the device's idle gaps (as `summarize` finds them), each
  credited to the spans open on the thread of its label (the latest-started
  host event still running when it began; the window's thread where there
  is none) when it began.

A span's figures include its children's. A host event's thread is the
system thread that recorded it (`device_resource_id`: operators,
annotations and CUDA runtime calls alike). The autograd engine's thread
runs the backward of the operators of another thread (its events name that
thread as their forward thread): besides its own spans it counts under the
spans open on that thread, so the device work of a backward pass counts
under `holo.backward` and `holo.step`."""
from __future__ import annotations

import bisect
import dataclasses
import itertools
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

from .trace import WINDOW, _ns, _on_device

PREFIX = "holo."
# CUDA API calls (cudaLaunchKernel, cudaMemcpyAsync, cuLaunchKernel, ...):
# the host side of a device operation
RUNTIME_PREFIX = "cu"


@dataclasses.dataclass
class SpanStats:
    count: int = 0
    host_s: float = 0.0
    self_s: float = 0.0
    device_s: float = 0.0
    launches: int = 0
    idle_s: float = 0.0


@dataclasses.dataclass
class SpanReport:
    spans: Dict[str, SpanStats]
    idle_s: float  # every idle gap of the window
    idle_credited_s: float  # the gaps credited to at least one span


def _int(e, method: str) -> int:
    f = getattr(e, method, None)
    return int(f()) if f is not None else 0


def _thread(e) -> int:
    return _int(e, "device_resource_id") or _int(e, "start_thread_id")


def _open_at(spans: Sequence[Tuple[int, int, int]], queries: Sequence[Tuple[int, int]]) -> Dict[int, Tuple]:
    """For spans (start, end, id) of one thread, nested, and queries
    (time, key): {key: the ids of the spans open at that time, outermost
    first}."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = {}, [], 0
    for t, key in sorted(queries):
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out[key] = tuple(s[2] for s in stack if s[1] > t)
    return out


def _parents(spans: Sequence[Tuple[int, int, int]]) -> Dict[int, int]:
    """{id: the id of the innermost span of the same thread enclosing it}."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack = {}, []
    for s in spans:
        while stack and stack[-1][1] <= s[0]:
            stack.pop()
        if stack:
            out[s[2]] = stack[-1][2]
        stack.append(s)
    return out


def reduce_spans(events) -> SpanReport:
    """The `holo.*` spans of the `bench.window` annotation's interval."""
    host_names = {e.name() for e in events if not _on_device(e)}
    win = [e for e in events if e.name() == WINDOW and not _on_device(e)]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} host '{WINDOW}' annotations, expected 1")
    w0 = _ns(win[0], "start")
    w1 = w0 + int(win[0].duration_ns())
    window_thread = _thread(win[0])

    # spans, host events and runtime calls; the threads' forward threads
    spans: List[Tuple[int, int, str, int]] = []  # start, end, name, thread
    host, runtime = [], {}
    by_tid: Dict[int, Counter] = defaultdict(Counter)
    fwd_of: Dict[int, set] = defaultdict(set)
    for e in events:
        if _on_device(e) or e is win[0]:
            continue
        s = _ns(e, "start")
        t = s + int(e.duration_ns())
        name, th = e.name(), _thread(e)
        if name.startswith(RUNTIME_PREFIX):
            runtime[_int(e, "correlation_id")] = (s, th)
        elif _int(e, "device_resource_id"):
            by_tid[_int(e, "start_thread_id")][th] += 1
            if _int(e, "fwd_thread_id"):
                fwd_of[th].add(_int(e, "fwd_thread_id"))
        if t <= w0 or s >= w1:
            continue
        host.append((s, t, name, th))
        if name.startswith(PREFIX):
            spans.append((s, t, name, th))
    tid_thread = {tid: c.most_common(1)[0][0] for tid, c in by_tid.items()}
    forward = {}
    for th, tids in fwd_of.items():
        others = {tid_thread.get(tid) for tid in tids} - {th, None}
        if len(others) == 1:
            forward[th] = others.pop()

    stats: Dict[str, SpanStats] = defaultdict(SpanStats)
    per_thread: Dict[int, List[Tuple[int, int, int]]] = defaultdict(list)
    for i, (s, t, name, th) in enumerate(spans):
        per_thread[th].append((s, t, i))
        st = stats[name]
        st.count += 1
        clipped = (min(t, w1) - max(s, w0)) / 1e9
        st.host_s += clipped
        st.self_s += clipped
    for th, ss in per_thread.items():
        for child, parent in _parents(ss).items():
            s, t = spans[child][0], spans[child][1]
            stats[spans[parent][2]].self_s -= (min(t, w1) - max(s, w0)) / 1e9

    # queries (thread, time) -> key; the spans open then are the answers
    # to `key` on that thread and to `-key - 1` on its forward thread
    queries: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    keys = itertools.count()

    def ask(th: int, time: int) -> int:
        key = next(keys)
        queries[th].append((time, key))
        if th in forward:
            queries[forward[th]].append((time, -key - 1))
        return key

    dev = []
    for e in events:
        if not _on_device(e) or e.name() in host_names:
            continue
        s = _ns(e, "start")
        t = s + int(e.duration_ns())
        if t <= w0 or s >= w1:
            continue
        launch = runtime.get(_int(e, "correlation_id"))
        dev.append((max(s, w0), min(t, w1), ask(launch[1], launch[0]) if launch else None))
    # the gaps, as summarize finds them, and their labels' threads
    gaps, cursor = [], w0
    for s, t, _ in sorted(dev, key=lambda d: (d[0], d[1])):
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, t)
    if cursor < w1:
        gaps.append((cursor, w1))
    host.sort()
    starts = [h[0] for h in host]
    gap_keys = []
    for g0, g1 in gaps:
        th = window_thread
        i = bisect.bisect_right(starts, g0) - 1
        for j in range(i, max(i - 4096, -1), -1):
            if host[j][1] > g0:
                th = host[j][3]
                break
        gap_keys.append(ask(th, g0))

    answers: Dict[int, Tuple] = {}
    for th, qs in queries.items():
        answers.update(_open_at(per_thread.get(th, []), qs))

    def credited(key: int) -> set:
        return {spans[i][2] for i in answers.get(key, ()) + answers.get(-key - 1, ())}

    for s, t, key in dev:
        for name in credited(key) if key is not None else ():
            stats[name].device_s += (t - s) / 1e9
            stats[name].launches += 1
    idle = idle_credited = 0.0
    for (g0, g1), key in zip(gaps, gap_keys):
        gap = (g1 - g0) / 1e9
        names = credited(key)
        idle += gap
        idle_credited += gap if names else 0.0
        for name in names:
            stats[name].idle_s += gap
    return SpanReport(dict(stats), idle, idle_credited)
