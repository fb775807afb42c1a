"""Profiling and debugging helpers (port of
holo_diffusion_tpu/utils/profiling.py; the reference's torch.profiler
traces, training_loop.py:463-473 and 525-538, and its `detect_anomaly`,
experiment.py:181-184).

Traces are torch.profiler captures of the host (and, with a card, CUDA)
activity, exported as Chrome trace JSON into the given directory.

Spans and counters. `span(name)` marks a layer of the program (the
`holo.*` names: step, data wait and copy, extractor, pooler, UNet, render
and its passes, decode and its backward, loss, backward, optimizer, chunk,
DDPM step, all-reduce) and `count(name, n)` adds to a named counter (the
bytes and batches the loop copies to the card, decodes by route, chunks
and UNet forwards by the path they took, chunk and UNet graphs captured).
Spans and counters inside a render that a chunk's CUDA graph replays
(`render_eval.py`), or inside a UNet forward that its graph replays
(`models/unet3d.py`), act at the graph's capture alone. Both act only while a
torch profiler records, whoever started it: then a span is a
`record_function` annotation in the same trace as the device's activity,
on its clock, nested in the spans open on its thread. Otherwise `span`
returns one shared no-op context after a single attribute read, and
`count` returns at once.
"""
from __future__ import annotations

import contextlib
import itertools
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Dict

import torch
import torch.autograd.profiler as _autograd_profiler

logger = logging.getLogger(__name__)
_trace_ids = itertools.count()
_OFF = contextlib.nullcontext()
_counters: Dict[str, int] = defaultdict(int)
_counters_lock = threading.Lock()


def span(name: str):
    """A context that marks `name` in the trace while a torch profiler
    records; the shared no-op context otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, n: int) -> None:
    """Add `n` to the counter `name` while a torch profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    with _counters_lock:
        _counters[name] += int(n)


def counters() -> Dict[str, int]:
    """The counters' values (those counted since the last reset)."""
    with _counters_lock:
        return dict(_counters)


def reset_counters() -> None:
    with _counters_lock:
        _counters.clear()


def _sync(value) -> None:
    """Wait for the card when `value` (a tensor, or a dict, list or tuple
    holding tensors) lies on it."""
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        for v in value:
            _sync(v)
    elif isinstance(value, torch.Tensor) and value.is_cuda:
        torch.cuda.synchronize(value.device)


def _all_threads_config():
    """The profiler setting that traces every thread (torch 2.11 has it);
    None, the default of the calling thread alone, on a torch without it."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        logger.warning("this torch traces the calling thread alone: the loader's copies are left out")
        return None


def _start(log_dir: str) -> torch.profiler.profile:
    """Start a trace of every thread where torch can (the loader's copies
    too), with the counters from zero."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities, experimental_config=_all_threads_config())
    reset_counters()
    prof.start()
    return prof


def _stop(prof: torch.profiler.profile, log_dir: str) -> str:
    prof.stop()
    logger.info("counters over the trace: %s", counters())
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{next(_trace_ids)}.pt.trace.json")
    prof.export_chrome_trace(path)
    logger.info("trace -> %s", path)
    return path


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace the enclosed block into `log_dir`."""
    prof = _start(log_dir)
    try:
        yield prof
    finally:
        _stop(prof, log_dir)


class SteadyStateProfiler:
    """A bounded trace of the steady-state train dispatches.

    The first dispatch (where the caches warm up) is left out, as the JAX
    package leaves out its compile. Capture starts before dispatch 1 and
    stops after dispatch `n_steps` (or at the epoch's end). A single-dispatch
    epoch still leaves a trace: `finish` traces its final wait for the card,
    so `profile=true` never leaves the trace directory empty.
    """

    def __init__(self, log_dir: str, n_steps: int = 3):
        self.log_dir = log_dir
        self.n_steps = max(1, n_steps)
        self._prof = None
        self._done = False
        self._t0 = 0.0
        self._last = 0

    def before_dispatch(self, it: int) -> None:
        if it == 1 and not self._done:
            self._prof = _start(self.log_dir)
            self._t0 = time.perf_counter()
        self._last = it

    def _close(self, sync_value) -> None:
        _sync(sync_value)
        logger.info("traced dispatches 1..%d in %.3f s", self._last, time.perf_counter() - self._t0)
        _stop(self._prof, self.log_dir)
        self._prof = None
        self._done = True

    def after_dispatch(self, it: int, sync_value) -> None:
        if self._prof is not None and it >= self.n_steps:
            self._close(sync_value)

    def finish(self, sync_value) -> None:
        if self._prof is not None:
            self._close(sync_value)
        elif not self._done:
            with profile_trace(self.log_dir):
                _sync(sync_value)
            self._done = True


def enable_anomaly_detection(enabled: bool = True) -> None:
    """autograd's anomaly detection (the reference's `detect_anomaly`)."""
    torch.autograd.set_detect_anomaly(enabled)
