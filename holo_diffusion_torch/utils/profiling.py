"""Profiling and debugging helpers (port of
holo_diffusion_tpu/utils/profiling.py; the reference's torch.profiler
traces, training_loop.py:463-473 and 525-538, its trainer/timer.py and its
`detect_anomaly`, experiment.py:181-184).

Traces are torch.profiler captures of the host (and, with a card, CUDA)
activity, exported as Chrome trace JSON into the given directory.
"""
from __future__ import annotations

import contextlib
import itertools
import logging
import os
import time
from collections import defaultdict
from typing import Dict

import torch

logger = logging.getLogger(__name__)
_trace_ids = itertools.count()


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


def _start(log_dir: str) -> torch.profiler.profile:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop(prof: torch.profiler.profile, log_dir: str) -> str:
    prof.stop()
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


class Timer:
    """Accumulating named wall timer; waits for the card on exit when its
    `sync_value` lies there (trainer/timer.py:12-71)."""

    _accum: Dict[str, float] = defaultdict(float)
    _count: Dict[str, int] = defaultdict(int)

    def __init__(self, name: str = "timer", quiet: bool = True, sync_value=None):
        self.name = name
        self.quiet = quiet
        self.sync_value = sync_value

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync_value is not None:
            _sync(self.sync_value)
        dt = time.perf_counter() - self._t0
        Timer._accum[self.name] += dt
        Timer._count[self.name] += 1
        if not self.quiet:
            print(f"[{self.name}] {dt * 1000:.2f} ms")
        return False

    @classmethod
    def averages(cls) -> Dict[str, float]:
        return {k: cls._accum[k] / max(cls._count[k], 1) for k in cls._accum}

    @classmethod
    def reset(cls):
        cls._accum.clear()
        cls._count.clear()
