"""One run of a cell: set-up, the window (timed, or traced for the
per-layer metrics), the program's state freed, the comparison with the
reference, and the result's line."""
from __future__ import annotations

import dataclasses
import importlib
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from ..reference.spec import Spec
from . import compare
from .manifest import Manifest
from .program import Context
from .trace import TraceSummary, traced


@dataclasses.dataclass
class Record:
    """What a per-layer metric's reader reads."""

    workload: str
    spec: Spec
    config: Dict
    units: int
    trace: Optional[TraceSummary]
    host: Dict[str, List[float]]
    flops_per_unit: Dict[str, float]


def make_cell(man: Manifest, workload: str, seed: int, device, program_args=None):
    wl = man.workload(workload)
    mix = man.mix(wl["traffic"])
    ctx = Context(man.config(wl["config"]), mix, man.limits(workload), seed, torch.device(device),
                  dict(program_args or {}))
    kind = importlib.import_module(f"benchmark.harness.kinds.{mix['kind']}")
    return kind, kind.Cell(ctx)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_units(cell, n: int) -> None:
    for _ in range(n):
        cell.unit()
    cell.drain()


def timed_window(cell, seconds: float, device):
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        cell.unit()
        n += 1
    cell.drain()
    _sync(device)
    return time.perf_counter() - t0, n


def card_line() -> str:
    """The card's name, power limit and clocks, from nvidia-smi (for the
    record beside the numbers)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm,clocks.sm",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def run_cell(man: Manifest, workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, log: Callable[[str], None] = lambda s: print(s, file=sys.stderr)) -> Dict:
    device = torch.device(device)
    kind, cell = make_cell(man, workload, seed, device)
    mix = cell.ctx.mix
    cell.setup()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    summary = None
    if trace:
        n = mix["trace_units"]
        summary = traced(lambda: run_units(cell, n))
        window_s = summary.window_s
    else:
        window_s, n = timed_window(cell, seconds, device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    failed = cell.failed()
    host = cell.host_timers()
    if device.type == "cuda":
        log(f"card: {card_line()}")
    log(f"{workload}: setup_s {setup_s!r}, {n} {cell.unit_name}s in {window_s!r} s, peak {peak} bytes")
    cell.release()
    readings = cell.check()["program"]
    ok, table = compare.verdict(readings, cell.ctx.limits)
    metrics = {}
    if trace:
        rec = Record(workload, cell.ctx.spec, cell.ctx.config, n, summary, host, cell.flops_per_unit())
        for m in man.per_layer(workload):
            v = man.metric_reader(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        scale = cell.e2e_scale() if hasattr(cell, "e2e_scale") else 1.0
        values = {"setup_s": setup_s, kind.E2E: scale * window_s / max(n, 1)}
        for m in man.end_to_end(workload):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok and failed == 0 and n > 0), "attempted": n, "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    compare.print_table(table)
    result["checks"] = table
    return result
