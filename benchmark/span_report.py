#!/usr/bin/env python3
"""The program's `holo.*` spans in a cell's traced window.

    python3 benchmark/span_report.py --workload <name> --seed <n> [--out <file.json>]

Set-up as `run.py` does it, then the mix's `trace_units` under
torch.profiler inside the `bench.window` annotation, as `--trace 1` runs
them. Prints one JSON object: the window, each span's figures
(`harness/spans.py`), the cell's per-layer metrics as `run.py` reads them,
the readings of each layer from its spans (below), and how much of the
window the unit's outermost spans cover. Without `--out` the object goes
to standard output only. No comparison with the reference is made.

The readings table and the traced window here stand in for metric files
while `harness/trace.py` does not reduce spans; once `TraceSummary`
carries them and metric files read them, these go, leaving at most the
coverage printout on top of `trace.traced()`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _ms_per_unit(field):
    return lambda sp, name, units: 1e3 * getattr(sp[name], field) / units if name in sp else None


def _ms_per_span(sp, name, units):
    return 1e3 * sp[name].host_s / sp[name].count if name in sp and sp[name].count else None


# for each mix kind: the unit's outermost spans, and each reading's span
# and how it is read (per unit of the window, or per span)
ROOTS = {"train": ("holo.step", "holo.data.wait"), "frames": ("holo.chunk",), "sample": ("holo.ddpm",)}
READINGS = {
    "train": {f"{k}_ms.train": (f"holo.{s}", _ms_per_unit("host_s")) for k, s in (
        ("data_wait", "data.wait"), ("extract", "extract"), ("pool", "pool"), ("unet", "unet"),
        ("render", "render"), ("backward", "backward"), ("optimizer", "optimizer"))},
    "frames": {"chunk_ms.frames": ("holo.chunk", _ms_per_span)},
    "sample": {"sampler_self_ms.sample": ("holo.ddpm", _ms_per_unit("self_s")),
               "unet_device_ms.sample": ("holo.unet", _ms_per_unit("device_s"))},
}
# a span's share of a roofline: the least time of the kernel-name metric
# (`metrics/<metric>.py`) over the span's device seconds
SPAN_ROOFLINES = {"train": {"decode_bwd_span_roofline.train": ("holo.decode.bwd", "decode_bwd_roofline.train")},
                  "frames": {"decode_fwd_span_roofline.frames": ("holo.decode", "decode_fwd_roofline.frames")}}


def report(man, workload: str, seed: int, device) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.harness.runner import Record, _sync, card_line, make_cell, run_units
    from benchmark.harness.spans import reduce_spans
    from benchmark.harness.trace import WINDOW, summarize

    device = torch.device(device)
    kind, cell = make_cell(man, workload, seed, device)
    mix_kind = cell.ctx.mix["kind"]
    cell.setup()
    _sync(device)
    n = cell.ctx.mix["trace_units"]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            run_units(cell, n)
            _sync(device)
    events = prof.profiler.kineto_results.events()
    summary, spans = summarize(events), reduce_spans(events)
    host = cell.host_timers()
    cell.release()
    rec = Record(workload, cell.ctx.spec, cell.ctx.config, n, summary, host, cell.flops_per_unit())
    per_layer = {m["name"]: man.metric_reader(m["name"]).read(rec) for m in man.per_layer(workload)}
    sp = spans.spans
    readings = {name: read(sp, span, n) for name, (span, read) in READINGS.get(mix_kind, {}).items()}
    for name, (span, metric) in SPAN_ROOFLINES.get(mix_kind, {}).items():
        kernel_share = per_layer.get(metric)
        kernel_s = summary.device_seconds(*man.metric_reader(metric).KERNELS)
        span_s = sp[span].device_s if span in sp else 0.0
        readings[name] = kernel_share * kernel_s / span_s if kernel_share and span_s > 0 else None
    roots = sum(sp[r].host_s for r in ROOTS[mix_kind] if r in sp)
    return {
        "workload": workload, "seed": seed, "units": n, "window_s": summary.window_s,
        "unit_s": summary.window_s / n, "busy_s": summary.busy_s,
        "card": card_line() if device.type == "cuda" else "cpu",
        "readings": readings, "per_layer": per_layer,
        "root_host_share": roots / summary.window_s,
        "idle_s": spans.idle_s, "idle_credited_share": spans.idle_credited_s / spans.idle_s if spans.idle_s else None,
        "spans": {k: dataclasses.asdict(v) for k, v in sorted(sp.items())},
        "idle_by_host": summary.idle_by_host[:10],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness.manifest import Manifest

    if not torch.cuda.is_available():
        print("span_report needs a CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    out = report(Manifest(ROOT), args.workload, args.seed, "cuda")
    out["seconds"] = time.perf_counter() - t0
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
