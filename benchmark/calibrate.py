#!/usr/bin/env python3
"""Readings that the limits of `correct` are set from, on the card at the
cell's own size (the benchmark's own runs do not run this).

    python3 benchmark/calibrate.py --workload hydrant.train --seeds 12 --controls 3 --first-seed 7001

For each of `--seeds` seeds: the cell's set-up (whose first steps are the
training check's), a short window of `--units` units (none for training),
and the comparison of the program with the float32 reference. For the first
`--controls` seeds also each control in the program's place: the reference
in TF32 (the precision below the configuration's float32), and for a
training cell the reference with half of each target's rays left out of the
loss (half of the batch, the mean over the rest). One JSON line per seed,
then a summary: each number's largest program reading (the lower reading)
and each control's smallest (the upper reading).
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

DEFAULT_UNITS = {"train": 0, "frames": 4, "sample": 30}


def cpu_reference_run(cell):
    """The training cell's reference on the host's CPU (the card's weights
    and draws moved there): a second witness, in another float order."""
    import dataclasses

    import torch

    from benchmark.reference.model import Model, Trainer

    ctx = dataclasses.replace(cell.ctx, device=torch.device("cpu"))
    with torch.device("cpu"):
        model = Model(ctx.spec)
    model.load_state_dict({k: v.cpu() for k, v in cell.ctx.weights().items()})
    trainer = Trainer(model)
    for k in range(cell.n_check):
        draws = {n: v.cpu() if isinstance(v, torch.Tensor) else v for n, v in cell.draws[k].items()}
        trainer.step(cell.pool[k], draws)
    return {"losses": trainer.losses, "grad": trainer.first_grad_norms, "change": trainer.change_norms()}


def witness(man, workload: str, seeds):
    """The card's reference against the CPU's, by the training cell's
    numbers: how far two float32 orders of the reference itself read."""
    import torch

    from benchmark.harness.runner import make_cell

    torch.set_num_threads(8)
    for seed in seeds:
        t0 = time.perf_counter()
        kind, cell = make_cell(man, workload, seed, torch.device("cuda"))
        cell.setup()
        cell.release()
        gpu = cell.reference_run()
        row = {"seed": seed, "cpu_vs_card_reference": cell.readings(cpu_reference_run(cell), gpu),
               "program": cell.readings(cell.program_record(), gpu), "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)


def calibrate(man, workload: str, seeds, n_controls: int, units=None, device="cuda", program_args=None):
    import torch

    from benchmark.harness.runner import make_cell, run_units

    rows = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        kind, cell = make_cell(man, workload, seed, torch.device(device), program_args)
        cell.setup()
        n = DEFAULT_UNITS[cell.ctx.mix["kind"]] if units is None else units
        if n:
            run_units(cell, n)
        cell.release()
        controls = ()
        if i < n_controls:
            controls = ("tf32", "half_batch") if cell.ctx.mix["kind"] == "train" else ("tf32",)
        row = {"seed": seed, **cell.check(controls), "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del cell
    summary = {"lower": {}, "upper": {}}
    for name in rows[0]["program"]:
        summary["lower"][name] = max(r["program"][name] for r in rows)
        for c in ("tf32", "half_batch"):
            vals = [r[c][name] for r in rows if c in r]
            if vals:
                summary["upper"].setdefault(c, {})[name] = min(vals)
    return rows, summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=7001)
    p.add_argument("--units", type=int, default=None)
    p.add_argument("--seed-list", default="", help="comma-separated seeds, in place of --seeds/--first-seed")
    p.add_argument("--witness", action="store_true",
                   help="training cells: the card's reference against the CPU's on these seeds, nothing else")
    p.add_argument("--program-arg", action="append", default=[],
                   help="key=value for the program's model (a second witness, e.g. fuse_decode=off)")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness.manifest import Manifest

    seeds = ([int(x) for x in args.seed_list.split(",")] if args.seed_list
             else [args.first_seed + 7919 * i for i in range(args.seeds)])
    if args.witness:
        witness(Manifest(ROOT), args.workload, seeds)
        return 0
    program_args = dict(kv.split("=", 1) for kv in args.program_arg)
    _, summary = calibrate(Manifest(ROOT), args.workload, seeds, args.controls, args.units,
                           program_args=program_args)
    print(json.dumps({"workload": args.workload, **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
