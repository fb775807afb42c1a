#!/usr/bin/env python3
"""The benchmark of `holo_diffusion_torch` on NVIDIA GPUs.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of `BENCHMARK.json` from the root of a checkout: set-up (the
program's model with weights made from the seed on the card, the cell's
inputs, its shapes warmed), then `--seconds` of the cell's units with
`--trace 0` (the end-to-end metrics), or the mix's fixed number of units
under torch.profiler with `--trace 1` (the per-layer metrics); then the
program's outputs against the plain reference under `benchmark/reference/`.
The last line of standard output is the result as one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error. Exits non-zero, printing no result, without enough CUDA devices, or
when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "holo_diffusion_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is a forbidden one, whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # the program's kernels build into build/ of this checkout
    # (holo_diffusion_torch/ops/_build.py); nothing else here compiles
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path.insert(0, str(ROOT))
    from benchmark.harness.manifest import Manifest

    man = Manifest(ROOT)
    chips = man.workload(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has {n}", file=sys.stderr)
        return 2
    from benchmark.harness.runner import run_cell

    result = run_cell(man, args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                      T_START)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules were loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
