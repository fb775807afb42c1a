"""The port's benchmark: `python3 benchmark/run.py --workload <name> ...` (see run.py)."""
