"""CPU tests of the benchmark (run: python -m pytest benchmark/tests -q)."""
