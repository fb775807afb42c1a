"""FLOP and byte counts of the benchmark's yardstick, from shapes."""
