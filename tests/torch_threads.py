"""One PyTorch intra-op thread in every test process. The suite runs in
several pytest-xdist workers on one machine, and PyTorch's default of one
OpenMP thread per core in each worker oversubscribes the cores several
times over; the spinning threads then slow every test, JAX's included.
Six of the port's heavy test files took 441 s of wall time on 6 workers
with the default and 101 s with one thread each (on an 8-core CPU). Every
port test module that runs on the CPU imports this (the card's tests do
not), and each worker imports every test module when it collects, so the
setting holds in every worker."""
import torch

torch.set_num_threads(1)
