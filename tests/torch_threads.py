"""The port's tests' share of the CPU under pytest-xdist.

PyTorch runs a CPU op on one OpenMP thread a core by default, so under
``pytest -n N`` the N workers would run N threads a core between them,
and a worker's spinning threads take the cores from the others: on 8
cores the port's heaviest test files ran three times slower for it.
Every port test module imports this one, which gives its worker's torch
ceil(cores / N) threads; outside xdist it changes nothing.  The ranks of
the distribution tests take one thread each (``torch_world``).
"""
import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if WORKERS > 1:
    torch.set_num_threads(max(1, -(-(os.cpu_count() or 1) // WORKERS)))
