"""Torch's intra-op threads for the port's CPU tests, set on import.

Under pytest-xdist the suite runs about one worker process per core, and
each worker's torch would start an OpenMP pool as wide as the machine; the
pools then oversubscribe the cores and spin (the port's tests ran about 3x
slower so). Each worker takes its share of the cores instead; a run without
xdist keeps torch's default.
"""

import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))
