"""One intra-op thread for each process that runs the port's tests.

pytest-xdist runs several workers on the host's cores, and torch's
OpenMP pool in each worker would take every core: the workers' pools
then spin against one another, and a run takes far longer in all.
Every ``tests/test_torch_*.py`` module imports this first. The
environment variable also reaches the processes the tests start (the
rank pools, the subprocesses); a value already set is kept.
"""
import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import torch  # noqa: E402

torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
