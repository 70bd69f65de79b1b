"""Thread cap for the port's CPU tests (not a test file).

Under pytest-xdist every worker is a process of its own, and each worker's
torch takes an intra-op OpenMP team as wide as the host. With ``-n 6`` on
eight cores the teams spin against each other: a test that takes half a
second alone takes minutes. So every ``tests/test_torch_*.py`` imports this
module (``tests/test_torch_test_env.py`` holds every such file to that), and
each worker gives torch its share of the cores: ``cpu_count // workers``, at
least one; torch's own default when pytest runs without xdist.

``OMP_NUM_THREADS`` and ``MKL_NUM_THREADS`` are set to the same count where
they are not set already, so the processes the tests spawn (the task
runner's workers, the bench subprocess, the import guards, the gloo ranks)
start with the same cap.

It imports only ``os`` and ``torch``: the card's test files run with
``--noconftest`` and load no jax.
"""

import os

import torch


def worker_threads() -> int:
    """The torch threads one test process may use."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        return max(1, (os.cpu_count() or 1) // int(workers))
    return torch.get_num_threads()


THREADS = worker_threads()
torch.set_num_threads(THREADS)
for _name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_name, str(THREADS))
