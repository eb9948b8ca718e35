"""Bounds torch's CPU thread pool in a test process of the port's tests.

Under pytest-xdist the workers share the machine's cores, and each
worker's torch would run one thread per core: with six workers on eight
cores the OpenMP threads oversubscribe the cores and spin while they wait
(ResNet-18 at batch 2 ran a train step in 14.3 s with the default pool and
0.75 s with one thread, on an 8-core machine beside a six-worker run). The
port's newer test modules import this module, and pytest-xdist has each
worker import every test module while it collects, so the bound holds in
every worker: ``cores // workers`` threads (at least one), where
``workers`` is pytest-xdist's ``PYTEST_XDIST_WORKER_COUNT`` (1 without
xdist) and ``cores`` the CPUs this process may run on. A run without
xdist keeps one thread per core, as before.
"""

import os

import torch


def bound():
    workers = max(1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
    n = max(1, len(os.sched_getaffinity(0)) // workers)
    if torch.get_num_threads() > n:
        torch.set_num_threads(n)
    return torch.get_num_threads()


bound()
