"""Give each pytest-xdist worker its share of the CPUs for torch.

torch's intra-op pool takes one thread per CPU in every process, so six
workers on eight CPUs run some 48 busy threads on eight cores, and the tests
slow down by far more than their work.  On an 8-CPU machine the tier-1 run
(``-n 6 --dist loadfile``) took 1109 s without the cap below and 277 s with
it; SepConv through the video driver, its slowest port test, 590.9 s and
1.8 s.  A worker (xdist sets ``PYTEST_XDIST_WORKER_COUNT`` there) keeps
``CPUs // workers`` threads, at least one; a run without xdist, or with
``--noconftest``, keeps torch's own default.  ``tests/conftest.py`` is the
JAX suite's and is separate.
"""
import os


def pytest_configure(config):
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        return
    import torch

    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // int(workers)))
