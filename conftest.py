"""How the tests run under pytest-xdist, and a time limit per test. Pytest
loads this file before tests/conftest.py.

Under xdist each worker gets its share of the cores for torch's threads,
set before torch loads so that spawned ranks inherit it, and the workers
that load JAX share one XLA compilation cache for the run (a temporary
directory). One process without workers keeps the defaults. Past
TEST_LIMIT_S in a test's setup, call or teardown, faulthandler dumps every
thread's stack, and SIGALRM fails the test once the main thread runs
Python again: a hang inside native code is dumped, not failed.
"""

import faulthandler
import os
import shutil
import signal
import sys
import tempfile

import pytest

TEST_LIMIT_S = 420
_CACHE_VAR = "BASICRENDERER_XLA_CACHE"   # the JAX Renderer reads it too
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _WORKERS:
    _THREADS = max(1, (os.cpu_count() or 1) // _WORKERS)
    for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(_var, str(_THREADS))

_stderr = None      # a dup of fd 2: pytest captures fd 2 during a test
_own_cache = None   # the cache directory this process made for its workers


def _past_limit(signum, frame):
    pytest.fail(f"the test ran past its limit of {TEST_LIMIT_S} s")


def pytest_configure(config):
    global _stderr, _own_cache
    _stderr = os.dup(2)
    signal.signal(signal.SIGALRM, _past_limit)
    if _WORKERS:
        import torch
        torch.set_num_threads(_THREADS)
        torch.set_num_interop_threads(_THREADS)
        if "jax" in sys.modules:
            from basicrenderer_tpu.utils.compile_cache import \
                enable_compilation_cache
            enable_compilation_cache()
    elif config.getoption("numprocesses", None) and \
            _CACHE_VAR not in os.environ:
        # The xdist controller, before it starts the workers.
        _own_cache = os.environ[_CACHE_VAR] = tempfile.mkdtemp(
            prefix="xla-cache-")


def pytest_unconfigure(config):
    if _own_cache:
        shutil.rmtree(_own_cache, ignore_errors=True)


@pytest.hookimpl(wrapper=True)
def _limited(item):
    faulthandler.dump_traceback_later(TEST_LIMIT_S, file=_stderr)
    signal.alarm(TEST_LIMIT_S + 1)
    try:
        return (yield)
    finally:
        signal.alarm(0)
        faulthandler.cancel_dump_traceback_later()


pytest_runtest_setup = pytest_runtest_call = pytest_runtest_teardown = _limited
