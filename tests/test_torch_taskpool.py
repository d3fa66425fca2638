"""The port's task pool (utils/taskpool.py) against the JAX package's: the
cases of tests/test_taskpool.py run on both pools, and each observed
outcome (results, run order, counters, barrier and cancel behaviour) must
be the same."""

import threading
import time

import numpy as np
import pytest

from basicrenderer_tpu.utils import taskpool as jtp
from basicrenderer_tpu_torch.utils import taskpool as ptp

POOLS = {"jax": jtp, "port": ptp}


def _both(scenario):
    """{package: scenario(taskpool module)} for both packages."""
    return {name: scenario(mod) for name, mod in POOLS.items()}


def _map_ordered(tp):
    pool = tp.TaskPool(workers=4, name="t")
    try:
        out = pool.map(lambda x: x * x, range(50))
        return out, pool.stats()
    finally:
        pool.shutdown()


def _priority_order(tp):
    pool = tp.TaskPool(workers=1, name="p")
    try:
        order = []
        gate = threading.Event()
        pool.submit(gate.wait)
        futs = [pool.submit(order.append, k, priority=pr)
                for k, pr in (("low", 5.0), ("high", -1.0), ("mid", 1.0),
                              ("mid2", 1.0))]
        gate.set()
        for f in futs:
            f.result(timeout=5)
        return order
    finally:
        pool.shutdown()


def _exception(tp):
    pool = tp.TaskPool(workers=2, name="e")
    try:
        f = pool.submit(lambda: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            f.result(timeout=5)
        return pool.submit(lambda: 7).result(timeout=5)
    finally:
        pool.shutdown()


def _group_barrier(tp):
    pool = tp.TaskPool(workers=4, name="g")
    try:
        done = []
        for i in range(16):
            pool.submit(lambda k: (time.sleep(0.005), done.append(k)),
                        i, group="batch")
        first = pool.wait_group("batch", timeout=10)
        again = pool.wait_group("batch", timeout=0.1)
        return first, sorted(done), again
    finally:
        pool.shutdown()


def _cancelled(tp):
    pool = tp.TaskPool(workers=1, name="t-cancel")
    try:
        gate = threading.Event()
        pool.submit(gate.wait, group="g")
        fut = pool.submit(lambda: 1, group="g")
        cancelled = fut.cancel()
        gate.set()
        return cancelled, pool.wait_group("g", timeout=10.0)
    finally:
        pool.shutdown()


def _after_shutdown(tp):
    pool = tp.TaskPool(workers=1, name="s")
    pool.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        pool.submit(lambda: 1)
    return pool.stats()


@pytest.mark.parametrize("scenario", [_map_ordered, _priority_order,
                                      _exception, _group_barrier, _cancelled,
                                      _after_shutdown])
def test_pool_matches_jax(scenario):
    out = _both(scenario)
    assert out["port"] == out["jax"]


def test_pool_outcomes():
    """The port's outcomes are the ones tests/test_taskpool.py asserts."""
    out, st = _map_ordered(ptp)
    assert out == [x * x for x in range(50)]
    assert st["submitted"] == 50 and st["completed"] == 50
    assert _priority_order(ptp) == ["high", "mid", "mid2", "low"]
    assert _exception(ptp) == 7
    assert _group_barrier(ptp) == (True, list(range(16)), True)
    assert _cancelled(ptp) == (True, True)


def test_shared_pool_singleton():
    assert ptp.shared_pool() is ptp.shared_pool()
    assert ptp.shared_pool() is not jtp.shared_pool()
    assert ptp.shared_pool().workers == jtp.shared_pool().workers


def test_strip_pyramid_matches_jax_parallel_build():
    """The JAX registry builds its layers on the pool (>= 4 layers); the
    port's strip pyramids, alpha-coverage layer included, must equal
    them bit for bit in both formats."""
    from basicrenderer_tpu.models.textures import TextureRegistry as JTex
    from basicrenderer_tpu_torch.models.textures import TextureRegistry as PTex

    rng = np.random.default_rng(3)
    regs = (JTex(resolution=64), PTex(resolution=64))
    for k in range(6):
        img = (rng.random((64, 64, 4)) * 255).astype(np.uint8)
        for reg in regs:
            reg.add(img, srgb=(k % 2 == 0),
                    alpha_cutoff=0.5 if k == 1 else -1.0)
    for fmt in ("rgba8", "bc3"):
        (js, jf), (ps, pf) = (r.strip_pyramid(fmt=fmt) for r in regs)
        np.testing.assert_array_equal(ps, js)
        np.testing.assert_array_equal(pf, jf)
