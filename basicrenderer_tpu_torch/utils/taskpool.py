"""General background task pool (TaskSchedulerManager analogue).

Port of basicrenderer_tpu/utils/taskpool.py, copied with its behaviour
unchanged. The pool runs the HOST side of bursty, import-shaped work:
image decode and BC encode at import, per-layer mip builds, container IO,
all of which release the GIL in numpy/PIL and parallelize on worker
threads. Device work stays on the frame's CUDA stream.

Semantics: priority tasks (lower value runs first), per-task futures,
named groups with a barrier wait, and counters for telemetry.
"""

from __future__ import annotations

import heapq
import itertools
import os
import threading
from concurrent.futures import Future
from typing import Any, Callable, Dict, Iterable, List, Optional


class TaskPool:
    def __init__(self, workers: Optional[int] = None, name: str = "tasks"):
        self.name = name
        self.workers = workers or max(2, (os.cpu_count() or 4) - 1)
        self._heap: List = []
        self._tick = itertools.count()      # FIFO tie-break within priority
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._groups: Dict[str, int] = {}   # group -> outstanding count
        self._group_done = threading.Condition(self._lock)
        self._stop = False
        self.submitted = 0
        self.completed = 0
        self._threads = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"{name}-{i}")
            for i in range(self.workers)]
        for t in self._threads:
            t.start()

    def submit(self, fn: Callable, *args, priority: float = 0.0,
               group: Optional[str] = None, **kwargs) -> Future:
        """Enqueue fn(*args, **kwargs); lower priority value runs first."""
        fut: Future = Future()
        with self._lock:
            if self._stop:
                raise RuntimeError(f"TaskPool {self.name} is shut down")
            heapq.heappush(self._heap, (priority, next(self._tick),
                                        fn, args, kwargs, fut, group))
            self.submitted += 1
            if group is not None:
                self._groups[group] = self._groups.get(group, 0) + 1
            self._work.notify()
        return fut

    def map(self, fn: Callable, items: Iterable, priority: float = 0.0
            ) -> List[Any]:
        """Run fn(item) for each item on the pool; ordered results, first
        exception re-raised (like the serial loop it replaces)."""
        futs = [self.submit(fn, it, priority=priority) for it in items]
        return [f.result() for f in futs]

    def wait_group(self, group: str, timeout: Optional[float] = None) -> bool:
        """Block until every task submitted under `group` has finished."""
        with self._lock:
            return self._group_done.wait_for(
                lambda: self._groups.get(group, 0) == 0, timeout=timeout)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"workers": self.workers, "queued": len(self._heap),
                    "submitted": self.submitted, "completed": self.completed}

    def shutdown(self, wait: bool = True) -> None:
        with self._lock:
            self._stop = True
            self._work.notify_all()
        if wait:
            for t in self._threads:
                t.join(timeout=5)

    def _run(self) -> None:
        while True:
            with self._lock:
                self._work.wait_for(lambda: self._heap or self._stop)
                if self._stop and not self._heap:
                    return
                _p, _t, fn, args, kwargs, fut, group = heapq.heappop(
                    self._heap)
            # Bookkeeping must run even when the future was cancelled while
            # queued, or wait_group() on its group would block forever.
            if fut.set_running_or_notify_cancel():
                try:
                    fut.set_result(fn(*args, **kwargs))
                except BaseException as e:      # delivered via future
                    fut.set_exception(e)
            with self._lock:
                self.completed += 1
                if group is not None:
                    self._groups[group] -= 1
                    if self._groups[group] == 0:
                        del self._groups[group]
                        self._group_done.notify_all()


_shared: Optional[TaskPool] = None
_shared_lock = threading.Lock()


def shared_pool() -> TaskPool:
    """Process-wide pool for import/IO burst work."""
    global _shared
    with _shared_lock:
        if _shared is None:
            _shared = TaskPool(name="br-shared")
        return _shared
