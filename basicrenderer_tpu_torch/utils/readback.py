"""Async device->host readback service.

Port of basicrenderer_tpu/utils/readback.py (reference: ReadbackManager
and the fenced readback path, CLodStreamingSystem.cpp:1091-1195 — GPU
writes land in a readback heap, a fence fires N frames later, the CPU maps
the buffer without ever stalling the frame).

On the card, `request` stages each tensor's copy at once: an event
recorded on the producing (current) stream, a side stream that waits on
it and copies into pinned host memory with `non_blocking=True`, and an
event after the copy. The worker thread waits on that event before it
hands the array out, so the render thread never waits on the copy. The
source tensor is kept alive until its copy has finished, so the caching
allocator cannot hand its memory to other work under the copy. CPU
tensors are copied when requested.

Bounded in-flight depth gives the frames-in-flight backpressure: when
`max_in_flight` readbacks are pending, `request` blocks the caller (the
same stall the reference takes when the CPU outruns its readback ring).
Requests resolve in request order.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from queue import Queue
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


def tree_map(fn: Callable[[Any], Any], value: Any) -> Any:
    """`fn` over the leaves of nested dicts, lists and tuples."""
    if isinstance(value, dict):
        return {k: tree_map(fn, v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(tree_map(fn, v) for v in value)
    return fn(value)


class _Staged:
    """One leaf's copy: the host array or pinned tensor, the event that
    ends its copy (None when already on the host) and the source kept
    alive until then."""

    def __init__(self, host, done=None, source=None):
        self.host, self.done, self.source = host, done, source

    def fetch(self) -> np.ndarray:
        if self.done is not None:
            self.done.synchronize()
        self.source = None
        host = self.host
        return host.numpy() if isinstance(host, torch.Tensor) else host


class ReadbackManager:
    def __init__(self, max_in_flight: int = 3):
        self._q: Queue = Queue()
        self._sem = threading.Semaphore(max_in_flight)
        self._worker: Optional[threading.Thread] = None
        self._closed = False
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._drain, name="readback", daemon=True)
            self._worker.start()

    def _drain(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            fut, staged, post = item
            try:
                arrs = tree_map(lambda s: s.fetch(), staged)
                fut.set_result(post(arrs) if post else arrs)
            except Exception as e:  # surface through the future
                fut.set_exception(e)
            finally:
                self._sem.release()

    def _stage(self, x) -> _Staged:
        """Start the copy of one leaf to the host (see the module
        docstring)."""
        if not isinstance(x, torch.Tensor):
            return _Staged(np.asarray(x))
        x = x.detach()
        if not x.is_cuda:
            return _Staged(x.clone())
        stream = self._streams.get(x.device)
        if stream is None:
            stream = self._streams[x.device] = torch.cuda.Stream(x.device)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(x.device))
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            host.copy_(x, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return _Staged(host, done, x)

    def request(self, value: Any,
                post: Callable[[Any], Any] = None) -> Future:
        """Queue an async fetch of `value` (a tensor, or nested dicts,
        lists and tuples of them). Returns a Future resolving to the same
        structure of numpy arrays (after `post`, if given — it runs on the
        worker). Blocks only when `max_in_flight` readbacks are already
        pending; requests resolve strictly in request order."""
        if self._closed:
            raise RuntimeError("ReadbackManager is closed")
        self._sem.acquire()
        try:
            staged = tree_map(self._stage, value)   # copies start now
        except BaseException:
            self._sem.release()
            raise
        fut: Future = Future()
        self._q.put((fut, staged, post))
        self._ensure_worker()
        return fut

    def close(self):
        self._closed = True
        if self._worker is not None and self._worker.is_alive():
            self._q.put(None)
            self._worker.join(timeout=5.0)
