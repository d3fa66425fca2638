"""Per-pass device profiling of a frame function.

Port of basicrenderer_tpu/utils/profiling.py (reference: the per-pass GPU
timestamp queries and the frame task-graph telemetry). The JAX package
maps XLA's fused ops back to source lines; here the passes are the
frame's own stages and kernels:

- per-stage times from CUDA events recorded as the frame enters each
  stage (the frame's `stage_hook`; graph/frame.build_frame_fn lists the
  stages), on the host clock when the frame runs on the CPU;
- per-kernel device time from torch.profiler: each kernel's mean event
  duration times its launches a call, because the profiler loses device
  events late in a long process (a trace that lost half a call's worth
  of some kernel is taken again).

    from basicrenderer_tpu_torch.utils.profiling import profile_fn
    rows = profile_fn(frame_fn, buffers, view, params)   # [(name, ms), ...]
"""

from __future__ import annotations

import inspect
import re
import statistics
import time
from typing import Callable, Dict, List, Tuple

import torch


def _on_card(args, kwargs) -> bool:
    """Whether a tensor argument, or a tensor field of a dataclass argument
    (SceneBuffers, ViewData, FrameParams), lies on the card."""
    for v in list(args) + list(kwargs.values()):
        fields = ([getattr(v, f) for f in v.__dataclass_fields__]
                  if hasattr(v, "__dataclass_fields__") else [v])
        if any(isinstance(x, torch.Tensor) and x.is_cuda for x in fields):
            return True
    return False


def stage_times(fn: Callable, *args, iters: int = 5,
                **kwargs) -> Dict[str, float]:
    """{stage: mean ms per call} of `fn(*args, stage_hook=..., **kwargs)`
    over `iters` calls after a warm call: the time from entering each
    stage to entering the next (the "end" mark closes the last)."""
    card = _on_card(args, kwargs)
    marks: List[Tuple[str, object]] = []

    def hook(name):
        if card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))
        else:
            marks.append((name, time.perf_counter()))

    fn(*args, stage_hook=hook, **kwargs)
    times: Dict[str, List[float]] = {}
    for _ in range(iters):
        marks.clear()
        fn(*args, stage_hook=hook, **kwargs)
        if card:
            torch.cuda.synchronize()
        for (name, a), (_, b) in zip(marks, marks[1:]):
            ms = a.elapsed_time(b) if card else (b - a) * 1e3
            times.setdefault(name, []).append(ms)
    return {k: sum(v) / iters for k, v in times.items()}


def kernel_times(fn: Callable, *args, iters: int = 5,
                 **kwargs) -> Dict[str, float]:
    """{kernel: mean device ms per call} of `fn(*args, **kwargs)` on the
    card from a torch.profiler trace of `iters` calls after a warm call:
    each kernel's (and copy's) mean event duration times its launches a
    call, its event count over `iters` rounded (at least 1: every call is
    the same). A trace that lost half a call's worth of some kernel's
    events is taken again, up to 5 times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(*args, **kwargs)
    counts = None
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn(*args, **kwargs)
            torch.cuda.synchronize()
        events: Dict[str, List[float]] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                events.setdefault(e.name, []).append(
                    e.time_range.elapsed_us() / 1e3)
        counts = {k: len(v) for k, v in events.items()}
        per_call = {k: max(1, round(c / iters)) for k, c in counts.items()}
        if events and all(abs(counts[k] - n * iters) <= iters // 2
                          for k, n in per_call.items()):
            parts: Dict[str, float] = {}
            for name, durations in events.items():
                m = re.search(r"::(\w+(?:<[^>(]*>)?)\(", name)
                key = m.group(1) if m else name[:60]
                parts[key] = parts.get(key, 0.0) + (
                    statistics.mean(durations) * per_call[name])
            return parts
    raise RuntimeError(f"torch.profiler lost device events in 5 traces of "
                       f"{iters} calls: {counts}")


def profile_fn(fn: Callable, *args, iters: int = 5,
               **kwargs) -> List[Tuple[str, float]]:
    """Run `fn(*args, **kwargs)` under the timers and return [(name,
    ms per call), ...]: "stage <name>" rows in frame order when `fn`
    takes a `stage_hook` (a frame function), then on the card "kernel
    <name>" rows (device time), sorted by cost."""
    rows: List[Tuple[str, float]] = []
    if "stage_hook" in inspect.signature(fn).parameters:
        rows += [(f"stage {k}", ms) for k, ms in
                 stage_times(fn, *args, iters=iters, **kwargs).items()]
    if _on_card(args, kwargs):
        parts = kernel_times(fn, *args, iters=iters, **kwargs)
        rows += [(f"kernel {k}", ms) for k, ms in
                 sorted(parts.items(), key=lambda kv: -kv[1])]
    return rows


def print_profile(rows: List[Tuple[str, float]], top: int = 25) -> None:
    stages = [(n, ms) for n, ms in rows if n.startswith("stage ")]
    kernels = [(n, ms) for n, ms in rows if n.startswith("kernel ")]
    for label, part in (("stages", stages), ("device kernels", kernels)):
        if part:
            print(f"{label} total ~{sum(ms for _, ms in part):.2f} ms/call")
            for name, ms in part[:top]:
                print(f"  {ms:8.3f} ms  {name}")
