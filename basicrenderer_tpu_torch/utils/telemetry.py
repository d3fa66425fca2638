"""Frame telemetry: per-stage host timings + device counters + history.

Host-only copy of basicrenderer_tpu/utils/telemetry.py. Reference
analogues: the frame task graph (BasicRenderer/include/Render/
FrameTaskGraphTelemetry.h:9-44, per-frame CPU stage snapshots), per-pass
GPU timestamps (Renderer.cpp:1912-1915) and the CLod GPU counter buffer
(CLodTelemetry.h:7-60). Device-side counters are the frame's scalar
outputs (bin/light/cluster overflows, pair counts), kept as tensors and
read only when dumped (`int(tensor)` synchronises then, not during the
frame); host stages are timed with the `stage` context manager (on the
card a stage times the host's queueing of its work). A ring buffer keeps
the last N frames for the UI and the headless dump."""

from __future__ import annotations

import collections
import contextlib
import json
import time
from typing import Any, Deque, Dict, List, Optional


class FrameTelemetry:
    def __init__(self, history: int = 256):
        self.history: Deque[Dict[str, Any]] = collections.deque(maxlen=history)
        self._current: Dict[str, Any] = {}
        self._frame_start = 0.0
        self.frame_index = 0

    # -- frame lifecycle -----------------------------------------------------
    def begin_frame(self) -> None:
        self._current = {"frame": self.frame_index, "stages": {}, "counters": {}}
        self._frame_start = time.perf_counter()

    def end_frame(self) -> None:
        self._current["frame_ms"] = (time.perf_counter() - self._frame_start) * 1e3
        self.history.append(self._current)
        self.frame_index += 1

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time a host-side stage (reference: ZoneScopedN per stage)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            st = self._current.setdefault("stages", {})
            st[name] = st.get(name, 0.0) + ms

    def counter(self, name: str, value) -> None:
        self._current.setdefault("counters", {})[name] = value

    def record_frame_outputs(self, out: Dict[str, Any]) -> None:
        """Capture the frame's scalar counters WITHOUT a device sync: the
        tensors are kept and read when dumped."""
        for k in ("num_pairs", "bin_overflow", "light_overflow"):
            if k in out:
                self._current.setdefault("counters", {})[k] = out[k]

    # -- reporting -------------------------------------------------------------
    def last(self) -> Optional[Dict[str, Any]]:
        return self.history[-1] if self.history else None

    def averages(self, n: int = 60) -> Dict[str, float]:
        frames = list(self.history)[-n:]
        if not frames:
            return {}
        out: Dict[str, float] = {"frame_ms": 0.0}
        for f in frames:
            out["frame_ms"] += f.get("frame_ms", 0.0)
            for k, v in f.get("stages", {}).items():
                out[f"stage.{k}"] = out.get(f"stage.{k}", 0.0) + v
        return {k: v / len(frames) for k, v in out.items()}

    def dump_json(self, path: str) -> None:
        def fetch(v):
            try:
                return int(v)
            except Exception:
                try:
                    return float(v)
                except Exception:
                    return str(v)

        frames = []
        for f in self.history:
            frames.append({
                "frame": f.get("frame"),
                "frame_ms": f.get("frame_ms"),
                "stages": f.get("stages", {}),
                "counters": {k: fetch(v) for k, v in f.get("counters", {}).items()},
            })
        with open(path, "w") as fp:
            json.dump(frames, fp, indent=1)
