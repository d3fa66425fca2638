"""One cell of the port's benchmark: set-up, the measured window, the
traced frames and the check against the plain reference.

The window drives the port's entry point, `Renderer.update()` then
`Renderer.render()` each frame, with at most `frames_in_flight` frames
queued (a CUDA event after each render; frame n + 3 waits on frame n's),
the camera advanced a step a frame along the traffic's periodic path, and
no image read back before the window closes with a synchronise.

The record the per-layer readers (portbench/metrics/) see:

- "resolution": the render resolution (width, height);
- "frames": frames dispatched in the window;
- "intervals_ms": the intervals between consecutive completion events,
  one a window frame (the first from the last warm frame's);
- "stages_ms": the Renderer telemetry's host stages summed over the
  window ("scene_update", "scene_commit", "dispatch");
- "trace" (traced run): {"frames", "window_s", "busy_s", "events"}: the
  profiled frames' device events as (name, start us, end us), the span of
  the profile and the union of its device intervals;
- "captures" (traced run): {metric: [bound ms of each captured call]}.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from collections import deque

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "basicrenderer_tpu_torch"
# Top-level module names that may not be loaded once the window closes.
FORBIDDEN = ("jax", "jaxlib", "flax", "basicrenderer_tpu")
# Outputs of a frame that the check compares.
OUT_KEYS = ("vis", "depth", "hdr", "image")
CHECKED = 3              # window frames compared, drawn from the seed ...
CHECK_SPAN = 64          # ... among the window's first CHECK_SPAN
PHASES = 1000            # the seed's start on the camera path, in frames
TELEMETRY_STAGES = ("scene_update", "scene_commit", "dispatch")
GAPS_READ = 5000         # longest idle gaps labelled by the host's activity
OP_NAME_CHARS = 120      # a device operation's name in the breakdown


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """portbench/<kind>/<name>.py, imported by path."""
    path = os.path.join(HERE, kind, name + ".py")
    mod_name = f"portbench.{kind}.{name.replace('-', '_').replace('.', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_spec(bench: dict, workload: str) -> dict:
    """The cell `workload` of BENCHMARK.json with its configuration and
    traffic files loaded and the metrics it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]
    return {
        "name": workload, "chips": cell["chips"],
        "config": load_json(os.path.join(ROOT, cfg_entry["file"])),
        "traffic": load_json(os.path.join(HERE, "traffic",
                                          cell["traffic"] + ".json")),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


# -- the camera path -----------------------------------------------------------
def camera_angle(traffic: dict, n: int) -> float:
    """The camera's turn about its target's vertical axis at frame n of
    the path, `phase` frames in: a triangle wave of amplitude
    `amplitude_rad` and slope `rad_per_frame`, or with no amplitude a
    steady orbit (a held camera at slope 0)."""
    rate, amp = traffic["rad_per_frame"], traffic["amplitude_rad"]
    x = (n + traffic.get("phase", 0)) * rate
    if amp <= 0.0:
        return x
    x = math.fmod(x, 4.0 * amp)
    if x < amp:
        return x
    if x < 3.0 * amp:
        return 2.0 * amp - x
    return x - 4.0 * amp


def camera_pose(cam: dict, traffic: dict, n: int):
    """(position, target) of the camera at frame n: the configuration's
    camera turned about its target's vertical axis."""
    a = camera_angle(traffic, n)
    p = np.asarray(cam["position"], np.float64)
    t = np.asarray(cam["target"], np.float64)
    d = p - t
    c, s = math.cos(a), math.sin(a)
    pos = t + np.array([c * d[0] + s * d[2], d[1], -s * d[0] + c * d[2]])
    return tuple(float(v) for v in pos), tuple(float(v) for v in t)


# -- set-up ----------------------------------------------------------------------
def build_scene(config: dict, seed: int) -> dict:
    """The scene as plain data (portbench/scenes/<scene>.py)."""
    return load_module("scenes", config["scene"]).build(
        config["scene_params"], seed)


def build_program(config: dict, desc: dict, device: str):
    """The port's Renderer with the configuration's settings (and its
    `frame_config` fields) and the scene `desc` loaded through its public
    registries; returns (renderer, scene)."""
    from basicrenderer_tpu_torch.models.materials import Material
    from basicrenderer_tpu_torch.models.mesh import MeshData
    from basicrenderer_tpu_torch.renderer import Renderer
    from basicrenderer_tpu_torch.scene.bridge import BridgeCapacities
    from basicrenderer_tpu_torch.scene.scene import Scene
    meshes = desc["meshes"]
    nv = sum(len(m["positions"]) for m in meshes)
    nt = sum(len(m["indices"]) for m in meshes)
    ncl = sum((len(m["indices"]) + 127) // 128 for m in meshes)
    r = Renderer(caps=BridgeCapacities(
        max_vertices=nv, max_triangles=nt,
        max_objects=len(desc["objects"]),
        max_materials=len(desc["materials"]) + 1, max_lights=1,
        max_clusters=ncl, max_geom_clusters=ncl), device=device)
    for k, v in config["settings"].items():
        r.settings.set(k, tuple(v) if isinstance(v, list) else v)
    # FrameConfig fields that no Renderer setting reaches (capacities sized
    # to the scene), set on every FrameConfig the Renderer builds.
    fixed = config.get("frame_config")
    if fixed:
        built = r._build_config
        r._build_config = lambda: dataclasses.replace(built(), **fixed)
    mesh_ids = [r.meshes.add(MeshData(
        positions=m["positions"], normals=m["normals"],
        uvs=np.zeros((len(m["positions"]), 2), np.float32),
        indices=m["indices"])) for m in meshes]
    mat_ids = [r.materials.add(Material(
        base_color=np.array(list(m["base_color"]) + [1.0], np.float32),
        metallic=m["metallic"], roughness=m["roughness"]))
        for m in desc["materials"]]
    scene = Scene()
    for ob in desc["objects"]:
        half = 0.5 * ob["yaw"]
        scene.create_renderable(
            mesh_ids[ob["mesh"]], mat_ids[ob["material"]],
            position=tuple(ob["position"]),
            rotation=np.array([0.0, math.sin(half), 0.0, math.cos(half)],
                              np.float32),
            scale=(ob["scale"],) * 3)
    sun = desc["sun"]
    scene.create_directional_light(direction=tuple(sun["direction"]),
                                   color=tuple(sun["color"]),
                                   intensity=sun["intensity"])
    scene.propagate_transforms()
    r.set_current_scene(scene)
    return r, scene


def aspect_of(config: dict) -> float:
    w, h = config["settings"]["renderResolution"]
    return w / h


class HostEvent:
    """A completion mark on the host clock, for a run on the CPU."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


class FrameLoop:
    """update() then render() a frame, the camera a step further each
    frame, at most `frames_in_flight` frames queued."""

    def __init__(self, r, scene, config, traffic, device):
        self.r, self.scene, self.config, self.traffic = r, scene, config, \
            traffic
        self.cuda = torch.device(device).type == "cuda"
        self.aspect = aspect_of(config)
        self.queued = deque()
        self.n = 0

    def step(self):
        if len(self.queued) >= self.traffic["frames_in_flight"]:
            self.queued.popleft().synchronize()
        cam = self.config["camera"]
        pos, target = camera_pose(cam, self.traffic, self.n)
        self.scene.set_camera(position=pos, target=target,
                              fov_y=cam["fov_y"], near=cam["near"],
                              aspect=self.aspect)
        self.r.update()
        out = self.r.render()
        ev = torch.cuda.Event(enable_timing=True) if self.cuda else HostEvent()
        ev.record()
        self.queued.append(ev)
        self.n += 1
        return out, ev

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()
        self.queued.clear()


def snapshot(out, device=None):
    """Copies of a frame's outputs that the check compares, on `device`
    (default: where they are)."""
    return {k: out[k].detach().to(device, copy=True) if device
            else out[k].clone() for k in OUT_KEYS}


# -- the traced frames -------------------------------------------------------------
def _capture(metric_mods):
    """Wrap each metric's `CAPTURE` entry of the port; returns ({metric:
    calls}, restore)."""
    calls, undo = {}, []
    for name, mod in metric_mods.items():
        target = getattr(mod, "CAPTURE", None)
        if not target:
            continue
        mod_path, fn_name = target.rsplit(".", 1)
        m = importlib.import_module(f"{PROGRAM}.{mod_path}")
        orig = getattr(m, fn_name)
        seen = calls.setdefault(name, [])

        def wrapper(*a, _orig=orig, _seen=seen, **kw):
            _seen.append((a, kw))
            return _orig(*a, **kw)
        functools.update_wrapper(wrapper, orig)   # carries `.launches`
        setattr(m, fn_name, wrapper)
        undo.append((m, fn_name, orig, wrapper))

    def restore():
        for m, fn_name, orig, wrapper in undo:
            orig.__dict__.update(wrapper.__dict__)
            setattr(m, fn_name, orig)
    return calls, restore


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def op_name(name: str) -> str:
    """A device operation's name without its return type and parameter
    list, at most OP_NAME_CHARS long."""
    name = name.removeprefix("void ").replace("(anonymous namespace)", "anon")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[:OP_NAME_CHARS] or "(unnamed)"


def read_profile(prof):
    """(device events, window s, busy s, breakdown) of a torch.profiler
    run: device events are (name, start us, end us) of kernels, memcpys and
    memsets; the breakdown lists the 10 device operations that took most
    time and the 10 host activities (the innermost host event under the
    gap's middle) that the longest device idle gaps fell in."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.events():
        rng = (e.name, float(e.time_range.start), float(e.time_range.end))
        (dev if e.device_type == DeviceType.CUDA else host).append(rng)
    if not dev:
        return [], 0.0, 0.0, {"device_ops": [], "idle_gaps": []}
    t0 = min(min(s for _, s, _ in dev), min((s for _, s, _ in host),
                                             default=math.inf))
    t1 = max(max(e for _, _, e in dev), max((e for _, _, e in host),
                                             default=-math.inf))
    merged = _merge([(s, e) for _, s, e in dev])
    busy = sum(b - a for a, b in merged)
    ops = {}
    for name, s, e in dev:
        key = op_name(name)
        ops[key] = ops.get(key, 0.0) + (e - s) * 1e-6
    gaps, prev = [], t0
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        gaps.append((prev, t1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_READ]
    hs = np.array([s for _, s, _ in host]) if host else np.zeros(0)
    he = np.array([e for _, _, e in host]) if host else np.zeros(0)
    idle = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inside = np.nonzero((hs <= mid) & (he >= mid))[0]
        label = (host[int(inside[np.argmin(he[inside] - hs[inside])])][0]
                 if len(inside) else "(no host event)")
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    top = functools.partial(sorted, key=lambda kv: -kv[1])
    breakdown = {"device_ops": [[k, v] for k, v in top(ops.items())[:10]],
                 "idle_gaps": [[k, v] for k, v in top(idle.items())[:10]]}
    return dev, (t1 - t0) * 1e-6, busy * 1e-6, breakdown


def trace_frames(loop, n_frames, metric_mods, rec):
    """Profile `n_frames` more frames; fills rec["trace"] and
    rec["captures"]; returns (busy s, window s, breakdown)."""
    from torch.profiler import ProfilerActivity, profile
    calls, restore = _capture(metric_mods)
    loop.sync()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_frames):
                loop.step()
            loop.sync()
    finally:
        restore()
    events, window_s, busy_s, breakdown = read_profile(prof)
    rec["trace"] = {"frames": n_frames, "window_s": window_s,
                    "busy_s": busy_s, "events": events}
    rec["captures"] = {name: [metric_mods[name].bound_ms(a, kw, rec)
                              for a, kw in seen]
                       for name, seen in calls.items()}
    return busy_s, window_s, breakdown


# -- one run ----------------------------------------------------------------------
def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def checked_frames(seed: int) -> list:
    """The window frames (counted from the window's first) the check
    compares: CHECKED of the first CHECK_SPAN, drawn from the seed."""
    rng = np.random.default_rng([seed, 1])
    return sorted(int(k) for k in rng.choice(CHECK_SPAN, CHECKED,
                                             replace=False))


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", controls=()) -> dict:
    """Run the cell `spec` (cell_spec) once; returns the result object,
    with the numbers compared under "checks". With `controls` (modes of
    portbench.reference other than "ref") the control's readings of the
    same frames follow under "controls", for setting the limits."""
    from portbench import check
    config = spec["config"]
    # The seed starts the camera path at another frame: the same views in
    # another order.
    traffic = dict(spec["traffic"], phase=int(
        np.random.default_rng([seed, 2]).integers(PHASES)))
    cuda = torch.device(device).type == "cuda"
    desc = build_scene(config, seed)
    r, scene = build_program(config, desc, device)
    loop = FrameLoop(r, scene, config, traffic, device)

    for _ in range(traffic["warm"]["frames"]):
        _, ev = loop.step()
    loop.sync()
    setup_s = time.perf_counter() - t_start
    print(f"portbench: set-up {setup_s:.3f} s, {loop.n} warm frames",
          file=sys.stderr)

    # The measured window.
    sample = checked_frames(seed)
    stages = {}
    overflows, events, checked = [], [ev], []
    frames = 0
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds or frames <= sample[-1]:
        out, ev = loop.step()
        events.append(ev)
        for k, v in r.telemetry.last()["stages"].items():
            if k in TELEMETRY_STAGES:
                stages[k] = stages.get(k, 0.0) + v
        overflows.append(out["bin_overflow"])
        overflows.append(out["cluster_overflow"])
        if frames in sample:
            checked.append((loop.n - 1, snapshot(out)))
        frames += 1
    loop.sync()
    window_s = time.perf_counter() - w0
    print(f"portbench: window {frames} frames in {window_s:.3f} s",
          file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ovf = torch.stack([o.reshape(()) for o in overflows]).reshape(-1, 2)
    failed = int(((ovf > 0).any(dim=1)).sum())
    rec = {"resolution": tuple(config["settings"]["renderResolution"]),
           "frames": frames,
           "intervals_ms": [a.elapsed_time(b)
                            for a, b in zip(events, events[1:])],
           "stages_ms": stages}
    del overflows, events

    e2e = {"frame_ms": window_s * 1e3 / frames,
           "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    result = {"correct": None, "attempted": frames, "failed": failed,
              "metrics": {}, "device": {
                  "platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                  "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        metric_mods = {m["name"]: load_module("metrics", m["name"])
                       for m in spec["per_layer"]}
        busy_s, tw_s, breakdown = trace_frames(
            loop, traffic["trace_frames"], metric_mods, rec)
        result["device"].update(busy_s=busy_s, window_s=tw_s)
        result["breakdown"] = breakdown
        for m in spec["per_layer"]:
            v = metric_mods[m["name"]].read(rec)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            if m["name"] in e2e:
                result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                                "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded that the benchmark may not load: "
                           f"{found}")

    # The check, once the program's state is freed.
    checked = [(k, snapshot(o, "cpu")) for k, o in checked]
    del loop, r, scene, out
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = check.run(config, traffic, desc, checked, device)
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    if controls:
        result["controls"] = {mode: check.numbers(config, traffic, desc,
                                                  checked, device, mode)
                              for mode in controls}
    return result
