#!/usr/bin/env python3
"""Times of checkouts of this repository, taken in turns on one card on
the same inputs, so that two versions can be compared inside one run.

    python3 tools/checkout_turns.py WORKLOAD [--scratch DIR] ROOT [ROOT ...]

Each ROOT is a checkout (at least its chip_smoke.py and
basicrenderer_tpu_torch/). For each ROOT in the order given, in a process
of its own (the checkouts' packages share a name), the script imports
ROOT's chip_smoke.py and package, which build ROOT's kernels into ROOT's
_build/ at first use, and times WORKLOAD:

- `soup`: chip_smoke.py's phase-6 frame (the soup courtyard from its own
  camera), its phase-14d frame (the same view with enable_shadows, the
  soup path's cascades; timed with phase 6's frame counts) and its
  phase-12 frame (the same courtyard with enable_occlusion, the low
  camera orbiting);
- `kernels`: first, in a process of its own, this script's checkout
  captures the inputs into DIR (default: a new temporary directory,
  outside any checkout): K4's launches of one `full` and one `full_bc3`
  frame (chip_smoke.py's phase 9: the dense LOD courtyard, the RGBA8
  bridge, then a second bridge with tex_format="bc3", each after
  SLICE3B_FRAMES frames along the orbit from the courtyard's camera; a
  frame launches K4 for the alpha-MASK pass and for the texture
  channels), the K1 accum launch of a full_oit frame with
  group_binning=False and no occlusion (phase 10's K1 variant, after its
  frames), phase 3's skewed K1 accum launch (one tile walking ~6,000 rows
  over half the tile, banded), phase 3's skewed K2 accum launch
  (group_rows 32, banded), K5's launch of the `full` frame (phase 8's
  TAA history warp), K6 on the first OIT layer of the full_oit K1
  variant's captured frame (phase 10's) and K6's tangent mode on the
  phase-1 layer of a soup frame with enable_occlusion and
  enable_vertex_tangents (phase 12's courtyard, low camera and orbit,
  after SOUP_OCC_TANGENT_FRAMES frames), with their plain versions'
  outputs. Each ROOT's K4 wrappers are then timed on the K4 launches and
  held to the plain outputs at the live pixels (a wrapper that takes the
  `live` mask gets it; an older one evaluates every pixel), its K1 and K2
  accum, K5 and K6 wrappers on theirs and held to them exactly, and
  ROOT's `full`, `full_bc3` and full_oit (K1 variant) frames are timed.
  Each launch is timed twice: by ROOT's chip_smoke.py `cuda_ms` (CUDA
  events around back-to-back launches, which read the host's pace where
  a launch is shorter than its wrapper's host time) and by this script's
  `device_ms` (the device time of the launches in a torch.profiler
  trace), one timer for every ROOT.

Frames are timed with chip_smoke.py's warm and timed frame counts (the
full_oit K1 variant with OIT_K1_FRAMES): the
host clock around each frame, which ends in a synchronise, and the stage
medians by CUDA events. The script prints the card's name and power limit,
one JSON line per ROOT and then `compare`'s lines for the first two ROOTs:
for each time, each checkout's runs, the difference of their means, and
"unresolved" when the difference is not larger than the spread, the range
of one checkout's runs (a frame's run is its median). Give the ROOTs in
turns, e.g. parent, change, change, parent, parent, change. Exits
non-zero without a CUDA device.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_REPS = 20
SKEW_GROUP_ROWS = 32
OIT_K1_FRAMES = (1, 4)     # full_oit with group_binning=False: warm, timed


def device_parts(torch, fn, reps):
    """{kernel name: mean device ms a call} of `fn()` over `reps` calls
    after a warm call, from a torch.profiler trace of the calls' CUDA
    kernels (and copies), as profile_frames reads them: each kernel's mean
    event duration times its launches a call. Late in a long process the
    trace loses a few device events (8 or 9 of a kernel's 10); a kernel's
    launches a call are its event count over `reps`, rounded, and a trace
    that lost half a call's worth of some kernel is taken again."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    counts = None
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                events.setdefault(e.name, []).append(
                    e.time_range.elapsed_us() / 1e3)
        counts = {k: len(v) for k, v in events.items()}
        per_call = {k: round(c / reps) for k, c in counts.items()}
        if events and all(n >= 1 and abs(counts[k] - n * reps) <= reps // 2
                          for k, n in per_call.items()):
            parts = {}
            for name, durations in events.items():
                m = re.search(r"::(\w+(?:<[^>(]*>)?)\(", name)
                key = m.group(1) if m else name[:60]
                parts[key] = parts.get(key, 0.0) + (
                    statistics.mean(durations) * per_call[name])
            return parts
    raise RuntimeError(f"torch.profiler lost device events in 5 traces "
                       f"of {reps} calls: {counts}")


def device_ms(torch, fn, reps):
    """Mean device ms of one `fn()` over `reps` calls: the device time of
    every kernel (and copy) a call launches, summed (device_parts)."""
    return sum(device_parts(torch, fn, reps).values())


def _import_root(root):
    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke as cs
    return cs


def _cpu(xs):
    return [x.detach().cpu() for x in xs]


def _full_buffers(np, torch, dev, cs, yard, fmt):
    """The courtyard's buffers with the procedural environment for
    bench.py's `full` (fmt "rgba8": the courtyard's own bridge; "bc3": a
    second bridge with tex_format="bc3"): (bridge, buffers)."""
    from basicrenderer_tpu_torch.models.environment import Environment
    from basicrenderer_tpu_torch.scene.bridge import SceneRenderBridge
    built, bridge = yard[0], yard[1]
    env = Environment.procedural(device=dev, use_cache=False)
    if fmt == "rgba8":
        buf = dataclasses.replace(
            yard[2], env_sh=torch.as_tensor(env.sh, device=dev),
            env_specular=torch.as_tensor(env.spec_mips, device=dev))
        return bridge, buf
    bridge_bc = SceneRenderBridge(built.scene, built.meshes, built.materials,
                                  bridge.caps, textures=bridge.textures,
                                  tex_format="bc3")
    return bridge_bc, bridge_bc.build_scene_buffers(
        env_sh=env.sh, env_specular=env.spec_mips, device=dev)


def _frames(np, torch, dev, cs, yard, capture_k4=False):
    """ROOT's `full`, `full_bc3` and full_oit (K1 variant) frames over the
    courtyard `yard`: {name: (frame ms, stage ms medians)}, and with
    `capture_k4` the K4 launches (name, args, kwargs, output) of one more
    frame of each format after its timed ones ("full" also K5's, as
    "full K5"), and the full_oit frame's K1 launches and bin_clustered
    calls."""
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn
    from basicrenderer_tpu_torch.graph.framedata import FrameConfig
    from basicrenderer_tpu_torch.graph.temporal import TemporalState
    from basicrenderer_tpu_torch.ops import taa_warp, textures
    built = yard[0]
    orbit = (built.scene.camera_matrices(aspect=16 / 9)[2].copy(),
             np.asarray(built.scene._camera_target, np.float64), 16 / 9)
    out, calls = {}, {}
    for fmt, name in (("rgba8", "full"), ("bc3", "full_bc3")):
        bridge, buf = _full_buffers(np, torch, dev, cs, yard, fmt)
        if fmt == "rgba8":
            yard[2] = None
        cfg = FrameConfig(**cs.CONFIG1_MINIMAL, **cs.FULL, tex_format=fmt)
        fr = build_frame_fn(cfg)
        temporal = TemporalState(cfg, device=dev)
        warm, timed = cs.SLICE3B_FRAMES
        _o, ms, _i, stages = cs.timed_frames(
            torch, np, fr, buf, built.scene, bridge, temporal, warm, timed,
            orbit)
        out[name] = (ms, stages)
        del _o
        if capture_k4:
            entry = ("tex_block_eval_bc3_cuda" if fmt == "bc3"
                     else "tex_block_eval_cuda")
            with cs.Capture(textures, [entry]) as tc, \
                    cs.Capture(taa_warp, ["warp_history_tiles"]) as wc:
                cs.timed_frames(torch, np, fr, buf, built.scene, bridge,
                                temporal, 1, 0, orbit, first=warm + timed)
            torch.cuda.synchronize()
            if len(tc.calls) != 2 or len(wc.calls) != 1:
                raise RuntimeError(f"{name}: captured {len(tc.calls)} K4 "
                                   f"and {len(wc.calls)} K5 launches, not 2 "
                                   "and 1")
            calls[name] = tc.calls
            calls[f"{name} K5"] = wc.calls
        del buf, fr, temporal
        torch.cuda.empty_cache()
    bridge_oit, buf_oit, _ = cs.oit_courtyard(np, torch, dev, yard)
    ocfg = dataclasses.replace(
        FrameConfig(**cs.CONFIG1_MINIMAL, **cs.FULL, **cs.FULL_OIT),
        group_binning=False, enable_occlusion=False, max_pairs=1 << 22)
    res = cs.oit_frames(np, torch, dev, (), built, bridge_oit, buf_oit,
                        ocfg, orbit, OIT_K1_FRAMES, "raster_tiles_cuda")
    out["full_oit_k1"] = (res[1], res[3])
    calls["full_oit_k1"] = res[7]
    calls["full_oit_k1 bins"] = res[9]
    return out, calls


def _soup_tangent_layer(np, torch, dev, cs):
    """K1's phase-1 launch (name, args, kwargs, output) of a soup frame
    with enable_occlusion and enable_vertex_tangents: chip_smoke.py's
    phase-12 courtyard, low camera and orbit, captured after
    SOUP_OCC_TANGENT_FRAMES frames."""
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn
    from basicrenderer_tpu_torch.graph.framedata import FrameConfig
    from basicrenderer_tpu_torch.graph.temporal import TemporalState
    from basicrenderer_tpu_torch.ops import raster
    sc, bridge, _ntris = cs.soup_courtyard(np)
    buf = bridge.build_scene_buffers(device=dev)
    sc.set_camera(aspect=16 / 9, **cs.SOUP_OCC_CAMERA)
    orbit = (np.asarray(cs.SOUP_OCC_CAMERA["position"], np.float64),
             np.asarray(cs.SOUP_OCC_CAMERA["target"], np.float64), 16 / 9)
    cfg = FrameConfig(width=1920, height=1080, tile_h=32, tile_w=128,
                      max_pairs=1 << 22, near_clip_tris=4096,
                      enable_occlusion=True, enable_vertex_tangents=True)
    fr = build_frame_fn(cfg)
    temporal = TemporalState(cfg, device=dev)
    warm, timed = cs.SOUP_OCC_TANGENT_FRAMES
    cs.timed_frames(torch, np, fr, buf, sc, bridge, temporal, warm, timed,
                    orbit, rate=cs.SOUP_OCC_RAD_PER_FRAME)
    with cs.Capture(raster, ["raster_tiles_cuda"]) as rc:
        cs.timed_frames(torch, np, fr, buf, sc, bridge, temporal, 1, 0, orbit,
                        first=warm + timed, rate=cs.SOUP_OCC_RAD_PER_FRAME)
    torch.cuda.synchronize()
    if len(rc.calls) != 2:
        raise RuntimeError(f"soup tangent frame: {len(rc.calls)} K1 "
                           "launches, not 2")
    return rc.calls[0]


def capture(scratch):
    """K4's launches of a `full` and a `full_bc3` frame, the K1 accum
    launch of a full_oit frame with group_binning=False, phase 3's skewed
    K1 and K2 accum launches, K5's launch of the `full` frame, K6 on the
    full_oit frame's first OIT layer and K6-tangent on a soup frame's
    phase-1 layer, by this checkout, with their plain outputs, into
    scratch/inputs.pt."""
    import numpy as np
    import torch
    cs = _import_root(REPO)
    from basicrenderer_tpu_torch.ops import (raster, raster_setup, resolve,
                                             taa_warp, textures)
    dev = torch.device("cuda", 0)
    yard = list(cs.courtyard(np, torch, dev))
    _times, calls = _frames(np, torch, dev, cs, yard, capture_k4=True)
    k4 = []
    for name in ("full", "full_bc3"):
        bc3 = name == "full_bc3"
        plain = (textures.tex_block_eval_bc3_plain if bc3
                 else textures.tex_block_eval_plain)
        for part, (_n, a, _kw, _o) in zip(("mask", "channels"), calls[name]):
            k4.append({"label": f"{name} {part}", "bc3": bc3,
                       "args": _cpu(a), "plain": plain(*a).cpu()})
    acc = [c for c in calls["full_oit_k1"]
           if c[1][-2] is not None and bool(c[1][-1])]
    if len(acc) != 1:
        raise RuntimeError(f"captured {len(acc)} K1 accum launches, not 1")
    pairs, acfg, row0, _init, peel, _ = acc[0][1]

    def trim(p):
        if isinstance(p, raster_setup.BinnedPairs):
            # The rows a launch can read: the big list and the tiles'
            # ranges (the capacity's tail is never read).
            keep = max(int(p.tile_offsets.max()), int(p.big_count), 1)
            p = p._replace(pair_data=p.pair_data[:keep].contiguous())
        return p

    def launch(p, c, r0, b, plain_fn):
        p = trim(p)
        return {"pairs": _cpu(p), "cfg": dataclasses.asdict(c),
                "tile_row0": int(r0), "peel": _cpu(b),
                "plain": _cpu(plain_fn(p, c, r0, None, b, True))}

    def resolve_launch(p, vis, c):
        p = trim(p)
        return {"pairs": _cpu(p), "vis": vis.cpu(),
                "cfg": dataclasses.asdict(c),
                "plain": resolve.resolve_attributes_plain(p, vis, c).cpu()}

    # K6 on the first OIT layer: its own pairs and vis (phase 10).
    oit_pairs = calls["full_oit_k1 bins"][-1][3]
    layer0 = [c for c in calls["full_oit_k1"] if c[1][0] is oit_pairs
              and c[1][-2] is not None and not bool(c[1][-1])][0]
    k6 = resolve_launch(layer0[1][0], layer0[3][1], layer0[1][1])
    _n, a5, _kw, _o = calls["full K5"][0]
    k5 = {"args": _cpu(a5[:3]) + list(a5[3:]),
          "plain": taa_warp.warp_history_plain(*a5).cpu()}
    acc_launch = launch(pairs, acfg, row0, peel, raster.raster_tiles_plain)
    del calls, _times, yard, acc, layer0, oit_pairs, pairs, peel, a5, _o
    torch.cuda.empty_cache()
    _n, a1, _kw, o1 = _soup_tangent_layer(np, torch, dev, cs)
    k6t = resolve_launch(a1[0], o1[1], a1[1])
    del a1, o1
    torch.cuda.empty_cache()
    k1s_pairs, k1s_cfg, k1s_band = cs.k1_skew_launch(torch, np, dev)
    k2s_pairs, k2s_cfg, k2s_band = cs.skew_launch(torch, np, dev,
                                                  SKEW_GROUP_ROWS)

    torch.save({
        "k4": k4,
        "k1_accum": acc_launch,
        "k1_accum_skew": launch(k1s_pairs, k1s_cfg, 0, k1s_band,
                                raster.raster_tiles_plain),
        "k2_accum_skew": launch(k2s_pairs, k2s_cfg, 0, k2s_band,
                                raster.raster_groups_plain),
        "k5": k5, "k6": k6, "k6_tangent": k6t,
    }, os.path.join(scratch, "inputs.pt"))
    return {"captured": os.path.join(scratch, "inputs.pt"),
            "k4_jobs": {d["label"]: int(d["args"][1].shape[0]) for d in k4},
            "k1_accum_pairs": int(acc_launch["pairs"][2]),
            "k1_skew_pairs": int(k1s_pairs.num_pairs),
            "k2_skew_pairs": int(k2s_pairs.num_pairs),
            "k6_pairs": int(k6["pairs"][2]),
            "k6_tangent_pairs": int(k6t["pairs"][2])}


def one_soup(cs, root, _scratch):
    """Both soup frames of checkout `root`; returns the JSON record."""
    import numpy as np
    import torch
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn
    from basicrenderer_tpu_torch.graph.framedata import FrameConfig
    from basicrenderer_tpu_torch.graph.temporal import TemporalState
    dev = torch.device("cuda", 0)
    sc, bridge, ntris = cs.soup_courtyard(np)
    buf = bridge.build_scene_buffers(device=dev)
    rec = {"root": root, "triangles": ntris}
    cfg = FrameConfig(width=1920, height=1080, tile_h=32, tile_w=128,
                      max_pairs=1 << 22, near_clip_tris=4096)
    runs = (("soup", cfg, cs.SLICE1_FRAMES, None, None),
            ("soup_shadows", dataclasses.replace(cfg, enable_shadows=True),
             cs.SLICE1_FRAMES, None, None),
            ("soup_occlusion", dataclasses.replace(cfg, enable_occlusion=True),
             cs.SOUP_OCC_FRAMES,
             (np.asarray(cs.SOUP_OCC_CAMERA["position"], np.float64),
              np.asarray(cs.SOUP_OCC_CAMERA["target"], np.float64), 16 / 9),
             cs.SOUP_OCC_RAD_PER_FRAME))
    for name, c, (warm, timed), orbit, rate in runs:
        if orbit is not None:
            sc.set_camera(aspect=16 / 9, **cs.SOUP_OCC_CAMERA)
        kw = {} if rate is None else {"rate": rate}
        _out, ms, _in, stages = cs.timed_frames(
            torch, np, build_frame_fn(c), buf, sc, bridge,
            TemporalState(c, device=dev), warm, timed, orbit, **kw)
        rec[name] = {"median_ms": statistics.median(ms), "frame_ms": ms,
                     "stage_ms": stages}
    return rec


def one_kernels(cs, root, scratch):
    """Root's K4, K1 accum, K2 accum, K5 and K6 wrappers on the saved
    inputs and root's `full`, `full_bc3` and full_oit (K1 variant) frames;
    returns the JSON record."""
    import inspect
    import numpy as np
    import torch
    from basicrenderer_tpu_torch.graph.framedata import FrameConfig
    from basicrenderer_tpu_torch.ops import (raster, raster_setup, resolve,
                                             taa_warp, textures)
    from basicrenderer_tpu_torch.utils import cuda_build
    dev = torch.device("cuda", 0)
    cuda_build.build_all([raster.SOURCE, textures.SOURCE, taa_warp.SOURCE,
                          resolve.SOURCE])
    saved = torch.load(os.path.join(scratch, "inputs.pt"), weights_only=False)
    rec = {"root": root}

    for d in saved["k4"]:
        fn = (textures.tex_block_eval_bc3_cuda if d["bc3"]
              else textures.tex_block_eval_cuda)
        args = tuple(x.to(dev) for x in d["args"])
        live = args[4].bool()
        if "live" not in inspect.signature(fn).parameters:
            args = args[:4]
        got = fn(*args)
        want = d["plain"].to(dev)
        if not torch.equal(got[live], want[live]):
            raise RuntimeError(f"{root}: K4 {d['label']} differs from plain "
                               "at live pixels")
        rec[f"k4 {d['label']} ms"] = cs.cuda_ms(torch, lambda: fn(*args),
                                               KERNEL_REPS)
        rec[f"k4 {d['label']} device ms"] = device_ms(
            torch, lambda: fn(*args), KERNEL_REPS)

    for key, kind in (("k1_accum", "K1"), ("k1_accum_skew", "K1"),
                      ("k2_accum_skew", "K2")):
        acc = saved[key]
        pt = (raster_setup.BinnedPairs if kind == "K1"
              else raster_setup.GroupBinnedPairs)
        fn = (raster.raster_tiles_cuda if kind == "K1"
              else raster.raster_groups_cuda)
        pairs = pt(*(x.to(dev) for x in acc["pairs"]))
        acfg = FrameConfig(**acc["cfg"])
        peel = tuple(x.to(dev) for x in acc["peel"])

        def run():
            return fn(pairs, acfg, acc["tile_row0"], None, peel, True)
        for g, w in zip(run(), acc["plain"]):
            if not torch.equal(g, w.to(dev)):
                raise RuntimeError(f"{root}: {kind} {key} differs from plain")
        rec[f"{key}_ms"] = cs.cuda_ms(torch, run, KERNEL_REPS)
        rec[f"{key}_device_ms"] = device_ms(torch, run, KERNEL_REPS)

    d = saved["k5"]
    a5 = tuple(x.to(dev) if torch.is_tensor(x) else x for x in d["args"])
    if not torch.equal(taa_warp.warp_history_tiles(*a5), d["plain"].to(dev)):
        raise RuntimeError(f"{root}: K5 differs from plain")
    rec["k5_ms"] = cs.cuda_ms(torch, lambda: taa_warp.warp_history_tiles(*a5),
                              KERNEL_REPS)
    rec["k5_device_ms"] = device_ms(
        torch, lambda: taa_warp.warp_history_tiles(*a5), KERNEL_REPS)
    for key in ("k6", "k6_tangent"):
        d = saved[key]
        pairs = raster_setup.BinnedPairs(*(x.to(dev) for x in d["pairs"]))
        vis, rcfg = d["vis"].to(dev), FrameConfig(**d["cfg"])

        def run():
            return resolve.resolve_attributes_cuda(pairs, vis, rcfg)
        if not torch.equal(run(), d["plain"].to(dev)):
            raise RuntimeError(f"{root}: {key} differs from plain")
        rec[f"{key}_ms"] = cs.cuda_ms(torch, run, KERNEL_REPS)
        rec[f"{key}_device_ms"] = device_ms(torch, run, KERNEL_REPS)
    del saved

    yard = list(cs.courtyard(np, torch, dev))
    times, _ = _frames(np, torch, dev, cs, yard)
    for name, (ms, stages) in times.items():
        rec[name] = {"median_ms": statistics.median(ms), "frame_ms": ms,
                     "stage_ms": stages}
    return rec


def _get(*keys):
    def get(rec):
        for k in keys:
            rec = rec[k]
        return rec
    return get


# WORKLOAD: (time of one ROOT, capture or None, compared metrics)
WORKLOADS = {
    "soup": (one_soup, None, (
        ("soup ms/frame", _get("soup", "median_ms")),
        ("soup setup stage ms", _get("soup", "stage_ms", "setup")),
        ("soup_shadows ms/frame", _get("soup_shadows", "median_ms")),
        ("soup_shadows setup stage ms", _get("soup_shadows", "stage_ms",
                                             "setup")),
        ("soup_shadows shadows stage ms", _get("soup_shadows", "stage_ms",
                                               "shadows")),
        ("soup_occlusion ms/frame", _get("soup_occlusion", "median_ms")))),
    "kernels": (one_kernels, capture, tuple(
        (f"K4 {fmt} {part} {unit}", _get(f"k4 {fmt} {part} {unit}"))
        for fmt in ("full", "full_bc3") for part in ("mask", "channels")
        for unit in ("ms", "device ms"))
        + tuple((f"{name} {unit} ({what})", _get(f"{key}_{suffix}"))
                for name, key, what in (
                    ("K1-accum", "k1_accum", "phase 10 K1-variant launch"),
                    ("K1-accum", "k1_accum_skew", "phase 3 skew launch"),
                    ("K2-accum", "k2_accum_skew", "phase 3 skew launch"),
                    ("K5", "k5", "a `full` frame's launch"),
                    ("K6", "k6", "phase 10's first OIT layer"),
                    ("K6-tangent", "k6_tangent", "a phase-12 soup layer"))
                for unit, suffix in (("ms", "ms"),
                                     ("device ms", "device_ms")))
        + (
           ("full ms/frame", _get("full", "median_ms")),
           ("full textures stage ms", _get("full", "stage_ms", "textures")),
           ("full mask stage ms", _get("full", "stage_ms", "mask")),
           ("full_bc3 ms/frame", _get("full_bc3", "median_ms")),
           ("full_bc3 textures stage ms", _get("full_bc3", "stage_ms",
                                               "textures")),
           ("full_bc3 mask stage ms", _get("full_bc3", "stage_ms", "mask")),
           ("full_oit (K1) ms/frame", _get("full_oit_k1", "median_ms")),
           ("full_oit (K1) oit_accum stage ms", _get("full_oit_k1",
                                                     "stage_ms",
                                                     "oit_accum")))),
}


def compare(recs, metrics):
    """Lines comparing the first two roots' runs, taken in turns. A
    metric's spread is the larger of the two checkouts' ranges over their
    runs; a difference of the means not larger than it is unresolved."""
    roots = []
    for r in recs:
        if r["root"] not in roots:
            roots.append(r["root"])
    if len(roots) < 2:
        return []
    lines = []
    for name, get in metrics:
        a, b = ([get(r) for r in recs if r["root"] == root]
                for root in roots[:2])
        diff = statistics.mean(b) - statistics.mean(a)
        spread = max(max(a) - min(a), max(b) - min(b))
        verdict = "unresolved" if abs(diff) <= spread else "resolved"
        lines.append(f"{name}: {roots[0]} {a} -> {roots[1]} {b}: difference "
                     f"{diff:+.4f} against a spread of {spread:.4f} "
                     f"({verdict})")
    return lines


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("checkout_turns: no CUDA device", file=sys.stderr)
        return 2
    if argv[:1] == ["--capture"]:
        print(json.dumps(capture(argv[1])), flush=True)
        return 0
    if argv[:1] == ["--one"]:
        workload, root, scratch = argv[1:4]
        root = os.path.abspath(root)
        rec = WORKLOADS[workload][0](_import_root(root), root, scratch)
        print(json.dumps(rec), flush=True)
        return 0
    if not argv or argv[0] not in WORKLOADS:
        print(__doc__, file=sys.stderr)
        return 2
    workload, argv = argv[0], argv[1:]
    scratch = None
    if argv[:1] == ["--scratch"]:
        scratch, argv = argv[1], argv[2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    _one, cap, metrics = WORKLOADS[workload]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    me = os.path.abspath(__file__)
    if cap is not None:
        scratch = scratch or tempfile.mkdtemp(prefix="checkout_turns_")
        os.makedirs(scratch, exist_ok=True)
        rc = subprocess.run([sys.executable, me, "--capture",
                             scratch]).returncode
        if rc != 0:
            return rc
    recs = []
    for root in argv:
        p = subprocess.run([sys.executable, me, "--one", workload, root,
                            scratch or ""], stdout=subprocess.PIPE, text=True)
        sys.stdout.write(p.stdout)
        sys.stdout.flush()
        if p.returncode != 0:
            return p.returncode
        recs.append(json.loads(p.stdout.strip().splitlines()[-1]))
    for line in compare(recs, metrics):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
