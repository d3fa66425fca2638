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
  camera) and its phase-12 frame (the same courtyard with
  enable_occlusion, the low camera orbiting);
- `kernels`: first, in a process of its own, this script's checkout
  captures the inputs into DIR (default: a new temporary directory,
  outside any checkout): the arguments of K3 in chip_smoke.py's phase-7
  frame (config1_minimal over the dense LOD courtyard, after its warm and
  timed frames), the K2 accum launch of its phase-10 frame (full_oit over
  the courtyard with a glass and an alpha-MASK material, along phase 10's
  orbit) and phase 3's skewed K2 accum launch (one tile walking ~6,000
  rows over half the tile, group_rows 32, banded), with their plain
  versions' outputs. Each ROOT's K3 and K2-accum wrappers are then timed
  on them by CUDA events and held to the plain outputs (K3 within
  chip_smoke.py's SHADE_RTOL / SHADE_ATOL, with its largest ulp distance;
  K2 accum exactly), and ROOT's config1_minimal (phase 7) and full_oit
  (phase 10) frames are timed.

Frames are timed with chip_smoke.py's warm and timed frame counts: the
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K3_REPS, ACCUM_REPS = 20, 20
SKEW_GROUP_ROWS = 32


def _import_root(root):
    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke as cs
    return cs


def _cpu(xs):
    return [x.detach().cpu() for x in xs]


def capture(scratch):
    """Phase 7's K3 arguments, phase 10's K2 accum launch and phase 3's
    skewed accum launch, by this checkout, with their plain outputs, into
    scratch/inputs.pt."""
    import numpy as np
    import torch
    cs = _import_root(REPO)
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn
    from basicrenderer_tpu_torch.graph.framedata import (FrameConfig,
                                                         FrameParams, make_view)
    from basicrenderer_tpu_torch.graph.temporal import TemporalState
    from basicrenderer_tpu_torch.ops import lighting, raster
    dev = torch.device("cuda", 0)
    yard = list(cs.courtyard(np, torch, dev))
    built, bridge, buf = yard[0], yard[1], yard[2]
    cfg = FrameConfig(**cs.CONFIG1_MINIMAL)
    fr = build_frame_fn(cfg)
    out, *_ = cs.timed_frames(torch, np, fr, buf, built.scene, bridge,
                              TemporalState(cfg, device=dev),
                              *cs.SLICE2_FRAMES)
    view = make_view(*built.scene.camera_matrices(aspect=16 / 9), device=dev)
    with cs.Capture(lighting, ["tiled_shade_cuda"]) as lc:
        fr(buf, view, FrameParams.default(dev),
           prev_depth=out["depth_padded"])
    torch.cuda.synchronize()
    k3_args = lc.calls[0][1]
    k3_plain = lighting.tiled_shade_plain(*k3_args)
    del out, fr, buf
    orbit = (built.scene.camera_matrices(aspect=16 / 9)[2].copy(),
             np.asarray(built.scene._camera_target, np.float64), 16 / 9)
    bridge_oit, buf_oit, _ = cs.oit_courtyard(np, torch, dev, yard)
    ocfg = FrameConfig(**cs.CONFIG1_MINIMAL, **cs.FULL, **cs.FULL_OIT)
    calls = cs.oit_frames(np, torch, dev, (), built, bridge_oit, buf_oit,
                          ocfg, orbit, cs.SLICE4_FRAMES,
                          "raster_groups_cuda")[7]
    acc = [c for c in calls if c[1][-2] is not None and bool(c[1][-1])]
    if len(acc) != 1:
        raise RuntimeError(f"captured {len(acc)} K2 accum launches, not 1")
    pairs, acfg, row0, _init, peel, _ = acc[0][1]
    spairs, scfg, band = cs.skew_launch(torch, np, dev, SKEW_GROUP_ROWS)

    def launch(p, c, r0, b):
        return {"pairs": _cpu(p), "cfg": dataclasses.asdict(c),
                "tile_row0": int(r0), "peel": _cpu(b),
                "plain": _cpu(raster.raster_groups_plain(p, c, r0, None, b,
                                                         True))}

    torch.save({
        "k3": {"args": _cpu(k3_args[:4]),
               "cfg": dataclasses.asdict(k3_args[4]),
               "plain": k3_plain.cpu()},
        "accum": launch(pairs, acfg, row0, peel),
        "accum_skew": launch(spairs, scfg, 0, band),
    }, os.path.join(scratch, "inputs.pt"))
    return {"captured": os.path.join(scratch, "inputs.pt"),
            "tile_lights": int(k3_args[2].long().sum()),
            "accum_pairs": int(pairs.num_pairs),
            "skew_pairs": int(spairs.num_pairs)}


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
    """Root's K3 and K2-accum on the saved inputs and root's config1 and
    full_oit frames; returns the JSON record."""
    import numpy as np
    import torch
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn
    from basicrenderer_tpu_torch.graph.framedata import FrameConfig
    from basicrenderer_tpu_torch.graph.temporal import TemporalState
    from basicrenderer_tpu_torch.ops import lighting, raster, raster_setup
    from basicrenderer_tpu_torch.utils import cuda_build
    dev = torch.device("cuda", 0)
    cuda_build.build_all([lighting.SOURCE, raster.SOURCE])
    saved = torch.load(os.path.join(scratch, "inputs.pt"), weights_only=False)
    rec = {"root": root}

    k3 = saved["k3"]
    a3 = tuple(x.to(dev) for x in k3["args"]) + (FrameConfig(**k3["cfg"]),)
    got = lighting.tiled_shade_cuda(*a3)
    want = k3["plain"].to(dev)
    torch.testing.assert_close(got, want, rtol=cs.SHADE_RTOL,
                               atol=cs.SHADE_ATOL)
    rec["k3_ms"] = cs.cuda_ms(torch, lambda: lighting.tiled_shade_cuda(*a3),
                              K3_REPS)
    rec["k3_max_abs_err"] = float((got - want).abs().max())
    rec["k3_max_ulp"] = cs.max_ulp(torch, got, want) \
        if hasattr(cs, "max_ulp") else None

    for key in ("accum", "accum_skew"):
        acc = saved[key]
        pairs = raster_setup.GroupBinnedPairs(*(x.to(dev)
                                                for x in acc["pairs"]))
        acfg = FrameConfig(**acc["cfg"])
        peel = tuple(x.to(dev) for x in acc["peel"])

        def run():
            return raster.raster_groups_cuda(pairs, acfg, acc["tile_row0"],
                                             None, peel, True)
        for g, w in zip(run(), acc["plain"]):
            if not torch.equal(g, w.to(dev)):
                raise RuntimeError(f"{root}: K2 {key} differs from plain")
        rec[f"k2_{key}_ms"] = cs.cuda_ms(torch, run, ACCUM_REPS)

    yard = list(cs.courtyard(np, torch, dev))
    built, bridge, buf = yard[0], yard[1], yard[2]
    cfg = FrameConfig(**cs.CONFIG1_MINIMAL)
    _o, ms, _i, stages = cs.timed_frames(
        torch, np, build_frame_fn(cfg), buf, built.scene, bridge,
        TemporalState(cfg, device=dev), *cs.SLICE2_FRAMES)
    rec["config1"] = {"median_ms": statistics.median(ms), "frame_ms": ms,
                      "tiled_shade_ms": stages.get("tiled_shade")}
    del _o, buf
    yard[2] = None
    orbit = (built.scene.camera_matrices(aspect=16 / 9)[2].copy(),
             np.asarray(built.scene._camera_target, np.float64), 16 / 9)
    bridge_oit, buf_oit, _ = cs.oit_courtyard(np, torch, dev, yard)
    ocfg = FrameConfig(**cs.CONFIG1_MINIMAL, **cs.FULL, **cs.FULL_OIT)
    res = cs.oit_frames(np, torch, dev, (), built, bridge_oit, buf_oit, ocfg,
                        orbit, cs.SLICE4_FRAMES, "raster_groups_cuda")
    ms, stages = res[1], res[3]
    rec["full_oit"] = {"median_ms": statistics.median(ms), "frame_ms": ms,
                       "tiled_shade_ms": stages.get("tiled_shade"),
                       "oit_accum_ms": stages.get("oit_accum")}
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
        ("soup_occlusion ms/frame", _get("soup_occlusion", "median_ms")))),
    "kernels": (one_kernels, capture, (
        ("K3 ms", _get("k3_ms")),
        ("K2-accum ms (phase 10 launch)", _get("k2_accum_ms")),
        ("K2-accum ms (phase 3 skew launch)", _get("k2_accum_skew_ms")),
        ("config1 ms/frame", _get("config1", "median_ms")),
        ("config1 tiled_shade stage ms", _get("config1", "tiled_shade_ms")),
        ("full_oit ms/frame", _get("full_oit", "median_ms")),
        ("full_oit tiled_shade stage ms", _get("full_oit",
                                               "tiled_shade_ms")),
        ("full_oit oit_accum stage ms", _get("full_oit", "oit_accum_ms")))),
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
