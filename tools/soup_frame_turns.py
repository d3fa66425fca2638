#!/usr/bin/env python3
"""Soup-frame times of checkouts of this repository, taken in turns on one
card, so that two versions can be compared inside one run.

    python3 tools/soup_frame_turns.py ROOT [ROOT ...]

Each ROOT is a checkout (at least its chip_smoke.py and
basicrenderer_tpu_torch/). For each ROOT in the order given, in a process
of its own (the checkouts' packages share a name), the script imports
ROOT's chip_smoke.py and package, which build ROOT's kernels into ROOT's
_build/ at first use, and times chip_smoke.py's phase-6 frame (the soup
courtyard from its own camera) and then its phase-12 frame (the same
courtyard with enable_occlusion, the low camera orbiting) through
graph/temporal.py, with chip_smoke.py's warm and timed frame counts: the
host clock around each frame, which ends in a synchronise, and the stage
medians by CUDA events. It prints one JSON line per ROOT and exits
non-zero without a CUDA device. Give the ROOTs in turns, e.g. parent,
change, change, parent.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys


def one(root):
    """Time both frames of checkout `root` in this process; returns the
    JSON record."""
    import numpy as np
    import torch
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import chip_smoke as cs
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


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("soup_frame_turns: no CUDA device", file=sys.stderr)
        return 2
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    for root in argv:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", root]).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
