"""A tiny soup cell for the CPU tests: courtyard-soup-orbit's files, the
scene cut to a grid of 2 with coarse meshes, at 128x64."""

import json
import os

from portbench import harness


def tiny_spec(workload="courtyard-soup-orbit"):
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        spec = harness.cell_spec(json.load(f), workload)
    c = spec["config"]
    c["scene_params"].update(grid=2, terrain_size=8.0, terrain_segments=8,
                             sphere=[0.5, 8, 16], torus=[0.5, 0.2, 8, 6])
    c["settings"].update(renderResolution=[128, 64],
                         maxTrianglePairs=1 << 14)
    c["camera"]["position"] = [3.0, 6.0, 4.0]
    spec["traffic"]["warm"] = {"frames": 3}
    spec["traffic"]["trace_frames"] = 2
    return spec
