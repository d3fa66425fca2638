"""What decides `correct`: frames the timed path produced, against the
plain reference (portbench/reference/) rendering the same scene from the
same camera.

The frames compared are CHECKED window frames drawn from the seed
(harness.checked_frames). The reference builds the scene from the cell's
own inputs (scenes/*.build) and renders each of those frames from
nothing but the scene and the camera at that frame. A frame carries no
state into the next in the cells this check serves (no TAA, occlusion or
VSM), so each compared frame stands alone. Compared, each frame (the
worst frame counts):

- vis_pct: the share of pixels, in percent, whose visibility id differs
  (the triangle that wins the pixel, or none): the setup, binning, depth
  test and K1;
- image_pct: the share of pixels whose ids agree and whose 8-bit image
  differs by more than IMAGE_LEVELS in a channel: the G-buffer, GGX
  shading, sky, tonemap and sRGB.

`numbers(..., mode)` puts the reference in the program's place in
another precision (the control, reference/raster.py's "tf32"), for
setting the limits.
"""

from __future__ import annotations

import sys
import time

import torch

IMAGE_LEVELS = 2        # an 8-bit difference above this counts
# Each limit lies between the largest reading of sound runs and the
# smallest reading of the control (PERF.md, section 2).
LIMITS = {
    "vis_pct": 0.5,
    "image_pct": 0.037,
}


def compare(prog: dict, ref: dict) -> dict:
    """The numbers of one frame: `prog` the program's outputs, `ref` the
    reference's, on one device."""
    pv, rv = prog["vis"].long(), ref["vis"]
    # A piece of a triangle clipped at the camera plane has an id past
    # the scene's triangles; such a piece agrees with a piece.
    same = torch.where(pv > ref["triangles"], ref["piece"], pv == rv)
    di = (prog["image"].int() - ref["image"].int()).abs().amax(-1)
    pct = 100.0 / pv.numel()
    return {"vis_pct": pct * int((~same).sum()),
            "image_pct": pct * int((same & (di > IMAGE_LEVELS)).sum())}


def numbers(config, traffic, desc, checked, device, mode=None) -> dict:
    """{name: worst reading over the `checked` frames} ((frame index,
    outputs) on the CPU) against the reference, or, with `mode`, the
    reference in that mode in the program's place."""
    from portbench import harness
    from portbench.reference import Reference
    w, h = config["settings"]["renderResolution"]
    t0 = time.perf_counter()
    ref = Reference(desc, w, h, config["settings"], device)
    ctl = Reference(desc, w, h, config["settings"], device, mode) \
        if mode else None
    print(f"portbench: reference set-up {time.perf_counter() - t0:.3f} s",
          file=sys.stderr)
    cam = config["camera"]
    worst = {}
    for k, outs in checked:
        t0 = time.perf_counter()
        pos, target = harness.camera_pose(cam, traffic, k)
        want = ref.frame(pos, target, cam["fov_y"], cam["near"])
        got = ctl.frame(pos, target, cam["fov_y"], cam["near"]) if ctl \
            else {name: v.to(device) for name, v in outs.items()}
        for name, v in compare(got, want).items():
            worst[name] = max(worst.get(name, v), v)
        del want, got
        print(f"portbench: reference frame {k} "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    return worst


def run(config, traffic, desc, checked, device) -> dict:
    """{name: {"value", "limit"}} for the `checked` frames."""
    got = numbers(config, traffic, desc, checked, device)
    return {name: {"value": got[name], "limit": limit}
            for name, limit in LIMITS.items()}
