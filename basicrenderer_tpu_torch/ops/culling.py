"""Culling: object frustum culling, the reverse-Z HZB and the HZB
occlusion test of the two-phase cluster occlusion.

Port of basicrenderer_tpu/ops/culling.py (`frustum_cull_spheres`,
`build_hzb`, `project_sphere_bounds`, `occlusion_test_hzb`,
`two_phase_object_cull`). Phase 1 of a frame tests cluster (or, on the
soup path, object) spheres against the previous frame's HZB; phase 2
re-tests the rejected ones against the HZB of phase 1's depth
(graph/frame.py). All fixed-shape, no host synchronisation.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..utils import math3d

HZB_FIRST_LEVEL = 1   # finest stored mip is 1/2 res (conservative)


def frustum_cull_spheres(viewproj: torch.Tensor, centers: torch.Tensor,
                         radii: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(N,) visibility mask for bounding spheres (world space)."""
    planes = math3d.frustum_planes(viewproj)
    return valid & math3d.sphere_in_frustum(planes, centers, radii)


def build_hzb(depth: torch.Tensor, levels: int = 8) -> List[torch.Tensor]:
    """Reverse-Z hierarchical depth pyramid: each level keeps the MIN
    (farthest) depth of its 2x2 block, so a sphere is occluded iff its
    nearest depth is below the block minimum. Returns `levels` mips
    starting at 1/2 resolution (odd edges drop their last row/column)."""
    mips = []
    d = depth
    for _ in range(levels):
        h, w = d.shape
        h2, w2 = max(h // 2, 1), max(w // 2, 1)
        if h >= 2 and w >= 2:
            rows = torch.amin(d[:h2 * 2].reshape(h2, 2, w), dim=1)
            d = torch.amin(rows[:, :w2 * 2].reshape(h2, w2, 2), dim=2)
        mips.append(d)
    return mips


def project_sphere_bounds(viewproj: torch.Tensor, centers: torch.Tensor,
                          radii: torch.Tensor, width: int, height: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Conservative screen-space AABB + nearest reverse-Z depth of spheres
    from the 8 corners of each sphere's world AABB. Returns (bbox (N, 4)
    f32 [x0, y0, x1, y1] pixels, z_near (N,) f32 NDC, behind (N,) bool)."""
    offs = torch.tensor([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                         for sz in (-1, 1)], dtype=torch.float32,
                        device=centers.device)                 # (8, 3)
    corners = centers[:, None, :] + radii[:, None, None] * offs[None]
    cx, cy, cz, w = math3d.mat4_columns(
        viewproj, corners[..., 0], corners[..., 1], corners[..., 2])
    behind = torch.any(w <= 1e-6, dim=-1)
    iw = 1.0 / torch.where(torch.abs(w) > 1e-9, w, 1.0)
    sx = (cx * iw * 0.5 + 0.5) * width
    sy = (0.5 - cy * iw * 0.5) * height
    z = cz * iw
    bbox = torch.stack([sx.amin(-1), sy.amin(-1), sx.amax(-1), sy.amax(-1)],
                       dim=-1)
    return bbox, z.amax(-1), behind


def occlusion_test_hzb(hzb_mips: List[torch.Tensor], bbox: torch.Tensor,
                       z_near: torch.Tensor, behind: torch.Tensor,
                       width: int, height: int) -> torch.Tensor:
    """(N,) bool: True = possibly visible. Picks the mip where the bbox
    spans at most 2x2 texels and compares the sphere's nearest depth with
    the farthest depth of those texels."""
    x0 = torch.clamp(bbox[:, 0], 0, width - 1)
    y0 = torch.clamp(bbox[:, 1], 0, height - 1)
    x1 = torch.clamp(bbox[:, 2], 0, width - 1)
    y1 = torch.clamp(bbox[:, 3], 0, height - 1)
    size = torch.maximum(x1 - x0, y1 - y0)
    num_mips = len(hzb_mips)
    mip = torch.clamp(torch.ceil(torch.log2(torch.clamp(size, min=1.0)))
                      .to(torch.int32) - HZB_FIRST_LEVEL, 0, num_mips - 1)
    # One flattened pyramid; each candidate selects its mip's (offset,
    # size, scale), then four gathers.
    flat = torch.cat([m.reshape(-1) for m in hzb_mips])
    off_m = torch.zeros_like(mip)
    wm_m = torch.zeros_like(mip)
    hm_m = torch.zeros_like(mip)
    sc_m = torch.zeros_like(x0)
    off = 0
    for m, hz in enumerate(hzb_mips):
        hm, wm = hz.shape
        sel = mip == m
        off_m = torch.where(sel, off, off_m)
        wm_m = torch.where(sel, wm, wm_m)
        hm_m = torch.where(sel, hm, hm_m)
        sc_m = torch.where(sel, 1.0 / (1 << (m + HZB_FIRST_LEVEL)), sc_m)
        off += hm * wm

    def texel(v, n):
        return torch.minimum(torch.clamp((v * sc_m).to(torch.int32), min=0),
                             n - 1)

    tx0, ty0 = texel(x0, wm_m), texel(y0, hm_m)
    tx1, ty1 = texel(x1, wm_m), texel(y1, hm_m)

    def at(ty, tx):
        return flat[(off_m + ty * wm_m + tx).long()]

    occluder_z = torch.minimum(torch.minimum(at(ty0, tx0), at(ty0, tx1)),
                               torch.minimum(at(ty1, tx0), at(ty1, tx1)))
    return (z_near >= occluder_z) | behind


def two_phase_object_cull(viewproj: torch.Tensor, centers: torch.Tensor,
                          radii: torch.Tensor, valid: torch.Tensor,
                          prev_hzb: Optional[List[torch.Tensor]],
                          width: int, height: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase-1 object cull: frustum + the previous frame's HZB. Returns
    (phase1_visible, candidates): the objects in the frustum that pass the
    HZB test, and those in the frustum that fail it (phase 2 re-tests
    them against the fresh HZB). Without a previous HZB every object in
    the frustum is visible and none is a candidate."""
    in_frustum = frustum_cull_spheres(viewproj, centers, radii, valid)
    if prev_hzb is None:
        return in_frustum, torch.zeros_like(in_frustum)
    bbox, z_near, behind = project_sphere_bounds(viewproj, centers, radii,
                                                 width, height)
    unoccluded = occlusion_test_hzb(prev_hzb, bbox, z_near, behind, width,
                                    height)
    return in_frustum & unoccluded, in_frustum & ~unoccluded
