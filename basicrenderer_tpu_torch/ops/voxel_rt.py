"""Voxel cone marching: the ray-traced fallback tier over the scene voxel
grid.

Port of basicrenderer_tpu/ops/voxel_rt.py (reference:
rayTracedReflections.rt.hlsl over CLodRayTracingSystem's cluster BLAS,
CLodRayTracingSystem.h:16-75, and the voxel LOD fallback raster,
VoxelGroupBuilder.cpp + voxelSoftwareRaster.hlsl). The JAX package traces
the models/voxels.py mip pyramid with a fixed-count cone march whose
level follows the cone's radius; its `fori_loop` is a Python loop over
the static step count here, each step one gather of the grid (two more
with SGGX). The grid and SGGX words are u32 in the JAX package and int32
tensors holding the same bits here; the byte extraction masks after the
shift, so the sign of the int32 never shows. The JAX package computes all
of this in XLA: there is no TPU kernel to port, and the port runs it as
tensor operations on the device of its inputs.

Inputs and outputs are planar columns (px, py, pz, ...), one shape for
every ray array.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.voxels import RADIANCE_SCALE
from ..utils import math3d
from .shade import _inverse, _iota
from .shadows import downsample2d
from .textures import resize_bilinear

LOG2E = 1.4426950408889634


def _byte(w: torch.Tensor, shift: int) -> torch.Tensor:
    """Byte `shift // 8` of the u32 words `w` (int32 bits), in [0, 1]."""
    return ((w >> shift) & 0xFF).to(torch.float32) * (1.0 / 255.0)


def cone_trace(grid: torch.Tensor, origin: torch.Tensor, cell: torch.Tensor,
               n: int, level_offsets: Tuple[int, ...],
               px, py, pz, dx, dy, dz,
               steps: int = 12, start_t=None, growth: float = 1.35,
               cone_tan: float = 0.12, sggx: torch.Tensor = None,
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """March cones from (px, py, pz) along (dx, dy, dz) through the packed
    RGBA8 mip pyramid. Returns the planar accumulated radiance (r, g, b)
    and the transmittance T (1 = clear miss).

    `n` / `level_offsets` are the grid's static build constants; `origin`
    and `cell` are tensors. `sggx` (models/voxels._pack_sggx layout): per
    cell normal second moments; occlusion scales by the projected area
    sqrt(w^T S w) along the ray (two more gathers a step)."""
    levels = len(level_offsets)
    shape = px.shape
    dev = px.device
    acc_r = torch.zeros(shape, dtype=torch.float32, device=dev)
    acc_g = torch.zeros_like(acc_r)
    acc_b = torch.zeros_like(acc_r)
    trans = torch.ones_like(acc_r)
    t0 = (2.0 * cell) if start_t is None else start_t
    t = torch.broadcast_to(torch.as_tensor(t0, dtype=torch.float32,
                                           device=dev), shape)
    inv_cell = 1.0 / cell
    N = grid.shape[0]
    for _ in range(steps):
        wx = px + dx * t
        wy = py + dy * t
        wz = pz + dz * t
        radius = torch.maximum(cone_tan * t, cell)
        lvl = torch.clamp((torch.log(radius * inv_cell) * LOG2E + 0.5)
                          .to(torch.int32), 0, levels - 1)
        sel = torch.exp2(lvl.to(torch.float32))
        nl = n / sel
        gx = torch.floor((wx - origin[0]) * inv_cell / sel)
        gy = torch.floor((wy - origin[1]) * inv_cell / sel)
        gz = torch.floor((wz - origin[2]) * inv_cell / sel)
        inside = ((gx >= 0) & (gx < nl) & (gy >= 0) & (gy < nl)
                  & (gz >= 0) & (gz < nl))

        def clip(g):
            return torch.minimum(torch.clamp(g, min=0.0), nl - 1).to(
                torch.int32)
        gxi, gyi, gzi = clip(gx), clip(gy), clip(gz)
        nli = nl.to(torch.int32)
        # Per-level flat offset: a select chain over the static table.
        off = torch.zeros(shape, dtype=torch.int32, device=dev)
        for li in range(levels):
            off = torch.where(lvl == li, level_offsets[li], off)
        flat = (off + (gzi * nli + gyi) * nli + gxi).long()
        w = grid[torch.clamp(flat, 0, N - 1)]
        r8, g8, b8 = _byte(w, 24), _byte(w, 16), _byte(w, 8)
        a = torch.where(inside, _byte(w, 0), 0.0)
        if sggx is not None:
            # Anisotropic projected-area modulation: sigma(w) =
            # sqrt(w^T S w); isotropic-equivalent scaling 2*sigma (a
            # uniform normal sphere has E|cos| = 1/2), capped at 1.
            S = sggx.shape[0]
            w0 = sggx[torch.clamp(flat * 2, 0, S - 1)]
            w1 = sggx[torch.clamp(flat * 2 + 1, 0, S - 1)]
            sxx, syy, szz = _byte(w0, 16), _byte(w0, 8), _byte(w0, 0)
            sxy = _byte(w1, 16) - 0.5
            sxz = _byte(w1, 8) - 0.5
            syz = _byte(w1, 0) - 0.5
            q = (sxx * dx * dx + syy * dy * dy + szz * dz * dz
                 + 2.0 * (sxy * dx * dy + sxz * dx * dz + syz * dy * dz))
            sigma = torch.sqrt(torch.clamp(q, min=0.0))
            a = a * torch.clamp(2.0 * sigma, max=1.0)
        # sqrt-encoded premultiplied radiance (models/voxels._pack_rgba8)
        live = inside & (trans > 1e-3)
        gate = torch.where(live, trans, 0.0)
        acc_r = acc_r + gate * (r8 * r8 * RADIANCE_SCALE)
        acc_g = acc_g + gate * (g8 * g8 * RADIANCE_SCALE)
        acc_b = acc_b + gate * (b8 * b8 * RADIANCE_SCALE)
        trans = trans * (1.0 - torch.where(live, a, 0.0))
        t = t * growth + 0.35 * cell
    return acc_r, acc_g, acc_b, trans


def _unproject_ds(depth, view, ds, row0, full_h, W):
    """Downsampled receiver depth and world positions, planar columns
    (the ops/ssr.py receiver pattern)."""
    d = downsample2d(depth, ds)
    h, w = d.shape
    dev = d.device
    sx = _iota(w, 1, (h, w), dev) * ds + 0.5
    sy = _iota(h, 0, (h, w), dev) * ds + 0.5 + row0
    ndc_x = sx / W * 2.0 - 1.0
    ndc_y = 1.0 - sy / full_h * 2.0
    inv_vp = _inverse(view.viewproj)
    px, py, pz, pw = math3d.mat4_columns(inv_vp, ndc_x, ndc_y, d)
    iw = 1.0 / torch.where(torch.abs(pw) > 1e-12, pw, 1.0)
    return d, px * iw, py * iw, pz * iw


def _sggx(scene, config):
    return scene.voxel_sggx if config.voxel_sggx else None


def _upsample(col, tr, ds, H, W, upsample=None):
    if ds > 1:
        up = upsample or resize_bilinear
        col, tr = up(col, H, W), up(tr, H, W)
    return col, tr


def voxel_reflections(scene, depth, normal, view, config, row0=0,
                      full_h=None):
    """Off-screen reflection fallback: cone-trace the voxel grid along the
    reflected view ray at config.voxel_rt_downscale. Returns (col (H, W,
    3), trans (H, W)): the traced radiance, and how much of the
    prefiltered environment still passes (1 = clean miss)."""
    H, W = depth.shape
    full_h = full_h or H
    ds = config.voxel_rt_downscale
    d, px, py, pz = _unproject_ds(depth, view, ds, row0, full_h, W)
    nx = downsample2d(normal[..., 0], ds)
    ny = downsample2d(normal[..., 1], ds)
    nz = downsample2d(normal[..., 2], ds)
    vx = px - view.cam_pos[0]
    vy = py - view.cam_pos[1]
    vz = pz - view.cam_pos[2]
    il = 1.0 / torch.clamp(torch.sqrt(vx * vx + vy * vy + vz * vz), min=1e-6)
    vx, vy, vz = vx * il, vy * il, vz * il
    vdotn = vx * nx + vy * ny + vz * nz
    rx = vx - 2.0 * vdotn * nx
    ry = vy - 2.0 * vdotn * ny
    rz = vz - 2.0 * vdotn * nz
    meta = scene.voxel_meta
    origin, cell = meta[0:3], meta[3]
    # Start off the surface along the normal so the receiver's own cell
    # does not occlude the ray.
    bias = 1.75 * cell
    cr, cg, cb, tr = cone_trace(
        scene.voxel_grid, origin, cell, config.voxel_n,
        config.voxel_level_offsets,
        px + nx * bias, py + ny * bias, pz + nz * bias, rx, ry, rz,
        steps=config.voxel_rt_steps, growth=1.32, cone_tan=0.14,
        sggx=_sggx(scene, config))
    live = d > 0
    tr = torch.where(live, tr, 1.0)
    col = torch.stack([torch.where(live, cr, 0.0), torch.where(live, cg, 0.0),
                       torch.where(live, cb, 0.0)], dim=-1)
    return _upsample(col, tr, ds, H, W)


def voxel_primary(scene, view, config, H, W, row0=0, full_h=None,
                  upsample=None):
    """Primary-visibility fallback: camera rays march the grid at
    config.voxel_rt_downscale (the frame takes it where the cut or the
    streaming residency left pixels uncovered); rows row0.. of a frame
    full_h tall. Returns (col (H, W, 3), trans (H, W)) at full size,
    resized bilinearly (by `upsample(img, H, W)` when given: a shard's
    seam-exact resize, graph/frame.halo_upsample)."""
    full_h = full_h or H
    ds = config.voxel_rt_downscale
    h, w = H // ds, W // ds
    dev = view.viewproj.device
    sx = _iota(w, 1, (h, w), dev) * ds + 0.5
    sy = _iota(h, 0, (h, w), dev) * ds + 0.5 + row0
    ndc_x = sx / W * 2.0 - 1.0
    ndc_y = 1.0 - sy / full_h * 2.0
    inv_vp = _inverse(view.viewproj)
    # A FINITE point along each pixel ray: under infinite reverse-Z the
    # far plane (z_ndc = 0) has w = 0, so unproject z_ndc = 0.1 (view
    # depth = 10x near) and take the direction from the camera.
    px, py, pz, pw = math3d.mat4_columns(
        inv_vp, ndc_x, ndc_y, torch.full((h, w), 0.1, dtype=torch.float32,
                                         device=dev))
    iw = 1.0 / torch.where(torch.abs(pw) > 1e-12, pw, 1.0)
    dx = px * iw - view.cam_pos[0]
    dy = py * iw - view.cam_pos[1]
    dz = pz * iw - view.cam_pos[2]
    il = 1.0 / torch.clamp(torch.sqrt(dx * dx + dy * dy + dz * dz), min=1e-9)
    dx, dy, dz = dx * il, dy * il, dz * il
    meta = scene.voxel_meta
    origin, cell = meta[0:3], meta[3]
    ox = view.cam_pos[0].expand(h, w)
    oy = view.cam_pos[1].expand(h, w)
    oz = view.cam_pos[2].expand(h, w)
    cr, cg, cb, tr = cone_trace(
        scene.voxel_grid, origin, cell, config.voxel_n,
        config.voxel_level_offsets, ox, oy, oz, dx, dy, dz,
        steps=config.voxel_primary_steps, growth=1.22, cone_tan=0.004,
        sggx=_sggx(scene, config))
    return _upsample(torch.stack([cr, cg, cb], dim=-1), tr, ds, H, W,
                     upsample)
