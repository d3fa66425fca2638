"""Voxel scene: build-time voxelization of resident geometry into a
world-space radiance + occupancy mip pyramid, consumed by cone marching
(ops/voxel_rt.py).

Port of basicrenderer_tpu/models/voxels.py, a host numpy copy: the same
sampling (seeded), bake, mip filter and packing, so the words equal the
JAX package's. Two reference subsystems meet in it: the VoxelGroupBuilder
(BasicRenderer/src/Mesh/VoxelGroupBuilder.cpp: voxelized cluster groups
with SGGX normal distributions, the LOD fallback where geometry is not
resident) and the CLodRayTracingSystem (CLodRayTracingSystem.h:16-75: the
acceleration structure over resident clusters, rebuilt on residency
change, traced for reflections). Here the structure is a dense mip
pyramid, rebuilt when lights or transforms change.

Radiance is baked at build time with the scene's directional lights, a
small ambient and emissive. Layout (device): ONE flat (Ncells,) u32 array,
levels concatenated fine to coarse; each cell packs premultiplied
radiance RGB (sqrt-encoded bytes, scaled by RADIANCE_SCALE) + coverage
alpha in RGBA8. The device copy is an int32 tensor holding the same bits
(scene/bridge.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

RADIANCE_SCALE = 8.0   # linear radiance at byte 255 (sqrt-encoded)


@dataclasses.dataclass
class VoxelSceneGrid:
    """Host-side build product. `meta` rides SceneBuffers (framedata)."""
    grid: np.ndarray            # (Ncells,) u32 packed RGBA8, all levels
    origin: np.ndarray          # (3,) f32 world min corner
    cell: float                 # level-0 cell size (cubic)
    n: int                      # level-0 edge resolution
    levels: int
    level_offsets: Tuple[int, ...]   # static flat offset per level
    # SGGX normal-distribution moments per cell (reference:
    # VoxelGroupBuilder's SGGX fit): S = E[n n^T], packed as TWO u32 per
    # cell interleaved [xx yy zz | xy xz yz] (diagonal bytes in [0,1],
    # off-diagonal offset-encoded from [-0.5, 0.5]). Projected area along
    # a ray is sqrt(w^T S w) — the anisotropic occlusion the cone trace
    # uses when FrameConfig.voxel_sggx is on. (2,) zeros when absent.
    sggx: np.ndarray = None

    def meta(self) -> np.ndarray:
        return np.array([*self.origin, self.cell, float(self.n),
                         float(self.levels), RADIANCE_SCALE, 0.0],
                        np.float32)


def static_level_offsets(n: int, levels: int = 5) -> Tuple[int, ...]:
    """Flat offset of each mip level in the packed grid — deterministic in
    (n, levels), so FrameConfig can carry it without seeing the build."""
    offs = []
    off = 0
    nl = n
    for _ in range(min(levels, int(np.log2(n)) + 1)):
        offs.append(off)
        off += nl ** 3
        if nl == 1:
            break
        nl //= 2
    return tuple(offs)


def _pack_rgba8(rgb: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Premultiplied radiance (sqrt-encoded) + alpha -> u32."""
    e = np.sqrt(np.clip(rgb / RADIANCE_SCALE, 0.0, 1.0))
    q = np.round(e * 255.0).astype(np.uint32)
    qa = np.round(np.clip(a, 0.0, 1.0) * 255.0).astype(np.uint32)
    return (q[..., 0] << 24) | (q[..., 1] << 16) | (q[..., 2] << 8) | qa


def _pack_sggx(m: np.ndarray) -> np.ndarray:
    """(N, 6) SGGX moments [xx yy zz xy xz yz] -> (N, 2) u32: word 0 holds
    the diagonal bytes ([0,1]), word 1 the off-diagonals offset-encoded
    from [-0.5, 0.5]."""
    d = np.round(np.clip(m[:, 0:3], 0.0, 1.0) * 255.0).astype(np.uint32)
    o = np.round((np.clip(m[:, 3:6], -0.5, 0.5) + 0.5) * 255.0) \
        .astype(np.uint32)
    w0 = (d[:, 0] << 16) | (d[:, 1] << 8) | d[:, 2]
    w1 = (o[:, 0] << 16) | (o[:, 1] << 8) | o[:, 2]
    return np.stack([w0, w1], axis=-1).astype(np.uint32)


def build_voxel_scene(positions: np.ndarray, indices: np.ndarray,
                      tri_material: np.ndarray, tri_object: np.ndarray,
                      object_mats: np.ndarray, material_table: np.ndarray,
                      lights: np.ndarray, num_dir_lights: int,
                      n: int = 64, levels: int = 5,
                      ambient: float = 0.03,
                      max_samples: int = 4_000_000,
                      bounds: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                      ) -> VoxelSceneGrid:
    """Voxelize world-space triangle soup (area-weighted surface sampling,
    the reference's ray-sampled occupancy made deterministic) and bake
    directional + ambient + emissive radiance per cell.

    positions/indices are the bridge's object-space packed arrays;
    tri_object selects each triangle's object matrix. Invalid rows
    (tri_object < 0) are skipped.
    """
    idx = np.asarray(indices)
    tobj = np.asarray(tri_object)
    live = tobj >= 0
    idx = idx[live]
    tmat = np.asarray(tri_material)[live]
    tobj = tobj[live]
    tri = np.asarray(positions)[idx]                       # (T, 3, 3) object
    m = np.asarray(object_mats)[tobj]                      # (T, 4, 4)
    tri = np.einsum("tij,tvj->tvi", m[:, :3, :3], tri) + m[:, None, :3, 3]

    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    nrm = np.cross(e1, e2)
    area2 = np.linalg.norm(nrm, axis=1)
    nok = area2 > 1e-20
    nrm = np.where(nok[:, None], nrm / np.maximum(area2, 1e-20)[:, None],
                   0.0)

    if bounds is None:
        lo = tri.reshape(-1, 3).min(0)
        hi = tri.reshape(-1, 3).max(0)
    else:
        lo, hi = np.asarray(bounds[0], np.float64), np.asarray(bounds[1],
                                                               np.float64)
    ext = float(np.max(hi - lo)) * 1.001 + 1e-6
    cell = ext / n
    origin = np.asarray(lo, np.float32)

    # Samples per triangle ~ area / (cell/2)^2, capped to the global budget.
    want = np.maximum(1, np.ceil((area2 * 0.5) / (0.5 * cell) ** 2))
    scale = min(1.0, max_samples / max(want.sum(), 1.0))
    cnt = np.maximum(1, np.floor(want * scale)).astype(np.int64)
    total = int(cnt.sum())
    tid = np.repeat(np.arange(len(cnt)), cnt)
    rng = np.random.default_rng(0)
    r1 = np.sqrt(rng.random(total))
    r2 = rng.random(total)
    a = 1.0 - r1
    b = r1 * (1.0 - r2)
    c = r1 * r2
    pts = (tri[tid, 0] * a[:, None] + tri[tid, 1] * b[:, None]
           + tri[tid, 2] * c[:, None])

    # Per-sample shaded radiance: albedo * (ambient + sum_dir N.L * I) +
    # emissive (material_table lanes: 0:3 base_color, 6:9 emissive).
    alb = material_table[np.clip(tmat, 0, len(material_table) - 1), 0:3]
    emi = material_table[np.clip(tmat, 0, len(material_table) - 1), 6:9]
    ndl = np.full(len(tmat), ambient, np.float64)
    shade = np.zeros((len(tmat), 3), np.float64)
    for li in range(num_dir_lights):
        row = lights[li]
        # LIGHT_STRIDE layout (bridge.snapshot_lights): 4:7 = direction
        # (pointing FROM the light), 7 = intensity, 8:11 = color.
        d = row[4:7] / max(np.linalg.norm(row[4:7]), 1e-9)
        nl = np.abs(nrm @ (-d))          # double-sided: thin geometry
        shade += nl[:, None] * row[8:11][None] * row[7]
    rad = alb * (ndl[:, None] + shade) + emi
    srad = rad[tid]

    g = np.clip(((pts - origin) / cell).astype(np.int64), 0, n - 1)
    flat = (g[:, 2] * n + g[:, 1]) * n + g[:, 0]
    ncell0 = n ** 3
    w = np.bincount(flat, minlength=ncell0).astype(np.float64)
    rgb0 = np.stack([np.bincount(flat, weights=srad[:, k], minlength=ncell0)
                     for k in range(3)], axis=-1)
    occ = w > 0
    rgb0 = np.where(occ[:, None], rgb0 / np.maximum(w, 1.0)[:, None], 0.0)
    a0 = occ.astype(np.float64)

    # SGGX second moments S = E[n n^T] per cell (reference:
    # VoxelGroupBuilder's per-voxel SGGX distributions). The moment matrix
    # filters LINEARLY, so mips just average it (the property SGGX was
    # designed for). Projected area along w is sqrt(w^T S w): a flat
    # surface viewed edge-on occludes ~nothing, a normal-on view fully.
    sn = nrm[tid]
    moms = np.stack([sn[:, 0] * sn[:, 0], sn[:, 1] * sn[:, 1],
                     sn[:, 2] * sn[:, 2], sn[:, 0] * sn[:, 1],
                     sn[:, 0] * sn[:, 2], sn[:, 1] * sn[:, 2]], axis=-1)
    m0 = np.stack([np.bincount(flat, weights=moms[:, k], minlength=ncell0)
                   for k in range(6)], axis=-1)
    m0 = np.where(occ[:, None], m0 / np.maximum(w, 1.0)[:, None], 0.0)

    # Mip pyramid: premultiplied averages (standard volume prefilter).
    levels = int(min(levels, int(np.log2(n)) + 1))
    prem = (rgb0 * a0[:, None]).reshape(n, n, n, 3)
    aa = a0.reshape(n, n, n)
    mm = (m0 * a0[:, None]).reshape(n, n, n, 6)   # premultiplied moments
    parts: List[np.ndarray] = []
    sparts: List[np.ndarray] = []
    offsets = []
    off = 0
    nl_ = n
    for _ in range(levels):
        al = aa.reshape(-1)
        pl = prem.reshape(-1, 3)
        rgb = np.where(al[:, None] > 1e-6, pl / np.maximum(al, 1e-6)[:, None],
                       0.0)
        packed = _pack_rgba8((rgb * np.maximum(al, 0.0)[:, None]), al)
        parts.append(packed.astype(np.uint32))
        ml = np.where(al[:, None] > 1e-6,
                      mm.reshape(-1, 6) / np.maximum(al, 1e-6)[:, None], 0.0)
        sparts.append(_pack_sggx(ml))
        offsets.append(off)
        off += nl_ ** 3
        if nl_ == 1:
            break
        prem = prem.reshape(nl_ // 2, 2, nl_ // 2, 2, nl_ // 2, 2, 3) \
            .mean(axis=(1, 3, 5))
        aa = aa.reshape(nl_ // 2, 2, nl_ // 2, 2, nl_ // 2, 2).mean(
            axis=(1, 3, 5))
        mm = mm.reshape(nl_ // 2, 2, nl_ // 2, 2, nl_ // 2, 2, 6) \
            .mean(axis=(1, 3, 5))
        nl_ //= 2

    grid = np.concatenate(parts)
    sggx = np.concatenate(sparts).reshape(-1)
    return VoxelSceneGrid(grid=grid, origin=origin, cell=float(cell), n=n,
                          levels=len(parts), level_offsets=tuple(offsets),
                          sggx=sggx)


def empty_voxel_scene(n: int = 1) -> VoxelSceneGrid:
    """Placeholder when the voxel tier is disabled (keeps SceneBuffers
    shapes static and tiny)."""
    return VoxelSceneGrid(grid=np.zeros(1, np.uint32),
                          origin=np.zeros(3, np.float32), cell=1.0, n=1,
                          levels=1, level_offsets=(0,),
                          sggx=np.zeros(2, np.uint32))
