"""Triangle-accurate ray-traced reflections over the resident cluster cut.

Port of basicrenderer_tpu/ops/rt_reflect.py (reference:
CLodRayTracingSystem.h:16-75 + rayTracedReflections.rt.hlsl: CLAS/BLAS/
TLAS over the resident clusters). The two-level structure is the JAX
package's, every stage a fixed-shape tensor pass:

1. BUILD (per frame): sort the compacted cut's slot spheres by Morton code
   (a stable sort, as the JAX package's `lax.sort`), chunk them into
   N_NODES contiguous nodes and take each node's AABB.
2. Level 1: every ray slab-tests all N_NODES AABBs and visits the nearest
   `rt_nodes_per_ray` entries (argmin takes the first index on ties, as
   `jnp.argmin` does).
3. Level 2: the node's slot spheres; each ray picks its `rt_candidates`
   nearest sphere entries.
4. INTERSECT: per candidate, the slot's quantized corner page, dequant
   row, model matrix and material are fetched and a Möller-Trumbore pass
   tests all 128 triangles as (R, 128) column math.

The JAX package fetches rows by one-hot matmuls and carries each slot's
page as f32 bit patterns in one combined row; here the fetches are index
gathers and the page stays int32 bits beside an f32 row of the rest.
Both fetch the same values while those are finite (the spheres, pages
and matrices of a cut are). Hits shade with the cluster material's
albedo x (primary directional N.L + SH ambient irradiance); misses fall
through to the voxel cone tier and the prefiltered environment. The JAX
package computes all of this in XLA: there is no TPU kernel to port, and
the port runs it as tensor operations on the device of its inputs.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..graph.framedata import FrameConfig, SceneBuffers, ViewData
from ..models.clusters import MESHLET_TRIS, SLAB_VERTS
from . import clod as clod_ops
from . import ibl as ibl_ops
from .shadows import downsample2d
from .textures import resize_bilinear
from .voxel_rt import _unproject_ds

N_NODES = 64
META_LANES = 32   # [dequant 8 | model matrix 16 | mat id, tri count,
#                    sphere xyzr, pad 2]


def _morton10(x: torch.Tensor) -> torch.Tensor:
    """(N,) ints in [0, 1024) -> bits spread 3 apart."""
    x = x.to(torch.int64)
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def build_slot_bvh(scene: SceneBuffers, comp, n_nodes: int = N_NODES):
    """Two-level BVH over the compacted cut. Returns (node_lo (n, 3),
    node_hi (n, 3), order (Kc,) slot ids in Morton order, cw (Kc, 3),
    rw (Kc,)): `order` reshaped (n, Kc/n) is the node -> slots table;
    dead slots sort last and carry empty AABBs."""
    cw, rw = clod_ops.slot_world_spheres(comp, scene)
    live = comp.slot_cluster >= 0
    Kc = cw.shape[0]
    inf = float("inf")
    lo = torch.where(live[:, None], cw - rw[:, None], inf).amin(dim=0)
    hi = torch.where(live[:, None], cw + rw[:, None], -inf).amax(dim=0)
    ext = torch.clamp(hi - lo, min=1e-6)
    q = torch.clamp((cw - lo) / ext * 1023.0, 0, 1023).to(torch.int32)
    code = (_morton10(q[:, 0]) | (_morton10(q[:, 1]) << 1)
            | (_morton10(q[:, 2]) << 2))
    key = torch.where(live, code, 2 ** 30)
    order = torch.sort(key, stable=True).indices
    k = Kc // n_nodes
    cw_s = cw[order].reshape(n_nodes, k, 3)
    rw_s = rw[order].reshape(n_nodes, k)
    live_s = live[order].reshape(n_nodes, k)
    node_lo = torch.where(live_s[..., None], cw_s - rw_s[..., None],
                          inf).amin(dim=1)
    node_hi = torch.where(live_s[..., None], cw_s + rw_s[..., None],
                          -inf).amax(dim=1)
    return node_lo, node_hi, order, cw, rw


def _combined_rows(scene: SceneBuffers, comp, order: torch.Tensor,
                   cw: torch.Tensor, rw: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot rows in Morton order: (pages (Kc, SLAB*3) int32 bits, meta
    (Kc, META_LANES) f32 [dequant | model matrix | mat id, tri count,
    sphere xyzr, pad])."""
    G = scene.geom_slot.shape[0]
    slots = scene.geom_slot[torch.clamp(comp.geom, 0, G - 1).long()]
    gids = torch.clamp(slots, 0, scene.cluster_verts.shape[0] - 1).long()
    O = scene.object_mats.shape[0]
    m16 = scene.object_mats.reshape(O, 16)[comp.slot_object.long()]
    C = scene.cluster_table.shape[0]
    crow = scene.cluster_table[torch.clamp(comp.slot_cluster, 0, C - 1)
                               .long()]
    zero = torch.zeros_like(rw)
    meta = torch.cat([
        scene.cluster_dequant[gids], m16,
        torch.stack([crow[:, 9],
                     torch.where(comp.slot_cluster >= 0, crow[:, 8], 0.0),
                     cw[:, 0], cw[:, 1], cw[:, 2], rw, zero, zero], dim=1)],
        dim=1)
    return scene.cluster_verts[gids][order], meta[order]


def trace_reflections(scene: SceneBuffers, comp, depth: torch.Tensor,
                      normal: torch.Tensor, view: ViewData,
                      config: FrameConfig, row0: int = 0, full_h: int = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (col (H, W, 3), hit (H, W) in [0, 1]) at full size:
    triangle-accurate reflection radiance where the reflected ray (one per
    config.rt_downscale block) hit the resident cut; hit 0 falls through
    to the voxel and environment tiers."""
    H, W = depth.shape
    full_h = full_h or H
    ds = config.rt_downscale
    d, px, py, pz = _unproject_ds(depth, view, ds, row0, full_h, W)
    nx = downsample2d(normal[..., 0], ds)
    ny = downsample2d(normal[..., 1], ds)
    nz = downsample2d(normal[..., 2], ds)
    vx, vy, vz = (px - view.cam_pos[0], py - view.cam_pos[1],
                  pz - view.cam_pos[2])
    il = torch.rsqrt(torch.clamp(vx * vx + vy * vy + vz * vz, min=1e-12))
    vx, vy, vz = vx * il, vy * il, vz * il
    vdn = vx * nx + vy * ny + vz * nz
    dx, dy, dz = vx - 2 * vdn * nx, vy - 2 * vdn * ny, vz - 2 * vdn * nz
    h, w = d.shape
    R = h * w
    dev = d.device
    covered = (d > 0.0).reshape(R)

    # Self-intersection guard: start just off the surface along the normal.
    eps = config.rt_ray_eps
    ox = (px + nx * eps).reshape(R)
    oy = (py + ny * eps).reshape(R)
    oz = (pz + nz * eps).reshape(R)
    dx, dy, dz = dx.reshape(R), dy.reshape(R), dz.reshape(R)

    def inv(v):
        return 1.0 / torch.where(torch.abs(v) > 1e-8, v, 1e-8)
    inv_dx, inv_dy, inv_dz = inv(dx), inv(dy), inv(dz)

    node_lo, node_hi, order, cw, rw = build_slot_bvh(scene, comp)
    pages, meta = _combined_rows(scene, comp, order, cw, rw)
    Kc = order.shape[0]
    k = Kc // N_NODES
    # Node-major sphere table [cx*k | cy*k | cz*k | r*k].
    cw_s = cw[order].reshape(N_NODES, k, 3)
    rw_s = rw[order].reshape(N_NODES, k)
    sph_tab = torch.cat([cw_s[..., 0], cw_s[..., 1], cw_s[..., 2], rw_s],
                        dim=1)                                # (64, 4k)

    # ---- Level 1: ray vs all node AABBs (R, 64) ---------------------------
    def slab(lo_c, hi_c, o, inv_d):
        t0 = (lo_c[None, :] - o[:, None]) * inv_d[:, None]
        t1 = (hi_c[None, :] - o[:, None]) * inv_d[:, None]
        return torch.minimum(t0, t1), torch.maximum(t0, t1)
    ax0, ax1 = slab(node_lo[:, 0], node_hi[:, 0], ox, inv_dx)
    ay0, ay1 = slab(node_lo[:, 1], node_hi[:, 1], oy, inv_dy)
    az0, az1 = slab(node_lo[:, 2], node_hi[:, 2], oz, inv_dz)
    tmin = torch.maximum(torch.maximum(ax0, ay0), az0)
    tmax = torch.minimum(torch.minimum(ax1, ay1), az1)
    t_lo = torch.clamp(tmin, min=0.0)
    inf = float("inf")
    te = torch.where(tmax >= t_lo, t_lo, inf)                 # (R, 64)

    best_t = torch.full((R,), inf, dtype=torch.float32, device=dev)
    best_nx = torch.zeros((R,), dtype=torch.float32, device=dev)
    best_ny = torch.zeros_like(best_nx)
    best_nz = torch.zeros_like(best_nx)
    best_mat = torch.zeros((R,), dtype=torch.int32, device=dev)

    for _node_rank in range(config.rt_nodes_per_ray):
        te_min, nsel = torch.min(te, dim=1)
        nhit = torch.isfinite(te_min)
        te = te.scatter(1, nsel[:, None], inf)                # mask out

        # ---- Level 2: the node's k slot spheres -------------------------
        srow = sph_tab[nsel]                                  # (R, 4k)
        lx = srow[:, 0:k] - ox[:, None]
        ly = srow[:, k:2 * k] - oy[:, None]
        lz = srow[:, 2 * k:3 * k] - oz[:, None]
        sr = srow[:, 3 * k:]
        tca = lx * dx[:, None] + ly * dy[:, None] + lz * dz[:, None]
        d2 = lx * lx + ly * ly + lz * lz - tca * tca
        thc2 = sr * sr - d2
        thc = torch.sqrt(torch.clamp(thc2, min=0.0))
        ts = torch.where((thc2 >= 0) & (tca + thc > 0.0),
                         torch.clamp(tca - thc, min=0.0), inf)
        ts = torch.where(nhit[:, None], ts, inf)

        for _cand in range(config.rt_candidates):
            ts_min, csel = torch.min(ts, dim=1)
            chit = torch.isfinite(ts_min)
            ts = ts.scatter(1, csel[:, None], inf)
            rowid = torch.where(chit, nsel * k + csel, 0)     # Morton slot
            t, gnx, gny, gnz, hit = _intersect_cluster(
                pages[rowid], meta[rowid], ox, oy, oz, dx, dy, dz, eps)
            better = hit & chit & (t < best_t)
            best_t = torch.where(better, t, best_t)
            best_nx = torch.where(better, gnx, best_nx)
            best_ny = torch.where(better, gny, best_ny)
            best_nz = torch.where(better, gnz, best_nz)
            best_mat = torch.where(better,
                                   torch.round(meta[rowid, 24])
                                   .to(torch.int32), best_mat)

    hit_mask = torch.isfinite(best_t) & covered

    # ---- Shade hits: albedo x (dir light N.L + SH ambient) ----------------
    M = scene.material_table.shape[0]
    albedo = scene.material_table[torch.clamp(best_mat, 0, M - 1).long(), 0:3]
    nlen = torch.rsqrt(torch.clamp(best_nx ** 2 + best_ny ** 2
                                   + best_nz ** 2, min=1e-12))
    hnx, hny, hnz = best_nx * nlen, best_ny * nlen, best_nz * nlen
    # Face the ray (the geometric normal's sign follows the winding).
    flip = torch.sign(-(hnx * dx + hny * dy + hnz * dz))
    hnx, hny, hnz = hnx * flip, hny * flip, hnz * flip
    light = scene.lights[0]
    ldir = -light[4:7] / torch.clamp(torch.linalg.vector_norm(light[4:7]),
                                     min=1e-6)
    ndl = torch.clamp(hnx * ldir[0] + hny * ldir[1] + hnz * ldir[2], min=0.0)
    n_img = torch.stack([hnx, hny, hnz], -1).reshape(h, w, 3)
    irr = ibl_ops.eval_sh_irradiance(scene.env_sh, n_img).reshape(R, 3)
    lcol = light[8:11] * light[7]
    rad = albedo * (ndl[:, None] * lcol[None] + irr)
    col = torch.where(hit_mask[:, None], rad, 0.0).reshape(h, w, 3)
    hitf = hit_mask.to(torch.float32).reshape(h, w)
    if ds > 1:
        col = resize_bilinear(col, H, W)
        hitf = resize_bilinear(hitf, H, W)
    return col, hitf


def _intersect_cluster(page, meta, ox, oy, oz, dx, dy, dz, eps):
    """Möller-Trumbore of every ray against ITS candidate cluster's 128
    triangles: (R, 128) column math over the ray's page (R, SLAB*3) int32
    bits and meta row (R, META_LANES). Returns (t, geometric normal xyz,
    hit) per ray."""
    S, M = SLAB_VERTS, MESHLET_TRIS
    dq = meta[:, 0:8]
    m = meta[:, 8:24]
    tcnt = meta[:, 25]
    w0 = page[:, 0:S]
    w1 = page[:, S:2 * S]
    inv = 1.0 / 65535.0

    def corner(c):
        sl = slice(c * M, (c + 1) * M)
        qx = (w0[:, sl] & 0xFFFF).to(torch.float32)
        qy = ((w0[:, sl] >> 16) & 0xFFFF).to(torch.float32)
        qz = (w1[:, sl] & 0xFFFF).to(torch.float32)
        lx = dq[:, 0:1] + qx * (dq[:, 3:4] * inv)
        ly = dq[:, 1:2] + qy * (dq[:, 4:5] * inv)
        lz = dq[:, 2:3] + qz * (dq[:, 5:6] * inv)
        # Object -> world with the slot's model matrix.
        wx = m[:, 0:1] * lx + m[:, 1:2] * ly + m[:, 2:3] * lz + m[:, 3:4]
        wy = m[:, 4:5] * lx + m[:, 5:6] * ly + m[:, 6:7] * lz + m[:, 7:8]
        wz = m[:, 8:9] * lx + m[:, 9:10] * ly + m[:, 10:11] * lz \
            + m[:, 11:12]
        return wx, wy, wz

    ax, ay, az = corner(0)
    bx, by, bz = corner(1)
    cx, cy, cz = corner(2)
    e1x, e1y, e1z = bx - ax, by - ay, bz - az
    e2x, e2y, e2z = cx - ax, cy - ay, cz - az
    # h = d x e2
    hx = dy[:, None] * e2z - dz[:, None] * e2y
    hy = dz[:, None] * e2x - dx[:, None] * e2z
    hz = dx[:, None] * e2y - dy[:, None] * e2x
    det = e1x * hx + e1y * hy + e1z * hz
    invd = 1.0 / torch.where(torch.abs(det) > 1e-12, det, 1e-12)
    sx = ox[:, None] - ax
    sy = oy[:, None] - ay
    sz = oz[:, None] - az
    u = (sx * hx + sy * hy + sz * hz) * invd
    # q = s x e1
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx[:, None] * qx + dy[:, None] * qy + dz[:, None] * qz) * invd
    t = (e2x * qx + e2y * qy + e2z * qz) * invd
    lane = torch.arange(M, dtype=torch.float32, device=page.device)[None, :]
    ok = ((torch.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1.0)
          & (t > eps) & (lane < tcnt[:, None]))
    t = torch.where(ok, t, float("inf"))
    tbest, j = torch.min(t, dim=1)
    j = j[:, None]

    def pick(x):
        return torch.gather(x, 1, j)[:, 0]
    # Geometric normal of the winning triangle: e1 x e2.
    gnx = pick(e1y * e2z - e1z * e2y)
    gny = pick(e1z * e2x - e1x * e2z)
    gnz = pick(e1x * e2y - e1y * e2x)
    return tbest, gnx, gny, gnz, torch.isfinite(tbest)
