"""Cluster-LOD (virtualized geometry) builder: the at-import Nanite-style
pipeline.

Port of basicrenderer_tpu/models/clusters.py (host numpy; same algorithm,
same table layout, same cache schema). Per mesh it produces all LOD
levels' triangles in one buffer and a flat cluster table
[bounding sphere | self_error | parent_error | level | ...] with the cut
invariant parent_error > self_error along every DAG path (runtime:
ops/clod.py).

The hot algorithms (quadric edge collapse with locked boundary vertices,
Morton meshlet partition) run in native C++ (native/clod_native.cpp),
built here with g++ into basicrenderer_tpu_torch/_build/ and loaded
through ctypes. Where the JAX package falls back to a low-quality numpy
decimator when the build fails, this copy raises: a fallback would render
different LODs than the reference. Built DAGs are cached under
basicrenderer_tpu_torch/_build/clod/ keyed by content hash.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Tuple

import numpy as np

from .mesh import MeshData, compute_normals

_PKG = Path(__file__).resolve().parents[1]
_NATIVE_SRC = _PKG.parent / "native" / "clod_native.cpp"
BUILD_DIR = _PKG / "_build"
CACHE_DIR = BUILD_DIR / "clod"
CACHE_SCHEMA = 9  # the JAX package's schema: same DAG, same key
MESHLET_TRIS = 128
SLAB_VERTS = 384        # cluster vertex-page capacity (128 tris x 3 corners)
GROUP_SIZE = 4          # clusters merged per simplify step
SIMPLIFY_RATIO = 0.5    # target triangle ratio per LOD level

_NATIVE = None


def _load_native() -> ctypes.CDLL:
    """Build (once per source hash) and load the native QEM library.
    Raises when g++ fails or the source is missing."""
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE
    src = _NATIVE_SRC.read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:16]
    so = BUILD_DIR / f"libclod-{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        res = subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp),
                              str(_NATIVE_SRC)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}) for "
                               f"{_NATIVE_SRC.name}:\n{res.stderr[:4000]}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.simplify_qem.restype = ctypes.c_float
    lib.simplify_qem.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.partition_meshlets.restype = ctypes.c_int
    lib.partition_meshlets.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    _NATIVE = lib
    return lib


def simplify(positions: np.ndarray, indices: np.ndarray, locked: np.ndarray,
             target_tris: int
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Quadric edge-collapse to ~target_tris; locked vertices stay fixed.
    Returns (positions, indices, src, max_error) where src[i] is the INPUT
    vertex each output vertex descended from (attribute provenance)."""
    lib = _load_native()
    nv, nt = len(positions), len(indices)
    pos = np.ascontiguousarray(positions, np.float32)
    idx = np.ascontiguousarray(indices, np.int32)
    lk = np.ascontiguousarray(locked, np.uint8)
    out_pos = np.zeros_like(pos)
    out_idx = np.zeros_like(idx)
    out_src = np.zeros(nv, np.int32)
    counts = np.zeros(2, np.int32)
    err = lib.simplify_qem(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nv,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), nt,
        lk.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(target_tris),
        out_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        out_src.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return (out_pos[:counts[0]].copy(), out_idx[:counts[1]].copy(),
            out_src[:counts[0]].copy(), float(err))


def partition(centroids: np.ndarray, max_tris: int = MESHLET_TRIS) -> np.ndarray:
    """(T, 3) centroids -> (T,) cluster ids (Morton-coherent chunks)."""
    lib = _load_native()
    nt = len(centroids)
    if nt == 0:
        return np.zeros(0, np.int32)
    cen = np.ascontiguousarray(centroids, np.float32)
    out = np.zeros(nt, np.int32)
    lib.partition_meshlets(
        cen.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nt,
        int(max_tris), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out


# Cluster table layout (float lanes), consumed by ops/clod.py
CLUSTER_STRIDE = 20
# 0-2 SELF-GROUP bound center (object space), 3 radius — the sphere of the
#     simplify group that created this cluster; used for frustum culling AND
#     for projecting self_error to screen space,
# 4 self_error (object-space), 5 parent_error, 6 level,
# 7 tri_offset (mesh-local; the bridge adds the global offset),
# 8 tri_count, 9 material id (bridge fills per instance),
# 10 transparent flag (bridge fills per instance),
# 11 geometry-cluster id (bridge fills; indexes the shared cluster vertex
#    pages — instances share geometry, framedata.SceneBuffers),
# 12-14 PARENT-GROUP bound center, 15 radius — the sphere of the group this
#     cluster is simplified INTO; used for projecting parent_error,
# 16-18 TIGHT per-cluster bound center, 19 radius — this cluster's own
#     vertices only. Culling (frustum + HZB occlusion) uses the tight
#     sphere: group spheres span whole simplify groups (median ~250 px
#     projected on the city bench) and made the occlusion test cull ~3%;
#     error projection MUST keep using the group spheres (lanes 0-3/12-15)
#     for the seam-free cut invariant below.
#
# Nanite cut invariant: both sides of a LOD switch must compute the SAME
# screen-space threshold, so children project parent_error with the parent
# group's sphere and parents project self_error with that same sphere
# (child.parent == parent.self in BOTH error and bound). Parent spheres
# contain child spheres, so projected errors are monotone along every DAG
# path and the separable per-cluster cut is seam- and hole-free.
# Triangles are stored grouped by cluster (offset/count ranges) so the
# runtime can gather a visible cluster's triangles contiguously.


@dataclasses.dataclass
class ClusterLODMesh:
    """All LOD levels in one soup + the cluster cut table."""
    positions: np.ndarray      # (V, 3) all levels
    normals: np.ndarray        # (V, 3)
    uvs: np.ndarray            # (V, 2)
    indices: np.ndarray        # (T, 3)
    tri_cluster: np.ndarray    # (T,) i32 cluster id
    clusters: np.ndarray       # (C, CLUSTER_STRIDE) f32
    num_levels: int
    source_tris: int
    # Streaming group ids (ops/clod.py residency patching; reference:
    # CLodStreamingSystem group pages). feeds_group[c] = the simplify group
    # c belongs to (-1 top level: never streamed, always resident);
    # made_group[c] = the group whose children c was simplified FROM
    # (-1 for level 0).
    feeds_group: np.ndarray = None    # (C,) i32
    made_group: np.ndarray = None     # (C,) i32

    @property
    def num_clusters(self) -> int:
        return len(self.clusters)


def to_mesh_data(cl: ClusterLODMesh, name: str = "") -> MeshData:
    """Wrap a built LOD DAG as a renderable MeshData (all levels resident;
    the runtime cut masks triangles per frame — ops/clod.py)."""
    return MeshData(cl.positions, cl.normals, cl.uvs, cl.indices,
                    tri_cluster=cl.tri_cluster, clusters=cl.clusters,
                    feeds_group=cl.feeds_group, made_group=cl.made_group,
                    name=name or "clod")


def _boundary_vertices(indices: np.ndarray, tri_cluster: np.ndarray,
                       nv: int, positions: np.ndarray = None) -> np.ndarray:
    """Vertices shared by triangles of different clusters (or open edges) —
    locked during simplification so neighboring groups stay sealed (the
    reference's group-boundary constraint).

    Duplicated vertices (UV/material seams: same position, split attributes)
    are WELDED by position first — otherwise each copy looks single-group,
    goes unlocked, drifts under simplification, and the seam cracks open."""
    if positions is not None:
        # Canonical id per rounded position (1e-5 of the mesh extent).
        ext = float(max(positions.max() - positions.min(), 1e-9))
        q = np.round(positions / ext * 1e5).astype(np.int64)
        _, canon = np.unique(q, axis=0, return_inverse=True)
    else:
        canon = np.arange(nv, dtype=np.int64)
    nc = int(canon.max()) + 1 if nv else 0
    owner = np.full(nc, -1, np.int64)
    locked_c = np.zeros(nc, bool)
    for k in range(3):
        v = canon[indices[:, k]]
        c = tri_cluster
        seen = owner[v]
        conflict = (seen >= 0) & (seen != c)
        locked_c[v[conflict]] = True
        owner[v] = np.where(seen < 0, c, seen)
    return locked_c[canon]


def build_cluster_lod(mesh: MeshData, max_levels: int = 8,
                      use_cache: bool = True) -> ClusterLODMesh:
    """Build the full LOD DAG for a mesh."""
    key = None
    if use_cache:
        h = hashlib.sha1()
        h.update(np.ascontiguousarray(mesh.positions).tobytes())
        h.update(np.ascontiguousarray(mesh.indices).tobytes())
        h.update(f"v{CACHE_SCHEMA}-{MESHLET_TRIS}-{GROUP_SIZE}-{max_levels}".encode())
        key = h.hexdigest()[:16]
        path = CACHE_DIR / f"{key}.npz"
        if path.exists():
            z = np.load(path)
            return ClusterLODMesh(
                z["positions"], z["normals"], z["uvs"], z["indices"],
                z["tri_cluster"], z["clusters"], int(z["num_levels"]),
                int(z["source_tris"]), z["feeds_group"], z["made_group"])

    all_pos: List[np.ndarray] = []
    all_idx: List[np.ndarray] = []
    all_cluster: List[np.ndarray] = []
    all_uv: List[np.ndarray] = []
    cluster_rows: List[np.ndarray] = []
    feeds_parts: List[np.ndarray] = []
    made_parts: List[np.ndarray] = []
    group_base = 0

    def append_level(pos, idx, uv, level, self_errs_per_cluster, cluster_of_tri,
                     self_spheres=None):
        """`self_spheres` (ncl, 4): the creating group's sphere per cluster
        (coarse levels); level 0 computes tight per-meshlet bounds."""
        v_off = sum(len(p) for p in all_pos)
        t_off = sum(len(i) for i in all_idx)
        c_off = sum(len(r) for r in cluster_rows)
        # Reorder triangles so each cluster's range is contiguous (the
        # runtime gathers visible clusters' triangle ranges directly).
        order = np.argsort(cluster_of_tri, kind="stable")
        idx = idx[order]
        cluster_of_tri = cluster_of_tri[order]
        all_pos.append(pos)
        all_idx.append(idx + v_off)
        all_uv.append(uv)
        all_cluster.append(cluster_of_tri + c_off)
        ncl = cluster_of_tri.max() + 1 if len(cluster_of_tri) else 0
        starts = np.searchsorted(cluster_of_tri, np.arange(ncl + 1))
        rows = np.zeros((ncl, CLUSTER_STRIDE), np.float32)
        for c in range(ncl):
            sel = slice(starts[c], starts[c + 1])
            vs = pos[np.unique(idx[sel])]
            cen = (vs.min(0) + vs.max(0)) * 0.5
            rad = np.linalg.norm(vs - cen, axis=1).max()
            if self_spheres is not None:
                rows[c, :4] = self_spheres[c]
            else:
                rows[c, :3] = cen
                rows[c, 3] = rad
            rows[c, 4] = self_errs_per_cluster[c]
            rows[c, 5] = np.inf  # parent error patched when parent appears
            rows[c, 6] = level
            rows[c, 7] = t_off + starts[c]
            rows[c, 8] = starts[c + 1] - starts[c]
            rows[c, 12:16] = rows[c, 0:4]  # parent sphere patched later
            rows[c, 16:19] = cen           # tight bound (culling only)
            rows[c, 19] = rad
        cluster_rows.append(rows)
        feeds_parts.append(np.full(ncl, -1, np.int32))
        made_parts.append(np.full(ncl, -1, np.int32))
        return c_off, ncl

    # Level 0: original mesh meshlets, self_error = 0.
    pos = np.asarray(mesh.positions, np.float32)
    idx = np.asarray(mesh.indices, np.int32)
    uv = np.asarray(mesh.uvs, np.float32)
    cen = pos[idx].mean(1)
    cl = partition(cen, MESHLET_TRIS)
    ncl0 = cl.max() + 1 if len(cl) else 0
    c_off, ncl = append_level(pos, idx, uv, 0, np.zeros(max(ncl0, 1)), cl)
    level = 0

    cur_pos, cur_idx, cur_uv, cur_cl = pos, idx, uv, cl
    prev_range = (c_off, ncl)
    while level < max_levels - 1 and len(cur_idx) > MESHLET_TRIS:
        level += 1
        # Group clusters (Morton order over cluster centers), merge, simplify
        # each group to SIMPLIFY_RATIO with boundary verts locked.
        ncl_cur = cur_cl.max() + 1
        ccen = np.zeros((ncl_cur, 3), np.float32)
        for c in range(ncl_cur):
            sel = cur_cl == c
            ccen[c] = cur_pos[np.unique(cur_idx[sel])].mean(0)
        group_of_cluster = partition(ccen, GROUP_SIZE)
        # Streaming group ids: the PREVIOUS level's clusters feed these
        # simplify groups (each group = one streamable page set).
        feeds_parts[-1][:] = group_base + group_of_cluster
        group_of_tri = group_of_cluster[cur_cl]
        locked = _boundary_vertices(cur_idx, group_of_tri, len(cur_pos),
                                    positions=cur_pos)

        new_pos_l, new_idx_l, new_uv_l, errs = [], [], [], []
        ngroups = group_of_cluster.max() + 1
        for g in range(ngroups):
            sel = group_of_tri == g
            tris_g = cur_idx[sel]
            used = np.unique(tris_g)
            remap = np.zeros(len(cur_pos), np.int32)
            remap[used] = np.arange(len(used), dtype=np.int32)
            p_g = cur_pos[used]
            uv_g = cur_uv[used]
            i_g = remap[tris_g]
            l_g = locked[used]
            # Weld duplicated seam vertices (same position, split UV) so
            # the collapse graph is watertight — unwelded copies simplify
            # independently and crack the seam open. The first copy's UV
            # survives; simplify() provenance then carries UVs through the
            # collapse (reference: attribute-preserving simplification,
            # ClusterLODUtilities.cpp's meshopt attribute path).
            ext_g = float(max(p_g.max() - p_g.min(), 1e-9)) if len(p_g) else 1.0
            qp = np.round(p_g / ext_g * 1e5).astype(np.int64)
            _, widx, winv = np.unique(qp, axis=0, return_index=True,
                                      return_inverse=True)
            pw, uvw = p_g[widx], uv_g[widx]
            lw = np.zeros(len(widx), bool)
            np.logical_or.at(lw, winv, l_g)
            iw = winv[i_g].astype(np.int32)
            target = max(int(len(iw) * SIMPLIFY_RATIO), 1)
            sp, si, src, err = simplify(pw, iw, lw.astype(np.uint8), target)
            new_pos_l.append(sp)
            new_idx_l.append(si)
            new_uv_l.append(uvw[src])
            errs.append(err)

        # Flatten this level.
        lvl_pos = np.concatenate(new_pos_l) if new_pos_l else np.zeros((0, 3), np.float32)
        lvl_uv = np.concatenate(new_uv_l) if new_uv_l else np.zeros((0, 2), np.float32)
        offs = np.cumsum([0] + [len(p) for p in new_pos_l])
        lvl_idx = np.concatenate([i + offs[k] for k, i in enumerate(new_idx_l)]) \
            if new_idx_l else np.zeros((0, 3), np.int32)
        if len(lvl_idx) == 0 or len(lvl_idx) >= len(cur_idx):
            break
        # Monotonic error ALONG EACH DAG PATH: a group's error must exceed
        # its OWN children's self errors (Nanite invariant). Accumulate the
        # simplify deviation on top of the children's (each level's QEM
        # error is relative to the PREVIOUS level's surface, so the sum
        # approximates total deviation from the source mesh). The round-2
        # global `prev_err` floor made one bad group poison every deeper
        # level of the whole mesh — the cut could never coarsen past it
        # even where local error was tiny.
        errs = np.asarray(errs, np.float32)
        prev_rows = cluster_rows[-1]
        child_max = np.zeros(ngroups, np.float32)
        np.maximum.at(child_max, group_of_cluster,
                      prev_rows[:ncl_cur, 4].astype(np.float32))
        lvl_err = np.maximum(errs + child_max, child_max * 1.0001 + 1e-7)

        # Group spheres: each group's sphere contains its children's SELF
        # spheres (containment makes the projected error monotone along
        # every DAG path — see the layout note above).
        prev_rows = cluster_rows[-1]
        group_spheres = np.zeros((ngroups, 4), np.float32)
        for g in range(ngroups):
            ch = np.nonzero(group_of_cluster == g)[0]
            cen = prev_rows[ch, :3].mean(0)
            group_spheres[g, :3] = cen
            group_spheres[g, 3] = (
                np.linalg.norm(prev_rows[ch, :3] - cen, axis=1)
                + prev_rows[ch, 3]).max()

        # New meshlets are partitioned WITHIN each simplify group — never
        # across groups — and every new cluster projects self_error with
        # EXACTLY its group's (error, sphere), so child.parent ==
        # parent.self on both sides of the switch and the runtime cut
        # (self <= tau < parent) is seam- and hole-free for every tau
        # (cross-group meshlets made the max-of-groups error
        # disagree with the children's patched parent_error, dropping
        # geometry between two groups' error values).
        cl2_parts = []
        err_parts = []
        sphere_parts = []
        made_group_parts = []
        cl_base = 0
        for g, i_g in enumerate(new_idx_l):
            if len(i_g) == 0:
                continue
            cen_g = new_pos_l[g][i_g].mean(1)
            cl_g = partition(cen_g, MESHLET_TRIS)
            ncl_g = cl_g.max() + 1
            cl2_parts.append(cl_g + cl_base)
            err_parts.append(np.full(ncl_g, lvl_err[g], np.float32))
            sphere_parts.append(np.tile(group_spheres[g], (ncl_g, 1)))
            made_group_parts.append(np.full(ncl_g, group_base + g, np.int32))
            cl_base += ncl_g
        cl2 = np.concatenate(cl2_parts).astype(np.int32)
        err_of_new_cluster = np.concatenate(err_parts)
        sphere_of_new_cluster = np.concatenate(sphere_parts)

        c_off2, ncl_new = append_level(lvl_pos, lvl_idx, lvl_uv,
                                       level, err_of_new_cluster, cl2,
                                       self_spheres=sphere_of_new_cluster)
        # New clusters record the group they were simplified FROM.
        made_np = np.concatenate(made_group_parts).astype(np.int32)
        made_parts[-1][:] = made_np
        group_base += int(ngroups)
        # Patch children: parent error AND parent sphere = their group's.
        for c in range(ncl_cur):
            g = group_of_cluster[c]
            prev_rows[c, 5] = lvl_err[g]
            prev_rows[c, 12:16] = group_spheres[g]
        prev_range = (c_off2, ncl_new)
        cur_pos, cur_idx, cur_uv, cur_cl = lvl_pos, lvl_idx, lvl_uv, cl2

    positions = np.concatenate(all_pos)
    indices = np.concatenate(all_idx)
    uvs = np.concatenate(all_uv)
    tri_cluster = np.concatenate(all_cluster)
    clusters = np.concatenate(cluster_rows)
    normals = compute_normals(positions, indices)
    out = ClusterLODMesh(positions.astype(np.float32), normals,
                         uvs.astype(np.float32), indices.astype(np.int32),
                         tri_cluster.astype(np.int32),
                         clusters.astype(np.float32),
                         num_levels=level + 1, source_tris=len(mesh.indices),
                         feeds_group=np.concatenate(feeds_parts),
                         made_group=np.concatenate(made_parts))
    if use_cache and key is not None:
        CACHE_DIR.mkdir(parents=True, exist_ok=True)
        tmp = CACHE_DIR / f"{key}.{os.getpid()}.tmp.npz"
        np.savez(tmp,
                 positions=out.positions, normals=out.normals, uvs=out.uvs,
                 indices=out.indices, tri_cluster=out.tri_cluster,
                 clusters=out.clusters, num_levels=out.num_levels,
                 source_tris=out.source_tris, feeds_group=out.feeds_group,
                 made_group=out.made_group)
        os.replace(tmp, CACHE_DIR / f"{key}.npz")
    return out
