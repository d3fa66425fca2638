"""Scene -> device bridge: packs the ECS world into SceneBuffers.

Port of basicrenderer_tpu/scene/bridge.py:

- `pack_geometry` (cold): flatten all renderable meshes into the global
  fixed-capacity buffers once. Geometry is packed ONCE PER MESH; every
  instance adds cluster rows that point at the shared triangle ranges and
  vertex pages (object + material live in the cluster row). Meshes without
  a LOD DAG get single-level clusters of 128 consecutive triangles, so all
  geometry can flow through the cluster path.
- `snapshot_objects` / `snapshot_lights` (hot, per frame): object matrices
  + lights as small numpy arrays.
- `build_scene_buffers(env_sh, env_specular, env_brdf_lut, device)` /
  `update_dynamic`: the tensor upload, with the texture strip atlas
  (models/textures.py; RGBA8 or, with `tex_format="bc3"`, BC3 block rows),
  the environment (models/environment.py), the skinning palette and,
  once `build_voxel_scene` ran, the voxel pyramid (models/voxels.py).
- `save_page_container`: the packed pages as a page-blob container
  (models/pageblob.py) the geometry streamer can read from disk.

As in the JAX package, the soup fields (positions ... tri_object) carry
each mesh once, tagged with the object of its first instance; the cluster
fields carry every instance. A skinned instance (a Renderable with a
skeleton, on a mesh with joints) is packed on its own (it deforms
uniquely), with its vertices' palette slots offset to its skeleton's
block of the joint palette.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..graph.framedata import (LIGHT_STRIDE, MAX_SHADOW_CUBE_SLOTS,
                               MAX_SHADOW_SPOT_SLOTS, SceneBuffers)
from ..models.clusters import CLUSTER_STRIDE, MESHLET_TRIS, SLAB_VERTS
from ..models.materials import MaterialRegistry
from ..models.mesh import MeshRegistry, compute_tangents
from ..models.pageblob import DEQUANT_LANES, quantize_page, write_container
from ..ops.textures import strip_layout
from .components import Light, LightType, Renderable, WorldMatrix
from .scene import Scene


@dataclasses.dataclass
class BridgeCapacities:
    max_vertices: int = 1 << 20
    max_triangles: int = 1 << 20
    max_objects: int = 1 << 12
    max_materials: int = 1 << 10
    max_lights: int = 256
    max_clusters: int = 1 << 14
    max_joints: int = 256
    max_geom_clusters: int = 1 << 13   # unique (non-instanced) cluster pages
    max_groups: int = 1 << 12          # streaming group id capacity


@dataclasses.dataclass
class PackedGeometry:
    """Host-side packed arrays + instance bookkeeping."""
    positions: np.ndarray
    normals: np.ndarray
    tangents: np.ndarray
    uvs: np.ndarray
    vert_object: np.ndarray
    indices: np.ndarray
    tri_material: np.ndarray
    tri_object: np.ndarray
    num_verts: int
    num_tris: int
    entity_to_object: Dict[int, int]
    local_bounds: np.ndarray     # (O, 4) object-space bounding sphere xyz + r
    tri_cluster: np.ndarray      # (T,) i32 global cluster id (-1 none)
    cluster_table: np.ndarray    # (C, CLUSTER_STRIDE) f32
    cluster_object: np.ndarray   # (C,) i32
    num_clusters: int
    cluster_verts: np.ndarray    # (G, SLAB*3) u32 quantized planar pages
    cluster_dequant: np.ndarray  # (G, 8) f32 per-page AABB min/ext
    cluster_tangents: np.ndarray  # (G, 512) f32 per-tri corner-0 object
    #                               tangent + w, plane-major
    cluster_feeds: np.ndarray    # (C,) i32 streaming group of c
    cluster_made: np.ndarray     # (C,) i32 group c was built from
    geom_group: np.ndarray       # (G,) i32 owning group per page (-1
    #                              pinned, -2 unused capacity)
    num_groups: int
    vert_joints: np.ndarray      # (V, 4) i32 global palette slots
    vert_weights: np.ndarray     # (V, 4) f32
    skin_instances: list         # [(skeleton_id, palette_offset, J)]


def pack_cluster_windows(cluster_table: np.ndarray,
                         cluster_object: np.ndarray,
                         num_clusters: int, window: int = 128) -> np.ndarray:
    """Window pre-cull table: one row per `window` consecutive cluster rows
    [cx, cy, cz, r, max_parent_err, object (-1 mixed), live_count, pad],
    the sphere being the object-space union of the window's tight cluster
    spheres (table lanes 16-19)."""
    C = cluster_table.shape[0]
    NW = (C + window - 1) // window
    out = np.zeros((NW, 8), np.float32)
    out[:, 5] = -1.0
    for w in range(NW):
        lo, hi = w * window, min((w + 1) * window, C)
        live = min(hi, num_clusters) - lo
        if live <= 0:
            continue
        rows = cluster_table[lo:lo + live]
        objs = np.unique(cluster_object[lo:lo + live])
        c, r = rows[:, 16:19], rows[:, 19]
        cen = c.mean(axis=0)
        rad = float(np.max(np.linalg.norm(c - cen, axis=1) + r))
        out[w, 0:3] = cen
        out[w, 3] = rad
        out[w, 4] = float(rows[:, 5].max())
        out[w, 5] = float(objs[0]) if len(objs) == 1 else -1.0
        out[w, 6] = float(live)
    return out


def _single_level_clusters(mesh) -> np.ndarray:
    """Single-LOD cluster rows for a mesh without a DAG: sequential
    128-triangle chunks (sets mesh.tri_cluster)."""
    nt = mesh.num_triangles
    ncl = (nt + MESHLET_TRIS - 1) // MESHLET_TRIS
    template = np.zeros((ncl, CLUSTER_STRIDE), np.float32)
    mesh.tri_cluster = np.arange(nt, dtype=np.int32) // MESHLET_TRIS
    for ci in range(ncl):
        lo = ci * MESHLET_TRIS
        hi = min(nt, lo + MESHLET_TRIS)
        vs = mesh.positions[np.unique(mesh.indices[lo:hi])]
        cen = (vs.min(0) + vs.max(0)) * 0.5
        template[ci, :3] = cen
        template[ci, 3] = np.linalg.norm(vs - cen, axis=1).max()
        template[ci, 5] = np.inf
        template[ci, 7] = lo
        template[ci, 8] = hi - lo
        template[ci, 12:16] = template[ci, 0:4]
        template[ci, 16:20] = template[ci, 0:4]
    return template


def _page_tangents(mesh, lo: int, cnt: int) -> np.ndarray:
    """One geometry cluster's per-triangle flat tangents: the corner-0
    vertex's object-space tangent and handedness, plane-major
    [tx*128 | ty*128 | tz*128 | w*128] (rotated to world and encoded as a
    theta by the setup, so instance rotations stay right)."""
    out = np.zeros((4, MESHLET_TRIS), np.float32)
    out[:, :cnt] = mesh.tangents[mesh.indices[lo:lo + cnt, 0]].T
    return out.reshape(-1)


def _page(mesh, lo: int, cnt: int):
    """One geometry cluster's quantized corner-major vertex page (row j =
    corner * 128 + tri). Dead corner rows repeat the cluster's own first
    vertex so they do not widen the page's quantization box."""
    tris = mesh.indices[lo:lo + cnt]
    fill = int(tris[0, 0]) if cnt > 0 else 0
    corner_ids = np.full(SLAB_VERTS, fill, np.int64)
    for cc in range(3):
        corner_ids[cc * MESHLET_TRIS:cc * MESHLET_TRIS + cnt] = tris[:, cc]
    rows10 = np.concatenate(
        [mesh.positions[corner_ids], mesh.normals[corner_ids],
         mesh.uvs[corner_ids], np.zeros((SLAB_VERTS, 2), np.float32)], axis=1)
    return quantize_page(rows10, SLAB_VERTS)


def _tensor(x, device, dtype=None) -> torch.Tensor:
    """Host array -> tensor on `device` (u32 as int32 bits)."""
    a = np.asarray(x, dtype)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a, device=device)


class SceneRenderBridge:
    def __init__(self, scene: Scene, meshes: MeshRegistry,
                 materials: MaterialRegistry,
                 caps: Optional[BridgeCapacities] = None, skeletons=None,
                 textures=None, tex_format: str = "rgba8"):
        self.scene = scene
        self.meshes = meshes
        self.materials = materials
        self.caps = caps or BridgeCapacities()
        self.skeletons = skeletons  # models.animation.SkeletonRegistry
        self.textures = textures    # models.textures.TextureRegistry
        self.tex_format = tex_format  # atlas-at-rest format (FrameConfig)
        self.packed: Optional[PackedGeometry] = None
        self._voxel = None          # models.voxels.VoxelSceneGrid

    def snapshot_joint_palette(self, t: float = 0.0) -> np.ndarray:
        """(max_joints, 16) object-space skinning palette of every skinned
        instance at time t (the SkeletonManager upload); identity rows
        elsewhere."""
        c = self.caps
        pal = np.tile(np.eye(4, dtype=np.float32).reshape(1, 16),
                      (c.max_joints, 1))
        if self.packed and self.packed.skin_instances and self.skeletons:
            for sk_id, off, nj in self.packed.skin_instances:
                p = self.skeletons.palette(sk_id, t)
                pal[off:off + nj] = p.reshape(nj, 16)
        return pal

    # -- cold path ---------------------------------------------------------
    def pack_geometry(self) -> PackedGeometry:
        c = self.caps
        pos = np.zeros((c.max_vertices, 3), np.float32)
        nrm = np.zeros((c.max_vertices, 3), np.float32)
        tan = np.zeros((c.max_vertices, 4), np.float32)
        uv = np.zeros((c.max_vertices, 2), np.float32)
        vobj = np.zeros((c.max_vertices,), np.int32)
        idx = np.zeros((c.max_triangles, 3), np.int32)
        tmat = np.zeros((c.max_triangles,), np.int32)
        tobj = np.full((c.max_triangles,), -1, np.int32)
        tcl = np.full((c.max_triangles,), -1, np.int32)
        cluster_table = np.zeros((c.max_clusters, CLUSTER_STRIDE), np.float32)
        cluster_object = np.zeros((c.max_clusters,), np.int32)
        cluster_verts = np.zeros((c.max_geom_clusters, SLAB_VERTS * 3),
                                 np.uint32)
        cluster_dequant = np.zeros((c.max_geom_clusters, DEQUANT_LANES),
                                   np.float32)
        cluster_dequant[:, 3:6] = 1.0
        cluster_tangents = np.zeros((c.max_geom_clusters, 4 * MESHLET_TRIS),
                                    np.float32)
        cluster_feeds = np.full((c.max_clusters,), -1, np.int32)
        cluster_made = np.full((c.max_clusters,), -1, np.int32)
        # -2 = unused capacity, -1 = live pinned page, >= 0 = group
        geom_group = np.full((c.max_geom_clusters,), -2, np.int32)
        vjoints = np.zeros((c.max_vertices, 4), np.int32)
        vweights = np.zeros((c.max_vertices, 4), np.float32)
        skin_instances = []
        joint_off = 0
        local_bounds = np.zeros((c.max_objects, 4), np.float32)
        ent2obj: Dict[int, int] = {}
        v_off = t_off = g_off = cl_off = grp_off = obj = 0
        # pack key (the mesh id, or ("skin", entity)) -> (template, feeds,
        # made)
        mesh_pack: Dict[object, tuple] = {}
        for eid, (r,) in self.scene.world.query(Renderable):
            mesh = self.meshes.get(r.mesh_id)
            nv, nt = mesh.num_vertices, mesh.num_triangles
            if obj >= c.max_objects:
                raise ValueError("object capacity exceeded")
            skinned = r.skeleton_id >= 0 and mesh.joints is not None
            # Skinned instances deform uniquely: they never share vertices.
            pack_key = ("skin", eid) if skinned else r.mesh_id
            if pack_key not in mesh_pack:
                if mesh.tangents is None or len(mesh.tangents) != nv:
                    mesh.tangents = compute_tangents(
                        mesh.positions, mesh.normals, mesh.uvs, mesh.indices)
                if v_off + nv > c.max_vertices or t_off + nt > c.max_triangles:
                    raise ValueError(
                        f"geometry capacity exceeded: verts {v_off + nv}/"
                        f"{c.max_vertices}, tris {t_off + nt}/{c.max_triangles}")
                pos[v_off:v_off + nv] = mesh.positions
                nrm[v_off:v_off + nv] = mesh.normals
                tan[v_off:v_off + nv] = mesh.tangents
                uv[v_off:v_off + nv] = mesh.uvs
                vobj[v_off:v_off + nv] = obj   # first instance (soup path)
                idx[t_off:t_off + nt] = mesh.indices + v_off
                tmat[t_off:t_off + nt] = r.material_id
                tobj[t_off:t_off + nt] = obj
                if mesh.tri_cluster is not None and mesh.clusters is not None:
                    template = mesh.clusters.copy()
                else:
                    template = _single_level_clusters(mesh)
                ncl_g = len(template)
                if g_off + ncl_g > c.max_geom_clusters:
                    raise ValueError("geometry cluster capacity exceeded")
                for ci in range(ncl_g):
                    lo, cnt = int(template[ci, 7]), int(template[ci, 8])
                    cluster_verts[g_off + ci], cluster_dequant[g_off + ci] = \
                        _page(mesh, lo, cnt)
                    cluster_tangents[g_off + ci] = _page_tangents(mesh, lo, cnt)
                template[:, 11] = g_off + np.arange(ncl_g)
                # Streaming groups offset into the global id space; top
                # level / non-LOD clusters stay -1 (always resident).
                if mesh.feeds_group is not None:
                    feeds_t = np.where(mesh.feeds_group >= 0,
                                       mesh.feeds_group + grp_off, -1)
                    made_t = np.where(mesh.made_group >= 0,
                                      mesh.made_group + grp_off, -1)
                    n_grp = int(max(mesh.feeds_group.max(initial=-1),
                                    mesh.made_group.max(initial=-1))) + 1
                else:
                    feeds_t = np.full(ncl_g, -1, np.int32)
                    made_t = np.full(ncl_g, -1, np.int32)
                    n_grp = 0
                if grp_off + n_grp > c.max_groups:
                    raise ValueError("streaming group capacity exceeded")
                # Page g belongs to the group its cluster FEEDS (the unit
                # the streamer loads and evicts together).
                geom_group[g_off:g_off + ncl_g] = feeds_t
                grp_off += n_grp
                g_off += ncl_g
                template[:, 7] += t_off  # mesh-local -> global tri offsets
                tcl[t_off:t_off + nt] = mesh.tri_cluster + cl_off  # first inst
                if skinned:
                    nj = (len(self.skeletons.skeletons[r.skeleton_id].parents)
                          if self.skeletons else int(mesh.joints.max()) + 1)
                    if joint_off + nj > c.max_joints:
                        raise ValueError("joint palette capacity exceeded")
                    vjoints[v_off:v_off + nv] = mesh.joints + joint_off
                    vweights[v_off:v_off + nv] = mesh.weights
                    skin_instances.append((r.skeleton_id, joint_off, nj))
                    joint_off += nj
                mesh_pack[pack_key] = (template, feeds_t, made_t)
                v_off += nv
                t_off += nt
            template, feeds_t, made_t = mesh_pack[pack_key]
            ncl = len(template)
            if cl_off + ncl > c.max_clusters:
                raise ValueError("cluster capacity exceeded")
            rows = template.copy()
            rows[:, 9] = r.material_id
            m = self.materials.get(r.material_id)
            # Surface class: 0 opaque, 1 transparent (OIT), 2 alpha-MASK.
            if m.alpha_blend or m.base_color[3] < 0.999 \
                    or m.transmission_weight > 0.0:
                rows[:, 10] = 1.0
            elif m.alpha_cutoff >= 0.0:
                rows[:, 10] = 2.0
            else:
                rows[:, 10] = 0.0
            cluster_table[cl_off:cl_off + ncl] = rows
            cluster_feeds[cl_off:cl_off + ncl] = feeds_t
            cluster_made[cl_off:cl_off + ncl] = made_t
            cluster_object[cl_off:cl_off + ncl] = obj
            cl_off += ncl
            bc, br = mesh.bounding_sphere()
            local_bounds[obj, :3] = bc
            local_bounds[obj, 3] = br
            ent2obj[eid] = obj
            obj += 1
        self.packed = PackedGeometry(
            pos, nrm, tan, uv, vobj, idx, tmat, tobj, v_off, t_off, ent2obj,
            local_bounds, tcl, cluster_table, cluster_object, cl_off,
            cluster_verts, cluster_dequant, cluster_tangents, cluster_feeds,
            cluster_made, geom_group, grp_off, vjoints, vweights,
            skin_instances)
        return self.packed

    def save_page_container(self, path: str) -> None:
        """Write the packed scene's quantized pages as a page-blob container
        the geometry streamer can cold-start from (reference: CLodCache.h
        page blobs + locators)."""
        p = self.packed if self.packed is not None else self.pack_geometry()
        write_container(path, p.cluster_verts, p.geom_group,
                        p.cluster_dequant, p.num_groups)

    # -- hot path ----------------------------------------------------------
    def snapshot_objects(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Model matrices, normal matrices, world bounding spheres, validity."""
        if self.packed is None:
            raise RuntimeError("pack_geometry() must run first")
        c = self.caps
        mats = np.tile(np.eye(4, dtype=np.float32), (c.max_objects, 1, 1))
        valid = np.zeros((c.max_objects,), bool)
        for eid, o in self.packed.entity_to_object.items():
            wm = self.scene.world.get(eid, WorldMatrix)
            if wm is not None:
                mats[o] = wm.value
            valid[o] = True
        m3 = mats[:, :3, :3]
        # normal matrix = inverse-transpose of upper 3x3
        nmats = np.linalg.inv(m3.astype(np.float64)).transpose(0, 2, 1).astype(np.float32)
        # World bounding spheres: transform local center, scale radius by the
        # largest axis scale (conservative).
        lb = self.packed.local_bounds
        centers = np.einsum("oij,oj->oi", m3, lb[:, :3]) + mats[:, :3, 3]
        scale = np.linalg.norm(m3, axis=1).max(axis=1)  # max column norm
        bounds = np.concatenate(
            [centers, (lb[:, 3] * scale)[:, None]], axis=1).astype(np.float32)
        return mats, nmats, bounds, valid

    def snapshot_lights(self) -> Tuple[np.ndarray, int, int]:
        """(L, LIGHT_STRIDE) packed light table, total count, directional
        count. Directional lights are packed FIRST (the full-screen pass can
        loop over just rows [0, num_directional))."""
        c = self.caps
        table = np.zeros((c.max_lights, LIGHT_STRIDE), np.float32)
        n = 0
        shadow_slot = 0
        cube_slot = 0
        entries = sorted(
            self.scene.world.query(Light),
            key=lambda e: 0 if e[1][0].type == LightType.DIRECTIONAL else 1)
        for eid, (l,) in entries:
            if n >= c.max_lights:
                break
            wm = self.scene.world.get(eid, WorldMatrix)
            m = wm.value if wm is not None else np.eye(4, dtype=np.float32)
            p = m[:3, 3]
            d = -m[:3, 2]  # light looks down local -Z
            d = d / (np.linalg.norm(d) + 1e-20)
            row = table[n]
            row[0:3] = p
            row[3] = float(l.type)
            row[4:7] = d
            row[7] = l.intensity
            row[8:11] = l.color
            row[11] = l.range
            row[12] = np.cos(l.inner_cone)
            row[13] = np.cos(l.outer_cone)
            # Local shadow slots as plain floats: lane 14 = spot view slot,
            # lane 15 = point cube index.
            slot = -1
            cube = -1
            if l.cast_shadows and l.type == LightType.SPOT and \
                    shadow_slot < MAX_SHADOW_SPOT_SLOTS:
                slot = shadow_slot
                shadow_slot += 1
            if l.cast_shadows and l.type == LightType.POINT and \
                    cube_slot < MAX_SHADOW_CUBE_SLOTS:
                cube = cube_slot
                cube_slot += 1
            row[14] = float(slot)
            row[15] = float(cube)
            n += 1
        n_dir = int(np.sum(table[:n, 3] == 0.0))
        return table, n, n_dir

    def build_scene_buffers(self, env_sh=None, env_specular=None,
                            env_brdf_lut=None, device="cuda") -> SceneBuffers:
        """Full upload to `device` (cold start or after geometry changes).
        The environment fields default to the JAX package's placeholders
        for a scene without one (zero SH, one 8x8 black mip, a zero LUT)."""
        if self.packed is None:
            self.pack_geometry()
        p = self.packed
        mats, nmats, bounds, ovalid = self.snapshot_objects()
        lights, num_lights, num_dir = self.snapshot_lights()
        mat_table = self.materials.packed_table(self.caps.max_materials)
        if env_sh is None:
            env_sh = np.zeros((9, 3), np.float32)
        if env_specular is None:
            env_specular = np.zeros((1, 6, 8, 8, 3), np.float32)
        if env_brdf_lut is None:
            env_brdf_lut = np.zeros((32, 32, 2), np.float32)
        if self.textures is not None and len(self.textures):
            strips, tex_flags = self.textures.strip_pyramid(
                fmt=self.tex_format)
        else:
            strips = np.full((strip_layout(4)[1], 128), 0xFFFFFFFF, np.uint32)
            tex_flags = np.zeros((1,), np.int32)

        def t(x, dtype=None):
            return _tensor(x, device, dtype)

        return SceneBuffers(
            positions=t(p.positions), normals=t(p.normals),
            tangents=t(p.tangents), uvs=t(p.uvs),
            vert_object=t(p.vert_object), indices=t(p.indices),
            tri_material=t(p.tri_material), tri_object=t(p.tri_object),
            num_tris=t(p.num_tris, np.int32),
            num_verts=t(p.num_verts, np.int32),
            object_mats=t(mats), object_normal_mats=t(nmats),
            object_bounds=t(bounds), object_valid=t(ovalid),
            material_table=t(mat_table),
            lights=t(lights), num_lights=t(num_lights, np.int32),
            num_dir_lights=t(num_dir, np.int32),
            tri_cluster=t(p.tri_cluster), cluster_table=t(p.cluster_table),
            cluster_object=t(p.cluster_object),
            num_clusters=t(p.num_clusters, np.int32),
            cluster_verts=t(p.cluster_verts),
            cluster_dequant=t(p.cluster_dequant),
            cluster_tangents=t(p.cluster_tangents),
            cluster_feeds=t(p.cluster_feeds), cluster_made=t(p.cluster_made),
            geom_slot=t(np.arange(p.cluster_verts.shape[0], dtype=np.int32)),
            group_resident=t(np.ones((self.caps.max_groups,), bool)),
            cluster_windows=t(pack_cluster_windows(
                p.cluster_table, p.cluster_object, p.num_clusters)),
            tex_strips=t(strips), tex_flags=t(tex_flags),
            env_sh=t(env_sh, np.float32),
            env_specular=t(env_specular, np.float32),
            env_brdf_lut=t(env_brdf_lut, np.float32),
            vert_joints=t(p.vert_joints), vert_weights=t(p.vert_weights),
            joint_palette=t(self.snapshot_joint_palette()),
            **self._voxel_fields(device),
        )

    def _voxel_fields(self, device) -> dict:
        """The voxel pyramid's SceneBuffers fields on `device` ({} until
        build_voxel_scene ran: the placeholders stay)."""
        v = self._voxel
        if v is None:
            return {}
        sggx = v.sggx if v.sggx is not None else np.zeros(2, np.uint32)
        return {"voxel_grid": _tensor(v.grid, device),
                "voxel_meta": _tensor(v.meta(), device),
                "voxel_sggx": _tensor(sggx, device)}

    def build_voxel_scene(self, n: int = 64, **kw):
        """Voxelize the packed world geometry and bake the current lights
        into the ray-fallback pyramid (models/voxels.py). Rebuild when
        lights or object transforms change (the reference's BLAS/TLAS
        refresh, Renderer.cpp:2001-2007). Returns the VoxelSceneGrid;
        build_scene_buffers embeds it (or splice `_voxel_fields`)."""
        from ..models.voxels import build_voxel_scene as _build
        if self.packed is None:
            self.pack_geometry()
        p = self.packed
        mats, _, _, _ = self.snapshot_objects()
        lights, _, num_dir = self.snapshot_lights()
        mat_table = self.materials.packed_table(self.caps.max_materials)
        self._voxel = _build(
            p.positions[:p.num_verts], p.indices[:p.num_tris],
            p.tri_material[:p.num_tris], p.tri_object[:p.num_tris],
            mats, mat_table, lights, num_dir, n=n, **kw)
        return self._voxel

    def update_dynamic(self, buffers: SceneBuffers,
                       t: float = 0.0) -> SceneBuffers:
        """Per-frame refresh of matrices, lights and the joint palette at
        animation time `t` (geometry untouched), on the device `buffers`
        live on."""
        mats, nmats, bounds, ovalid = self.snapshot_objects()
        lights, num_lights, num_dir = self.snapshot_lights()
        device = buffers.positions.device

        def up(x, dtype=None):
            return _tensor(x, device, dtype)

        return dataclasses.replace(
            buffers, joint_palette=up(self.snapshot_joint_palette(t)),
            object_mats=up(mats), object_normal_mats=up(nmats),
            object_bounds=up(bounds), object_valid=up(ovalid),
            lights=up(lights), num_lights=up(num_lights, np.int32),
            num_dir_lights=up(num_dir, np.int32),
        )
