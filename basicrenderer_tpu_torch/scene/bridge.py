"""Scene -> device bridge: packs the ECS world into SceneBuffers.

Port of the triangle-soup part of basicrenderer_tpu/scene/bridge.py:

- `pack_geometry` (cold): flatten all renderable instances into the global
  fixed-capacity triangle soup once (geometry upload).
- `snapshot_objects` / `snapshot_lights` (hot, per frame): gather object
  matrices + lights into small numpy arrays.
- `build_scene_buffers(device)` / `update_dynamic`: the tensor upload.

The cluster, page and tangent-page packing of the JAX bridge feed the
cluster-LOD path, which this port does not have yet. The soup packs each
mesh's geometry ONCE, tagged with the object of its first instance, so a
scene that instances a mesh twice, carries a LOD DAG, skins a mesh or
registers textures needs that cluster path and is refused here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..graph.framedata import (LIGHT_STRIDE, MAX_SHADOW_CUBE_SLOTS,
                               MAX_SHADOW_SPOT_SLOTS, SceneBuffers)
from ..models.materials import MaterialRegistry
from ..models.mesh import MeshRegistry, compute_tangents
from .components import Light, LightType, Renderable, WorldMatrix
from .scene import Scene


@dataclasses.dataclass
class BridgeCapacities:
    max_vertices: int = 1 << 20
    max_triangles: int = 1 << 20
    max_objects: int = 1 << 12
    max_materials: int = 1 << 10
    max_lights: int = 256


@dataclasses.dataclass
class PackedGeometry:
    """Host-side packed soup arrays + instance bookkeeping."""
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
    local_bounds: np.ndarray  # (O, 4) object-space bounding sphere xyz + r


class SceneRenderBridge:
    def __init__(self, scene: Scene, meshes: MeshRegistry,
                 materials: MaterialRegistry,
                 caps: Optional[BridgeCapacities] = None, textures=None):
        if textures is not None and len(textures):
            raise NotImplementedError(
                "textures are not ported yet (FrameConfig.enable_textures)")
        self.scene = scene
        self.meshes = meshes
        self.materials = materials
        self.caps = caps or BridgeCapacities()
        self.packed: Optional[PackedGeometry] = None

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

        v_off = 0
        t_off = 0
        ent2obj: Dict[int, int] = {}
        local_bounds = np.zeros((c.max_objects, 4), np.float32)
        obj = 0
        packed_meshes = set()
        for eid, (r,) in self.scene.world.query(Renderable):
            mesh = self.meshes.get(r.mesh_id)
            nv, nt = mesh.num_vertices, mesh.num_triangles
            if obj >= c.max_objects:
                raise ValueError("object capacity exceeded")
            if mesh.clusters is not None or mesh.tri_cluster is not None:
                raise NotImplementedError(
                    "meshes with a cluster-LOD DAG render through the "
                    "cluster path (FrameConfig.enable_clod), not ported yet")
            if r.skeleton_id >= 0 and mesh.joints is not None:
                raise NotImplementedError(
                    "skinned meshes are not ported yet "
                    "(FrameConfig.enable_skinning)")
            if r.mesh_id in packed_meshes:
                raise NotImplementedError(
                    f"mesh {r.mesh_id} is instanced more than once: the soup "
                    "packs geometry once per mesh, so instancing needs the "
                    "cluster path (FrameConfig.enable_clod), not ported yet")
            packed_meshes.add(r.mesh_id)
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
            vobj[v_off:v_off + nv] = obj
            idx[t_off:t_off + nt] = mesh.indices + v_off
            tmat[t_off:t_off + nt] = r.material_id
            tobj[t_off:t_off + nt] = obj
            v_off += nv
            t_off += nt
            bc, br = mesh.bounding_sphere()
            local_bounds[obj, :3] = bc
            local_bounds[obj, 3] = br
            ent2obj[eid] = obj
            obj += 1
        self.packed = PackedGeometry(pos, nrm, tan, uv, vobj, idx, tmat, tobj,
                                     v_off, t_off, ent2obj, local_bounds)
        return self.packed

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

    def build_scene_buffers(self, device="cpu") -> SceneBuffers:
        """Full upload to `device` (cold start or after geometry changes)."""
        if self.packed is None:
            self.pack_geometry()
        p = self.packed
        mats, nmats, bounds, ovalid = self.snapshot_objects()
        lights, num_lights, num_dir = self.snapshot_lights()
        mat_table = self.materials.packed_table(self.caps.max_materials)

        def t(x, dtype=None):
            return torch.as_tensor(np.asarray(x, dtype), device=device)

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
        )

    def update_dynamic(self, buffers: SceneBuffers) -> SceneBuffers:
        """Per-frame refresh of matrices/lights (geometry untouched), on the
        device `buffers` live on."""
        mats, nmats, bounds, ovalid = self.snapshot_objects()
        lights, num_lights, num_dir = self.snapshot_lights()
        device = buffers.positions.device

        def t(x, dtype=None):
            return torch.as_tensor(np.asarray(x, dtype), device=device)

        return dataclasses.replace(
            buffers,
            object_mats=t(mats), object_normal_mats=t(nmats),
            object_bounds=t(bounds), object_valid=t(ovalid),
            lights=t(lights), num_lights=t(num_lights, np.int32),
            num_dir_lights=t(num_dir, np.int32),
        )
