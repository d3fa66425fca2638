"""Mesh data model and registry.

Host-side analogue of the reference's Mesh/MeshManager GPU geometry database
(reference: BasicRenderer/include/Managers/MeshManager.h:31-130,
BasicRenderer/src/Mesh/Mesh.cpp). Meshes are CPU-side numpy arrays; the
registry packs all registered meshes + scene instances into *fixed-capacity*
device buffers (SceneBuffers) that the frame function consumes.

Key design choice: instead of per-mesh vertex buffers + indirect draws,
every renderable instance is flattened into one global triangle soup with
per-vertex object ids. Per-frame, only the object matrices change; the
geometry buffers are uploaded once (streaming updates them incrementally
later — see ops/streaming.py). Clustering (meshlets) is layered on top in
models/clusters.py for the virtualized-geometry path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class MeshData:
    """One mesh's geometry, object space. float32/int32 numpy arrays."""
    positions: np.ndarray          # (V, 3)
    normals: np.ndarray            # (V, 3)
    uvs: np.ndarray                # (V, 2)
    indices: np.ndarray            # (T, 3) int32
    tangents: Optional[np.ndarray] = None  # (V, 4) xyz + handedness
    joints: Optional[np.ndarray] = None    # (V, 4) int32 joint indices
    weights: Optional[np.ndarray] = None   # (V, 4) f32 skin weights
    # Cluster-LOD (virtualized geometry) attachments — set by
    # models/clusters.py when the mesh carries a LOD DAG.
    tri_cluster: Optional[np.ndarray] = None  # (T,) i32 local cluster id
    clusters: Optional[np.ndarray] = None     # (C, CLUSTER_STRIDE) f32
    feeds_group: Optional[np.ndarray] = None  # (C,) i32 streaming group
    made_group: Optional[np.ndarray] = None   # (C,) i32 source group
    name: str = ""

    def __post_init__(self):
        self.positions = np.ascontiguousarray(self.positions, np.float32)
        self.normals = np.ascontiguousarray(self.normals, np.float32)
        self.uvs = np.ascontiguousarray(self.uvs, np.float32)
        self.indices = np.ascontiguousarray(self.indices, np.int32)
        if self.tangents is not None:
            self.tangents = np.ascontiguousarray(self.tangents, np.float32)

    @property
    def num_vertices(self) -> int:
        return self.positions.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]

    def bounding_sphere(self) -> Tuple[np.ndarray, float]:
        c = (self.positions.min(0) + self.positions.max(0)) * 0.5
        r = float(np.linalg.norm(self.positions - c, axis=1).max()) if len(self.positions) else 0.0
        return c.astype(np.float32), r

    def aabb(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.positions.min(0).astype(np.float32), self.positions.max(0).astype(np.float32)


def compute_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (reference computes these at import when
    absent; GlTFGeometryExtractor)."""
    n = np.zeros_like(positions, dtype=np.float64)
    v0 = positions[indices[:, 0]]
    v1 = positions[indices[:, 1]]
    v2 = positions[indices[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    for k in range(3):
        np.add.at(n, indices[:, k], fn)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.maximum(ln, 1e-20)).astype(np.float32)


def compute_tangents(positions, normals, uvs, indices) -> np.ndarray:
    """Mikktspace-compatible per-vertex tangents + handedness.

    Reimplements the ALGORITHM of Morten Mikkelsen's mikktspace (the
    reference vendors the C source — BasicRenderer/src/Utilities/
    mikktspace.c); not a code translation. The compatibility-critical
    rules, per the published spec:

    - face tangent/bitangent from the UV parameterization (dP/du, dP/dv);
    - corner contributions weighted by the CORNER ANGLE (not area);
    - corners only average with corners of the SAME handedness sign
      (a mirrored-UV seam keeps two clean frames instead of a smeared
      average — the failure mode of naive accumulation);
    - per-vertex orthonormalization against the vertex normal, and
      handedness w = sign(dot(cross(n, t), b)).

    Meshes whose mirrored halves share seam vertices get the majority
    sign at the seam (mikktspace splits such wedges; glTF-conformant
    content already duplicates them, so this matches in practice)."""
    V = positions.shape[0]
    i0, i1, i2 = indices[:, 0], indices[:, 1], indices[:, 2]
    e1 = (positions[i1] - positions[i0]).astype(np.float64)
    e2 = (positions[i2] - positions[i0]).astype(np.float64)
    du1 = (uvs[i1] - uvs[i0]).astype(np.float64)
    du2 = (uvs[i2] - uvs[i0]).astype(np.float64)
    det = du1[:, 0] * du2[:, 1] - du2[:, 0] * du1[:, 1]
    ok = np.abs(det) > 1e-12
    r = np.where(ok, 1.0 / np.where(det == 0, 1.0, det), 0.0)[:, None]
    t_face = (e1 * du2[:, 1:2] - e2 * du1[:, 1:2]) * r
    b_face = (e2 * du1[:, 0:1] - e1 * du2[:, 0:1]) * r
    # Face handedness: the sign of the UV determinant (mirrored triangles
    # flip it).
    f_sign = np.where(det >= 0.0, 1.0, -1.0)

    # Corner angles (the mikktspace weight).
    def corner_angle(a, b, c):
        u = positions[b] - positions[a]
        v = positions[c] - positions[a]
        un = u / np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-20)
        vn = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-20)
        return np.arccos(np.clip(np.sum(un * vn, 1), -1.0, 1.0))

    angles = [corner_angle(i0, i1, i2), corner_angle(i1, i2, i0),
              corner_angle(i2, i0, i1)]

    # Sign-separated accumulation: each vertex keeps a +1 and a -1 bin;
    # the final frame comes from the bin with more accumulated weight.
    tan = np.zeros((V, 2, 3), np.float64)
    bit = np.zeros((V, 2, 3), np.float64)
    wsum = np.zeros((V, 2), np.float64)
    sbin = (f_sign < 0).astype(np.int64)
    for k, ang in enumerate(angles):
        idx = indices[:, k].astype(np.int64)
        w = np.where(ok, ang, 0.0)
        np.add.at(tan, (idx, sbin), t_face * w[:, None])
        np.add.at(bit, (idx, sbin), b_face * w[:, None])
        np.add.at(wsum, (idx, sbin), w)
    pick = (wsum[:, 1] > wsum[:, 0]).astype(np.int64)
    tv = tan[np.arange(V), pick]
    bv = bit[np.arange(V), pick]
    # Orthonormalize against the vertex normal.
    n = normals.astype(np.float64)
    tv = tv - n * np.sum(tv * n, axis=1, keepdims=True)
    ln = np.linalg.norm(tv, axis=1, keepdims=True)
    tv = np.where(ln > 1e-12, tv / np.maximum(ln, 1e-20),
                  np.array([[1.0, 0.0, 0.0]]))
    w = np.where(np.sum(np.cross(n, tv) * bv, axis=1) >= 0.0, 1.0, -1.0)
    return np.concatenate([tv, w[:, None]],
                          axis=1).astype(np.float32)


class MeshRegistry:
    """Host-side mesh database; hands out integer mesh ids."""

    def __init__(self):
        self.meshes: List[MeshData] = []

    def add(self, mesh: MeshData) -> int:
        if mesh.normals is None or mesh.normals.size == 0:
            mesh.normals = compute_normals(mesh.positions, mesh.indices)
        if mesh.uvs is None or mesh.uvs.size == 0:
            mesh.uvs = np.zeros((mesh.num_vertices, 2), np.float32)
        if mesh.tangents is None:
            mesh.tangents = compute_tangents(mesh.positions, mesh.normals, mesh.uvs, mesh.indices)
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    def get(self, mesh_id: int) -> MeshData:
        return self.meshes[mesh_id]

    def __len__(self):
        return len(self.meshes)
