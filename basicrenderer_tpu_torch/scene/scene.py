"""Scene API over the ECS world.

Mirrors the reference's Scene class surface (reference:
BasicScene/include/BasicScene/Scene.h:18-44 — CreateNodeECS,
CreateRenderableEntityECS, Create{Directional,Point,Spot}LightECS, SetCamera,
AppendScene, PropagateTransforms, Activate) with snake_case naming.

Transform propagation is vectorized on the host: nodes are kept in a
topologically-sorted order (parents before children) and world matrices are
computed level-by-level with batched numpy matmuls — the analogue of the
reference's PropagateTransforms over the flecs hierarchy.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils import math3d
from .components import (
    Camera, Light, LightType, Parent, Position, PrimaryCamera, Renderable,
    Rotation, Scale, WorldMatrix, TAG_TRANSFORM_DIRTY,
)
from .ecs import World


def _trs_numpy(pos: np.ndarray, quat: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Batched TRS composition: (N,3),(N,4),(N,3) -> (N,4,4) float32."""
    n = pos.shape[0]
    x, y, z, w = quat[:, 0], quat[:, 1], quat[:, 2], quat[:, 3]
    norm = x * x + y * y + z * z + w * w
    s2 = np.where(norm > 0, 2.0 / np.maximum(norm, 1e-20), 0.0)
    xx, yy, zz = x * x * s2, y * y * s2, z * z * s2
    xy, xz, yz = x * y * s2, x * z * s2, y * z * s2
    wx, wy, wz = w * x * s2, w * y * s2, w * z * s2
    m = np.zeros((n, 4, 4), np.float32)
    m[:, 0, 0] = 1.0 - (yy + zz)
    m[:, 0, 1] = xy - wz
    m[:, 0, 2] = xz + wy
    m[:, 1, 0] = xy + wz
    m[:, 1, 1] = 1.0 - (xx + zz)
    m[:, 1, 2] = yz - wx
    m[:, 2, 0] = xz - wy
    m[:, 2, 1] = yz + wx
    m[:, 2, 2] = 1.0 - (xx + yy)
    m[:, :3, :3] *= scale[:, None, :]
    m[:, :3, 3] = pos
    m[:, 3, 3] = 1.0
    return m


class Scene:
    def __init__(self, world: Optional[World] = None):
        self.world = world or World()
        self.root = self.world.entity()
        self.world.add_tag(self.root, "SceneRoot")
        self.world.set(self.root, WorldMatrix())
        self._primary_camera: Optional[int] = None

    # -- node creation -----------------------------------------------------
    def create_node(self, parent: Optional[int] = None, position=(0, 0, 0),
                    rotation=(0, 0, 0, 1), scale=(1, 1, 1), name: str = "") -> int:
        e = self.world.entity()
        self.world.set(e, Position(np.asarray(position)))
        self.world.set(e, Rotation(np.asarray(rotation)))
        self.world.set(e, Scale(np.asarray(scale)))
        self.world.set(e, Parent(parent if parent is not None else self.root))
        self.world.set(e, WorldMatrix())
        self.world.add_tag(e, TAG_TRANSFORM_DIRTY)
        if name:
            self.world.add_tag(e, f"name:{name}")
        return e

    def create_renderable(self, mesh_id: int, material_id: int,
                          parent: Optional[int] = None, position=(0, 0, 0),
                          rotation=(0, 0, 0, 1), scale=(1, 1, 1),
                          cast_shadows: bool = True, skeleton_id: int = -1) -> int:
        e = self.create_node(parent, position, rotation, scale)
        self.world.set(e, Renderable(mesh_id, material_id, skeleton_id, cast_shadows))
        return e

    # -- lights ------------------------------------------------------------
    def create_directional_light(self, direction=(0, -1, 0), color=(1, 1, 1),
                                 intensity=1.0, cast_shadows=True,
                                 parent: Optional[int] = None) -> int:
        # Orientation encodes the direction: light looks down its -Z like a
        # camera. Build a quaternion rotating -Z onto `direction`.
        d = np.asarray(direction, np.float64)
        d = d / (np.linalg.norm(d) + 1e-20)
        fr = np.array([0.0, 0.0, -1.0])
        c = np.cross(fr, d)
        dot = float(np.dot(fr, d))
        if dot < -0.999999:
            q = np.array([0, 1, 0, 0], np.float32)  # 180 deg about Y
        else:
            s = np.sqrt((1.0 + dot) * 2.0)
            q = np.array([c[0] / s, c[1] / s, c[2] / s, s * 0.5], np.float32)
        e = self.create_node(parent, rotation=q)
        self.world.set(e, Light(type=LightType.DIRECTIONAL, color=np.asarray(color),
                                intensity=intensity, cast_shadows=cast_shadows))
        return e

    def create_point_light(self, position=(0, 0, 0), color=(1, 1, 1), intensity=1.0,
                           range=25.0, cast_shadows=False, parent: Optional[int] = None) -> int:
        e = self.create_node(parent, position=position)
        self.world.set(e, Light(type=LightType.POINT, color=np.asarray(color),
                                intensity=intensity, range=range, cast_shadows=cast_shadows))
        return e

    def create_spot_light(self, position=(0, 0, 0), direction=(0, -1, 0), color=(1, 1, 1),
                          intensity=1.0, range=25.0, inner_cone=0.4, outer_cone=0.6,
                          cast_shadows=False, parent: Optional[int] = None) -> int:
        e = self.create_directional_light(direction, color, intensity, cast_shadows, parent)
        self.world.get(e, Light).type = LightType.SPOT
        l = self.world.get(e, Light)
        l.range, l.inner_cone, l.outer_cone = range, inner_cone, outer_cone
        self.world.set(e, Position(np.asarray(position)))
        return e

    # -- camera ------------------------------------------------------------
    def set_camera(self, position=(0, 0, 5), target=(0, 0, 0), up=(0, 1, 0),
                   fov_y=1.0471975512, near=0.1, far=None, aspect=16 / 9) -> int:
        # Reuse the existing primary camera entity (controllers call this
        # every tick — creating a node per call would leak entities).
        e = getattr(self, "_primary_camera", None)
        if e is None:
            e = self.create_node(position=position)
        else:
            from .components import Position
            self.world.set(e, Position(np.asarray(position, np.float32)))
        self.world.set(e, Camera(fov_y=fov_y, near=near, far=far, aspect=aspect))
        self.world.set(e, PrimaryCamera())
        # Store look-at target via rotation: compute view matrix on demand.
        self._camera_target = np.asarray(target, np.float32)
        self._camera_up = np.asarray(up, np.float32)
        self._primary_camera = e
        return e

    @property
    def primary_camera(self) -> int:
        return self._primary_camera

    def camera_matrices(self, aspect: Optional[float] = None):
        """Returns (view, proj, camera_pos) numpy arrays for the primary camera."""
        cam = self.world.get(self._primary_camera, Camera)
        pos = self.world.get(self._primary_camera, Position).value
        view = math3d.np_look_at(pos, self._camera_target, self._camera_up)
        proj = math3d.np_perspective(cam.fov_y, aspect or cam.aspect, cam.near, cam.far)
        return view, proj, pos

    # -- transform propagation --------------------------------------------
    def propagate_transforms(self) -> None:
        """Compute WorldMatrix for every node, parents before children.

        Reference analogue: Scene::PropagateTransforms (BasicScene/Scene.h:38).
        Vectorized per depth level with batched numpy matmuls.
        """
        w = self.world
        # Gather all transform nodes.
        entities: List[int] = []
        parents: Dict[int, int] = {}
        for eid, (p,) in w.query(Parent):
            entities.append(eid)
            parents[eid] = p.entity
        if not entities:
            return
        # Depth levels.
        depth: Dict[int, int] = {self.root: 0}

        def get_depth(e: int) -> int:
            d = depth.get(e)
            if d is not None:
                return d
            p = parents.get(e, self.root)
            d = get_depth(p) + 1 if p != e else 0
            depth[e] = d
            return d

        for e in entities:
            get_depth(e)
        maxd = max(depth[e] for e in entities)
        world_mats: Dict[int, np.ndarray] = {self.root: np.eye(4, dtype=np.float32)}
        for level in range(1, maxd + 1):
            level_ents = [e for e in entities if depth[e] == level]
            if not level_ents:
                continue
            pos = np.stack([w.get(e, Position).value for e in level_ents])
            rot = np.stack([w.get(e, Rotation).value for e in level_ents])
            scl = np.stack([w.get(e, Scale).value for e in level_ents])
            local = _trs_numpy(pos, rot, scl)
            pmats = np.stack([world_mats[parents[e]] for e in level_ents])
            wm = np.einsum("nij,njk->nik", pmats, local)
            for i, e in enumerate(level_ents):
                world_mats[e] = wm[i]
                w.get(e, WorldMatrix).value = wm[i]

    # -- composition -------------------------------------------------------
    def append_scene(self, other: "Scene", parent: Optional[int] = None) -> Dict[int, int]:
        """Clone another scene's entities under `parent` (reference:
        Scene::AppendScene). Returns old->new entity id map."""
        mapping: Dict[int, int] = {other.root: parent if parent is not None else self.root}
        ow = other.world
        # Topological copy.
        ents = [e for e, _ in ow.query(Parent)]
        pending = list(ents)
        while pending:
            nxt = []
            for e in pending:
                p = ow.get(e, Parent).entity
                if p not in mapping:
                    nxt.append(e)
                    continue
                ne = self.world.entity()
                mapping[e] = ne
                for ctype in (Position, Rotation, Scale, WorldMatrix, Renderable, Light, Camera):
                    v = ow.get(e, ctype)
                    if v is not None:
                        import copy
                        self.world.set(ne, copy.deepcopy(v))
                self.world.set(ne, Parent(mapping[p]))
                self.world.add_tag(ne, TAG_TRANSFORM_DIRTY)
            if len(nxt) == len(pending):
                break  # orphans
            pending = nxt
        return mapping
