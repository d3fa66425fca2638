"""Scene components, mirroring the reference's BasicScene component set
(reference: BasicScene/include/BasicScene/Components.h:21-100).

All math payloads are numpy float32 on the host; the render bridge packs them
into device arrays. Angles are radians; quaternions are xyzw.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def _v3(x) -> np.ndarray:
    a = np.asarray(x, np.float32)
    return np.broadcast_to(a, (3,)).copy()


@dataclasses.dataclass
class Position:
    value: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))

    def __post_init__(self):
        self.value = _v3(self.value)


@dataclasses.dataclass
class Rotation:
    """xyzw quaternion."""
    value: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0, 0, 0, 1], np.float32))

    def __post_init__(self):
        self.value = np.asarray(self.value, np.float32).reshape(4)


@dataclasses.dataclass
class Scale:
    value: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(3, np.float32))

    def __post_init__(self):
        self.value = _v3(self.value)


@dataclasses.dataclass
class Parent:
    entity: int = 0  # 0 = scene root


@dataclasses.dataclass
class WorldMatrix:
    """Propagated world transform (output of Scene.propagate_transforms)."""
    value: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4, dtype=np.float32))


@dataclasses.dataclass
class Renderable:
    """Attaches geometry to an entity. mesh_id indexes the MeshRegistry;
    material_id indexes the MaterialRegistry."""
    mesh_id: int = -1
    material_id: int = -1
    skeleton_id: int = -1  # -1 = unskinned
    cast_shadows: bool = True


class LightType:
    DIRECTIONAL = 0
    POINT = 1
    SPOT = 2


@dataclasses.dataclass
class Light:
    """Reference analogue: LightInfo (ShaderBuffers.h:377-404)."""
    type: int = LightType.POINT
    color: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(3, np.float32))
    intensity: float = 1.0
    range: float = 25.0
    inner_cone: float = 0.4       # radians (spot)
    outer_cone: float = 0.6       # radians (spot)
    cast_shadows: bool = False

    def __post_init__(self):
        self.color = _v3(self.color)


@dataclasses.dataclass
class Camera:
    fov_y: float = 1.0471975512  # 60 deg
    near: float = 0.1
    far: Optional[float] = None  # None = infinite reverse-Z
    aspect: float = 16.0 / 9.0


class PrimaryCamera:
    """Tag component marking the active camera."""


@dataclasses.dataclass
class SkinnedInstance:
    """Links a renderable to a skeleton instance (SkeletonManager analogue)."""
    skeleton_id: int = -1
    joint_offset: int = 0


# Tag names (string tags in our ECS)
TAG_ACTIVE_SCENE = "ActiveScene"
TAG_SCENE_ROOT = "SceneRoot"
TAG_TRANSFORM_DIRTY = "RenderTransformUpdated"  # reference: Renderer.cpp:1889-1895
