"""Interactive camera controllers (host-side, pure numpy).

Host-only copy of basicrenderer_tpu/utils/camera.py.

Reference analogue: the InputManager + camera movement in the demo app
(reference: BasicRenderer/src/Managers/InputManager.cpp, Camera movement in
BasicRenderer.cpp's message loop). Headless-friendly: callers feed key/mouse
deltas; `apply(scene)` pushes the pose into Scene.set_camera each tick —
the same role the reference's WM_INPUT handling plays.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class FlyCamera:
    """WASD + mouse-look free camera (reference: the demo's fly mode)."""
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 2.0, 6.0], np.float64))
    yaw: float = math.pi          # radians; pi looks down -Z
    pitch: float = -0.2
    move_speed: float = 6.0       # units/second
    look_speed: float = 0.003     # radians/pixel

    def forward(self) -> np.ndarray:
        cp = math.cos(self.pitch)
        return np.array([math.sin(self.yaw) * cp, math.sin(self.pitch),
                         math.cos(self.yaw) * cp])

    def right(self) -> np.ndarray:
        return np.array([math.cos(self.yaw), 0.0, -math.sin(self.yaw)])

    def look(self, dx_px: float, dy_px: float) -> None:
        self.yaw -= dx_px * self.look_speed
        self.pitch = float(np.clip(self.pitch - dy_px * self.look_speed,
                                   -1.5, 1.5))

    def move(self, dt: float, forward=0.0, strafe=0.0, up=0.0) -> None:
        """forward/strafe/up in [-1, 1] (W/S, D/A, E/Q)."""
        v = (self.forward() * forward + self.right() * strafe
             + np.array([0.0, 1.0, 0.0]) * up)
        n = np.linalg.norm(v)
        if n > 1e-9:
            self.position = self.position + v / n * (self.move_speed * dt)

    def keys(self, dt: float, pressed) -> None:
        """Apply a WASDQE key set (any iterable of chars)."""
        p = set(k.lower() for k in pressed)
        self.move(dt, forward=("w" in p) - ("s" in p),
                  strafe=("d" in p) - ("a" in p),
                  up=("e" in p) - ("q" in p))

    def apply(self, scene, aspect: float = 16 / 9, fov_y: float = 1.0) -> None:
        scene.set_camera(position=tuple(self.position),
                         target=tuple(self.position + self.forward()),
                         aspect=aspect, fov_y=fov_y)


@dataclasses.dataclass
class OrbitCamera:
    """Target-orbit camera (the showcase/turntable mode)."""
    target: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    distance: float = 8.0
    yaw: float = 0.8
    pitch: float = 0.45
    min_distance: float = 0.5

    def orbit(self, dx_px: float, dy_px: float, speed: float = 0.005) -> None:
        self.yaw += dx_px * speed
        self.pitch = float(np.clip(self.pitch + dy_px * speed, -1.4, 1.4))

    def zoom(self, wheel: float) -> None:
        self.distance = max(self.min_distance,
                            self.distance * math.exp(-wheel * 0.1))

    def position(self) -> np.ndarray:
        cp = math.cos(self.pitch)
        off = np.array([math.cos(self.yaw) * cp, math.sin(self.pitch),
                        math.sin(self.yaw) * cp])
        return self.target + off * self.distance

    def apply(self, scene, aspect: float = 16 / 9, fov_y: float = 1.0) -> None:
        scene.set_camera(position=tuple(self.position()),
                         target=tuple(self.target), aspect=aspect,
                         fov_y=fov_y)
