"""Procedural test geometry: cube, sphere, plane, torus, and benchmark scenes.

The reference's demo content (Zorah/Bistro/San Miguel/Sponza — README.md:41-52)
is not redistributable; these generators produce deterministic stand-in scenes
with comparable triangle counts and material variety for tests and benches.
"""

from __future__ import annotations

import numpy as np

from .mesh import MeshData, compute_normals


def make_plane(size: float = 1.0, segments: int = 1) -> MeshData:
    """XZ plane centered at origin, +Y normal."""
    s = segments
    xs = np.linspace(-size / 2, size / 2, s + 1)
    zs = np.linspace(-size / 2, size / 2, s + 1)
    gx, gz = np.meshgrid(xs, zs, indexing="xy")
    pos = np.stack([gx, np.zeros_like(gx), gz], axis=-1).reshape(-1, 3)
    uv = np.stack([(gx / size + 0.5), (gz / size + 0.5)], axis=-1).reshape(-1, 2)
    idx = []
    for j in range(s):
        for i in range(s):
            a = j * (s + 1) + i
            b = a + 1
            c = a + (s + 1)
            d = c + 1
            # Wind so the +Y face survives backface culling (CCW seen from +Y).
            idx += [[a, c, b], [b, c, d]]
    nrm = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (pos.shape[0], 1))
    return MeshData(pos, nrm, uv.astype(np.float32), np.array(idx, np.int32), name="plane")


def make_cube(size: float = 1.0) -> MeshData:
    """Axis-aligned cube with per-face normals/uvs (24 verts, 12 tris)."""
    h = size / 2
    faces = [
        # normal, up, right
        (np.array([0, 0, 1.0]), np.array([0, 1.0, 0]), np.array([1.0, 0, 0])),
        (np.array([0, 0, -1.0]), np.array([0, 1.0, 0]), np.array([-1.0, 0, 0])),
        (np.array([1.0, 0, 0]), np.array([0, 1.0, 0]), np.array([0, 0, -1.0])),
        (np.array([-1.0, 0, 0]), np.array([0, 1.0, 0]), np.array([0, 0, 1.0])),
        (np.array([0, 1.0, 0]), np.array([0, 0, -1.0]), np.array([1.0, 0, 0])),
        (np.array([0, -1.0, 0]), np.array([0, 0, 1.0]), np.array([1.0, 0, 0])),
    ]
    pos, nrm, uv, idx = [], [], [], []
    for f, (n, up, right) in enumerate(faces):
        base = len(pos)
        for du, dv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
            pos.append(n * h + right * du * h + up * dv * h)
            nrm.append(n)
            uv.append([(du + 1) / 2, 1 - (dv + 1) / 2])
        # CCW when viewed from outside (normal toward viewer).
        idx += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return MeshData(np.array(pos, np.float32), np.array(nrm, np.float32),
                    np.array(uv, np.float32), np.array(idx, np.int32), name="cube")


def make_uv_sphere(radius: float = 0.5, rings: int = 16, sectors: int = 32) -> MeshData:
    phi = np.linspace(0, np.pi, rings + 1)
    theta = np.linspace(0, 2 * np.pi, sectors + 1)
    p, t = np.meshgrid(phi, theta, indexing="ij")
    x = np.sin(p) * np.cos(t)
    y = np.cos(p)
    z = np.sin(p) * np.sin(t)
    pos = np.stack([x, y, z], -1).reshape(-1, 3) * radius
    nrm = pos / max(radius, 1e-9)
    uv = np.stack([t / (2 * np.pi), p / np.pi], -1).reshape(-1, 2)
    idx = []
    for i in range(rings):
        for j in range(sectors):
            a = i * (sectors + 1) + j
            b = a + sectors + 1
            # outward-facing CCW
            idx += [[a, a + 1, b], [a + 1, b + 1, b]]
    return MeshData(pos.astype(np.float32), nrm.astype(np.float32),
                    uv.astype(np.float32), np.array(idx, np.int32), name="sphere")


def make_torus(major: float = 0.6, minor: float = 0.25, rings: int = 24, sides: int = 16) -> MeshData:
    u = np.linspace(0, 2 * np.pi, rings + 1)
    v = np.linspace(0, 2 * np.pi, sides + 1)
    gu, gv = np.meshgrid(u, v, indexing="ij")
    cx, cz = np.cos(gu) * major, np.sin(gu) * major
    x = (major + minor * np.cos(gv)) * np.cos(gu)
    z = (major + minor * np.cos(gv)) * np.sin(gu)
    y = minor * np.sin(gv)
    pos = np.stack([x, y, z], -1).reshape(-1, 3)
    cen = np.stack([cx, np.zeros_like(cx), cz], -1).reshape(-1, 3)
    nrm = pos - cen
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    uv = np.stack([gu / (2 * np.pi), gv / (2 * np.pi)], -1).reshape(-1, 2)
    idx = []
    for i in range(rings):
        for j in range(sides):
            a = i * (sides + 1) + j
            b = a + sides + 1
            idx += [[a, b, a + 1], [a + 1, b, b + 1]]
    return MeshData(pos.astype(np.float32), nrm.astype(np.float32),
                    uv.astype(np.float32), np.array(idx, np.int32), name="torus")


def make_fractal_terrain(size: float = 50.0, segments: int = 128, height: float = 4.0,
                         seed: int = 7) -> MeshData:
    """Value-noise heightfield — a Sponza-courtyard-scale floor stand-in."""
    rng = np.random.default_rng(seed)
    h = np.zeros((segments + 1, segments + 1))
    freq, amp = 4, 1.0
    for _ in range(5):
        g = rng.standard_normal((freq + 1, freq + 1))
        xi = np.linspace(0, freq, segments + 1)
        # bilinear upsample
        x0 = np.floor(xi).astype(int).clip(0, freq - 1)
        fx = xi - x0
        row = g[x0] * (1 - fx)[:, None] + g[x0 + 1] * fx[:, None]
        col = row[:, x0] * (1 - fx)[None, :] + row[:, x0 + 1] * fx[None, :]
        h += col * amp
        freq *= 2
        amp *= 0.5
    h = h / np.abs(h).max() * height
    mesh = make_plane(size, segments)
    pos = mesh.positions.reshape(segments + 1, segments + 1, 3).copy()
    pos[..., 1] = h.astype(np.float32)
    pos = pos.reshape(-1, 3)
    nrm = compute_normals(pos, mesh.indices)
    return MeshData(pos, nrm, mesh.uvs, mesh.indices, name="terrain")
