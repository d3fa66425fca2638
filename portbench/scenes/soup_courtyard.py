"""A procedural courtyard, made by the benchmark itself: a rolling
terrain and a grid of UV spheres, cubes and tori, each object its own
mesh (so the frame draws it on the soup visibility buffer, one instance
a mesh), lit by one sun.

`build(params, seed)` returns the scene as plain data that both sides
take as it is: the port (harness.build_program) and the plain reference
(portbench/reference/). `seed` draws each object's place, height, scale
and turn; the meshes, and so the triangle count, are the same for every
seed.

    meshes:    [{"positions" (V, 3) f32, "normals" (V, 3) f32,
                 "indices" (T, 3) i32}]  (front faces counter-clockwise)
    materials: [{"base_color" [r, g, b], "metallic", "roughness"}]
    objects:   [{"mesh", "material", "position" [x, y, z], "yaw" (radians
                 about +y), "scale" (uniform)}]
    sun:       {"direction" [x, y, z], "color" [r, g, b], "intensity"}
"""

from __future__ import annotations

import numpy as np

PALETTE = [
    ([0.8, 0.15, 0.1], 0.0, 0.35), ([0.1, 0.5, 0.8], 0.0, 0.2),
    ([0.9, 0.75, 0.3], 1.0, 0.25), ([0.2, 0.7, 0.25], 0.0, 0.6),
    ([0.85, 0.85, 0.9], 1.0, 0.1), ([0.6, 0.3, 0.7], 0.0, 0.5),
    ([0.95, 0.55, 0.15], 0.0, 0.4), ([0.35, 0.35, 0.4], 1.0, 0.55),
]
GROUND = ([0.45, 0.42, 0.38], 0.0, 0.95)
SUN = {"direction": [-0.45, -1.0, -0.3], "color": [1.0, 0.96, 0.9],
       "intensity": 3.0}


def _mesh(pos, nrm, idx):
    """Drops zero-area triangles and turns each so that its corners run
    counter-clockwise about its vertices' normals."""
    pos = np.asarray(pos, np.float64)
    idx = np.asarray(idx, np.int64)
    a, b, c = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    g = np.cross(b - a, c - a)
    idx = idx[np.linalg.norm(g, axis=1) > 1e-12]
    g = g[np.linalg.norm(g, axis=1) > 1e-12]
    flip = np.sum(g * np.asarray(nrm)[idx].sum(axis=1), axis=1) < 0
    idx[flip] = idx[flip][:, [0, 2, 1]]
    return {"positions": pos.astype(np.float32),
            "normals": np.asarray(nrm, np.float32),
            "indices": idx.astype(np.int32)}


def _grid_quads(rows: int, cols: int):
    """Two triangles a quad of a (rows + 1) x (cols + 1) vertex grid."""
    i, j = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    v00 = (i * (cols + 1) + j).ravel()
    v01, v10 = v00 + 1, v00 + cols + 1
    v11 = v10 + 1
    return np.concatenate([np.stack([v00, v10, v11], 1),
                           np.stack([v00, v11, v01], 1)])


def terrain(size: float, segments: int, height: float):
    """A rolling ground of size x size in x and z, four octaves of sines,
    normals from the height field's gradient."""
    t = np.linspace(-size / 2, size / 2, segments + 1)
    z, x = np.meshgrid(t, t, indexing="ij")
    y = np.zeros_like(x)
    gx = np.zeros_like(x)
    gz = np.zeros_like(x)
    for k, (fx, fz, ph) in enumerate(((0.21, 0.17, 0.3), (0.53, -0.41, 1.1),
                                      (1.3, 0.9, 2.0), (2.7, -2.3, 0.7))):
        amp = height * 0.5 ** (k + 1)
        arg = fx * x + fz * z + ph
        y += amp * np.sin(arg)
        gx += amp * fx * np.cos(arg)
        gz += amp * fz * np.cos(arg)
    pos = np.stack([x, y, z], -1).reshape(-1, 3)
    nrm = np.stack([-gx, np.ones_like(x), -gz], -1).reshape(-1, 3)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return _mesh(pos, nrm, _grid_quads(segments, segments))


def uv_sphere(radius: float, rings: int, sectors: int):
    th, ph = np.meshgrid(np.linspace(0, np.pi, rings + 1),
                         np.linspace(0, 2 * np.pi, sectors + 1),
                         indexing="ij")
    nrm = np.stack([np.sin(th) * np.cos(ph), np.cos(th),
                    np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
    return _mesh(radius * nrm, nrm, _grid_quads(rings, sectors))


def torus(major: float, minor: float, rings: int, sides: int):
    u, v = np.meshgrid(np.linspace(0, 2 * np.pi, rings + 1),
                       np.linspace(0, 2 * np.pi, sides + 1), indexing="ij")
    nrm = np.stack([np.cos(v) * np.cos(u), np.sin(v),
                    np.cos(v) * np.sin(u)], -1).reshape(-1, 3)
    ring = np.stack([np.cos(u), np.zeros_like(u), np.sin(u)],
                    -1).reshape(-1, 3)
    return _mesh(major * ring + minor * nrm, nrm, _grid_quads(rings, sides))


def cube(size: float):
    pos, nrm, idx = [], [], []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            n = np.zeros(3)
            n[axis] = sign
            u, w = np.eye(3)[(axis + 1) % 3], np.eye(3)[(axis + 2) % 3]
            base = len(pos)
            for du, dw in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                pos.append(0.5 * size * (n + du * u + dw * w))
                nrm.append(n)
            idx += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return _mesh(pos, nrm, idx)


def build(params: dict, seed: int) -> dict:
    grid = params["grid"]
    s, t = params["sphere"], params["torus"]
    shapes = [lambda: uv_sphere(*s), lambda: cube(params["cube"]),
              lambda: torus(*t)]
    materials = [{"base_color": rgb, "metallic": m, "roughness": r}
                 for rgb, m, r in [GROUND] + PALETTE]
    meshes = [terrain(params["terrain_size"], params["terrain_segments"],
                      params["terrain_height"])]
    objects = [{"mesh": 0, "material": 0, "position": [0.0, 0.0, 0.0],
                "yaw": 0.0, "scale": 1.0}]
    rng = np.random.default_rng(seed)
    for i in range(grid):
        for j in range(grid):
            meshes.append(shapes[(i * grid + j) % len(shapes)]())
            x = (i - grid / 2 + 0.5) * 2.0 + rng.uniform(-0.4, 0.4)
            z = (j - grid / 2 + 0.5) * 2.0 + rng.uniform(-0.4, 0.4)
            y = rng.uniform(0.4, 1.2)
            scale = rng.uniform(0.6, 1.3)
            yaw = rng.uniform(0, 2 * np.pi)
            objects.append({"mesh": len(meshes) - 1,
                            "material": 1 + (i * 3 + j) % len(PALETTE),
                            "position": [x, y, z], "yaw": yaw,
                            "scale": scale})
    return {"meshes": meshes, "materials": materials, "objects": objects,
            "sun": dict(SUN)}
