"""Benchmark / demo scene builders.

Port of basicrenderer_tpu/models/scenes.py::build_courtyard: the same
deterministic scene (same seed, placement, palette, lights, camera) from
the port's own host modules.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..scene.scene import Scene
from .materials import Material, MaterialRegistry
from .mesh import MeshRegistry
from . import procedural


@dataclasses.dataclass
class BuiltScene:
    scene: Scene
    meshes: MeshRegistry
    materials: MaterialRegistry
    num_triangles: int


def build_courtyard(grid: int = 10, seed: int = 42,
                    meshes: Optional[MeshRegistry] = None,
                    materials: Optional[MaterialRegistry] = None,
                    lod: bool = False, textures=None, dense: bool = False,
                    num_point_lights: int = 4) -> BuiltScene:
    """A Sponza-courtyard-style scene: terrain floor + a grid^2 field of
    mixed sphere/cube/torus instances with varied PBR materials + lights.
    With `lod=True` the curved shapes carry cluster-LOD DAGs (the
    virtualized-geometry bench path). Pass a TextureRegistry to give the
    terrain + shapes base-color/normal/roughness maps (bench Config 2).
    `dense=True` swaps in high-tessellation source meshes (Bistro-class
    source complexity: grid=16 dense ~= 2.4M source triangles — the LOD
    build keeps the rendered set bounded). `num_point_lights` scales the
    local-light field (the 1k-light bench)."""
    rng = np.random.default_rng(seed)
    # `is None` (not truthiness): an EMPTY registry passed in (e.g. a fresh
    # Renderer's) must still be used, or the scene's ids point nowhere.
    meshes = MeshRegistry() if meshes is None else meshes
    materials = MaterialRegistry() if materials is None else materials

    if dense:
        terrain = meshes.add(procedural.make_fractal_terrain(
            size=60.0, segments=256, height=2.0))
        sphere_mesh = procedural.make_uv_sphere(0.5, rings=64, sectors=128)
        torus_mesh = procedural.make_torus(0.5, 0.2, rings=96, sides=48)
    else:
        terrain = meshes.add(procedural.make_fractal_terrain(
            size=60.0, segments=96, height=2.0))
        sphere_mesh = procedural.make_uv_sphere(0.5, rings=16, sectors=32)
        torus_mesh = procedural.make_torus(0.5, 0.2, rings=24, sides=12)
    if lod:
        from . import clusters
        sphere_mesh = clusters.to_mesh_data(clusters.build_cluster_lod(sphere_mesh))
        torus_mesh = clusters.to_mesh_data(clusters.build_cluster_lod(torus_mesh))
    sphere = meshes.add(sphere_mesh)
    cube = meshes.add(procedural.make_cube(0.8))
    torus = meshes.add(torus_mesh)
    shapes = [sphere, cube, torus]

    # Optional texture set (base color + tangent-space normal + ORM).
    tex_base = tex_norm = tex_orm = -1
    if textures is not None:
        r = textures.resolution
        yy, xx = np.mgrid[0:r, 0:r].astype(np.float32) / r
        marble = 0.55 + 0.35 * np.sin(xx * 21.0 + 3.5 * np.sin(yy * 9.0))
        base = np.stack([marble, marble * 0.93, marble * 0.85], -1)
        tex_base = textures.add(base.clip(0, 1), srgb=False)
        bump = np.sin(xx * 60.0) * np.cos(yy * 60.0) * 0.35
        nrm = np.stack([bump, np.roll(bump, 7, 0),
                        np.sqrt(np.clip(1 - 2 * bump ** 2, 0.05, 1))], -1)
        tex_norm = textures.add(nrm * 0.5 + 0.5, srgb=False)
        orm = np.stack([np.ones_like(xx), 0.5 + 0.45 * np.sin(xx * 13.0),
                        (yy > 0.5).astype(np.float32)], -1)
        tex_orm = textures.add(orm, srgb=False)

    mat_ids = []
    palette = [
        ([0.8, 0.15, 0.1], 0.0, 0.35), ([0.1, 0.5, 0.8], 0.0, 0.2),
        ([0.9, 0.75, 0.3], 1.0, 0.25), ([0.2, 0.7, 0.25], 0.0, 0.6),
        ([0.85, 0.85, 0.9], 1.0, 0.1), ([0.6, 0.3, 0.7], 0.0, 0.5),
        ([0.95, 0.55, 0.15], 0.0, 0.4), ([0.35, 0.35, 0.4], 1.0, 0.55),
    ]
    for k, (rgb, metal, rough) in enumerate(palette):
        mat_ids.append(materials.add(Material(
            base_color=np.array(rgb + [1.0], np.float32),
            metallic=metal, roughness=rough,
            base_color_texture=tex_base if k % 2 == 0 else -1,
            normal_texture=tex_norm if k % 3 == 0 else -1,
            metallic_roughness_texture=tex_orm if k % 4 == 0 else -1)))
    ground = materials.add(Material(
        base_color=np.array([0.45, 0.42, 0.38, 1.0], np.float32),
        roughness=0.95, base_color_texture=tex_base,
        normal_texture=tex_norm))

    sc = Scene()
    sc.create_renderable(terrain, ground)

    extent = grid * 2.0
    tri_count = meshes.get(terrain).num_triangles
    for i in range(grid):
        for j in range(grid):
            shape = shapes[(i * grid + j) % len(shapes)]
            mat = mat_ids[(i * 3 + j) % len(mat_ids)]
            x = (i - grid / 2 + 0.5) * 2.0 + rng.uniform(-0.4, 0.4)
            z = (j - grid / 2 + 0.5) * 2.0 + rng.uniform(-0.4, 0.4)
            y = rng.uniform(0.4, 1.2)
            s = rng.uniform(0.6, 1.3)
            angle = rng.uniform(0, 2 * np.pi)
            q = np.array([0, np.sin(angle / 2), 0, np.cos(angle / 2)], np.float32)
            sc.create_renderable(shape, mat, position=(x, y, z),
                                 rotation=q, scale=(s, s, s))
            tri_count += meshes.get(shape).num_triangles

    sc.create_directional_light(direction=(-0.45, -1.0, -0.3),
                                color=(1.0, 0.96, 0.9), intensity=3.0)
    # Local light field (num_point_lights=1000 is the many-light bench:
    # reference README.md "1000 dynamic lights").
    for k in range(num_point_lights):
        if k < 4:
            ang = k * np.pi / 2 + 0.4
            p = (np.cos(ang) * 6, 2.5, np.sin(ang) * 6)
            inten, rng_w = 30.0, 14.0
        else:
            p = (rng.uniform(-extent, extent), rng.uniform(0.5, 4.0),
                 rng.uniform(-extent, extent))
            inten, rng_w = 8.0, 4.0
        sc.create_point_light(position=p,
                              color=(1.0, 0.7, 0.4) if k % 2 else (0.4, 0.6, 1.0),
                              intensity=inten, range=rng_w)
    sc.set_camera(position=(grid * 1.1, grid * 0.55, grid * 1.25),
                  target=(0, 0.0, 0), aspect=16 / 9)
    sc.propagate_transforms()
    return BuiltScene(sc, meshes, materials, tri_count)
