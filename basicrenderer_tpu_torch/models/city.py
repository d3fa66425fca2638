"""Real-content benchmark scene: the authored city-block GLB ingested
through the importer and the cluster-LOD build.

Port of basicrenderer_tpu/models/city.py, copied with its behaviour
unchanged: bench.py's own scene. The asset (assets/city.glb, authored by
tools/make_city.py, which ensure_city_glb runs only when the file is
missing) is a multi-MB binary glTF with embedded PNG textures, alpha-MASK
foliage and instanced prototypes; load_city imports it through
models/importers.py, builds a cluster-LOD DAG for every mesh of at least
`min_lod_tris` triangles (models/clusters.py), and adds the sun, the 12
lamp lights and an optional seeded field of point lights. finish_city is
those last steps alone, for the city's meshes imported another way (a USD
crate written by models/usdc.export_meshes_usdc, chip_smoke.py phase 17).
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Optional

import numpy as np

from ..scene.scene import Scene
from .animation import SkeletonRegistry
from .materials import MaterialRegistry
from .mesh import MeshRegistry
from .scenes import BuiltScene
from .textures import TextureRegistry

DEFAULT_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "assets", "city.glb")


def ensure_city_glb(path: str = DEFAULT_PATH, subdiv: int = 8) -> str:
    """Author the GLB if it does not exist yet (cached on disk)."""
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        subprocess.run(
            [sys.executable, os.path.join(repo, "tools", "make_city.py"),
             path, "--subdiv", str(subdiv)],
            check=True)
    return path


def load_city(path: str = DEFAULT_PATH, lod: bool = True,
              textures: Optional[TextureRegistry] = None,
              num_point_lights: int = 0, subdiv: int = 8,
              min_lod_tris: int = 4096, seed: int = 9,
              glass_blend: bool = False, displace: bool = False,
              registries=None) -> BuiltScene:
    """Import the city GLB, attach cluster-LOD DAGs to every heavy mesh,
    and light it (sun + lamp points + an optional extra light field).

    `glass_blend` converts the window-glass material to OpenPBR
    transmission (alpha-BLEND class -> the OIT peel: every pane becomes
    deep-transparency content). `displace` gives the cobbled ground a
    Reyes displacement (micro-tessellated bumps). `registries` supplies
    external (meshes, materials, skeletons) — e.g. a Renderer's — so the
    streaming bench can drive the full Renderer loop on this scene."""
    from .importers import load_model

    ensure_city_glb(path, subdiv)
    scene = Scene()
    if registries is not None:
        meshes, materials, skeletons = registries
    else:
        meshes, materials, skeletons = (MeshRegistry(), MaterialRegistry(),
                                        SkeletonRegistry())
    textures = textures if textures is not None else TextureRegistry(256)
    load_model(path, scene, meshes, materials, skeletons, textures=textures)
    if glass_blend:
        for m in materials.materials:
            if m.name == "glass":
                m.transmission_weight = 0.9
                m.transmission_color = np.asarray([0.55, 0.7, 0.65],
                                                  np.float32)
                m.ior = 1.5
                m.roughness = 0.05
    if displace:
        for m in materials.materials:
            if m.name == "cobble":
                m.displacement_scale = 0.12
                m.displacement_texture = m.base_color_texture

    return finish_city(scene, meshes, materials, lod, num_point_lights,
                       min_lod_tris, seed)


def finish_city(scene: Scene, meshes: MeshRegistry,
                materials: MaterialRegistry, lod: bool = True,
                num_point_lights: int = 0, min_lod_tris: int = 4096,
                seed: int = 9) -> BuiltScene:
    """load_city's steps after the import, for the city's meshes however
    they were imported (the glb, or a USD crate export of it): the LOD
    DAGs of the heavy meshes, the sun, the 12 lamps, the optional light
    field and the hero camera."""
    if lod:
        from . import clusters
        for i, m in enumerate(meshes.meshes):
            if len(m.indices) >= min_lod_tris and m.tri_cluster is None:
                built = clusters.build_cluster_lod(m)
                nm = clusters.to_mesh_data(built, name=m.name)
                meshes.meshes[i] = nm

    # Sun + sky-ish fill.
    scene.create_directional_light(direction=(-0.45, -1.0, -0.3),
                                   color=(1.0, 0.96, 0.9), intensity=3.0)
    # Lamp glow points (tools/make_city.py places 12 lamps on a r=14 ring).
    for i in range(12):
        a = (i + 0.5) / 12 * 2 * np.pi
        scene.create_point_light(
            position=(float(np.cos(a) * 14), 3.6, float(np.sin(a) * 14)),
            color=(1.0, 0.85, 0.6), intensity=8.0, range=12.0)
    # Optional dense light field (the 1k-light clustered bench).
    rng = np.random.default_rng(seed)
    for _ in range(num_point_lights):
        scene.create_point_light(
            position=(float(rng.uniform(-40, 40)),
                      float(rng.uniform(0.5, 12.0)),
                      float(rng.uniform(-40, 40))),
            color=tuple(float(c) for c in rng.uniform(0.3, 1.0, 3)),
            intensity=float(rng.uniform(2.0, 8.0)),
            range=float(rng.uniform(4.0, 10.0)))

    # Street-level hero camera: down the plaza toward the arcade fronts.
    scene.set_camera(position=(20.0, 4.0, 26.0), target=(-6.0, 3.0, -8.0),
                     fov_y=1.05, near=0.1)

    num_tris = 0
    from ..scene.components import Renderable
    for _e, (r,) in scene.world.query(Renderable):
        num_tris += len(meshes.meshes[r.mesh_id].indices)
    scene.propagate_transforms()
    return BuiltScene(scene, meshes, materials, num_tris)
