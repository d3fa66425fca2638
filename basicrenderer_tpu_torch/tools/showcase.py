"""Render the five BASELINE.json configs through the port's Renderer to
PNGs and print timings.

Port of examples/showcase.py (its configs 1-5; config 6 needs geometry
streaming, which the port does not have yet). Usage:

    python -m basicrenderer_tpu_torch.tools.showcase [outdir] [--small] [--cpu]
    python -m basicrenderer_tpu_torch.tools.showcase --serve [port]

--small renders at 640x360 (default 1920x1080); --cpu renders with the
plain PyTorch versions on the CPU instead of the card. `--serve [port]`
instead starts a live renderer behind the headless UI
(utils/ui_server.py, on 127.0.0.1): open the printed URL to flip
settings, switch debug views and watch telemetry; a telemetry JSON dump
is written to the working directory on exit.

Scene stand-ins are procedural (the reference's Bistro/San Miguel/Zorah
content is not redistributable); each config exercises the same feature
set as its BASELINE.json counterpart.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from ..models import clusters, procedural
from ..models.materials import Material
from ..models.scenes import build_courtyard
from ..renderer import Renderer
from ..scene.bridge import BridgeCapacities
from ..scene.scene import Scene
from ..utils.png import write_png

# Feature settings the configs turn on one by one (all off in the base).
_FEATURES = ("enableShadows", "enableClusteredLighting", "enableIBL",
             "enableBloom", "enableGTAO", "enableTAA", "enableOIT",
             "enableAutoExposure")


def save(r, name, outdir):
    r.update()
    t0 = time.perf_counter()
    img = r.render_to_numpy()
    dt = (time.perf_counter() - t0) * 1e3
    path = os.path.join(outdir, f"{name}.png")
    write_png(path, img)
    print(f"{name}: {img.shape[1]}x{img.shape[0]} first frame {dt:.0f} ms "
          f"-> {path}", flush=True)
    return img


def base_renderer(res, device, lights_cap=1024):
    r = Renderer(caps=BridgeCapacities(
        max_vertices=1 << 18, max_triangles=1 << 18, max_objects=512,
        max_materials=64, max_lights=lights_cap, max_clusters=1 << 17),
        device=device)
    r.settings.set("renderResolution", res)
    r.settings.set("maxTrianglePairs", 1 << 17)
    for k in _FEATURES:
        r.settings.set(k, False)
    return r


def use_scene(r, built):
    """Render `built` (a models.scenes.BuiltScene) with its registries."""
    r.meshes, r.materials = built.meshes, built.materials
    r.set_current_scene(built.scene)


def serve(port: int = 0, device="cuda"):
    """Live mode: courtyard scene + headless settings/telemetry UI."""
    from ..utils.ui_server import UIServer
    r = base_renderer((640, 360), device)
    built = build_courtyard(grid=6, lod=True, meshes=r.meshes,
                            materials=r.materials, textures=r.textures)
    built.scene.propagate_transforms()
    r.settings.set("enableBloom", True)
    r.settings.set("enableClusteredLighting", True)
    r.set_current_scene(built.scene)
    ui = UIServer(r, port=port).start()
    print(f"live UI at {ui.url} — ctrl-C to stop", flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        r.telemetry.dump_json("showcase_telemetry.json")
        print("telemetry dumped to showcase_telemetry.json", flush=True)
        ui.stop()


def render_all(outdir, res, device):
    """Configs 1-5; returns {name: image}."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(0)
    images = {}

    # Config 1 — Forward+: 1 directional light, GGX PBR, no shadows/post.
    r = base_renderer(res, device)
    use_scene(r, build_courtyard(grid=10))
    images["config1_forward"] = save(r, "config1_forward", outdir)

    # Config 2 — Deferred + tiled lighting (1k point/spot) + IBL.
    built = build_courtyard(grid=10)
    sc = built.scene
    for i in range(1000):
        p = rng.uniform(-11, 11, 3)
        p[1] = rng.uniform(0.5, 3)
        col = rng.uniform(0.2, 1.0, 3)
        if i % 4 == 0:
            sc.create_spot_light(position=p, direction=(0, -1, 0), color=col,
                                 intensity=8.0, range=rng.uniform(2, 5))
        else:
            sc.create_point_light(position=p, color=col, intensity=6.0,
                                  range=rng.uniform(1.5, 4))
    sc.propagate_transforms()
    r = base_renderer(res, device)
    r.settings.set("enableClusteredLighting", True)
    use_scene(r, built)
    r.set_environment("procedural")
    images["config2_deferred_1klights_ibl"] = save(
        r, "config2_deferred_1klights_ibl", outdir)

    # Config 3 — cascaded shadows + two-phase HZB occlusion culling.
    r = base_renderer(res, device)
    r.settings.set("enableShadows", True)
    r.settings.set("numShadowCascades", 3)
    r.settings.set("shadowResolution", 1024)
    r.settings.set("enableOcclusionCulling", True)
    use_scene(r, build_courtyard(grid=10))
    images["config3_shadows_occlusion"] = save(
        r, "config3_shadows_occlusion", outdir)

    # Config 4 — visibility-buffer virtualized geometry (cluster-LOD).
    sphere_lod = clusters.build_cluster_lod(
        procedural.make_uv_sphere(0.5, rings=64, sectors=128))
    torus_lod = clusters.build_cluster_lod(
        procedural.make_torus(0.5, 0.2, rings=64, sides=48))
    r = base_renderer(res, device)
    ms = r.meshes.add(clusters.to_mesh_data(sphere_lod))
    mt = r.meshes.add(clusters.to_mesh_data(torus_lod))
    terrain = r.meshes.add(procedural.make_fractal_terrain(120.0, 96, 3.0))
    gray = r.materials.add(Material(
        base_color=np.array([.55, .52, .5, 1], np.float32), roughness=.9))
    mats = [r.materials.add(Material(
        base_color=np.array([*rng.uniform(0.3, 0.9, 3), 1], np.float32),
        roughness=float(rng.uniform(0.3, 0.8)))) for _ in range(8)]
    sc = Scene()
    sc.create_renderable(terrain, gray)
    for i in range(20):
        for j in range(20):
            sc.create_renderable(ms if (i + j) % 2 else mt,
                                 mats[(i * 3 + j) % 8],
                                 position=((i - 10) * 3.0, 0.6,
                                           (j - 10) * 3.0))
    sc.create_directional_light(direction=(-.4, -1, -.3), intensity=3.0)
    sc.set_camera(position=(12, 6, 18), target=(0, 0, 0),
                  aspect=res[0] / res[1])
    sc.propagate_transforms()
    r.set_current_scene(sc)
    r.set_environment("procedural")
    images["config4_virtualized_geometry"] = save(
        r, "config4_virtualized_geometry", outdir)

    # Config 5 — full frame: OIT + GTAO + bloom + TAA + auto-exposure +
    # shadows + tiled lights + IBL.
    built = build_courtyard(grid=10)
    glass = built.materials.add(Material(
        base_color=np.array([0.2, 0.6, 0.9, 0.4], np.float32),
        alpha_blend=True, roughness=0.2))
    pane = built.meshes.add(procedural.make_plane(6.0, 1))
    half = np.pi / 4    # a quarter turn about +x, as (x, y, z, w)
    q = np.array([np.sin(half), 0.0, 0.0, np.cos(half)], np.float32)
    built.scene.create_renderable(pane, glass, position=(0, 2.0, 6.0),
                                  rotation=q)
    built.scene.propagate_transforms()
    r = base_renderer(res, device)
    for k in ("enableShadows", "enableClusteredLighting", "enableBloom",
              "enableGTAO", "enableTAA", "enableOIT", "enableAutoExposure"):
        r.settings.set(k, True)
    r.settings.set("numShadowCascades", 3)
    use_scene(r, built)
    r.set_environment("procedural")
    images["config5_full"] = save(r, "config5_full", outdir)
    # A few extra frames so TAA accumulates.
    for _ in range(4):
        r.update()
        img = r.render_to_numpy()
    write_png(os.path.join(outdir, "config5_full_taa.png"), img)
    images["config5_full_taa"] = img
    print("config5 TAA-converged frame saved", flush=True)
    return images


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else "cuda"
    if "--serve" in argv:
        i = argv.index("--serve")
        port = int(argv[i + 1]) if len(argv) > i + 1 and \
            argv[i + 1].isdigit() else 0
        return serve(port, device)
    outdir = argv[0] if argv and not argv[0].startswith("-") else "showcase"
    res = (640, 360) if "--small" in argv else (1920, 1080)
    render_all(outdir, res, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
