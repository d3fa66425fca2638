"""The rank side of tests/test_torch_parallel.py: the scenes and
FrameConfigs of tests/test_parallel.py built from the port's modules,
and the function each spawned rank runs (it imports neither jax nor the
JAX package, so a rank starts in a few seconds)."""

import dataclasses

import numpy as np
import torch

from tests.test_torch_bridge import PORT_PKG, build_scene

BASE = dict(width=128, height=128, tile_h=16, tile_w=128, max_pairs=1 << 12)
FULL = dict(enable_clod=True, max_visible_clusters=128, enable_shadows=True,
            num_cascades=2, shadow_resolution=128, enable_clustered=True,
            max_lights_per_cluster=8, enable_ibl=True, enable_gtao=True,
            enable_bloom=True, enable_auto_exposure=True)
VSM = dict(enable_clod=True, max_visible_clusters=128, enable_vsm=True,
           shadow_clusters=64)
STREAMING = dict(enable_clod=True, max_visible_clusters=64,
                 enable_streaming=True, enable_textures=True,
                 tex_channels=("base",), enable_texture_streaming=True)
OIT = dict(enable_clod=True, max_visible_clusters=64, enable_oit=True,
           oit_layers=2, oit_clusters=32)

# Every pass a shard runs on rows it gathers or takes halo rows for:
# normal maps and anisotropy (screen derivatives), the IBL's and the voxel
# fallback's upsample, the TAA clamp (the VSM converging between the two
# frames changes the history), GTAO, bloom, exposure, SSR.
SEAMS = dict(enable_clod=True, max_visible_clusters=128,
             enable_textures=True, tex_channels=("base", "normal", "mr"),
             enable_ibl=True, enable_taa=True, enable_vsm=True,
             shadow_clusters=64, enable_aniso=True, enable_gtao=True,
             enable_bloom=True, enable_auto_exposure=True, enable_ssr=True)
VOXEL = dict(enable_voxel_fallback=True, voxel_primary_steps=24,
             voxel_rt_downscale=2)
# Textures and an alpha-MASK pass at texture_downscale 2 on 48-row shards:
# 24 sampling rows a shard, so the sampler's 16-row blocks of the second
# shard start 8 rows off the whole frame's.
MASKED = dict(height=96, enable_clod=True, max_visible_clusters=16,
              enable_textures=True, tex_channels=("base",),
              enable_alpha_mask=True, mask_clusters=16)

# name -> (scene, FrameConfig fields, frames). A frame of a case with TAA
# takes the previous frame's taa_out, one with VSM its vsm_state (the
# first: a fresh page cache).
CASES = {
    "basic": ("basic", BASE, 1),
    "basic_120": ("basic", dict(BASE, height=120), 1),
    "full": ("basic", dict(BASE, **FULL), 1),
    "taa": ("basic", dict(BASE, enable_taa=True), 2),
    "basic_64": ("basic", dict(BASE, height=64), 1),
    "vsm": ("basic", dict(BASE, **VSM), 2),
    "streaming": ("streaming", dict(BASE, **STREAMING), 1),
    "oit": ("oit", dict(BASE, **OIT), 1),
    "seams": ("textured", dict(BASE, **SEAMS), 2),
    "seams_full_rate": ("textured", dict(BASE, **SEAMS,
                                         texture_downscale=1), 1),
    "seams_voxel": ("voxel", dict(BASE, **VOXEL), 1),
    "masked": ("masked", dict(BASE, **MASKED), 1),
}
# The cases held to the port's own single-card frame, bit for bit.
AGAINST_PORT = ("seams", "seams_full_rate", "seams_voxel")
KEEP = ("image", "vis", "depth", "touched_groups", "tex_wanted")


def streaming_scene(root):
    """tests/test_parallel.py's streaming scene from `root`'s modules: a
    cluster-LOD sphere with a checkered base colour."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    clusters, procedural = mod("models.clusters"), mod("models.procedural")
    Material = mod("models.materials").Material
    meshes, mats = mod("models.mesh").MeshRegistry(), \
        mod("models.materials").MaterialRegistry()
    tex = mod("models.textures").TextureRegistry(resolution=64)
    checker = tex.checkerboard()
    lod = clusters.build_cluster_lod(
        procedural.make_uv_sphere(1.0, rings=24, sectors=48),
        use_cache=False)
    sphere = meshes.add(clusters.to_mesh_data(lod))
    red = mats.add(Material(base_color=np.array([0.8, 0.2, 0.2, 1],
                                                np.float32),
                            base_color_texture=checker))
    sc = mod("scene.scene").Scene()
    sc.create_renderable(sphere, red, position=(0, 1, 0))
    sc.create_directional_light(direction=(-0.4, -1, -0.3), intensity=3.0)
    sc.set_camera(position=(3, 2.5, 4), target=(0, 1, 0), aspect=1.0)
    sc.propagate_transforms()
    b = mod("scene.bridge")
    caps = b.BridgeCapacities(max_vertices=1 << 14, max_triangles=1 << 14,
                              max_objects=8, max_materials=8, max_lights=4,
                              max_clusters=512, max_geom_clusters=256,
                              max_groups=256)
    return sc, b.SceneRenderBridge(sc, meshes, mats, caps, textures=tex)


def oit_scene(root):
    """tests/test_parallel.py's OIT scene from `root`'s modules: a glass
    cube over a plane."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    procedural = mod("models.procedural")
    Material = mod("models.materials").Material
    meshes, mats = mod("models.mesh").MeshRegistry(), \
        mod("models.materials").MaterialRegistry()
    cube = meshes.add(procedural.make_cube(1.0))
    plane = meshes.add(procedural.make_plane(10.0, 2))
    gray = mats.add(Material(base_color=np.array([0.5, 0.5, 0.5, 1],
                                                 np.float32), roughness=0.9))
    glass = mats.add(Material(base_color=np.array([0.4, 0.6, 0.9, 0.45],
                                                  np.float32),
                              alpha_blend=True, roughness=0.1))
    sc = mod("scene.scene").Scene()
    sc.create_renderable(plane, gray)
    sc.create_renderable(cube, glass, position=(0, 0.6, 0))
    sc.create_directional_light(direction=(-0.4, -1, -0.3), intensity=3.0)
    sc.set_camera(position=(3, 2.5, 4), target=(0, 0.5, 0), aspect=1.0)
    sc.propagate_transforms()
    b = mod("scene.bridge")
    caps = b.BridgeCapacities(max_vertices=1 << 10, max_triangles=1 << 10,
                              max_objects=16, max_materials=8, max_lights=4)
    return sc, b.SceneRenderBridge(sc, meshes, mats, caps)


def textured_scene(root):
    """A normal-mapped checkered floor (base, normal and
    metallic-roughness maps), an anisotropic LOD sphere and a cube under
    a directional light, from `root`'s modules."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    clusters, procedural = mod("models.clusters"), mod("models.procedural")
    Material = mod("models.materials").Material
    meshes, mats = mod("models.mesh").MeshRegistry(), \
        mod("models.materials").MaterialRegistry()
    tex = mod("models.textures").TextureRegistry(resolution=64)
    r = tex.resolution
    yy, xx = np.mgrid[0:r, 0:r].astype(np.float32) / r
    bump = np.sin(xx * 25.0) * np.cos(yy * 25.0) * 0.35
    nrm = np.stack([bump, np.roll(bump, 5, 0),
                    np.sqrt(np.clip(1 - 2 * bump ** 2, 0.05, 1))], -1)
    orm = np.stack([np.ones_like(xx), 0.5 + 0.45 * np.sin(xx * 13.0),
                    (yy > 0.5).astype(np.float32)], -1)
    floor = mats.add(Material(
        base_color=np.array([0.7, 0.7, 0.72, 1], np.float32),
        roughness=0.25, metallic=0.1, base_color_texture=tex.checkerboard(),
        normal_texture=tex.add(nrm * 0.5 + 0.5, srgb=False),
        metallic_roughness_texture=tex.add(orm, srgb=False)))
    brushed = mats.add(Material(
        base_color=np.array([0.9, 0.6, 0.25, 1], np.float32),
        roughness=0.35, metallic=0.8, anisotropy_strength=0.8,
        anisotropy_rotation=0.6))
    sphere = meshes.add(clusters.to_mesh_data(clusters.build_cluster_lod(
        procedural.make_uv_sphere(0.8, rings=16, sectors=32),
        use_cache=False)))
    plane = meshes.add(procedural.make_plane(8.0, 2))
    cube = meshes.add(procedural.make_cube(0.7))
    sc = mod("scene.scene").Scene()
    sc.create_renderable(plane, floor)
    sc.create_renderable(sphere, brushed, position=(0, 0.8, 0))
    sc.create_renderable(cube, floor, position=(-1.4, 0.35, 0.6))
    sc.create_directional_light(direction=(-0.5, -1, -0.35), intensity=2.5)
    sc.set_camera(position=(2.5, 2.0, 3.5), target=(0, 0.5, 0), aspect=1.0)
    sc.propagate_transforms()
    b = mod("scene.bridge")
    caps = b.BridgeCapacities(max_vertices=1 << 13, max_triangles=1 << 13,
                              max_objects=8, max_materials=8, max_lights=4,
                              max_clusters=256)
    return sc, b.SceneRenderBridge(sc, meshes, mats, caps, textures=tex)


def voxel_scene(root):
    """tests/test_torch_voxels.py's fallback scene, the camera raised: a
    large emissive cube whose voxel pyramid (n = 32) the frame marches."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    Material = mod("models.materials").Material
    meshes, mats = mod("models.mesh").MeshRegistry(), \
        mod("models.materials").MaterialRegistry()
    cube = meshes.add(mod("models.procedural").make_cube(1.0))
    red = mats.add(Material(
        base_color=np.array([0.9, 0.1, 0.1, 1], np.float32),
        emissive=np.array([2.0, 0.1, 0.1], np.float32)))
    sc = mod("scene.scene").Scene()
    sc.create_renderable(cube, red, position=(0, 0, 0), scale=(4, 4, 4))
    # The cube's top edge crosses the middle rows, the 2-rank seam.
    sc.set_camera(position=(0, 2, 9), target=(0, 2, 0), aspect=1.0)
    sc.create_directional_light(direction=(-0.3, -1.0, -0.2), intensity=2.0)
    sc.propagate_transforms()
    b = mod("scene.bridge")
    caps = b.BridgeCapacities(max_vertices=1 << 11, max_triangles=1 << 11,
                              max_objects=8, max_materials=4, max_lights=4,
                              max_clusters=16)
    return sc, b.SceneRenderBridge(sc, meshes, mats, caps)


def masked_scene(root):
    """An alpha-MASK floor (round holes, tiled 16 times, cutoff 0.5) over a blue backdrop, both wider than the view, seen from above
    at an angle, so that the sampler's mips change down the screen; from
    `root`'s modules."""
    import dataclasses
    import importlib

    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    Material = mod("models.materials").Material
    meshes, mats = mod("models.mesh").MeshRegistry(), \
        mod("models.materials").MaterialRegistry()
    tex = mod("models.textures").TextureRegistry(resolution=64)
    yy, xx = np.mgrid[0:64, 0:64]
    img = np.ones((64, 64, 4), np.float32)
    # Round holes (alpha 0) of radius 5 texels, 16 texels apart: the
    # coarse mips average about 0.7, clear of the cutoff.
    hole = np.hypot(xx % 16 - 7.5, yy % 16 - 7.5)
    img[..., 3] = np.clip((hole - 5.0) / 2.0 + 0.5, 0.0, 1.0)
    leaf = mats.add(Material(
        base_color=np.array([0.1, 0.8, 0.1, 1], np.float32), roughness=0.8,
        alpha_cutoff=0.5, base_color_texture=tex.add(img, srgb=False)))
    blue = mats.add(Material(base_color=np.array([0.1, 0.1, 0.9, 1],
                                                 np.float32), roughness=0.8))
    plane = mod("models.procedural").make_plane(40.0, 4)
    tiled = meshes.add(dataclasses.replace(plane, uvs=plane.uvs * 16))
    sc = mod("scene.scene").Scene()
    sc.create_renderable(meshes.add(plane), blue, position=(0, -0.5, 0))
    sc.create_renderable(tiled, leaf)
    sc.create_directional_light(direction=(-0.3, -1, -0.2), intensity=3.0)
    sc.set_camera(position=(0, 2.5, 2.5), target=(0, 0, -0.5), aspect=4 / 3)
    sc.propagate_transforms()
    b = mod("scene.bridge")
    caps = b.BridgeCapacities(max_vertices=1 << 8, max_triangles=1 << 8,
                              max_objects=4, max_materials=4, max_lights=2,
                              max_clusters=16, max_geom_clusters=16)
    return sc, b.SceneRenderBridge(sc, meshes, mats, caps, textures=tex)


def make_scene(root, name):
    builders = {"streaming": streaming_scene, "oit": oit_scene,
                "textured": textured_scene, "voxel": voxel_scene,
                "masked": masked_scene}
    if name == "basic":
        return build_scene(root, "basic")
    return builders[name](root)


def case_scene(root, name):
    """Case `name`'s (scene, bridge, FrameConfig fields, frames) from
    `root`'s modules. The voxel case's fields name its voxel pyramid; its
    caller drops every triangle (buffers' tri_object -1), so that every
    pixel takes the voxel fallback."""
    scene, fields, frames = CASES[name]
    sc, bridge = make_scene(root, scene)
    if scene == "voxel":
        vox = bridge.build_voxel_scene(n=32)
        fields = dict(fields, voxel_n=vox.n,
                      voxel_level_offsets=vox.level_offsets)
    return sc, bridge, fields, frames


def port_frames(name, frame_fn, device="cpu"):
    """Run case `name` through `frame_fn(config)` (a frame builder: the
    sharded or the single-card one); the last frame's outputs."""
    from basicrenderer_tpu_torch.graph.framedata import (FrameConfig,
                                                         FrameParams,
                                                         make_view)
    from basicrenderer_tpu_torch.ops import vsm as vsm_ops
    sc, bridge, fields, frames = case_scene(PORT_PKG, name)
    cfg = FrameConfig(**fields)
    buf = bridge.build_scene_buffers(device=device)
    if CASES[name][0] == "voxel":
        buf = dataclasses.replace(buf, tri_object=torch.full_like(
            buf.tri_object, -1))
    view = make_view(*sc.camera_matrices(aspect=cfg.width / cfg.height),
                     device=device)
    params = FrameParams.default(device)
    frame = frame_fn(cfg)
    hist = None
    st = vsm_ops.init_state(device=device) if cfg.enable_vsm else None
    for _ in range(frames):
        out = frame(buf, view, params, taa_history=hist, vsm_state=st)
        hist = out["taa_out"] if cfg.enable_taa else None
        st = out.get("vsm_state")
    return out


def halo_case(rank, n, rows_per=24, ds=2):
    """A random (n * rows_per, 40, 3) image and a (n * rows_per, 40)
    u/v pair: this rank's rows through frame.halo_upsample and
    frame.halo_mipf, gathered, beside the whole-frame resize and mip."""
    from basicrenderer_tpu_torch.graph import frame as pframe
    from basicrenderer_tpu_torch.ops import textures as tex_ops
    from basicrenderer_tpu_torch.parallel.tile_sharding import RowShards
    from basicrenderer_tpu_torch.graph.framedata import FrameConfig
    rng = np.random.default_rng(7)
    h = n * rows_per
    img = torch.as_tensor(rng.random((1, h, 40, 3), np.float32))
    uv = torch.as_tensor(rng.random((h, 40, 2), np.float32)
                         * np.linspace(1, 9, h, dtype=np.float32)[:, None,
                                                                  None])
    rows = RowShards(FrameConfig(width=40, height=h, tile_h=rows_per,
                                 tile_w=40))
    mine = slice(rank * rows_per, (rank + 1) * rows_per)
    up = rows.gather_rows(pframe.halo_upsample(
        img[:, mine], ds, rows_per * ds, 80, row_axis=1,
        rows=rows).movedim(1, 0)).movedim(0, 1)
    mipf = rows.gather_rows(pframe.halo_mipf(uv[mine, :, 0], uv[mine, :, 1],
                                             64, rows))
    M = len(tex_ops.mip_layout(64)[0])
    return {"up": up.numpy(),
            "up_whole": tex_ops.resize_bilinear(img, h * ds, 80,
                                                row_dim=1).numpy(),
            "mipf": mipf.numpy(),
            "mipf_whole": tex_ops.compute_mip(uv, 64, M).numpy()}


def run_cases(rank, n, device, names):
    """Each rank: every case of `names` sharded over the n ranks
    (assembled: rank 0 returns them as numpy), then "halo" if named."""
    from basicrenderer_tpu_torch.graph import frame as pframe
    from basicrenderer_tpu_torch.parallel import tile_sharding as ts
    torch.set_num_threads(1)
    res = {}
    for name in names:
        if name == "halo":
            res[name] = halo_case(rank, n)
            continue
        out = ts.assemble(port_frames(name, ts.build_sharded_frame_fn,
                                      device))
        res[name] = {"keys": sorted(out),
                     **{k: out[k].cpu().numpy() for k in KEEP if k in out}}
        if name in AGAINST_PORT and rank == 0:
            one = port_frames(name, pframe.build_frame_fn, device)
            res[name]["single"] = {k: one[k].cpu().numpy()
                                   for k in ts._SHARDED_KEYS}
            res[name]["sharded"] = {k: out[k].cpu().numpy()
                                    for k in ts._SHARDED_KEYS}
    return res if rank == 0 else None
