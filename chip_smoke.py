#!/usr/bin/env python3
"""Smoke run of basicrenderer_tpu_torch, the PyTorch + CUDA port, on one
NVIDIA GPU (written for an H100).

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --quick    # phases 1-5 only (build and checks)
    python3 chip_smoke.py --profile  # every phase, then a torch.profiler
                                     # trace of 5 frames of slices 2, 3
                                     # and 3b

Run from the root of a checkout. Phases, one line each:
 1. the card and toolchain;
 2. one build of every kernel (one nvcc per source, all started together);
 3. every kernel against its plain PyTorch version on the card, on small
    inputs: K1 and K2 (plain and seeded) exact on vis and depth, K3 and K4
    within their tolerances, K4's BC3 mode on random BC3 windows and on
    the windows of a BC3-textured 512x512 frame, K5 (the TAA history
    warp) exact on random history at 64x256 and 1088x1920 with shifts
    past the clip limits;
 4. the 128x128 golden scene against tests/goldens/basic_deferred.png and
    against the port on the CPU;
 5. the 512x512 cluster rig (tests/test_goldens_512.py) against
    g512_occlusion.png, g512_clustered.png, g512_gtao_bloom.png,
    g512_taa.png, g512_ssr.png, g512_clod_textured_ibl.png,
    g512_alpha_mask.png (full-rate mask pass) and g512_vsm.png (4 VSM
    steps), its alpha-MASK frame on the card against the port on the CPU,
    and 4-frame moving-camera sequences (graph/temporal.py, motion-vector
    resolve) on the card against the same sequences on the CPU: TAA +
    SSR, then with IBL, then bench.py's `full` toggles (textures with
    normal maps, VSM, IBL, the post stack) once over the RGBA8 atlas and
    once over the BC3 atlas;
 6. slice 1 at full size: the triangle-soup frame of a ~1.36M-triangle
    courtyard at 1920x1080, timed, K1 timed against its plain version;
 7. slice 2 at full size: the cluster-LOD frame of bench.py's
    config1_minimal (two-phase HZB occlusion, clustered lights, alpha-MASK
    pass) over the dense LOD courtyard with 1000 point lights, timed with
    per-stage CUDA events; K2, K3 and K4 timed alone against their plain
    versions on the frame's own inputs;
 8. slice 3 at full size: bench.py's config4_post (GTAO, bloom, TAA,
    auto-exposure, SSR over the config1_minimal base) over the same
    courtyard, the camera orbiting a small angle per frame through
    graph/temporal.py so that K5 warps history every frame after the
    first; timed with per-stage CUDA events; K5 timed alone against its
    plain version and against one torch grid_sample over the same history;
    then the same with IBL over the procedural environment;
 9. slice 3b at full size: bench.py's `full` (config4_post + IBL + texture
    channels base, normal, metallic-roughness + VSM) and `full_bc3` (the
    same over the BC3 atlas, built by a second bridge with
    tex_format="bc3" after the RGBA8 buffers are freed) over the same
    courtyard with the same orbit, so VSM pages go dirty; timed with
    per-stage CUDA events; VSM pages rendered per frame and the raster
    launches they make; K4 per format and K2's VSM page launches checked
    and timed alone against their bounds and plain versions on a frame's
    own inputs; atlas bytes per format; the RMSE of full_bc3 against full;
    each format's peak memory; then `full` with a held camera until the
    VSM cache converges.
Kernel launch counts are reset just before each full-size path is driven
and read just after. Any failed check raises and the exit code is non-zero.
The second-to-last line is the kernels' JSON record and the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero and
prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_RMSE_MAX = 6.0        # tests/test_goldens.py
CHANNEL_RTOL = 1e-6          # raster kernels vs plain: vis and depth exact
SHADE_RTOL, SHADE_ATOL = 1e-3, 1e-4   # K3 vs plain (tests/test_lighting.py)
TEX_ATOL = 1e-3              # K4 vs plain, on the [0, 255] scale (RGBA8
#                              and BC3: the same f32 operations, 0 expected)
WARP_ATOL = 1e-5             # K5 vs plain (the same f32 operations: 0 expected)
# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# f32 operations per unit of work, counted from the kernels' sources: a
# (row, pixel) raster test (three planes at 4 each, e2 2); a (pixel, light)
# of the tiled shade; a pixel of the texture window evaluation.
RASTER_FLOPS_PER_ROW_PIXEL = 14
SHADE_FLOPS_PER_PIXEL_LIGHT = 118
SHADE_FLOPS_PER_PIXEL = 30
TEX_FLOPS_PER_PIXEL = 60
BC3_FLOPS_PER_BLOCK = 90     # K4 BC3, a block's palette: 565 expand (6),
#                              2 colours x 3 and 6 alpha steps at 7 each
#                              (1 - w, 2 products, sum, round, clamp)
BC3_OPS_PER_TEXEL = 4        # K4 BC3, a texel: index fetch and select,
#                              colour and alpha
WARP_FLOPS_PER_VALUE = 9     # K5: two taps x2 rows, then x2 columns
ORBIT_RAD_PER_FRAME = 0.004  # phase 8 camera orbit about the scene's y axis
SLICE1_FRAMES = (2, 10)      # (warm, timed)
SLICE2_FRAMES = (3, 12)
SLICE3_FRAMES = (3, 12)
SLICE3B_FRAMES = (3, 12)
VSM_CONVERGE_FRAMES = 40     # phase 9: static frames allowed to converge


class CheckFailed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


T_START = time.perf_counter()


def say(line):
    """Print a phase line, stamped with the seconds since the start."""
    print(f"[{time.perf_counter() - T_START:.1f} s] {line}", flush=True)


def rmse(a, b):
    import numpy as np
    return float(np.sqrt(np.mean((np.asarray(a, np.float32)
                                  - np.asarray(b, np.float32)) ** 2)))


def bound(flops, nbytes):
    """(bound ms, "operations" | "bytes") at the card's published peaks."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def cuda_ms(torch, fn, reps):
    """Mean ms of `fn()` over `reps` launches by CUDA events, after a warm
    launch."""
    fn()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def host_ms(torch, fn):
    """(result, ms) of one call of `fn()` ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def reset_launches(kernels):
    for k in kernels:
        k.launches = 0


# ---------------------------------------------------------------------------
# Scenes (built from the port's own modules)
# ---------------------------------------------------------------------------

def golden_scene(np):
    """tests/test_frame_e2e.build_test_scene."""
    from basicrenderer_tpu_torch.models import procedural
    from basicrenderer_tpu_torch.models.materials import Material, MaterialRegistry
    from basicrenderer_tpu_torch.models.mesh import MeshRegistry
    from basicrenderer_tpu_torch.scene.bridge import BridgeCapacities, SceneRenderBridge
    from basicrenderer_tpu_torch.scene.scene import Scene
    meshes, mats = MeshRegistry(), MaterialRegistry()
    cube = meshes.add(procedural.make_cube(1.0))
    plane = meshes.add(procedural.make_plane(10.0, 2))
    red = mats.add(Material(name="red", base_color=np.array(
        [0.8, 0.1, 0.1, 1], np.float32), roughness=0.4))
    gray = mats.add(Material(name="gray", base_color=np.array(
        [0.5, 0.5, 0.5, 1], np.float32), roughness=0.9))
    sc = Scene()
    sc.create_renderable(plane, gray)
    sc.create_renderable(cube, red, position=(0, 0.5, 0))
    sc.create_directional_light(direction=(-0.4, -1, -0.3), intensity=3.0)
    sc.set_camera(position=(3, 2.5, 4), target=(0, 0.5, 0), aspect=1.0)
    sc.propagate_transforms()
    caps = BridgeCapacities(max_vertices=1 << 10, max_triangles=1 << 10,
                            max_objects=16, max_materials=16, max_lights=8)
    return sc, SceneRenderBridge(sc, meshes, mats, caps)


def g512_scene(np, fmt="rgba8", maps=False):
    """The shared scene of tests/test_goldens_512.py (without the voxel
    pyramid): a LOD sphere, a cube, a checkered floor, a glass quad, an
    alpha-MASK leaf quad, directional + point + spot lights. With `maps`,
    the floor and the sphere also get a tangent-space normal map and a
    metallic-roughness map (tests/test_torch_full_frame.py's); the atlas
    is stored in `fmt`."""
    from basicrenderer_tpu_torch.models import clusters, procedural
    from basicrenderer_tpu_torch.models.materials import Material, MaterialRegistry
    from basicrenderer_tpu_torch.models.mesh import MeshRegistry
    from basicrenderer_tpu_torch.models.textures import TextureRegistry
    from basicrenderer_tpu_torch.scene.bridge import BridgeCapacities, SceneRenderBridge
    from basicrenderer_tpu_torch.scene.scene import Scene
    half = np.float32(np.pi / 4)
    qx90 = np.array([np.sin(half), 0, 0, np.cos(half)], np.float32)
    meshes, mats = MeshRegistry(), MaterialRegistry()
    tex = TextureRegistry(resolution=64)
    checker = tex.checkerboard(a=(1, 1, 1), b=(0.15, 0.15, 0.15), squares=8)
    r = tex.resolution
    yy, xx = np.mgrid[0:r, 0:r]
    hole = (((yy * 4 // r) + (xx * 4 // r)) % 2).astype(np.float32)
    leaf = tex.add(np.dstack([np.full((r, r), 0.2, np.float32),
                              np.full((r, r), 0.7, np.float32),
                              np.full((r, r), 0.2, np.float32), hole]),
                   srgb=False)
    maps_kw = {}
    if maps:
        yy, xx = np.mgrid[0:r, 0:r].astype(np.float32) / r
        bump = np.sin(xx * 25.0) * np.cos(yy * 25.0) * 0.35
        nrm = np.stack([bump, np.roll(bump, 5, 0),
                        np.sqrt(np.clip(1 - 2 * bump ** 2, 0.05, 1))], -1)
        orm = np.stack([np.ones_like(xx), 0.5 + 0.45 * np.sin(xx * 13.0),
                        (yy > 0.5).astype(np.float32)], -1)
        maps_kw = dict(normal_texture=tex.add(nrm * 0.5 + 0.5, srgb=False),
                       metallic_roughness_texture=tex.add(orm, srgb=False))
    sphere = meshes.add(clusters.to_mesh_data(clusters.build_cluster_lod(
        procedural.make_uv_sphere(0.8, rings=24, sectors=48))))
    plane = meshes.add(procedural.make_plane(8.0, 2))
    cube = meshes.add(procedural.make_cube(0.7))
    quad = meshes.add(procedural.make_plane(1.2, 1))
    floor_m = mats.add(Material(
        base_color=np.array([0.7, 0.7, 0.72, 1], np.float32),
        roughness=0.25, metallic=0.1, base_color_texture=checker, **maps_kw))
    gold_m = mats.add(Material(
        base_color=np.array([0.9, 0.6, 0.25, 1], np.float32),
        roughness=0.35, metallic=0.8, **maps_kw))
    glass_m = mats.add(Material(
        base_color=np.array([0.4, 0.6, 0.9, 0.45], np.float32),
        roughness=0.1, alpha_blend=True))
    leaf_m = mats.add(Material(
        base_color=np.array([1, 1, 1, 1], np.float32), roughness=0.7,
        alpha_cutoff=0.5, base_color_texture=leaf))
    sc = Scene()
    sc.create_renderable(plane, floor_m)
    sc.create_renderable(sphere, gold_m, position=(0, 0.8, 0))
    sc.create_renderable(cube, 0, position=(-1.4, 0.35, 0.6))
    sc.create_renderable(quad, glass_m, position=(0.9, 0.7, 1.2), rotation=qx90)
    sc.create_renderable(quad, leaf_m, position=(-0.6, 0.7, 1.6), rotation=qx90)
    sc.create_directional_light(direction=(-0.5, -1, -0.35), intensity=2.5)
    sc.create_point_light(position=(1.5, 1.8, -0.5), color=(1.0, 0.4, 0.2),
                          intensity=6.0)
    sc.create_spot_light(position=(-2.0, 2.5, 1.5), direction=(0.6, -1, -0.4),
                         intensity=8.0, outer_cone=0.5)
    sc.set_camera(position=(2.6, 2.0, 3.2), target=(0, 0.6, 0), aspect=1.0)
    sc.propagate_transforms()
    caps = BridgeCapacities(max_vertices=1 << 15, max_triangles=1 << 15,
                            max_objects=16, max_materials=8, max_lights=8,
                            max_clusters=1 << 10, max_geom_clusters=1 << 10)
    return sc, SceneRenderBridge(sc, meshes, mats, caps, textures=tex,
                                 tex_format=fmt)


def soup_courtyard(np, grid=12, seed=42):
    """The dense courtyard of basicrenderer_tpu/models/scenes.py:86-140 with
    every object registered as its own mesh (the soup frame draws one
    instance per mesh): fractal terrain (60, 256 segments, height 2) and
    grid^2 objects cycling a 64x128 UV sphere, a 0.8 cube and a 96x48
    torus."""
    from basicrenderer_tpu_torch.models import procedural
    from basicrenderer_tpu_torch.models.materials import Material, MaterialRegistry
    from basicrenderer_tpu_torch.models.mesh import MeshRegistry
    from basicrenderer_tpu_torch.scene.bridge import BridgeCapacities, SceneRenderBridge
    from basicrenderer_tpu_torch.scene.scene import Scene
    rng = np.random.default_rng(seed)
    meshes, mats = MeshRegistry(), MaterialRegistry()
    terrain = meshes.add(procedural.make_fractal_terrain(60.0, 256, 2.0))
    makers = [lambda: procedural.make_uv_sphere(0.5, rings=64, sectors=128),
              lambda: procedural.make_cube(0.8),
              lambda: procedural.make_torus(0.5, 0.2, rings=96, sides=48)]
    palette = [
        ([0.8, 0.15, 0.1], 0.0, 0.35), ([0.1, 0.5, 0.8], 0.0, 0.2),
        ([0.9, 0.75, 0.3], 1.0, 0.25), ([0.2, 0.7, 0.25], 0.0, 0.6),
        ([0.85, 0.85, 0.9], 1.0, 0.1), ([0.6, 0.3, 0.7], 0.0, 0.5),
        ([0.95, 0.55, 0.15], 0.0, 0.4), ([0.35, 0.35, 0.4], 1.0, 0.55),
    ]
    mat_ids = [mats.add(Material(base_color=np.array(rgb + [1.0], np.float32),
                                 metallic=metal, roughness=rough))
               for rgb, metal, rough in palette]
    ground = mats.add(Material(base_color=np.array([0.45, 0.42, 0.38, 1.0],
                                                   np.float32), roughness=0.95))
    sc = Scene()
    sc.create_renderable(terrain, ground)
    for i in range(grid):
        for j in range(grid):
            shape = meshes.add(makers[(i * grid + j) % len(makers)]())
            mat = mat_ids[(i * 3 + j) % len(mat_ids)]
            x = (i - grid / 2 + 0.5) * 2.0 + rng.uniform(-0.4, 0.4)
            z = (j - grid / 2 + 0.5) * 2.0 + rng.uniform(-0.4, 0.4)
            y = rng.uniform(0.4, 1.2)
            s = rng.uniform(0.6, 1.3)
            angle = rng.uniform(0, 2 * np.pi)
            q = np.array([0, np.sin(angle / 2), 0, np.cos(angle / 2)], np.float32)
            sc.create_renderable(shape, mat, position=(x, y, z), rotation=q,
                                 scale=(s, s, s))
    sc.create_directional_light(direction=(-0.45, -1.0, -0.3),
                                color=(1.0, 0.96, 0.9), intensity=3.0)
    for k in range(4):
        ang = k * np.pi / 2 + 0.4
        sc.create_point_light(position=(np.cos(ang) * 6, 2.5, np.sin(ang) * 6),
                              color=(1.0, 0.7, 0.4) if k % 2 else (0.4, 0.6, 1.0),
                              intensity=30.0, range=14.0)
    sc.set_camera(position=(grid * 1.1, grid * 0.55, grid * 1.25),
                  target=(0, 0.0, 0), aspect=16 / 9)
    sc.propagate_transforms()
    nv = sum(meshes.get(m).num_vertices for m in range(len(meshes)))
    nt = sum(meshes.get(m).num_triangles for m in range(len(meshes)))
    ncl = sum((meshes.get(m).num_triangles + 127) // 128
              for m in range(len(meshes)))
    caps = BridgeCapacities(max_vertices=nv, max_triangles=nt,
                            max_objects=grid * grid + 1, max_materials=16,
                            max_lights=8, max_clusters=ncl,
                            max_geom_clusters=ncl)
    return sc, SceneRenderBridge(sc, meshes, mats, caps), nt


def random_groups(torch, np, seed, n, cfg, dev):
    """Random clip-space triangles (tests/test_raster.py's generator) set up
    and group-binned by the port's front end."""
    from basicrenderer_tpu_torch.ops import raster_setup
    rng = np.random.default_rng(seed)
    w = rng.uniform(2.0, 10.0, size=(n, 3, 1)).astype(np.float32)
    xy = rng.uniform(-0.9, 0.9, size=(n, 3, 2)).astype(np.float32) * w
    z = rng.uniform(0.05, 0.95, size=(n, 3, 1)).astype(np.float32) * w
    clip = torch.as_tensor(np.concatenate([xy, z, w], -1).reshape(-1, 4),
                           device=dev)
    idx = torch.arange(3 * n, dtype=torch.int32, device=dev).view(n, 3)
    lanes, bbox, valid, _ = raster_setup.triangle_setup_packed(
        clip, idx, torch.ones(n, dtype=torch.bool, device=dev), cfg,
        None, None)
    return lanes, bbox, valid


# ---------------------------------------------------------------------------
# Kernel-vs-plain comparisons
# ---------------------------------------------------------------------------

def compare_raster(torch, kernel_out, plain_out, label):
    """Raster kernel vs plain: vis and depth exactly, channels within
    CHANNEL_RTOL. Returns the max abs error over depth and channels."""
    kd, kv, kch = kernel_out
    pd, pv, pch = plain_out
    nvis, ndepth = int((kv != pv).sum()), int((kd != pd).sum())
    check(nvis == 0 and ndepth == 0,
          f"{label}: kernel differs from plain on {nvis} vis / {ndepth} depth")
    torch.testing.assert_close(kch, pch, rtol=CHANNEL_RTOL, atol=CHANNEL_RTOL)
    return max(float((kd - pd).abs().max()), float((kch - pch).abs().max()))


def k1_check(torch, pairs, cfg, label):
    from basicrenderer_tpu_torch.ops import raster
    return compare_raster(torch, raster.raster_tiles_cuda(pairs, cfg),
                          raster.raster_tiles_plain(pairs, cfg), label)


def k2_check(torch, pairs, cfg, label, init=None):
    from basicrenderer_tpu_torch.ops import raster
    return compare_raster(torch, raster.raster_groups_cuda(pairs, cfg, 0, init),
                          raster.raster_groups_plain(pairs, cfg, 0, init),
                          label)


def k3_check(torch, args, label):
    from basicrenderer_tpu_torch.ops import lighting
    k = lighting.tiled_shade_cuda(*args)
    p = lighting.tiled_shade_plain(*args)
    try:
        torch.testing.assert_close(k, p, rtol=SHADE_RTOL, atol=SHADE_ATOL)
    except AssertionError as e:
        raise CheckFailed(f"{label}: tiled shade kernel vs plain: {e}")
    return float((k - p).abs().max())


def k4_check(torch, args, label, bc3=False):
    from basicrenderer_tpu_torch.ops import textures
    if bc3:
        k = textures.tex_block_eval_bc3_cuda(*args)
        p = textures.tex_block_eval_bc3_plain(*args)
    else:
        k = textures.tex_block_eval_cuda(*args)
        p = textures.tex_block_eval_plain(*args)
    err = float((k - p).abs().max())
    check(err <= TEX_ATOL, f"{label}: texture kernel vs plain max abs err "
          f"{err} > {TEX_ATOL}")
    return err


def random_bc3_windows(torch, np, seed, dev, jobs=600, npix=256, nrows=200):
    """Random BC3 jobs on `dev`: an atlas of encoder blocks (random texels)
    whose first rows hold raw random words (every bit pattern, both alpha
    modes), random window rows (some outside the atlas: the kernel clamps
    them) and tap centres over every lane and texel row."""
    from basicrenderer_tpu_torch.models.texprocess import bc3_encode
    from basicrenderer_tpu_torch.ops import textures
    rng = np.random.default_rng(seed)
    band = rng.integers(0, 256, (4 * nrows, 128, 4), np.uint8)
    strips = np.ascontiguousarray(bc3_encode(band)).view("<u4") \
        .reshape(nrows, 128).copy()
    strips[:8] = rng.integers(0, 2 ** 32, (8, 128), dtype=np.uint64)
    rows = rng.integers(-2, nrows + 2, (jobs, textures.BC_WROWS)) \
        .astype(np.int32)
    x_hat = (rng.integers(0, 128, (jobs, npix))
             + rng.uniform(0, 1, (jobs, npix))).astype(np.float32)
    x_hat[:, :16] = np.floor(x_hat[:, :16])
    yf = (rng.integers(0, textures.BC_TEXEL_ROWS - 1, (jobs, npix))
          + rng.uniform(0, 1, (jobs, npix))).astype(np.float32)
    return tuple(torch.as_tensor(a, device=dev) for a in
                 (strips.view(np.int32), rows, x_hat, yf))


def bc3_tapped(torch, x_hat, yf):
    """(distinct blocks, distinct texels) of the BC3 windows that the
    pixels' taps read: two lanes (floor(x_hat) and the next, wrapping at
    128) on two texel rows (floor(yf) and the next, inside the window's
    BC_TEXEL_ROWS), per job."""
    from basicrenderer_tpu_torch.ops import textures
    WR = textures.BC_TEXEL_ROWS
    jobs, pix = x_hat.shape
    jid = torch.arange(jobs, device=x_hat.device)[:, None].expand(jobs, pix)
    l0 = torch.floor(x_hat).long() & 127
    r0 = torch.floor(yf).long()
    blocks, texels = [], []
    for r in (r0, r0 + 1):
        ok = (r >= 0) & (r < WR)
        for lane in (l0, (l0 + 1) & 127):
            texels.append(((jid * WR + r) * 128 + lane)[ok])
            blocks.append(((jid * (WR // 4) + r // 4) * 32 + lane // 4)[ok])
    return (int(torch.unique(torch.cat(blocks)).numel()),
            int(torch.unique(torch.cat(texels)).numel()))


def k4_bound(torch, args, bc3):
    """(bound ms, by) of one K4 launch on `args`: each distinct window row
    read once, the per-pixel tap centres read and RGBA written; the
    operations of the pixel evaluation and, for BC3, of decoding what the
    taps read: the palette of each distinct block they touch and each
    distinct texel (at most 4 a pixel)."""
    _strips, rows, x_hat, yf = args[:4]
    jobs, pix = x_hat.shape
    flops = jobs * pix * TEX_FLOPS_PER_PIXEL
    if bc3:
        nblocks, ntexels = bc3_tapped(torch, x_hat, yf)
        flops += nblocks * BC3_FLOPS_PER_BLOCK + ntexels * BC3_OPS_PER_TEXEL
    uniq = int(torch.unique(rows).numel())
    return bound(flops, uniq * 512 + rows.numel() * 4 + x_hat.numel() * 8
                 + jobs * pix * 16)


def k2_bound(raster, pairs, cfg, row0, init):
    """(bound ms, by, (row, tile) pairs walked) of one K2 launch: every
    walked row tested on its tile's pixels, each walked row read once, the
    depth, vis and 8 channels written (and read once more when seeded)."""
    walked = raster.expand_group_pairs(pairs, cfg, row0)[0].shape[0]
    nbytes = walked * 128 + cfg.padded_height * cfg.padded_width * 40 * (
        2 if init is not None else 1)
    b_ms, b_by = bound(walked * cfg.tile_h * cfg.tile_w
                       * RASTER_FLOPS_PER_ROW_PIXEL, nbytes)
    return b_ms, b_by, walked


def random_warp(torch, np, seed, shape, dev, tile=(32, 128)):
    """Random history (H, W, 3) and per-tile shifts on `dev`: uniform over
    +-80 rows / +-220 columns (past the clip limits), the first tiles
    exactly on the limits and on negative fractions."""
    rng = np.random.default_rng(seed)
    H, W = shape
    T = (H // tile[0]) * (W // tile[1])
    dy = rng.uniform(-80, 80, T).astype(np.float32)
    dx = rng.uniform(-220, 220, T).astype(np.float32)
    dy[:4] = (70.0, -70.0, -0.25, -69.5)
    dx[:4] = (190.0, -190.0, -0.75, -189.25)
    hist = rng.random((H, W, 3)).astype(np.float32)
    return (torch.as_tensor(hist, device=dev), torch.as_tensor(dy, device=dev),
            torch.as_tensor(dx, device=dev)) + tile


def k5_check(torch, args, label):
    from basicrenderer_tpu_torch.ops import taa_warp
    k = taa_warp.warp_history_tiles(*args)
    p = taa_warp.warp_history_plain(*args)
    err = float((k - p).abs().max())
    check(err <= WARP_ATOL, f"{label}: history warp kernel vs plain max abs "
          f"err {err} > {WARP_ATOL}")
    return err


def entity_at(np, sc, position):
    """The entity whose Position is `position`."""
    from basicrenderer_tpu_torch.scene.components import Position
    for eid, (pos,) in sc.world.query(Position):
        if np.allclose(pos.value, position):
            return eid
    raise CheckFailed(f"no entity at {position}")


def orbit_camera(np, sc, pos0, target, angle, aspect):
    """Camera at pos0 turned by `angle` about the vertical axis through
    `target`."""
    c, s = np.cos(angle), np.sin(angle)
    d = np.asarray(pos0, np.float64) - target
    sc.set_camera(position=(target[0] + c * d[0] - s * d[2], pos0[1],
                            target[2] + s * d[0] + c * d[2]),
                  target=tuple(target), aspect=aspect)


class Capture:
    """Records the inputs and outputs of every call of the named module
    functions while installed. The functions still run; a kernel wrapper
    counts its launches on the module's name, so the count moves to the
    stand-in while it is installed and back when it is removed."""

    def __init__(self, module, names):
        self.module, self.names, self.calls = module, names, []

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.names}
        for n, fn in self.saved.items():
            def wrapped(*a, _fn=fn, _n=n, **kw):
                out = _fn(*a, **kw)
                self.calls.append((_n, a, kw, out))
                return out
            if hasattr(fn, "launches"):
                wrapped.launches = fn.launches
            setattr(self.module, n, wrapped)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            if hasattr(fn, "launches"):
                fn.launches = getattr(self.module, n).launches
            setattr(self.module, n, fn)


# ---------------------------------------------------------------------------

def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    quick = "--quick" in sys.argv[1:]
    sys.path.insert(0, REPO)
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn, geometry_pass
    from basicrenderer_tpu_torch.graph.framedata import (FrameConfig,
                                                         FrameParams, make_view)
    from basicrenderer_tpu_torch.ops import (lighting, raster, raster_setup,
                                             taa_warp, textures, vsm)
    from basicrenderer_tpu_torch.utils import cuda_build
    from basicrenderer_tpu_torch.utils.png import read_png
    dev = torch.device("cuda", 0)
    kernels = (raster.raster_tiles_cuda, raster.raster_groups_cuda,
               lighting.tiled_shade_cuda, textures.tex_block_eval_cuda,
               taa_warp.warp_history_tiles, textures.tex_block_eval_bc3_cuda)
    t_start = time.perf_counter()

    # -- 1. the card -------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    say(smi)
    say(f"phase 1 card: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f" | torch {torch.__version__} cuda {torch.version.cuda} | nvcc {nvcc}")

    # -- 2. kernel build ---------------------------------------------------
    t0 = time.perf_counter()
    libs = cuda_build.build_all([raster.SOURCE, lighting.SOURCE,
                                 textures.SOURCE, taa_warp.SOURCE])
    reports = []
    for src, lib in libs.items():
        regs = [ln.split("info    : ")[-1] for ln in lib.build_log.splitlines()
                if "registers" in ln or "spill" in ln]
        reports.append(f"{src.name}: {' / '.join(regs) or 'cached'}")
    say(f"phase 2 build: {len(libs)} libraries in {time.perf_counter() - t0:.2f}"
        f" s | ptxas: {' || '.join(reports)}")

    # -- 3. kernels vs plain on the card -----------------------------------
    res = []
    for seed in (0, 5):
        cfg = FrameConfig(width=256, height=64, tile_h=16, tile_w=128,
                          max_pairs=1 << 12)
        lanes, bbox, valid = random_groups(torch, np, seed, 60, cfg, dev)
        res.append((f"K1 random{seed}", k1_check(
            torch, raster_setup.bin_pairs(lanes, bbox, valid, cfg), cfg,
            f"K1 random seed {seed}")))
    cfg512 = FrameConfig(width=512, height=512, tile_h=32, tile_w=128,
                         max_pairs=1 << 16, max_tiles_per_tri=8,
                         max_tiles_per_group=4, max_group_pairs=1 << 13)
    lanes, bbox, valid = random_groups(torch, np, 9, 3008, cfg512, dev)
    pairs = raster_setup.bin_pairs(lanes, bbox, valid, cfg512)
    check(int(pairs.big_count) > 0, "512x512 scene has no big triangles")
    res.append(("K1 random512", k1_check(torch, pairs, cfg512, "K1 512x512")))
    gpairs = raster_setup.bin_groups(lanes, bbox, valid, cfg512)
    check(int(gpairs.big_count) > 0, "512x512 scene has no big groups")
    res.append(("K2 random512", k2_check(torch, gpairs, cfg512, "K2 512x512")))
    lanes2, bbox2, valid2 = random_groups(torch, np, 10, 1024, cfg512, dev)
    seed_bufs = raster.raster_groups_plain(
        raster_setup.bin_groups(lanes2, bbox2, valid2, cfg512), cfg512)
    res.append(("K2 seeded random512", k2_check(
        torch, gpairs, cfg512, "K2 seeded 512x512", init=seed_bufs)))
    gsc, gbridge = golden_scene(np)
    gcfg = FrameConfig(width=128, height=128, tile_h=16, tile_w=128,
                       max_pairs=1 << 12)
    gview = make_view(*gsc.camera_matrices(aspect=1.0), device=dev)
    gbuf = gbridge.build_scene_buffers(device=dev)
    res.append(("K1 golden", k1_check(torch, geometry_pass(gbuf, gview, gcfg)[-1],
                                      gcfg, "K1 golden scene")))
    rsc, rbridge = g512_scene(np)
    rbuf = rbridge.build_scene_buffers(device=dev)
    rview = make_view(*rsc.camera_matrices(aspect=1.0), device=dev)
    rcfg = FrameConfig(width=512, height=512, tile_h=32, tile_w=128,
                       max_pairs=1 << 15, enable_clod=True,
                       max_visible_clusters=1024, enable_clustered=True,
                       enable_alpha_mask=True)
    rparams = FrameParams.default(dev)
    with Capture(raster, ["raster_groups_cuda"]) as rc, \
            Capture(lighting, ["tiled_shade_cuda"]) as lc, \
            Capture(textures, ["tex_block_eval_cuda"]) as tc:
        build_frame_fn(rcfg)(rbuf, rview, rparams)
    rig_pairs = rc.calls[0][1][0]
    res.append(("K2 rig", k2_check(torch, rig_pairs, rcfg, "K2 rig")))
    res.append(("K2 seeded rig", k2_check(torch, rig_pairs, rcfg, "K2 seeded rig",
                                          init=rc.calls[1][3])))
    res.append(("K3 rig", k3_check(torch, lc.calls[0][1], "K3 rig")))
    res.append(("K4 rig", k4_check(torch, tc.calls[0][1], "K4 rig")))
    res.append(("K4-BC3 random", k4_check(
        torch, random_bc3_windows(torch, np, 11, dev), "K4-BC3 random",
        bc3=True)))
    bsc, bbridge = g512_scene(np, fmt="bc3", maps=True)
    bcfg = FrameConfig(width=512, height=512, tile_h=32, tile_w=128,
                       max_pairs=1 << 15, enable_clod=True,
                       max_visible_clusters=1024, enable_alpha_mask=True,
                       enable_textures=True, tex_format="bc3",
                       tex_channels=("base", "normal", "mr"))
    with Capture(textures, ["tex_block_eval_bc3_cuda"]) as bc:
        build_frame_fn(bcfg)(bbridge.build_scene_buffers(device=dev),
                             make_view(*bsc.camera_matrices(aspect=1.0),
                                       device=dev), rparams)
    check(len(bc.calls) == 2, f"BC3 rig frame launched K4-BC3 "
          f"{len(bc.calls)} times (mask pass + texture channels expected)")
    for label, call in zip(("mask", "channels"), bc.calls):
        res.append((f"K4-BC3 rig {label}", k4_check(
            torch, call[1], f"K4-BC3 rig {label}", bc3=True)))
    for seed, shape in ((12, (64, 256)), (13, (1088, 1920))):
        label = f"K5 random {shape[0]}x{shape[1]}"
        res.append((label, k5_check(torch, random_warp(torch, np, seed, shape,
                                                       dev), label)))
    say("phase 3 kernels vs plain: " + "; ".join(f"{k} max_abs_err {e:.3g}"
                                                  for k, e in res)
        + f" (K1/K2 vis, depth exact, channels rtol {CHANNEL_RTOL}; K3 rtol "
        f"{SHADE_RTOL} atol {SHADE_ATOL}; K4 and K4-BC3 atol {TEX_ATOL} on "
        f"0-255; K5 atol {WARP_ATOL})")

    # -- 4. golden on the card ---------------------------------------------
    frame = build_frame_fn(gcfg)
    out = frame(gbuf, gview, FrameParams.default(dev))
    img = out["image"].cpu().numpy()
    golden = read_png(os.path.join(REPO, "tests", "goldens", "basic_deferred.png"))
    r_gold = rmse(img, golden)
    cpu_out = frame(gbridge.build_scene_buffers(device="cpu"),
                    make_view(*gsc.camera_matrices(aspect=1.0), device="cpu"),
                    FrameParams.default("cpu"))
    r_cpu = rmse(img, cpu_out["image"].numpy())
    vis_agree = float((out["vis"].cpu() == cpu_out["vis"]).float().mean())
    check(r_gold <= GOLDEN_RMSE_MAX, f"golden RMSE {r_gold} > {GOLDEN_RMSE_MAX}")
    check(vis_agree >= 0.999, f"card vs CPU vis agreement {vis_agree}")
    say(f"phase 4 golden: 128x128 RMSE vs basic_deferred.png {r_gold:.4f} "
        f"(limit {GOLDEN_RMSE_MAX}); vs the port on the CPU: RMSE {r_cpu:.4f},"
        f" vis agreement {vis_agree:.5f}")

    # -- 5. the 512x512 cluster rig ----------------------------------------
    base = dict(width=512, height=512, tile_h=16, tile_w=128,
                max_pairs=1 << 15, enable_clod=True, max_visible_clusters=1024)
    goldens = {}
    for name, flags, steps in (
            ("g512_occlusion", dict(enable_occlusion=True), 3),
            ("g512_clustered", dict(enable_clustered=True), 1),
            ("g512_gtao_bloom", dict(enable_gtao=True, enable_bloom=True,
                                     enable_auto_exposure=True), 1),
            ("g512_taa", dict(enable_taa=True), 3),
            ("g512_ssr", dict(enable_ssr=True, ssr_downscale=2), 1),
            ("g512_clod_textured_ibl", dict(
                enable_textures=True, texture_downscale=1, enable_ibl=True,
                tex_channels=("base", "normal", "mr")), 1),
            ("g512_alpha_mask", dict(enable_alpha_mask=True,
                                     enable_textures=True,
                                     texture_downscale=1), 1),
            ("g512_vsm", dict(enable_vsm=True), 4)):
        cfg = FrameConfig(**base, **flags)
        fr = build_frame_fn(cfg)
        prev = torch.zeros((cfg.padded_height, cfg.padded_width), device=dev) \
            if cfg.enable_occlusion else None
        hist = None
        vsm_st = vsm.init_state(cfg, device=dev) if cfg.enable_vsm else None
        for _ in range(steps):
            o = fr(rbuf, rview, rparams, prev_depth=prev, taa_history=hist,
                   vsm_state=vsm_st)
            prev = o["depth_padded"] if cfg.enable_occlusion else None
            hist = o["taa_out"] if cfg.enable_taa else None
            vsm_st = o.get("vsm_state")
        goldens[name] = rmse(o["image"].cpu().numpy(), read_png(
            os.path.join(REPO, "tests", "goldens", f"{name}.png")))
        check(goldens[name] <= GOLDEN_RMSE_MAX,
              f"{name}: RMSE {goldens[name]} > {GOLDEN_RMSE_MAX}")
    mcfg = FrameConfig(**base, enable_alpha_mask=True)
    mo = build_frame_fn(mcfg)(rbuf, rview, rparams)
    mo_cpu = build_frame_fn(mcfg)(
        rbridge.build_scene_buffers(device="cpu"),
        make_view(*rsc.camera_matrices(aspect=1.0), device="cpu"),
        FrameParams.default("cpu"))
    m_agree = float((mo["vis"].cpu() == mo_cpu["vis"]).float().mean())
    m_rmse = rmse(mo["image"].cpu().numpy(), mo_cpu["image"].numpy())
    check(m_agree >= 0.999 and m_rmse <= 1.0,
          f"alpha-mask frame card vs CPU: vis agreement {m_agree}, RMSE {m_rmse}")
    seqs = []
    for label, flags, fmt in (
            ("TAA + SSR", SEQ_POST, "rgba8"),
            ("TAA + SSR + IBL", dict(SEQ_POST, enable_ibl=True), "rgba8"),
            ("full", SEQ_FULL, "rgba8"),
            ("full_bc3", dict(SEQ_FULL, tex_format="bc3"), "bc3")):
        s_agree, s_rmse, s_k5, s_ms, s_pages = moving_sequence(
            np, torch, dev, flags, fmt)
        seqs.append(f"{label}: vis agreement {s_agree:.5f}, RMSE "
                    f"{s_rmse:.4f}, K5 launches {s_k5}"
                    + (f", VSM pages {s_pages}" if s_pages else "")
                    + f", CPU {s_ms / 1e3:.1f} s")
    say("phase 5 cluster rig 512x512: " + ", ".join(
        f"{k} RMSE {v:.4f}" for k, v in goldens.items())
        + f" (limit {GOLDEN_RMSE_MAX}); alpha-MASK frame card vs CPU: vis "
        f"agreement {m_agree:.5f}, RMSE {m_rmse:.4f} (limits 0.999, 1.0); "
        "moving-camera sequences, 4 frames, last frame card vs CPU (limits "
        "0.999, 1.0): " + "; ".join(seqs))
    if quick:
        say(f"quick run: phases 6-9 skipped; {time.perf_counter() - t_start:.1f} s")
        return 0

    records = {}
    records.update(slice1(np, torch, dev, kernels))
    yard = list(courtyard(np, torch, dev))   # phase 9 drops its buffers
    records.update(slice2(np, torch, dev, kernels, smi, yard,
                          profile="--profile" in sys.argv[1:]))
    records.update(slice3(np, torch, dev, kernels, smi, yard,
                          profile="--profile" in sys.argv[1:]))
    records.update(slice3b(np, torch, dev, kernels, smi, yard,
                           profile="--profile" in sys.argv[1:]))

    print(json.dumps({"kernels": [records[k] for k in
                                  ("K1", "K2", "K2-VSM", "K3", "K4", "K4-BC3",
                                   "K5")]}),
          flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def slice1(np, torch, dev, kernels):
    """Phase 6: the soup frame at full size; K1 timed alone and plain."""
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn, geometry_pass
    from basicrenderer_tpu_torch.graph.framedata import FrameConfig, make_view
    from basicrenderer_tpu_torch.graph.temporal import TemporalState
    from basicrenderer_tpu_torch.ops import raster
    t0 = time.perf_counter()
    sc, bridge, ntris = soup_courtyard(np)
    buf = bridge.build_scene_buffers(device=dev)
    view = make_view(*sc.camera_matrices(aspect=16 / 9), device=dev)
    setup_s = time.perf_counter() - t0
    cfg = FrameConfig(width=1920, height=1080, tile_h=32, tile_w=128,
                      max_pairs=1 << 22, near_clip_tris=4096)
    fr = build_frame_fn(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(kernels)
    warm, timed = SLICE1_FRAMES
    out, frame_ms, _, stages = timed_frames(
        torch, np, fr, buf, sc, bridge, TemporalState(cfg, device=dev), warm,
        timed)
    launches = [k.launches for k in kernels]
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check(launches[0] == warm + timed,
          f"K1 launched {launches[0]} times in {warm + timed} frames")
    check(sum(launches[1:]) == 0, f"slice 1 launched other kernels {launches}")
    img, vis = out["image"], out["vis"]
    coverage = float((vis > 0).float().mean())
    counters = {k: int(out[k]) for k in ("bin_overflow", "cluster_overflow",
                                         "num_pairs")}
    check(tuple(img.shape) == (1080, 1920, 3) and img.dtype == torch.uint8,
          f"image {tuple(img.shape)} {img.dtype}")
    check(bool(torch.isfinite(out["hdr"]).all()), "non-finite HDR values")
    check(counters["bin_overflow"] == 0 and counters["cluster_overflow"] == 0,
          f"overflow {counters}")
    check(0.5 < coverage < 1.0, f"coverage {coverage}")
    check(float(img.float().std()) > 5.0, "flat image")

    pairs = geometry_pass(buf, view, cfg)[-1]
    k1_ms = cuda_ms(torch, lambda: raster.raster_tiles_cuda(pairs, cfg), 10)
    plain, plain_ms = host_ms(torch, lambda: raster.raster_tiles_plain(pairs, cfg))
    err = compare_raster(torch, raster.raster_tiles_cuda(pairs, cfg), plain,
                         "K1 1080p frame")
    offs = pairs.tile_offsets.long()
    rows_walked = int((offs[1:] - offs[:-1]).sum())   # big list empty below
    check(int(pairs.big_count) == 0, "slice 1 big list not empty")
    npix = cfg.tile_h * cfg.tile_w
    b_ms, b_by = bound(rows_walked * npix * RASTER_FLOPS_PER_ROW_PIXEL,
                       rows_walked * 128 + cfg.padded_height
                       * cfg.padded_width * 40)
    say(f"phase 6 slice 1: soup 1920x1080 tile 32x128, {ntris} triangles, host "
        f"scene build {setup_s:.1f} s | median {statistics.median(frame_ms):.3f} "
        f"ms/frame over {timed} (min {min(frame_ms):.3f}, max {max(frame_ms):.3f})"
        f" | stage ms (CUDA events, median): "
        + " ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f" | K1 {k1_ms:.3f} ms (bound {b_ms:.3f} ms, {b_by}) vs plain "
        f"{plain_ms:.1f} ms, max_abs_err {err:.3g} | K1 launches {launches[0]}"
        f" | pairs {counters['num_pairs']}, (row, tile) walked {rows_walked} |"
        f" coverage {coverage:.4f} | peak {peak_gib:.2f} GiB")
    return {"K1": {
        "name": "raster_tiles (K1, plain mode)", "route": "cuda",
        "source": "basicrenderer_tpu_torch/csrc/raster.cu",
        "replaces": "basicrenderer_tpu/ops/raster_pallas.py:135",
        "launches": launches[0], "max_abs_err": err, "ms": k1_ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}}


CONFIG1_MINIMAL = dict(width=1920, height=1080, tile_h=32, tile_w=128,
                       max_pairs=1 << 18, max_tiles_per_tri=8,
                       enable_clod=True, max_visible_clusters=3072,
                       max_phase2_clusters=256, shadow_clusters=768,
                       enable_clustered=True, enable_alpha_mask=True,
                       enable_occlusion=True)   # bench.py:217-224
CONFIG4_POST = dict(enable_gtao=True, enable_bloom=True, enable_taa=True,
                    enable_auto_exposure=True, enable_ssr=True)  # bench.py:233-235


def courtyard(np, torch, dev):
    """The dense LOD courtyard of phases 7 and 8 (grid 16, 1000 point
    lights, 256^2 textures) on the card: (built, bridge, buffers, host s)."""
    from basicrenderer_tpu_torch.models.scenes import build_courtyard
    from basicrenderer_tpu_torch.models.textures import TextureRegistry
    from basicrenderer_tpu_torch.scene.bridge import BridgeCapacities, SceneRenderBridge
    t0 = time.perf_counter()
    tex = TextureRegistry(256)
    built = build_courtyard(grid=16, dense=True, lod=True,
                            num_point_lights=1000, textures=tex)
    caps = BridgeCapacities(max_vertices=1 << 22, max_triangles=1 << 22,
                            max_objects=512, max_materials=64,
                            max_lights=1024 + 8, max_clusters=1 << 16,
                            max_geom_clusters=1 << 15, max_groups=1 << 13)
    bridge = SceneRenderBridge(built.scene, built.meshes, built.materials,
                               caps, textures=tex)
    buf = bridge.build_scene_buffers(device=dev)
    return built, bridge, buf, time.perf_counter() - t0


def slice2(np, torch, dev, kernels, smi, yard, profile=False):
    """Phase 7: bench.py's config1_minimal over the dense LOD courtyard."""
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn
    from basicrenderer_tpu_torch.graph.framedata import (FrameConfig,
                                                         FrameParams, make_view)
    from basicrenderer_tpu_torch.graph.temporal import TemporalState
    from basicrenderer_tpu_torch.ops import clod, lighting, raster, textures
    built, bridge, buf, setup_s = yard
    view = make_view(*built.scene.camera_matrices(aspect=16 / 9), device=dev)
    params = FrameParams.default(dev)
    cfg = FrameConfig(**CONFIG1_MINIMAL)
    fr = build_frame_fn(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(kernels)
    warm, timed = SLICE2_FRAMES
    out, frame_ms, _, stages = timed_frames(
        torch, np, fr, buf, built.scene, bridge, TemporalState(cfg, device=dev),
        warm, timed)
    launches = [k.launches for k in kernels]
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    n = warm + timed
    # The temporal state passes a zero previous depth on the first frame, so
    # every frame takes phase 1, phase 2 and the mask pass.
    check(launches[0] == 0, f"slice 2 launched K1 {launches[0]} times")
    check(launches[1] == 3 * n,
          f"K2 launched {launches[1]} times in {n} frames")
    check(launches[2] == n and launches[3] == n and launches[4] == 0,
          f"K3 / K4 / K5 launched {launches[2:]} times in {n} frames")
    img, vis = out["image"], out["vis"]
    coverage = float((vis > 0).float().mean())
    check(tuple(img.shape) == (1080, 1920, 3) and img.dtype == torch.uint8,
          f"image {tuple(img.shape)} {img.dtype}")
    check(bool(torch.isfinite(out["hdr"]).all()), "non-finite HDR values")
    check(0.3 < coverage < 1.0, f"coverage {coverage}")
    check(float(img.float().std()) > 5.0, "flat image")
    counters = {k: int(out[k]) for k in ("bin_overflow", "cluster_overflow",
                                         "light_overflow", "num_pairs")}

    # One more frame with the kernels' inputs captured, then each kernel
    # alone against its plain version on those inputs.
    with Capture(raster, ["raster_groups_cuda"]) as rc, \
            Capture(lighting, ["tiled_shade_cuda"]) as lc, \
            Capture(textures, ["tex_block_eval_cuda"]) as tc, \
            Capture(clod, ["compact_visible_tris"]) as cc:
        fr(buf, view, params, prev_depth=out["depth_padded"])
    torch.cuda.synchronize()
    live = [int((c[3].slot_cluster >= 0).sum()) for c in cc.calls]
    check(len(rc.calls) == 3 and len(lc.calls) == 1 and len(tc.calls) == 1,
          "captured frame launched an unexpected kernel mix")
    reps = 10
    recs = {}
    k2_ms = k2_plain = k2_bsum = 0.0
    k2_err = k2_big = 0.0
    k2_by = "operations"
    k2_parts = []
    npix = cfg.tile_h * cfg.tile_w
    for label, (_n, a, kw, kout) in zip(("phase1", "phase2", "mask"), rc.calls):
        p_, c_, r0_, init = a[0], a[1], a[2], a[3] if len(a) > 3 else None
        ms = cuda_ms(torch, lambda: raster.raster_groups_cuda(p_, c_, r0_, init),
                     reps)
        pd, pmsd = host_ms(torch, lambda: raster.raster_groups_plain(
            p_, c_, r0_, init))
        err = compare_raster(torch, kout, pd, f"K2 {label} 1080p")
        b_ms, b_by, walked = k2_bound(raster, p_, c_, r0_, init)
        if b_ms > k2_big:
            k2_big, k2_by = b_ms, b_by
        k2_ms, k2_plain, k2_bsum = k2_ms + ms, k2_plain + pmsd, k2_bsum + b_ms
        k2_err = max(k2_err, err)
        k2_parts.append(f"{label} {ms:.3f} ms (bound {b_ms:.3f}, plain "
                        f"{pmsd:.0f}, rows walked {walked}, pairs "
                        f"{int(p_.num_pairs)})")
    recs["K2"] = {
        "name": "raster_groups (K2, plain + seeded modes; per frame: phase 1,"
                " phase 2 seeded, mask pass)", "route": "cuda",
        "source": "basicrenderer_tpu_torch/csrc/raster.cu",
        "replaces": "basicrenderer_tpu/ops/raster_pallas.py:252",
        "launches": launches[1], "max_abs_err": k2_err, "ms": k2_ms,
        "plain_ms": k2_plain, "bound_ms": k2_bsum, "bound_by": k2_by,
        "library_ms": None}

    a3 = lc.calls[0][1]
    k3_ms = cuda_ms(torch, lambda: lighting.tiled_shade_cuda(*a3), reps)
    _, k3_plain = host_ms(torch, lambda: lighting.tiled_shade_plain(*a3))
    k3_err = k3_check(torch, a3, "K3 1080p")
    shade_in, payload, counts = a3[0], a3[1], a3[2]
    pix_lights = int(counts.long().sum()) * npix
    hw = shade_in.shape[1] * shade_in.shape[2]
    b3_ms, b3_by = bound(pix_lights * SHADE_FLOPS_PER_PIXEL_LIGHT
                         + hw * SHADE_FLOPS_PER_PIXEL,
                         shade_in.numel() * 4 + payload.numel() * 4
                         + counts.numel() * 4 + hw * 12)
    recs["K3"] = {
        "name": "tiled_shade (K3)", "route": "cuda",
        "source": "basicrenderer_tpu_torch/csrc/tiled_shade.cu",
        "replaces": "basicrenderer_tpu/ops/lighting.py:133",
        "launches": launches[2], "max_abs_err": k3_err, "ms": k3_ms,
        "plain_ms": k3_plain, "bound_ms": b3_ms, "bound_by": b3_by,
        "library_ms": None}

    a4 = tc.calls[0][1]
    k4_ms = cuda_ms(torch, lambda: textures.tex_block_eval_cuda(*a4), reps)
    _, k4_plain = host_ms(torch, lambda: textures.tex_block_eval_plain(*a4))
    k4_err = k4_check(torch, a4, "K4 1080p")
    jobs = a4[1].shape[0]
    b4_ms, b4_by = k4_bound(torch, a4, bc3=False)
    recs["K4"] = {
        "name": "tex_block_eval (K4, RGBA8)", "route": "cuda",
        "source": "basicrenderer_tpu_torch/csrc/tex_block.cu",
        "replaces": "basicrenderer_tpu/ops/textures.py:508",
        "launches": launches[3], "max_abs_err": k4_err, "ms": k4_ms,
        "plain_ms": k4_plain, "bound_ms": b4_ms, "bound_by": b4_by,
        "library_ms": None}

    order = ["cut", "hzb", "setup", "bin", "raster", "hzb2", "cut2", "setup2",
             "bin2", "raster2", "mask", "gbuffer", "light_cull", "tiled_shade",
             "shade"]
    say(f"phase 7 slice 2: config1_minimal 1920x1080 over build_courtyard(grid="
        f"16, dense, lod, 1000 point lights, textures 256): "
        f"{built.num_triangles} source triangles, {int(buf.num_clusters)} "
        f"clusters, host scene build {setup_s:.1f} s | median "
        f"{statistics.median(frame_ms):.3f} ms/frame over {timed} (min "
        f"{min(frame_ms):.3f}, max {max(frame_ms):.3f}) | stage ms (CUDA "
        f"events, median): " + " ".join(f"{k} {stages[k]:.3f}" for k in order
                                        if k in stages)
        + f" | K2 {k2_ms:.3f} ms per frame = " + "; ".join(k2_parts)
        + f" | K3 {k3_ms:.3f} ms (bound {b3_ms:.3f} {b3_by}, plain "
        f"{k3_plain:.1f}, {pix_lights // npix} tile-lights) | K4 {k4_ms:.3f} ms "
        f"(bound {b4_ms:.4f} {b4_by}, plain {k4_plain:.1f}, {jobs} jobs) | "
        f"launches K1 {launches[0]} K2 {launches[1]} K3 {launches[2]} K4 "
        f"{launches[3]} in {n} frames | visible clusters {live[0]}, phase-2 "
        f"clusters {live[1]}, mask clusters {live[2]} | overflow bin "
        f"{counters['bin_overflow']} cluster {counters['cluster_overflow']} "
        f"light {counters['light_overflow']}, group pairs "
        f"{counters['num_pairs']} | coverage {coverage:.4f} | peak "
        f"{peak_gib:.2f} GiB | {smi}")
    if profile:
        prev = [out["depth_padded"]]

        def step():
            prev[0] = fr(buf, view, params, prev_depth=prev[0])["depth_padded"]
        profile_frames(torch, step, statistics.median(frame_ms), "phase 7")
    return recs

SEQ_BASE = dict(width=512, height=512, tile_h=16, tile_w=128,
                max_pairs=1 << 15, enable_clod=True, max_visible_clusters=256)
SEQ_POST = dict(SEQ_BASE, enable_taa=True, enable_ssr=True, ssr_downscale=2)
# bench.py's `full` (bench.py:236-241: config1_minimal's toggles, then IBL,
# texture channels, VSM and the post stack) over the 512x512 rig.
SEQ_FULL = dict(SEQ_BASE, enable_occlusion=True, enable_clustered=True,
                enable_alpha_mask=True, enable_ibl=True, enable_textures=True,
                tex_channels=("base", "normal", "mr"), enable_vsm=True,
                enable_gtao=True, enable_bloom=True, enable_taa=True,
                enable_auto_exposure=True, enable_ssr=True)


def moving_sequence(np, torch, dev, flags, fmt, frames=4):
    """Phase 5: the 512x512 rig (with normal and metallic-roughness maps
    when `flags` enable textures; its atlas in `fmt`) over `frames` frames
    of FrameConfig(**flags), the camera orbiting and the cube sliding,
    driven by graph/temporal.py on the card and on the CPU from the same
    scene; with IBL, over the procedural environment (one precompute on
    the card feeding both runs). Returns (vis agreement, image RMSE) of the
    last frame, the K5 launches, the CPU run's ms and the VSM pages the
    card rendered."""
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn
    from basicrenderer_tpu_torch.graph.framedata import FrameConfig
    from basicrenderer_tpu_torch.graph.temporal import TemporalState
    from basicrenderer_tpu_torch.models.environment import Environment
    from basicrenderer_tpu_torch.ops import taa_warp
    from basicrenderer_tpu_torch.scene.components import Position
    cfg = FrameConfig(**flags)
    sc, bridge = g512_scene(np, fmt=fmt, maps=cfg.enable_textures)
    env = {}
    if cfg.enable_ibl:
        e = Environment.procedural(device=dev, use_cache=False)
        env = dict(env_sh=e.sh, env_specular=e.spec_mips)
    fr = build_frame_fn(cfg)
    devices = (dev, torch.device("cpu"))
    states = [TemporalState(cfg, device=d) for d in devices]
    bufs = [bridge.build_scene_buffers(**env, device=d) for d in devices]
    cube0 = np.array([-1.4, 0.35, 0.6], np.float32)
    cube = entity_at(np, sc, cube0)
    pos0 = sc.camera_matrices(aspect=1.0)[2].copy()
    before = taa_warp.warp_history_tiles.launches
    cpu_ms = 0.0
    pages = 0
    outs = [None, None]
    for i in range(frames):
        orbit_camera(np, sc, pos0, np.array([0.0, 0.6, 0.0]), 0.03 * i, 1.0)
        sc.world.set(cube, Position(cube0 + np.array([0.06 * i, 0, 0],
                                                     np.float32)))
        sc.propagate_transforms()
        for k, state in enumerate(states):
            t0 = time.perf_counter()
            bufs[k] = bridge.update_dynamic(bufs[k])
            view, params, kw = state.inputs(sc, bridge)
            outs[k] = fr(bufs[k], view, params, **kw)
            state.carry(outs[k])
            if k == 1:
                cpu_ms += (time.perf_counter() - t0) * 1e3
        if cfg.enable_vsm:
            pages += int(outs[0]["vsm_stats"]["rendered"])
            for key in ("dirty", "needed", "rendered"):
                check(int(outs[0]["vsm_stats"][key])
                      == int(outs[1]["vsm_stats"][key]),
                      f"VSM {key} card vs CPU on frame {i}")
    torch.cuda.synchronize()
    launches = taa_warp.warp_history_tiles.launches - before
    card, cpu = outs
    agree = float((card["vis"].cpu() == cpu["vis"]).float().mean())
    err = rmse(card["image"].cpu().numpy(), cpu["image"].numpy())
    check(agree >= 0.999 and err <= 1.0,
          f"moving sequence {sorted(flags)} ({fmt}) card vs CPU: vis "
          f"agreement {agree}, RMSE {err}")
    check(launches == frames - 1,
          f"K5 launched {launches} times in a {frames}-frame sequence")
    check(not cfg.enable_vsm or pages > 0, "no VSM page rendered")
    check(bool(torch.isfinite(card["hdr"]).all()), "non-finite HDR values")
    return agree, err, launches, cpu_ms, pages


def timed_frames(torch, np, fr, buf, scene, bridge, temporal, warm, timed,
                 orbit=None, first=0, on_frame=None):
    """Run warm + timed frames of `scene` with the inputs of `temporal`
    (graph/temporal.py). With `orbit` = (pos0, target, aspect) the camera
    turns ORBIT_RAD_PER_FRAME per frame about the vertical through target;
    without, it stays. Returns (last output, frame ms list, temporal ms
    list, stage ms medians): frame ms from the frame call to its
    synchronise, temporal ms the host work of temporal.inputs.
    `on_frame(out)` sees every frame's outputs after its synchronise."""
    marks = []

    def hook(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    frame_ms, inputs_ms, stage_ms = [], [], {}
    out = None
    for i in range(first, first + warm + timed):
        if orbit is not None:
            pos0, target, aspect = orbit
            orbit_camera(np, scene, pos0, target, ORBIT_RAD_PER_FRAME * i,
                         aspect)
        marks.clear()
        t0 = time.perf_counter()
        view, params, kw = temporal.inputs(scene, bridge)
        t1 = time.perf_counter()
        out = fr(buf, view, params, stage_hook=hook, **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        temporal.carry(out)
        if on_frame is not None:
            on_frame(out)
        if i >= first + warm:
            frame_ms.append((t2 - t1) * 1e3)
            inputs_ms.append((t1 - t0) * 1e3)
            for (name, a), (_, b) in zip(marks, marks[1:]):
                stage_ms.setdefault(name, []).append(a.elapsed_time(b))
    return out, frame_ms, inputs_ms, {k: statistics.median(v)
                                      for k, v in stage_ms.items()}


def slice3(np, torch, dev, kernels, smi, yard, profile=False):
    """Phase 8: bench.py's config4_post over the dense LOD courtyard with
    an orbiting camera; K5 alone against its plain version and grid_sample;
    then the same run with IBL over the procedural environment."""
    import dataclasses
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn
    from basicrenderer_tpu_torch.graph.framedata import FrameConfig
    from basicrenderer_tpu_torch.graph.temporal import TemporalState
    from basicrenderer_tpu_torch.models.environment import Environment
    from basicrenderer_tpu_torch.ops import taa_warp
    built, bridge, buf, _setup_s = yard
    pos0 = built.scene.camera_matrices(aspect=16 / 9)[2].copy()
    target = np.asarray(built.scene._camera_target, np.float64)
    orbit = (pos0, target, 16 / 9)
    cfg = FrameConfig(**CONFIG1_MINIMAL, **CONFIG4_POST)
    warm, timed = SLICE3_FRAMES
    n = warm + timed
    order = ["cut", "hzb", "setup", "bin", "raster", "hzb2", "cut2", "setup2",
             "bin2", "raster2", "mask", "gbuffer", "light_cull", "tiled_shade",
             "shade", "ssr", "gtao", "ibl", "motion", "taa", "bloom",
             "exposure"]
    rec = None
    lines = []
    for label in ("config4_post", "config4_post + IBL"):
        ibl = label.endswith("IBL")
        run_cfg = dataclasses.replace(cfg, enable_ibl=True) if ibl else cfg
        run_buf = buf
        env_s = 0.0
        if ibl:
            t0 = time.perf_counter()
            env = Environment.procedural(device=dev, use_cache=False)
            env_s = time.perf_counter() - t0
            run_buf = dataclasses.replace(
                buf, env_sh=torch.as_tensor(env.sh, device=dev),
                env_specular=torch.as_tensor(env.spec_mips, device=dev))
        fr = build_frame_fn(run_cfg)
        temporal = TemporalState(run_cfg, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches(kernels)
        out, frame_ms, inputs_ms, stages = timed_frames(
            torch, np, fr, run_buf, built.scene, bridge, temporal, warm, timed,
            orbit)
        launches = [k.launches for k in kernels]
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        # The temporal state passes a zero previous depth on the first frame, so
        # every frame takes phase 1, phase 2 and the mask pass; history
        # exists from the second frame on.
        check(launches[0] == 0, f"{label} launched K1 {launches[0]} times")
        check(launches[1] == 3 * n, f"{label}: K2 launched {launches[1]} "
              f"times in {n} frames")
        check(launches[2] == n and launches[3] == n,
              f"{label}: K3 / K4 launched {launches[2:4]} times in {n} frames")
        check(launches[4] == n - 1, f"{label}: K5 launched {launches[4]} "
              f"times in {n} frames")
        img, vis = out["image"], out["vis"]
        coverage = float((vis > 0).float().mean())
        check(tuple(img.shape) == (1080, 1920, 3) and img.dtype == torch.uint8,
              f"image {tuple(img.shape)} {img.dtype}")
        check(bool(torch.isfinite(out["hdr"]).all())
              and bool(torch.isfinite(out["taa_out"]).all()),
              "non-finite HDR values")
        check(0.3 < coverage < 1.0, f"coverage {coverage}")
        check(float(img.float().std()) > 5.0, "flat image")
        counters = {k: int(out[k]) for k in ("bin_overflow", "cluster_overflow",
                                             "light_overflow")}

        # One more frame with K5's inputs captured; K5 alone on them.
        with Capture(taa_warp, ["warp_history_tiles"]) as wc:
            out = timed_frames(torch, np, fr, run_buf, built.scene, bridge,
                               temporal, 1, 0, orbit, first=n)[0]
        check(len(wc.calls) == 1, f"captured frame launched K5 "
              f"{len(wc.calls)} times")
        _name, a5, _kw, k5_out = wc.calls[0]
        hist, tdy, tdx, th, tw = a5
        shift = max(float(tdy.abs().max()), float(tdx.abs().max()))
        check(shift > 0.01, f"{label}: tile motion {shift} px: the orbit "
              "did not move the tiles")
        k5_ms = cuda_ms(torch, lambda: taa_warp.warp_history_tiles(*a5), 20)
        plain, k5_plain = host_ms(torch, lambda: taa_warp.warp_history_plain(
            *a5))
        k5_err = float((k5_out - plain).abs().max())
        check(k5_err <= WARP_ATOL, f"{label}: K5 vs plain on the frame's "
              f"inputs: max abs err {k5_err}")
        lib_ms, lib_err = grid_sample_warp(torch, hist, tdy, tdx, th, tw,
                                           plain)
        Hp, Wp, C = hist.shape
        b5_ms, b5_by = bound(Hp * Wp * C * WARP_FLOPS_PER_VALUE,
                             2 * hist.numel() * 4 + 2 * tdy.numel() * 4)
        if profile and not ibl:
            first = [n + 1]

            def step():
                timed_frames(torch, np, fr, run_buf, built.scene, bridge,
                             temporal, 1, 0, orbit, first=first[0])
                first[0] += 1
            profile_frames(torch, step, statistics.median(frame_ms),
                           f"phase 8 {label}")
        if rec is None:
            rec = {"K5": {
                "name": "warp_history_tiles (K5, TAA history warp)",
                "route": "cuda",
                "source": "basicrenderer_tpu_torch/csrc/taa_warp.cu",
                "replaces": "basicrenderer_tpu/ops/taa_warp.py:44",
                "launches": launches[4], "max_abs_err": k5_err, "ms": k5_ms,
                "plain_ms": k5_plain, "bound_ms": b5_ms, "bound_by": b5_by,
                "library_ms": lib_ms}}
        lines.append(
            f"{label}: median {statistics.median(frame_ms):.3f} ms/frame over "
            f"{timed} (min {min(frame_ms):.3f}, max {max(frame_ms):.3f}; "
            f"temporal state host {statistics.median(inputs_ms):.3f} ms"
            + (f"; environment precompute {env_s:.1f} s" if ibl else "")
            + ") | stage ms (CUDA events, median): "
            + " ".join(f"{k} {stages[k]:.3f}" for k in order if k in stages)
            + f" | launches per frame K1 {launches[0] / n:.2f} K2 "
            f"{launches[1] / n:.2f} K3 {launches[2] / n:.2f} K4 "
            f"{launches[3] / n:.2f} K5 {launches[4] / n:.2f} ({launches} in "
            f"{n} frames) | K5 {k5_ms:.4f} ms (bound {b5_ms:.4f} ms "
            f"{b5_by}) vs plain {k5_plain:.3f} ms vs grid_sample {lib_ms:.4f}"
            f" ms (max diff {lib_err:.2g}), max_abs_err {k5_err:.3g}, max "
            f"tile shift {shift:.3f} px | overflow {counters} | coverage "
            f"{coverage:.4f} | peak {peak_gib:.2f} GiB")
    say("phase 8 slice 3: config4_post 1920x1080 over the phase-7 courtyard, "
        f"camera orbit {ORBIT_RAD_PER_FRAME} rad/frame | " + " || ".join(lines)
        + f" | {smi}")
    return rec


FULL = dict(enable_ibl=True, enable_textures=True,
            tex_channels=("base", "normal", "mr"), enable_vsm=True,
            enable_gtao=True, enable_bloom=True, enable_taa=True,
            enable_auto_exposure=True,
            enable_ssr=True)   # bench.py:236-241, over config1_minimal


def slice3b(np, torch, dev, kernels, smi, yard, profile=False):
    """Phase 9: bench.py's `full` and `full_bc3` over the dense LOD
    courtyard with the phase-8 orbit through graph/temporal.py; K4 per
    format and K2's VSM page launches checked and timed alone on a frame's
    own inputs. `full` renders the courtyard's RGBA8 buffers (`yard`, a
    list: its buffers are dropped here); `full_bc3` those of a second
    bridge with tex_format="bc3" (bench.py:323-332), built after the RGBA8
    buffers and state are freed, so that each format's peak is its own."""
    import dataclasses
    import gc
    from basicrenderer_tpu_torch.models.environment import Environment
    from basicrenderer_tpu_torch.scene.bridge import SceneRenderBridge
    built, bridge = yard[0], yard[1]
    # Both formats orbit from where phase 8 left the camera.
    orbit = (built.scene.camera_matrices(aspect=16 / 9)[2].copy(),
             np.asarray(built.scene._camera_target, np.float64), 16 / 9)
    env = Environment.procedural(device=dev, use_cache=False)
    buf = dataclasses.replace(
        yard[2], env_sh=torch.as_tensor(env.sh, device=dev),
        env_specular=torch.as_tensor(env.spec_mips, device=dev))
    yard[2] = None
    recs = {}
    line, img, rgba8_bytes = full_run(np, torch, dev, kernels, built, bridge,
                                      buf, "rgba8", orbit, recs, profile)
    del buf
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bridge_bc = SceneRenderBridge(built.scene, built.meshes, built.materials,
                                  bridge.caps, textures=bridge.textures,
                                  tex_format="bc3")
    buf_bc = bridge_bc.build_scene_buffers(env_sh=env.sh,
                                           env_specular=env.spec_mips,
                                           device=dev)
    torch.cuda.synchronize()
    bc_s = time.perf_counter() - t0
    line_bc, img_bc, bc3_bytes = full_run(np, torch, dev, kernels, built,
                                          bridge_bc, buf_bc, "bc3", orbit,
                                          recs, profile)
    err_bc3 = rmse(img_bc, img)
    check(bc3_bytes * 4 <= rgba8_bytes, f"BC3 atlas {bc3_bytes} B is not 4x "
          f"smaller than RGBA8 {rgba8_bytes} B")
    check(err_bc3 <= GOLDEN_RMSE_MAX, f"full_bc3 vs full RMSE {err_bc3}")
    say("phase 9 slice 3b: full / full_bc3 1920x1080 over the phase-7 "
        f"courtyard, camera orbit {ORBIT_RAD_PER_FRAME} rad/frame | {line} || "
        f"{line_bc} || atlas bytes rgba8 {rgba8_bytes} bc3 {bc3_bytes} "
        f"({rgba8_bytes / bc3_bytes:.2f}x; the BC3 bridge's pack, encode "
        f"and upload on the host {bc_s:.1f} s) | RMSE full_bc3 vs full (same "
        f"camera, frame {sum(SLICE3B_FRAMES)}) {err_bc3:.4f} | {smi}")
    return recs


def full_run(np, torch, dev, kernels, built, bridge, buf, fmt, orbit, recs,
             profile):
    """One format of phase 9: warm + timed frames of `full` (fmt "rgba8")
    or `full_bc3` ("bc3") over `buf` along `orbit` (as timed_frames takes
    it), then one captured frame whose K4 launches (and, for RGBA8, K2's
    VSM page launches) are checked against their plain versions and timed
    alone; RGBA8 then holds the camera until the VSM cache converges.
    Adds its kernel records to `recs`; returns (line, last image as
    numpy, atlas bytes). Its tensors are freed when it returns."""
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn
    from basicrenderer_tpu_torch.graph.framedata import FrameConfig
    from basicrenderer_tpu_torch.graph.temporal import TemporalState
    from basicrenderer_tpu_torch.ops import raster, textures
    label = "full_bc3" if fmt == "bc3" else "full"
    bc3 = fmt == "bc3"
    warm, timed = SLICE3B_FRAMES
    n = warm + timed
    order = ["cut", "hzb", "setup", "bin", "raster", "hzb2", "cut2", "setup2",
             "bin2", "raster2", "mask", "gbuffer", "textures", "normal_map",
             "vsm", "light_cull", "tiled_shade", "shade", "ssr", "gtao", "ibl",
             "motion", "taa", "bloom", "exposure"]
    cfg = FrameConfig(**CONFIG1_MINIMAL, **FULL, tex_format=fmt)
    fr = build_frame_fn(cfg)
    temporal = TemporalState(cfg, device=dev)
    pages = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(kernels)
    out, frame_ms, inputs_ms, stages = timed_frames(
        torch, np, fr, buf, built.scene, bridge, temporal, warm, timed, orbit,
        on_frame=lambda o: pages.append(int(o["vsm_stats"]["rendered"])))
    launches = [k.launches for k in kernels]
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    # Per frame: K2 for phase 1, phase 2 and the mask pass, plus one per
    # VSM page rendered (pages raster through the group path, K2; K1 gets
    # none); K4 in the frame's format for the mask pass and the texture
    # channels; K3 once; K5 from the second frame.
    k4, k4b = (0, 2 * n) if bc3 else (2 * n, 0)
    check(launches[0] == 0, f"{label} launched K1 {launches[0]} times")
    check(launches[1] == 3 * n + sum(pages), f"{label}: K2 launched "
          f"{launches[1]} times in {n} frames with {sum(pages)} VSM pages")
    check(launches[2] == n and launches[3] == k4 and launches[5] == k4b,
          f"{label}: K3 / K4 / K4-BC3 launched {launches[2]} / "
          f"{launches[3]} / {launches[5]} times in {n} frames")
    check(launches[4] == n - 1, f"{label}: K5 launched {launches[4]} "
          f"times in {n} frames")
    check(sum(pages) > 0, f"{label}: the orbit dirtied no VSM page")
    img, vis = out["image"], out["vis"]
    coverage = float((vis > 0).float().mean())
    check(tuple(img.shape) == (1080, 1920, 3) and img.dtype == torch.uint8,
          f"image {tuple(img.shape)} {img.dtype}")
    check(bool(torch.isfinite(out["hdr"]).all()), "non-finite HDR values")
    check(0.3 < coverage < 1.0, f"coverage {coverage}")
    check(float(img.float().std()) > 5.0, "flat image")
    counters = {k: int(out[k]) for k in ("bin_overflow", "cluster_overflow",
                                         "light_overflow")}
    del out

    # One more frame with K4's inputs (the mask pass's and the texture
    # channels' windows) and K2's captured; each launch alone against its
    # plain version and its bound.
    entry = "tex_block_eval_bc3_cuda" if bc3 else "tex_block_eval_cuda"
    plain = (textures.tex_block_eval_bc3_plain if bc3
             else textures.tex_block_eval_plain)
    with Capture(textures, [entry]) as tc, \
            Capture(raster, ["raster_groups_cuda"]) as rc:
        last = timed_frames(torch, np, fr, buf, built.scene, bridge,
                            temporal, 1, 0, orbit, first=n)[0]
    image = last["image"].cpu().numpy()
    captured_pages = int(last["vsm_stats"]["rendered"])
    del last
    check(len(tc.calls) == 2, f"{label}: captured frame launched K4 "
          f"{len(tc.calls)} times")
    k4_ms = k4_plain = k4_bound_ms = k4_big = 0.0
    k4_err, k4_by, k4_parts = 0.0, "bytes", []
    for part, (_n, a4, _kw, k4_out) in zip(("mask", "channels"), tc.calls):
        ms = cuda_ms(torch, lambda: getattr(textures, entry)(*a4), 10)
        p_out, p_ms = host_ms(torch, lambda: plain(*a4))
        err = float((k4_out - p_out).abs().max())
        check(err <= TEX_ATOL, f"{label} K4 {part} vs plain on the "
              f"frame's windows: max abs err {err}")
        b_ms, b_by = k4_bound(torch, a4, bc3)
        if b_ms > k4_big:
            k4_big, k4_by = b_ms, b_by
        k4_ms, k4_plain, k4_bound_ms = k4_ms + ms, k4_plain + p_ms, \
            k4_bound_ms + b_ms
        k4_err = max(k4_err, err)
        k4_parts.append(f"{part} {ms:.4f} ms (bound {b_ms:.4f} {b_by}, "
                        f"plain {p_ms:.2f}, {a4[1].shape[0]} jobs)")
    del tc
    if bc3:
        recs["K4-BC3"] = {
            "name": "tex_block_eval_bc3 (K4, BC3 mode: window decode "
                    "fused; per frame: mask pass + texture channels)",
            "route": "cuda",
            "source": "basicrenderer_tpu_torch/csrc/tex_block.cu",
            "replaces": "basicrenderer_tpu/ops/textures.py:508 (with "
                        "bc3_decode_rows, :606)",
            "launches": launches[5], "max_abs_err": k4_err,
            "ms": k4_ms, "plain_ms": k4_plain, "bound_ms": k4_bound_ms,
            "bound_by": k4_by, "library_ms": None}

    # K2's VSM page launches of the captured frame (the 128x128 depth-only
    # ortho page config; the frame's own launches are 1920 wide).
    page_line = ""
    page_calls = [c for c in rc.calls if c[1][1].width == cfg.vsm_page_size]
    check(len(page_calls) == captured_pages and len(rc.calls) == 3 + len(
        page_calls), f"{label}: captured frame launched K2 {len(rc.calls)} "
        f"times, {len(page_calls)} on pages, with {captured_pages} pages")
    if not bc3:
        check(captured_pages > 0, "captured frame rendered no VSM page")
        p_ms_sum = p_plain = p_bound = p_big = 0.0
        p_err, p_by, p_parts = 0.0, "operations", []
        for k, (_n, a, _kw, kout) in enumerate(page_calls):
            pp, pc, pr0 = a[0], a[1], a[2]
            pinit = a[3] if len(a) > 3 else None
            ms = cuda_ms(torch, lambda: raster.raster_groups_cuda(
                pp, pc, pr0, pinit), 10)
            pd, pl_ms = host_ms(torch, lambda: raster.raster_groups_plain(
                pp, pc, pr0, pinit))
            err = compare_raster(torch, kout, pd, f"K2 VSM page {k}")
            b_ms, b_by, walked = k2_bound(raster, pp, pc, pr0, pinit)
            if b_ms > p_big:
                p_big, p_by = b_ms, b_by
            p_ms_sum, p_plain, p_bound = p_ms_sum + ms, p_plain + pl_ms, \
                p_bound + b_ms
            p_err = max(p_err, err)
            p_parts.append(f"{ms:.4f} ms (bound {b_ms:.4f} {b_by}, plain "
                           f"{pl_ms:.0f}, rows walked {walked}, pairs "
                           f"{int(pp.num_pairs)})")
        recs["K2-VSM"] = {
            "name": "raster_groups (K2, plain mode, VSM pages: 128x128 "
                    "depth-only ortho page config; per frame: the frame's "
                    "dirty pages)", "route": "cuda",
            "source": "basicrenderer_tpu_torch/csrc/raster.cu",
            "replaces": "basicrenderer_tpu/ops/raster_pallas.py:252",
            "launches": sum(pages), "max_abs_err": p_err, "ms": p_ms_sum,
            "plain_ms": p_plain, "bound_ms": p_bound, "bound_by": p_by,
            "library_ms": None}
        page_line = (f" | K2 on the captured frame's {len(page_calls)} VSM "
                     f"pages {p_ms_sum:.4f} ms (bound {p_bound:.4f} ms "
                     f"{p_by}, plain {p_plain:.0f} ms, max_abs_err "
                     f"{p_err:.3g}; vis and depth exact) = "
                     + "; ".join(p_parts))
    del rc, page_calls
    conv_line = ""
    if not bc3:
        conv_line = " | " + vsm_converged(np, torch, kernels, fr, buf,
                                          built.scene, bridge, temporal,
                                          n + 1)
    if profile and not bc3:
        first = [n + 1 + VSM_CONVERGE_FRAMES + 5]

        def step():
            timed_frames(torch, np, fr, buf, built.scene, bridge, temporal,
                         1, 0, orbit, first=first[0])
            first[0] += 1
        profile_frames(torch, step, statistics.median(frame_ms),
                       f"phase 9 {label}")
    atlas = buf.tex_strips.numel() * 4
    line = (
        f"{label}: median {statistics.median(frame_ms):.3f} ms/frame over "
        f"{timed} (min {min(frame_ms):.3f}, max {max(frame_ms):.3f}; "
        f"temporal state host {statistics.median(inputs_ms):.3f} ms) | "
        "stage ms (CUDA events, median): "
        + " ".join(f"{k} {stages[k]:.3f}" for k in order if k in stages)
        + f" | VSM pages rendered per frame {pages} (K2 launches from "
        f"them {sum(pages)}, {sum(pages) / n:.2f}/frame; K1 0) | launches "
        f"per frame K1 {launches[0] / n:.2f} K2 {launches[1] / n:.2f} K3 "
        f"{launches[2] / n:.2f} K4 {launches[3] / n:.2f} K4-BC3 "
        f"{launches[5] / n:.2f} K5 {launches[4] / n:.2f} | K4 "
        f"({fmt}) per frame {k4_ms:.4f} ms (bound {k4_bound_ms:.4f} ms "
        f"{k4_by}, plain {k4_plain:.2f} ms, max_abs_err {k4_err:.3g}) = "
        + "; ".join(k4_parts) + page_line
        + f" | atlas {atlas} bytes | overflow {counters} | coverage "
        f"{coverage:.4f} | peak {peak_gib:.2f} GiB" + conv_line)
    return line, image, atlas


def vsm_converged(np, torch, kernels, fr, buf, scene, bridge, temporal,
                  first):
    """Phase 9, `full`: hold the camera until the VSM cache renders no page
    (at most VSM_CONVERGE_FRAMES frames), then time 5 more frames: with a
    converged cache the VSM stage is the mark, the one host read of the
    dirty-page count and the sample, with no page work queued (the TAA
    jitter may still reveal a page at a window edge now and then)."""
    pages = []
    k = 0
    while k < VSM_CONVERGE_FRAMES and (not pages or pages[-1] > 0):
        timed_frames(torch, np, fr, buf, scene, bridge, temporal, 1, 0,
                     first=first + k,
                     on_frame=lambda o: pages.append(
                         int(o["vsm_stats"]["rendered"])))
        k += 1
    check(pages[-1] == 0, f"VSM did not converge in {k} static frames: "
          f"pages {pages}")
    still = []
    reset_launches(kernels)
    _out, frame_ms, _in, stages = timed_frames(
        torch, np, fr, buf, scene, bridge, temporal, 0, 5, first=first + k,
        on_frame=lambda o: still.append(int(o["vsm_stats"]["rendered"])))
    check(kernels[1].launches == 3 * 5 + sum(still),
          f"converged cache: pages {still}, K2 launched "
          f"{kernels[1].launches} times in 5 frames")
    return (f"static camera: converged after {k} frames (pages {pages}); "
            f"then 5 frames, pages {still}: median "
            f"{statistics.median(frame_ms):.3f} ms/frame, vsm stage "
            f"{stages['vsm']:.3f} ms, K2 {kernels[1].launches / 5:.2f} "
            "launches/frame")


def grid_sample_warp(torch, hist, tdy, tdx, th, tw, ref):
    """(ms, max abs diff vs `ref`) of one torch grid_sample (bilinear,
    border padding) warping (1, C, H, W) history by the same clipped
    per-tile shifts; the grid and layout are made outside the timing. A
    yardstick only: the port never calls it. Its normalised f32 grid
    places samples to ~1e-4 px, so at HDR edges it differs from K5 by up
    to ~1e-3 of the history's range."""
    from basicrenderer_tpu_torch.ops import taa_warp
    Hp, Wp, C = hist.shape
    ty, tx = Hp // th, Wp // tw
    dy = torch.clamp(tdy, -(taa_warp.PAD_Y - 2.0), taa_warp.PAD_Y - 2.0)
    dx = torch.clamp(tdx, -(taa_warp.PAD_XL - 2.0), taa_warp.PAD_XL - 2.0)
    dyp = dy.view(ty, tx).repeat_interleave(th, 0).repeat_interleave(tw, 1)
    dxp = dx.view(ty, tx).repeat_interleave(th, 0).repeat_interleave(tw, 1)
    ys = torch.arange(Hp, device=hist.device, dtype=torch.float64)[:, None]
    xs = torch.arange(Wp, device=hist.device, dtype=torch.float64)[None, :]
    gx = (2.0 * (xs + dxp.double() + 0.5) / Wp - 1.0).float()
    gy = (2.0 * (ys + dyp.double() + 0.5) / Hp - 1.0).float()
    grid = torch.stack([gx, gy], -1)[None].contiguous()
    planes = hist.permute(2, 0, 1)[None].contiguous()

    def run():
        return torch.nn.functional.grid_sample(
            planes, grid, mode="bilinear", padding_mode="border",
            align_corners=False)

    ms = cuda_ms(torch, run, 20)
    err = float((run()[0].permute(1, 2, 0) - ref).abs().max())
    scale = float(hist.abs().max())
    check(err <= 1e-2 * scale, f"grid_sample yardstick differs from K5 by "
          f"{err} (history range {scale})")
    return ms, err


def profile_frames(torch, step, wall_ms, label, n=5):
    """torch.profiler over n calls of `step()` (one steady frame each):
    device time per frame (sum of kernel times on the one stream), its
    share of the unprofiled wall time, kernel launches per frame, and the
    kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / n
    launches = sum(e.count for e in kern) / n
    top = sorted(kern, key=lambda e: e.self_device_time_total, reverse=True)
    say(f"{label} profile ({n} frames, torch.profiler): device busy {busy:.3f} "
        f"ms/frame = {100 * busy / wall_ms:.1f}% of the unprofiled median "
        f"{wall_ms:.3f} ms | {launches:.0f} kernel launches/frame | top: "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / n:.3f} ms"
                    f" x{e.count / n:.0f}" for e in top[:12]))


if __name__ == "__main__":
    sys.exit(main())
