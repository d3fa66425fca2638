#!/usr/bin/env python3
"""Smoke run of basicrenderer_tpu_torch, the PyTorch + CUDA port, on one
NVIDIA GPU (written for an H100).

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --quick    # phases 1-5 only (build and checks)
    python3 chip_smoke.py --profile  # every phase, then a torch.profiler
                                     # trace of 5 frames of slices 2, 3,
                                     # 3b and 4
    python3 chip_smoke.py --only 6,14  # phases 1-2 and the named ones
                                       # of 6-18, with the phases whose
                                       # scenes they reuse (no kernels
                                       # line and no result)

Run from the root of a checkout. Phases, one line each:
 1. the card and toolchain;
 2. one build of every kernel (one nvcc per source, all started together),
    each instance's registers, and the blocks an SM that each K1/K2 mode,
    K3, K5 and each of K6's three kernels launch;
 3. every kernel against its plain PyTorch version on the card, on small
    inputs: K1 and K2 (plain and seeded) exact on vis and depth, K3 and K4
    within their tolerances (K3 on the rig's frame and on a 1024x500 case
    with tiles at 64 and 0 lights, point and spot, warps with no valid
    pixel and warps with some: its largest ulp distance, and +0.0 at every
    invalid pixel), K4 and its BC3 mode on random windows with no live
    mask, all pixels live, all dead and jobs partly dead (exact: 0 at the
    dead pixels), K4's BC3 mode on the windows of a BC3-textured 512x512
    frame, K5 (the TAA history
    warp) exact on random history at 64x256 and 1088x1920 (and with 4
    channels at 64x256) with shifts past the clip limits, K1's and K2's peel and accum modes and K6 (the
    attribute resolve) exact on random 512x512 scenes with a random seed
    depth, peel bound and accum payload, K6 also on a random vis drawn
    from every row's id and with 64x128 tiles; K1's seeded mode, the
    tangent instances of K1's and K2's plain, seeded and peel modes and
    K6's tangent mode exact on a random 512x512 scene with a random
    tangent angle per triangle (K6 also on a random vis); K2's accum mode on a skewed scene (one tile's walk
    ~6,000 rows over half the tile) at group_rows 8 and 32 and K1's on the
    same scene binned per triangle, each banded launch also timed alone,
    and both on the tie case;
 4. the 128x128 golden scene against tests/goldens/basic_deferred.png and
    against the port on the CPU; the flagship frame of
    __graft_entry__.entry() (256x128) against the port on the CPU; the
    clod_textured frame against tests/goldens/clod_textured.png;
 5. the 512x512 cluster rig (tests/test_goldens_512.py) against
    g512_occlusion.png, g512_clustered.png, g512_gtao_bloom.png,
    g512_taa.png, g512_ssr.png, g512_clod_textured_ibl.png,
    g512_alpha_mask.png (full-rate mask pass), g512_vsm.png (4 VSM steps)
    and g512_oit.png (OIT at its defaults), its alpha-MASK frame on the
    card against the port on the CPU, and 4-frame moving-camera sequences
    (graph/temporal.py, motion-vector resolve) on the card against the
    same sequences on the CPU: TAA + SSR, then with IBL, then bench.py's
    `full` toggles (textures with normal maps, VSM, IBL, the post stack)
    once over the RGBA8 atlas and once over the BC3 atlas, then
    `full_oit`'s (full + OIT with two layers and transmission over the
    glass quad, a second alpha-MASK peel);
 6. slice 1 at full size: the triangle-soup frame of a ~1.36M-triangle
    courtyard at 1920x1080, timed, K1 timed against its plain version;
 7. slice 2 at full size: the cluster-LOD frame of bench.py's
    config1_minimal (two-phase HZB occlusion, clustered lights, alpha-MASK
    pass) over the dense LOD courtyard with 1000 point lights, timed with
    per-stage CUDA events; K2, K3 and K4 timed alone against their plain
    versions on the frame's own inputs (K4 with its live jobs and pixels
    and its bound counted with and without the live mask); K3's lights
    per tile, the share of
    warp-light iterations its warp skip saves, its light loop's SASS
    instructions (cuobjdump) and the issue-rate floor they give;
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
    launches they make; K4 per format (each launch's live jobs and
    pixels) and K2's VSM page launches checked and timed alone against
    their bounds and plain versions on a frame's own inputs; atlas bytes
    per format; the RMSE of full_bc3 against full;
    each format's peak memory; then `full` with a held camera until the
    VSM cache converges;
10. slice 4 at full size: bench.py's `full_oit` (full + OIT, two layers,
    512 transparent clusters, transmission, two alpha-MASK peels) over
    the same courtyard with one palette material made glass and one a
    striped alpha-MASK material, the same orbit; timed with per-stage
    CUDA events (the OIT stages and the second mask peel); launches per
    frame of every K1/K2 mode; the transparent cut, the OIT pairs and
    the overflow; K2's peel and accum launches of one captured frame
    checked and timed alone against their bounds (operations and bytes)
    and plain versions, with the accum launch's rows walked per tile;
    K1's peel and accum modes and K6 timed on that frame's transparent
    rows binned per triangle (K6 against K1's fused channels); then a
    few frames with group_binning=False and no occlusion, the frame path
    through K1's peel and accum modes;
11. vertex tangents at full size: bench.py's `full` with
    enable_vertex_tangents over phase 9's normal-mapped courtyard and
    orbit, timed in turns with `full` (off, on, on, off) in the same call;
    K2's tangent launches of one captured frame (phase 1, phase 2 seeded,
    mask pass, VSM pages) checked against the plain version and timed
    alone, the VSM pages' depth against the same launches without the
    tangent channel; K1's and K2's peel+tangent modes on random rows at
    1920x1088; a 4-frame moving `full` + tangents sequence on the 512x512
    rig card vs CPU;
12. the soup frame's two-phase occlusion at full size: phase 6's
    courtyard with enable_occlusion, the camera orbiting so that objects
    are uncovered, timed with per-stage CUDA events; phase-1 objects,
    candidates and phase-2 survivors per frame; K1's seeded launch of one
    captured frame checked and timed alone, and a random seeded case at
    1920x1088; the same frame with enable_vertex_tangents (K1's
    plain+tangent and seeded+tangent launches checked, K6's tangent mode
    on the captured phase-1 layer against K1's fused channels); then the
    cluster path of config1_minimal with group_binning=False and
    occlusion for 3 frames (K1 seeded on clustered rows);
13. bench.py's own scene at full size: assets/city.glb through the port's
    glTF importer and cluster-LOD build (5,097,780 source triangles, 988 +
    12 point lights, the bench's capacities and hero camera), rendered at
    1920x1080 in config1_minimal, full and full_taau (a 1280x720 render
    presented at 1920x1080) through graph/temporal.py, timed with
    per-stage CUDA events; K4's alpha-MASK launch over the `leaf` jobs
    and K5's launch on the 1080x1920 output-size history checked (exact)
    and timed alone; full_taau and full against the native max-quality
    full frame (bench.py's rmse_vs_max_quality); a 4-frame moving
    full_taau sequence (256x128 presented at 512x256) on the card against
    the CPU;
14. shadow maps and the OpenPBR lobes at full size: (a) city-1080p-shadows,
    phase 13's city in config1_minimal with enable_shadows (4 cascades at
    1024^2), energy compensation and the Renderer's shadow caps (4 spot
    slots at 512^2, 2 cubes of 256^2 faces) over four shadow-casting spot
    and two shadow-casting point lights added to the hero view, static
    camera, timed with per-stage CUDA events ("shadows", "spot_shadows",
    "cube_shadows"), K2 launches per frame (3 + 20), peak memory, a frame
    with the shadows off for comparison, and one captured frame's K2
    launches on the cascades, spot maps and cube faces held to the plain
    version and timed alone per shape; (b) openpbr-1080p, the OpenPBR rig
    of tests/test_goldens_512.py with a coat and a fuzz sphere at
    1920x1080 with every lobe, OIT with transmission, textures, IBL,
    clustered lights, cascades and a cube-shadowed point light, one
    captured frame's K3 and K4 launches held to the plain version; (c)
    card against CPU, 4 moving frames at 256x128 (vis equal, RMSE <= 1.0
    on every frame): (a)'s flags on tests/test_spot_shadows.py's scene
    (the cluster path, dead spot and cube slots), enable_shadows on
    tests/test_shadows_ibl.py's wall (the soup path: K1 rasters the
    cascades) and (b)'s flags on its rig (every lobe, textures, OIT with
    transmission, IBL); (d) soup-1080p-shadows, phase 6's courtyard with
    enable_shadows: K1 on the soup's cascades at full size, one captured
    frame's cascade launches held to the plain version and timed alone.
    The (a) and (d) frames' K3 launches, with the shadowed lights taken
    out of the tiled loop, are held to the plain version too;
15. the Renderer entry point and Reyes: (a) README.md's quick start
    through Renderer() at the settings' defaults (1280x720, the soup
    frame, 4 cascades, clustered lights, IBL, bloom), 4 frames with the
    cube moving, on the card and with device="cpu" (vis equal, RMSE < 0.1
    every frame; K1 and K3 launch counts); (b) phase 13's city through the
    Renderer at its defaults at 1920x1080: ms/frame, its telemetry stages
    and one frame's profile_fn table, the same FrameConfig driven
    directly (the Renderer's host cost), then with enableSceneOverlap,
    then 8 render_async frames equal to render_to_numpy's; (c) bench.py's
    full_reyes on the city (the cobble ground displaced): diced parents,
    live micro rows and the Reyes overflow, the frame's K2 launches held
    to the plain version and timed alone against their bound; (d)
    tests/test_reyes.py's displaced plane at 1920x1080 (the share of
    pixels the dicing changes) and 4 orbiting frames at 256x256 on the
    card against the CPU (vis equal, RMSE < 0.1);
16. streaming, the voxel tiers, RT reflections and skinning: (a)
    city-1080p-streaming, bench.py's full_streaming settings through the
    Renderer on phase 13's city, phase 14's shadow-casting spot and
    point lights removed (warm until 12 frames load no page,
    capped at 60; the slope of 24 frames over 12; page loads, resident
    groups, launches a frame), one frame's K2 launches held to the plain
    version and timed alone, and a small LOD scene card against CPU with
    synchronous ticks; (b) the same with enableTextureStreaming
    (promotions, demotions); (c) g512_voxel_rt against its golden, the
    city's voxel build and its `full` frame with both voxel tiers, the
    voxel scenes card against CPU; (d) the city's `full` frame with RT
    reflections (the hit share), the mirror scene card against CPU,
    argmin's ties on the card; (e) tests/test_skinning.py's cylinder bent
    over 4 frames at 1920x1080 (its K1 launches held to the plain version
    and timed alone) and at 256x256 card against CPU on the soup and
    cluster paths;
17. every import format: (a) the fixtures of
    basicrenderer_tpu_torch/tools/format_fixtures.py (a textured binary
    FBX, USDA, modern and legacy USDC, USDZ, a textured NIF, binary PLY
    and STL, DAE) through load_model and the Renderer at 256x256 on the
    card and on the CPU (vis equal, RMSE <= 1.0; K1 on every card frame,
    K4 on the textured ones); (b) city-1080p-usdc: assets/city.glb
    exported with export_meshes_usdc and read back with load_usdc (host
    seconds of each, the file's size; every mesh array bit-equal, world
    matrices within f32), models/city.finish_city's LOD and lights, and
    config1_minimal at 1920x1080 (3 warm, 8 timed frames), one captured
    frame's K2 launches (exact) and K3 launch held to the plain versions
    and timed alone;
18. tile sharding (parallel/tile_sharding.py): phase 13's city (built
    when phase 13 did not run), saved as .npz, which each spawned rank
    loads through interop; two frames a run (the second takes
    depth_padded, taa_out and vsm_state back): (a) `full` at 1920x1088,
    tile_h 32, over one rank and NCCL, bit-equal to the unsharded frame
    on the card; (b) the same over 2 ranks of 17 tile rows on the one
    card over gloo (NCCL refuses two ranks on one card; gloo takes the
    CUDA tensors); (c) config1_minimal at 1920x1152, tile_h 16, over 4
    ranks of 18 tile rows (each rank's rows whole 16-row sampler blocks
    at texture_downscale 2), then with group_binning=False (K1); (b) and
    (c) held to the unsharded card frame within
    tests/test_parallel.py's _assert_match limits. Every
    rank holds each K1/K2 launch at tile_row0 > 0 and, past rank 0, each
    K3 and K4 launch to its plain version; rank 1 times its last frame's
    such launches alone. Prints ms/frame per rank and world size,
    launches per rank, the backend and the collectives a rank.
Each kernel timed alone is timed twice: by CUDA events around
back-to-back launches (cuda_ms, the kernels line's `ms`) and by the device
time of its launches in a torch.profiler trace (device_ms, the kernels
line's `device_ms`); a launch shorter than its wrapper's host time reads
the host's pace on the first.
Kernel launch counts (per raster mode: ops/raster.py's MODE_LAUNCHES; K6's
tangent mode: ops/resolve.py's TANGENT_LAUNCHES) are reset just before each
full-size path is driven and read just after. Any failed check raises and the exit code is non-zero.
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
SHADE_RTOL, SHADE_ATOL = 1e-3, 1e-4   # K3 vs plain (tests/test_lighting.py)
TEX_ATOL = 1e-3              # K4 vs plain, on the [0, 255] scale (RGBA8
#                              and BC3: the same f32 operations, 0 expected)
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
# Accum mode, per passing (row, pixel): the depth-warp weight (2 sub, max,
# div, min/max, fma = 7) and the 8 sums (4 fma, 4 add).
ACCUM_FLOPS_PER_FRAGMENT = 15
PEEL_FLOPS_PER_ROW_PIXEL = 15  # the plain test and the peel bound compare
RESOLVE_OPS_PER_ROW_PIXEL = 1  # K6: the id compare; planes where it matches
RESOLVE_FLOPS_PER_MATCH = 16   # four planes at 4
ORBIT_RAD_PER_FRAME = 0.004  # phase 8 camera orbit about the scene's y axis
SLICE1_FRAMES = (2, 10)      # (warm, timed)
SLICE2_FRAMES = (3, 12)
SLICE3_FRAMES = (3, 12)
SLICE3B_FRAMES = (3, 12)
# bench.py:361-365: full_oit's glass.
FULL_OIT_GLASS = dict(transmission_weight=0.9,
                      transmission_color=(0.55, 0.7, 0.65), ior=1.5,
                      roughness=0.05)
SLICE4_FRAMES = (2, 6)
SLICE4_K1_FRAMES = (1, 2)    # phase 10 with group_binning=False
VSM_CONVERGE_FRAMES = 40     # phase 9: static frames allowed to converge
TANGENT_FRAMES = (2, 5)      # phase 11: each of its four runs, in turns
SOUP_OCC_FRAMES = (2, 8)     # phase 12: the soup frame with occlusion
SOUP_OCC_TANGENT_FRAMES = (1, 3)   # phase 12 with enable_vertex_tangents
SOUP_OCC_RAD_PER_FRAME = 0.02      # phase 12's orbit, fast enough that
#                                    objects come out from behind others
# Phase 12's camera: low over the courtyard, so that objects hide others.
SOUP_OCC_CAMERA = dict(position=(14.0, 1.8, 9.0), target=(0.0, 0.6, 0.0))
CLUSTER_K1_FRAMES = (1, 2)   # phase 12, cluster path, group_binning=False


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


def device_parts(torch, fn, reps):
    """{kernel name: mean device ms a call} of `fn()` over `reps` calls
    after a warm call, from a torch.profiler trace of the calls' CUDA
    kernels (and copies): utils/profiling.kernel_times, which scales each
    kernel's mean event duration by its launches a call and takes the
    trace again when it lost events (late in a long process the profiler
    loses a few device events; for a kernel of a few microseconds, every
    other one)."""
    from basicrenderer_tpu_torch.utils.profiling import kernel_times
    try:
        return kernel_times(fn, iters=reps)
    except RuntimeError as e:
        raise CheckFailed(str(e)) from e


def device_ms(torch, fn, reps):
    """Mean device ms of one `fn()` over `reps` calls: the device time of
    every kernel (and copy) a call launches, summed (device_parts). A
    launch shorter than its wrapper's host time reads the host's pace on
    cuda_ms, not here; cuda_ms stays the kernels line's `ms`."""
    return sum(device_parts(torch, fn, reps).values())


def host_ms(torch, fn):
    """(result, ms) of one call of `fn()` ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def sm_clock_mhz():
    """The card's maximum SM clock in MHz (nvidia-smi)."""
    return int(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits", "-i", "0"], capture_output=True, text=True,
        check=True).stdout.strip())


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


def g512_scene(np, fmt="rgba8", maps=False, transmission=False):
    """The shared scene of tests/test_goldens_512.py (without the voxel
    pyramid): a LOD sphere, a cube, a checkered floor, a glass quad, an
    alpha-MASK leaf quad, directional + point + spot lights. With `maps`,
    the floor and the sphere also get a tangent-space normal map and a
    metallic-roughness map (tests/test_torch_full_frame.py's); the atlas
    is stored in `fmt`. With `transmission` the glass takes bench.py's
    full_oit glass (bench.py:361-365: OpenPBR transmission 0.9, colour
    (0.55, 0.7, 0.65), ior 1.5, roughness 0.05)."""
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
    glass_m = mats.add(Material(**{
        "base_color": np.array([0.4, 0.6, 0.9, 0.45], np.float32),
        "roughness": 0.1, "alpha_blend": True,
        **(FULL_OIT_GLASS if transmission else {})}))
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


def flagship_scene(np):
    """__graft_entry__._build_small_inputs(full=False)'s scene (the frame
    of __graft_entry__.entry(), 256x128): a floor, a checkered red cube, a
    gold sphere and a glass cube (the cube mesh instanced twice), a
    directional and a point light; the bridge carries no textures, as
    there."""
    from basicrenderer_tpu_torch.models import procedural
    from basicrenderer_tpu_torch.models.materials import Material, MaterialRegistry
    from basicrenderer_tpu_torch.models.mesh import MeshRegistry
    from basicrenderer_tpu_torch.models.textures import TextureRegistry
    from basicrenderer_tpu_torch.scene.bridge import BridgeCapacities, SceneRenderBridge
    from basicrenderer_tpu_torch.scene.scene import Scene
    meshes, mats = MeshRegistry(), MaterialRegistry()
    checker = TextureRegistry(resolution=64).checkerboard()
    cube = meshes.add(procedural.make_cube(1.0))
    sphere = meshes.add(procedural.make_uv_sphere(0.5, rings=8, sectors=16))
    plane = meshes.add(procedural.make_plane(10.0, 2))
    red = mats.add(Material(base_color=np.array([0.8, 0.1, 0.1, 1], np.float32),
                            base_color_texture=checker))
    gold = mats.add(Material(base_color=np.array([0.9, 0.7, 0.3, 1], np.float32),
                             metallic=1.0, roughness=0.3))
    glass = mats.add(Material(base_color=np.array([0.5, 0.7, 0.9, 0.5],
                                                  np.float32),
                              alpha_blend=True, roughness=0.1))
    sc = Scene()
    sc.create_renderable(plane, 0)
    sc.create_renderable(cube, red, position=(0, 0.5, 0))
    sc.create_renderable(sphere, gold, position=(1.4, 0.5, 0.3))
    sc.create_renderable(cube, glass, position=(0.6, 0.5, 1.2),
                         scale=(0.6, 0.6, 0.6))
    sc.create_directional_light(direction=(-0.4, -1, -0.3), intensity=3.0)
    sc.create_point_light(position=(0, 2, 2), intensity=10.0, range=10.0)
    sc.set_camera(position=(3, 2.5, 4), target=(0, 0.5, 0), aspect=2.0)
    sc.propagate_transforms()
    caps = BridgeCapacities(max_vertices=1 << 12, max_triangles=1 << 12,
                            max_objects=16, max_materials=8, max_lights=8,
                            max_clusters=256)
    return sc, SceneRenderBridge(sc, meshes, mats, caps)


def clod_textured_scene(np):
    """tests/test_goldens.py's clod_textured scene: a cluster-LOD sphere
    with a checkered base colour under one directional light."""
    from basicrenderer_tpu_torch.models import clusters, procedural
    from basicrenderer_tpu_torch.models.materials import Material, MaterialRegistry
    from basicrenderer_tpu_torch.models.mesh import MeshRegistry
    from basicrenderer_tpu_torch.models.textures import TextureRegistry
    from basicrenderer_tpu_torch.scene.bridge import BridgeCapacities, SceneRenderBridge
    from basicrenderer_tpu_torch.scene.scene import Scene
    cl = clusters.build_cluster_lod(
        procedural.make_uv_sphere(1.0, rings=32, sectors=64))
    meshes, mats = MeshRegistry(), MaterialRegistry()
    tex = TextureRegistry(resolution=64)
    checker = tex.checkerboard(a=(1, 1, 1), b=(0.1, 0.1, 0.1), squares=8)
    mid = meshes.add(clusters.to_mesh_data(cl))
    m = mats.add(Material(base_color=np.array([0.9, 0.7, 0.4, 1], np.float32),
                          roughness=0.5, base_color_texture=checker))
    sc = Scene()
    sc.create_renderable(mid, m)
    sc.create_directional_light(direction=(-0.4, -1, -0.3), intensity=3.0)
    sc.set_camera(position=(0, 0.5, 2.8), target=(0, 0, 0), aspect=1.0)
    sc.propagate_transforms()
    caps = BridgeCapacities(max_vertices=1 << 15, max_triangles=1 << 15,
                            max_objects=8, max_materials=4, max_lights=4,
                            max_clusters=1 << 10, max_geom_clusters=1 << 10)
    return sc, SceneRenderBridge(sc, meshes, mats, caps, textures=tex)


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


def ptxas_summary(log):
    """One entry per compiled kernel of an nvcc -Xptxas -v report: its
    name with its integer template arguments, registers and (when any)
    spill bytes; "cached" for a library built earlier."""
    import re
    out, name = [], None
    # (span_tiles_kernel<16,0>: pixels per thread, mode;
    # attr_pixels_kernel<tangent>: the tangent channel.)
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)", ln)
        if m:
            mang = m.group(1)
            # The kernel's own name follows the source's namespace tag
            # (..._raster_cu_<hash><length>span_tiles_kernel...): the
            # shortest <length><name> whose name ends in _kernel (digits
            # of the hash can read as a longer length that also ends
            # there).
            tail = mang.split("_cu_")[-1]
            k = min((tail[g.end():g.end() + int(g.group()[i:])]
                     for g in re.finditer(r"\d+", tail)
                     for i in range(len(g.group()))
                     if tail[g.end():g.end() + int(g.group()[i:])]
                     .endswith("_kernel")), key=len, default=None)
            # Integer template arguments as numbers, the tangent flag
            # (a bool argument) as "tangent" when set.
            args = [v if t == "i" else "tangent"
                    for t, v in re.findall(r"L([ib])(\d+)E", mang)
                    if t == "i" or v == "1"]
            name = (k or mang) + (
                f"<{','.join(args)}>" if args else "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and (m.group(1) != "0" or m.group(2) != "0"):
            out.append(f"{name} SPILLS {m.group(1)}/{m.group(2)} B")
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append(f"{name} {m.group(1)} regs")
    return ", ".join(out) or "cached"


def random_payload(torch, np, lanes, seed):
    """`lanes` with random accum payload bytes on the live rows (lanes 28,
    30, 31, as ops/oit.py packs them)."""
    rng = np.random.default_rng(seed)
    rows = lanes.cpu().numpy().copy()
    n = rows.shape[0]
    live = rows[:, 9] > 0.5
    a8 = rng.integers(0, 256, n)
    od = rng.integers(0, 256, (n, 3))
    col = rng.integers(0, 256, (n, 3))
    rows[:, 30] = np.where(live, a8 + od[:, 0] * 256.0 + od[:, 1] * 65536.0, 0)
    rows[:, 31] = np.where(live, od[:, 2], 0)
    rows[:, 28] = np.where(live, col[:, 0] + col[:, 1] * 256.0
                           + col[:, 2] * 65536.0, 0)
    return torch.as_tensor(rows.astype(np.float32), device=lanes.device)


def random_tangents(torch, np, lanes, seed):
    """`lanes` with a random tangent angle in lane 27 of each live row
    (the setup's encoding: [-pi, pi], +4pi for a negative handedness). Set
    before binning, so every pair row of a triangle carries the same one,
    as the setup's rows do."""
    rng = np.random.default_rng(seed)
    rows = lanes.cpu().numpy().copy()
    n = rows.shape[0]
    theta = rng.uniform(-np.pi, np.pi, n) + np.where(rng.random(n) < 0.5,
                                                     4 * np.pi, 0.0)
    rows[:, 27] = np.where(rows[:, 9] > 0.5, theta, 0)
    return torch.as_tensor(rows.astype(np.float32), device=lanes.device)


def random_seed_buffers(torch, np, raster_out, seed):
    """A seed for the seeded modes: a raster's depth and vis with random
    channels 5-7 (the seed's values the seeded modes keep, or overwrite
    with the tangent channel)."""
    rng = np.random.default_rng(seed)
    d, v, ch = raster_out
    ch = ch.clone()
    ch[5:] = torch.as_tensor(rng.normal(size=tuple(ch[5:].shape))
                             .astype(np.float32), device=ch.device)
    return d, v, ch


def random_band(torch, np, seed, cfg, dev):
    """A random peel band on the padded grid: seed depth in [0, 0.3), bound
    in [0.4, 1) with +inf on a band of columns and 0 on a band of rows."""
    rng = np.random.default_rng(seed)
    H, W = cfg.padded_height, cfg.padded_width
    seed_d = rng.uniform(0.0, 0.3, (H, W)).astype(np.float32)
    bound = rng.uniform(0.4, 1.0, (H, W)).astype(np.float32)
    bound[:, :W // 8] = np.inf
    bound[-H // 16:] = 0.0
    return (torch.as_tensor(seed_d, device=dev),
            torch.as_tensor(bound, device=dev))


def tie_case(torch, np, dev, cfg):
    """The split design's tie case at 512x512: 1024 random triangles with
    random accum payload bytes, each three times (itself; a coplanar twin
    with another id, combo, attribute planes and tangent; a duplicate with
    another tangent), shuffled, so that a tile's equal-z rows lie in
    different spans of its walk. Yields
    (kernel, pairs, spans of the busiest tile) for K1 and K2; checks that
    the busiest tile has more than 3 spans."""
    from basicrenderer_tpu_torch.ops import raster, raster_setup
    rng = np.random.default_rng(18)
    lanes, bbox, valid = random_groups(torch, np, 18, 1024, cfg, dev)
    rows = random_payload(torch, np, random_tangents(torch, np, lanes, 19),
                          20).cpu().numpy()
    n = rows.shape[0]
    live = rows[:, 9] > 0.5
    twin, dup = rows.copy(), rows.copy()
    twin[:, 9] = np.where(live, rows[:, 9] + n, 0)
    twin[:, 10] = np.where(live, rows[:, 10] + 7, 0)
    twin[:, 15:28] = rng.normal(size=(n, 13)).astype(np.float32)
    dup[:, 27] = np.where(live, rng.uniform(-np.pi, np.pi, n), 0)
    perm = torch.as_tensor(rng.permutation(3 * n), device=dev)
    rows = torch.as_tensor(np.concatenate([rows, twin, dup]), device=dev)[perm]
    bbox, valid = torch.cat([bbox] * 3)[perm], torch.cat([valid] * 3)[perm]
    for kname in ("K1", "K2"):
        if kname == "K1":
            prs_ = raster_setup.bin_pairs(rows, bbox, valid, cfg)
            nr = prs_.pair_data.shape[0]
            args = (prs_.tile_offsets, nr, prs_.big_count, nr,
                    raster.SPAN_ROWS)
        else:
            prs_ = raster_setup.bin_groups(rows, bbox, valid, cfg)
            args = (prs_.tile_offsets, prs_.group_ids.shape[0],
                    prs_.big_count, prs_.big_ids.shape[0],
                    raster.SPAN_ROWS // cfg.group_rows)
        q = raster.span_queue(*args)
        check(torch.equal(raster.span_queue_cuda(*args), q),
              f"{kname} tie case: work queue kernel differs from span_queue")
        spans = int((q[2:] - q[1:-1]).max())
        check(spans > 3, f"{kname} tie case: busiest tile has {spans} spans")
        yield kname, prs_, spans


def launches_per_call(torch, fn):
    """CUDA kernels one call of `fn` launches (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


# ---------------------------------------------------------------------------
# Kernel-vs-plain comparisons
# ---------------------------------------------------------------------------

def compare_raster(torch, kernel_out, plain_out, label):
    """Raster kernel vs plain: vis, depth and every channel exactly equal
    (the same f32 operations). Returns the max abs error over depth and
    channels (0)."""
    kd, kv, kch = kernel_out
    pd, pv, pch = plain_out
    nvis, ndepth = int((kv != pv).sum()), int((kd != pd).sum())
    nch = int((kch != pch).sum())
    check(nvis == 0 and ndepth == 0 and nch == 0,
          f"{label}: kernel differs from plain on {nvis} vis / {ndepth} "
          f"depth / {nch} channel values")
    return max(float((kd - pd).abs().max()), float((kch - pch).abs().max()))


def k1_check(torch, pairs, cfg, label, tile_row0=0):
    from basicrenderer_tpu_torch.ops import raster
    return compare_raster(
        torch, raster.raster_tiles_cuda(pairs, cfg, tile_row0),
        raster.raster_tiles_plain(pairs, cfg, tile_row0), label)


def k2_check(torch, pairs, cfg, label, init=None, tile_row0=0):
    from basicrenderer_tpu_torch.ops import raster
    return compare_raster(
        torch, raster.raster_groups_cuda(pairs, cfg, tile_row0, init),
        raster.raster_groups_plain(pairs, cfg, tile_row0, init), label)


def tile_band(pairs, cfg, row0, rows):
    """A shard's view of binned pairs: the config `rows` tile rows tall
    and the slice of the tile offsets from tile row `row0`, as
    parallel/tile_sharding.RowShards.localize cuts it."""
    import dataclasses
    t0 = row0 * cfg.tiles_x
    return (pairs._replace(tile_offsets=pairs.tile_offsets[
        t0:t0 + rows * cfg.tiles_x + 1]),
        dataclasses.replace(cfg, height=rows * cfg.tile_h))


def mode_check(torch, kernel_out, plain_out, label):
    """A peel / accum mode or K6 vs its plain version: every output
    exactly equal (the same f32 operations in the same order). Returns the
    max abs error (0)."""
    errs = []
    for k, p in zip(kernel_out, plain_out):
        check(k.shape == p.shape, f"{label}: shape {tuple(k.shape)} vs "
              f"{tuple(p.shape)}")
        nbad = int((k != p).sum())
        check(nbad == 0, f"{label}: kernel differs from plain on {nbad} "
              "values")
        errs.append(float((k.double() - p.double()).abs().max())
                    if k.numel() else 0.0)
    return max(errs)


def raster_mode_check(torch, pairs, cfg, label, peel=None, accum=False,
                      init=None):
    """K1 (BinnedPairs) or K2 (GroupBinnedPairs) in a seeded, peel or
    accum mode (the tangent instance under cfg.enable_vertex_tangents) on
    the card vs its plain version: every output exact."""
    from basicrenderer_tpu_torch.ops import raster, raster_setup
    if isinstance(pairs, raster_setup.GroupBinnedPairs):
        k = raster.raster_groups_cuda(pairs, cfg, 0, init, peel, accum)
        p = raster.raster_groups_plain(pairs, cfg, 0, init, peel, accum)
    else:
        k = raster.raster_tiles_cuda(pairs, cfg, 0, init, peel, accum)
        p = raster.raster_tiles_plain(pairs, cfg, 0, init, peel, accum)
    return mode_check(torch, k, p, label)


def random_vis(torch, np, pairs, shape, seed):
    """A vis buffer of `shape` on the pairs' device whose pixels show the
    id of any walked row (any tile's or a big row), 0 or -1."""
    rng = np.random.default_rng(seed)
    live = int(pairs.tile_offsets[-1])
    pool = np.concatenate([pairs.pair_data[:live, 9].cpu().numpy()
                           .astype(np.int32), [0, -1]])
    return torch.as_tensor(rng.choice(pool, tuple(shape)), dtype=torch.int32,
                           device=pairs.pair_data.device)


def k6_check(torch, pairs, vis, cfg, label):
    from basicrenderer_tpu_torch.ops import resolve
    return mode_check(torch, (resolve.resolve_attributes_cuda(pairs, vis, cfg),),
                      (resolve.resolve_attributes_plain(pairs, vis, cfg),),
                      label)


def max_ulp(torch, a, b):
    """The largest distance in units in the last place between two f32
    tensors of one shape (+0 and -0 at distance 0)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i >= 0, i, -(i & 0x7FFFFFFF))
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def k3_check(torch, args, label):
    """K3 vs its plain version: within SHADE_RTOL / SHADE_ATOL, and +0.0
    exactly (sign bit included) at every pixel with valid == 0, as the
    kernel's warp skip writes. Returns (max abs err, max ulp)."""
    from basicrenderer_tpu_torch.ops import lighting
    k = lighting.tiled_shade_cuda(*args)
    p = lighting.tiled_shade_plain(*args)
    try:
        torch.testing.assert_close(k, p, rtol=SHADE_RTOL, atol=SHADE_ATOL)
    except AssertionError as e:
        raise CheckFailed(f"{label}: tiled shade kernel vs plain: {e}")
    inv = args[0][11] == 0
    nz = int((k.view(torch.int32)[:, inv] != 0).sum())
    check(nz == 0, f"{label}: {nz} values at valid == 0 pixels are not +0.0")
    return float((k - p).abs().max()), max_ulp(torch, k, p)


def k3_case(torch, np, dev):
    """Phase 3's K3 case: tiled_shade arguments of a 1024x500 frame (tiles
    32x128, padded to 512 rows, 64 light slots a tile) with random G-buffer
    planes; light slots alternate point and spot lights; tile 0 walks all
    64, tile 1 none, the others 1-64 (dead slots with intensity 0, as the
    cull leaves them); sky rows (whole invalid warps), rows invalid on
    every other lane (partly valid warps), one invalid warp inside a tile,
    scattered invalid pixels and the zero pad rows."""
    from basicrenderer_tpu_torch.graph.framedata import FrameConfig
    rng = np.random.default_rng(23)
    cfg = FrameConfig(width=1024, height=500, tile_h=32, tile_w=128)
    H, W = cfg.padded_height, cfg.padded_width
    n = rng.normal(size=(3, H, W))
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    valid = (rng.uniform(0, 1, (H, W)) > 0.1).astype(np.float32)
    valid[0:6] = 0.0
    valid[6:12, ::2] = 0.0
    valid[40:44, 300:332] = 0.0
    shade_in = np.concatenate([
        n, rng.uniform(0, 1, (3, H, W)), rng.uniform(0, 1, (1, H, W)),
        rng.uniform(0.05, 1, (1, H, W)), rng.uniform(-6, 6, (3, H, W)),
        valid[None]]).astype(np.float32)
    shade_in[:, cfg.height:] = 0.0
    nt, mx = cfg.num_tiles, cfg.max_lights_per_cluster
    lights = np.zeros((nt, mx, 16), np.float32)
    lights[..., 0:3] = rng.uniform(-6, 6, (nt, mx, 3))
    lights[..., 3] = np.where(np.arange(mx) % 2 == 0, 1.0, 2.0)
    d = rng.normal(size=(nt, mx, 3))
    lights[..., 4:7] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    lights[..., 7] = rng.uniform(1, 10, (nt, mx))
    lights[..., 8:11] = rng.uniform(0.2, 1, (nt, mx, 3))
    lights[..., 11] = rng.uniform(2, 8, (nt, mx))
    lights[..., 12] = np.cos(0.3)
    lights[..., 13] = np.cos(0.9)
    counts = rng.integers(1, mx + 1, nt).astype(np.int32)
    counts[0], counts[1] = mx, 0
    for t in range(nt):
        lights[t, counts[t]:, 7] = 0.0
    return (torch.as_tensor(shade_in, device=dev),
            torch.as_tensor(lights, device=dev),
            torch.as_tensor(counts, device=dev),
            torch.tensor([3.0, 2.0, 4.0], device=dev), cfg)


def warp_light_share(torch, args):
    """(warp-light iterations of a K3 launch, those its warp skip saves):
    a warp of 32 pixels (row-major within its tile) walks its tile's
    lights unless none of its pixels is valid."""
    shade_in, counts, cfg = args[0], args[2], args[4]
    th, tw = cfg.tile_h, cfg.tile_w
    v = shade_in[11].reshape(cfg.tiles_y, th, cfg.tiles_x, tw).permute(
        0, 2, 1, 3).reshape(cfg.num_tiles, -1, 32)
    n = counts.long().clamp(0, cfg.max_lights_per_cluster)
    skipped = (~(v != 0).any(-1)).sum(1)
    return int((n * v.shape[1]).sum()), int((n * skipped).sum())


def sass_loop(lib_path, kernel):
    """The light loop of `kernel` in `cuobjdump --dump-sass` of the library
    at `lib_path`: the span from the target of a predicated backward branch
    (a not unrolled loop's latch) to that branch, the largest such span.
    Returns (instructions in the span, instructions issued by one trip on
    the common path, all the kernel's instructions, the span's opcodes by
    count). The common path takes every forward branch whose skipped
    instructions hold a CALL (the IEEE divide's and square root's slow
    paths, and the spot-light block, whose divide has one) and no other:
    a point light's iteration with no slow path taken."""
    import collections
    import re
    from basicrenderer_tpu_torch.utils import cuda_build
    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    funcs = [f for f in re.split(r"\n\s*Function : ", sass)[1:]
             if kernel in f.splitlines()[0]]
    check(len(funcs) == 1, f"{kernel}: {len(funcs)} functions in the SASS")
    ins = [(int(a, 16), t.strip()) for a, t in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", funcs[0])]
    branch = re.compile(r"(@!?U?P\w+\s+)?BRA(?:\.\w+)*\s+`?\(?0x([0-9a-f]+)")
    best = None
    for addr, text in ins:
        m = branch.match(text)
        if m and m.group(1) and int(m.group(2), 16) < addr:
            span = (int(m.group(2), 16), addr)
            if best is None or span[1] - span[0] > best[1] - best[0]:
                best = span
    check(best is not None, f"{kernel}: no loop in the SASS")
    body = [(a, t) for a, t in ins if best[0] <= a <= best[1]]
    at = {a: i for i, (a, _) in enumerate(body)}
    issued, i = 0, 0
    while i < len(body):
        addr, text = body[i]
        issued += 1
        m = branch.match(text)
        if m and int(m.group(2), 16) > addr:
            target = int(m.group(2), 16)
            skipped = [t for a, t in body if addr < a < target]
            if not m.group(1) or any(t.split()[0].startswith("CALL")
                                     for t in skipped):
                check(target in at, f"{kernel}: a branch leaves the loop")
                i = at[target]
                continue
        i += 1
    ops = collections.Counter(
        re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0]
        for _, t in body)
    return len(body), issued, len(ins), ops


def rows_per_tile(torch, raster, pairs, cfg):
    """Rows each tile's K2 walk evaluates (after the bbox tests), as a
    (tiles,) tensor."""
    offs = raster.expand_group_pairs(pairs, cfg)[1].long()
    return offs[1:] - offs[:-1]


def skew_case(torch, np, dev, cfg, seed, per_triangle=False):
    """Phase 3's skewed accum scene: 6144 small front-facing triangles
    inside the left half of the first 32x128 tile, then 1024 random ones
    below it, set up by the port with random payload bytes and
    group-binned at cfg.group_rows (K2), or binned per triangle with
    `per_triangle` (K1)."""
    from basicrenderer_tpu_torch.ops import raster_setup
    rng = np.random.default_rng(seed)
    busy, rest = 6144, 1024
    w = rng.uniform(2.0, 10.0, size=(busy + rest, 3, 1))
    x0, y0 = -1.0 + 2.0 * 64 / cfg.width, 1.0 - 2.0 * cfg.tile_h / cfg.height
    c = np.stack([rng.uniform(-0.99, x0, busy),
                  rng.uniform(y0, 0.99, busy)], -1)[:, None, :]
    xy_busy = np.clip(c + rng.uniform(-0.03, 0.03, (busy, 3, 2)),
                      [-0.995, y0 + 0.005], [x0 - 0.005, 0.995])
    xy_rest = np.stack([rng.uniform(-0.9, 0.9, (rest, 3)),
                        rng.uniform(-0.9, y0 - 0.1, (rest, 3))], -1)
    xy = np.concatenate([xy_busy, xy_rest])
    e1, e2 = xy[:, 1] - xy[:, 0], xy[:, 2] - xy[:, 0]
    cw = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0] < 0
    xy[cw] = xy[cw][:, [0, 2, 1]]
    z = rng.uniform(0.05, 0.95, size=(busy + rest, 3, 1))
    clip = torch.as_tensor(np.concatenate([xy * w, z * w, w], -1)
                           .astype(np.float32).reshape(-1, 4), device=dev)
    n = busy + rest
    idx = torch.arange(3 * n, dtype=torch.int32, device=dev).view(n, 3)
    lanes, bbox, valid, _ = raster_setup.triangle_setup_packed(
        clip, idx, torch.ones(n, dtype=torch.bool, device=dev), cfg,
        None, None)
    lanes = random_payload(torch, np, lanes, seed + 1)
    if per_triangle:
        return raster_setup.bin_pairs(lanes, bbox, valid, cfg)
    return raster_setup.bin_groups(lanes, bbox, valid, cfg)


def skew_launch(torch, np, dev, group_rows):
    """Phase 3's skewed K2 accum launch at `group_rows`: (pairs, cfg,
    peel band), the band that of phase 3's random 512x512 scenes."""
    import dataclasses
    from basicrenderer_tpu_torch.graph.framedata import FrameConfig
    cfg512 = FrameConfig(**CFG512)
    scfg = dataclasses.replace(cfg512, group_rows=group_rows)
    return (skew_case(torch, np, dev, scfg, 24 + group_rows), scfg,
            random_band(torch, np, 15, cfg512, dev))


def k1_skew_launch(torch, np, dev):
    """Phase 3's skewed K1 accum launch: (pairs, cfg, peel band), the
    scene of skew_launch binned per triangle, the band of phase 3's random
    512x512 scenes."""
    from basicrenderer_tpu_torch.graph.framedata import FrameConfig
    cfg512 = FrameConfig(**CFG512)
    return (skew_case(torch, np, dev, cfg512, 22, per_triangle=True), cfg512,
            random_band(torch, np, 15, cfg512, dev))


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


def random_rgba8_windows(torch, np, seed, dev, jobs=600, npix=256,
                         nrows=200):
    """Random RGBA8 jobs on `dev`: random texel words, window rows (some
    outside the atlas: the kernel clamps them) and tap centres over every
    lane and window row, some on texel centres."""
    from basicrenderer_tpu_torch.ops import textures
    rng = np.random.default_rng(seed)
    strips = rng.integers(0, 2 ** 32, (nrows, 128), dtype=np.uint64) \
        .astype(np.uint32)
    rows = rng.integers(-2, nrows + 2, (jobs, textures.WROWS)) \
        .astype(np.int32)
    x_hat = (rng.integers(0, 128, (jobs, npix))
             + rng.uniform(0, 1, (jobs, npix))).astype(np.float32)
    x_hat[:, :16] = np.floor(x_hat[:, :16])
    yf = (rng.integers(0, textures.WROWS - 1, (jobs, npix))
          + rng.uniform(0, 1, (jobs, npix))).astype(np.float32)
    return tuple(torch.as_tensor(a, device=dev) for a in
                 (strips.view(np.int32), rows, x_hat, yf))


def live_masks(torch, np, seed, shape, dev):
    """K4's `live` masks of phase 3: none given, all live, all dead, and
    a mask with a third of the jobs dead, a third live and a third live
    at random pixels (about half)."""
    rng = np.random.default_rng(seed)
    jobs = shape[0]
    part = rng.uniform(size=shape) < 0.5
    part[:jobs // 3] = False
    part[jobs // 3:2 * jobs // 3] = True
    return (("no mask", None),
            ("all live", torch.ones(shape, dtype=torch.bool, device=dev)),
            ("all dead", torch.zeros(shape, dtype=torch.bool, device=dev)),
            ("partly dead", torch.as_tensor(part, device=dev)))


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


def bc3_tapped(torch, x_hat, yf, live=None):
    """(distinct blocks, distinct texels) of the BC3 windows that the
    pixels' taps read (only the live pixels' with a `live` mask): two lanes
    (floor(x_hat) and the next, wrapping at 128) on two texel rows
    (floor(yf) and the next, inside the window's BC_TEXEL_ROWS), per job."""
    from basicrenderer_tpu_torch.ops import textures
    WR = textures.BC_TEXEL_ROWS
    jobs, pix = x_hat.shape
    jid = torch.arange(jobs, device=x_hat.device)[:, None].expand(jobs, pix)
    l0 = torch.floor(x_hat).long() & 127
    r0 = torch.floor(yf).long()
    blocks, texels = [], []
    for r in (r0, r0 + 1):
        ok = (r >= 0) & (r < WR)
        if live is not None:
            ok = ok & live.bool()
        for lane in (l0, (l0 + 1) & 127):
            texels.append(((jid * WR + r) * 128 + lane)[ok])
            blocks.append(((jid * (WR // 4) + r // 4) * 32 + lane // 4)[ok])
    return (int(torch.unique(torch.cat(blocks)).numel()),
            int(torch.unique(torch.cat(texels)).numel()))


def k4_bound(torch, args, bc3):
    """(bound ms, by) of one K4 launch on `args` (strips, rows, x_hat, yf
    and the `live` mask, when given), counting what the function with the
    mask must do: the distinct window rows and the row ids of the jobs
    with a live pixel, the live pixels' tap centres, the mask, and every
    RGBA written; the operations of the live pixels' evaluation and, for BC3,
    of decoding what the live taps read: the palette of each distinct
    block they touch and each distinct texel (at most 4 a pixel)."""
    _strips, rows, x_hat, yf = args[:4]
    live = args[4] if len(args) > 4 else None
    jobs, pix = x_hat.shape
    if live is None:
        live_jobs = torch.ones(jobs, dtype=torch.bool, device=rows.device)
        live_px, mask_bytes = jobs * pix, 0
    else:
        live_jobs = live.bool().any(dim=1)
        live_px, mask_bytes = int(live.bool().sum()), jobs * pix
    njobs = int(live_jobs.sum())
    flops = live_px * TEX_FLOPS_PER_PIXEL
    if bc3:
        nblocks, ntexels = bc3_tapped(torch, x_hat, yf, live)
        flops += nblocks * BC3_FLOPS_PER_BLOCK + ntexels * BC3_OPS_PER_TEXEL
    uniq = int(torch.unique(rows[live_jobs]).numel())
    return bound(flops, uniq * 512 + njobs * rows.shape[1] * 4
                 + live_px * 8 + mask_bytes + jobs * pix * 16)


def k4_live_line(torch, args, bc3):
    """A K4 launch's live jobs and pixels, its bound as k4_bound counts it
    and as it was counted before the live mask (every job's rows and tap
    centres, every pixel's operations)."""
    live = args[4] if len(args) > 4 else None
    jobs, pix = args[2].shape
    b_ms, b_by = k4_bound(torch, args, bc3)
    o_ms, o_by = k4_bound(torch, args[:4], bc3)
    nj = int(live.bool().any(dim=1).sum()) if live is not None else jobs
    npx = int(live.bool().sum()) if live is not None else jobs * pix
    return (f"live jobs {nj} of {jobs}, live pixels {npx} of {jobs * pix}; "
            f"bound {b_ms:.4f} {b_by} (counted over every pixel, without "
            f"the mask: {o_ms:.4f} {o_by})")


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


def map_bound(walked, cfg):
    """(bound ms, by) of one depth-only shadow-map launch walking `walked`
    (row, tile) pairs: each walked row tested on its tile's pixels and
    read once, and the depth plane written (4 bytes a pixel). A map keeps
    only the depth (ops/shadows.render_cascade); the vis and 8 channel
    planes K1/K2 write there too are no work the map needs."""
    return bound(walked * cfg.tile_h * cfg.tile_w * RASTER_FLOPS_PER_ROW_PIXEL,
                 walked * 128 + cfg.padded_height * cfg.padded_width * 4)


def random_warp(torch, np, seed, shape, dev, tile=(32, 128), channels=3):
    """Random history (H, W, channels) and per-tile shifts on `dev`:
    uniform over +-80 rows / +-220 columns (past the clip limits), the
    first tiles exactly on the limits and on negative fractions."""
    rng = np.random.default_rng(seed)
    H, W = shape
    T = (H // tile[0]) * (W // tile[1])
    dy = rng.uniform(-80, 80, T).astype(np.float32)
    dx = rng.uniform(-220, 220, T).astype(np.float32)
    dy[:4] = (70.0, -70.0, -0.25, -69.5)
    dx[:4] = (190.0, -190.0, -0.75, -189.25)
    hist = rng.random((H, W, channels)).astype(np.float32)
    return (torch.as_tensor(hist, device=dev), torch.as_tensor(dy, device=dev),
            torch.as_tensor(dx, device=dev)) + tile


def k5_check(torch, args, label):
    """K5 vs its plain version: every value equal (the same f32
    operations). Returns the max abs error (0)."""
    from basicrenderer_tpu_torch.ops import taa_warp
    k = taa_warp.warp_history_tiles(*args)
    p = taa_warp.warp_history_plain(*args)
    check(torch.equal(k, p), f"{label}: history warp kernel differs from "
          f"plain on {int((k != p).sum())} values")
    return float((k - p).abs().max())


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

PTXAS = []   # phase 2's per-library register reports


def main():
    import dataclasses
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
                                             resolve, taa_warp, textures, vsm)
    from basicrenderer_tpu_torch.renderer import kernel_sources
    from basicrenderer_tpu_torch.utils import cuda_build
    from basicrenderer_tpu_torch.utils.png import read_png
    dev = torch.device("cuda", 0)
    # Indices 0-5 are checked by phases 6-9; 6-9 are the peel and accum
    # raster modes (phase 10), 10 K6, 11-13 the plain and seeded modes,
    # 14-21 the seeded and tangent modes (phases 11-12).
    kernels = (raster.raster_tiles_cuda, raster.raster_groups_cuda,
               lighting.tiled_shade_cuda, textures.tex_block_eval_cuda,
               taa_warp.warp_history_tiles, textures.tex_block_eval_bc3_cuda,
               raster.MODE_LAUNCHES[("K1", "peel")],
               raster.MODE_LAUNCHES[("K1", "accum")],
               raster.MODE_LAUNCHES[("K2", "peel")],
               raster.MODE_LAUNCHES[("K2", "accum")],
               resolve.resolve_attributes_cuda,
               raster.MODE_LAUNCHES[("K1", "plain")],
               raster.MODE_LAUNCHES[("K2", "plain")],
               raster.MODE_LAUNCHES[("K2", "seeded")],
               raster.MODE_LAUNCHES[("K1", "seeded")],
               raster.MODE_LAUNCHES[("K1", "plain+tangent")],
               raster.MODE_LAUNCHES[("K1", "seeded+tangent")],
               raster.MODE_LAUNCHES[("K1", "peel+tangent")],
               raster.MODE_LAUNCHES[("K2", "plain+tangent")],
               raster.MODE_LAUNCHES[("K2", "seeded+tangent")],
               raster.MODE_LAUNCHES[("K2", "peel+tangent")],
               resolve.TANGENT_LAUNCHES)
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
    libs = cuda_build.build_all(kernel_sources())
    reports = [f"{src.name}: {ptxas_summary(lib.build_log)}"
               for src, lib in libs.items()]
    PTXAS.extend(reports)
    occupancy = []
    for glabel, gcfg_ in (("1080p", FrameConfig(width=1920, height=1080,
                                                tile_h=32, tile_w=128)),
                          ("VSM page", FrameConfig(width=128, height=128,
                                                   tile_h=32, tile_w=128))):
        for kname in ("K1", "K2"):
            for mname in ("plain", "peel", "accum"):
                n_sm, ppt = raster.blocks_per_sm(kname, mname, gcfg_)
                occupancy.append(f"{kname}-{mname} {glabel} {ppt} px/thread "
                                 f"{n_sm} blocks/SM")
    cfg1080 = FrameConfig(width=1920, height=1080, tile_h=32, tile_w=128)
    k3_occ = lighting.blocks_per_sm(cfg1080)
    k6_occ = ", ".join(f"{k} {n_} blocks/SM"
                       for k, n_ in resolve.blocks_per_sm(cfg1080).items())
    k5_occ = taa_warp.blocks_per_sm(3, 32, 128)
    say(f"phase 2 build: {len(libs)} libraries in {time.perf_counter() - t0:.2f}"
        f" s | ptxas: {' || '.join(reports)} | raster instances launched "
        f"(pass 1 of the split design; accum: one pixel a thread, K1 with "
        f"a producer warp): " + ", ".join(occupancy)
        + f" | K3 tiled_shade_kernel "
        f"1 px/thread {k3_occ} blocks/SM at 64 light slots | K5 "
        f"taa_warp_kernel<3> {k5_occ} blocks/SM on 32x128 tiles | K6 at "
        f"1080p: {k6_occ}")

    only = only_phases(sys.argv[1:])
    if only is not None:
        recs = later_phases(np, torch, dev, kernels, smi, only)
        say(f"phases {sorted(only)} records: " + json.dumps(recs))
        return 0

    # -- 3. kernels vs plain on the card -----------------------------------
    res = []
    for seed in (0, 5):
        cfg = FrameConfig(width=256, height=64, tile_h=16, tile_w=128,
                          max_pairs=1 << 12)
        lanes, bbox, valid = random_groups(torch, np, seed, 60, cfg, dev)
        res.append((f"K1 random{seed}", k1_check(
            torch, raster_setup.bin_pairs(lanes, bbox, valid, cfg), cfg,
            f"K1 random seed {seed}")))
    cfg512 = FrameConfig(**CFG512)
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
    # The same scene on a shard's band of tile rows (from tile row 5, 8
    # rows: its slice of the tile offsets at tile_row0 5), plain and seeded.
    band = slice(5 * cfg512.tile_h, 13 * cfg512.tile_h)
    bpairs, bcfg = tile_band(pairs, cfg512, 5, 8)
    res.append(("K1 random512 tile row 5", k1_check(
        torch, bpairs, bcfg, "K1 512x512 band", tile_row0=5)))
    bgpairs, _ = tile_band(gpairs, cfg512, 5, 8)
    res.append(("K2 random512 tile row 5", k2_check(
        torch, bgpairs, bcfg, "K2 512x512 band", tile_row0=5)))
    res.append(("K2 seeded random512 tile row 5", k2_check(
        torch, bgpairs, bcfg, "K2 seeded 512x512 band", tile_row0=5,
        init=tuple(x[..., band, :].contiguous() for x in seed_bufs))))
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
    k3_err, k3_ulp = k3_check(torch, lc.calls[0][1], "K3 rig")
    res.append(("K3 rig", k3_err))
    k3_args = k3_case(torch, np, dev)
    k3_err, k3_case_ulp = k3_check(torch, k3_args, "K3 case")
    res.append(("K3 case", k3_err))
    k3_all, k3_skip = warp_light_share(torch, k3_args)
    k3_line = (f"K3 max ulp vs plain: rig {k3_ulp}, case {k3_case_ulp} (case "
               f"1024x500: tiles at 64 and 0 lights, point and spot; "
               f"{k3_skip} of {k3_all} warp-light iterations skipped; every "
               f"valid == 0 pixel +0.0)")
    res.append(("K4 rig", k4_check(torch, tc.calls[0][1], "K4 rig")))
    for kname, windows in (("K4", random_rgba8_windows),
                           ("K4-BC3", random_bc3_windows)):
        wargs = windows(torch, np, 11, dev)
        for mname, live in live_masks(torch, np, 12, tuple(wargs[2].shape),
                                      dev):
            label = f"{kname} random, {mname}"
            res.append((label, k4_check(torch, wargs + (live,), label,
                                        bc3=kname == "K4-BC3")))
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
    for seed, shape, c in ((12, (64, 256), 3), (13, (1088, 1920), 3),
                           (14, (64, 256), 4)):
        label = f"K5 random {shape[0]}x{shape[1]}x{c}"
        res.append((label, k5_check(torch, random_warp(
            torch, np, seed, shape, dev, channels=c), label)))
    # The peel and accum modes on random 512x512 scenes with a random seed
    # depth, peel bound and payload (both big lists in use), then K6 on
    # K1's own vis.
    planes = random_payload(torch, np, lanes, 14)
    mpairs = raster_setup.bin_pairs(planes, bbox, valid, cfg512)
    mgpairs = raster_setup.bin_groups(planes, bbox, valid, cfg512)
    band = random_band(torch, np, 15, cfg512, dev)
    for kname, prs_ in (("K1", mpairs), ("K2", mgpairs)):
        for mname, kw in (("peel", dict(peel=band, accum=False)),
                          ("accum", dict(peel=band, accum=True)),
                          ("accum unbanded", dict(peel=None, accum=True))):
            label = f"{kname}-{mname} random512"
            res.append((label, raster_mode_check(torch, prs_, cfg512, label,
                                                 **kw)))
    _, k1_vis, _ = raster.raster_tiles_cuda(mpairs, cfg512)
    res.append(("K6 random512", k6_check(torch, mpairs, k1_vis, cfg512,
                                         "K6 random512")))
    # K6 on any vis (not a raster's: ids of every row, other tiles' too),
    # and on 64x128 tiles (two id tables a tile).
    res.append(("K6 random512 random vis", k6_check(
        torch, mpairs, random_vis(torch, np, mpairs, k1_vis.shape, 25),
        cfg512, "K6 random512 random vis")))
    cfg64 = FrameConfig(**{**CFG512, "tile_h": 64})
    pairs64 = raster_setup.bin_pairs(planes, bbox, valid, cfg64)
    res.append(("K6 random512 tile 64x128 random vis", k6_check(
        torch, pairs64, random_vis(torch, np, pairs64, k1_vis.shape, 26),
        cfg64, "K6 random512 tile 64x128")))
    # K2's accum mode on a skewed scene: one tile's walk thousands of rows
    # long over half the tile, at group_rows 8 and the frames' 32; the
    # banded launch also timed alone (the tile's walk under load, where the
    # captured frame's launch walks few rows).
    skews = []
    for gr in (8, 32):
        spairs, scfg, _ = skew_launch(torch, np, dev, gr)
        walk = rows_per_tile(torch, raster, spairs, scfg)
        check(int(walk[0]) >= 5000 and int(walk[0]) > 4 * int(walk[1:].max()),
              f"skew case (group_rows {gr}): rows per tile {walk.tolist()}")
        for mname, kw in (("accum", dict(peel=band, accum=True)),
                          ("accum unbanded", dict(peel=None, accum=True))):
            label = f"K2-{mname} skew512 gr{gr}"
            res.append((label, raster_mode_check(torch, spairs, scfg, label,
                                                 **kw)))
        s_out = raster.raster_groups_cuda(spairs, scfg, 0, None, band, True)
        s_ms = cuda_ms(torch, lambda: raster.raster_groups_cuda(
            spairs, scfg, 0, None, band, True), 20)
        s_b, s_by, s_walked, s_ops, s_bytes = mode_bound(
            torch, raster, spairs, scfg, True, s_out)
        skews.append(f"K2 group_rows {gr}: busiest tile {int(walk[0])} "
                     f"rows, next {int(walk[1:].max())}, rows walked "
                     f"{s_walked}, fragments {int(s_out[2][7].sum())}, "
                     f"banded launch {s_ms:.4f} ms (bound {s_b:.4f} {s_by}:"
                     f" operations {s_ops:.4f}, bytes {s_bytes:.4f})")
    # K1's accum mode on the same scene binned per triangle: the busiest
    # tile walks ~6,000 own rows, then the big rows.
    k1s_pairs, k1s_cfg, _ = k1_skew_launch(torch, np, dev)
    offs = k1s_pairs.tile_offsets.long()
    walk = offs[1:] - offs[:-1]
    check(int(walk[0]) >= 5000 and int(walk[0]) > 4 * int(walk[1:].max()),
          f"K1 skew case: own rows per tile {walk.tolist()}")
    for mname, kw in (("accum", dict(peel=band, accum=True)),
                      ("accum unbanded", dict(peel=None, accum=True))):
        label = f"K1-{mname} skew512"
        res.append((label, raster_mode_check(torch, k1s_pairs, k1s_cfg,
                                             label, **kw)))
    s_out = raster.raster_tiles_cuda(k1s_pairs, k1s_cfg, 0, None, band, True)
    s_ms = cuda_ms(torch, lambda: raster.raster_tiles_cuda(
        k1s_pairs, k1s_cfg, 0, None, band, True), 20)
    s_b, s_by, s_walked, s_ops, s_bytes = mode_bound(
        torch, raster, k1s_pairs, k1s_cfg, True, s_out)
    skews.append(f"K1: busiest tile {int(walk[0])} own rows + "
                 f"{int(k1s_pairs.big_count)} big rows, next "
                 f"{int(walk[1:].max())} own, rows walked {s_walked}, "
                 f"fragments {int(s_out[2][7].sum())}, banded launch "
                 f"{s_ms:.4f} ms (bound {s_b:.4f} {s_by}: operations "
                 f"{s_ops:.4f}, bytes {s_bytes:.4f})")
    # K1 seeded, and the tangent instances of the plain, seeded and peel
    # modes of both kernels, on the same scene with a random tangent angle
    # per triangle in lane 27 and a seed with random channels 5-7; then K6
    # in tangent mode on K1's own vis.
    tcfg = dataclasses.replace(cfg512, enable_vertex_tangents=True)
    tlanes = random_tangents(torch, np, planes, 16)
    tpairs = raster_setup.bin_pairs(tlanes, bbox, valid, tcfg)
    tgpairs = raster_setup.bin_groups(tlanes, bbox, valid, tcfg)
    seed1 = random_seed_buffers(torch, np, raster.raster_tiles_plain(
        raster_setup.bin_pairs(lanes2, bbox2, valid2, cfg512), cfg512), 17)
    for kname, prs_ in (("K1", tpairs), ("K2", tgpairs)):
        for mname, c_, kw in (("seeded", cfg512, dict(init=seed1)),
                              ("plain+tangent", tcfg, {}),
                              ("seeded+tangent", tcfg, dict(init=seed1)),
                              ("peel+tangent", tcfg, dict(peel=band))):
            label = f"{kname}-{mname} random512"
            res.append((label, raster_mode_check(torch, prs_, c_, label,
                                                 **kw)))
    _, k1_tvis, k1_tch = raster.raster_tiles_cuda(tpairs, tcfg)
    res.append(("K6-tangent random512", k6_check(
        torch, tpairs, k1_tvis, tcfg, "K6-tangent random512")))
    res.append(("K6-tangent random512 random vis", k6_check(
        torch, tpairs, random_vis(torch, np, tpairs, k1_tvis.shape, 27), tcfg,
        "K6-tangent random512 random vis")))
    check(bool((k1_tch[5] != 0).any()), "random512: no tangent written")
    # The split design's tie case: equal-z rows of one tile in different
    # spans, from a seed.
    ties = []
    tie_cfg = dataclasses.replace(cfg512, max_tiles_per_tri=64,
                                  max_pairs=1 << 18)
    tie_tcfg = dataclasses.replace(tie_cfg, enable_vertex_tangents=True)
    for kname, prs_, spans in tie_case(torch, np, dev, tie_cfg):
        for mname, c_, kw in (("seeded", tie_cfg, dict(init=seed1)),
                              ("seeded+tangent", tie_tcfg, dict(init=seed1)),
                              ("plain", tie_cfg, {}),
                              ("peel", tie_cfg, dict(peel=band)),
                              ("accum", tie_cfg, dict(peel=band,
                                                      accum=True))):
            label = f"{kname}-{mname} ties512"
            res.append((label, raster_mode_check(torch, prs_, c_, label,
                                                 **kw)))
        ties.append(f"{kname} busiest tile {spans} spans")
    ties = ", ".join(ties) + (" (seeded, seeded+tangent, plain, peel, accum"
                              " exact; work queue kernel == span_queue)")
    per_call = ", ".join(
        f"{kname}-{mname} {launches_per_call(torch, lambda: fn(prs_, c_, **kw))}"
        for kname, fn, prs_ in (("K1", raster.raster_tiles_cuda, tpairs),
                                ("K2", raster.raster_groups_cuda, tgpairs))
        for mname, c_, kw in (("plain", cfg512, {}),
                              ("seeded", cfg512, dict(init=seed1)),
                              ("peel+tangent", tcfg, dict(peel=band)),
                              ("accum", cfg512, dict(peel=band, accum=True))))
    # The setup's fused multiply-add (raster_setup.fma) must round once on
    # the card, as it does on the CPU and as XLA's contracted setup does.
    fa, fb, fc = (torch.randn(100003, device=dev) * k for k in (1.0, 100.0,
                                                                50.0))
    fma_diff = int((raster_setup.fma(fa, fb, fc)
                    != raster.fma32(fa, fb, fc)).sum())
    check(fma_diff == 0, f"raster_setup.fma differs from the one-rounding "
          f"fused multiply-add on {fma_diff} of 100003 values on the card")
    say("phase 3 kernels vs plain: " + "; ".join(f"{k} max_abs_err {e:.3g}"
                                                  for k, e in res)
        + f" (K1/K2 every mode: vis, depth and channels exact; K3 rtol "
        f"{SHADE_RTOL} atol {SHADE_ATOL}; K4 and K4-BC3 atol {TEX_ATOL} on "
        f"0-255, random windows with each live mask; K5 and K6 every output "
        f"exact) | K1/K2 split "
        f"design tie case: {ties} | accum skew cases: {'; '.join(skews)} "
        f"| {k3_line} | CUDA launches per raster call (torch.profiler): "
        f"{per_call} | setup fma one rounding on the card: 100003 values "
        "exact")

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
    fsc, fbridge = flagship_scene(np)
    fcfg = FrameConfig(width=256, height=128, tile_h=16, tile_w=128,
                       max_pairs=1 << 13)     # __graft_entry__.py:101-104
    f_out = [build_frame_fn(fcfg)(fbridge.build_scene_buffers(device=d),
                                  make_view(*fsc.camera_matrices(aspect=2.0),
                                            device=d), FrameParams.default(d))
             for d in (dev, "cpu")]
    f_agree = float((f_out[0]["vis"].cpu() == f_out[1]["vis"]).float().mean())
    f_rmse = rmse(f_out[0]["image"].cpu().numpy(), f_out[1]["image"].numpy())
    check(f_agree >= 0.999 and f_rmse <= 1.0, f"flagship frame card vs CPU: "
          f"vis agreement {f_agree}, RMSE {f_rmse}")
    csc, cbridge = clod_textured_scene(np)
    ccfg = FrameConfig(width=128, height=128, tile_h=16, tile_w=128,
                       max_pairs=1 << 14, enable_clod=True,
                       enable_textures=True, texture_downscale=1)
    c_img = build_frame_fn(ccfg)(
        cbridge.build_scene_buffers(device=dev),
        make_view(*csc.camera_matrices(aspect=1.0), device=dev),
        FrameParams.default(dev))["image"].cpu().numpy()
    r_clod = rmse(c_img, read_png(os.path.join(REPO, "tests", "goldens",
                                               "clod_textured.png")))
    check(r_clod <= GOLDEN_RMSE_MAX, f"clod_textured RMSE {r_clod}")
    say(f"phase 4 golden: 128x128 RMSE vs basic_deferred.png {r_gold:.4f} "
        f"(limit {GOLDEN_RMSE_MAX}); vs the port on the CPU: RMSE {r_cpu:.4f},"
        f" vis agreement {vis_agree:.5f} | flagship frame 256x128 card vs "
        f"CPU: vis agreement {f_agree:.5f}, RMSE {f_rmse:.4f} (limits 0.999, "
        f"1.0) | clod_textured RMSE vs its PNG {r_clod:.4f} (limit "
        f"{GOLDEN_RMSE_MAX})")

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
            ("g512_vsm", dict(enable_vsm=True), 4),
            ("g512_oit", dict(enable_oit=True), 1)):
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
            ("full_bc3", dict(SEQ_FULL, tex_format="bc3"), "bc3"),
            ("full_oit", SEQ_FULL_OIT, "rgba8")):
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
        say(f"quick run: phases 6-14 skipped; {time.perf_counter() - t_start:.1f} s")
        return 0

    records = later_phases(np, torch, dev, kernels, smi)

    print(json.dumps({"kernels": [records[k] for k in
                                  ("K1", "K2", "K2-VSM", "K3", "K4", "K4-BC3",
                                   "K5", "K1-peel", "K1-accum", "K2-peel",
                                   "K2-accum", "K6", "K1-seeded",
                                   "K1-tangent", "K1-peel-tangent",
                                   "K2-tangent", "K2-peel-tangent",
                                   "K6-tangent", "K4-city", "K5-taau",
                                   "K2-CSM", "K2-spot", "K2-cube",
                                   "K1-CSM", "K2-reyes", "K2-stream",
                                   "K1-skin", "K2-usdc", "K3-usdc",
                                   "K1-shard", "K2-shard", "K3-shard",
                                   "K4-shard")]}),
          flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# The earlier phases whose scenes a phase of 6-18 reuses (phase 18 reuses
# phase 13's city when it ran, and builds it otherwise).
PHASE_NEEDS = {12: {6}, 14: {6, 13}, 15: {13}, 16: {13}}


def only_phases(argv):
    """The phases that `--only N,M,...` names, with those whose scenes
    they reuse; None (every phase) without the flag."""
    if "--only" not in argv:
        return None
    only = {int(p) for p in argv[argv.index("--only") + 1].split(",")}
    for p in list(only):
        only |= PHASE_NEEDS.get(p, set())
    check(only <= set(range(6, 19)), f"--only takes phases 6-18, not {only}")
    return only


def later_phases(np, torch, dev, kernels, smi, only=None):
    """Phases 6-18 in order, or those in `only`: the records of every
    kernel they time."""
    def want(*phases):
        return only is None or any(p in only for p in phases)

    profile = "--profile" in sys.argv[1:]
    records = {}
    soup = []     # phase 6's scene, kept for phases 12 and 14
    if want(6):
        records.update(slice1(np, torch, dev, kernels, soup))
    if want(7, 8, 9, 10, 11, 12):
        yard = list(courtyard(np, torch, dev))   # phase 9 drops its buffers
        if want(7):
            records.update(slice2(np, torch, dev, kernels, smi, yard,
                                  profile=profile))
        if want(8):
            records.update(slice3(np, torch, dev, kernels, smi, yard,
                                  profile=profile))
        if want(9):
            records.update(slice3b(np, torch, dev, kernels, smi, yard,
                                   profile=profile))
        if want(10):
            records.update(slice4(np, torch, dev, kernels, smi, yard,
                                  profile=profile))
        if want(11):
            records.update(slice5_tangents(np, torch, dev, kernels, smi,
                                           yard))
        if want(12):
            records.update(slice5_occlusion(np, torch, dev, kernels, smi,
                                            soup, yard))
        del yard
    city_built = None
    if want(13):
        city_recs, city_built = slice10_city(np, torch, dev, kernels, smi)
        records.update(city_recs)
    if want(14):
        records.update(slice11_shadows(np, torch, dev, kernels, smi,
                                       city_built, soup))
    del soup
    if want(15):
        records.update(slice12_renderer(np, torch, dev, kernels, smi,
                                        city_built))
    if want(16):
        records.update(slice13_streaming(np, torch, dev, kernels, smi,
                                         city_built))
    if want(17):
        records.update(slice14_formats(np, torch, dev, kernels, smi))
    if want(18):
        records.update(slice15_sharding(np, torch, dev, kernels, smi,
                                        city_built))
    del city_built
    return records


def slice1(np, torch, dev, kernels, soup):
    """Phase 6: the soup frame at full size; K1 timed alone and plain.
    Leaves (scene, bridge, buffers, triangles) in the list `soup` for
    phase 12."""
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn, geometry_pass
    from basicrenderer_tpu_torch.graph.framedata import FrameConfig, make_view
    from basicrenderer_tpu_torch.graph.temporal import TemporalState
    from basicrenderer_tpu_torch.ops import raster
    t0 = time.perf_counter()
    sc, bridge, ntris = soup_courtyard(np)
    buf = bridge.build_scene_buffers(device=dev)
    view = make_view(*sc.camera_matrices(aspect=16 / 9), device=dev)
    setup_s = time.perf_counter() - t0
    cfg = FrameConfig(**SOUP_1080P)
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
    check(launches[11] == launches[0]
          and all(x == 0 for i, x in enumerate(launches) if i not in (0, 11)),
          f"slice 1 launched other kernels or modes {launches}")
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
    k1_dev = device_ms(torch, lambda: raster.raster_tiles_cuda(pairs, cfg), 5)
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
        + f" | K1 {k1_ms:.3f} ms (device {k1_dev:.3f}; bound {b_ms:.3f} ms, "
        f"{b_by}) vs plain "
        f"{plain_ms:.1f} ms, max_abs_err {err:.3g} | K1 launches {launches[0]}"
        f" | pairs {counters['num_pairs']}, (row, tile) walked {rows_walked} |"
        f" coverage {coverage:.4f} | peak {peak_gib:.2f} GiB")
    soup.extend((sc, bridge, buf, ntris))
    return {"K1": {
        "name": "raster_tiles (K1, plain mode)", "route": "cuda",
        "source": "basicrenderer_tpu_torch/csrc/raster.cu",
        "replaces": "basicrenderer_tpu/ops/raster_pallas.py:135",
        "launches": launches[0], "max_abs_err": err, "ms": k1_ms,
        "device_ms": k1_dev, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}}


SOUP_1080P = dict(width=1920, height=1080, tile_h=32, tile_w=128,  # phase 6
                  max_pairs=1 << 22, near_clip_tris=4096)
CFG512 = dict(width=512, height=512, tile_h=32, tile_w=128,   # phase 3
              max_pairs=1 << 16, max_tiles_per_tri=8, max_tiles_per_group=4,
              max_group_pairs=1 << 13)
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
    from basicrenderer_tpu_torch.utils import cuda_build
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
    k2_ms = k2_dev = k2_plain = k2_bsum = 0.0
    k2_err = k2_big = 0.0
    k2_by = "operations"
    k2_parts = []
    npix = cfg.tile_h * cfg.tile_w
    for label, (_n, a, kw, kout) in zip(("phase1", "phase2", "mask"), rc.calls):
        p_, c_, r0_, init = a[0], a[1], a[2], a[3] if len(a) > 3 else None
        ms = cuda_ms(torch, lambda: raster.raster_groups_cuda(p_, c_, r0_, init),
                     reps)
        dev_ms = device_ms(torch, lambda: raster.raster_groups_cuda(
            p_, c_, r0_, init), reps)
        k2_dev += dev_ms
        pd, pmsd = host_ms(torch, lambda: raster.raster_groups_plain(
            p_, c_, r0_, init))
        err = compare_raster(torch, kout, pd, f"K2 {label} 1080p")
        b_ms, b_by, walked = k2_bound(raster, p_, c_, r0_, init)
        if b_ms > k2_big:
            k2_big, k2_by = b_ms, b_by
        k2_ms, k2_plain, k2_bsum = k2_ms + ms, k2_plain + pmsd, k2_bsum + b_ms
        k2_err = max(k2_err, err)
        k2_parts.append(f"{label} {ms:.3f} ms (device {dev_ms:.3f}; bound "
                        f"{b_ms:.3f}, plain "
                        f"{pmsd:.0f}, rows walked {walked}, pairs "
                        f"{int(p_.num_pairs)})")
    recs["K2"] = {
        "name": "raster_groups (K2, plain + seeded modes; per frame: phase 1,"
                " phase 2 seeded, mask pass)", "route": "cuda",
        "source": "basicrenderer_tpu_torch/csrc/raster.cu",
        "replaces": "basicrenderer_tpu/ops/raster_pallas.py:252",
        "launches": launches[1], "max_abs_err": k2_err, "ms": k2_ms,
        "device_ms": k2_dev, "plain_ms": k2_plain, "bound_ms": k2_bsum, "bound_by": k2_by,
        "library_ms": None}

    a3 = lc.calls[0][1]
    k3_ms = cuda_ms(torch, lambda: lighting.tiled_shade_cuda(*a3), reps)
    k3_dev = device_ms(torch, lambda: lighting.tiled_shade_cuda(*a3), reps)
    _, k3_plain = host_ms(torch, lambda: lighting.tiled_shade_plain(*a3))
    k3_err, k3_ulp = k3_check(torch, a3, "K3 1080p")
    shade_in, payload, counts = a3[0], a3[1], a3[2]
    pix_lights = int(counts.long().sum()) * npix
    hw = shade_in.shape[1] * shade_in.shape[2]
    b3_ms, b3_by = bound(pix_lights * SHADE_FLOPS_PER_PIXEL_LIGHT
                         + hw * SHADE_FLOPS_PER_PIXEL,
                         shade_in.numel() * 4 + payload.numel() * 4
                         + counts.numel() * 4 + hw * 12)
    # The issue-rate floor: warp-light iterations x the light loop's SASS
    # instructions over the card's warp issue slots (4 an SM and clock).
    loop_span, loop_ins, k3_ins, loop_ops = sass_loop(
        cuda_build.load(lighting.SOURCE).path, "tiled_shade_kernel")
    warp_lights, warp_skipped = warp_light_share(torch, a3)
    issue_hz = (torch.cuda.get_device_properties(0).multi_processor_count * 4
                * sm_clock_mhz() * 1e6)
    floor_all = warp_lights * loop_ins / issue_hz * 1e3
    floor_run = (warp_lights - warp_skipped) * loop_ins / issue_hz * 1e3
    lpt = counts.long().clamp(0, cfg.max_lights_per_cluster).float()
    k3_extra = (f"max ulp {k3_ulp}; lights per tile max {int(lpt.max())} "
                f"median {float(lpt.median()):.0f}; warp-light iterations "
                f"{warp_lights}, {warp_skipped} skipped "
                f"({warp_skipped / max(warp_lights, 1):.4f}); light loop "
                f"{loop_span} SASS instructions of {k3_ins}, {loop_ins} "
                f"issued a point light's trip ("
                + " ".join(f"{k} {v}" for k, v in loop_ops.most_common(12))
                + f"); issue floor {floor_all:.3f} ms over every warp-light, "
                f"{floor_run:.3f} over those walked, at {sm_clock_mhz()} MHz")
    recs["K3"] = {
        "name": "tiled_shade (K3)", "route": "cuda",
        "source": "basicrenderer_tpu_torch/csrc/tiled_shade.cu",
        "replaces": "basicrenderer_tpu/ops/lighting.py:133",
        "launches": launches[2], "max_abs_err": k3_err, "ms": k3_ms,
        "device_ms": k3_dev, "plain_ms": k3_plain, "bound_ms": b3_ms, "bound_by": b3_by,
        "library_ms": None}

    a4 = tc.calls[0][1]
    k4_ms = cuda_ms(torch, lambda: textures.tex_block_eval_cuda(*a4), reps)
    k4_dev = device_ms(torch, lambda: textures.tex_block_eval_cuda(*a4), reps)
    _, k4_plain = host_ms(torch, lambda: textures.tex_block_eval_plain(*a4))
    k4_err = k4_check(torch, a4, "K4 1080p")
    b4_ms, b4_by = k4_bound(torch, a4, bc3=False)
    k4_live = k4_live_line(torch, a4, bc3=False)
    recs["K4"] = {
        "name": "tex_block_eval (K4, RGBA8)", "route": "cuda",
        "source": "basicrenderer_tpu_torch/csrc/tex_block.cu",
        "replaces": "basicrenderer_tpu/ops/textures.py:508",
        "launches": launches[3], "max_abs_err": k4_err, "ms": k4_ms,
        "device_ms": k4_dev, "plain_ms": k4_plain, "bound_ms": b4_ms, "bound_by": b4_by,
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
        + f" | K3 {k3_ms:.3f} ms (device {k3_dev:.3f}; bound {b3_ms:.3f} "
        f"{b3_by}, plain "
        f"{k3_plain:.1f}, {pix_lights // npix} tile-lights; {k3_extra}) | "
        f"K4 {k4_ms:.4f} ms (device {k4_dev:.4f}; plain {k4_plain:.1f}; "
        f"{k4_live}) | "
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
# bench.py's full_oit (bench.py:367-369: full + OIT) over the rig, whose
# glass quad then takes full_oit's transmission.
FULL_OIT = dict(enable_oit=True, oit_layers=2, oit_clusters=512,
                enable_transmission=True, mask_peels=2)
SEQ_FULL_OIT = dict(SEQ_FULL, **FULL_OIT)


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
    sc, bridge = g512_scene(np, fmt=fmt, maps=cfg.enable_textures,
                            transmission=cfg.enable_transmission)
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
                 orbit=None, first=0, on_frame=None,
                 rate=ORBIT_RAD_PER_FRAME):
    """Run warm + timed frames of `scene` with the inputs of `temporal`
    (graph/temporal.py). With `orbit` = (pos0, target, aspect) the camera
    turns `rate` rad per frame about the vertical through target; without,
    it stays. Returns (last output, frame ms list, temporal ms
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
            orbit_camera(np, scene, pos0, target, rate * i, aspect)
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
        k5_dev = device_ms(torch, lambda: taa_warp.warp_history_tiles(*a5),
                           20)
        plain, k5_plain = host_ms(torch, lambda: taa_warp.warp_history_plain(
            *a5))
        k5_err = float((k5_out - plain).abs().max())
        check(torch.equal(k5_out, plain), f"{label}: K5 differs from plain "
              f"on the frame's inputs on {int((k5_out != plain).sum())} "
              f"values (max abs err {k5_err})")
        lib_ms, lib_err, lib_dev = grid_sample_warp(torch, hist, tdy, tdx, th,
                                                    tw, plain)
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
                "device_ms": k5_dev, "plain_ms": k5_plain, "bound_ms": b5_ms, "bound_by": b5_by,
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
            f"{n} frames) | K5 {k5_ms:.4f} ms (device {k5_dev:.4f}; bound "
            f"{b5_ms:.4f} ms {b5_by}) vs plain {k5_plain:.3f} ms vs "
            f"grid_sample {lib_ms:.4f} ms (device {lib_dev:.4f}; max diff "
            f"{lib_err:.2g}), max_abs_err {k5_err:.3g}, max "
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
    k4_ms = k4_dev = k4_plain = k4_bound_ms = k4_big = 0.0
    k4_err, k4_by, k4_parts = 0.0, "bytes", []
    for part, (_n, a4, _kw, k4_out) in zip(("mask", "channels"), tc.calls):
        ms = cuda_ms(torch, lambda: getattr(textures, entry)(*a4), 10)
        dev_ms = device_ms(torch, lambda: getattr(textures, entry)(*a4), 10)
        k4_dev += dev_ms
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
        k4_parts.append(f"{part} {ms:.4f} ms (device {dev_ms:.4f}; plain "
                        f"{p_ms:.2f}; "
                        f"{k4_live_line(torch, a4, bc3)})")
    del tc
    if bc3:
        recs["K4-BC3"] = {
            "name": "tex_block_eval_bc3 (K4, BC3 mode: each tap's texel "
                    "decoded from the block words; per frame: mask pass + "
                    "texture channels)",
            "route": "cuda",
            "source": "basicrenderer_tpu_torch/csrc/tex_block.cu",
            "replaces": "basicrenderer_tpu/ops/textures.py:508 (with "
                        "bc3_decode_rows, :606)",
            "launches": launches[5], "max_abs_err": k4_err,
            "ms": k4_ms, "device_ms": k4_dev, "plain_ms": k4_plain,
            "bound_ms": k4_bound_ms,
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
        p_ms_sum = p_dev = p_plain = p_bound = p_big = 0.0
        p_err, p_by, p_parts = 0.0, "operations", []
        for k, (_n, a, _kw, kout) in enumerate(page_calls):
            pp, pc, pr0 = a[0], a[1], a[2]
            pinit = a[3] if len(a) > 3 else None
            ms = cuda_ms(torch, lambda: raster.raster_groups_cuda(
                pp, pc, pr0, pinit), 10)
            dev_ms = device_ms(torch, lambda: raster.raster_groups_cuda(
                pp, pc, pr0, pinit), 10)
            p_dev += dev_ms
            pd, pl_ms = host_ms(torch, lambda: raster.raster_groups_plain(
                pp, pc, pr0, pinit))
            err = compare_raster(torch, kout, pd, f"K2 VSM page {k}")
            b_ms, b_by, walked = k2_bound(raster, pp, pc, pr0, pinit)
            if b_ms > p_big:
                p_big, p_by = b_ms, b_by
            p_ms_sum, p_plain, p_bound = p_ms_sum + ms, p_plain + pl_ms, \
                p_bound + b_ms
            p_err = max(p_err, err)
            p_parts.append(f"{ms:.4f} ms (device {dev_ms:.4f}; bound "
                           f"{b_ms:.4f} {b_by}, plain "
                           f"{pl_ms:.0f}, rows walked {walked}, pairs "
                           f"{int(pp.num_pairs)})")
        recs["K2-VSM"] = {
            "name": "raster_groups (K2, plain mode, VSM pages: 128x128 "
                    "depth-only ortho page config; per frame: the frame's "
                    "dirty pages)", "route": "cuda",
            "source": "basicrenderer_tpu_torch/csrc/raster.cu",
            "replaces": "basicrenderer_tpu/ops/raster_pallas.py:252",
            "launches": sum(pages), "max_abs_err": p_err, "ms": p_ms_sum,
            "device_ms": p_dev, "plain_ms": p_plain, "bound_ms": p_bound, "bound_by": p_by,
            "library_ms": None}
        page_line = (f" | K2 on the captured frame's {len(page_calls)} VSM "
                     f"pages {p_ms_sum:.4f} ms (device {p_dev:.4f}; bound "
                     f"{p_bound:.4f} ms "
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
        f"({fmt}) per frame {k4_ms:.4f} ms (device {k4_dev:.4f}; bound "
        f"{k4_bound_ms:.4f} ms "
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


def oit_courtyard(np, torch, dev, yard):
    """Phase 10's scene: the phase-7 courtyard with palette[1] made glass
    (alpha_blend, base alpha 0.35, bench.py:361-365's transmission) and
    palette[3] made alpha-MASK (cutoff 0.5) over a 256^2 base texture whose
    alpha has 16-texel stripe holes; a new bridge over the courtyard's
    meshes and texture registry, with the procedural environment. Returns
    (bridge, buffers, host s); the materials are restored after the
    build."""
    import dataclasses
    from basicrenderer_tpu_torch.models.environment import Environment
    from basicrenderer_tpu_torch.scene.bridge import SceneRenderBridge
    built, bridge = yard[0], yard[1]
    t0 = time.perf_counter()
    mats = built.materials.materials
    rgb = [tuple(np.round(m.base_color[:3], 3)) for m in mats]
    glass_i = rgb.index((0.1, 0.5, 0.8))        # palette[1]
    mask_i = rgb.index((0.2, 0.7, 0.25))        # palette[3]
    tex = bridge.textures
    r = tex.resolution
    xx = np.mgrid[0:r, 0:r][1]
    stripes = ((xx // 16) % 2).astype(np.float32)
    t_mask = tex.add(np.dstack([np.full((r, r), c, np.float32)
                                for c in (0.2, 0.7, 0.25)] + [stripes]),
                     srgb=False)
    saved = (mats[glass_i], mats[mask_i])
    mats[glass_i] = dataclasses.replace(
        mats[glass_i], alpha_blend=True,
        base_color=np.array([0.1, 0.5, 0.8, 0.35], np.float32),
        **FULL_OIT_GLASS)
    mats[mask_i] = dataclasses.replace(mats[mask_i], alpha_cutoff=0.5,
                                       base_color_texture=t_mask)
    try:
        env = Environment.procedural(device=dev, use_cache=False)
        bridge_oit = SceneRenderBridge(built.scene, built.meshes,
                                       built.materials, bridge.caps,
                                       textures=tex)
        buf = bridge_oit.build_scene_buffers(env_sh=env.sh,
                                             env_specular=env.spec_mips,
                                             device=dev)
    finally:
        mats[glass_i], mats[mask_i] = saved
    torch.cuda.synchronize()
    return bridge_oit, buf, time.perf_counter() - t0


def k1_walked(torch, pairs, cfg, row0=0):
    """(row, tile) pairs K1 walks: each tile's binned rows, plus each big
    row on every tile its bbox (lanes 11-14) covers; the tile rows are
    row0 .. row0 + cfg.tiles_y - 1 (a shard's, from tile row `row0`)."""
    offs = pairs.tile_offsets.long()
    own = int((offs[1:] - offs[:-1]).sum())
    big = pairs.pair_data[:int(pairs.big_count)]
    nx = (torch.clamp(big[:, 12], max=cfg.tiles_x - 1)
          - torch.clamp(big[:, 11], min=0) + 1).clamp(min=0)
    ny = (torch.clamp(big[:, 14], max=row0 + cfg.tiles_y - 1)
          - torch.clamp(big[:, 13], min=row0) + 1).clamp(min=0)
    return own + int((nx * ny).sum())


def k6_bound(torch, pairs, vis, cfg):
    """(bound ms, by, old bound ms, old by, detail text) of one K6 launch
    from this run's inputs. The bound counts what the function needs: a
    32-byte sector of each walked row's id (own rows once, big rows once,
    not once a tile), 128 bytes a (tile, id) that wins a pixel, the vis
    read and 8 channels written a pixel, and the planes of each covered
    pixel. The old count, kept for comparison, charged every walked
    (row, tile) 128 bytes and a compare a pixel of its tile."""
    N, th, tw = cfg.num_tiles, cfg.tile_h, cfg.tile_w
    pd, dev = pairs.pair_data, pairs.pair_data.device
    n_rows = pd.shape[0]
    offc = pairs.tile_offsets.long().clamp(max=n_rows)
    counts = offc[1:] - offc[:-1]
    own = int(counts.sum())
    nbig = min(int(pairs.big_count), n_rows)
    tiles = torch.arange(N, device=dev)
    own_ids = pd[int(offc[0]):int(offc[0]) + own, 9].to(torch.int32).long()
    own_keys = torch.repeat_interleave(tiles, counts) * 2 ** 32 + own_ids
    big_ids = pd[:nbig, 9].to(torch.int32).long()
    big_keys = (tiles[:, None] * 2 ** 32 + big_ids[None, :]).flatten()
    row_keys = torch.cat([own_keys[own_ids > 0],
                          big_keys[(big_ids > 0).repeat(N)]]).unique()
    vis_t = vis.reshape(cfg.tiles_y, th, cfg.tiles_x, tw).permute(
        0, 2, 1, 3).reshape(N, th * tw).long()
    pix_keys = tiles[:, None] * 2 ** 32 + vis_t
    covered = (vis_t > 0) & torch.isin(pix_keys, row_keys)
    n_cov = int(covered.sum())
    winners = int(pix_keys[covered].unique().numel())
    hw = cfg.padded_height * cfg.padded_width
    b_ms, b_by = bound(n_cov * RESOLVE_FLOPS_PER_MATCH,
                       (own + nbig) * 32 + winners * 128 + hw * (4 + 32))
    walked = int((pairs.tile_offsets[1:] - pairs.tile_offsets[:-1]).long()
                 .sum()) + int(pairs.big_count) * N
    old_ms, old_by = bound(
        walked * th * tw * RESOLVE_OPS_PER_ROW_PIXEL
        + int((vis > 0).sum()) * RESOLVE_FLOPS_PER_MATCH,
        walked * 128 + hw * (4 + 32))
    return (b_ms, b_by, old_ms, old_by,
            f"bound {b_ms:.4f} {b_by}: rows read {own + nbig} ({nbig} big), "
            f"winning (tile, id) {winners}, covered pixels {n_cov}; the old "
            f"count's bound {old_ms:.4f} {old_by}: (row, tile) walked "
            f"{walked} x {th * tw} px")


def mode_bound(torch, raster, pairs, cfg, accum, out):
    """(bound ms, by, rows walked, operations ms, bytes ms) of one peel /
    accum launch: every walked (row, tile) tested on its tile's pixels,
    each walked row read once, the seed and bound read and depth, vis and
    8 channels written; in accum mode also the weight and 8 sums of each
    fragment this run's data passes (channel 7 counts them)."""
    from basicrenderer_tpu_torch.ops import raster_setup
    if isinstance(pairs, raster_setup.GroupBinnedPairs):
        walked = raster.expand_group_pairs(pairs, cfg)[0].shape[0]
    else:
        walked = k1_walked(torch, pairs, cfg)
    npix = cfg.tile_h * cfg.tile_w
    flops = walked * npix * PEEL_FLOPS_PER_ROW_PIXEL
    if accum:
        flops += int(out[2][7].sum()) * ACCUM_FLOPS_PER_FRAGMENT
    hw = cfg.padded_height * cfg.padded_width
    nbytes = walked * 128 + hw * (8 + 40)
    b_ms, b_by = bound(flops, nbytes)
    return (b_ms, b_by, walked, flops / PEAK_F32_FLOPS * 1e3,
            nbytes / PEAK_BYTES * 1e3)


def time_mode_launches(torch, raster, calls, plain_fn, label):
    """Each captured launch (name, args, kwargs, output) of a raster mode
    timed alone by CUDA events and by device time, run by its plain
    version and compared exactly. Returns (ms, plain ms, bound ms,
    bound_by of the largest, max abs err, parts text, device ms) summed
    over the launches."""
    ms_sum = dev_sum = plain_sum = b_sum = b_big = err = 0.0
    by, parts = "operations", []
    for k, (_n, a, kw, kout) in enumerate(calls):
        fn = getattr(raster, _n)
        ms = cuda_ms(torch, lambda: fn(*a, **kw), 5)
        dev_ms = device_ms(torch, lambda: fn(*a, **kw), 5)
        dev_sum += dev_ms
        pout, p_ms = host_ms(torch, lambda: plain_fn(*a, **kw))
        err = max(err, mode_check(torch, kout, pout, f"{label} launch {k}"))
        accum = bool(a[-1])
        b_ms, b_by, walked, ops_ms, bytes_ms = mode_bound(
            torch, raster, a[0], a[1], accum, kout)
        if b_ms > b_big:
            b_big, by = b_ms, b_by
        ms_sum, plain_sum, b_sum = ms_sum + ms, plain_sum + p_ms, b_sum + b_ms
        parts.append(f"{ms:.4f} ms (device {dev_ms:.4f}; bound {b_ms:.4f} "
                     f"{b_by}: operations {ops_ms:.4f}, bytes "
                     f"{bytes_ms:.4f}; plain "
                     f"{p_ms:.0f}, rows walked {walked}, pairs "
                     f"{int(a[0].num_pairs)}"
                     + (f", fragments {int(kout[2][7].sum())}" if accum
                        else "") + ")")
    return ms_sum, plain_sum, b_sum, by, err, "; ".join(parts), dev_sum


def oit_frames(np, torch, dev, kernels, built, bridge, buf, cfg, orbit,
               frames, entry):
    """Warm + timed frames of `cfg` over `buf` along `orbit`, then one
    captured frame: (last output, frame ms, temporal ms, stage medians,
    launches by kernel index, per-frame oit_overflow, captured `entry`
    launches, captured compactions, captured bin_clustered calls)."""
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn
    from basicrenderer_tpu_torch.graph.temporal import TemporalState
    from basicrenderer_tpu_torch.ops import clod, raster, raster_setup
    fr = build_frame_fn(cfg)
    temporal = TemporalState(cfg, device=dev)
    warm, timed = frames
    ovf = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(kernels)
    out, frame_ms, inputs_ms, stages = timed_frames(
        torch, np, fr, buf, built.scene, bridge, temporal, warm, timed, orbit,
        on_frame=lambda o: ovf.append(int(o["oit_overflow"])))
    launches = [k.launches for k in kernels]
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    with Capture(raster, [entry]) as rc, \
            Capture(clod, ["compact_visible_tris"]) as cc, \
            Capture(raster_setup, ["bin_clustered"]) as bc:
        timed_frames(torch, np, fr, buf, built.scene, bridge, temporal, 1, 0,
                     orbit, first=warm + timed)
    torch.cuda.synchronize()
    return (out, frame_ms, inputs_ms, stages, launches, ovf, peak_gib,
            rc.calls, cc.calls, bc.calls)


def slice4(np, torch, dev, kernels, smi, yard, profile=False):
    """Phase 10: bench.py's full_oit (full + OIT: two layers, 512
    transparent clusters, transmission, two alpha-MASK peels) over the
    courtyard with a glass and a striped alpha-MASK palette material,
    orbiting as phase 9 through graph/temporal.py: the default group
    binning (K2's peel and accum modes), then group_binning=False without
    occlusion (K1's peel and accum modes; phase 12 runs the cluster path's
    K1 seeded). Each mode's launches of one captured frame are checked and
    timed alone; K6 re-resolves the K1 frame's first layer."""
    import dataclasses
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn
    from basicrenderer_tpu_torch.graph.framedata import FrameConfig
    from basicrenderer_tpu_torch.graph.temporal import TemporalState
    from basicrenderer_tpu_torch.ops import raster, resolve
    built = yard[0]
    orbit = (built.scene.camera_matrices(aspect=16 / 9)[2].copy(),
             np.asarray(built.scene._camera_target, np.float64), 16 / 9)
    bridge, buf, build_s = oit_courtyard(np, torch, dev, yard)
    cfg = FrameConfig(**CONFIG1_MINIMAL, **FULL, **FULL_OIT)
    order = ["cut", "hzb", "setup", "bin", "raster", "hzb2", "cut2", "setup2",
             "bin2", "raster2", "mask", "mask_peel2", "gbuffer", "textures",
             "normal_map", "vsm", "light_cull", "tiled_shade", "shade", "ssr",
             "gtao", "ibl", "oit_cut", "oit_setup", "oit_bin", "oit_peel0",
             "oit_peel1", "oit_accum", "oit_shade", "oit_composite", "motion",
             "taa", "bloom", "exposure"]
    names = ("K1", "K2", "K3", "K4", "K5", "K4-BC3", "K1-peel", "K1-accum",
             "K2-peel", "K2-accum", "K6", "K1-plain", "K2-plain", "K2-seeded")
    recs, lines = {}, []
    # The K1 variant bins every visible triangle per tile: the soup
    # frame's pair capacity (phase 6) in place of config1's 2^18.
    for variant, vcfg, frames, entry in (
            ("K2", cfg, SLICE4_FRAMES, "raster_groups_cuda"),
            ("K1", dataclasses.replace(cfg, group_binning=False,
                                       enable_occlusion=False,
                                       max_pairs=1 << 22),
             SLICE4_K1_FRAMES, "raster_tiles_cuda")):
        (out, frame_ms, inputs_ms, stages, launches, ovf, peak_gib, calls,
         comps, bins) = oit_frames(np, torch, dev, kernels, built, bridge,
                                   buf, vcfg, orbit, frames, entry)
        n = sum(frames)
        img, vis = out["image"], out["vis"]
        check(tuple(img.shape) == (vcfg.height, vcfg.width, 3)
              and img.dtype == torch.uint8,
              f"full_oit ({variant}) image {tuple(img.shape)} {img.dtype}")
        check(bool(torch.isfinite(out["hdr"]).all()), "non-finite HDR values")
        check(float(img.float().std()) > 5.0, "flat image")
        peel_i, accum_i = (8, 9) if variant == "K2" else (6, 7)
        # Per frame: the second mask peel and at least the first OIT layer
        # peel; the tail whenever the last layer has coverage.
        check(launches[peel_i] >= 2 * n and launches[accum_i] >= 1,
              f"full_oit ({variant}): {variant} peel / accum launched "
              f"{launches[peel_i]} / {launches[accum_i]} times in {n} frames")
        other = (6, 7) if variant == "K2" else (8, 9)
        check(all(launches[i] == 0 for i in other) and launches[10] == 0,
              f"full_oit ({variant}) launched other modes: {launches}")
        oit_comp = comps[-1][3]
        oit_pairs = bins[-1][3]
        cut_live = int((oit_comp.slot_cluster >= 0).sum())
        cap = (vcfg.max_group_pairs if variant == "K2"
               else min(vcfg.oit_max_pairs, vcfg.max_pairs))
        plain_fn = (raster.raster_groups_plain if variant == "K2"
                    else raster.raster_tiles_plain)
        mode_calls = {m: [c for c in calls if c[1][-2] is not None
                          and bool(c[1][-1]) == (m == "accum")]
                      for m in ("peel", "accum")}
        check(len(mode_calls["peel"]) >= 2 and len(mode_calls["accum"]) == 1,
              f"captured full_oit ({variant}) frame: peel / accum launches "
              f"{len(mode_calls['peel'])} / {len(mode_calls['accum'])}")
        parts = []
        if variant == "K2":
            # The accum launch's walk per tile, as its schedule sees it.
            a_ = mode_calls["accum"][0][1]
            walk = rows_per_tile(torch, raster, a_[0], a_[1]).float()
            tot = float(walk.sum())
            parts.append(
                f"K2-accum rows walked per tile: max {int(walk.max())}, "
                f"median {float(walk.median()):.0f}, total {int(tot)}, "
                f"tiles walking any {int((walk > 0).sum())} of "
                f"{walk.numel()}, busiest tile's share "
                f"{float(walk.max()) / max(tot, 1.0):.4f}")
        for m in ("peel", "accum"):
            ms, p_ms, b_ms, b_by, err, txt, dev_ms = time_mode_launches(
                torch, raster, mode_calls[m], plain_fn,
                f"{variant}-{m} 1080p")
            idx = {"peel": peel_i, "accum": accum_i}[m]
            recs[f"{variant}-{m}"] = {
                "name": f"{'raster_groups' if variant == 'K2' else 'raster_tiles'}"
                        f" ({variant}, {m} mode; per frame: "
                        + ("the second alpha-MASK peel and the OIT layers"
                           if m == "peel" else "the OIT tail") + ")",
                "route": "cuda",
                "source": "basicrenderer_tpu_torch/csrc/raster.cu",
                "replaces": "basicrenderer_tpu/ops/raster_pallas.py:"
                            + ("252" if variant == "K2" else "135"),
                "launches": launches[idx], "max_abs_err": err, "ms": ms,
                "device_ms": dev_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None}
            parts.append(f"{variant}-{m} {ms:.4f} ms per frame (device "
                         f"{dev_ms:.4f}; bound {b_ms:.4f} {b_by}, plain "
                         f"{p_ms:.0f} ms, "
                         f"max_abs_err {err:.3g}) = {txt}")
        k6_line = ""
        if variant == "K1":
            # K6 on the first OIT layer: its own pairs and vis; its
            # channels 0-4 against the layer's fused ones.
            layer0 = [c for c in mode_calls["peel"] if c[1][0] is oit_pairs][0]
            pairs1, kvis, kch = layer0[1][0], layer0[3][1], layer0[3][2]
            before = kernels[10].launches
            k6_out = resolve.resolve_attributes(pairs1, kvis, vcfg)
            torch.cuda.synchronize()
            k6_launches = kernels[10].launches - before
            check(k6_launches == 1, f"K6 launched {k6_launches} times")
            fused_diff = float((k6_out[:5] - kch[:5]).abs().max())
            k6_ms = cuda_ms(torch, lambda: resolve.resolve_attributes_cuda(
                pairs1, kvis, vcfg), 10)
            k6_parts = device_parts(
                torch, lambda: resolve.resolve_attributes_cuda(pairs1, kvis,
                                                               vcfg), 10)
            k6_dev = sum(k6_parts.values())
            k6_plain, k6_pms = host_ms(
                torch, lambda: resolve.resolve_attributes_plain(pairs1, kvis,
                                                                vcfg))
            k6_err = mode_check(torch, (k6_out,), (k6_plain,), "K6 1080p")
            b6_ms, b6_by, _old_ms, _old_by, b6_txt = k6_bound(
                torch, pairs1, kvis, vcfg)
            recs["K6"] = {
                "name": "resolve_attributes (K6; no frame path calls it: "
                        "driven once on phase 10's first OIT layer, "
                        "soup-binned)", "route": "cuda",
                "source": "basicrenderer_tpu_torch/csrc/resolve.cu",
                "replaces": "basicrenderer_tpu/ops/resolve_pallas.py:39",
                "launches": k6_launches, "max_abs_err": k6_err, "ms": k6_ms,
                "device_ms": k6_dev, "plain_ms": k6_pms, "bound_ms": b6_ms, "bound_by": b6_by,
                "library_ms": None}
            k6_line = (f" | K6 on the first layer {k6_ms:.4f} ms (device "
                       f"{k6_dev:.4f} = " + " + ".join(
                           f"{k} {v:.4f}" for k, v in k6_parts.items())
                       + f"; {b6_txt}; plain {k6_pms:.0f} ms, "
                       f"max_abs_err {k6_err:.3g}); channels 0-4 vs K1's "
                       f"fused: max abs diff {fused_diff:.3g}")
        if profile and variant == "K2":
            fr_p = build_frame_fn(vcfg)
            temporal = TemporalState(vcfg, device=dev)
            first = [n + 1]

            def step():
                timed_frames(torch, np, fr_p, buf, built.scene, bridge,
                             temporal, 1, 0, orbit, first=first[0])
                first[0] += 1
            profile_frames(torch, step, statistics.median(frame_ms),
                           "phase 10 full_oit")
        lines.append(
            f"full_oit ({variant}{', group_binning=False, no occlusion' if variant == 'K1' else ''}): "
            f"median {statistics.median(frame_ms):.3f} ms/frame over "
            f"{frames[1]} (min {min(frame_ms):.3f}, max {max(frame_ms):.3f}; "
            f"temporal state host {statistics.median(inputs_ms):.3f} ms) | "
            "stage ms (CUDA events, median): "
            + " ".join(f"{k} {stages[k]:.3f}" for k in order if k in stages)
            + " | launches per frame "
            + " ".join(f"{nm} {launches[i] / n:.2f}"
                       for i, nm in enumerate(names))
            + f" | transparent clusters cut {cut_live} of oit_clusters "
            f"{vcfg.oit_clusters}, OIT pairs {int(oit_pairs.num_pairs)} of "
            f"{cap} (bin overflow {int(oit_pairs.overflow)}), oit_overflow "
            f"per frame {ovf} | " + " || ".join(parts) + k6_line
            + f" | coverage {float((vis > 0).float().mean()):.4f} | peak "
            f"{peak_gib:.2f} GiB")
        del out, calls, comps, bins, mode_calls
    say("phase 10 slice 4: full_oit 1920x1080 over the phase-7 courtyard "
        "(palette[1] glass, palette[3] striped alpha-MASK; new bridge "
        f"{build_s:.1f} s), camera orbit {ORBIT_RAD_PER_FRAME} rad/frame | "
        + " |||| ".join(lines) + f" | {smi}")
    return recs


def registers(pattern):
    """Phase 2's register entries (`name<args> N regs`) whose kernel name
    matches the regular expression `pattern`."""
    import re
    out = []
    for rep in PTXAS:
        for item in rep.split(": ", 1)[-1].split(", "):
            if re.search(pattern, item):
                out.append(item)
    return ", ".join(out) or "not reported (cached build)"


def mode_record(name, source_line, launches, err, ms, plain_ms, b_ms, b_by,
                dev_ms, source="basicrenderer_tpu_torch/csrc/raster.cu"):
    """A kernels-line record of a raster (or resolve) mode."""
    pallas = ("basicrenderer_tpu/ops/resolve_pallas.py" if "resolve" in
              source else "basicrenderer_tpu/ops/raster_pallas.py")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": f"{pallas}:{source_line}", "launches": launches,
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def time_launches(torch, calls, cuda_fn, plain_fn, bound_fn, label):
    """Each captured launch (name, args, kwargs, output) timed alone by
    CUDA events and by device time, run by its plain version and compared
    exactly; returns (ms, plain ms, bound ms, bound_by of the largest, max
    abs err, parts, device ms) summed over the launches. `bound_fn(args,
    output)` gives (bound ms, by, rows walked)."""
    ms_sum = dev_sum = plain_sum = b_sum = b_big = err = 0.0
    by, parts = "operations", []
    for k, (_n, a, kw, kout) in enumerate(calls):
        ms = cuda_ms(torch, lambda: cuda_fn(*a, **kw), 5)
        dev_ms = device_ms(torch, lambda: cuda_fn(*a, **kw), 5)
        dev_sum += dev_ms
        pout, p_ms = host_ms(torch, lambda: plain_fn(*a, **kw))
        err = max(err, mode_check(torch, kout, pout, f"{label} launch {k}"))
        b_ms, b_by, walked = bound_fn(a, kout)
        if b_ms > b_big:
            b_big, by = b_ms, b_by
        ms_sum, plain_sum, b_sum = ms_sum + ms, plain_sum + p_ms, b_sum + b_ms
        parts.append(f"{ms:.4f} ms (device {dev_ms:.4f}; bound {b_ms:.4f} "
                     f"{b_by}, plain {p_ms:.0f}, rows walked {walked})")
    return ms_sum, plain_sum, b_sum, by, err, parts, dev_sum


def k1_bound(torch, a, _out=None, row0=0):
    """(bound ms, by, rows walked) of one K1 launch with args `a` (pairs,
    config, tile_row0, init, ...) at tile row `row0`: each walked row
    tested on its tile's pixels and read once, depth, vis and 8 channels
    written (and read once more when seeded)."""
    pairs, cfg, init = a[0], a[1], a[3]
    walked = k1_walked(torch, pairs, cfg, row0)
    b_ms, b_by = bound(walked * cfg.tile_h * cfg.tile_w
                       * RASTER_FLOPS_PER_ROW_PIXEL,
                       walked * 128 + cfg.padded_height * cfg.padded_width
                       * 40 * (2 if init is not None else 1))
    return b_ms, b_by, walked


def slice5_tangents(np, torch, dev, kernels, smi, yard):
    """Phase 11: bench.py's `full` with enable_vertex_tangents over phase
    9's normal-mapped courtyard and orbit, in turns with `full` (off, on,
    on, off: each run from the same start with a fresh temporal state, so
    VSM pages go dirty alike); K2's tangent launches of one captured frame
    checked and timed alone, the VSM pages' depth against the same
    launches without the tangent channel; K1's and K2's peel+tangent
    modes on random rows; a moving `full` + tangents sequence card vs
    CPU on the 512x512 rig."""
    import dataclasses
    import gc
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn
    from basicrenderer_tpu_torch.graph.framedata import FrameConfig
    from basicrenderer_tpu_torch.graph.temporal import TemporalState
    from basicrenderer_tpu_torch.models.environment import Environment
    from basicrenderer_tpu_torch.ops import raster, raster_setup
    built, bridge = yard[0], yard[1]
    orbit = (built.scene.camera_matrices(aspect=16 / 9)[2].copy(),
             np.asarray(built.scene._camera_target, np.float64), 16 / 9)
    t0 = time.perf_counter()
    env = Environment.procedural(device=dev, use_cache=False)
    buf = bridge.build_scene_buffers(env_sh=env.sh, env_specular=env.spec_mips,
                                     device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    base = FrameConfig(**CONFIG1_MINIMAL, **FULL)
    tan = dataclasses.replace(base, enable_vertex_tangents=True)
    order = ["setup", "setup2", "mask", "gbuffer", "textures", "normal_map",
             "vsm"]
    warm, timed = TANGENT_FRAMES
    n = warm + timed
    runs, imgs, t_launches = [], {}, None
    for label, cfg in (("full", base), ("full+tangents", tan),
                       ("full+tangents", tan), ("full", base)):
        pages = []
        torch.cuda.synchronize()
        reset_launches(kernels)
        out, frame_ms, _in, stages = timed_frames(
            torch, np, build_frame_fn(cfg), buf, built.scene, bridge,
            TemporalState(cfg, device=dev), warm, timed, orbit,
            on_frame=lambda o: pages.append(int(o["vsm_stats"]["rendered"])))
        la = [k.launches for k in kernels]
        on = cfg.enable_vertex_tangents
        # Per frame: phase 1 and the mask pass in plain mode, phase 2
        # seeded, one plain launch per VSM page; all of them the tangent
        # instances with tangents on (the page config keeps the flag).
        plain_i, seeded_i = (18, 19) if on else (12, 13)
        other = (12, 13) if on else (18, 19)
        check(la[plain_i] == 2 * n + sum(pages) and la[seeded_i] == n
              and la[other[0]] == 0 and la[other[1]] == 0 and la[0] == 0,
              f"phase 11 {label}: K2 modes launched {la[12]} plain, "
              f"{la[13]} seeded, {la[18]} plain+tangent, {la[19]} "
              f"seeded+tangent, K1 {la[0]} in {n} frames with {sum(pages)} "
              "VSM pages")
        check(bool(torch.isfinite(out["hdr"]).all()), "non-finite HDR values")
        check(float(out["image"].float().std()) > 5.0, "flat image")
        imgs[label] = out["image"].cpu().numpy()
        if on and t_launches is None:
            t_launches = la[18] + la[19]
        runs.append((label, statistics.median(frame_ms), stages, pages))
        del out
    err_on_off = rmse(imgs["full+tangents"], imgs["full"])

    # One captured frame with tangents (a fresh temporal state: phase 1,
    # phase 2, the mask pass and the dirty VSM pages).
    with Capture(raster, ["raster_groups_cuda"]) as rc:
        timed_frames(torch, np, build_frame_fn(tan), buf, built.scene, bridge,
                     TemporalState(tan, device=dev), 1, 0, orbit)
    torch.cuda.synchronize()
    check(len(rc.calls) >= 4 and rc.calls[1][1][3] is not None,
          f"phase 11 captured frame: {len(rc.calls)} K2 launches")
    labels = ["phase 1", "phase 2", "mask"] + [
        f"page {k}" for k in range(len(rc.calls) - 3)]
    k2_ms, k2_plain, k2_b, k2_by, k2_err, k2_parts, k2_dev = time_launches(
        torch, rc.calls, raster.raster_groups_cuda, raster.raster_groups_plain,
        lambda a, _o: k2_bound(raster, a[0], a[1], a[2], a[3]),
        "K2-tangent 1080p")
    page_depth = 0
    for _n, a, kw, kout in rc.calls[3:]:
        check(a[1].width == base.vsm_page_size, "page launch expected")
        off = raster.raster_groups_cuda(
            a[0], dataclasses.replace(a[1], enable_vertex_tangents=False),
            a[2], a[3])
        page_depth += int((off[0] != kout[0]).sum())
    check(page_depth == 0, f"VSM page depth changed with the tangent "
          f"channel on {page_depth} texels")
    del rc

    # The peel+tangent modes on random rows at 1920x1088.
    rcfg = FrameConfig(width=1920, height=1080, tile_h=32, tile_w=128,
                       max_pairs=1 << 20, max_tiles_per_tri=8,
                       max_tiles_per_group=8, max_group_pairs=1 << 16,
                       enable_vertex_tangents=True)
    lanes, bbox, valid = random_groups(torch, np, 18, 2048, rcfg, dev)
    lanes = random_tangents(torch, np, random_payload(torch, np, lanes, 19),
                            20)
    band = random_band(torch, np, 21, rcfg, dev)
    recs, peel_parts = {}, []
    for kname, prs_, cuda_fn, plain_fn in (
            ("K1", raster_setup.bin_pairs(lanes, bbox, valid, rcfg),
             raster.raster_tiles_cuda, raster.raster_tiles_plain),
            ("K2", raster_setup.bin_groups(lanes, bbox, valid, rcfg),
             raster.raster_groups_cuda, raster.raster_groups_plain)):
        count = raster.MODE_LAUNCHES[(kname, "peel+tangent")]
        count.launches = 0
        kout = raster.raster_tiles(prs_, rcfg, peel=band)
        torch.cuda.synchronize()
        check(count.launches == 1, f"{kname} peel+tangent launched "
              f"{count.launches} times")
        ms, p_ms, b_ms, b_by, err, _parts, dev_ms = time_launches(
            torch, [("", (prs_, rcfg, 0, None, band, False), {}, kout)],
            cuda_fn, plain_fn,
            lambda a, o: mode_bound(torch, raster, a[0], a[1], False, o)[:3],
            f"{kname}-peel+tangent random 1080p")
        recs[f"{kname}-peel-tangent"] = mode_record(
            f"{'raster_tiles' if kname == 'K1' else 'raster_groups'} "
            f"({kname}, peel mode with the tangent channel; driven once on "
            "random rows at 1920x1088, no frame path of this run takes it)",
            "135" if kname == "K1" else "252", 1, err, ms, p_ms, b_ms, b_by,
            dev_ms)
        peel_parts.append(f"{kname}-peel+tangent {ms:.4f} ms (device "
                          f"{dev_ms:.4f}; bound {b_ms:.4f} {b_by}, plain "
                          f"{p_ms:.0f} ms, "
                          f"max_abs_err {err:.3g})")
    recs["K2-tangent"] = mode_record(
        "raster_groups (K2, tangent channel in plain and seeded modes; per "
        "frame of `full` + vertex tangents: phase 1, phase 2 seeded, mask "
        "pass, VSM pages)", "252", t_launches, k2_err, k2_ms, k2_plain, k2_b,
        k2_by, k2_dev)
    del buf
    gc.collect()
    torch.cuda.empty_cache()
    s_agree, s_rmse, s_k5, s_ms, s_pages = moving_sequence(
        np, torch, dev, dict(SEQ_FULL, enable_vertex_tangents=True), "rgba8")
    say("phase 11 vertex tangents: full with enable_vertex_tangents 1920x1080 "
        f"over the phase-9 courtyard and orbit (buffers {build_s:.1f} s), in "
        "turns with full: "
        + " | ".join(f"{lb} median {ms_:.3f} ms/frame over {timed}, stage ms "
                     + " ".join(f"{k} {st[k]:.3f}" for k in order if k in st)
                     + f", VSM pages {pg}" for lb, ms_, st, pg in runs)
        + f" | RMSE full+tangents vs full (same camera, frame {n}) "
        f"{err_on_off:.4f} | K2 tangent launches {t_launches} in {n} frames "
        f"| K2 tangent per captured frame {k2_ms:.4f} ms (device "
        f"{k2_dev:.4f}; bound {k2_b:.4f} "
        f"{k2_by}, plain {k2_plain:.0f} ms, max_abs_err {k2_err:.3g}; every "
        "output exact) = " + "; ".join(f"{lb} {p}" for lb, p in
                                       zip(labels, k2_parts))
        + f" | VSM page depth with vs without the tangent channel: "
        f"{page_depth} texels differ | " + "; ".join(peel_parts)
        + f" | moving full + tangents 512x512, 4 frames, card vs CPU: vis "
        f"agreement {s_agree:.5f}, RMSE {s_rmse:.4f}, K5 {s_k5}, VSM pages "
        f"{s_pages}, CPU {s_ms / 1e3:.1f} s | registers: "
        + registers(r"span_groups|resolve_groups") + f" | {smi}")
    return recs


def slice5_occlusion(np, torch, dev, kernels, smi, soup, yard):
    """Phase 12: phase 6's soup courtyard with enable_occlusion, the camera
    low and orbiting, through graph/temporal.py: per-frame phase verdicts,
    K1's seeded launch of a captured frame checked and timed alone, a
    random seeded case; the same with enable_vertex_tangents (K1's
    plain+tangent and seeded+tangent, K6's tangent mode on the phase-1
    layer); then config1_minimal's cluster path with group_binning=False
    and occlusion (K1 seeded on clustered rows)."""
    import dataclasses
    import gc
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn
    from basicrenderer_tpu_torch.graph.framedata import FrameConfig
    from basicrenderer_tpu_torch.graph.temporal import TemporalState
    from basicrenderer_tpu_torch.ops import culling, raster, raster_setup, resolve
    sc, bridge, buf, ntris = soup
    sc.set_camera(aspect=16 / 9, **SOUP_OCC_CAMERA)
    orbit = (np.asarray(SOUP_OCC_CAMERA["position"], np.float64),
             np.asarray(SOUP_OCC_CAMERA["target"], np.float64), 16 / 9)
    cfg = FrameConfig(width=1920, height=1080, tile_h=32, tile_w=128,
                      max_pairs=1 << 22, near_clip_tris=4096,
                      enable_occlusion=True)
    order = ["setup", "hzb", "bin", "raster", "hzb2", "bin2", "raster2",
             "gbuffer", "shade"]
    warm, timed = SOUP_OCC_FRAMES
    n = warm + timed
    temporal = TemporalState(cfg, device=dev)
    fr = build_frame_fn(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(kernels)
    with Capture(culling, ["two_phase_object_cull", "occlusion_test_hzb"]) as cc:
        out, frame_ms, _in, stages = timed_frames(
            torch, np, fr, buf, sc, bridge, temporal, warm, timed, orbit,
            rate=SOUP_OCC_RAD_PER_FRAME)
    la = [k.launches for k in kernels]
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check(la[0] == 2 * n and la[11] == n and la[14] == n
          and all(x == 0 for i, x in enumerate(la) if i not in (0, 11, 14)),
          f"phase 12: launches {la} in {n} frames (K1 plain and seeded once "
          "a frame, nothing else)")
    # Per frame: the phase-1 cull (its own HZB test first), then the
    # phase-2 test of the candidates against the fresh HZB.
    verdicts = []
    for i, (name, _a, _kw, res) in enumerate(cc.calls):
        if name == "two_phase_object_cull":
            check(cc.calls[i + 1][0] == "occlusion_test_hzb",
                  "phase-2 occlusion test missing")
            vis1, cand = res
            vis2 = cand & cc.calls[i + 1][3]
            verdicts.append((int(vis1.sum()), int(cand.sum()), int(vis2.sum())))
    del cc
    check(len(verdicts) == n and verdicts[0][1] == 0,
          f"phase verdicts {verdicts} (the first frame has no previous depth)")
    img = out["image"]
    check(tuple(img.shape) == (1080, 1920, 3), f"image {tuple(img.shape)}")
    check(bool(torch.isfinite(out["hdr"]).all()), "non-finite HDR values")
    check(float(img.float().std()) > 5.0, "flat image")
    coverage = float((out["vis"] > 0).float().mean())
    counters = {k: int(out[k]) for k in ("bin_overflow", "num_pairs")}
    check(counters["bin_overflow"] == 0, f"overflow {counters}")
    del out

    # One captured frame: K1's phase-1 and seeded phase-2 launches.
    with Capture(raster, ["raster_tiles_cuda"]) as rc:
        timed_frames(torch, np, fr, buf, sc, bridge, temporal, 1, 0, orbit,
                     first=n, rate=SOUP_OCC_RAD_PER_FRAME)
    torch.cuda.synchronize()
    check(len(rc.calls) == 2 and rc.calls[1][1][3] is not None,
          f"captured frame: {len(rc.calls)} K1 launches")
    p1_ms = cuda_ms(torch, lambda: raster.raster_tiles_cuda(*rc.calls[0][1]),
                    5)
    s_ms, s_plain, s_b, s_by, s_err, s_parts, s_dev = time_launches(
        torch, rc.calls[1:], raster.raster_tiles_cuda,
        raster.raster_tiles_plain, lambda a, _o: k1_bound(torch, a),
        "K1-seeded 1080p")
    s_pairs = int(rc.calls[1][1][0].num_pairs)
    s_won = int((rc.calls[1][3][1] != rc.calls[1][1][3][1]).sum())
    del rc
    # A random seeded case at 1920x1088, whatever the orbit left phase 2.
    rcfg = FrameConfig(width=1920, height=1080, tile_h=32, tile_w=128,
                       max_pairs=1 << 20, max_tiles_per_tri=8)
    la_, bb_, va_ = random_groups(torch, np, 22, 2048, rcfg, dev)
    lb_, bbb_, vb_ = random_groups(torch, np, 23, 1024, rcfg, dev)
    rinit = random_seed_buffers(torch, np, raster.raster_tiles_cuda(
        raster_setup.bin_pairs(lb_, bbb_, vb_, rcfg), rcfg), 24)
    r_err = raster_mode_check(torch, raster_setup.bin_pairs(la_, bb_, va_, rcfg),
                              rcfg, "K1-seeded random 1080p", init=rinit)

    # The same frames with the tangent channel.
    tcfg = dataclasses.replace(cfg, enable_vertex_tangents=True)
    ttemp = TemporalState(tcfg, device=dev)
    tfr = build_frame_fn(tcfg)
    tw, tt = SOUP_OCC_TANGENT_FRAMES
    nt = tw + tt
    torch.cuda.synchronize()
    reset_launches(kernels)
    tout, t_ms, _in, t_stages = timed_frames(
        torch, np, tfr, buf, sc, bridge, ttemp, tw, tt, orbit,
        rate=SOUP_OCC_RAD_PER_FRAME)
    tl = [k.launches for k in kernels]
    check(tl[0] == 2 * nt and tl[15] == nt and tl[16] == nt
          and all(x == 0 for i, x in enumerate(tl) if i not in (0, 15, 16)),
          f"phase 12 with tangents: launches {tl} in {nt} frames")
    del tout
    # The scene has no normal map: at one camera the frames with and
    # without the tangent channel are the same image (fresh temporal
    # states, so both take the same phases).
    same = [timed_frames(torch, np, f_, buf, sc, bridge,
                         TemporalState(c_, device=dev), 1, 0, orbit,
                         rate=SOUP_OCC_RAD_PER_FRAME)[0]
            for f_, c_ in ((fr, cfg), (tfr, tcfg))]
    t_same = (bool(torch.equal(same[0]["vis"], same[1]["vis"]))
              and bool(torch.equal(same[0]["image"], same[1]["image"])))
    check(t_same, "the tangent channel changed the soup frame")
    del same
    with Capture(raster, ["raster_tiles_cuda"]) as trc:
        timed_frames(torch, np, tfr, buf, sc, bridge, ttemp, 1, 0, orbit,
                     first=nt, rate=SOUP_OCC_RAD_PER_FRAME)
    torch.cuda.synchronize()
    check(len(trc.calls) == 2, f"captured tangent frame: {len(trc.calls)} "
          "K1 launches")
    t_ms_k, t_plain, t_b, t_by, t_err, t_parts, t_dev = time_launches(
        torch, trc.calls, raster.raster_tiles_cuda, raster.raster_tiles_plain,
        lambda a, _o: k1_bound(torch, a), "K1-tangent 1080p")
    # K6 in tangent mode on the phase-1 layer: its pairs and vis; its
    # channels 0-5 against the layer's fused ones.
    pairs1, kvis, kch = trc.calls[0][1][0], trc.calls[0][3][1], trc.calls[0][3][2]
    del trc
    before = kernels[21].launches
    k6_out = resolve.resolve_attributes(pairs1, kvis, tcfg)
    torch.cuda.synchronize()
    k6_launches = kernels[21].launches - before
    check(k6_launches == 1, f"K6 tangent mode launched {k6_launches} times")
    fused_diff = float((k6_out[:6] - kch[:6]).abs().max())
    k6_ms = cuda_ms(torch, lambda: resolve.resolve_attributes_cuda(
        pairs1, kvis, tcfg), 10)
    k6_parts = device_parts(torch, lambda: resolve.resolve_attributes_cuda(
        pairs1, kvis, tcfg), 10)
    k6_dev = sum(k6_parts.values())
    k6_plain, k6_pms = host_ms(torch, lambda: resolve.resolve_attributes_plain(
        pairs1, kvis, tcfg))
    k6_err = mode_check(torch, (k6_out,), (k6_plain,), "K6-tangent 1080p")
    b6_ms, b6_by, _old_ms, _old_by, b6_txt = k6_bound(torch, pairs1, kvis,
                                                      tcfg)
    del k6_out, k6_plain, pairs1, kvis, kch

    # config1_minimal's cluster path binned per triangle, with occlusion.
    cbuf = yard[1].build_scene_buffers(device=dev)
    ccfg = FrameConfig(**{**CONFIG1_MINIMAL, "group_binning": False,
                          "max_pairs": 1 << 22})
    ctemp = TemporalState(ccfg, device=dev)
    cfr = build_frame_fn(ccfg)
    cw, ct = CLUSTER_K1_FRAMES
    ncl = cw + ct
    torch.cuda.synchronize()
    reset_launches(kernels)
    cout, c_ms, _in, c_stages = timed_frames(
        torch, np, cfr, cbuf, yard[0].scene, yard[1], ctemp, cw, ct)
    cl = [k.launches for k in kernels]
    check(cl[1] == 0 and cl[11] == 2 * ncl and cl[14] == ncl,
          f"cluster path, group_binning=False: launches {cl} in {ncl} frames "
          "(K1 plain for phase 1 and the mask pass, K1 seeded for phase 2)")
    check(bool(torch.isfinite(cout["hdr"]).all()), "non-finite HDR values")
    c_ovf = {k: int(cout[k]) for k in ("bin_overflow", "cluster_overflow")}
    del cout
    with Capture(raster, ["raster_tiles_cuda"]) as crc:
        timed_frames(torch, np, cfr, cbuf, yard[0].scene, yard[1], ctemp, 1,
                     0, first=ncl)
    torch.cuda.synchronize()
    seeded = [c for c in crc.calls if c[1][3] is not None]
    check(len(seeded) == 1, f"cluster captured frame: {len(seeded)} seeded "
          "K1 launches")
    c_sms, c_splain, c_sb, c_sby, c_serr, _p, c_sdev = time_launches(
        torch, seeded, raster.raster_tiles_cuda, raster.raster_tiles_plain,
        lambda a, _o: k1_bound(torch, a), "K1-seeded cluster 1080p")
    del crc, seeded, cbuf
    gc.collect()
    torch.cuda.empty_cache()

    recs = {
        "K1-seeded": mode_record(
            "raster_tiles (K1, seeded mode: phase 2 of the soup frame's "
            "two-phase occlusion; per frame)", "135", la[14], s_err, s_ms,
            s_plain, s_b, s_by, s_dev),
        "K1-tangent": mode_record(
            "raster_tiles (K1, tangent channel in plain and seeded modes; "
            "per frame of the soup frame with occlusion and vertex tangents: "
            "phase 1, phase 2 seeded)", "135", tl[15] + tl[16], t_err,
            t_ms_k, t_plain, t_b, t_by, t_dev),
        "K6-tangent": mode_record(
            "resolve_attributes (K6, tangent mode; no frame path calls it: "
            "driven once on phase 12's phase-1 layer with tangents)", "39",
            k6_launches, k6_err, k6_ms, k6_pms, b6_ms, b6_by, k6_dev,
            source="basicrenderer_tpu_torch/csrc/resolve.cu"),
    }
    say("phase 12 soup occlusion: phase-6 courtyard "
        f"({ntris} triangles) with enable_occlusion 1920x1080, camera "
        f"{SOUP_OCC_CAMERA} orbiting {SOUP_OCC_RAD_PER_FRAME} rad/frame | "
        f"median {statistics.median(frame_ms):.3f} ms/frame over {timed} (min "
        f"{min(frame_ms):.3f}, max {max(frame_ms):.3f}) | stage ms (CUDA "
        "events, median): " + " ".join(f"{k} {stages[k]:.3f}" for k in order
                                       if k in stages)
        + " | per frame (phase-1 objects, candidates, phase-2 survivors): "
        + str(verdicts) + f" | launches per frame K1 {la[0] / n:.2f} (plain "
        f"{la[11] / n:.2f}, seeded {la[14] / n:.2f}) | phase 1 {p1_ms:.3f} ms"
        f" | K1 seeded on the captured frame {s_ms:.4f} ms (device "
        f"{s_dev:.4f}; bound {s_b:.4f} "
        f"{s_by}, plain {s_plain:.0f} ms, max_abs_err {s_err:.3g}; phase-2 "
        f"pairs {s_pairs}, pixels won {s_won}) = {'; '.join(s_parts)} | K1 "
        f"seeded random 1080p max_abs_err {r_err:.3g} | pairs "
        f"{counters['num_pairs']}, coverage {coverage:.4f}, peak "
        f"{peak_gib:.2f} GiB || with enable_vertex_tangents: median "
        f"{statistics.median(t_ms):.3f} ms/frame over {tt}, stage ms "
        + " ".join(f"{k} {t_stages[k]:.3f}" for k in order if k in t_stages)
        + f", launches K1 plain+tangent {tl[15]} seeded+tangent {tl[16]} in "
        f"{nt} frames, vis and image equal to the frame without the tangent "
        f"channel at one camera: {t_same}; K1 tangent per captured frame "
        f"{t_ms_k:.4f} ms (device {t_dev:.4f}; "
        f"bound {t_b:.4f} {t_by}, plain {t_plain:.0f} ms, max_abs_err "
        f"{t_err:.3g}) = phase 1 {t_parts[0]}; phase 2 {t_parts[1]}; K6 "
        f"tangent on the phase-1 layer {k6_ms:.4f} ms (device {k6_dev:.4f} "
        "= " + " + ".join(f"{k} {v:.4f}" for k, v in k6_parts.items())
        + f"; {b6_txt}; plain {k6_pms:.0f} ms, max_abs_err {k6_err:.3g}); "
        f"channels 0-5 vs K1's fused: max abs diff {fused_diff:.3g} || "
        "cluster path "
        "(config1_minimal, group_binning=False, occlusion): median "
        f"{statistics.median(c_ms):.3f} ms/frame over {ct}, stage ms "
        + " ".join(f"{k} {c_stages[k]:.3f}" for k in
                   ("setup", "bin", "raster", "setup2", "bin2", "raster2",
                    "mask") if k in c_stages)
        + f", launches K1 plain {cl[11]} seeded {cl[14]} in {ncl} frames, "
        f"overflow {c_ovf}; K1 seeded on clustered rows {c_sms:.4f} ms (device"
        f" {c_sdev:.4f}; bound "
        f"{c_sb:.4f} {c_sby}, plain {c_splain:.0f} ms, max_abs_err "
        f"{c_serr:.3g}) | registers: "
        + registers(r"span_tiles|resolve_tiles|id_table|last_match|"
                    r"attr_pixels")
        + f" | {smi}")
    return recs


# Phase 13: bench.py's own scene and matrix rows (bench.py:203-248).
CITY_TRIANGLES = 5_097_780   # bench.py's metric line for assets/city.glb
CITY_CAPS = dict(max_vertices=1 << 22, max_triangles=1 << 22,
                 max_objects=512, max_materials=64, max_lights=1024 + 8,
                 max_clusters=1 << 16, max_geom_clusters=1 << 15,
                 max_groups=1 << 13)              # bench.py:206-208
TAAU = dict(width=1280, height=720, output_width=1920,
            output_height=1080)                    # bench.py:246-248
# bench.py:302-306: every sampling rate at full resolution.
MAX_QUALITY = dict(texture_downscale=1, ibl_specular_downscale=1,
                   ssr_downscale=2, ssr_steps=32, vsm_sample_downscale=1,
                   vsm_mark_downscale=2, vsm_filter_taps=4,
                   near_clip_tris=512)
CITY_FRAMES = (3, 8)         # phase 13: (warm, timed) frames of each row
CITY_HQ_FRAMES = 8           # phase 13: static frames of the max-quality full
CITY_SEQ = dict(width=256, height=128, tile_h=16, output_width=512,
                output_height=256)  # phase 13's card-vs-CPU full_taau
CITY_SEQ_RAD_PER_FRAME = 0.01


def slice10_city(np, torch, dev, kernels, smi):
    """Phase 13: bench.py's imported city (assets/city.glb through the
    port's glTF importer and LOD build, 988 + 12 point lights, the bench's
    capacities and hero camera) at 1920x1080 in config1_minimal, full and
    full_taau (1280x720 presented at 1920x1080) through graph/temporal.py,
    static camera; K4's mask launch (live `leaf` jobs) and K5's launch at
    the output size checked and timed alone; full_taau against the native
    max-quality full frame; a 4-frame moving full_taau sequence at a small
    size on the card against the CPU."""
    import dataclasses
    import gc
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn
    from basicrenderer_tpu_torch.graph.framedata import FrameConfig
    from basicrenderer_tpu_torch.graph.temporal import TemporalState
    from basicrenderer_tpu_torch.models import city, clusters
    from basicrenderer_tpu_torch.models.textures import TextureRegistry
    from basicrenderer_tpu_torch.ops import taa_warp, textures
    from basicrenderer_tpu_torch.scene.bridge import (BridgeCapacities,
                                                      SceneRenderBridge)
    # Import, with the LOD build's seconds counted apart.
    lod_s = [0.0]
    build = clusters.build_cluster_lod

    def timed_build(*a, **kw):
        t = time.perf_counter()
        try:
            return build(*a, **kw)
        finally:
            lod_s[0] += time.perf_counter() - t

    t0 = time.perf_counter()
    clusters.build_cluster_lod = timed_build
    try:
        tex = TextureRegistry(256)
        built = city.load_city(lod=True, textures=tex,
                               num_point_lights=1000 - 12)
    finally:
        clusters.build_cluster_lod = build
    load_s = time.perf_counter() - t0
    check(built.num_triangles == CITY_TRIANGLES, f"city: "
          f"{built.num_triangles} source triangles, {CITY_TRIANGLES} expected")
    leaf_layers = sum(c >= 0 for c in tex.alpha_cutoffs)
    check(leaf_layers == 1, f"city: {leaf_layers} alpha-MASK texture layers")
    t0 = time.perf_counter()
    bridge = SceneRenderBridge(built.scene, built.meshes, built.materials,
                               BridgeCapacities(**CITY_CAPS), textures=tex)
    buf = bridge.build_scene_buffers(device=dev)
    torch.cuda.synchronize()
    buf_s = time.perf_counter() - t0
    base = FrameConfig(**CONFIG1_MINIMAL)
    rows = {"config1_minimal": base,
            "full": dataclasses.replace(base, **FULL),
            "full_taau": dataclasses.replace(base, **FULL, **TAAU)}
    order = ["cut", "hzb", "setup", "bin", "raster", "hzb2", "cut2", "setup2",
             "bin2", "raster2", "mask", "gbuffer", "textures", "normal_map",
             "vsm", "light_cull", "tiled_shade", "shade", "ssr", "gtao", "ibl",
             "upscale", "motion", "taa", "bloom", "exposure"]
    warm, timed = CITY_FRAMES
    n = warm + timed
    lines, images, recs = [], {}, {}
    for name, cfg in rows.items():
        fr = build_frame_fn(cfg)
        temporal = TemporalState(cfg, device=dev)
        pages = []
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches(kernels)
        out, frame_ms, inputs_ms, stages = timed_frames(
            torch, np, fr, buf, built.scene, bridge, temporal, warm, timed,
            on_frame=lambda o: pages.append(int(o["vsm_stats"]["rendered"])
                                            if "vsm_stats" in o else 0))
        launches = [k.launches for k in kernels]
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        full = cfg.enable_textures
        oh = cfg.output_height or cfg.height
        ow = cfg.output_width or cfg.width
        # Per frame: K2 for phase 1, phase 2 and the mask pass (the
        # temporal state passes a zero previous depth first), one per VSM
        # page rendered; K3 once; K4 for the mask pass (and the texture
        # channels on full); K5 from the second frame with TAA.
        check(launches[0] == 0, f"city {name} launched K1 {launches[0]} "
              "times")
        check(launches[1] == 3 * n + sum(pages), f"city {name}: K2 launched "
              f"{launches[1]} times in {n} frames with {sum(pages)} VSM pages")
        check(launches[2] == n and launches[3] == (2 if full else 1) * n,
              f"city {name}: K3 / K4 launched {launches[2:4]} times in {n} "
              "frames")
        check(launches[4] == (n - 1 if cfg.enable_taa else 0),
              f"city {name}: K5 launched {launches[4]} times in {n} frames")
        img, vis = out["image"], out["vis"]
        coverage = float((vis > 0).float().mean())
        check(tuple(img.shape) == (oh, ow, 3) and img.dtype == torch.uint8,
              f"city {name}: image {tuple(img.shape)} {img.dtype}")
        check(tuple(vis.shape) == (cfg.height, cfg.width),
              f"city {name}: vis {tuple(vis.shape)}")
        check(bool(torch.isfinite(out["hdr"]).all()), f"city {name}: "
              "non-finite HDR values")
        # The hero view is half sky, and the ground is culled: its faces
        # wind clockwise seen from above (ROADMAP Queue 3).
        check(0.1 < coverage < 1.0, f"city {name}: coverage {coverage}")
        check(float(img.float().std()) > 5.0, f"city {name}: flat image")
        if cfg.enable_taa:
            check(tuple(out["taa_out"].shape) == (oh, ow, 3),
                  f"city {name}: history {tuple(out['taa_out'].shape)}")
        counters = {k: int(out[k]) for k in ("bin_overflow",
                                             "cluster_overflow", "num_pairs",
                                             "light_overflow")}
        images[name] = img.cpu().numpy()
        del out

        # One more frame with the kernel inputs captured: K4's mask launch
        # (config1_minimal) and K5's output-size launch (full_taau), each
        # alone against its plain version.
        extra = ""
        if name in ("config1_minimal", "full_taau"):
            with Capture(textures, ["tex_block_eval_cuda"]) as tc, \
                    Capture(taa_warp, ["warp_history_tiles"]) as wc:
                timed_frames(torch, np, fr, buf, built.scene, bridge,
                             temporal, 1, 0, first=n)
            if name == "config1_minimal":
                check(len(tc.calls) == 1, f"city {name}: captured frame "
                      f"launched K4 {len(tc.calls)} times")
                a4, k4_out = tc.calls[0][1], tc.calls[0][3]
                plain, k4_plain = host_ms(
                    torch, lambda: textures.tex_block_eval_plain(*a4))
                check(torch.equal(k4_out, plain), f"city K4 mask launch "
                      f"differs from plain on {int((k4_out != plain).sum())} "
                      "values")
                live = a4[4].bool()
                live_px = int(live.sum())
                check(live_px > 0, "city K4 mask launch: no live pixel (the "
                      "leaf MASK clusters are not in view)")
                k4_ms = cuda_ms(torch, lambda: textures.tex_block_eval_cuda(
                    *a4), 10)
                k4_dev = device_ms(torch, lambda: textures.tex_block_eval_cuda(
                    *a4), 10)
                b4_ms, b4_by = k4_bound(torch, a4, bc3=False)
                recs["K4-city"] = {
                    "name": "tex_block_eval (K4, RGBA8, the city's alpha-MASK"
                            " pass: live leaf jobs at 1920x1080)",
                    "route": "cuda",
                    "source": "basicrenderer_tpu_torch/csrc/tex_block.cu",
                    "replaces": "basicrenderer_tpu/ops/textures.py:508",
                    "launches": launches[3], "max_abs_err": float(
                        (k4_out - plain).abs().max()), "ms": k4_ms,
                    "device_ms": k4_dev, "plain_ms": k4_plain,
                    "bound_ms": b4_ms, "bound_by": b4_by, "library_ms": None}
                extra = (f" | K4 mask launch {k4_ms:.4f} ms (device "
                         f"{k4_dev:.4f}; plain {k4_plain:.2f} ms; exact; "
                         f"{k4_live_line(torch, a4, bc3=False)})")
            else:
                check(len(wc.calls) == 1, f"city {name}: captured frame "
                      f"launched K5 {len(wc.calls)} times")
                a5, k5_out = wc.calls[0][1], wc.calls[0][3]
                hist = a5[0]
                padded = (-(-oh // cfg.tile_h) * cfg.tile_h,
                          -(-ow // cfg.tile_w) * cfg.tile_w, 3)
                check(tuple(hist.shape) == padded, f"city {name}: K5 warped "
                      f"a {tuple(hist.shape)} history, the padded output "
                      f"size {padded} expected")
                plain, k5_plain = host_ms(
                    torch, lambda: taa_warp.warp_history_plain(*a5))
                check(torch.equal(k5_out, plain), f"city K5 launch differs "
                      f"from plain on {int((k5_out != plain).sum())} values")
                k5_ms = cuda_ms(torch, lambda: taa_warp.warp_history_tiles(
                    *a5), 20)
                k5_dev = device_ms(torch, lambda: taa_warp.warp_history_tiles(
                    *a5), 20)
                lib_ms, lib_err, lib_dev = grid_sample_warp(
                    torch, hist, a5[1], a5[2], a5[3], a5[4], plain)
                Hp, Wp, C = hist.shape
                b5_ms, b5_by = bound(Hp * Wp * C * WARP_FLOPS_PER_VALUE,
                                     2 * hist.numel() * 4
                                     + 2 * a5[1].numel() * 4)
                recs["K5-taau"] = {
                    "name": "warp_history_tiles (K5, TAAU: the 1920x1080 "
                            "output-size history of a 1280x720 render)",
                    "route": "cuda",
                    "source": "basicrenderer_tpu_torch/csrc/taa_warp.cu",
                    "replaces": "basicrenderer_tpu/ops/taa_warp.py:44",
                    "launches": launches[4], "max_abs_err": float(
                        (k5_out - plain).abs().max()), "ms": k5_ms,
                    "device_ms": k5_dev, "plain_ms": k5_plain,
                    "bound_ms": b5_ms, "bound_by": b5_by,
                    "library_ms": lib_ms}
                extra = (f" | K5 on the {Hp}x{Wp} output history "
                         f"{k5_ms:.4f} ms (device {k5_dev:.4f}; bound "
                         f"{b5_ms:.4f} {b5_by}; plain {k5_plain:.2f} ms; "
                         f"grid_sample {lib_ms:.4f}, device {lib_dev:.4f}; "
                         f"exact; tiles {a5[1].numel()})")
            del tc, wc
        lines.append(
            f"{name}: median {statistics.median(frame_ms):.3f} ms/frame over "
            f"{timed} after {warm} warm (min {min(frame_ms):.3f}, max "
            f"{max(frame_ms):.3f}; temporal state host "
            f"{statistics.median(inputs_ms):.3f} ms) | stage ms (CUDA "
            "events, median): "
            + " ".join(f"{k} {stages[k]:.3f}" for k in order if k in stages)
            + f" | launches K2 {launches[1]} K3 {launches[2]} K4 "
            f"{launches[3]} K5 {launches[4]} in {n} frames, VSM pages {pages}"
            f" | counters {counters} | coverage {coverage:.4f} | peak "
            f"{peak_gib:.2f} GiB" + extra)

    # Upscale quality (bench.py:296-321): full_taau against the native
    # max-quality full frame, RMSE on the 0-1 scale; full against it too.
    hq = dataclasses.replace(rows["full"], **MAX_QUALITY)
    fr = build_frame_fn(hq)
    out = timed_frames(torch, np, fr, buf, built.scene, bridge,
                       TemporalState(hq, device=dev), CITY_HQ_FRAMES, 0)[0]
    img_hq = out["image"].cpu().numpy().astype(np.float32) / 255.0
    del out

    def rmse01(a):
        return float(np.sqrt(np.mean((a.astype(np.float32) / 255.0
                                      - img_hq) ** 2)))
    q_taau, q_full = rmse01(images["full_taau"]), rmse01(images["full"])
    check(np.isfinite(q_taau) and np.isfinite(q_full), "upscale RMSE")
    del buf
    gc.collect()
    torch.cuda.empty_cache()

    # Card against CPU: a 4-frame moving full_taau sequence at a small size.
    scfg = dataclasses.replace(rows["full_taau"], **CITY_SEQ)
    sfr = build_frame_fn(scfg)
    devices = (dev, torch.device("cpu"))
    states = [TemporalState(scfg, device=d) for d in devices]
    bufs = [bridge.build_scene_buffers(device=d) for d in devices]
    pos0 = built.scene.camera_matrices(aspect=2.0)[2].copy()
    target = np.asarray(built.scene._camera_target, np.float64)
    before = taa_warp.warp_history_tiles.launches
    cpu_ms = 0.0
    outs = [None, None]
    for i in range(4):
        orbit_camera(np, built.scene, pos0, target,
                     CITY_SEQ_RAD_PER_FRAME * i, 2.0)
        built.scene.propagate_transforms()
        for k, state in enumerate(states):
            t1 = time.perf_counter()
            view, params, kw = state.inputs(built.scene, bridge)
            outs[k] = sfr(bufs[k], view, params, **kw)
            state.carry(outs[k])
            if k == 1:
                cpu_ms += (time.perf_counter() - t1) * 1e3
    torch.cuda.synchronize()
    s_k5 = taa_warp.warp_history_tiles.launches - before
    card, cpu = outs
    s_agree = float((card["vis"].cpu() == cpu["vis"]).float().mean())
    s_rmse = rmse(card["image"].cpu().numpy(), cpu["image"].numpy())
    check(s_agree >= 0.999 and s_rmse <= 1.0, f"city full_taau sequence "
          f"card vs CPU: vis agreement {s_agree}, RMSE {s_rmse}")
    check(s_k5 == 3, f"city sequence: K5 launched {s_k5} times in 4 frames")
    check(tuple(card["image"].shape) == (256, 512, 3), "city sequence image "
          f"{tuple(card['image'].shape)}")
    del outs, card, cpu, bufs
    say(f"phase 13 city: assets/city.glb through the port's importer "
        f"{load_s - lod_s[0]:.1f} s + LOD build {lod_s[0]:.1f} s (host), "
        f"{built.num_triangles} source triangles, "
        f"{len(built.meshes.meshes)} meshes, {len(tex)} texture layers "
        f"({leaf_layers} alpha-MASK), scene buffers {buf_s:.1f} s | "
        + " || ".join(lines)
        + f" | upscale: full_taau vs the native max-quality full "
        f"({CITY_HQ_FRAMES} static frames) RMSE {q_taau:.5f} (0-1), full vs "
        f"it {q_full:.5f} | card vs CPU, full_taau 256x128 -> 512x256, 4 "
        f"frames orbiting {CITY_SEQ_RAD_PER_FRAME} rad/frame: vis agreement "
        f"{s_agree:.5f}, RMSE {s_rmse:.4f} (limits 0.999, 1.0), K5 "
        f"launches {s_k5}, CPU {cpu_ms / 1e3:.1f} s | {smi}")
    return recs, (built, bridge)


# Phase 14: cascaded, spot and point shadow maps and the OpenPBR lobes.
# (a) city-1080p-shadows: bench.py's base config (bench.py:215-224) on the
# city with the Renderer's shadow caps (graph/framedata.py: 4 cascades at
# 1024^2; 4 spot slots at 512^2, 2 cubes of 256^2 faces) and energy
# compensation, over four shadow-casting spot lights and two
# shadow-casting point lights in the hero view (as examples/showcase.py
# adds a shadow-casting spot light to the courtyard).
CITY_SHADOWS = dict(enable_shadows=True, enable_energy_comp=True,
                    max_shadow_lights=4, max_shadow_cubes=2)
CITY_SPOTS = ((14.0, 10.0, 18.0), (8.0, 10.0, 10.0), (2.0, 10.0, 3.0),
              (-4.0, 10.0, -4.0))
CITY_POINTS = ((11.0, 5.0, 14.0), (-1.0, 5.0, -1.0))
# FrameConfig's defaults for the cascades, the Renderer's map sizes.
CITY_SHADOW_SIZES = (4, 1024, 512, 256)
SHADOW_FRAMES = (3, 8)        # phase 14: (warm, timed) frames
SHADOW_K2_PER_FRAME = 4 + 4 + 12   # cascades, spot maps, cube faces
# (b) openpbr-1080p: the OpenPBR rig of tests/test_goldens_512.py with a
# clear-coated and a fuzz sphere, its point light casting a cube shadow.
OPENPBR_1080P = dict(width=1920, height=1080, tile_h=32, tile_w=128,
                     max_pairs=1 << 18, max_tiles_per_tri=8,
                     enable_clod=True, max_visible_clusters=1024,
                     enable_textures=True, texture_downscale=1,
                     enable_oit=True, oit_layers=2, enable_transmission=True,
                     enable_ibl=True, enable_clustered=True,
                     enable_shadows=True, max_shadow_cubes=1,
                     enable_coat=True, enable_fuzz=True,
                     enable_energy_comp=True, enable_sss=True,
                     enable_aniso=True)
# (c) card against CPU, 4 moving frames at 256x128.
SHADOW_SEQ = dict(width=256, height=128, tile_h=16)
# The capacities of tests/test_spot_shadows.py's config for its scene (16
# clusters).
SHADOW_SEQ_CAPS = dict(max_pairs=1 << 12, max_visible_clusters=16,
                       max_phase2_clusters=16, shadow_clusters=16)
SHADOW_SEQ_RAD_PER_FRAME = 0.03
# (b)'s flags on its rig at (c)'s size, with two 256^2 cascades: the plain
# version rasters 4 x 1024^2 cascades of the rig's spheres on the CPU at
# ~75 s a frame.
OPENPBR_SEQ = dict(OPENPBR_1080P, **SHADOW_SEQ, num_cascades=2,
                   shadow_resolution=256)
# (d) soup-1080p-shadows: phase 6's frame with FrameConfig's cascades.
SOUP_SHADOW_FRAMES = (1, 3)
SOUP_CAMERA = dict(position=(12 * 1.1, 12 * 0.55, 12 * 1.25),
                   target=(0, 0.0, 0), aspect=16 / 9)   # soup_courtyard's


def shadow_test_scene(np, name):
    """tests/test_shadows_ibl.py's wall ("wall": a floor and a tall wall
    under a shadow-casting directional light) or tests/test_spot_shadows.py's
    scene ("spot": a floor and a cube under a shadow-casting spot light),
    from the port's modules."""
    from basicrenderer_tpu_torch.models import procedural
    from basicrenderer_tpu_torch.models.materials import Material, MaterialRegistry
    from basicrenderer_tpu_torch.models.mesh import MeshRegistry
    from basicrenderer_tpu_torch.scene.bridge import BridgeCapacities, SceneRenderBridge
    from basicrenderer_tpu_torch.scene.scene import Scene
    meshes, mats = MeshRegistry(), MaterialRegistry()
    sc = Scene()
    if name == "wall":
        plane = meshes.add(procedural.make_plane(20.0, 2))
        cube = meshes.add(procedural.make_cube(1.5))
        m = mats.add(Material(base_color=np.array([0.7, 0.7, 0.7, 1],
                                                  np.float32), roughness=0.8))
        sc.create_renderable(plane, m)
        sc.create_renderable(cube, m, position=(0, 1.5, 0), scale=(3, 2, 0.3))
        sc.create_directional_light(direction=(-0.5, -1.0, 0.6),
                                    intensity=4.0, cast_shadows=True)
        sc.set_camera(position=(6, 6, 8), target=(0, 0.5, 0), aspect=2.0)
        caps = BridgeCapacities(max_vertices=1 << 10, max_triangles=1 << 10,
                                max_objects=8, max_materials=4, max_lights=4)
    else:
        cube = meshes.add(procedural.make_cube(0.8))
        plane = meshes.add(procedural.make_plane(12.0, 4))
        white = mats.add(Material(base_color=np.array([1, 1, 1, 1],
                                                      np.float32),
                                  roughness=0.9))
        sc.create_renderable(plane, white)
        sc.create_renderable(cube, white, position=(0, 0.8, 0))
        sc.create_spot_light(position=(1.5, 5.0, 1.0),
                             direction=(-0.3, -1, -0.2), intensity=60.0,
                             range=12.0, inner_cone=0.5, outer_cone=0.9,
                             cast_shadows=True)
        sc.set_camera(position=(4, 4, 5), target=(0, 0.5, 0), aspect=2.0)
        caps = BridgeCapacities(max_vertices=1 << 10, max_triangles=1 << 10,
                                max_objects=8, max_materials=4, max_lights=8,
                                max_clusters=16, max_geom_clusters=16)
    sc.propagate_transforms()
    return sc, SceneRenderBridge(sc, meshes, mats, caps)


def openpbr_scene(np, aspect):
    """The OpenPBR rig of tests/test_goldens_512.py (glass, skin and
    brushed-metal spheres over a checkered floor) with a clear-coated and
    a fuzz sphere, its point light casting a cube shadow."""
    from basicrenderer_tpu_torch.models import clusters, procedural
    from basicrenderer_tpu_torch.models.materials import Material, MaterialRegistry
    from basicrenderer_tpu_torch.models.mesh import MeshRegistry
    from basicrenderer_tpu_torch.models.textures import TextureRegistry
    from basicrenderer_tpu_torch.scene.bridge import BridgeCapacities, SceneRenderBridge
    from basicrenderer_tpu_torch.scene.scene import Scene
    meshes, mats = MeshRegistry(), MaterialRegistry()
    tex = TextureRegistry(resolution=64)
    checker = tex.checkerboard(a=(1, 1, 1), b=(0.15, 0.15, 0.15), squares=8)
    sphere = meshes.add(clusters.to_mesh_data(clusters.build_cluster_lod(
        procedural.make_uv_sphere(0.8, rings=24, sectors=48))))
    plane = meshes.add(procedural.make_plane(8.0, 2))

    def mat(rgb, **kw):
        return mats.add(Material(base_color=np.array([*rgb, 1], np.float32),
                                 **kw))
    floor_m = mat((0.7, 0.7, 0.72), roughness=0.3,
                  base_color_texture=checker)
    glass_m = mat((1, 1, 1), roughness=0.05, transmission_weight=1.0,
                  transmission_color=np.array([0.4, 0.9, 0.5], np.float32),
                  ior=1.5)
    skin_m = mat((0.85, 0.62, 0.52), roughness=0.55, subsurface_weight=0.8,
                 subsurface_color=np.array([1.0, 0.35, 0.25], np.float32),
                 subsurface_radius=0.6)
    brushed_m = mat((0.9, 0.9, 0.92), roughness=0.35, metallic=1.0,
                    anisotropy_strength=0.85, anisotropy_rotation=0.6)
    coat_m = mat((0.7, 0.05, 0.05), roughness=0.6, coat_weight=1.0,
                 coat_roughness=0.08)
    fuzz_m = mat((0.2, 0.2, 0.6), roughness=0.8, fuzz_weight=0.9,
                 fuzz_roughness=0.4)
    sc = Scene()
    sc.create_renderable(plane, floor_m)
    sc.create_renderable(sphere, glass_m, position=(-1.6, 0.8, 0))
    sc.create_renderable(sphere, skin_m, position=(0, 0.8, -0.4))
    sc.create_renderable(sphere, brushed_m, position=(1.6, 0.8, 0))
    sc.create_renderable(sphere, coat_m, position=(-0.8, 0.8, 1.4))
    sc.create_renderable(sphere, fuzz_m, position=(0.9, 0.8, 1.4))
    sc.create_directional_light(direction=(-0.5, -1, -0.35), intensity=2.5)
    sc.create_point_light(position=(0.0, 2.2, 2.0), color=(1.0, 0.9, 0.8),
                          intensity=5.0, cast_shadows=True)
    sc.set_camera(position=(0.4, 2.0, 4.2), target=(0, 0.7, 0), aspect=aspect)
    sc.propagate_transforms()
    caps = BridgeCapacities(max_vertices=1 << 15, max_triangles=1 << 15,
                            max_objects=16, max_materials=8, max_lights=8,
                            max_clusters=1 << 10, max_geom_clusters=1 << 10)
    return sc, SceneRenderBridge(sc, meshes, mats, caps, textures=tex)


def shadow_launches(torch, raster, calls, cuda_fn, plain_fn, walked_fn,
                    label):
    """Every captured shadow-map launch (name, args, kwargs, output) held
    to its plain version (vis, depth and channels exact), then all of them
    timed together by CUDA events and by device time, and their depth-only
    bounds (map_bound) summed. Returns (ms, device ms, plain ms, bound ms,
    bound_by of the largest, max abs err, rows walked, bytes bound ms with
    every plane the kernel writes)."""
    err, plain_ms, b_sum, b_big, by, walked = 0.0, 0.0, 0.0, 0.0, "bytes", 0
    planes_ms = 0.0
    for k, (_n, a, kw, kout) in enumerate(calls):
        check(len(a) < 4 or a[3] is None, f"{label} launch {k} is seeded")
        pout, p_ms = host_ms(torch, lambda: plain_fn(*a, **kw))
        err = max(err, compare_raster(torch, kout, pout,
                                      f"{label} launch {k}"))
        w = walked_fn(a)
        b_ms, b_by = map_bound(w, a[1])
        planes_ms += (w * 128 + a[1].padded_height * a[1].padded_width
                      * 40) / PEAK_BYTES * 1e3
        plain_ms, b_sum, walked = plain_ms + p_ms, b_sum + b_ms, walked + w
        if b_ms > b_big:
            b_big, by = b_ms, b_by
    def run():
        for _n, a, kw, _o in calls:
            cuda_fn(*a, **kw)
    return (cuda_ms(torch, run, 5), device_ms(torch, run, 5), plain_ms,
            b_sum, by, err, walked, planes_ms)


def frame_k3_k4(torch, lc, tc, label):
    """The K3 and K4 launches of one captured frame (Capture lists), each
    held to its plain version: K3 within SHADE_RTOL / SHADE_ATOL (k3_check),
    K4 exact. Returns (K3 max abs err, K3 max ulp, K4 launches, K4 max abs
    err)."""
    from basicrenderer_tpu_torch.ops import textures
    check(len(lc.calls) == 1, f"{label}: captured frame launched K3 "
          f"{len(lc.calls)} times")
    k3_err, k3_ulp = k3_check(torch, lc.calls[0][1], f"{label} K3")
    k4_err = 0.0
    for k, (_n, a, kw, kout) in enumerate(tc.calls):
        plain = textures.tex_block_eval_plain(*a, **kw)
        check(torch.equal(kout, plain), f"{label} K4 launch {k} differs "
              f"from plain on {int((kout != plain).sum())} values")
        k4_err = max(k4_err, float((kout - plain).abs().max()))
    return k3_err, k3_ulp, len(tc.calls), k4_err


def slice11_shadows(np, torch, dev, kernels, smi, city_built, soup):
    """Phase 14: (a) city-1080p-shadows, (b) openpbr-1080p, (c) 4-frame
    moving sequences at 256x128 on the card against the CPU (the cluster
    path with (a)'s flags on tests/test_spot_shadows.py's scene; the soup
    path with enable_shadows on tests/test_shadows_ibl.py's wall, K1
    rastering the cascades; (b)'s flags on its rig), (d) soup-1080p-shadows
    (phase 6's courtyard `soup` with enable_shadows: K1 on its cascades).
    Returns the kernels-line records of the shadow launches."""
    import gc
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn
    from basicrenderer_tpu_torch.graph.framedata import FrameConfig
    from basicrenderer_tpu_torch.graph.temporal import TemporalState
    from basicrenderer_tpu_torch.models.environment import Environment
    from basicrenderer_tpu_torch.ops import lighting, raster, textures
    recs = {}
    order = ["cut", "hzb", "setup", "bin", "raster", "hzb2", "cut2", "setup2",
             "bin2", "raster2", "mask", "gbuffer", "textures", "normal_map",
             "shadows", "light_cull", "tiled_shade", "shade", "cube_shadows",
             "spot_shadows", "ibl", "oit_cut", "oit_setup", "oit_bin",
             "oit_peel0", "oit_peel1", "oit_accum", "oit_shade",
             "oit_composite"]

    def stage_line(stages):
        return " ".join(f"{k} {stages[k]:.3f}" for k in order if k in stages)

    # -- (a) city-1080p-shadows -------------------------------------------
    built, bridge = city_built
    sc = built.scene
    for pos in CITY_SPOTS:
        sc.create_spot_light(position=pos, direction=(-0.25, -1.0, -0.3),
                             intensity=300.0, range=28.0, inner_cone=0.45,
                             outer_cone=0.85, cast_shadows=True)
    for pos in CITY_POINTS:
        sc.create_point_light(position=pos, color=(1.0, 0.85, 0.7),
                              intensity=150.0, range=22.0, cast_shadows=True)
    sc.propagate_transforms()
    t0 = time.perf_counter()
    buf = bridge.build_scene_buffers(device=dev)
    torch.cuda.synchronize()
    buf_s = time.perf_counter() - t0
    slots = buf.lights[:int(buf.num_lights), 14:16].cpu().numpy()
    check(sorted(slots[slots[:, 0] >= 0, 0].tolist()) == [0, 1, 2, 3]
          and sorted(slots[slots[:, 1] >= 0, 1].tolist()) == [0, 1],
          f"city: spot slots / cube indices {slots[(slots >= 0).any(1)]}")
    cfg = FrameConfig(**CONFIG1_MINIMAL, **CITY_SHADOWS)
    sizes = (cfg.num_cascades, cfg.shadow_resolution,
             cfg.spot_shadow_resolution, cfg.point_shadow_resolution)
    check(sizes == CITY_SHADOW_SIZES, f"city-1080p-shadows: cascades and "
          f"map sizes {sizes}, {CITY_SHADOW_SIZES} expected")
    fr = build_frame_fn(cfg)
    temporal = TemporalState(cfg, device=dev)
    warm, timed = SHADOW_FRAMES
    n = warm + timed
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(kernels)
    out, frame_ms, _inputs_ms, stages = timed_frames(
        torch, np, fr, buf, sc, bridge, temporal, warm, timed)
    launches = [k.launches for k in kernels]
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    per_frame = 3 + SHADOW_K2_PER_FRAME
    check(launches[0] == 0, f"city-1080p-shadows launched K1 {launches[0]} "
          "times")
    check(launches[1] == per_frame * n, f"city-1080p-shadows: K2 launched "
          f"{launches[1]} times in {n} frames, {per_frame * n} expected")
    check(launches[2] == n and launches[3] == n, f"city-1080p-shadows: K3 / "
          f"K4 launched {launches[2:4]} times in {n} frames")
    check(bool(torch.isfinite(out["hdr"]).all()), "city-1080p-shadows: "
          "non-finite HDR values")
    img = out["image"]
    check(tuple(img.shape) == (cfg.height, cfg.width, 3),
          f"city-1080p-shadows image {tuple(img.shape)}")
    # The same view with the shadows off: the shadowed lights leave the
    # tiled loop for their own passes, so pixels must darken somewhere.
    cfg0 = FrameConfig(**CONFIG1_MINIMAL, enable_energy_comp=True)
    out0 = timed_frames(torch, np, build_frame_fn(cfg0), buf, sc, bridge,
                        TemporalState(cfg0, device=dev), 1, 0)[0]
    darker = float(((out0["image"].float() - img.float()).mean(-1) > 8.0)
                   .float().mean())
    check(darker > 0.001, f"city-1080p-shadows: {darker} of the pixels "
          "darker than with the shadows off")
    del out, out0

    # One more frame with K2's and K3's launches captured: each shadow map
    # shape held to the plain version and timed alone; K3, with the six
    # shadowed lights out of the tiled loop, held to its plain version.
    with Capture(raster, ["raster_groups_cuda"]) as rc, \
            Capture(lighting, ["tiled_shade_cuda"]) as lc, \
            Capture(textures, ["tex_block_eval_cuda"]) as tc:
        timed_frames(torch, np, fr, buf, sc, bridge, temporal, 1, 0, first=n)
    check(len(rc.calls) == per_frame, f"city-1080p-shadows: captured frame "
          f"launched K2 {len(rc.calls)} times")
    a_k3_err, a_k3_ulp, a_k4_n, a_k4_err = frame_k3_k4(
        torch, lc, tc, "city-1080p-shadows")
    del lc, tc
    k2_lines = []
    r_csm, r_spot, r_cube = sizes[1:]
    for key, res, count, what in (
            ("K2-CSM", r_csm, 4, f"cascades, {r_csm}^2 depth-only ortho"),
            ("K2-spot", r_spot, 4, f"spot shadow maps, {r_spot}^2 "
                                   "depth-only perspective"),
            ("K2-cube", r_cube, 12, f"cube faces, {r_cube}^2 depth-only "
                                    "perspective, 2 point lights x 6")):
        calls = [c for c in rc.calls
                 if (c[1][1].width, c[1][1].height) == (res, res)]
        check(len(calls) == count, f"{key}: {len(calls)} launches in the "
              f"captured frame, {count} expected")
        ms, d_ms, p_ms, b_ms, b_by, err, walked, planes_ms = \
            shadow_launches(
                torch, raster, calls, raster.raster_groups_cuda,
                raster.raster_groups_plain,
                lambda a: raster.expand_group_pairs(
                    a[0], a[1], a[2] if len(a) > 2 else 0)[0].shape[0], key)
        pairs = sum(int(c[1][0].num_pairs) for c in calls)
        recs[key] = {
            "name": f"raster_groups (K2, plain mode, {what}; per frame: "
                    f"{count} launches of the city-1080p-shadows frame)",
            "route": "cuda",
            "source": "basicrenderer_tpu_torch/csrc/raster.cu",
            "replaces": "basicrenderer_tpu/ops/raster_pallas.py:252",
            "launches": launches[1] * count // per_frame,
            "max_abs_err": err, "ms": ms, "device_ms": d_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}
        k2_lines.append(f"{key} {count} launches {ms:.4f} ms (device "
                        f"{d_ms:.4f}; depth-only bound {b_ms:.4f} {b_by}, "
                        f"with every plane written {planes_ms:.4f} bytes; "
                        f"plain {p_ms:.0f} ms; vis, depth and channels "
                        f"exact; pairs {pairs}, rows walked {walked})")
    del rc, buf
    gc.collect()
    torch.cuda.empty_cache()
    a_line = (f"(a) city-1080p-shadows: scene buffers {buf_s:.1f} s | median "
              f"{statistics.median(frame_ms):.3f} ms/frame over {timed} after "
              f"{warm} warm (min {min(frame_ms):.3f}, max "
              f"{max(frame_ms):.3f}) | stage ms (CUDA events, median): "
              + stage_line(stages)
              + f" | launches K2 {launches[1]} ({per_frame}/frame: 3 + "
              f"{SHADOW_K2_PER_FRAME} shadow) K3 {launches[2]} K4 "
              f"{launches[3]} in {n} frames | {darker:.4f} of the pixels "
              f"darker than with the shadows off | peak {peak_gib:.2f} GiB | "
              f"captured frame: K3 max abs err {a_k3_err:.3g} (max ulp "
              f"{a_k3_ulp}), K4 {a_k4_n} launches exact | "
              + "; ".join(k2_lines))

    # -- (b) openpbr-1080p ------------------------------------------------
    psc, pbridge = openpbr_scene(np, 1920 / 1080)
    env = Environment.procedural(device=dev, use_cache=False)
    pbuf = pbridge.build_scene_buffers(env_sh=env.sh,
                                       env_specular=env.spec_mips,
                                       device=dev)
    pcfg = FrameConfig(**OPENPBR_1080P)
    pfr = build_frame_fn(pcfg)
    ptemporal = TemporalState(pcfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(kernels)
    out, p_frame_ms, _, p_stages = timed_frames(
        torch, np, pfr, pbuf, psc, pbridge, ptemporal, warm, timed)
    p_launches = [k.launches for k in kernels]
    p_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check(bool(torch.isfinite(out["hdr"]).all()), "openpbr-1080p: "
          "non-finite HDR values")
    coverage = float((out["vis"] > 0).float().mean())
    check(0.2 < coverage < 1.0, f"openpbr-1080p: coverage {coverage}")
    check(p_launches[3] >= n and p_launches[2] == n, f"openpbr-1080p: K3 / "
          f"K4 launched {p_launches[2:4]} times in {n} frames")
    del out
    # One more frame with K3's and K4's launches captured, each held to
    # its plain version (K4: the textured floor's base colour).
    with Capture(lighting, ["tiled_shade_cuda"]) as lc, \
            Capture(textures, ["tex_block_eval_cuda"]) as tc:
        timed_frames(torch, np, pfr, pbuf, psc, pbridge, ptemporal, 1, 0,
                     first=n)
    b_k3_err, b_k3_ulp, b_k4_n, b_k4_err = frame_k3_k4(
        torch, lc, tc, "openpbr-1080p")
    check(b_k4_n >= 1, "openpbr-1080p: the captured frame launched no K4")
    del lc, tc, pbuf
    b_line = (f"(b) openpbr-1080p: median {statistics.median(p_frame_ms):.3f}"
              f" ms/frame over {timed} after {warm} warm (min "
              f"{min(p_frame_ms):.3f}, max {max(p_frame_ms):.3f}) | stage ms "
              "(CUDA events, median): " + stage_line(p_stages)
              + f" | launches K2 {p_launches[1]} (of which peel "
              f"{raster.MODE_LAUNCHES[('K2', 'peel')].launches}, accum "
              f"{raster.MODE_LAUNCHES[('K2', 'accum')].launches}) K3 "
              f"{p_launches[2]} K4 {p_launches[3]} in {n} frames | coverage "
              f"{coverage:.4f} | peak {p_peak:.2f} GiB | captured frame: K3 "
              f"max abs err {b_k3_err:.3g} (max ulp {b_k3_ulp}), K4 "
              f"{b_k4_n} launches exact")

    # -- (c) card against CPU ---------------------------------------------
    c_lines = []
    for label, name, flags in (
            ("cluster path", "spot", dict(CONFIG1_MINIMAL, **CITY_SHADOWS,
                                          **SHADOW_SEQ, **SHADOW_SEQ_CAPS)),
            ("soup path", "wall", dict(enable_shadows=True, max_pairs=1 << 12,
                                       **SHADOW_SEQ, tile_w=128)),
            ("OpenPBR rig", "openpbr", OPENPBR_SEQ)):
        devices = (dev, torch.device("cpu"))
        if name == "openpbr":
            ssc, sbridge = openpbr_scene(np, 2.0)
            target = np.array([0.0, 0.7, 0.0])
            envs = [Environment.procedural(device=d, use_cache=False)
                    for d in devices]
            sbufs = [sbridge.build_scene_buffers(env_sh=e.sh,
                                                 env_specular=e.spec_mips,
                                                 device=d)
                     for e, d in zip(envs, devices)]
        else:
            ssc, sbridge = shadow_test_scene(np, name)
            target = np.array([0.0, 0.5, 0.0])
            sbufs = [sbridge.build_scene_buffers(device=d) for d in devices]
        scfg = FrameConfig(**flags)
        sfr = build_frame_fn(scfg)
        states = [TemporalState(scfg, device=d) for d in devices]
        pos0 = ssc.camera_matrices(aspect=2.0)[2].copy()
        reset_launches(kernels)
        cpu_ms, worst = 0.0, (1.0, 0.0)
        for i in range(4):
            orbit_camera(np, ssc, pos0, target, SHADOW_SEQ_RAD_PER_FRAME * i,
                         2.0)
            ssc.propagate_transforms()
            outs = []
            for k, state in enumerate(states):
                t1 = time.perf_counter()
                view, params, kw = state.inputs(ssc, sbridge)
                o = sfr(sbufs[k], view, params, **kw)
                state.carry(o)
                outs.append(o)
                if k == 1:
                    cpu_ms += (time.perf_counter() - t1) * 1e3
            agree = float((outs[0]["vis"].cpu() == outs[1]["vis"])
                          .float().mean())
            err = rmse(outs[0]["image"].cpu().numpy(),
                       outs[1]["image"].numpy())
            check(agree == 1.0 and err <= 1.0, f"phase 14 {label} frame {i} "
                  f"card vs CPU: vis agreement {agree}, RMSE {err}")
            worst = (min(worst[0], agree), max(worst[1], err))
        c_launches = [k.launches for k in kernels]
        if name == "wall":
            # The soup path: K1 rasters the main view and each cascade.
            check(c_launches[0] == 4 * (1 + scfg.num_cascades)
                  and c_launches[1] == 0, f"phase 14 soup path: K1 / K2 "
                  f"launched {c_launches[:2]} times in 4 frames")
        elif name == "spot":
            check(c_launches[1] == 4 * (3 + SHADOW_K2_PER_FRAME)
                  and c_launches[0] == 0, f"phase 14 cluster path: K1 / K2 "
                  f"launched {c_launches[:2]} times in 4 frames")
        else:
            check(c_launches[1] > 0 and c_launches[2] == 4
                  and c_launches[3] >= 4, f"phase 14 OpenPBR rig: K2 / K3 / "
                  f"K4 launched {c_launches[1:4]} times in 4 frames")
        c_lines.append(f"{label} ({name}): every frame vis agreement >= "
                       f"{worst[0]:.5f}, RMSE <= {worst[1]:.4f} (limits 1.0 "
                       f"equal, 1.0), K1 {c_launches[0]} K2 {c_launches[1]} "
                       f"K3 {c_launches[2]} K4 {c_launches[3]} launches, "
                       f"CPU {cpu_ms / 1e3:.1f} s")
        del sbufs, outs

    # -- (d) soup-1080p-shadows: K1 on the soup's cascades at full size ----
    usc, ubridge, ubuf, _ntris = soup
    usc.set_camera(**SOUP_CAMERA)   # phase 6's view (phase 12 moved it)
    usc.propagate_transforms()
    ucfg = FrameConfig(**SOUP_1080P, enable_shadows=True)
    ufr = build_frame_fn(ucfg)
    utemporal = TemporalState(ucfg, device=dev)
    uwarm, utimed = SOUP_SHADOW_FRAMES
    un = uwarm + utimed
    reset_launches(kernels)
    out, u_frame_ms, _, u_stages = timed_frames(
        torch, np, ufr, ubuf, usc, ubridge, utemporal, uwarm, utimed)
    u_launches = [k.launches for k in kernels]
    check(u_launches[0] == un * (1 + ucfg.num_cascades)
          and u_launches[1] == 0, f"soup-1080p-shadows: K1 / K2 launched "
          f"{u_launches[:2]} times in {un} frames")
    check(bool(torch.isfinite(out["hdr"]).all()), "soup-1080p-shadows: "
          "non-finite HDR values")
    del out
    with Capture(raster, ["raster_tiles_cuda"]) as kc, \
            Capture(lighting, ["tiled_shade_cuda"]) as lc, \
            Capture(textures, ["tex_block_eval_cuda"]) as tc:
        timed_frames(torch, np, ufr, ubuf, usc, ubridge, utemporal, 1, 0,
                     first=un)
    k1_calls = [c for c in kc.calls if c[1][1].width == ucfg.shadow_resolution]
    check(len(k1_calls) == ucfg.num_cascades, f"soup-1080p-shadows: "
          f"captured {len(k1_calls)} cascade launches")
    check(len(lc.calls) == 0 and len(tc.calls) == 0, "soup-1080p-shadows "
          "launched K3 or K4")
    pairs = [int(c[1][0].num_pairs) for c in k1_calls]
    overflow = [int(c[1][0].overflow) for c in k1_calls]
    ms, d_ms, p_ms, b_ms, b_by, err1, walked, planes_ms = shadow_launches(
        torch, raster, k1_calls, raster.raster_tiles_cuda,
        raster.raster_tiles_plain, lambda a: k1_walked(torch, a[0], a[1]),
        "K1-CSM")
    del kc, lc, tc, k1_calls
    recs["K1-CSM"] = {
        "name": "raster_tiles (K1, plain mode, soup-path cascades: "
                f"{ucfg.num_cascades} x {ucfg.shadow_resolution}^2 depth-only "
                "ortho of phase 6's courtyard; per frame: one launch a "
                "cascade)",
        "route": "cuda",
        "source": "basicrenderer_tpu_torch/csrc/raster.cu",
        "replaces": "basicrenderer_tpu/ops/raster_pallas.py:135",
        "launches": u_launches[0] * ucfg.num_cascades
        // (1 + ucfg.num_cascades),
        "max_abs_err": err1, "ms": ms, "device_ms": d_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}
    d_line = (f"(d) soup-1080p-shadows: median "
              f"{statistics.median(u_frame_ms):.3f} ms/frame over {utimed} "
              f"after {uwarm} warm | stage ms (CUDA events, median): "
              + " ".join(f"{k} {v:.3f}" for k, v in u_stages.items())
              + f" | K1 {u_launches[0]} launches in {un} frames | captured "
              f"frame's {ucfg.num_cascades} cascade launches {ms:.4f} ms "
              f"(device {d_ms:.4f}; depth-only bound {b_ms:.4f} {b_by}, with "
              f"every plane written {planes_ms:.4f} bytes; plain "
              f"{p_ms:.0f} ms; vis, depth and channels exact; pairs {pairs}, "
              f"overflow {overflow}, rows walked {walked})")
    say("phase 14 shadows + OpenPBR: " + " || ".join(
        [a_line, b_line, "(c) card vs CPU, 4 frames at 256x128 orbiting "
         f"{SHADOW_SEQ_RAD_PER_FRAME} rad/frame: " + "; ".join(c_lines),
         d_line]) + f" | {smi}")
    return recs


# Phase 15: the Renderer entry point and Reyes micro-tessellation.
# (a) README.md's quick start through Renderer() at the settings' defaults
# (1280x720, the soup frame, CSM, clustered lights, IBL, bloom), the cube
# moving, card against CPU.
QUICK_FRAMES = 4
QUICK_STEP = 0.15            # the cube's x step a frame
# (b) the city through the Renderer at its defaults (enableClod forced by
# the LOD meshes), 1920x1080: sync, then enableSceneOverlap, then
# render_async; the same FrameConfig driven directly as phase 14a does.
RENDERER_RES = (1920, 1080)
RENDERER_FRAMES = (3, 8)
ASYNC_FRAMES = 8
# (c) full_reyes (bench.py:378-393): full + Reyes over the cobble ground
# displaced 0.12 by its base-colour texture.
FULL_REYES = dict(enable_reyes=True, reyes_tris=2048, reyes_dice=4,
                  reyes_px=96.0)
REYES_FRAMES = (3, 8)
# (d) tests/test_reyes.py::_rig's displaced plane (its CFG and Reyes
# flags) at 1920x1080, then 4 orbiting frames at 256x256 card vs CPU.
REYES_RIG = dict(tile_h=16, tile_w=128, max_pairs=1 << 14, enable_clod=True,
                 max_visible_clusters=256, enable_reyes=True, reyes_tris=256,
                 reyes_dice=4, reyes_px=16.0)
REYES_RIG_RES = (1920, 1080)
REYES_RIG_RAD_PER_FRAME = 0.05


def quick_start_renderer(np, device):
    """README.md's quick start on `device`: Renderer(), a red cube, a
    directional light, the procedural environment. Returns (renderer,
    scene, cube entity)."""
    from basicrenderer_tpu_torch.models import procedural
    from basicrenderer_tpu_torch.models.materials import Material
    from basicrenderer_tpu_torch.renderer import Renderer
    from basicrenderer_tpu_torch.scene.scene import Scene
    r = Renderer(device=device)
    cube = r.meshes.add(procedural.make_cube(1.0))
    red = r.materials.add(Material(base_color=[0.8, 0.1, 0.1, 1.0]))
    sc = Scene()
    ent = sc.create_renderable(cube, red, position=(0, 0.5, 0))
    sc.create_directional_light(direction=(-0.4, -1, -0.3), intensity=3.0)
    sc.set_camera(position=(3, 2, 4), target=(0, 0.5, 0))
    r.set_current_scene(sc)
    r.set_environment("procedural")
    return r, sc, ent


def reyes_rig(np, displacement):
    """tests/test_reyes.py::_rig from the port's modules: (scene, bridge)."""
    from basicrenderer_tpu_torch.models import procedural
    from basicrenderer_tpu_torch.models.materials import (Material,
                                                          MaterialRegistry)
    from basicrenderer_tpu_torch.models.mesh import MeshRegistry
    from basicrenderer_tpu_torch.models.textures import TextureRegistry
    from basicrenderer_tpu_torch.scene.bridge import (BridgeCapacities,
                                                      SceneRenderBridge)
    from basicrenderer_tpu_torch.scene.scene import Scene
    meshes, mats = MeshRegistry(), MaterialRegistry()
    tex = TextureRegistry(resolution=64)
    r = tex.resolution
    _yy, xx = np.mgrid[0:r, 0:r]
    h = (xx > r // 2).astype(np.float32)
    height = tex.add(np.dstack([h, h * 0, h * 0]), srgb=False)
    plane = meshes.add(procedural.make_plane(4.0, 2))
    m = mats.add(Material(
        base_color=np.array([0.8, 0.8, 0.8, 1], np.float32), roughness=0.6,
        displacement_scale=displacement, displacement_texture=height))
    sc = Scene()
    sc.create_renderable(plane, m)
    sc.create_directional_light(direction=(-0.4, -1, -0.3), intensity=3.0)
    sc.set_camera(position=(0, 2.2, 3.2), target=(0, 0, 0), aspect=1.0)
    sc.propagate_transforms()
    caps = BridgeCapacities(max_vertices=1 << 12, max_triangles=1 << 12,
                            max_objects=4, max_materials=4, max_lights=4,
                            max_clusters=1 << 8, max_geom_clusters=1 << 8)
    return sc, SceneRenderBridge(sc, meshes, mats, caps, textures=tex)


def renderer_frames(torch, r, warm, timed, sync=True):
    """Run warm + timed frames of Renderer `r` (update, render and, with
    `sync`, a synchronise). Returns (last output, ms list: update to
    synchronise, update ms list)."""
    frame_ms, update_ms, out = [], [], None
    for i in range(warm + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.update()
        t1 = time.perf_counter()
        out = r.render()
        if sync:
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i >= warm:
            frame_ms.append((t2 - t0) * 1e3)
            update_ms.append((t1 - t0) * 1e3)
    return out, frame_ms, update_ms


def telemetry_line(r, n):
    avg = r.telemetry.averages(n)
    return " ".join(f"{k} {v:.3f}" for k, v in sorted(avg.items()))


def slice12_renderer(np, torch, dev, kernels, smi, city_built):
    """Phase 15: (a) the README quick start through Renderer(), card
    against CPU; (b) the city through the Renderer at its defaults, sync,
    overlapped and render_async, against the same FrameConfig driven
    directly; (c) full_reyes on the city, its K2 launches held to the plain
    version and timed alone; (d) the Reyes rig at 1920x1080 and 4 frames
    card against CPU at 256x256. Returns the kernels-line record of K2 on
    the Reyes micro rows."""
    import dataclasses
    import gc
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn
    from basicrenderer_tpu_torch.graph.framedata import (FrameConfig,
                                                         FrameParams, make_view)
    from basicrenderer_tpu_torch.graph.temporal import TemporalState
    from basicrenderer_tpu_torch.ops import raster, reyes
    from basicrenderer_tpu_torch.renderer import Renderer
    from basicrenderer_tpu_torch.scene.bridge import (BridgeCapacities,
                                                      SceneRenderBridge)
    from basicrenderer_tpu_torch.scene.components import Position
    from basicrenderer_tpu_torch.utils.profiling import profile_fn
    t_phase = time.perf_counter()

    # -- (a) the README quick start, card against CPU ----------------------
    card, sc, ent = quick_start_renderer(np, dev)
    cpu, sc_c, ent_c = quick_start_renderer(np, "cpu")
    cfg_a = card.current_config()
    check((cfg_a.width, cfg_a.height) == (1280, 720) and cfg_a.enable_shadows
          and cfg_a.enable_clustered and cfg_a.enable_ibl
          and cfg_a.enable_bloom and not cfg_a.enable_clod,
          f"quick start config {cfg_a}")
    check(cfg_a == cpu.current_config(), "quick start: card and CPU "
          "renderers built different configs")
    reset_launches(kernels)
    a_lines, a_ms, cpu_s = [], [], 0.0
    for i in range(QUICK_FRAMES):
        pos = np.array([QUICK_STEP * i, 0.5, 0.0], np.float32)
        for s, e in ((sc, ent), (sc_c, ent_c)):
            s.world.set(e, Position(pos))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card.update()
        o_card = card.render()
        torch.cuda.synchronize()
        a_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        cpu.update()
        o_cpu = cpu.render()
        cpu_s += time.perf_counter() - t0
        agree = float((o_card["vis"].cpu() == o_cpu["vis"]).float().mean())
        err = rmse(o_card["image"].cpu().numpy(), o_cpu["image"].numpy())
        check(agree == 1.0 and err < 0.1, f"quick start frame {i} card vs "
              f"CPU: vis agreement {agree}, RMSE {err}")
        a_lines.append(f"{agree:.5f}/{err:.4f}")
    k1_a, k3_a = kernels[0].launches, kernels[2].launches
    per_frame = 1 + cfg_a.num_cascades
    check(k1_a == per_frame * QUICK_FRAMES and k3_a == QUICK_FRAMES,
          f"quick start: K1 launched {k1_a} and K3 {k3_a} times in "
          f"{QUICK_FRAMES} frames ({per_frame} and 1 a frame expected)")
    a_line = (f"(a) README quick start through Renderer() (1280x720: soup, "
              f"{cfg_a.num_cascades} cascades at {cfg_a.shadow_resolution}"
              f"^2, clustered lights, IBL, bloom), the cube moving "
              f"{QUICK_STEP} a frame: card vs CPU vis agreement / RMSE per "
              f"frame {', '.join(a_lines)} (limits 1.0, 0.1); card ms/frame "
              f"{', '.join(f'{x:.2f}' for x in a_ms)}; launches K1 {k1_a} "
              f"K3 {k3_a} in {QUICK_FRAMES} frames; CPU {cpu_s:.1f} s; "
              f"telemetry (ms, mean) {telemetry_line(card, QUICK_FRAMES)}")
    say(f"phase 15 Renderer + Reyes: {a_line}")
    del card, cpu, o_card, o_cpu
    gc.collect()
    torch.cuda.empty_cache()

    # -- (b) the city through the Renderer ---------------------------------
    built, bridge = city_built
    r = Renderer(caps=BridgeCapacities(**CITY_CAPS), device=dev)
    r.meshes, r.materials, r.textures = (built.meshes, built.materials,
                                         bridge.textures)
    r.settings.set("renderResolution", RENDERER_RES)
    r.set_current_scene(built.scene)
    cfg = r.current_config()
    check(cfg.enable_clod and cfg.enable_textures, "city Renderer: "
          f"enable_clod {cfg.enable_clod}, enable_textures "
          f"{cfg.enable_textures}")
    warm, timed = RENDERER_FRAMES
    n = warm + timed
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches(kernels)
    t0 = time.perf_counter()
    out, sync_ms, upd_ms = renderer_frames(torch, r, warm, timed)
    launches = [k.launches for k in kernels]
    check(launches[0] == 0 and launches[1] > 0 and launches[2] == n,
          f"city Renderer: K1 {launches[0]}, K2 {launches[1]}, K3 "
          f"{launches[2]} launches in {n} frames")
    check(bool(torch.isfinite(out["hdr"]).all())
          and 0.1 < float((out["vis"] > 0).float().mean()) < 1.0,
          "city Renderer: non-finite HDR or bad coverage")
    sync_tel = telemetry_line(r, timed)
    img_sync = out["image"].cpu().numpy()
    view, params, kw = r._temporal.inputs(built.scene, r._bridge)
    prof = profile_fn(r._programs.get(cfg), r._buffers, view, params,
                      iters=2, **kw)
    # The same FrameConfig driven directly (phase 14a's way).
    fr = build_frame_fn(cfg)
    _o, direct_ms, direct_in, _st = timed_frames(
        torch, np, fr, r._buffers, built.scene, r._bridge,
        TemporalState(cfg, device=dev), warm, timed)
    del _o
    r.settings.set("enableSceneOverlap", True)
    out, over_ms, over_upd = renderer_frames(torch, r, warm, timed)
    over_tel = telemetry_line(r, timed)
    r.settings.set("enableSceneOverlap", False)
    r.update()
    img_ref = r.render_to_numpy()
    check(np.array_equal(img_ref, img_sync), "city Renderer: the static "
          "frame changed between the sync and overlapped runs")
    futs = []
    for _ in range(ASYNC_FRAMES):
        r.update()
        futs.append(r.render_async())
    async_imgs = [f.result(timeout=300)["image"] for f in futs]
    check(all(np.array_equal(a, img_ref) for a in async_imgs),
          "city Renderer: render_async images differ from render_to_numpy")
    r._readback.close()
    med = statistics.median
    host_cost = med(sync_ms) - med(direct_ms)
    b_line = (f"(b) city through Renderer (its defaults: enableClod forced, "
              f"textures, {cfg.num_cascades} cascades, clustered, IBL, "
              f"bloom; shadow spot slots {cfg.max_shadow_lights}, cubes "
              f"{cfg.max_shadow_cubes}) 1920x1080: median "
              f"{med(sync_ms):.3f} ms/frame (update {med(upd_ms):.3f}) over "
              f"{timed} after {warm} warm; the same FrameConfig driven "
              f"directly {med(direct_ms):.3f} (temporal inputs "
              f"{med(direct_in):.3f}): Renderer host cost {host_cost:.3f} "
              f"ms/frame | telemetry {sync_tel} | enableSceneOverlap "
              f"{med(over_ms):.3f} ms/frame (update {med(over_upd):.3f}), "
              f"telemetry {over_tel} | render_async {ASYNC_FRAMES} frames "
              f"equal to render_to_numpy | launches K2 {launches[1]} K3 "
              f"{launches[2]} K4 {launches[3]} in {n} frames | profile_fn "
              f"(one frame, ms): " + ", ".join(
                  f"{name} {ms:.3f}" for name, ms in prof[:30]))
    say(f"phase 15 {b_line}")
    del out, r, fr
    gc.collect()
    torch.cuda.empty_cache()

    # -- (c) full_reyes on the city ----------------------------------------
    cobble = [m for m in built.materials.materials if m.name == "cobble"]
    check(len(cobble) == 1 and cobble[0].base_color_texture >= 0,
          "city: no textured cobble material")
    saved = (cobble[0].displacement_scale, cobble[0].displacement_texture)
    cobble[0].displacement_scale = 0.12
    cobble[0].displacement_texture = cobble[0].base_color_texture
    rbridge = SceneRenderBridge(built.scene, built.meshes, built.materials,
                                BridgeCapacities(**CITY_CAPS),
                                textures=bridge.textures)
    buf = rbridge.build_scene_buffers(device=dev)
    rcfg = dataclasses.replace(FrameConfig(**CONFIG1_MINIMAL, **FULL),
                               **FULL_REYES)
    fr = build_frame_fn(rcfg)
    temporal = TemporalState(rcfg, device=dev)
    warm, timed = REYES_FRAMES
    n = warm + timed
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches(kernels)
    out, frame_ms, _in_ms, stages = timed_frames(
        torch, np, fr, buf, built.scene, rbridge, temporal, warm, timed)
    k2_launches = kernels[1].launches
    check(bool(torch.isfinite(out["hdr"]).all()), "full_reyes: non-finite")
    cluster_ovf = int(out["cluster_overflow"])
    del out
    with Capture(reyes, ["dice_reyes"]) as dc, \
            Capture(raster, ["raster_groups_cuda"]) as rc:
        o = timed_frames(torch, np, fr, buf, built.scene, rbridge, temporal,
                         1, 0, first=n)[0]
        vis_now = o["vis"]
        del o
    dc_calls = dc.calls
    Kt = rcfg.max_visible_clusters * 128
    main_call = dc_calls[0]
    diced = int((~main_call[3][3]).sum())
    micro_live = int(main_call[3][2].sum())
    r_ovf = int(main_call[3][4])
    all_diced = sum(int((~c[3][3]).sum()) for c in dc_calls)
    all_micro = sum(int(c[3][2].sum()) for c in dc_calls)
    check(len(rc.calls) >= 3, f"full_reyes: captured frame launched K2 "
          f"{len(rc.calls)} times")
    err, plain_ms, b_sum, b_big, by, walked = 0.0, 0.0, 0.0, 0.0, "bytes", 0
    for k, (_n, a, kw, kout) in enumerate(rc.calls):
        pout, p_ms = host_ms(torch, lambda: raster.raster_groups_plain(
            *a, **kw))
        err = max(err, compare_raster(torch, kout, pout,
                                      f"full_reyes K2 launch {k}"))
        init = a[3] if len(a) > 3 else kw.get("init")
        b_ms, b_by, w = k2_bound(raster, a[0], a[1], a[2] if len(a) > 2
                                 else 0, init)
        plain_ms, b_sum, walked = plain_ms + p_ms, b_sum + b_ms, walked + w
        if b_ms > b_big:
            b_big, by = b_ms, b_by

    def k2_run():
        for _n, a, kw, _o in rc.calls:
            raster.raster_groups_cuda(*a, **kw)
    k2_ms, k2_dev = cuda_ms(torch, k2_run, 5), device_ms(torch, k2_run, 5)
    n_k2 = len(rc.calls)
    recs = {"K2-reyes": {
        "name": "raster_groups (K2 on full_reyes's frame: the city's cut "
                "with the cobble ground's Reyes micro rows appended, at "
                "1920x1080)",
        "route": "cuda", "source": "basicrenderer_tpu_torch/csrc/raster.cu",
        "replaces": "basicrenderer_tpu/ops/raster_pallas.py:252",
        "launches": k2_launches, "max_abs_err": err, "ms": k2_ms,
        "device_ms": k2_dev, "plain_ms": plain_ms, "bound_ms": b_sum,
        "bound_by": by, "library_ms": None}}
    cobble[0].displacement_scale, cobble[0].displacement_texture = saved
    micro_px = int(((vis_now > Kt) & (vis_now <= Kt + rcfg.reyes_tris
                                      * rcfg.reyes_dice ** 2)).sum())
    del buf, rbridge, temporal, dc, rc
    gc.collect()
    torch.cuda.empty_cache()
    c_line = (f"(c) full_reyes (full + reyes_tris 2048, dice 4, 96 px; "
              f"cobble displaced 0.12) 1920x1080: median "
              f"{statistics.median(frame_ms):.3f} ms/frame over {timed} after "
              f"{warm} warm | stage ms (CUDA events, median): " + " ".join(
                  f"{k} {v:.3f}" for k, v in stages.items())
              + f" | main view: diced parents {diced}, live micro rows "
              f"{micro_live} of {rcfg.reyes_tris * rcfg.reyes_dice ** 2}, "
              f"Reyes overflow {r_ovf}, pixels showing a main-view micro "
              f"row {micro_px}; all {len(dc_calls)} dicing setups of the "
              f"frame: diced {all_diced}, live micro rows {all_micro} | "
              f"cluster_overflow {cluster_ovf} | K2 {k2_launches} launches "
              f"in {n} frames; the captured frame's {n_k2} K2 launches "
              f"{k2_ms:.4f} ms (device {k2_dev:.4f}; bound {b_sum:.4f}, the "
              f"largest by {by}; plain {plain_ms:.0f} ms; vis, depth and "
              f"channels exact; rows walked {walked})")
    say(f"phase 15 {c_line}")

    # -- (d) the Reyes rig: where dicing shows ------------------------------
    dcfg = FrameConfig(width=REYES_RIG_RES[0], height=REYES_RIG_RES[1],
                       **REYES_RIG)
    imgs, n_diced = [], 0
    for disp in (0.5, 0.0):
        rsc, rbr = reyes_rig(np, disp)
        with Capture(reyes, ["dice_reyes"]) as rd:
            o = build_frame_fn(dcfg)(
                rbr.build_scene_buffers(device=dev),
                make_view(*rsc.camera_matrices(
                    aspect=REYES_RIG_RES[0] / REYES_RIG_RES[1]), device=dev),
                FrameParams.default(dev))
        n_diced = max(n_diced, int((~rd.calls[0][3][3]).sum()))
        check(bool(torch.isfinite(o["hdr"]).all()), "Reyes rig: non-finite")
        imgs.append(o["image"].cpu().numpy())
    changed = float((imgs[0] != imgs[1]).any(-1).mean())
    check(changed > 0.01 and n_diced > 0, f"Reyes rig 1080p: {changed} of "
          f"the pixels changed, {n_diced} parents diced")
    scfg = FrameConfig(width=256, height=256, **REYES_RIG)
    sfr = build_frame_fn(scfg)
    rsc, rbr = reyes_rig(np, 0.5)
    bufs = [rbr.build_scene_buffers(device=d) for d in (dev, "cpu")]
    pos0 = rsc.camera_matrices(aspect=1.0)[2].copy()
    target = np.zeros(3)
    d_lines, cpu_s = [], 0.0
    for i in range(4):
        orbit_camera(np, rsc, pos0, target, REYES_RIG_RAD_PER_FRAME * i, 1.0)
        outs = []
        for k, d in enumerate((dev, "cpu")):
            t0 = time.perf_counter()
            outs.append(sfr(bufs[k], make_view(*rsc.camera_matrices(
                aspect=1.0), device=d), FrameParams.default(d)))
            if k == 1:
                cpu_s += time.perf_counter() - t0
        agree = float((outs[0]["vis"].cpu() == outs[1]["vis"]).float().mean())
        err = rmse(outs[0]["image"].cpu().numpy(), outs[1]["image"].numpy())
        check(agree == 1.0 and err < 0.1, f"Reyes rig frame {i} card vs CPU:"
              f" vis agreement {agree}, RMSE {err}")
        d_lines.append(f"{agree:.5f}/{err:.4f}")
    d_line = (f"(d) Reyes rig (tests/test_reyes.py's displaced plane) at "
              f"1920x1080: {n_diced} parents diced, {changed:.4f} of the "
              f"pixels differ from the undisplaced frame | 256x256, 4 frames "
              f"orbiting {REYES_RIG_RAD_PER_FRAME} rad/frame, card vs CPU vis"
              f" agreement / RMSE {', '.join(d_lines)} (limits 1.0, 0.1), CPU"
              f" {cpu_s:.1f} s")
    say(f"phase 15 {d_line} | phase 15 {time.perf_counter() - t_phase:.1f} "
        f"s | {smi}")
    return recs


# Phase 16: geometry and texture streaming, the voxel tiers, RT
# reflections and skinning.
# (a) bench.py::_bench_streaming (bench.py:92-175): the city through the
# Renderer at `full` + enableStreaming, streamingSlots 6144, the bench's
# capacities; warm until the streamer stops loading (12 quiet frames),
# capped; then the slope of 24 frames over 12.
STREAM_SETTINGS = dict(
    renderResolution=(1920, 1080), tileSize=(32, 128),
    maxTrianglePairs=1 << 18, enableClod=True, maxVisibleClusters=3072,
    enableClusteredLighting=True, enableOcclusionCulling=True,
    enableIBL=True, enableTextures=True, enableVSM=True, enableGTAO=True,
    enableBloom=True, enableTAA=True, enableAutoExposure=True,
    enableSSR=True, enableStreaming=True, streamingSlots=6144)
STREAM_WARM_MAX = 60
STREAM_QUIET = 12
STREAM_RUNS = (3, 12, 24)
TEXSTREAM_FRAMES = (20, 12)     # (b): warm, timed
VOXEL_CITY_RES = 64             # (c): the city's voxelResolution
TIER_FRAMES = (2, 5)            # (c), (d): warm, timed
SKIN_FRAMES = 4                 # (e): the cylinder bent over 4 frames
SMALL = dict(width=256, height=256, tile_h=16, tile_w=128)
G512_BASE = dict(width=512, height=512, tile_h=16, tile_w=128,
                 max_pairs=1 << 15, enable_clod=True,
                 max_visible_clusters=1024)     # tests/test_goldens_512.py
SMALL_TICKS = 6                 # (a) card vs CPU: synchronous ticks


def lod_spheres_scene(np):
    """tests/test_torch_streaming.py's scene: two instances of a
    cluster-LOD sphere (39 streaming groups). Returns (scene, bridge)."""
    from basicrenderer_tpu_torch.models import clusters, procedural
    from basicrenderer_tpu_torch.models.materials import MaterialRegistry
    from basicrenderer_tpu_torch.models.mesh import MeshRegistry
    from basicrenderer_tpu_torch.scene.bridge import (BridgeCapacities,
                                                      SceneRenderBridge)
    from basicrenderer_tpu_torch.scene.scene import Scene
    lod = clusters.build_cluster_lod(
        procedural.make_uv_sphere(1.0, rings=48, sectors=96), use_cache=False)
    meshes, mats = MeshRegistry(), MaterialRegistry()
    mid = meshes.add(clusters.to_mesh_data(lod))
    sc = Scene()
    sc.create_renderable(mid, 0)
    sc.create_renderable(mid, 0, position=(2.5, 0.0, -2.0))
    sc.create_directional_light(direction=(-0.3, -1, -0.2), intensity=3.0)
    sc.set_camera(position=(0, 0.4, 3.0), target=(0, 0, 0), aspect=1.0)
    sc.propagate_transforms()
    caps = BridgeCapacities(max_vertices=1 << 16, max_triangles=1 << 16,
                            max_objects=8, max_materials=4, max_lights=4,
                            max_clusters=1 << 12, max_geom_clusters=1 << 10,
                            max_groups=1 << 10)
    bridge = SceneRenderBridge(sc, meshes, mats, caps)
    bridge.pack_geometry()
    return sc, bridge


def voxel_scene(np, variant):
    """tests/test_torch_voxels.py's scenes with their 32^3 pyramid:
    "offscreen" (a mirror floor under an emissive slab above the frustum)
    or "fallback" (a large cube, to be drawn with no triangle rastered).
    Returns (scene, bridge, VoxelSceneGrid)."""
    from basicrenderer_tpu_torch.models import procedural
    from basicrenderer_tpu_torch.models.materials import (Material,
                                                          MaterialRegistry)
    from basicrenderer_tpu_torch.models.mesh import MeshRegistry
    from basicrenderer_tpu_torch.scene.bridge import (BridgeCapacities,
                                                      SceneRenderBridge)
    from basicrenderer_tpu_torch.scene.scene import Scene
    meshes, mats = MeshRegistry(), MaterialRegistry()
    sc = Scene()
    if variant == "offscreen":
        plane = meshes.add(procedural.make_plane(20.0, 16))
        slab = meshes.add(procedural.make_cube(1.0))
        mirror = mats.add(Material(base_color=np.array([0.9, 0.9, 0.9, 1],
                                                       np.float32),
                                   metallic=1.0, roughness=0.05))
        red = mats.add(Material(base_color=np.array([0.9, 0.05, 0.05, 1],
                                                    np.float32),
                                emissive=np.array([6.0, 0.2, 0.2],
                                                  np.float32)))
        sc.create_renderable(plane, mirror)
        sc.create_renderable(slab, red, position=(0, 6.0, -3.0),
                             scale=(6.0, 0.5, 6.0))
        sc.set_camera(position=(0, 2.0, 5.0), target=(0, 0.0, 1.0),
                      aspect=1.0)
    else:
        cube = meshes.add(procedural.make_cube(1.0))
        red = mats.add(Material(base_color=np.array([0.9, 0.1, 0.1, 1],
                                                    np.float32),
                                emissive=np.array([2.0, 0.1, 0.1],
                                                  np.float32)))
        sc.create_renderable(cube, red, position=(0, 0, 0), scale=(4, 4, 4))
        sc.set_camera(position=(0, 0, 9), target=(0, 0, 0), aspect=1.0)
    sc.create_directional_light(direction=(-0.3, -1.0, -0.2), intensity=2.0)
    sc.propagate_transforms()
    bridge = SceneRenderBridge(sc, meshes, mats, BridgeCapacities(
        max_vertices=1 << 11, max_triangles=1 << 11, max_objects=8,
        max_materials=4, max_lights=4, max_clusters=16))
    return sc, bridge, bridge.build_voxel_scene(n=32)


def mirror_scene(np):
    """tests/test_torch_rt_reflect.py's scene: a mirror floor and a
    cluster-LOD red sphere only reflected rays see, with a 32^3 pyramid.
    Returns (scene, bridge, VoxelSceneGrid)."""
    from basicrenderer_tpu_torch.models import clusters, procedural
    from basicrenderer_tpu_torch.models.materials import (Material,
                                                          MaterialRegistry)
    from basicrenderer_tpu_torch.models.mesh import MeshRegistry
    from basicrenderer_tpu_torch.scene.bridge import (BridgeCapacities,
                                                      SceneRenderBridge)
    from basicrenderer_tpu_torch.scene.scene import Scene
    meshes, mats = MeshRegistry(), MaterialRegistry()
    plane = meshes.add(procedural.make_plane(20.0, 8))
    sphere = meshes.add(clusters.to_mesh_data(clusters.build_cluster_lod(
        procedural.make_uv_sphere(1.5, rings=16, sectors=32),
        use_cache=False)))
    mirror = mats.add(Material(base_color=np.array([0.9, 0.9, 0.9, 1],
                                                   np.float32),
                               metallic=1.0, roughness=0.05))
    red = mats.add(Material(base_color=np.array([0.9, 0.05, 0.05, 1],
                                                np.float32)))
    sc = Scene()
    sc.create_renderable(plane, mirror)
    sc.create_renderable(sphere, red, position=(0.0, 4.0, -1.0))
    sc.create_directional_light(direction=(-0.3, -1.0, -0.2), intensity=3.0)
    sc.set_camera(position=(0, 2.0, 6.0), target=(0, 0.0, 0.0), aspect=1.0)
    sc.propagate_transforms()
    bridge = SceneRenderBridge(sc, meshes, mats, BridgeCapacities(
        max_vertices=1 << 14, max_triangles=1 << 14, max_objects=8,
        max_materials=4, max_lights=4, max_clusters=256,
        max_geom_clusters=128, max_groups=128))
    return sc, bridge, bridge.build_voxel_scene(n=32)


def skin_rig(np):
    """tests/test_skinning.py's two-bone cylinder (bone 1 at mid-height,
    bent 90 degrees about z by its clip over one second) on a floor, from
    the port's modules. Returns (scene, bridge)."""
    from basicrenderer_tpu_torch.models import animation, procedural
    from basicrenderer_tpu_torch.models.materials import (Material,
                                                          MaterialRegistry)
    from basicrenderer_tpu_torch.models.mesh import MeshData, MeshRegistry
    from basicrenderer_tpu_torch.scene.bridge import (BridgeCapacities,
                                                      SceneRenderBridge)
    from basicrenderer_tpu_torch.scene.scene import Scene
    height, segs, rings = 2.0, 8, 9
    pos, jnts, wts = [], [], []
    for y in np.linspace(0, height, rings):
        for a in np.linspace(0, 2 * np.pi, segs, endpoint=False):
            pos.append([0.3 * np.cos(a), y, 0.3 * np.sin(a)])
            w1 = np.clip((y - height * 0.25) / (height * 0.5), 0, 1)
            jnts.append([0, 1, 0, 0])
            wts.append([1 - w1, w1, 0, 0])
    idx = []
    for r in range(rings - 1):
        for k in range(segs):
            a, b = r * segs + k, r * segs + (k + 1) % segs
            idx += [[a, a + segs, b], [b, a + segs, b + segs]]
    nrm = np.zeros((len(pos), 3), np.float32)
    nrm[:, 0] = 1.0
    mesh = MeshData(np.array(pos, np.float32), nrm,
                    np.zeros((len(pos), 2), np.float32),
                    np.array(idx, np.int32), joints=np.array(jnts, np.int32),
                    weights=np.array(wts, np.float32))
    reg = animation.SkeletonRegistry()
    inv_bind = np.stack([np.eye(4, dtype=np.float32),
                         np.eye(4, dtype=np.float32)])
    inv_bind[1, 1, 3] = -height / 2
    sid = reg.add(animation.Skeleton(
        np.array([-1, 0], np.int32), inv_bind,
        np.array([[0, 0, 0], [0, height / 2, 0]], np.float32),
        np.tile(np.array([0, 0, 0, 1], np.float32), (2, 1)),
        np.ones((2, 3), np.float32)))
    q90 = np.array([0, 0, np.sin(np.pi / 4), np.cos(np.pi / 4)], np.float32)
    reg.add_clip(sid, animation.AnimationClip("bend", [animation.Channel(
        1, "rotation", np.array([0.0, 1.0], np.float32),
        np.stack([np.array([0, 0, 0, 1], np.float32), q90]))]))
    reg.play(sid, 0)
    meshes, mats = MeshRegistry(), MaterialRegistry()
    mid = meshes.add(mesh)
    floor = meshes.add(procedural.make_plane(6.0, 2))
    red = mats.add(Material(base_color=np.array([0.8, 0.2, 0.2, 1],
                                                np.float32)))
    sc = Scene()
    sc.create_renderable(mid, red, skeleton_id=sid)
    sc.create_renderable(floor, 0)
    sc.create_directional_light(direction=(-0.4, -1, -0.3), intensity=3.0)
    sc.set_camera(position=(0.5, 1.6, 3.2), target=(-0.3, 0.9, 0),
                  aspect=1.0)
    sc.propagate_transforms()
    bridge = SceneRenderBridge(sc, meshes, mats, BridgeCapacities(
        max_vertices=1 << 10, max_triangles=1 << 10, max_objects=4,
        max_materials=4, max_lights=2, max_clusters=128, max_joints=16,
        max_geom_clusters=64), skeletons=reg)
    return sc, bridge


def card_vs_cpu(torch, outs, label, share=1.0):
    """(vis agreement, RMSE) of a card frame against its CPU frame, held
    to `share` and 0.1."""
    agree = float((outs[0]["vis"].cpu() == outs[1]["vis"]).float().mean())
    err = rmse(outs[0]["image"].cpu().numpy(), outs[1]["image"].numpy())
    check(agree >= share and err <= 0.1, f"{label} card vs CPU: vis "
          f"agreement {agree}, RMSE {err}")
    return agree, err


def both(build_fn, dev):
    """build_fn(device) on the card and on the CPU."""
    return [build_fn(d) for d in (dev, "cpu")]


def k_launch_record(torch, raster, calls, cuda_fn, plain_fn, cfg_of, label,
                    k1):
    """Hold captured K1 / K2 launches to their plain version and time them
    alone. Returns (max abs err, ms, device ms, plain ms, bound ms, bound
    by)."""
    err, plain_ms, b_sum, b_big, by = 0.0, 0.0, 0.0, 0.0, "bytes"
    for k, (_n, a, kw, kout) in enumerate(calls):
        pout, p_ms = host_ms(torch, lambda: plain_fn(*a, **kw))
        err = max(err, compare_raster(torch, kout, pout, f"{label} {k}"))
        plain_ms += p_ms
        cfg = cfg_of(a, kw)
        init = a[3] if len(a) > 3 else kw.get("init")
        if k1:
            walked = k1_walked(torch, a[0], cfg)
            b_ms, b_by = bound(
                walked * cfg.tile_h * cfg.tile_w * RASTER_FLOPS_PER_ROW_PIXEL,
                walked * 128 + cfg.padded_height * cfg.padded_width * 40
                * (2 if init is not None else 1))
        else:
            b_ms, b_by, _w = k2_bound(raster, a[0], a[1],
                                      a[2] if len(a) > 2 else 0, init)
        b_sum += b_ms
        if b_ms > b_big:
            b_big, by = b_ms, b_by

    def run():
        for _n, a, kw, _o in calls:
            cuda_fn(*a, **kw)
    return err, cuda_ms(torch, run, 5), device_ms(torch, run, 5), \
        plain_ms, b_sum, by


def slice13_streaming(np, torch, dev, kernels, smi, city_built):
    """Phase 16: (a) city-1080p-streaming through the Renderer, K2's
    launches of a streamed frame held to the plain version and timed
    alone, and 6 frames of a small LOD scene card against CPU with
    synchronous ticks; (b) the same city with enableTextureStreaming; (c)
    the voxel tiers: g512_voxel_rt against its golden, the city's `full`
    frame with both voxel tiers, the voxel scenes card against CPU; (d)
    the city's `full` frame with RT reflections and the mirror scene card
    against CPU; (e) the skinned cylinder at 1920x1080 (its K1 launches
    held to the plain version and timed alone) and at 256x256 card
    against CPU on the soup and cluster paths. Returns the kernels-line
    records of K2 on the streamed frame and K1 on the skinned frame."""
    import dataclasses
    import gc
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn
    from basicrenderer_tpu_torch.graph.framedata import (FrameConfig,
                                                         FrameParams, make_view)
    from basicrenderer_tpu_torch.graph.temporal import TemporalState
    from basicrenderer_tpu_torch.models.streaming import GeometryStreamer
    from basicrenderer_tpu_torch.models.voxels import static_level_offsets
    from basicrenderer_tpu_torch.ops import raster
    from basicrenderer_tpu_torch.ops import rt_reflect
    from basicrenderer_tpu_torch.renderer import Renderer
    from basicrenderer_tpu_torch.scene.bridge import BridgeCapacities
    from basicrenderer_tpu_torch.scene.components import Light, LightType
    from basicrenderer_tpu_torch.utils.png import read_png
    t_phase = time.perf_counter()
    built, bridge = city_built
    recs = {}
    names = ("K1", "K2", "K3", "K4", "K5")
    # bench.py's city: without the shadow-casting spot and point lights
    # phase 14 added, when it ran (the Renderer would give each a map).
    added = [e for e, (light,) in built.scene.world.query(Light)
             if light.cast_shadows
             and light.type in (LightType.SPOT, LightType.POINT)]
    check(len(added) in (0, len(CITY_SPOTS) + len(CITY_POINTS)),
          f"city: {len(added)} shadow-casting local lights")
    for e in added:
        built.scene.world.destroy(e)
    built.scene.propagate_transforms()

    # -- (a) city-1080p-streaming through the Renderer -----------------------
    r = Renderer(caps=BridgeCapacities(**CITY_CAPS), device=dev)
    r.meshes, r.materials, r.textures = (built.meshes, built.materials,
                                         bridge.textures)
    for k, v in STREAM_SETTINGS.items():
        r.settings.set(k, v)
    r.set_current_scene(built.scene)
    cfg = r.current_config()
    check(cfg.enable_streaming and cfg.enable_clod and cfg.enable_vsm
          and cfg.enable_taa and cfg.max_shadow_lights == 0
          and cfg.max_shadow_cubes == 0, f"streaming Renderer config {cfg}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    prev_loads, quiet, warm = -1, 0, 0
    for warm in range(1, STREAM_WARM_MAX + 1):
        r.update()
        out = r.render()
        out["image"][0, 0, 0].item()       # frame pacing for the ticks
        loads = r._streamer.loads
        quiet = quiet + 1 if loads == prev_loads else 0
        prev_loads = loads
        if quiet >= STREAM_QUIET:
            break
    settled = quiet >= STREAM_QUIET
    warm_s = time.perf_counter() - t0
    st = r._streamer
    loads_warm = st.loads

    def run(n):
        t = time.perf_counter()
        o = None
        for _ in range(n):
            r.update()
            o = r.render()
        o["image"][0, 0, 0].item()
        return time.perf_counter() - t, o

    run(STREAM_RUNS[0])
    reset_launches(kernels)
    t1, _o = run(STREAM_RUNS[1])
    t2, out = run(STREAM_RUNS[2])
    n_timed = STREAM_RUNS[1] + STREAM_RUNS[2]
    per_frame = [kernels[i].launches / n_timed for i in range(5)]
    slope = (t2 - t1) / (STREAM_RUNS[2] - STREAM_RUNS[1]) * 1e3
    steady = (st.loads - loads_warm) / sum(STREAM_RUNS)
    check(bool(torch.isfinite(out["hdr"]).all())
          and 0.1 < float((out["vis"] > 0).float().mean()) < 1.0,
          "city streaming: non-finite HDR or bad coverage")
    check(st.loads > 0 and st.resident_groups > 0, f"city streaming: "
          f"{st.loads} page loads, {st.resident_groups} resident groups")
    check(all(per_frame[i] > 0 for i in (1, 2, 3, 4)), "city streaming: "
          f"launches a frame {per_frame}: K2, K3, K4 and K5 expected")
    k2_launches = kernels[1].launches
    with Capture(raster, ["raster_groups_cuda"]) as rc:
        r.update()
        o = r.render()
        torch.cuda.synchronize()
        del o
    check(len(rc.calls) >= 3, f"city streaming: a frame launched K2 "
          f"{len(rc.calls)} times")
    err, k2_ms, k2_dev, plain_ms, b_ms, by = k_launch_record(
        torch, raster, rc.calls, raster.raster_groups_cuda,
        raster.raster_groups_plain, lambda a, kw: a[1], "streamed K2 launch",
        k1=False)
    recs["K2-stream"] = {
        "name": "raster_groups (K2 on city-1080p-streaming's frame: the "
                "residency-patched cut set up from the 6144-slot page pool, "
                "through the Renderer)",
        "route": "cuda", "source": "basicrenderer_tpu_torch/csrc/raster.cu",
        "replaces": "basicrenderer_tpu/ops/raster_pallas.py:252",
        "launches": k2_launches, "max_abs_err": err, "ms": k2_ms,
        "device_ms": k2_dev, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": by, "library_ms": None}
    n_k2 = len(rc.calls)
    del rc
    a_line = (f"(a) city-1080p-streaming (bench.py's full_streaming settings "
              f"through the Renderer: full + enableStreaming, 6144 slots, "
              f"the bench's caps) 1920x1080: warm {warm} frames in "
              f"{warm_s:.1f} s, settled {settled} (12 frames without a load,"
              f" capped at {STREAM_WARM_MAX}) | {slope:.3f} ms/frame (slope "
              f"of {STREAM_RUNS[2]} frames over {STREAM_RUNS[1]}) | "
              f"page_loads_total {st.loads} page_loads_warm {loads_warm} "
              f"loads_per_frame_steady {steady:.2f} resident_groups "
              f"{st.resident_groups} evictions {st.evictions} | launches a "
              f"frame " + " ".join(f"{n} {x:.2f}" for n, x in
                                   zip(names, per_frame))
              + f" | one frame's {n_k2} K2 launches {k2_ms:.4f} ms (device "
              f"{k2_dev:.4f}; bound {b_ms:.4f}, the largest by {by}; plain "
              f"{plain_ms:.0f} ms; vis, depth and channels exact)")
    say(f"phase 16 streaming, voxels, RT, skinning: {a_line}")

    # -- (b) + enableTextureStreaming -----------------------------------------
    r.settings.set("enableTextureStreaming", True)
    check(r.current_config().enable_texture_streaming,
          "texture streaming did not reach the FrameConfig")
    r.update()
    tst = r._tex_streamer
    check(tst is not None, "texture streamer not brought up")
    loads0, dem0 = tst.loads, tst.demotions
    for _ in range(TEXSTREAM_FRAMES[0]):
        r.update()
        r.render()["image"][0, 0, 0].item()
    tb, out = run(TEXSTREAM_FRAMES[1])
    check(bool(torch.isfinite(out["hdr"]).all()) and "tex_wanted" in out,
          "texture streaming: non-finite HDR or no tex_wanted")
    check(tst.loads > loads0, "texture streaming: no mip was promoted")
    b_line = (f"(b) + enableTextureStreaming (RGBA8, the atlas written to "
              f"a strip container under _build/texstream): "
              f"{tb / TEXSTREAM_FRAMES[1] * 1e3:.3f} ms/frame over "
              f"{TEXSTREAM_FRAMES[1]} after {TEXSTREAM_FRAMES[0]} warm | "
              f"promotions {tst.loads} (in (b) {tst.loads - loads0}) "
              f"demotions {tst.demotions} (in (b) {tst.demotions - dem0}) of "
              f"{tst.c.num_layers} textures, fine rows {tst.fine_rows} of "
              f"{tst.budget}")
    say(f"phase 16 {b_line}")
    tst.stop()
    st.stop()
    r._feedback.close()
    del r, out, _o, st, tst
    gc.collect()
    torch.cuda.empty_cache()

    # (a) card against CPU: synchronous ticks on a small LOD scene.
    sc_s, br_s = lod_spheres_scene(np)
    scfg = FrameConfig(**SMALL, max_pairs=1 << 14, enable_clod=True,
                       enable_streaming=True)
    sfr = build_frame_fn(scfg)
    GR = br_s.caps.max_groups
    bufs, strs = [], []
    for d in (dev, "cpu"):
        buf = br_s.build_scene_buffers(device=d)
        s_ = GeometryStreamer(br_s.packed, GR, 96, loads_per_update=6,
                              device=d)
        sv, sdq, gs, gr = s_.update(np.zeros(GR, bool))
        bufs.append(dataclasses.replace(buf, cluster_verts=sv,
                                        cluster_dequant=sdq, geom_slot=gs,
                                        group_resident=gr))
        strs.append(s_)
    tick_lines = []
    for i in range(SMALL_TICKS):
        outs = [sfr(bufs[k], make_view(*sc_s.camera_matrices(aspect=1.0),
                                       device=d), FrameParams.default(d))
                for k, d in enumerate((dev, "cpu"))]
        agree, err = card_vs_cpu(torch, outs, f"streaming tick {i}")
        touched = outs[1]["touched_groups"].numpy()
        t_eq = float((outs[0]["touched_groups"].cpu().numpy()
                      == touched).mean())
        for k in range(2):
            sv, sdq, gs, gr = strs[k].update(touched)
            bufs[k] = dataclasses.replace(bufs[k], cluster_verts=sv,
                                          cluster_dequant=sdq, geom_slot=gs,
                                          group_resident=gr)
        check(np.array_equal(strs[0].geom_slot, strs[1].geom_slot),
              f"streaming tick {i}: card and CPU streamers diverged")
        tick_lines.append(f"{agree:.5f}/{err:.4f}/{t_eq:.4f}")
    check(strs[0].loads > 0, "small LOD scene: no page loads")
    say(f"phase 16 (a) card vs CPU, two LOD spheres at 256x256 with "
        f"synchronous ticks fed the CPU frame's touched groups (96 slots): "
        f"vis agreement / RMSE / touched_groups equal share per frame "
        f"{', '.join(tick_lines)} (limits 1.0, 0.1); loads {strs[0].loads}, "
        f"evictions {strs[0].evictions}")
    del bufs, strs

    # -- (c) the voxel tiers -----------------------------------------------
    gsc, gbr = g512_scene(np)
    gbr.build_voxel_scene(n=32)
    gcfg = FrameConfig(**G512_BASE, enable_voxel_rt=True, enable_ibl=True,
                       voxel_n=32, voxel_level_offsets=static_level_offsets(32))
    go = build_frame_fn(gcfg)(gbr.build_scene_buffers(device=dev),
                              make_view(*gsc.camera_matrices(aspect=1.0),
                                        device=dev), FrameParams.default(dev))
    g_rmse = rmse(go["image"].cpu().numpy(), read_png(
        os.path.join(REPO, "tests", "goldens", "g512_voxel_rt.png")))
    check(g_rmse <= GOLDEN_RMSE_MAX, f"g512_voxel_rt: RMSE {g_rmse} > "
          f"{GOLDEN_RMSE_MAX}")
    del go
    t0 = time.perf_counter()
    vox = bridge.build_voxel_scene(n=VOXEL_CITY_RES)
    vox_s = time.perf_counter() - t0
    buf = bridge.build_scene_buffers(device=dev)
    full = dataclasses.replace(FrameConfig(**CONFIG1_MINIMAL), **FULL)
    tier_rows = {}
    for name, flags in (
            ("voxel", dict(enable_voxel_rt=True, enable_voxel_fallback=True,
                           voxel_n=vox.n,
                           voxel_level_offsets=vox.level_offsets)),
            ("rt", dict(enable_rt_reflect=True))):
        tcfg = dataclasses.replace(full, **flags)
        reset_launches(kernels)
        with Capture(rt_reflect, ["trace_reflections"]) as tc:
            o, ms, _in, stages = timed_frames(
                torch, np, build_frame_fn(tcfg), buf, built.scene, bridge,
                TemporalState(tcfg, device=dev), *TIER_FRAMES)
        check(bool(torch.isfinite(o["hdr"]).all()), f"city {name}: "
              "non-finite HDR")
        hit = None
        if name == "rt":
            check(len(tc.calls) == sum(TIER_FRAMES), f"city rt: "
                  f"{len(tc.calls)} traces in {sum(TIER_FRAMES)} frames")
            covered = (o["vis"] > 0).float()
            hitmap = tc.calls[-1][3][1]
            hit = float((hitmap * covered).sum() / covered.sum())
        tier_rows[name] = (statistics.median(ms), stages,
                           [kernels[i].launches for i in range(5)], hit)
        del o, tc
    del buf
    gc.collect()
    torch.cuda.empty_cache()
    tiers_line = []
    for name, (ms, stages, launches, hit) in tier_rows.items():
        keep = {k: v for k, v in stages.items()
                if k in ("voxel_primary", "voxel_reflect", "rt_reflect",
                         "ssr", "ibl", "raster")}
        tiers_line.append(
            f"{name}: {ms:.3f} ms/frame (median of {TIER_FRAMES[1]} after "
            f"{TIER_FRAMES[0]} warm; stage ms " + " ".join(
                f"{k} {v:.3f}" for k, v in keep.items())
            + f"; launches K1-K5 {launches}"
            + (f"; hit share of the covered pixels' reflection map "
               f"{hit:.4f}" if hit is not None else "") + ")")
    v_lines = []
    for variant, flags in (("offscreen", dict(enable_voxel_rt=True,
                                              enable_ibl=True,
                                              voxel_sggx=True)),
                           ("fallback", dict(enable_voxel_fallback=True,
                                             voxel_primary_steps=24))):
        vsc, vbr, vv = voxel_scene(np, variant)
        vcfg = FrameConfig(**SMALL, max_pairs=1 << 12, voxel_n=vv.n,
                           voxel_level_offsets=vv.level_offsets,
                           voxel_rt_downscale=2, voxel_rt_steps=20, **flags)
        outs = []
        for d in (dev, "cpu"):
            vb = vbr.build_scene_buffers(device=d)
            if variant == "fallback":
                vb = dataclasses.replace(vb, tri_object=torch.full_like(
                    vb.tri_object, -1))
            outs.append(build_frame_fn(vcfg)(
                vb, make_view(*vsc.camera_matrices(aspect=1.0), device=d),
                FrameParams.default(d)))
        agree, err = card_vs_cpu(torch, outs, f"voxel {variant}")
        v_lines.append(f"{variant} {agree:.5f}/{err:.4f}")
    say(f"phase 16 (c) voxel tiers: g512_voxel_rt RMSE {g_rmse:.4f} (limit "
        f"{GOLDEN_RMSE_MAX}) | the city's full frame with enableVoxelRT + "
        f"enableVoxelFallback at voxelResolution {VOXEL_CITY_RES}: voxel "
        f"build {vox_s:.2f} s on the host ({vox.grid.size} cells in "
        f"{vox.levels} levels) | {tiers_line[0]} | 256x256 card vs CPU "
        f"(vis agreement / RMSE, limits 1.0, 0.1): {', '.join(v_lines)}")

    # -- (d) RT reflections ---------------------------------------------------
    msc, mbr, mv = mirror_scene(np)
    r_lines = []
    for label, flags in (("rt", dict()),
                         ("rt + voxel + ssr + windows", dict(
                             enable_voxel_rt=True, enable_ssr=True,
                             cut_windows=2, voxel_n=mv.n,
                             voxel_level_offsets=mv.level_offsets,
                             voxel_rt_downscale=2))):
        mcfg = FrameConfig(**SMALL, max_pairs=1 << 12, enable_clod=True,
                           max_visible_clusters=64, enable_ibl=True,
                           enable_rt_reflect=True, rt_downscale=2, **flags)
        outs = [build_frame_fn(mcfg)(
            mbr.build_scene_buffers(device=d),
            make_view(*msc.camera_matrices(aspect=1.0), device=d),
            FrameParams.default(d)) for d in (dev, "cpu")]
        agree, err = card_vs_cpu(torch, outs, f"mirror {label}")
        r_lines.append(f"{label} {agree:.5f}/{err:.4f}")
    ties = torch.tensor([[3.0, 1.0, 1.0, 2.0], [float("inf")] * 4,
                         [0.5, 0.5, 0.5, 0.5]], device=dev)
    check(torch.min(ties, dim=1).indices.tolist() == [1, 0, 0]
          and torch.argmin(ties, dim=1).tolist() == [1, 0, 0],
          "argmin on the card does not take the first of ties")
    say(f"phase 16 (d) RT reflections: the city's full frame with "
        f"enableRTReflections: {tiers_line[1]} | 256x256 mirror scene card "
        f"vs CPU (vis agreement / RMSE, limits 1.0, 0.1): "
        f"{', '.join(r_lines)} | argmin takes the first of ties on the card")

    # -- (e) skinning -----------------------------------------------------------
    ksc, kbr = skin_rig(np)
    kcfg = FrameConfig(width=1920, height=1080, tile_h=32, tile_w=128,
                       max_pairs=1 << 16, enable_skinning=True)
    kfr = build_frame_fn(kcfg)
    kview = make_view(*ksc.camera_matrices(aspect=16 / 9), device=dev)
    kbuf = kbr.build_scene_buffers(device=dev)
    times = np.linspace(0.0, 1.0 - 1e-4, SKIN_FRAMES)
    kbuf = kbr.update_dynamic(kbuf, float(times[0]))
    kfr(kbuf, kview, FrameParams.default(dev))          # warm
    reset_launches(kernels)
    k_ms, vis_first = [], None
    for i, t in enumerate(times):
        kbuf = kbr.update_dynamic(kbuf, float(t))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == len(times) - 1:
            with Capture(raster, ["raster_tiles_cuda"]) as kc:
                o = kfr(kbuf, kview, FrameParams.default(dev))
        else:
            o = kfr(kbuf, kview, FrameParams.default(dev))
        torch.cuda.synchronize()
        k_ms.append((time.perf_counter() - t0) * 1e3)
        if vis_first is None:
            vis_first = o["vis"]
    k1_launches = kernels[0].launches
    moved = float((o["vis"] != vis_first).float().mean())
    check(k1_launches == SKIN_FRAMES and moved > 0.001, f"skinned 1080p: K1 "
          f"{k1_launches} launches in {SKIN_FRAMES} frames, {moved} of the "
          f"pixels moved")
    err, k1_ms, k1_dev, plain_ms, b_ms, by = k_launch_record(
        torch, raster, kc.calls, raster.raster_tiles_cuda,
        raster.raster_tiles_plain, lambda a, kw: a[1], "skinned K1 launch",
        k1=True)
    recs["K1-skin"] = {
        "name": "raster_tiles (K1 on the skinned soup frame: the two-bone "
                "cylinder bent by the linear-blend prepass, 1920x1080)",
        "route": "cuda", "source": "basicrenderer_tpu_torch/csrc/raster.cu",
        "replaces": "basicrenderer_tpu/ops/raster_pallas.py:135",
        "launches": k1_launches, "max_abs_err": err, "ms": k1_ms,
        "device_ms": k1_dev, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": by, "library_ms": None}
    del o, kc, kbuf
    s_lines = []
    for path, flags in (("soup", dict()), ("cluster", dict(
            enable_clod=True, max_visible_clusters=64))):
        pcfg = FrameConfig(**SMALL, max_pairs=1 << 12, enable_skinning=True,
                           **flags)
        pfr = build_frame_fn(pcfg)
        bufs = [kbr.build_scene_buffers(device=d) for d in (dev, "cpu")]
        lines = []
        for t in times:
            outs = []
            for k, d in enumerate((dev, "cpu")):
                bufs[k] = kbr.update_dynamic(bufs[k], float(t))
                outs.append(pfr(bufs[k], make_view(
                    *ksc.camera_matrices(aspect=1.0), device=d),
                    FrameParams.default(d)))
            agree, err = card_vs_cpu(torch, outs, f"skinned {path} t={t:.2f}",
                                     share=0.999)
            lines.append(f"{agree:.5f}/{err:.4f}")
        s_lines.append(f"{path} {', '.join(lines)}")
    say(f"phase 16 (e) skinning: tests/test_skinning.py's two-bone cylinder "
        f"bent over {SKIN_FRAMES} frames at 1920x1080 (soup path): ms/frame "
        f"{', '.join(f'{x:.2f}' for x in k_ms)}, {moved:.4f} of the pixels "
        f"moved; K1 {k1_launches} launches; the last frame's K1 "
        f"{k1_ms:.4f} ms (device {k1_dev:.4f}; bound {b_ms:.4f}, {by}; plain "
        f"{plain_ms:.0f} ms; exact) | 256x256 card vs CPU per frame (vis "
        f"agreement / RMSE, limits 0.999, 0.1): {' | '.join(s_lines)} | "
        f"phase 16 {time.perf_counter() - t_phase:.1f} s | {smi}")
    return recs


# Phase 17: every format's fixture through the Renderer, card against CPU.
FORMAT_CAPS = dict(max_vertices=1 << 10, max_triangles=1 << 10, max_objects=16,
                   max_materials=8, max_lights=4)
FORMAT_SETTINGS = dict(renderResolution=(256, 256))
# The city exported to USDC imports one mesh per instance (114, where the
# glb shares 24 among them): the geometry capacities grow to hold them.
CITY_INSTANCED_TRIANGLES = 2_438_472   # the glb's instances, before LOD
CITY_USDC_CAPS = dict(CITY_CAPS, max_triangles=1 << 23,
                      max_geom_clusters=1 << 16, max_groups=1 << 14)


def format_frames(np, torch, dev, kernels):
    """Phase 17 (a): each fixture of tools/format_fixtures.py through
    load_model and the Renderer at 256x256 at its default settings, on the
    card and on the CPU: vis equal, RMSE <= 1.0; K1 launched on every card
    frame, K4 on the textured ones (FBX, NIF). Returns the line's parts."""
    import tempfile
    from basicrenderer_tpu_torch.renderer import Renderer
    from basicrenderer_tpu_torch.scene.bridge import BridgeCapacities
    from basicrenderer_tpu_torch.tools import format_fixtures as ff
    parts = []
    with tempfile.TemporaryDirectory() as d:
        for name in ff.FORMATS:
            sub = os.path.join(d, name)
            os.makedirs(sub)
            path = ff.write_fixture(name, sub)
            outs, launches, cpu_s = [], None, 0.0
            for device in (dev, "cpu"):
                t0 = time.perf_counter()
                r = Renderer(caps=BridgeCapacities(**FORMAT_CAPS), device=device)
                sc, _ = ff.fixture_scene(path, r.meshes, r.materials,
                                         r.textures, r.skeletons)
                for k, v in FORMAT_SETTINGS.items():
                    r.settings.set(k, v)
                r.set_current_scene(sc)
                if device is dev:
                    reset_launches(kernels)
                r.update()
                out = r.render()
                if device is dev:
                    torch.cuda.synchronize()
                    launches = [k.launches for k in kernels[:4]]
                    textured = len(r.textures)
                else:
                    cpu_s = time.perf_counter() - t0
                outs.append(out)
            check(launches[0] > 0, f"{name}: the card frame launched K1 "
                  f"{launches[0]} times")
            check(textured == (1 if name in ("fbx", "nif") else 0) and
                  (launches[3] > 0) == bool(textured), f"{name}: "
                  f"{textured} textures, K4 launched {launches[3]} times")
            agree = float((outs[0]["vis"].cpu() == outs[1]["vis"]).float().mean())
            err = rmse(outs[0]["image"].cpu().numpy(), outs[1]["image"].numpy())
            cover = float((outs[1]["vis"] > 0).float().mean())
            check(agree == 1.0 and err <= 1.0 and 0.1 < cover < 1.0,
                  f"{name} card vs CPU: vis agreement {agree}, RMSE {err}, "
                  f"coverage {cover}")
            parts.append(f"{name} vis {agree:.5f} RMSE {err:.4f} (K1 "
                         f"{launches[0]}, K3 {launches[2]}, K4 {launches[3]};"
                         f" CPU {cpu_s:.1f} s)")
    return parts


def slice14_formats(np, torch, dev, kernels, smi):
    """Phase 17: (a) format_frames; (b) city-1080p-usdc: assets/city.glb
    through the glTF importer, its renderables written with
    export_meshes_usdc (an instance each: mesh, material, world matrix),
    read back with load_usdc (the whole crate through the native LZ4
    codec), every mesh array bit-equal to the export and every world
    matrix within f32, then models/city.finish_city (the LOD DAGs, the
    lights, the hero camera) and bench.py's config1_minimal at 1920x1080;
    one captured frame's K2 launches held to the plain version (exact)
    and its K3 launch (within SHADE_RTOL / SHADE_ATOL), each timed alone.
    Returns the kernels-line records K2-usdc and K3-usdc."""
    import gc
    import tempfile
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn
    from basicrenderer_tpu_torch.graph.framedata import FrameConfig
    from basicrenderer_tpu_torch.graph.temporal import TemporalState
    from basicrenderer_tpu_torch.models import city, usdc
    from basicrenderer_tpu_torch.models.materials import MaterialRegistry
    from basicrenderer_tpu_torch.models.mesh import MeshRegistry
    from basicrenderer_tpu_torch.ops import lighting, raster
    from basicrenderer_tpu_torch.scene.bridge import (BridgeCapacities,
                                                      SceneRenderBridge)
    from basicrenderer_tpu_torch.scene.components import Renderable, WorldMatrix
    from basicrenderer_tpu_torch.scene.scene import Scene
    t_phase = time.perf_counter()
    a_parts = format_frames(np, torch, dev, kernels)
    a_s = time.perf_counter() - t_phase
    say("phase 17 formats: (a) the fixtures of tools/format_fixtures.py "
        "through load_model and the Renderer (256x256, default settings) "
        f"card vs CPU (limits: vis equal, RMSE 1.0) in {a_s:.1f} s: "
        + "; ".join(a_parts))

    # -- (b) city-1080p-usdc -------------------------------------------------
    t0 = time.perf_counter()
    src = city.load_city(lod=False, textures=None)
    glb_s = time.perf_counter() - t0
    inst = [(r.mesh_id, r.material_id,
             np.asarray(src.scene.world.get(e, WorldMatrix).value, np.float64))
            for e, (r,) in src.scene.world.query(Renderable)]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "city.usdc")
        t0 = time.perf_counter()
        usdc.export_meshes_usdc(path, src.meshes, src.materials, inst)
        export_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(11)
        check(head[:8] == b"PXR-USDC" and tuple(head[8:]) == (0, 8, 0),
              f"city.usdc header {head!r}")
        t0 = time.perf_counter()
        sc, meshes, mats = Scene(), MeshRegistry(), MaterialRegistry()
        usdc.load_usdc(path, sc, meshes, mats)
        import_s = time.perf_counter() - t0
    check(len(meshes) == len(inst), f"city.usdc: {len(meshes)} meshes for "
          f"{len(inst)} instances")
    sc.propagate_transforms()
    seen, world_err = set(), 0.0
    for e, (r,) in sc.world.query(Renderable):
        m = meshes.get(r.mesh_id)
        k = int(m.name[len("mesh"):])
        seen.add(k)
        ref = src.meshes.get(inst[k][0])
        for field in ("positions", "normals", "uvs", "indices"):
            a, b = getattr(m, field), np.asarray(getattr(ref, field))
            check(a.dtype == b.dtype and a.shape == b.shape
                  and np.array_equal(a, b), f"city.usdc mesh{k} {field}: "
                  f"{a.dtype}{a.shape} differs from the export's "
                  f"{b.dtype}{b.shape}")
        M = inst[k][2]
        diff = float(np.abs(np.asarray(sc.world.get(e, WorldMatrix).value,
                                       np.float64) - M).max())
        world_err = max(world_err, diff / max(1.0, float(np.abs(M).max())))
    check(seen == set(range(len(inst))), f"city.usdc: renderables of "
          f"{len(seen)} of {len(inst)} instances")
    check(world_err <= 1e-5, f"city.usdc world matrices differ by "
          f"{world_err} (relative to the largest entry)")
    n_src = src.num_triangles
    del src
    t0 = time.perf_counter()
    built = city.finish_city(sc, meshes, mats, lod=True,
                             num_point_lights=1000 - 12)
    lod_s = time.perf_counter() - t0
    check(n_src == CITY_INSTANCED_TRIANGLES
          and built.num_triangles == CITY_TRIANGLES, f"city.usdc: {n_src} "
          f"instanced triangles, {built.num_triangles} with the LOD levels "
          f"({CITY_INSTANCED_TRIANGLES} and {CITY_TRIANGLES} expected)")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bridge = SceneRenderBridge(sc, meshes, mats,
                               BridgeCapacities(**CITY_USDC_CAPS))
    buf = bridge.build_scene_buffers(device=dev)
    torch.cuda.synchronize()
    buf_s = time.perf_counter() - t0
    cfg = FrameConfig(**CONFIG1_MINIMAL)
    fr = build_frame_fn(cfg)
    temporal = TemporalState(cfg, device=dev)
    warm, timed = CITY_FRAMES
    n = warm + timed
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(kernels)
    out, frame_ms, inputs_ms, stages = timed_frames(
        torch, np, fr, buf, sc, bridge, temporal, warm, timed)
    launches = [k.launches for k in kernels]
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check(launches[0] == 0 and launches[1] == 3 * n and launches[2] == n,
          f"city.usdc: K1 / K2 / K3 launched {launches[:3]} times in {n} "
          "frames (0, 3 a frame, 1 a frame expected)")
    img, vis = out["image"], out["vis"]
    coverage = float((vis > 0).float().mean())
    check(tuple(img.shape) == (1080, 1920, 3)
          and img.dtype == torch.uint8
          and bool(torch.isfinite(out["hdr"]).all())
          and 0.1 < coverage < 1.0 and float(img.float().std()) > 5.0,
          f"city.usdc frame: image {tuple(img.shape)} {img.dtype}, coverage "
          f"{coverage}")
    counters = {k: int(out[k]) for k in ("bin_overflow", "cluster_overflow",
                                         "num_pairs", "light_overflow")}
    del out
    with Capture(raster, ["raster_groups_cuda"]) as rc, \
            Capture(lighting, ["tiled_shade_cuda"]) as lc:
        timed_frames(torch, np, fr, buf, sc, bridge, temporal, 1, 0, first=n)
    check(len(rc.calls) == 3 and len(lc.calls) == 1, f"city.usdc: the "
          f"captured frame launched K2 {len(rc.calls)} and K3 "
          f"{len(lc.calls)} times")
    k2_err, k2_ms, k2_dev, k2_plain, b2_ms, b2_by = k_launch_record(
        torch, raster, rc.calls, raster.raster_groups_cuda,
        raster.raster_groups_plain, lambda a, kw: a[1], "city.usdc K2",
        k1=False)
    a3 = lc.calls[0][1]
    k3_err, k3_ulp = k3_check(torch, a3, "city.usdc K3")
    k3_ms = cuda_ms(torch, lambda: lighting.tiled_shade_cuda(*a3), 10)
    k3_dev = device_ms(torch, lambda: lighting.tiled_shade_cuda(*a3), 10)
    _, k3_plain = host_ms(torch, lambda: lighting.tiled_shade_plain(*a3))
    b3_ms, b3_by = k3_bound(a3)
    recs = {"K2-usdc": {
        "name": "raster_groups (K2 on city-1080p-usdc: the city exported to "
                f"USDC and imported again, {len(inst)} meshes; phase 1, "
                "phase 2 seeded, mask pass)",
        "route": "cuda", "source": "basicrenderer_tpu_torch/csrc/raster.cu",
        "replaces": "basicrenderer_tpu/ops/raster_pallas.py:252",
        "launches": launches[1], "max_abs_err": k2_err, "ms": k2_ms,
        "device_ms": k2_dev, "plain_ms": k2_plain, "bound_ms": b2_ms,
        "bound_by": b2_by, "library_ms": None},
        "K3-usdc": {
        "name": "tiled_shade (K3 on city-1080p-usdc, 1000 point lights)",
        "route": "cuda",
        "source": "basicrenderer_tpu_torch/csrc/tiled_shade.cu",
        "replaces": "basicrenderer_tpu/ops/lighting.py:133",
        "launches": launches[2], "max_abs_err": k3_err, "ms": k3_ms,
        "device_ms": k3_dev, "plain_ms": k3_plain, "bound_ms": b3_ms,
        "bound_by": b3_by, "library_ms": None}}
    order = ["cut", "hzb", "setup", "bin", "raster", "hzb2", "cut2", "setup2",
             "bin2", "raster2", "mask", "gbuffer", "light_cull", "tiled_shade",
             "shade"]
    say(f"phase 17 formats: (b) city-1080p-usdc ({smi}): glb import "
        f"{glb_s:.2f} s | export_meshes_usdc {export_s:.2f} s host, "
        f"{size} bytes, crate 0.8.0, {len(inst)} instances | load_usdc "
        f"{import_s:.2f} s host | every mesh array bit-equal, world matrices "
        f"within {world_err:.3g} | finish_city (LOD, 1000 point lights) "
        f"{lod_s:.2f} s, buffers {buf_s:.2f} s | config1_minimal "
        f"{cfg.width}x{cfg.height}: "
        f"{statistics.median(frame_ms):.3f} ms/frame (median of {timed}, "
        f"after {warm} warm; host inputs {statistics.median(inputs_ms):.3f} "
        f"ms), peak {peak_gib:.2f} GiB, coverage {coverage:.4f}, counters "
        f"{counters} | stages " + " ".join(
            f"{k} {stages[k]:.3f}" for k in order if k in stages)
        + f" | K2 {k2_ms:.4f} ms for the frame's 3 launches (device "
        f"{k2_dev:.4f}; bound {b2_ms:.4f}, the largest by {b2_by}; plain "
        f"{k2_plain:.0f} ms; exact) | K3 {k3_ms:.4f} ms (device "
        f"{k3_dev:.4f}; bound {b3_ms:.4f} by {b3_by}; plain {k3_plain:.0f} "
        f"ms; max abs err {k3_err:.3g}, max ulp {k3_ulp}) | phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    del buf, bridge, built, fr, temporal
    gc.collect()
    torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# Phase 18: tile sharding (basicrenderer_tpu_torch/parallel/tile_sharding.py)
# ---------------------------------------------------------------------------

SHARD_RES = dict(width=1920, height=1088)   # 34 tile rows of 32
SHARD_FRAMES = 2    # the second takes depth_padded, taa_out, vsm_state back
# (label, ranks, (label, FrameConfig fields over config1_minimal at
# SHARD_RES)...). Each mode's backend is tile_sharding.default_backend:
# on one card NCCL for world size 1, gloo for 2 and 4 ranks sharing the
# card (NCCL refuses two ranks on one card); NCCL with a card a rank.
# A sharded frame equals the unsharded one where each rank's rows, at
# texture_downscale 2, are whole 16-row sampler blocks (a multiple of 32
# rows): 2 ranks of 17 32-row tiles at 1088, 4 ranks of 18 16-row tiles
# at 1152 (17 of 16 rows at 1088 regroup the alpha-MASK pass's blocks at
# the seams, in the JAX package too).
SHARD_MODES = (
    ("a", 1, (("full, tile_h 32", dict(FULL, tile_h=32)),)),
    ("b", 2, (("full, tile_h 32", dict(FULL, tile_h=32)),)),
    ("c", 4, (("config1_minimal at 1920x1152, tile_h 16",
               dict(tile_h=16, height=1152)),
              ("config1_minimal at 1920x1152, tile_h 16, "
               "group_binning=False",
               dict(tile_h=16, height=1152, group_binning=False)))),
)
SHARD_TIMED_RANK = 1   # whose last frame's launches at an offset are timed


def shard_inputs(np, torch, city_built):
    """Phase 18's scene on the CPU: phase 13's city (built here when phase
    13 did not run) with the bench's capacities and hero camera. Returns
    (buffers, view_of(aspect) -> ViewData, params, label)."""
    from basicrenderer_tpu_torch.graph.framedata import FrameParams, make_view
    from basicrenderer_tpu_torch.models import city
    from basicrenderer_tpu_torch.models.textures import TextureRegistry
    from basicrenderer_tpu_torch.scene.bridge import (BridgeCapacities,
                                                      SceneRenderBridge)
    if city_built is None:
        tex = TextureRegistry(256)
        built = city.load_city(lod=True, textures=tex,
                               num_point_lights=1000 - 12)
        bridge = SceneRenderBridge(built.scene, built.meshes, built.materials,
                                   BridgeCapacities(**CITY_CAPS),
                                   textures=tex)
    else:
        built, bridge = city_built

    def view_of(aspect):
        return make_view(*built.scene.camera_matrices(aspect=aspect),
                         device="cpu")
    return (bridge.build_scene_buffers(device="cpu"), view_of,
            FrameParams.default("cpu"),
            f"assets/city.glb, {built.num_triangles} source triangles")


def save_fields(np, path, x):
    """A dataclass of tensors (and floats) as an .npz of its fields."""
    import dataclasses
    np.savez(path, **{f.name: np.asarray(getattr(x, f.name))
                      for f in dataclasses.fields(x)})


def match_limits(torch, a, b, label):
    """tests/test_parallel.py's _assert_match between two frames' outputs
    (tensors on one device): vis equal, depth within rtol 1e-5 / atol
    1e-6, the image at most 1 apart on under 1% of its values. Returns
    (share of image values that differ, largest difference)."""
    nvis = int((a["vis"] != b["vis"]).sum())
    depth_ok = bool(torch.allclose(a["depth"], b["depth"], rtol=1e-5,
                                   atol=1e-6))
    di = (a["image"].int() - b["image"].int()).abs()
    share, largest = float((di > 0).float().mean()), int(di.max())
    check(nvis == 0 and depth_ok and largest <= 1 and share < 0.01,
          f"{label}: sharded vs unsharded: {nvis} vis differ, depth within "
          f"limits {depth_ok}, image max diff {largest} on {share:.5f}")
    return share, largest


def shard_row0(call):
    """The tile_row0 of a captured K1/K2 call (pairs, config, tile_row0,
    init, peel, accum)."""
    _n, a, kw, _out = call
    return a[2] if len(a) > 2 else kw.get("tile_row0", 0)


def shard_rank(rank, n, dev, npz_dir, configs, timed):
    """One rank of phase 18, under parallel/tile_sharding.run_ranks: the
    saved scene loaded through interop; for each FrameConfig of `configs`
    SHARD_FRAMES sharded frames with the K1-K4 wrappers captured (their
    launch counts zeroed before and read after), the outputs assembled,
    every captured launch at a tile-row offset (K1/K2 with tile_row0 > 0,
    every K3 and K4 launch of a rank past 0) held to its plain version;
    with `timed`, SHARD_TIMED_RANK times its last frame's such launches
    alone while the other ranks wait; then rank 0 renders the same frames
    unsharded and holds the assembled ones to them: bit for bit at world
    size 1, else match_limits. Returns a summary per config."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    from basicrenderer_tpu_torch import interop
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn
    from basicrenderer_tpu_torch.graph.framedata import FrameConfig
    from basicrenderer_tpu_torch.ops import lighting, raster, textures
    from basicrenderer_tpu_torch.ops import vsm as vsm_ops
    from basicrenderer_tpu_torch.parallel import tile_sharding as ts

    def load(name):
        with np.load(os.path.join(npz_dir, name + ".npz")) as f:
            return dict(f)
    buf = interop.scene_buffers(load("scene"), dev)
    params = interop.frame_params(load("params"), dev)
    plain_of = {"K1": raster.raster_tiles_plain, "K2": raster.raster_groups_plain,
                "K4": textures.tex_block_eval_plain}

    def frames(fr, cfg, hook=None):
        view = interop.view_data(load(f"view{cfg.height}"), dev)
        prev = hist = out = None
        st = vsm_ops.init_states(cfg, dev) if cfg.enable_vsm else None
        ms = []
        for _ in range(SHARD_FRAMES):
            if hook is not None:
                hook()
            t0 = time.perf_counter()
            out = fr(buf, view, params, prev, hist, vsm_state=st)
            torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            prev = out["depth_padded"] if cfg.enable_occlusion else None
            hist = out["taa_out"] if cfg.enable_taa else None
            st = out.get("vsm_state")
        return out, ms

    summaries = []
    for _label, fields in configs:
        cfg = FrameConfig(**{**CONFIG1_MINIMAL, **SHARD_RES, **fields})
        frame = ts.build_sharded_frame_fn(cfg)
        wrappers = {"K1": raster.raster_tiles_cuda,
                    "K2": raster.raster_groups_cuda,
                    "K3": lighting.tiled_shade_cuda,
                    "K4": textures.tex_block_eval_cuda}
        for w in wrappers.values():
            w.launches = 0
        marks = []
        with Capture(raster, ["raster_tiles_cuda", "raster_groups_cuda"]) as rc, \
                Capture(lighting, ["tiled_shade_cuda"]) as lc, \
                Capture(textures, ["tex_block_eval_cuda"]) as tc:
            def mark():
                marks.append({"K1K2": len(rc.calls), "K3": len(lc.calls),
                              "K4": len(tc.calls)})
                dist.barrier()
            out, ms = frames(frame, cfg, mark)
        launches = {k: w.launches for k, w in wrappers.items()}
        whole = ts.assemble(out)
        del out
        last = marks[-1]
        calls = {
            "K1": [(i >= last["K1K2"], c) for i, c in enumerate(rc.calls)
                   if c[0] == "raster_tiles_cuda" and shard_row0(c) > 0],
            "K2": [(i >= last["K1K2"], c) for i, c in enumerate(rc.calls)
                   if c[0] == "raster_groups_cuda" and shard_row0(c) > 0],
            "K3": [(i >= last["K3"], c) for i, c in enumerate(lc.calls)
                   if rank > 0],
            "K4": [(i >= last["K4"], c) for i, c in enumerate(tc.calls)
                   if rank > 0]}
        del rc, lc, tc
        offset = {k: len(cs) for k, cs in calls.items()}
        errs, plain_ms = {}, {}
        for k, cs in calls.items():
            errs[k], plain_ms[k] = 0.0, 0.0
            for j, (in_last, (_n, a, kw, kout)) in enumerate(cs):
                label = f"rank {rank} {k} launch {j} at an offset"
                if k == "K3":
                    err, _ulp = k3_check(torch, a, label)
                    if in_last:
                        plain_ms[k] += host_ms(torch, lambda: lighting
                                               .tiled_shade_plain(*a))[1]
                else:
                    pout, p_ms = host_ms(torch, lambda: plain_of[k](*a, **kw))
                    if in_last:
                        plain_ms[k] += p_ms
                    if k == "K4":
                        check(torch.equal(kout, pout), f"{label} differs "
                              f"from plain on {int((kout != pout).sum())} "
                              "values")
                        err = float((kout - pout).abs().max())
                    else:
                        err = compare_raster(torch, kout, pout, label)
                errs[k] = max(errs[k], err)
        dist.barrier()
        rec = {}
        if timed and rank == SHARD_TIMED_RANK:
            rec = shard_times(torch, raster, lighting, textures,
                              {k: [c for in_last, c in cs if in_last]
                               for k, cs in calls.items()}, errs, plain_ms)
        del calls
        dist.barrier()
        summary = {"ms": ms, "launches": launches,
                   "collectives": frame.rows.collectives, "errs": errs,
                   "rec": rec,
                   "offset_launches": offset, "match": None}
        if rank == 0:
            img, vis = whole["image"], whole["vis"]
            coverage = float((vis > 0).float().mean())
            check(tuple(img.shape) == (cfg.height, cfg.width, 3)
                  and bool(torch.isfinite(whole["hdr"]).all())
                  and 0.1 < coverage < 1.0 and float(img.float().std()) > 5.0,
                  f"sharded city frame: image {tuple(img.shape)}, coverage "
                  f"{coverage}")
            ref, ref_ms = frames(build_frame_fn(cfg), cfg)
            if n == 1:
                for k in ts._SHARDED_KEYS:
                    check(torch.equal(whole[k], ref[k]), f"world size 1: "
                          f"{k} differs from the unsharded frame on "
                          f"{int((whole[k] != ref[k]).sum())} values")
                summary["match"] = "bit-equal (" + ", ".join(
                    ts._SHARDED_KEYS) + ")"
            else:
                share, largest = match_limits(torch, whole, ref,
                                              f"{n} ranks")
                summary["match"] = (f"vis equal, depth within limits, image "
                                    f"max diff {largest} on {share:.6f} of "
                                    "its values")
            summary["coverage"] = coverage
            summary["unsharded_ms"] = ref_ms
            del ref
        summaries.append(summary)
        del whole
    return summaries


def shard_times(torch, raster, lighting, textures, calls, errs, plain_ms):
    """Records of one rank's last-frame launches at an offset (`calls`:
    kernel -> captured calls), each kernel's launches timed together
    alone: by CUDA events (ms) and the profiler (device_ms), beside the
    plain versions' ms, the bound (summed over the launches; `bound_by`
    that of the largest) and the max abs error of every launch at an
    offset (`errs`)."""
    cuda_of = {"K1": raster.raster_tiles_cuda, "K2": raster.raster_groups_cuda,
               "K3": lighting.tiled_shade_cuda,
               "K4": textures.tex_block_eval_cuda}
    recs = {}
    for k, cs in calls.items():
        if not cs:
            continue
        b_sum, b_big, by = 0.0, 0.0, "bytes"
        for _n, a, kw, _out in cs:
            if k == "K1":
                b_ms, b_by, _w = k1_bound(torch, a, row0=shard_row0(
                    (_n, a, kw, _out)))
            elif k == "K2":
                b_ms, b_by, _w = k2_bound(raster, a[0], a[1], a[2],
                                          a[3] if len(a) > 3 else None)
            elif k == "K3":
                b_ms, b_by = k3_bound(a)
            else:
                b_ms, b_by = k4_bound(torch, a, bc3=False)
            b_sum += b_ms
            if b_ms > b_big:
                b_big, by = b_ms, b_by

        def run(cs=cs, fn=cuda_of[k]):
            for _n, a, kw, _o in cs:
                fn(*a, **kw)
        recs[k] = {"calls": len(cs), "ms": cuda_ms(torch, run, 5),
                   "device_ms": device_ms(torch, run, 5),
                   "plain_ms": plain_ms[k], "bound_ms": b_sum,
                   "bound_by": by, "max_abs_err": errs[k]}
    return recs


def k3_bound(a):
    """(bound ms, by) of one K3 launch with args (shade_in, payload,
    counts, cam_pos, config): each tile's lights on its pixels and the
    per-pixel work; every input read once, the RGB written."""
    shade_in, payload, counts, cfg = a[0], a[1], a[2], a[4]
    hw = shade_in.shape[1] * shade_in.shape[2]
    return bound(int(counts.long().sum()) * cfg.tile_h * cfg.tile_w
                 * SHADE_FLOPS_PER_PIXEL_LIGHT + hw * SHADE_FLOPS_PER_PIXEL,
                 shade_in.numel() * 4 + payload.numel() * 4
                 + counts.numel() * 4 + hw * 12)


SHARD_RECORDS = (   # kernels-line record, mode, config index, kernel, what
    ("K1-shard", "c", 1, "K1", "raster_tiles (K1 at shard tile offsets: "
     "config1_minimal with group_binning=False on the city at 1920x1152, "
     "4 ranks of 18 tile rows; plain, seeded and mask launches)",
     "basicrenderer_tpu_torch/csrc/raster.cu",
     "basicrenderer_tpu/ops/raster_pallas.py:135"),
    ("K2-shard", "b", 0, "K2", "raster_groups (K2 at shard tile offsets: "
     "the city's full at 1920x1088, 2 ranks of 17 tile rows; phase 1, "
     "phase 2 seeded, mask pass)",
     "basicrenderer_tpu_torch/csrc/raster.cu",
     "basicrenderer_tpu/ops/raster_pallas.py:252"),
    ("K3-shard", "b", 0, "K3", "tiled_shade (K3 on a shard's padded grid: "
     "the city's full at 1920x1088, 2 ranks, 1000 point lights)",
     "basicrenderer_tpu_torch/csrc/tiled_shade.cu",
     "basicrenderer_tpu/ops/lighting.py:133"),
    ("K4-shard", "b", 0, "K4", "tex_block_eval (K4, RGBA8, on a shard's "
     "rows with halo mip estimates: the city's full at 1920x1088, 2 "
     "ranks; mask pass and texture channels)",
     "basicrenderer_tpu_torch/csrc/tex_block.cu",
     "basicrenderer_tpu/ops/textures.py:508"),
)


def slice15_sharding(np, torch, dev, kernels, smi, city_built):
    """Phase 18: tile sharding. The city (phase 13's, or built here) at
    SHARD_RES saved as .npz in a temporary directory, which each rank of
    parallel/tile_sharding.run_ranks loads through interop; each mode of
    SHARD_MODES runs its configs in its ranks (shard_rank). Returns the
    kernels-line records K1-shard, K2-shard, K3-shard and K4-shard: their
    launches are those at a tile-row offset on every mode's ranks."""
    import gc
    import tempfile
    from basicrenderer_tpu_torch.parallel import tile_sharding as ts
    t_phase = time.perf_counter()
    buf, view_of, params, label = shard_inputs(np, torch, city_built)
    results, lines = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for name, x in (("scene", buf), ("params", params)):
            save_fields(np, os.path.join(tmp, name + ".npz"), x)
        for h in {f.get("height", SHARD_RES["height"])
                  for _m, _n, configs in SHARD_MODES for _l, f in configs}:
            save_fields(np, os.path.join(tmp, f"view{h}.npz"),
                        view_of(SHARD_RES["width"] / h))
        nbytes = sum(os.path.getsize(os.path.join(tmp, f))
                     for f in os.listdir(tmp))
        save_s = time.perf_counter() - t0
        del buf, params
        gc.collect()
        torch.cuda.empty_cache()
        for mode, n, configs in SHARD_MODES:
            t0 = time.perf_counter()
            backend = ts.default_backend(n, dev.type)
            res = ts.run_ranks(shard_rank, n, backend, dev.type, tmp,
                               configs, n > 1)
            results[mode] = res
            for c, (cfg_label, _fields) in enumerate(configs):
                per = [r[c] for r in res]
                s0 = per[0]
                lines.append(
                    f"({mode}) {cfg_label}, {n} rank{'s' if n > 1 else ''} "
                    f"over {backend}: ms/frame per rank "
                    + " ".join(str([round(m, 3) for m in r["ms"]])
                               for r in per)
                    + f" (unsharded on rank 0: "
                    f"{[round(m, 3) for m in s0['unsharded_ms']]}) | launches"
                    f" K1/K2/K3/K4 per rank "
                    + " ".join(str([r["launches"][k] for k in
                                    ("K1", "K2", "K3", "K4")]) for r in per)
                    + " | at an offset, held to plain (exact K1/K2/K4, K3 "
                    "within tolerance): "
                    + " ".join(str([r["offset_launches"][k] for k in
                                    ("K1", "K2", "K3", "K4")]) for r in per)
                    + f" | collectives a rank {s0['collectives']}"
                    + (" (gloo takes the CUDA tensors: no host staging)"
                       if backend == "gloo" else "")
                    + f" | {s0['match']} | coverage {s0['coverage']:.4f}")
            lines[-1] += f" | spawn to end {time.perf_counter() - t0:.1f} s"
    recs = {}
    for name, mode, c, k, what, source, replaces in SHARD_RECORDS:
        launches = sum(r[ci]["offset_launches"][k]
                       for m in ("b", "c") for r in results[m]
                       for ci in range(len(r)))
        check(launches > 0, f"{name}: no launch at a tile-row offset")
        rec = results[mode][SHARD_TIMED_RANK][c]["rec"][k]
        err = max(r[ci]["errs"][k] for m in ("b", "c") for r in results[m]
                  for ci in range(len(r)))
        recs[name] = {"name": what, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": launches,
                      "max_abs_err": err, "ms": rec["ms"],
                      "device_ms": rec["device_ms"],
                      "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                      "bound_by": rec["bound_by"], "library_ms": None}
    say(f"phase 18 tile sharding: {label}, buffers saved as .npz ({nbytes} bytes, "
        f"{save_s:.1f} s), {SHARD_FRAMES} frames a run | "
        + " || ".join(lines)
        + " | rank " + str(SHARD_TIMED_RANK) + "'s last-frame launches at "
        "an offset, timed alone: "
        + "; ".join(f"{name} {r['ms']:.4f} ms for "
                    f"{results[m][SHARD_TIMED_RANK][c]['rec'][k]['calls']}"
                    f" launches (device {r['device_ms']:.4f}; bound "
                    f"{r['bound_ms']:.4f} {r['bound_by']}; plain "
                    f"{r['plain_ms']:.0f} ms; max abs err {r['max_abs_err']:.3g})"
                    for (name, m, c, k, *_), r in
                    zip(SHARD_RECORDS, recs.values()))
        + f" | phase {time.perf_counter() - t_phase:.1f} s | {smi}")
    return recs


def grid_sample_warp(torch, hist, tdy, tdx, th, tw, ref):
    """(ms, max abs diff vs `ref`, device ms) of one torch grid_sample
    (bilinear, border padding) warping (1, C, H, W) history by the same
    clipped per-tile shifts; the grid and layout are made outside the timing. A
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
    dev_ms = device_ms(torch, run, 20)
    err = float((run()[0].permute(1, 2, 0) - ref).abs().max())
    scale = float(hist.abs().max())
    check(err <= 1e-2 * scale, f"grid_sample yardstick differs from K5 by "
          f"{err} (history range {scale})")
    return ms, err, dev_ms


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
