#!/usr/bin/env python3
"""Smoke run of basicrenderer_tpu_torch, the PyTorch + CUDA port, on one
NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernel from
csrc/, checks it against its plain PyTorch version, renders the golden
scene and compares it with tests/goldens/basic_deferred.png, then renders
a 1920x1080 frame of ~1.36M triangles through the public entry points
(Scene -> SceneRenderBridge -> build_frame_fn) and times it. Each phase
prints one line; any failed check raises and the exit code is non-zero.
The second-to-last line is the kernels' JSON record and the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero
and prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FRAMES_WARM = 3
FRAMES_TIMED = 20
GOLDEN_RMSE_MAX = 6.0        # tests/test_goldens.py
CHANNEL_RTOL = 1e-6          # kernel vs plain channels; vis and depth exact


class CheckFailed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def say(line):
    print(line, flush=True)


def build_random_pairs(torch, seed, n, cfg, dev):
    """Random clip-space triangles (tests/test_raster.py's generator) set up
    and binned by the port's front end."""
    import numpy as np
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
    return raster_setup.bin_pairs(lanes, bbox, valid, cfg)


def compare_kernel(torch, pairs, cfg, label):
    """Kernel vs plain version on the same pairs: vis and depth exactly,
    channels within CHANNEL_RTOL. Returns (max abs err, plain seconds,
    coverage)."""
    from basicrenderer_tpu_torch.ops import raster
    kd, kv, kch = raster.raster_tiles_cuda(pairs, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pd, pv, pch = raster.raster_tiles_plain(pairs, cfg)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    nvis = int((kv != pv).sum())
    ndepth = int((kd != pd).sum())
    check(nvis == 0 and ndepth == 0,
          f"{label}: kernel differs from plain on {nvis} vis / {ndepth} depth")
    torch.testing.assert_close(kch, pch, rtol=CHANNEL_RTOL, atol=CHANNEL_RTOL)
    err = max(float((kd - pd).abs().max()), float((kch - pch).abs().max()))
    return err, plain_s, float((kv > 0).float().mean())


def golden_scene(np):
    """tests/test_frame_e2e.build_test_scene, from the port's modules."""
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


def courtyard_scene(np, grid=12, seed=42):
    """The dense courtyard of basicrenderer_tpu/models/scenes.py:86-140
    (palette, placement, lights, camera) with every object registered as
    its own mesh: fractal terrain (60, 256 segments, height 2) and grid^2
    objects cycling a 64x128 UV sphere, a 96x48 torus and a 0.8 cube."""
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
    caps = BridgeCapacities(max_vertices=nv, max_triangles=nt,
                            max_objects=grid * grid + 1, max_materials=16,
                            max_lights=8)
    return sc, SceneRenderBridge(sc, meshes, mats, caps), nt


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn
    from basicrenderer_tpu_torch.graph.framedata import (FrameConfig,
                                                         FrameParams, make_view)
    from basicrenderer_tpu_torch.ops import raster
    from basicrenderer_tpu_torch.utils import cuda_build
    from basicrenderer_tpu_torch.utils.png import read_png
    dev = torch.device("cuda", 0)

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
    lib = raster.build_kernel()
    regs = [ln.split("info    : ")[-1] for ln in lib.build_log.splitlines()
            if "registers" in ln]
    say(f"phase 2 build: {os.path.relpath(lib.path, REPO)} in "
        f"{time.perf_counter() - t0:.2f} s; ptxas: {' / '.join(regs) or 'cached'}")

    # -- 3. kernel vs plain on the card ------------------------------------
    results = []
    for seed in (0, 5):
        cfg = FrameConfig(width=256, height=64, tile_h=16, tile_w=128,
                          max_pairs=1 << 12)
        pairs = build_random_pairs(torch, seed, 60, cfg, dev)
        results.append((f"random{seed}", compare_kernel(torch, pairs, cfg,
                                                        f"random seed {seed}")))
    cfg512 = FrameConfig(width=512, height=512, tile_h=32, tile_w=128,
                         max_pairs=1 << 16, max_tiles_per_tri=8)
    pairs = build_random_pairs(torch, 9, 3000, cfg512, dev)
    check(int(pairs.big_count) > 0, "512x512 scene has no big triangles")
    results.append(("random512", compare_kernel(torch, pairs, cfg512,
                                                "512x512 scene")))
    gsc, gbridge = golden_scene(np)
    gcfg = FrameConfig(width=128, height=128, tile_h=16, tile_w=128,
                       max_pairs=1 << 12)
    gview = make_view(*gsc.camera_matrices(aspect=1.0), device=dev)
    gbuf = gbridge.build_scene_buffers(device=dev)
    from basicrenderer_tpu_torch.graph.frame import geometry_pass
    gpairs = geometry_pass(gbuf, gview, gcfg)[-1]
    results.append(("golden", compare_kernel(torch, gpairs, gcfg, "golden scene")))
    say("phase 3 kernel vs plain: " + "; ".join(
        f"{k} max_abs_err {e:.3g} coverage {c:.3f}" for k, (e, _, c) in results)
        + f" (vis, depth exact; channels rtol {CHANNEL_RTOL})")

    # -- 4. golden on the card ---------------------------------------------
    frame = build_frame_fn(gcfg)
    out = frame(gbuf, gview, FrameParams.default(dev))
    img = out["image"].cpu().numpy()
    golden = read_png(os.path.join(REPO, "tests", "goldens", "basic_deferred.png"))
    rmse = float(np.sqrt(np.mean((img.astype(np.float32)
                                  - golden.astype(np.float32)) ** 2)))
    cpu_out = frame(gbridge.build_scene_buffers(device="cpu"),
                    make_view(*gsc.camera_matrices(aspect=1.0)),
                    FrameParams.default())
    rmse_cpu = float(np.sqrt(np.mean((img.astype(np.float32)
                                      - cpu_out["image"].numpy()) ** 2)))
    vis_agree = float((out["vis"].cpu() == cpu_out["vis"]).float().mean())
    check(rmse <= GOLDEN_RMSE_MAX, f"golden RMSE {rmse} > {GOLDEN_RMSE_MAX}")
    check(vis_agree >= 0.999, f"card vs CPU vis agreement {vis_agree}")
    say(f"phase 4 golden: 128x128 RMSE vs basic_deferred.png {rmse:.4f} "
        f"(limit {GOLDEN_RMSE_MAX}); vs the port on the CPU: RMSE {rmse_cpu:.4f},"
        f" vis agreement {vis_agree:.5f}")

    # -- 5. the slice at full size -----------------------------------------
    t0 = time.perf_counter()
    sc, bridge, ntris = courtyard_scene(np)
    buf = bridge.build_scene_buffers(device=dev)
    view = make_view(*sc.camera_matrices(aspect=16 / 9), device=dev)
    params = FrameParams.default(dev)
    setup_s = time.perf_counter() - t0
    cfg = FrameConfig(width=1920, height=1080, tile_h=32, tile_w=128,
                      max_pairs=1 << 22, near_clip_tris=4096)
    frame = build_frame_fn(cfg)

    marks = []

    def hook(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    raster.raster_tiles_cuda.launches = 0
    frame_ms, stage_ms = [], {}
    for i in range(FRAMES_WARM + FRAMES_TIMED):
        marks.clear()
        t0 = time.perf_counter()
        out = frame(buf, view, params, stage_hook=hook)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        if i >= FRAMES_WARM:
            frame_ms.append(dt)
            for (name, a), (_, b) in zip(marks, marks[1:]):
                stage_ms.setdefault(name, []).append(a.elapsed_time(b))
    launches = raster.raster_tiles_cuda.launches
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    n_frames = FRAMES_WARM + FRAMES_TIMED
    check(launches == n_frames,
          f"raster kernel launched {launches} times in {n_frames} frames")

    img, hdr, vis = out["image"], out["hdr"], out["vis"]
    counters = {k: int(out[k]) for k in ("bin_overflow", "cluster_overflow",
                                         "num_pairs")}
    coverage = float((vis > 0).float().mean())
    check(tuple(img.shape) == (1080, 1920, 3) and img.dtype == torch.uint8,
          f"image {tuple(img.shape)} {img.dtype}")
    check(bool(torch.isfinite(hdr).all()), "non-finite HDR values")
    check(counters["bin_overflow"] == 0 and counters["cluster_overflow"] == 0,
          f"overflow {counters}")
    check(0.5 < coverage < 1.0, f"coverage {coverage}")
    check(float(img.float().std()) > 5.0, "flat image")

    # K1 alone and its plain version, on the frame's own pairs.
    pairs = geometry_pass(buf, view, cfg)[-1]
    torch.cuda.synchronize()
    for _ in range(2):
        raster.raster_tiles_cuda(pairs, cfg)
    reps = 10
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        raster.raster_tiles_cuda(pairs, cfg)
    e1.record()
    torch.cuda.synchronize()
    k1_ms = e0.elapsed_time(e1) / reps
    err, plain_s, _ = compare_kernel(torch, pairs, cfg, "1080p frame")
    med = statistics.median(frame_ms)
    stages = " ".join(f"{k} {statistics.median(v):.3f}" for k, v in stage_ms.items())
    say(f"phase 5 slice: 1920x1080 tile 32x128, {ntris} triangles "
        f"({bridge.packed.num_tris} packed), host scene build {setup_s:.1f} s | "
        f"median {med:.3f} ms/frame over {FRAMES_TIMED} (min {min(frame_ms):.3f},"
        f" max {max(frame_ms):.3f}) | stage ms (CUDA events, median): {stages} |"
        f" K1 {k1_ms:.3f} ms vs plain {plain_s * 1e3:.1f} ms, max_abs_err {err:.3g}"
        f" | K1 launches {launches} in {n_frames} frames | overflow "
        f"bin {counters['bin_overflow']} clip {counters['cluster_overflow']},"
        f" pairs {counters['num_pairs']}, big {int(pairs.big_count)} | coverage"
        f" {coverage:.4f} | peak {peak_gib:.2f} GiB | {smi}")

    print(json.dumps({"kernels": [{
        "name": "raster_tiles (K1, plain mode)", "route": "cuda",
        "source": "basicrenderer_tpu_torch/csrc/raster.cu",
        "replaces": "basicrenderer_tpu/ops/raster_pallas.py:135",
        "launches": launches, "max_abs_err": err, "ms": k1_ms,
        "plain_ms": plain_s * 1e3}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
