"""Multi-card frame execution: the screen's tile rows split over a
torch.distributed process group.

Port of basicrenderer_tpu/parallel/tile_sharding.py. Each rank renders a
band of `tiles_y / world` tile rows: the geometry pass, the binning and
the shadow and VSM pages are replicated (every rank computes the same
values, so nothing is broadcast), the raster walks only the rank's tiles
(its slice of the full-screen tile offsets, at its tile-row offset), and
the per-pixel passes run on its rows. The passes that cross rows (the
HZBs, the VSM, cascade and local shadow terms, SSR, the reflection tiers,
GTAO, bloom, auto-exposure) gather the frame's rows, run on the whole
frame and keep their own rows; the per-pixel work that reads a
neighbouring row (the texture, IBL and voxel upsamples, the mip
estimate, the normal-map and anisotropy derivatives, the TAA clamp)
takes one halo row from each neighbour, so the ranks render the
single-card frame (the JAX package's sharded frame differs from its
single-device one at the seam rows there); "tex_wanted" is the minimum
over the ranks. This file holds no frame logic of its own: it runs the
same `graph.frame._render_body` as the single-card frame, with the
rank's `RowShards`.

The caller creates the process group and chooses its backend (NCCL with
a card per rank; gloo on the CPU, or for several ranks on one card,
which NCCL refuses; gloo takes CUDA tensors and moves them through the
host itself).

Like the JAX package's, the sharded frame renders `tiles_y * tile_h`
rows: when `height` is not a multiple of `tile_h` the last rank's band
holds the padded rows too, and the passes that cross rows see them. And
like the JAX package's, it is seam-exact with textures only when a
rank's rows are whole sampler blocks (`build_sharded_frame_fn`).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
from datetime import timedelta
from typing import Callable, Dict

import numpy as np
import torch
import torch.distributed as dist

from ..graph.frame import _render_body, check_config
from ..graph.framedata import FrameConfig, FrameParams, SceneBuffers, ViewData

AXIS = "sp"   # the JAX package's mesh axis; here, the process group

# Output keys that hold per-row image data (each rank's rows); every other
# output (counters, the streaming feedback, the VSM state) is replicated.
# The counters of a rank's own rows (light_overflow, oit_overflow) are
# that rank's, as a replicated output of the JAX shard_map is shard 0's.
_SHARDED_KEYS = ("image", "hdr", "depth", "depth_padded", "vis", "taa_out")


def _all_gather_rows(x: torch.Tensor, group, world: int) -> torch.Tensor:
    """Every rank's x concatenated along dim 0 in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


class RowShards:
    """One rank's band of a frame's tile rows and the collectives the
    frame body takes across bands (graph/frame._render_body's `rows`).
    `world` ranks of `group` each hold `rows_per` tile rows; this rank's
    first is `row0_tiles` (pixel row `row0_px`), and `height` its pixel
    rows. `collectives` counts the collectives it made."""

    def __init__(self, config: FrameConfig, group=None):
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        check_config(config, shards=self.world)
        self.rows_per = config.tiles_y // self.world
        self.row0_tiles = self.rank * self.rows_per
        self.row0_px = self.row0_tiles * config.tile_h
        self.height = self.rows_per * config.tile_h
        self.tile0 = self.row0_tiles * config.tiles_x
        self.num_tiles = self.rows_per * config.tiles_x
        self.collectives = 0

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's rows (dim 0) -> the whole frame's, every rank's in
        rank order."""
        self.collectives += 1
        return _all_gather_rows(x, self.group, self.world)

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The whole frame's rows (dim 0) -> this rank's."""
        return x[self.row0_px:self.row0_px + self.height]

    def localize(self, pairs):
        """Binned pairs over the whole screen -> the same pairs with this
        rank's slice of the tile offsets (the offsets stay absolute)."""
        return pairs._replace(tile_offsets=pairs.tile_offsets[
            self.tile0:self.tile0 + self.num_tiles + 1])

    def halo_rows(self, x: torch.Tensor, row_axis: int = 0):
        """(x with the upper neighbour's last row above it and the lower
        neighbour's first row below it along `row_axis`, the rows added
        above, the rows added below). At the frame's top and bottom no row
        is added (the JAX package clamps to the shard's own edge row
        there), so work on the extended rows meets the frame's edges as
        the whole frame does. One all_gather of every rank's two edge
        rows."""
        xr = x.movedim(row_axis, 0)
        h = xr.shape[0]
        edges = self.gather_rows(torch.stack([xr[0], xr[h - 1]]))
        r = self.rank
        top, bot = int(r > 0), int(r < self.world - 1)
        ext = torch.cat([edges[2 * r - 1:2 * r - 1 + top], xr,
                         edges[2 * r + 2:2 * r + 2 + bot]])
        return ext.movedim(0, row_axis), top, bot

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise minimum of x over the ranks."""
        self.collectives += 1
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MIN, group=self.group)
        return out


def build_sharded_frame_fn(config: FrameConfig, group=None) -> Callable:
    """The frame program of `config` with its tile rows split over the
    ranks of `group` (the default group when None): `frame(scene, view,
    params, prev_depth=None, taa_history=None, vsm_state=None,
    stage_hook=None)`, called by every rank with the same replicated
    scene, view, params and VSM state. `prev_depth` and `taa_history`
    are the rank's own rows (its previous frame's "depth_padded" and
    "taa_out"); the outputs in `_SHARDED_KEYS` are the rank's rows
    (`assemble` gathers them), the others replicated. Raises ValueError
    unless the tile rows divide evenly over the ranks, or with TAAU. A
    sharded frame with TAA resolves with the camera jitter, never with
    motion vectors, as in the JAX package. `frame.rows` is the rank's
    RowShards.

    The limit: with textures, the sampler groups its pixels (every
    texture_downscale-th) into 16-row blocks from each shard's first row,
    and each block picks one mip. Unless a shard's rows (`rows_per *
    tile_h`) are a multiple of 16 * texture_downscale, the blocks at the
    seams group other pixels than on one card, so their mips, and what an
    alpha-MASK pass keeps there, differ from the single-card frame, as
    in the JAX package's sharded frame (tests/test_torch_parallel.py
    holds the port to it on such a frame)."""
    rows = RowShards(config, group)
    lcfg = dataclasses.replace(config, height=rows.height)

    def frame(scene: SceneBuffers, view: ViewData, params: FrameParams,
              prev_depth: torch.Tensor = None,
              taa_history: torch.Tensor = None, vsm_state=None,
              stage_hook: Callable[[str], None] = None
              ) -> Dict[str, torch.Tensor]:
        return _render_body(scene, view, params, prev_depth, config,
                            stage_hook, taa_history, vsm_state=vsm_state,
                            lcfg=lcfg, row0_tiles=rows.row0_tiles, rows=rows)

    frame.rows = rows
    return frame


def assemble(out: Dict[str, torch.Tensor], group=None
             ) -> Dict[str, torch.Tensor]:
    """A sharded frame's outputs with the keys of `_SHARDED_KEYS`
    gathered into whole-frame tensors (every rank calls it and gets the
    whole frame); the other outputs as they are."""
    world = dist.get_world_size(group)
    return {k: (_all_gather_rows(v, group, world) if k in _SHARDED_KEYS
                else v) for k, v in out.items()}


# A collective that waits longer raises in its rank.
_COLLECTIVE_TIMEOUT = timedelta(seconds=900)


def _rank_main(rank: int, fn: Callable, n: int, backend: str, device: str,
               tmp: str, args: tuple) -> None:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            rank=rank, world_size=n,
                            timeout=_COLLECTIVE_TIMEOUT)
    try:
        result = fn(rank, n, dev, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn: Callable, n: int, backend: str, device, *args) -> list:
    """Run `fn(rank, n, device, *args)` in n spawned processes joined in
    one process group of `backend` (a `file://` store in a temporary
    directory, so concurrent runs cannot race on a port), and return
    each rank's result (picklable) in rank order. `device` "cuda" gives
    rank r card r modulo the cards there are; a device with an index
    puts every rank on it. A rank that raises makes run_ranks raise (the
    other ranks are stopped)."""
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, n, backend, str(device), tmp, args),
            nprocs=n, start_method="spawn")
        results = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def flagship_inputs(width: int, height: int, device="cuda"):
    """__graft_entry__._build_small_inputs(full=True)'s scene and
    FrameConfig, rebuilt from this package's modules: a floor, a
    checkered red cube, a gold sphere and a glass cube under a
    directional and a point light, with cluster LOD, cascades, clustered
    lights, IBL, textures with streaming feedback, SSR, OIT, geometry
    streaming, VSM, Reyes, GTAO, bloom, TAA and auto-exposure. Returns
    (config, buffers, view, params) on `device`."""
    from ..graph.framedata import make_view
    from ..models import procedural
    from ..models.materials import Material, MaterialRegistry
    from ..models.mesh import MeshRegistry
    from ..models.textures import TextureRegistry
    from ..scene.bridge import BridgeCapacities, SceneRenderBridge
    from ..scene.scene import Scene

    meshes, mats = MeshRegistry(), MaterialRegistry()
    tex = TextureRegistry(resolution=64)
    checker = tex.checkerboard()
    cube = meshes.add(procedural.make_cube(1.0))
    sphere = meshes.add(procedural.make_uv_sphere(0.5, rings=8, sectors=16))
    plane = meshes.add(procedural.make_plane(10.0, 2))
    red = mats.add(Material(base_color=np.array([0.8, 0.1, 0.1, 1],
                                                np.float32),
                            base_color_texture=checker))
    gold = mats.add(Material(base_color=np.array([0.9, 0.7, 0.3, 1],
                                                 np.float32),
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
    sc.set_camera(position=(3, 2.5, 4), target=(0, 0.5, 0),
                  aspect=width / height)
    sc.propagate_transforms()
    caps = BridgeCapacities(max_vertices=1 << 12, max_triangles=1 << 12,
                            max_objects=16, max_materials=8, max_lights=8,
                            max_clusters=256)
    bridge = SceneRenderBridge(sc, meshes, mats, caps, textures=tex)
    config = FrameConfig(
        width=width, height=height, tile_h=16, tile_w=128,
        max_pairs=1 << 13, enable_clod=True, max_visible_clusters=128,
        enable_shadows=True, num_cascades=2, shadow_resolution=256,
        enable_clustered=True, max_lights_per_cluster=8,
        enable_ibl=True, enable_gtao=True, enable_bloom=True,
        enable_taa=True, enable_auto_exposure=True,
        enable_textures=True, tex_channels=("base",),
        enable_texture_streaming=True, enable_ssr=True,
        enable_oit=True, oit_layers=2, oit_clusters=32,
        enable_streaming=True,
        enable_vsm=True, vsm_pages_per_frame=2,
        vsm_page_pairs=1 << 11, vsm_page_clusters=64,
        enable_reyes=True, reyes_tris=16, reyes_split_tris=8, reyes_dice=2)
    view = make_view(*sc.camera_matrices(aspect=width / height),
                     device=device)
    return (config, bridge.build_scene_buffers(device=device), view,
            FrameParams.default(device))


def _two_steps(frame, config, buf, view, params, device):
    from ..ops import vsm as vsm_ops
    out = frame(buf, view, params,
                vsm_state=vsm_ops.init_states(config, device))
    # The second step feeds the TAA history (the rank's rows) and the
    # replicated VSM page cache back in (frames in flight).
    return frame(buf, view, params, None, out["taa_out"],
                 vsm_state=out["vsm_state"])


def _dryrun_rank(rank: int, n: int, device: torch.device) -> dict:
    from ..graph.frame import build_frame_fn
    height = 16 * n
    config, buf, view, params = flagship_inputs(256, height, device)
    frame = build_sharded_frame_fn(config)
    whole = assemble(_two_steps(frame, config, buf, view, params, device))
    img = whole["image"].cpu().numpy()
    if img.shape != (height, 256, 3):
        raise AssertionError(f"sharded image {img.shape}")
    if not img.std() > 1.0:
        raise AssertionError("the sharded frame rendered nothing")
    for key in ("touched_groups", "tex_wanted"):
        if key not in whole:
            raise AssertionError(f"the sharded frame lost {key!r}")
    res = {"image": img,
           "coverage": float((whole["vis"] > 0).float().mean()),
           "bin_overflow": int(whole["bin_overflow"]),
           "collectives": frame.rows.collectives}
    if rank == 0:
        # The same two steps on one card, for the differences.
        one = _two_steps(build_frame_fn(config), config, buf, view, params,
                         device)
        diff = (whole["image"].int() - one["image"].int()).abs()
        res["vis_differ"] = int((whole["vis"] != one["vis"]).sum())
        res["image_max_diff"] = int(diff.max())
    return res


def default_backend(n: int, device="cuda") -> str:
    """NCCL when each of n ranks on `device` has a card of its own, gloo
    otherwise (the CPU, or several ranks on one card, which NCCL
    refuses)."""
    on_cards = torch.device(device).type == "cuda"
    return "nccl" if on_cards and 0 < n <= torch.cuda.device_count() \
        else "gloo"


def dryrun_multichip(n: int, device="cuda", backend: str = None) -> dict:
    """One full sharded frame step (two frames: the second takes the TAA
    history and the VSM state back) of `flagship_inputs` at 256 x 16n
    over n ranks, the counterpart of __graft_entry__.dryrun_multichip,
    and on rank 0 the same two frames on one card: the vis pixels and
    the largest image difference between the two are reported.
    `backend` defaults to `default_backend(n, device)`. Returns rank
    0's summary and prints it."""
    backend = backend or default_backend(n, device)
    res = run_ranks(_dryrun_rank, n, backend, device)[0]
    print(f"dryrun_multichip({n}) on {device} over {backend}: OK, full "
          f"frame (clod+shadows+vsm+reyes+clustered+ibl+textures+texstream+"
          f"ssr+oit+streaming+gtao+bloom+taa) image {res['image'].shape}, "
          f"coverage {res['coverage']:.2f}, overflow={res['bin_overflow']}, "
          f"{res['collectives']} collectives a rank; against one card: "
          f"{res['vis_differ']} vis "
          f"pixels differ, image max diff {res['image_max_diff']}",
          flush=True)
    return res


if __name__ == "__main__":
    import sys
    argv = sys.argv[1:]
    dryrun_multichip(int(argv[0]) if argv else 2,
                     device="cpu" if "--cpu" in argv else "cuda")
