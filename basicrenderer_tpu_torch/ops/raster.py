"""Tile rasterizers with fused attribute resolve: the CUDA kernels
(csrc/raster.cu) and their plain PyTorch versions.

Port of basicrenderer_tpu/ops/raster_pallas.py:
- K1 `_raster_kernel` in its plain mode, over per-triangle BinnedPairs
  (reference twins: ops/raster_ref.py::raster_tiles_ref and
  ops/resolve_pallas.py::resolve_attributes_ref). Per tile, walk the
  tile's binned pair rows and then the global big-triangle list.
- K2 `_raster_kernel_groups` in its plain and seeded modes, over
  GroupBinnedPairs: per tile, walk the rows of the tile's (group, tile)
  pairs straight from the lane table, skipping rows whose float tile bbox
  (lanes 11-14) misses the tile, then the global big-group list, whose
  entries are box-tested before their rows are read. Seeded mode starts
  from a previous raster's buffers (two-phase occlusion, phase 2).

At each pixel centre both evaluate the barycentric edge planes and the
depth plane, keep the closest (reverse-Z max) depth + triangle id, and
write the perspective attribute planes of the winner.

`raster_tiles` picks the implementation by the device of the pairs: CUDA
tensors launch a kernel (or raise), CPU tensors run the plain version.

Plane evaluation is the one numerical contract shared with the JAX
reference: every plane is fma(a, px, b*py) + c, each step rounded to f32
(see `plane_eval`). Any other form changes which pixels sit exactly on an
edge, and exact `vis` parity is lost.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple, Union

import torch

from ..graph.framedata import FrameConfig
from ..utils import cuda_build
from .raster_setup import SETUP_LANES, BinnedPairs, GroupBinnedPairs

# Channels: [octu/w, octv/w, u/w, v/w, mat_id, tangent, unused, accum];
# the plain and seeded modes write 0-4 (seeded keeps the seed's 5-7).
NUM_CHANNELS = 8
_ATTR_CHANNELS = 5
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "raster.cu"
Init = Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def plane_eval(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
               px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """a*px + b*py + c as fma(a, px, round(b*py)) + c.

    XLA's CPU backend contracts the JAX reference's planes into exactly this
    form, and the CUDA kernels spell it with __fmaf_rn. PyTorch has no f32
    fused multiply-add, so the fma is emulated in f64: a*px is exact there,
    and the sum is rounded back to f32 before c is added in f32."""
    return (a.double() * px.double() + (b * py).double()).float() + c


def _check_modes(pairs, config: FrameConfig, init, peel, accum: bool) -> None:
    if init is not None and not isinstance(pairs, GroupBinnedPairs):
        raise NotImplementedError(
            "seeded per-triangle raster (the soup path's two-phase "
            "occlusion) is not ported yet (FrameConfig.enable_occlusion "
            "without enable_clod)")
    if peel is not None:
        raise NotImplementedError(
            "peeled raster (OIT / alpha-mask peels) is not ported yet "
            "(FrameConfig.enable_oit, FrameConfig.mask_peels > 1)")
    if accum:
        raise NotImplementedError(
            "accumulating raster (OIT beyond-K tail) is not ported yet "
            "(FrameConfig.enable_oit)")
    if config.enable_vertex_tangents:
        raise NotImplementedError(
            "the tangent channel is not ported yet "
            "(FrameConfig.enable_vertex_tangents)")


def raster_tiles(pairs: Union[BinnedPairs, GroupBinnedPairs],
                 config: FrameConfig, tile_row0: int = 0, init: Init = None,
                 peel=None, accum: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused raster + attribute resolve on the padded tile grid.

    Returns (depth (H', W') f32, vis (H', W') i32,
             channels (NUM_CHANNELS, H', W') f32). `tile_row0` offsets the
    tile grid vertically in global screen space (edge planes are in global
    pixels). `init` = (depth, vis, channels) seeds a group raster (two-phase
    occlusion replay). The peeled, accum and tangent modes, and seeding a
    per-triangle raster, raise NotImplementedError."""
    _check_modes(pairs, config, init, peel, accum)
    grouped = isinstance(pairs, GroupBinnedPairs)
    dev = (pairs.lanes if grouped else pairs.pair_data).device
    if dev.type == "cuda":
        if grouped:
            return raster_groups_cuda(pairs, config, tile_row0, init)
        return raster_tiles_cuda(pairs, config, tile_row0)
    if dev.type == "cpu":
        if grouped:
            return raster_groups_plain(pairs, config, tile_row0, init)
        return raster_tiles_plain(pairs, config, tile_row0)
    raise ValueError(f"no raster for device {dev}")


def _to_image(t: torch.Tensor, config: FrameConfig) -> torch.Tensor:
    """(..., tiles, th, tw) -> (..., H', W')."""
    th, tw = config.tile_h, config.tile_w
    lead = t.shape[:-3]
    t = t.reshape(*lead, config.tiles_y, config.tiles_x, th, tw)
    t = t.transpose(-3, -2)
    return t.reshape(*lead, config.tiles_y * th, config.tiles_x * tw)


def _to_tiles(img: torch.Tensor, config: FrameConfig) -> torch.Tensor:
    """(..., H', W') -> (..., tiles, th, tw) (inverse of _to_image)."""
    th, tw = config.tile_h, config.tile_w
    lead = img.shape[:-2]
    t = img.reshape(*lead, config.tiles_y, th, config.tiles_x, tw)
    return t.transpose(-3, -2).reshape(*lead, config.num_tiles, th, tw)


def _plain_walk(pair_data: torch.Tensor, tile_offsets: torch.Tensor,
                big_count: int, config: FrameConfig, tile_row0: int,
                init: Init = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's walk, vectorised across tiles: step s gathers row start_t + s
    of every tile t at once (masked past each tile's count), then every
    tile walks rows [0, big_count) with the bbox test. Reads the longest
    tile's row count on the host."""
    th, tw = config.tile_h, config.tile_w
    tiles_x = config.tiles_x
    N = config.num_tiles
    dev = pair_data.device
    f32 = torch.float32
    n_rows = pair_data.shape[0]

    t = torch.arange(N, device=dev)
    ty = t // tiles_x + tile_row0
    tx = t % tiles_x
    # Pixel centres, broadcast (N, 1, tw) and (N, th, 1).
    px = (torch.arange(tw, device=dev, dtype=f32)[None, None, :]
          + (tx * tw).to(f32)[:, None, None] + 0.5)
    py = (torch.arange(th, device=dev, dtype=f32)[None, :, None]
          + (ty * th).to(f32)[:, None, None] + 0.5)
    txf, tyf = tx.to(f32), ty.to(f32)

    if init is None:
        depth = torch.zeros((N, th, tw), dtype=f32, device=dev)
        vis = torch.zeros((N, th, tw), dtype=torch.int32, device=dev)
        chans = torch.zeros((NUM_CHANNELS, N, th, tw), dtype=f32, device=dev)
    else:
        depth = _to_tiles(init[0], config).clone()
        vis = _to_tiles(init[1], config).clone()
        chans = _to_tiles(init[2], config).clone()

    def row_step(rows: torch.Tensor, live: torch.Tensor) -> None:
        d = rows[:, :, None, None]                       # (N, 32, 1, 1)
        e0 = plane_eval(d[:, 0], d[:, 1], d[:, 2], px, py)
        e1 = plane_eval(d[:, 3], d[:, 4], d[:, 5], px, py)
        e2 = (1.0 - e0) - e1
        z = plane_eval(d[:, 6], d[:, 7], d[:, 8], px, py)
        tri_id_f = d[:, 9]
        ok = live[:, None, None] & (tri_id_f > 0.5)
        passd = ok & (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (z > depth)
        depth.copy_(torch.where(passd, z, depth))
        vis.copy_(torch.where(passd, tri_id_f.to(torch.int32), vis))
        for ch in range(4):
            val = plane_eval(d[:, 15 + ch * 3], d[:, 16 + ch * 3],
                             d[:, 17 + ch * 3], px, py)
            chans[ch] = torch.where(passd, val, chans[ch])
        chans[4] = torch.where(passd, d[:, 10], chans[4])

    if n_rows:
        offs = tile_offsets.long().clamp(max=n_rows)
        starts, counts = offs[:-1], offs[1:] - offs[:-1]
        for s in range(int(counts.max()) if N else 0):
            idx = torch.clamp(starts + s, max=n_rows - 1)
            row_step(pair_data[idx], s < counts)
        for j in range(min(big_count, n_rows)):
            row = pair_data[j]
            hit = ((txf >= row[11]) & (txf <= row[12])
                   & (tyf >= row[13]) & (tyf <= row[14]))
            row_step(row.expand(N, SETUP_LANES), hit)

    return (_to_image(depth, config), _to_image(vis, config),
            _to_image(chans, config))


def raster_tiles_plain(pairs: BinnedPairs, config: FrameConfig,
                       tile_row0: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1. Reads the big count on the host."""
    return _plain_walk(pairs.pair_data, pairs.tile_offsets,
                       int(pairs.big_count), config, tile_row0)


def expand_group_pairs(pairs: GroupBinnedPairs, config: FrameConfig,
                       tile_row0: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (row, tile) pairs K2 evaluates, in its order: per tile, the rows
    of its (group, tile) pairs in pair order, then the rows of every
    big-group entry whose group box covers the tile, in list order; rows
    whose float bbox (lanes 11-14) misses the tile are dropped, as the
    kernel skips them. Returns (pair_data (R, SETUP_LANES), tile_offsets
    (num_tiles + 1,) i32) for K1's walk."""
    GR = config.group_rows
    N = config.num_tiles
    lanes = pairs.lanes
    dev = lanes.device
    i64 = torch.int64
    offs = pairs.tile_offsets.long()
    Pc = pairs.group_ids.shape[0]
    Bg = pairs.big_ids.shape[0]
    j = torch.arange(GR, dtype=i64, device=dev)

    # Own pairs: tile of pair p is the t with offs[t] <= p < offs[t+1].
    p = torch.arange(Pc, dtype=i64, device=dev)
    tile_own = torch.searchsorted(offs[1:], p, right=True)
    live_own = (p < offs[N])[:, None].expand(Pc, GR)
    rows_own = pairs.group_ids.long()[:, None] * GR + j
    tile_own = tile_own[:, None].expand(Pc, GR)
    seq_own = p[:, None] * GR + j

    # Big list: every tile x every live entry, box-tested.
    t = torch.arange(N, dtype=i64, device=dev)[:, None]
    tx, tyg = t % config.tiles_x, t // config.tiles_x + tile_row0
    bx, by = pairs.big_bx.long()[None], pairs.big_by.long()[None]
    pb = torch.arange(Bg, dtype=i64, device=dev)[None]
    hit = ((pb < pairs.big_count.long()) & (tx >= bx // 2048)
           & (tx <= bx % 2048) & (tyg >= by // 2048) & (tyg <= by % 2048))
    live_big = hit[:, :, None].expand(N, Bg, GR)
    rows_big = (pairs.big_ids.long()[None, :, None] * GR + j).expand(N, Bg, GR)
    tile_big = t[:, :, None].expand(N, Bg, GR)
    seq_big = Pc * GR + (pb[:, :, None] * GR + j).expand(N, Bg, GR)

    rows = torch.cat([rows_own.reshape(-1), rows_big.reshape(-1)])
    tile = torch.cat([tile_own.reshape(-1), tile_big.reshape(-1)])
    seq = torch.cat([seq_own.reshape(-1), seq_big.reshape(-1)])
    live = torch.cat([live_own.reshape(-1), live_big.reshape(-1)])
    rows, tile, seq = rows[live], tile[live], seq[live]
    box = lanes[rows, 11:15]
    txf = (tile % config.tiles_x).to(torch.float32)
    tyf = (tile // config.tiles_x + tile_row0).to(torch.float32)
    keep = ((txf >= box[:, 0]) & (txf <= box[:, 1])
            & (tyf >= box[:, 2]) & (tyf <= box[:, 3]))
    rows, tile, seq = rows[keep], tile[keep], seq[keep]
    order = torch.argsort(tile * (Pc * GR + Bg * GR) + seq)
    rows, tile = rows[order], tile[order]
    tile_offsets = torch.searchsorted(
        tile, torch.arange(N + 1, dtype=i64, device=dev)).to(torch.int32)
    return lanes[rows], tile_offsets


def raster_groups_plain(pairs: GroupBinnedPairs, config: FrameConfig,
                        tile_row0: int = 0, init: Init = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2: K1's walk over the expanded
    (row, tile) pairs, starting from `init` when seeded."""
    pair_data, offs = expand_group_pairs(pairs, config, tile_row0)
    return _plain_walk(pair_data, offs, 0, config, tile_row0, init)


_fns = {}


def _kernel_fn(name: str):
    """An entry point of the built library with its ctypes signature."""
    if name not in _fns:
        fn = getattr(cuda_build.load(SOURCE).lib, name)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "br_raster_tiles":
            fn.argtypes = [p, p, p, ll, p, p, p, i, i, i, i, i, p]
        else:
            fn.argtypes = [p, p, p, p, p, p, p, ll, i, i, i, p, p, p, p, p, p,
                           i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def build_kernel() -> cuda_build.CudaLibrary:
    """Build (if needed) and load the raster library; returns it."""
    return cuda_build.load(SOURCE)


def _check_tensors(dev, named):
    for name, x in named:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def raster_tiles_cuda(pairs: BinnedPairs, config: FrameConfig,
                      tile_row0: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream (no synchronisation).
    `raster_tiles_cuda.launches` counts the launches."""
    pd, offs, big = pairs.pair_data, pairs.tile_offsets, pairs.big_count
    dev = pd.device
    if dev.type != "cuda":
        raise ValueError(f"raster_tiles_cuda needs CUDA tensors, got {dev}")
    if pd.dtype != torch.float32 or pd.dim() != 2 or pd.shape[1] != SETUP_LANES:
        raise ValueError(f"pair_data must be (R, {SETUP_LANES}) f32, got "
                         f"{tuple(pd.shape)} {pd.dtype}")
    if offs.dtype != torch.int32 or offs.shape != (config.num_tiles + 1,):
        raise ValueError(f"tile_offsets must be ({config.num_tiles + 1},) "
                         f"i32, got {tuple(offs.shape)} {offs.dtype}")
    if big.dtype != torch.int32 or big.numel() != 1:
        raise ValueError(f"big_count must be one i32, got {big.dtype}")
    _check_tensors(dev, (("pair_data", pd), ("tile_offsets", offs),
                         ("big_count", big)))
    Hp, Wp = config.padded_height, config.padded_width
    depth = torch.empty((Hp, Wp), dtype=torch.float32, device=dev)
    vis = torch.empty((Hp, Wp), dtype=torch.int32, device=dev)
    channels = torch.empty((NUM_CHANNELS, Hp, Wp), dtype=torch.float32,
                           device=dev)
    fn = _kernel_fn("br_raster_tiles")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(offs.data_ptr(), big.data_ptr(), pd.data_ptr(), pd.shape[0],
                 depth.data_ptr(), vis.data_ptr(), channels.data_ptr(),
                 config.tiles_x, config.tiles_y, config.tile_h, config.tile_w,
                 int(tile_row0), stream)
    if err != 0:
        raise RuntimeError(f"raster kernel launch failed: CUDA error {err}")
    raster_tiles_cuda.launches += 1
    return depth, vis, channels


raster_tiles_cuda.launches = 0


def raster_groups_cuda(pairs: GroupBinnedPairs, config: FrameConfig,
                       tile_row0: int = 0, init: Init = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K2 on the current stream (no synchronisation), seeded from
    `init` when given. `raster_groups_cuda.launches` counts the launches."""
    lanes = pairs.lanes
    dev = lanes.device
    if dev.type != "cuda":
        raise ValueError(f"raster_groups_cuda needs CUDA tensors, got {dev}")
    GR = config.group_rows
    if GR not in (8, 16, 32):
        raise ValueError(f"group_rows must be 8, 16 or 32, got {GR}")
    if (lanes.dtype != torch.float32 or lanes.dim() != 2
            or lanes.shape[1] != SETUP_LANES or lanes.shape[0] % GR):
        raise ValueError(f"lanes must be (NG*{GR}, {SETUP_LANES}) f32, got "
                         f"{tuple(lanes.shape)} {lanes.dtype}")
    ints = (("group_ids", pairs.group_ids), ("tile_offsets", pairs.tile_offsets),
            ("big_ids", pairs.big_ids), ("big_count", pairs.big_count),
            ("big_bx", pairs.big_bx), ("big_by", pairs.big_by))
    for name, x in ints:
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be i32, got {x.dtype}")
    if pairs.tile_offsets.shape != (config.num_tiles + 1,):
        raise ValueError(f"tile_offsets must be ({config.num_tiles + 1},)")
    nbig = pairs.big_ids.shape[0]
    if pairs.big_bx.shape != (nbig,) or pairs.big_by.shape != (nbig,):
        raise ValueError("big_ids, big_bx and big_by differ in length")
    _check_tensors(dev, (("lanes", lanes),) + ints)
    Hp, Wp = config.padded_height, config.padded_width
    if init is not None:
        d0, v0, c0 = init
        if (d0.shape != (Hp, Wp) or v0.shape != (Hp, Wp)
                or c0.shape != (NUM_CHANNELS, Hp, Wp)
                or d0.dtype != torch.float32 or v0.dtype != torch.int32
                or c0.dtype != torch.float32):
            raise ValueError("init must be (depth f32, vis i32, channels "
                             f"f32) on the padded grid {Hp}x{Wp}")
        _check_tensors(dev, (("init depth", d0), ("init vis", v0),
                             ("init channels", c0)))
    depth = torch.empty((Hp, Wp), dtype=torch.float32, device=dev)
    vis = torch.empty((Hp, Wp), dtype=torch.int32, device=dev)
    channels = torch.empty((NUM_CHANNELS, Hp, Wp), dtype=torch.float32,
                           device=dev)
    seed = (0, 0, 0) if init is None else tuple(x.data_ptr() for x in init)
    fn = _kernel_fn("br_raster_groups")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pairs.tile_offsets.data_ptr(), pairs.group_ids.data_ptr(),
                 pairs.big_ids.data_ptr(), pairs.big_count.data_ptr(),
                 pairs.big_bx.data_ptr(), pairs.big_by.data_ptr(),
                 lanes.data_ptr(), lanes.shape[0] // GR, GR,
                 pairs.group_ids.shape[0], nbig, *seed, depth.data_ptr(),
                 vis.data_ptr(), channels.data_ptr(), config.tiles_x,
                 config.tiles_y, config.tile_h, config.tile_w, int(tile_row0),
                 stream)
    if err != 0:
        raise RuntimeError(f"group raster kernel launch failed: CUDA error {err}")
    raster_groups_cuda.launches += 1
    return depth, vis, channels


raster_groups_cuda.launches = 0
