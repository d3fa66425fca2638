"""Tile rasterizers with fused attribute resolve: the CUDA kernels
(csrc/raster.cu) and their plain PyTorch versions.

Port of basicrenderer_tpu/ops/raster_pallas.py:
- K1 `_raster_kernel` in its plain, seeded, peel and accum modes, over
  per-triangle BinnedPairs (reference twins: ops/raster_ref.py::
  raster_tiles_ref and ops/resolve_pallas.py::resolve_attributes_ref).
  Per tile, walk the tile's binned pair rows and then the global
  big-triangle list. Seeded mode is phase 2 of the soup frame's
  two-phase occlusion (and of the cluster path's with group_binning
  off).
- K2 `_raster_kernel_groups` in its plain, seeded, peel and accum modes,
  over GroupBinnedPairs: per tile, walk the rows of the tile's (group,
  tile) pairs straight from the lane table, skipping rows whose float
  tile bbox (lanes 11-14) misses the tile, then the global big-group
  list, whose entries are box-tested before their rows are read. Seeded
  mode starts from a previous raster's buffers (two-phase occlusion,
  phase 2).
Peel mode (OIT layers, further alpha-MASK layers) starts from a seed
depth and keeps only fragments strictly in front of a per-pixel peel
bound; accum mode (the OIT tail) sums per pixel, in walk order, the
depth-warp-weighted alpha and premultiplied colour, the optical depths
and the fragment count of every fragment in the band, into channels
0-3, 4-6 and 7.

At each pixel centre both evaluate the barycentric edge planes and the
depth plane, keep the closest (reverse-Z max) depth + triangle id, and
write the perspective attribute planes of the winner (plain, seeded and
peel modes). With FrameConfig.enable_vertex_tangents those modes also
write the winner's flat tangent angle (lane 27) to channel 5 (the
tangent mode of both kernels); accum mode ignores the flag, as the JAX
package's does.

`raster_tiles` picks the implementation by the device of the pairs: CUDA
tensors launch a kernel (or raise), CPU tensors run the plain version.
On the card the plain, seeded and peel modes cut each tile's walk into
spans (`span_queue` is the plain version of that work queue) that a
persistent grid shares out, and keep the winner of each pixel as a 64-bit
(depth, walk order) key (csrc/raster.cu). Accum mode's sums keep walk
order, so a tile is cut by pixels instead: one pixel a thread, the
rows' common work (tests, payload decode) once a block, by K1's producer
warp while the pixel warps sum the previous stage.

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
# the plain and seeded modes write 0-4, and 5 in tangent mode (seeded
# keeps the seed's others).
NUM_CHANNELS = 8
_ATTR_CHANNELS = 5
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "raster.cu"
# Walk rows in one work item of the kernels' split design (K2: walk
# entries of SPAN_ROWS // group_rows groups).
SPAN_ROWS = 256
Init = Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
Peel = Optional[Tuple[torch.Tensor, torch.Tensor]]


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 fused multiply-add a*b + c, emulated in f64: the product of two
    f32 values is exact there, and the f64 sum rounds to f32 as a single
    rounding would unless it lands exactly halfway between two f32
    values (double rounding)."""
    return (a.double() * b.double() + c.double()).float()


def plane_eval(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
               px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """a*px + b*py + c as fma(a, px, round(b*py)) + c.

    XLA's CPU backend contracts the JAX reference's planes into exactly this
    form, and the CUDA kernels spell it with __fmaf_rn. PyTorch has no f32
    fused multiply-add, so the fma is emulated in f64 (`fma32`), and c is
    added in f32."""
    return fma32(a, px, b * py) + c


def _check_modes(init, peel, accum: bool) -> None:
    if init is not None and (peel is not None or accum):
        raise ValueError("a seeded raster takes neither peel nor accum")


def raster_tiles(pairs: Union[BinnedPairs, GroupBinnedPairs],
                 config: FrameConfig, tile_row0: int = 0, init: Init = None,
                 peel: Peel = None, accum: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused raster + attribute resolve on the padded tile grid.

    Returns (depth (H', W') f32, vis (H', W') i32,
             channels (NUM_CHANNELS, H', W') f32). `tile_row0` offsets the
    tile grid vertically in global screen space (edge planes are in global
    pixels); `pairs` then carries the shard's slice of the full-screen
    tile offsets (parallel/tile_sharding.RowShards.localize). `init` = (depth, vis, channels) seeds a group raster (two-phase
    occlusion replay). `peel` = (seed_depth, peel_depth) (H', W') runs a
    depth-peeling pass: the depth starts at the seed, vis and channels at
    zero, and a fragment must also lie strictly in front of peel_depth
    (reverse-Z). `accum` sums the OIT tail's 8 channels instead (w*alpha,
    w*r, w*g, w*b, the optical depths r, g, b, the count; w = the
    depth-warp weight with `peel`, else 1) and leaves depth at its start
    and vis at zero. `config.enable_vertex_tangents` selects the tangent
    mode (channel 5 takes the winner's lane 27)."""
    _check_modes(init, peel, accum)
    grouped = isinstance(pairs, GroupBinnedPairs)
    dev = (pairs.lanes if grouped else pairs.pair_data).device
    if dev.type == "cuda":
        if grouped:
            return raster_groups_cuda(pairs, config, tile_row0, init, peel,
                                      accum)
        return raster_tiles_cuda(pairs, config, tile_row0, init, peel,
                                 accum)
    if dev.type == "cpu":
        if grouped:
            return raster_groups_plain(pairs, config, tile_row0, init, peel,
                                       accum)
        return raster_tiles_plain(pairs, config, tile_row0, init, peel,
                                  accum)
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


# The plain walk's chunk: at most _CHUNK_ROWS rows of every tile a step,
# and at most _CHUNK_VALUES (row, pixel) values.
_CHUNK_ROWS = 64
_CHUNK_VALUES = 1 << 23
_INV255 = torch.tensor(1.0 / 255.0, dtype=torch.float32)
_FOUR255 = torch.tensor(4.0 / 255.0, dtype=torch.float32)
_INV256 = torch.tensor(1.0 / 256.0, dtype=torch.float32)


def unpack_payload(p28: torch.Tensor, p30: torch.Tensor,
                   p31: torch.Tensor):
    """The accum mode's per-row bytes, as exact floats: (a8, r8, g8, b8,
    odr8, odg8, odb8) from payload lanes 30 (a8 + odr8*256 + odg8*65536),
    28 (r8 + g8*256 + b8*65536) and 31 (odb8), by the floor-divide chain of
    the JAX package."""
    hi = torch.floor(p30 * _INV256)
    a8 = p30 - hi * 256.0
    hi2 = torch.floor(hi * _INV256)
    odr8 = hi - hi2 * 256.0
    c1 = torch.floor(p28 * _INV256)
    r8 = p28 - c1 * 256.0
    b8 = torch.floor(c1 * _INV256)
    g8 = c1 - b8 * 256.0
    return a8, r8, g8, b8, odr8, hi2, p31


def accum_weight(z: torch.Tensor, seed: torch.Tensor,
                 peel_z: torch.Tensor) -> torch.Tensor:
    """The depth-warp weight u*u + 0.05 of a fragment at z in the band
    (seed .. peel_z): u = clip((z - seed) / max(peel_z - seed, 1e-6), 0, 1).
    The square and the add are one fused multiply-add, the form XLA's CPU
    backend gives the JAX package."""
    u = torch.clamp((z - seed) / torch.clamp(peel_z - seed, min=1e-6),
                    0.0, 1.0)
    return fma32(u, u, torch.tensor(0.05, dtype=torch.float32))


def accum_add(chan: torch.Tensor, wgt: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """chan + wgt * v as one fused multiply-add (XLA's CPU form)."""
    return fma32(wgt, v, chan)


def _plain_walk(pair_data: torch.Tensor, tile_offsets: torch.Tensor,
                big_count: int, config: FrameConfig, tile_row0: int,
                init: Init = None, peel: Peel = None, accum: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's walk, vectorised across tiles: step s gathers row start_t + s
    of every tile t at once (masked past each tile's count), then every
    tile walks rows [0, big_count) with the bbox test; outside accum mode
    each step takes a run of rows of every tile (chunk_step). Reads the
    longest tile's row count on the host. Modes as `raster_tiles`."""
    tangent = config.enable_vertex_tangents
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

    vis = torch.zeros((N, th, tw), dtype=torch.int32, device=dev)
    chans = torch.zeros((NUM_CHANNELS, N, th, tw), dtype=f32, device=dev)
    peel_z = None
    if init is not None:
        depth = _to_tiles(init[0], config).clone()
        vis = _to_tiles(init[1], config).clone()
        chans = _to_tiles(init[2], config).clone()
    elif peel is not None:
        depth = _to_tiles(peel[0], config).clone()
        peel_z = _to_tiles(peel[1], config)
    else:
        depth = torch.zeros((N, th, tw), dtype=f32, device=dev)
    seed = depth.clone() if accum else None
    zero = torch.zeros((), dtype=f32, device=dev)
    one = torch.ones((), dtype=f32, device=dev)

    def row_step(rows: torch.Tensor, live: torch.Tensor) -> None:
        d = rows[:, :, None, None]                       # (N, 32, 1, 1)
        e0 = plane_eval(d[:, 0], d[:, 1], d[:, 2], px, py)
        e1 = plane_eval(d[:, 3], d[:, 4], d[:, 5], px, py)
        e2 = (1.0 - e0) - e1
        z = plane_eval(d[:, 6], d[:, 7], d[:, 8], px, py)
        tri_id_f = d[:, 9]
        ok = live[:, None, None] & (tri_id_f > 0.5)
        passd = ok & (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (z > depth)
        if peel_z is not None:
            passd = passd & (z < peel_z)
        if accum:
            a8, r8, g8, b8, odr8, odg8, odb8 = unpack_payload(
                d[:, 28], d[:, 30], d[:, 31])
            if peel_z is not None:
                wgt = torch.where(passd, accum_weight(z, seed, peel_z), zero)
            else:
                wgt = torch.where(passd, one, zero)
            for ch, v in enumerate((a8, r8, g8, b8)):
                chans[ch] = accum_add(chans[ch], wgt, v * _INV255)
            for ch, v in enumerate((odr8, odg8, odb8)):
                chans[4 + ch] = chans[4 + ch] + torch.where(
                    passd, v * _FOUR255, zero)
            chans[7] = chans[7] + torch.where(passd, one, zero)
            return
        depth.copy_(torch.where(passd, z, depth))
        vis.copy_(torch.where(passd, tri_id_f.to(torch.int32), vis))
        for ch in range(4):
            val = plane_eval(d[:, 15 + ch * 3], d[:, 16 + ch * 3],
                             d[:, 17 + ch * 3], px, py)
            chans[ch] = torch.where(passd, val, chans[ch])
        chans[4] = torch.where(passd, d[:, 10], chans[4])
        if tangent:
            chans[5] = torch.where(passd, d[:, 27], chans[5])

    def chunk_step(rows: torch.Tensor, live: torch.Tensor) -> None:
        """K walked rows of every tile at once, (N, K, 32) and (N, K):
        the same result as K row_steps. A row wins a pixel where it
        covers it, passes the peel bound and lies strictly in front of
        the depth so far, so of a run of rows the first that reaches the
        run's largest z wins, if that z beats the depth before the run
        (torch.max returns the first index of the largest value)."""
        d = rows[:, :, :, None, None]                  # (N, K, 32, 1, 1)
        pxk, pyk = px[:, None], py[:, None]
        e0 = plane_eval(d[:, :, 0], d[:, :, 1], d[:, :, 2], pxk, pyk)
        e1 = plane_eval(d[:, :, 3], d[:, :, 4], d[:, :, 5], pxk, pyk)
        e2 = (1.0 - e0) - e1
        z = plane_eval(d[:, :, 6], d[:, :, 7], d[:, :, 8], pxk, pyk)
        cov = ((live & (rows[:, :, 9] > 0.5))[:, :, None, None]
               & (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & ~torch.isnan(z))
        if peel_z is not None:
            cov = cov & (z < peel_z[:, None])
        zmax, k = torch.where(cov, z, -torch.inf).max(dim=1)
        passd = zmax > depth
        win = rows[torch.arange(N, device=dev)[:, None, None], k]
        depth.copy_(torch.where(passd, zmax, depth))
        vis.copy_(torch.where(passd, win[..., 9].to(torch.int32), vis))
        for ch in range(4):
            val = plane_eval(win[..., 15 + ch * 3], win[..., 16 + ch * 3],
                             win[..., 17 + ch * 3], px, py)
            chans[ch] = torch.where(passd, val, chans[ch])
        chans[4] = torch.where(passd, win[..., 10], chans[4])
        if tangent:
            chans[5] = torch.where(passd, win[..., 27], chans[5])

    if n_rows and accum:
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
    elif n_rows:
        # Sums need walk order; a maximum does not: the other modes walk
        # K rows of every tile a step, K bounded by the step's pixels.
        K = max(1, min(_CHUNK_ROWS, _CHUNK_VALUES // max(N * th * tw, 1)))
        offs = tile_offsets.long().clamp(max=n_rows)
        starts, counts = offs[:-1], offs[1:] - offs[:-1]
        ks = torch.arange(K, device=dev)
        for s in range(0, int(counts.max()) if N else 0, K):
            idx = torch.clamp(starts[:, None] + s + ks, max=n_rows - 1)
            chunk_step(pair_data[idx], (s + ks)[None] < counts[:, None])
        nb = min(big_count, n_rows)
        for j in range(0, nb, K):
            rows = pair_data[j:min(j + K, nb)]
            hit = ((txf[:, None] >= rows[:, 11]) & (txf[:, None] <= rows[:, 12])
                   & (tyf[:, None] >= rows[:, 13])
                   & (tyf[:, None] <= rows[:, 14]))
            chunk_step(rows.expand(N, *rows.shape), hit)

    return (_to_image(depth, config), _to_image(vis, config),
            _to_image(chans, config))


def raster_tiles_plain(pairs: BinnedPairs, config: FrameConfig,
                       tile_row0: int = 0, init: Init = None,
                       peel: Peel = None, accum: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1, starting from `init` when seeded.
    Reads the big count on the host."""
    return _plain_walk(pairs.pair_data, pairs.tile_offsets,
                       int(pairs.big_count), config, tile_row0, init, peel,
                       accum)


def expand_group_pairs(pairs: GroupBinnedPairs, config: FrameConfig,
                       tile_row0: int = 0, boxed: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (row, tile) pairs K2 evaluates, in its order: per tile, the rows
    of its (group, tile) pairs in pair order, then the rows of every
    big-group entry whose group box covers the tile, in list order; rows
    whose float bbox (lanes 11-14) misses the tile are dropped, as the
    kernel skips them. With `boxed` False neither test is made: every
    tile takes every row of the live big entries, the walk of the JAX
    package's reference (raster_ref._group_walk). Returns (pair_data
    (R, SETUP_LANES), tile_offsets (num_tiles + 1,) i32) for K1's walk."""
    GR = config.group_rows
    N = config.num_tiles
    lanes = pairs.lanes
    dev = lanes.device
    i64 = torch.int64
    offs = pairs.tile_offsets.long()
    Pc = pairs.group_ids.shape[0]
    Bg = pairs.big_ids.shape[0]
    j = torch.arange(GR, dtype=i64, device=dev)

    # Own pairs: tile of pair p is the t with offs[t] <= p < offs[t+1]
    # (a shard's offsets slice starts past pair 0: tile_row0 > 0).
    p = torch.arange(Pc, dtype=i64, device=dev)
    tile_own = torch.searchsorted(offs[1:], p, right=True)
    live_own = ((p >= offs[0]) & (p < offs[N]))[:, None].expand(Pc, GR)
    rows_own = pairs.group_ids.long()[:, None] * GR + j
    tile_own = tile_own[:, None].expand(Pc, GR)
    seq_own = p[:, None] * GR + j

    # Big list: every tile x every live entry, box-tested.
    t = torch.arange(N, dtype=i64, device=dev)[:, None]
    tx, tyg = t % config.tiles_x, t // config.tiles_x + tile_row0
    bx, by = pairs.big_bx.long()[None], pairs.big_by.long()[None]
    pb = torch.arange(Bg, dtype=i64, device=dev)[None]
    hit = pb < pairs.big_count.long()
    if boxed:
        hit = hit & ((tx >= bx // 2048) & (tx <= bx % 2048)
                     & (tyg >= by // 2048) & (tyg <= by % 2048))
    live_big = hit[:, :, None].expand(N, Bg, GR)
    rows_big = (pairs.big_ids.long()[None, :, None] * GR + j).expand(N, Bg, GR)
    tile_big = t[:, :, None].expand(N, Bg, GR)
    seq_big = Pc * GR + (pb[:, :, None] * GR + j).expand(N, Bg, GR)

    rows = torch.cat([rows_own.reshape(-1), rows_big.reshape(-1)])
    tile = torch.cat([tile_own.reshape(-1), tile_big.reshape(-1)])
    seq = torch.cat([seq_own.reshape(-1), seq_big.reshape(-1)])
    live = torch.cat([live_own.reshape(-1), live_big.reshape(-1)])
    rows, tile, seq = rows[live], tile[live], seq[live]
    if boxed:
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
                        tile_row0: int = 0, init: Init = None,
                        peel: Peel = None, accum: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2: K1's walk over the expanded
    (row, tile) pairs, starting from `init` when seeded."""
    pair_data, offs = expand_group_pairs(pairs, config, tile_row0)
    return _plain_walk(pair_data, offs, 0, config, tile_row0, init, peel,
                       accum)


_fns = {}
_MODE_CODE = {"plain": 0, "seeded": 0, "peel": 1, "accum": 2}
# Each kernel's modes as MODE_LAUNCHES names them; "+tangent" marks the
# tangent instance of a mode (accum mode has none).
MODES = ("plain", "seeded", "peel", "accum", "plain+tangent",
         "seeded+tangent", "peel+tangent")


class ModeLaunches:
    """The launch count of one mode of a raster kernel (`launches`). The
    wrappers' own `launches` count every mode; `MODE_LAUNCHES[(kernel,
    mode)]` counts one: kernel "K1" or "K2", mode one of MODES."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


MODE_LAUNCHES = {(k, m): ModeLaunches(f"{k}-{m}")
                 for k in ("K1", "K2") for m in MODES}


def _mode(init, peel, accum: bool, tangent: bool = False) -> str:
    if accum:
        return "accum"
    if peel is not None:
        base = "peel"
    else:
        base = "plain" if init is None else "seeded"
    return base + "+tangent" if tangent else base


def span_queue(tile_offsets: torch.Tensor, cap: int,
               big_count: torch.Tensor, big_cap: int,
               span: int) -> torch.Tensor:
    """The work queue of the kernels' split design (plain version of
    csrc/raster.cu::span_queue_kernel, which each split-design call runs
    first): (tiles + 2,) i32, [0] the item counter (zero), then the
    exclusive scan of each tile's spans, the last entry their total. Tile
    t's walk is its own range [offs[t], offs[t+1]) clamped to `cap` (rows
    for K1, (group, tile) pairs for K2), then the big list's
    min(big_count, big_cap) rows or entries; it is cut into
    ceil(walk / span) spans. Computed on the device of its inputs with no
    host read."""
    offs = tile_offsets.clamp(max=cap)
    walk = (offs[1:] - offs[:-1]).clamp_(min=0)
    walk += big_count.reshape(1).clamp(0, big_cap)
    spans = torch.div(walk + (span - 1), span, rounding_mode="floor")
    queue = torch.zeros(tile_offsets.shape[0] + 1, dtype=torch.int32,
                        device=tile_offsets.device)
    torch.cumsum(spans, 0, dtype=torch.int32, out=queue[2:])
    return queue


def span_queue_cuda(tile_offsets: torch.Tensor, cap: int,
                    big_count: torch.Tensor, big_cap: int,
                    span: int) -> torch.Tensor:
    """`span_queue` by the raster library's one-block kernel (the first
    launch of every split-design call), on the current stream."""
    dev = tile_offsets.device
    if dev.type != "cuda":
        raise ValueError(f"span_queue_cuda needs CUDA tensors, got {dev}")
    for name, x in (("tile_offsets", tile_offsets), ("big_count", big_count)):
        if x.dtype != torch.int32 or x.device != dev or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous i32 on {dev}")
    queue = torch.empty(tile_offsets.shape[0] + 1, dtype=torch.int32,
                        device=dev)
    with torch.cuda.device(dev):
        err = _kernel_fn("br_span_queue")(
            tile_offsets.data_ptr(), cap, big_count.data_ptr(), big_cap, span,
            tile_offsets.shape[0] - 1, queue.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"span queue kernel launch failed: CUDA error {err}")
    return queue


def _kernel_fn(name: str):
    """An entry point of the built library with its ctypes signature."""
    if name not in _fns:
        fn = getattr(cuda_build.load(SOURCE).lib, name)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "br_raster_tiles":
            fn.argtypes = [p, p, p, ll, p, p, p, p, i, i, p, i, p, p, p, p,
                           i, i, i, i, i, p]
        elif name == "br_raster_groups":
            fn.argtypes = [p, p, p, p, p, p, p, ll, i, i, i, p, p, p, p, i,
                           i, p, i, p, p, p, p, i, i, i, i, i, p]
        elif name == "br_span_queue":
            fn.argtypes = [p, ll, p, ll, i, i, p, p]
        else:
            fn.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def build_kernel() -> cuda_build.CudaLibrary:
    """Build (if needed) and load the raster library; returns it."""
    return cuda_build.load(SOURCE)


def blocks_per_sm(kernel: str, mode: str, config: FrameConfig
                  ) -> Tuple[int, int]:
    """(resident blocks an SM, pixels a thread) of the instance that a
    raster of `kernel` ("K1" or "K2") in `mode` (one of MODES) launches on
    `config`'s tile grid: pass 1 of the split design, or accum mode's walk."""
    ppt = ctypes.c_int(0)
    n = _kernel_fn("br_raster_blocks_per_sm")(
        int(kernel == "K2"), _MODE_CODE[mode.split("+")[0]],
        config.tile_h * config.tile_w, config.num_tiles, ctypes.byref(ppt))
    return n, ppt.value


def _check_tensors(dev, named):
    for name, x in named:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _split_scratch(dev, config: FrameConfig):
    """(work queue, key plane) scratch of a launch, which the split design
    fills and accum mode ignores."""
    queue = torch.empty(config.num_tiles + 2, dtype=torch.int32, device=dev)
    keys = torch.empty((config.padded_height, config.padded_width),
                       dtype=torch.int64, device=dev)
    return queue, keys


def _check_peel(dev, peel: Peel, config: FrameConfig) -> Tuple[int, int]:
    """(seed depth, peel bound) pointers of a peel band (0, 0 without)."""
    if peel is None:
        return 0, 0
    shape = (config.padded_height, config.padded_width)
    for name, x in zip(("peel seed", "peel bound"), peel):
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape} f32, got "
                             f"{tuple(x.shape)} {x.dtype}")
    _check_tensors(dev, zip(("peel seed", "peel bound"), peel))
    return peel[0].data_ptr(), peel[1].data_ptr()


def _check_init(dev, init: Init, config: FrameConfig) -> Tuple[int, int, int]:
    """(depth, vis, channels) pointers of a seed (0, 0, 0 without)."""
    if init is None:
        return 0, 0, 0
    Hp, Wp = config.padded_height, config.padded_width
    d0, v0, c0 = init
    if (d0.shape != (Hp, Wp) or v0.shape != (Hp, Wp)
            or c0.shape != (NUM_CHANNELS, Hp, Wp)
            or d0.dtype != torch.float32 or v0.dtype != torch.int32
            or c0.dtype != torch.float32):
        raise ValueError("init must be (depth f32, vis i32, channels "
                         f"f32) on the padded grid {Hp}x{Wp}")
    _check_tensors(dev, (("init depth", d0), ("init vis", v0),
                         ("init channels", c0)))
    return d0.data_ptr(), v0.data_ptr(), c0.data_ptr()


def _seed_pointers(dev, config: FrameConfig, init: Init, peel: Peel):
    """(depth0, vis0, chan0, bound) pointers of the kernels' C interface:
    a seed's three buffers, or a peel band's seed depth and bound."""
    seed = _check_init(dev, init, config)
    seed_p, peel_p = _check_peel(dev, peel, config)
    if peel is not None:
        seed = (seed_p, 0, 0)
    return seed + (peel_p,)


def raster_tiles_cuda(pairs: BinnedPairs, config: FrameConfig,
                      tile_row0: int = 0, init: Init = None,
                      peel: Peel = None, accum: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K1 on the current stream (no synchronisation), seeded from
    `init` when given, else in the mode of `peel` / `accum`, with the
    tangent channel under config.enable_vertex_tangents (as
    `raster_tiles`). The plain, seeded and peel modes launch four kernels
    (work queue, key plane start, pass 1, resolve), accum mode one (a
    block per 256-pixel slice of a tile, plus a producer warp).
    `raster_tiles_cuda.launches` counts the calls of every mode,
    MODE_LAUNCHES each mode's."""
    pd, offs, big = pairs.pair_data, pairs.tile_offsets, pairs.big_count
    dev = pd.device
    if dev.type != "cuda":
        raise ValueError(f"raster_tiles_cuda needs CUDA tensors, got {dev}")
    _check_modes(init, peel, accum)
    if pd.dtype != torch.float32 or pd.dim() != 2 or pd.shape[1] != SETUP_LANES:
        raise ValueError(f"pair_data must be (R, {SETUP_LANES}) f32, got "
                         f"{tuple(pd.shape)} {pd.dtype}")
    if pd.data_ptr() % 16:
        raise ValueError("pair_data must be 16-byte aligned")
    if offs.dtype != torch.int32 or offs.shape != (config.num_tiles + 1,):
        raise ValueError(f"tile_offsets must be ({config.num_tiles + 1},) "
                         f"i32, got {tuple(offs.shape)} {offs.dtype}")
    if big.dtype != torch.int32 or big.numel() != 1:
        raise ValueError(f"big_count must be one i32, got {big.dtype}")
    _check_tensors(dev, (("pair_data", pd), ("tile_offsets", offs),
                         ("big_count", big)))
    ptrs = _seed_pointers(dev, config, init, peel)
    tangent = config.enable_vertex_tangents
    mode = _mode(init, peel, accum)
    Hp, Wp = config.padded_height, config.padded_width
    depth = torch.empty((Hp, Wp), dtype=torch.float32, device=dev)
    vis = torch.empty((Hp, Wp), dtype=torch.int32, device=dev)
    channels = torch.empty((NUM_CHANNELS, Hp, Wp), dtype=torch.float32,
                           device=dev)
    fn = _kernel_fn("br_raster_tiles")
    with torch.cuda.device(dev):
        queue, keys = _split_scratch(dev, config)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(offs.data_ptr(), big.data_ptr(), pd.data_ptr(), pd.shape[0],
                 *ptrs, _MODE_CODE[mode], int(tangent), queue.data_ptr(),
                 SPAN_ROWS, keys.data_ptr(), depth.data_ptr(),
                 vis.data_ptr(), channels.data_ptr(), config.tiles_x,
                 config.tiles_y, config.tile_h, config.tile_w, int(tile_row0),
                 stream)
    if err != 0:
        raise RuntimeError(f"raster kernel launch failed: CUDA error {err}")
    raster_tiles_cuda.launches += 1
    MODE_LAUNCHES[("K1", _mode(init, peel, accum, tangent))].launches += 1
    return depth, vis, channels


raster_tiles_cuda.launches = 0


def raster_groups_cuda(pairs: GroupBinnedPairs, config: FrameConfig,
                       tile_row0: int = 0, init: Init = None,
                       peel: Peel = None, accum: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K2 on the current stream (no synchronisation), seeded from
    `init` when given, else in the mode of `peel` / `accum`, with the
    tangent channel under config.enable_vertex_tangents (as
    `raster_tiles`); its launches as `raster_tiles_cuda`'s (accum mode:
    one kernel, a block per 256-pixel slice of a tile).
    `raster_groups_cuda.launches` counts the calls of every mode,
    MODE_LAUNCHES each mode's."""
    lanes = pairs.lanes
    dev = lanes.device
    if dev.type != "cuda":
        raise ValueError(f"raster_groups_cuda needs CUDA tensors, got {dev}")
    _check_modes(init, peel, accum)
    GR = config.group_rows
    if GR not in (8, 16, 32):
        raise ValueError(f"group_rows must be 8, 16 or 32, got {GR}")
    if (lanes.dtype != torch.float32 or lanes.dim() != 2
            or lanes.shape[1] != SETUP_LANES or lanes.shape[0] % GR):
        raise ValueError(f"lanes must be (NG*{GR}, {SETUP_LANES}) f32, got "
                         f"{tuple(lanes.shape)} {lanes.dtype}")
    if lanes.data_ptr() % 16:
        raise ValueError("lanes must be 16-byte aligned")
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
    ptrs = _seed_pointers(dev, config, init, peel)
    tangent = config.enable_vertex_tangents
    mode = _mode(init, peel, accum)
    depth = torch.empty((Hp, Wp), dtype=torch.float32, device=dev)
    vis = torch.empty((Hp, Wp), dtype=torch.int32, device=dev)
    channels = torch.empty((NUM_CHANNELS, Hp, Wp), dtype=torch.float32,
                           device=dev)
    fn = _kernel_fn("br_raster_groups")
    with torch.cuda.device(dev):
        queue, keys = _split_scratch(dev, config)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pairs.tile_offsets.data_ptr(), pairs.group_ids.data_ptr(),
                 pairs.big_ids.data_ptr(), pairs.big_count.data_ptr(),
                 pairs.big_bx.data_ptr(), pairs.big_by.data_ptr(),
                 lanes.data_ptr(), lanes.shape[0] // GR, GR,
                 pairs.group_ids.shape[0], nbig, *ptrs,
                 _MODE_CODE[mode], int(tangent), queue.data_ptr(),
                 SPAN_ROWS // GR, keys.data_ptr(), depth.data_ptr(),
                 vis.data_ptr(), channels.data_ptr(), config.tiles_x,
                 config.tiles_y, config.tile_h, config.tile_w, int(tile_row0),
                 stream)
    if err != 0:
        raise RuntimeError(f"group raster kernel launch failed: CUDA error {err}")
    raster_groups_cuda.launches += 1
    MODE_LAUNCHES[("K2", _mode(init, peel, accum, tangent))].launches += 1
    return depth, vis, channels


raster_groups_cuda.launches = 0
