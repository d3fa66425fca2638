"""Roofline arithmetic of the raster kernels K1 and K2: the least time the
card could take for the work a launch is handed, at the published peaks
of one H100 SXM (NVIDIA's data sheet: 67 TFLOP/s in f32 outside the
tensor cores, 3.35 TB/s of HBM3), as the larger of operations over the
f32 peak and bytes over the memory peak.

Copied from chip_smoke.py (`bound`, `k1_walked`, `k1_bound`, `k2_bound`,
`map_bound`); `k2_walked` counts the (row, tile) pairs of the port's
`ops/raster.expand_group_pairs` without building them. The counts read the
pairs and tile ranges the binning hands each launch, so they are the same
whatever implements the kernel. Plain torch; any device.
"""

from __future__ import annotations

import torch

PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# f32 operations of one (row, pixel) raster test, counted from the kernel's
# source: three planes at 4 each, e2 2.
RASTER_FLOPS_PER_ROW_PIXEL = 14
ROW_BYTES = 128          # one setup row (SETUP_LANES f32 lanes), read once
PIXEL_BYTES = 40         # depth, vis and 8 channels written a pixel
DEPTH_BYTES = 4          # a depth-only map keeps its depth plane alone


def bound(flops: float, nbytes: float):
    """(bound ms, "operations" | "bytes") at the card's published peaks."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def k1_walked(pairs, cfg, row0: int = 0) -> int:
    """(row, tile) pairs K1 walks: each tile's binned rows, plus each big
    row on every tile its bbox (lanes 11-14) covers; the tile rows are
    row0 .. row0 + cfg.tiles_y - 1."""
    offs = pairs.tile_offsets.long()
    own = int((offs[1:] - offs[:-1]).sum())
    big = pairs.pair_data[:int(pairs.big_count)]
    nx = (torch.clamp(big[:, 12], max=cfg.tiles_x - 1)
          - torch.clamp(big[:, 11], min=0) + 1).clamp(min=0)
    ny = (torch.clamp(big[:, 14], max=row0 + cfg.tiles_y - 1)
          - torch.clamp(big[:, 13], min=row0) + 1).clamp(min=0)
    return own + int((nx * ny).sum())


def k2_walked(pairs, cfg, row0: int = 0) -> int:
    """(row, tile) pairs K2 walks: per tile, the rows of its (group, tile)
    pairs, then the rows of every live big-group entry whose group box
    covers the tile; a row whose float bbox (lanes 11-14) misses the tile
    is skipped."""
    GR = cfg.group_rows
    N = cfg.num_tiles
    lanes = pairs.lanes
    dev = lanes.device
    i64 = torch.int64
    offs = pairs.tile_offsets.long()
    Pc = pairs.group_ids.shape[0]
    Bg = pairs.big_ids.shape[0]
    j = torch.arange(GR, dtype=i64, device=dev)

    def kept(rows, tile):
        box = lanes[rows, 11:15]
        txf = (tile % cfg.tiles_x).to(torch.float32)
        tyf = (tile // cfg.tiles_x + row0).to(torch.float32)
        return int(((txf >= box[:, 0]) & (txf <= box[:, 1])
                    & (tyf >= box[:, 2]) & (tyf <= box[:, 3])).sum())

    p = torch.arange(Pc, dtype=i64, device=dev)
    live = (p >= offs[0]) & (p < offs[N])
    tile_own = torch.searchsorted(offs[1:], p, right=True)[live]
    rows_own = (pairs.group_ids.long()[live][:, None] * GR + j).reshape(-1)
    walked = kept(rows_own, tile_own[:, None].expand(-1, GR).reshape(-1))

    t = torch.arange(N, dtype=i64, device=dev)[:, None]
    tx, tyg = t % cfg.tiles_x, t // cfg.tiles_x + row0
    bx, by = pairs.big_bx.long()[None], pairs.big_by.long()[None]
    pb = torch.arange(Bg, dtype=i64, device=dev)[None]
    hit = ((pb < pairs.big_count.long())
           & (tx >= bx // 2048) & (tx <= bx % 2048)
           & (tyg >= by // 2048) & (tyg <= by % 2048))
    ti, bi = torch.nonzero(hit, as_tuple=True)
    rows_big = (pairs.big_ids.long()[bi][:, None] * GR + j).reshape(-1)
    return walked + kept(rows_big, ti[:, None].expand(-1, GR).reshape(-1))


def _raster_bound(walked: int, cfg, pixel_bytes: int, seeded: bool):
    return bound(walked * cfg.tile_h * cfg.tile_w * RASTER_FLOPS_PER_ROW_PIXEL,
                 walked * ROW_BYTES + cfg.padded_height * cfg.padded_width
                 * pixel_bytes * (2 if seeded else 1))


def k1_bound(pairs, cfg, row0: int = 0, init=None):
    """(bound ms, by, rows walked) of one K1 launch: each walked row tested
    on its tile's pixels and read once, depth, vis and 8 channels written
    (and read once more when seeded)."""
    walked = k1_walked(pairs, cfg, row0)
    return (*_raster_bound(walked, cfg, PIXEL_BYTES, init is not None),
            walked)


def k2_bound(pairs, cfg, row0: int = 0, init=None):
    """(bound ms, by, rows walked) of one K2 launch, counted as k1_bound."""
    walked = k2_walked(pairs, cfg, row0)
    return (*_raster_bound(walked, cfg, PIXEL_BYTES, init is not None),
            walked)


def map_bound(walked: int, cfg):
    """(bound ms, by) of one depth-only shadow-map launch walking `walked`
    (row, tile) pairs: each walked row tested and read once, and the depth
    plane written. A map (a VSM page, a cascade) keeps only the depth."""
    return _raster_bound(walked, cfg, DEPTH_BYTES, False)


def owned_device_s(events, own, shared, others, calls):
    """Device seconds of one kernel's launches in a trace: the events
    whose names contain one of `own`, plus the `shared` launches (a work
    queue, a key plane's start) that precede one of them on the stream
    before any event of `others`. `events` are (name, start_us, end_us)
    device events. Returns (seconds, the events whose names contain one
    of `calls`: one a call)."""
    total, count, pending = 0.0, 0, 0.0
    for name, t0, t1 in sorted(events, key=lambda e: e[1]):
        dur = (t1 - t0) * 1e-6
        if any(k in name for k in own):
            total += dur + pending
            count += any(k in name for k in calls)
            pending = 0.0
        elif any(k in name for k in others):
            pending = 0.0
        elif any(k in name for k in shared):
            pending += dur
    return total, count
