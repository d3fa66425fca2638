"""K1 (the soup path's tile raster, csrc/raster.cu) against its roofline:
the k1_bound of every launch of the profiled frames (roofline.py; a
depth-only map at another size by map_bound), summed, over K1's device
time in the trace. Launches captured at the port's K1 entry; nothing is
read where a launch ran a mode the bound does not count (peel, accum)."""

from portbench import roofline

MOVES = "frame_ms"
CAPTURE = "ops.raster.raster_tiles_cuda"
OWN = ("span_tiles_kernel", "resolve_tiles_kernel", "accum_rows_kernel")
SHARED = ("span_queue_kernel", "init_keys_kernel")
OTHERS = ("span_groups_kernel", "resolve_groups_kernel", "accum_groups_kernel")
CALLS = ("span_tiles_kernel", "accum_rows_kernel")


def _arg(args, kwargs, i, name, default=None):
    return args[i] if len(args) > i else kwargs.get(name, default)


def bound_ms(args, kwargs, rec):
    pairs, cfg = args[0], args[1]
    row0 = _arg(args, kwargs, 2, "tile_row0", 0)
    init = _arg(args, kwargs, 3, "init")
    if _arg(args, kwargs, 4, "peel") is not None or \
            _arg(args, kwargs, 5, "accum", False):
        return None
    if (cfg.width, cfg.height) == tuple(rec["resolution"]):
        return roofline.k1_bound(pairs, cfg, row0, init)[0]
    return roofline.map_bound(roofline.k1_walked(pairs, cfg, row0), cfg)[0]


def read(rec):
    tr = rec.get("trace")
    bounds = (rec.get("captures") or {}).get("k1_roofline_pct")
    if not tr or not bounds or any(b is None for b in bounds):
        return None
    dev_s, calls = roofline.owned_device_s(tr["events"], OWN, SHARED, OTHERS,
                                           CALLS)
    if not calls or dev_s <= 0:
        return None
    # A trace that lost some launches' events: their time taken as the
    # mean of the launches it kept.
    return 100.0 * sum(bounds) * 1e-3 / (dev_s * len(bounds) / calls)
