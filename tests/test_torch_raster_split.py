"""The split schedule of the CUDA raster kernels (csrc/raster.cu), emulated
in plain PyTorch on the CPU and held to the plain versions of K1 and K2.

On the card the plain, seeded and peel modes cut each tile's walk into
spans, let any block take any span, keep per pixel the span's running best
z and its row's walk-order index, merge the spans with a 64-bit key max
(the depth's order-preserving bits above the inverted walk order) and
resolve the winner's row in a second pass. `split_raster` below does the
same with spans of a few rows (or one group), so that spans cut through
every tile, and must equal `raster_tiles_plain` / `raster_groups_plain`
(the sequential walk) bit for bit: depth, vis and all 8 channels, in the
plain, seeded and peel modes, each with and without the tangent channel.
Its spans must equal the work queue that every split-design call computes
on the device, by its plain version (`ops/raster.py::span_queue`) here on
the CPU. One case each holds the schedule to the JAX package's Pallas
kernels in interpret mode.

The CUDA kernels themselves run only on a card: their tie case and the
work-queue kernel against `span_queue` are marked `cuda` and skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
from basicrenderer_tpu.ops import raster_setup as jrs
from basicrenderer_tpu.ops.raster_pallas import raster_tiles_pallas
from basicrenderer_tpu_torch.graph.framedata import FrameConfig as PConfig
from basicrenderer_tpu_torch.ops import raster as praster
from basicrenderer_tpu_torch.ops import raster_setup as prs

from tests.test_raster import random_clip_triangles
from tests.test_torch_raster import peel_band, with_payload

KW = dict(width=128, height=128, tile_h=16, tile_w=128, max_pairs=1 << 13,
          max_group_pairs=1 << 11, group_rows=8, near_clip_tris=0)
SPAN_ROWS = 4      # K1 rows a span: spans cut through every busy tile
SPAN_GROUPS = 1    # K2 walk entries a span
MODES = ("plain", "seeded", "peel", "plain+tangent", "seeded+tangent",
         "peel+tangent")
NONE = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# The schedule, emulated
# ---------------------------------------------------------------------------

def _walks(pairs, cfg, tile_row0=0):
    """Each tile's walk in the kernels' order: (table, rows (L,) i64 into
    the table, ok (L,) bool: the row is walked (K2: its big entry's box
    covers the tile), boxed (L,) bool: the row's float bbox is tested,
    rows a walk entry). K1: own rows then big rows (those boxed); K2: the
    group_rows rows of each own pair, then of each big entry, every row
    boxed, groups clamped to the lane table."""
    N = cfg.num_tiles
    walks = []
    if isinstance(pairs, prs.GroupBinnedPairs):
        GR = cfg.group_rows
        table = pairs.lanes
        ng = table.shape[0] // GR
        cap, bcap = pairs.group_ids.shape[0], pairs.big_ids.shape[0]
        offs = pairs.tile_offsets.long().clamp(max=cap)
        nbig = int(pairs.big_count.clamp(0, bcap))
        bx, by = pairs.big_bx[:nbig].long(), pairs.big_by[:nbig].long()
        for t in range(N):
            tx, tyg = t % cfg.tiles_x, t // cfg.tiles_x + tile_row0
            s, e = int(offs[t]), max(int(offs[t + 1]), int(offs[t]))
            groups = torch.cat([pairs.group_ids[s:e].long(),
                                pairs.big_ids[:nbig].long()]).clamp(0, ng - 1)
            covers = ((tx >= bx // 2048) & (tx <= bx % 2048)
                      & (tyg >= by // 2048) & (tyg <= by % 2048))
            ok = torch.cat([torch.ones(e - s, dtype=torch.bool), covers])
            rows = (groups[:, None] * GR + torch.arange(GR)).reshape(-1)
            walks.append((rows, ok.repeat_interleave(GR),
                          torch.ones_like(rows, dtype=torch.bool)))
        return table, walks, GR
    table = pairs.pair_data
    n_rows = table.shape[0]
    offs = pairs.tile_offsets.long().clamp(max=n_rows)
    nbig = int(pairs.big_count.clamp(0, n_rows))
    for t in range(N):
        s, e = int(offs[t]), max(int(offs[t + 1]), int(offs[t]))
        rows = torch.cat([torch.arange(s, e), torch.arange(nbig)])
        boxed = torch.cat([torch.zeros(e - s, dtype=torch.bool),
                           torch.ones(nbig, dtype=torch.bool)])
        walks.append((rows, torch.ones_like(boxed), boxed))
    return table, walks, 1


def zmap(z: torch.Tensor) -> torch.Tensor:
    """The kernels' order-preserving map of a float's bits (-0 as +0), in
    its signed form: ordered as the floats, in [-2^31, 2^31)."""
    b = (z + 0.0).view(torch.int32).long()
    return torch.where(b >= 0, b, -(b & 0x7FFFFFFF) - 1)


def split_raster(pairs, cfg, span, init=None, peel=None, tile_row0=0):
    """K1 / K2 by the split schedule: spans of `span` walk entries, a
    running best per (span, pixel) from the tile's start depth (strict
    test: the first of equal z wins inside a span), keys zmap(z) << 32 |
    (0xFFFFFFFE - order) merged by max over a sentinel zmap(start) << 32 |
    0xFFFFFFFF, then the resolve of each pixel's winning order. Returns
    ((depth, vis, channels), spans per tile)."""
    tangent = cfg.enable_vertex_tangents
    th, tw, N = cfg.tile_h, cfg.tile_w, cfg.num_tiles
    table, walks, per_entry = _walks(pairs, cfg, tile_row0)
    R = span * per_entry                       # rows a span
    f32 = torch.float32
    if init is not None:
        start_d, start_v, start_ch = (praster._to_tiles(x, cfg) for x in init)
    else:
        start_d = (praster._to_tiles(peel[0], cfg) if peel is not None
                   else torch.zeros((N, th, tw), dtype=f32))
        start_v = torch.zeros((N, th, tw), dtype=torch.int32)
        start_ch = torch.zeros((8, N, th, tw), dtype=f32)
    bound = praster._to_tiles(peel[1], cfg) if peel is not None else None
    t_all = torch.arange(N)
    px_t = (torch.arange(tw, dtype=f32)[None, None, :]
            + (t_all % cfg.tiles_x * tw).to(f32)[:, None, None] + 0.5)
    py_t = (torch.arange(th, dtype=f32)[None, :, None]
            + ((t_all // cfg.tiles_x + tile_row0) * th).to(f32)[:, None, None]
            + 0.5)

    # Work items: (tile, span); each span's rows padded to R.
    n_spans = [-(-rows.shape[0] // R) for rows, _, _ in walks]
    items = [(t, s) for t in range(N) for s in range(n_spans[t])]
    keys = (zmap(start_d) << 32) | NONE
    if items:
        it = torch.tensor([t for t, _ in items])
        I = len(items)
        rows = torch.zeros((I, R), dtype=torch.long)
        walked = torch.zeros((I, R), dtype=torch.bool)
        boxed = torch.zeros((I, R), dtype=torch.bool)
        for i, (t, s) in enumerate(items):
            r, ok, bx = (x[s * R:(s + 1) * R] for x in walks[t])
            rows[i, :r.shape[0]], walked[i, :r.shape[0]] = r, ok
            boxed[i, :r.shape[0]] = bx
        order = torch.tensor([s * R for _, s in items])[:, None] + torch.arange(R)
        best_z = start_d[it].clone()
        best_o = torch.full((I, th, tw), -1, dtype=torch.long)
        px, py = px_t[it], py_t[it]
        txf = (it % cfg.tiles_x).to(f32)
        tyf = (it // cfg.tiles_x + tile_row0).to(f32)
        for j in range(R):
            r = table[rows[:, j]]
            d = r[:, :, None, None]
            covers = ((txf >= r[:, 11]) & (txf <= r[:, 12])
                      & (tyf >= r[:, 13]) & (tyf <= r[:, 14]))
            live = walked[:, j] & (r[:, 9] > 0.5) & (~boxed[:, j] | covers)
            e0 = praster.plane_eval(d[:, 0], d[:, 1], d[:, 2], px, py)
            e1 = praster.plane_eval(d[:, 3], d[:, 4], d[:, 5], px, py)
            e2 = (1.0 - e0) - e1
            z = praster.plane_eval(d[:, 6], d[:, 7], d[:, 8], px, py)
            ok = (live[:, None, None] & (e0 >= 0) & (e1 >= 0) & (e2 >= 0)
                  & (z > best_z))
            if bound is not None:
                ok = ok & (z < bound[it])
            best_z = torch.where(ok, z, best_z)
            best_o = torch.where(ok, order[:, j, None, None], best_o)
        item_keys = torch.where(best_o >= 0,
                                (zmap(best_z) << 32) | (NONE - 1 - best_o),
                                torch.iinfo(torch.int64).min)
        keys = keys.reshape(N, -1).scatter_reduce(
            0, it[:, None].expand(I, th * tw), item_keys.reshape(I, -1),
            reduce="amax").reshape(N, th, tw)

    # Resolve.
    low = keys & NONE
    won = low != NONE
    order = torch.where(won, NONE - 1 - low, 0)
    lmax = max([1] + [w[0].shape[0] for w in walks])
    walk_rows = torch.zeros((N, lmax), dtype=torch.long)
    for t, (r, _, _) in enumerate(walks):
        walk_rows[t, :r.shape[0]] = r
    row = table[walk_rows[t_all[:, None, None], order]]      # (N, th, tw, 32)
    lane = row.permute(3, 0, 1, 2)
    z = praster.plane_eval(lane[6], lane[7], lane[8], px_t, py_t)
    depth = torch.where(won, z, start_d)
    vis = torch.where(won, lane[9].to(torch.int32), start_v)
    chans = start_ch.clone()
    for c in range(4):
        chans[c] = torch.where(won, praster.plane_eval(
            lane[15 + 3 * c], lane[16 + 3 * c], lane[17 + 3 * c], px_t, py_t),
            chans[c])
    chans[4] = torch.where(won, lane[10], chans[4])
    if tangent:
        chans[5] = torch.where(won, lane[27], chans[5])
    out = tuple(praster._to_image(x, cfg) for x in (depth, vis, chans))
    return out, n_spans


# ---------------------------------------------------------------------------
# Scenes
# ---------------------------------------------------------------------------

def _setup(rng, n, cfg):
    """n random clip-space triangles set up by the port, with payload bytes
    and a random tangent angle on every live row."""
    clip = torch.as_tensor(random_clip_triangles(rng, n).reshape(-1, 4))
    idx = torch.arange(3 * n, dtype=torch.int32).view(n, 3)
    lanes, bbox, valid, _ = prs.triangle_setup_packed(
        clip, idx, torch.ones(n, dtype=torch.bool), cfg, None, None)
    rows = with_payload(rng, lanes.numpy())
    rows[:, 27] = np.where(rows[:, 9] > 0.5,
                           rng.uniform(-np.pi, 5 * np.pi, rows.shape[0]), 0)
    return rows, bbox, valid


def _ties(rng, rows, bbox, valid):
    """Each triangle three times, shuffled: itself, a coplanar twin (the
    same edge and depth planes and bbox, another id, attribute planes,
    combo and tangent) and a duplicate (the same id and planes, another
    tangent angle), so that equal-z rows of different ids and of one id lie
    in different spans of a tile's walk."""
    n = rows.shape[0]
    twin, dup = rows.copy(), rows.copy()
    live = rows[:, 9] > 0.5
    twin[:, 9] = np.where(live, rows[:, 9] + n, 0)
    twin[:, 10] = np.where(live, rows[:, 10] + 7, 0)
    twin[:, 15:27] = rng.normal(size=(n, 12)).astype(np.float32)
    twin[:, 27] = np.where(live, rng.uniform(-np.pi, np.pi, n), 0)
    dup[:, 27] = np.where(live, rng.uniform(-np.pi, np.pi, n), 0)
    perm = rng.permutation(3 * n)
    return (np.concatenate([rows, twin, dup])[perm],
            torch.cat([bbox] * 3)[perm], torch.cat([valid] * 3)[perm])


SCENES = {
    # name: (seed, triangles, extra config, tie rows)
    "random": (0, 256, {}, False),
    "ties": (1, 96, {}, True),
    "big_list": (2, 80, dict(max_tiles_per_tri=2, max_tiles_per_group=1),
                 False),
    "empty": (3, 64, {}, False),
}
# The card's tie case: busy tiles walk more than three of the kernels'
# 256-row spans.
CARD_TIES = (4, 480, {}, True)


def _case(kernel, scene, mode):
    """(pairs, config, raster keywords) of a scene in a mode."""
    seed, n, extra, ties = SCENES.get(scene, CARD_TIES)
    rng = np.random.default_rng(seed)
    cfg = PConfig(**{**KW, **extra},
                  enable_vertex_tangents=mode.endswith("+tangent"))
    bin_fn = prs.bin_pairs if kernel == "K1" else prs.bin_groups
    rows, bbox, valid = _setup(rng, n, cfg)
    if ties:
        rows, bbox, valid = _ties(rng, rows, bbox, valid)
    if scene == "empty":
        rows[:, 9] = 0.0
        valid = torch.zeros_like(valid)
    pairs = bin_fn(torch.as_tensor(rows), bbox, valid, cfg)
    kw = {}
    if mode.startswith("seeded"):
        srows, sbbox, svalid = _setup(rng, 64, cfg)
        plain = (praster.raster_tiles_plain if kernel == "K1"
                 else praster.raster_groups_plain)
        d0, v0, c0 = plain(bin_fn(torch.as_tensor(srows), sbbox, svalid, cfg),
                           cfg)
        c0 = c0.clone()
        c0[5:] = torch.as_tensor(rng.normal(size=tuple(c0[5:].shape))
                                 .astype(np.float32))
        kw["init"] = (d0, v0, c0)
    elif mode.startswith("peel"):
        kw["peel"] = tuple(torch.as_tensor(b) for b in peel_band(
            rng, cfg.padded_height, cfg.padded_width))
    return pairs, cfg, kw


def _queue(kernel, pairs, cfg, span):
    if kernel == "K1":
        n = pairs.pair_data.shape[0]
        return praster.span_queue(pairs.tile_offsets, n, pairs.big_count, n,
                                  span)
    return praster.span_queue(pairs.tile_offsets, pairs.group_ids.shape[0],
                              pairs.big_count, pairs.big_ids.shape[0], span)


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        # Bit for bit: -0.0 and 0.0 differ, NaNs compare by their bits.
        gb = g.view(torch.int32) if g.dtype == torch.float32 else g
        wb = w.view(torch.int32) if w.dtype == torch.float32 else w
        assert torch.equal(gb, wb), int((gb != wb).sum())


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_split_schedule_matches_plain(kernel, scene, mode):
    """The split schedule equals the sequential walk bit for bit (depth,
    vis, 8 channels), and its spans are the wrapper's work queue."""
    pairs, cfg, kw = _case(kernel, scene, mode)
    plain = (praster.raster_tiles_plain if kernel == "K1"
             else praster.raster_groups_plain)
    span = SPAN_ROWS if kernel == "K1" else SPAN_GROUPS
    got, n_spans = split_raster(pairs, cfg, span, **kw)
    want = plain(pairs, cfg, **kw)
    _assert_same(got, want)
    queue = _queue(kernel, pairs, cfg, span)
    assert queue.dtype == torch.int32
    assert queue.tolist() == [0, 0] + np.cumsum(n_spans).tolist()
    if scene == "empty":
        assert queue[-1] == 0
    else:
        assert max(n_spans) > 3 and (want[1] > 0).any()


def test_ties_straddle_span_boundaries():
    """The tie scene is what its name says: at many pixels the rows that
    pass at the winning depth lie in different spans of the tile's walk,
    among them rows of different ids (twins) and of one id (duplicates),
    and the winner is the first of them in walk order."""
    pairs, cfg, _ = _case("K1", "ties", "plain")
    table, walks, _ = _walks(pairs, cfg)
    depth, vis, _ = praster.raster_tiles_plain(pairs, cfg)
    tz, tv = praster._to_tiles(depth, cfg), praster._to_tiles(vis, cfg)
    th, tw = cfg.tile_h, cfg.tile_w
    twins = dups = 0
    for t, (rows, _, boxed) in enumerate(walks):
        r = table[rows][:, :, None, None]
        px = (torch.arange(tw, dtype=torch.float32)
              + (t % cfg.tiles_x) * tw + 0.5)[None, :]
        py = (torch.arange(th, dtype=torch.float32)
              + (t // cfg.tiles_x) * th + 0.5)[:, None]
        txf, tyf = float(t % cfg.tiles_x), float(t // cfg.tiles_x)
        covers = ((txf >= r[:, 11]) & (txf <= r[:, 12]) & (tyf >= r[:, 13])
                  & (tyf <= r[:, 14]))
        e0 = praster.plane_eval(r[:, 0], r[:, 1], r[:, 2], px, py)
        e1 = praster.plane_eval(r[:, 3], r[:, 4], r[:, 5], px, py)
        z = praster.plane_eval(r[:, 6], r[:, 7], r[:, 8], px, py)
        tied = ((r[:, 9] > 0.5) & (~boxed[:, None, None] | covers)
                & (e0 >= 0) & (e1 >= 0) & ((1.0 - e0) - e1 >= 0)
                & (z == tz[t]) & (tz[t] > 0))             # (L, th, tw)
        several = tied.sum(0) > 1
        w = torch.arange(rows.shape[0])[:, None, None]
        first = torch.where(tied, w, rows.shape[0]).amin(0)
        last = torch.where(tied, w, -1).amax(0)
        ids = r[:, 9].expand_as(tied)
        lo = torch.where(tied, ids, np.inf).amin(0)
        hi = torch.where(tied, ids, -np.inf).amax(0)
        twins += int((several & (first // SPAN_ROWS != last // SPAN_ROWS)
                      & (lo != hi)).sum())
        # The winner's duplicates: tied rows of the first row's id.
        same = tied & (ids == ids.gather(0, first.clamp(
            max=rows.shape[0] - 1)[None]))
        last_same = torch.where(same, w, -1).amax(0)
        dups += int((several & (last_same > first)
                     & (first // SPAN_ROWS != last_same // SPAN_ROWS)).sum())
        won = tv[t] > 0
        assert torch.equal(tv[t][won], table[rows[first[won]], 9].int())
    assert twins > 100 and dups > 100, (twins, dups)


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_split_schedule_matches_pallas_interpret(kernel):
    """The schedule against the JAX package's Pallas kernel (interpret
    mode) on the same pairs (the random scene, carried to JAX as numpy):
    vis and depth exact, channels as tests/test_torch_raster.py compares
    them."""
    pairs, cfg, _ = _case(kernel, "random", "plain")
    jtype = jrs.BinnedPairs if kernel == "K1" else jrs.GroupBinnedPairs
    jpairs = jtype(*(jnp.asarray(x.numpy()) for x in pairs))
    jd, jv, jch = (np.asarray(x) for x in raster_tiles_pallas(
        jpairs, JConfig(**KW), interpret=True))
    (d, v, ch), n_spans = split_raster(
        pairs, cfg, SPAN_ROWS if kernel == "K1" else SPAN_GROUPS)
    assert max(n_spans) > 3
    np.testing.assert_array_equal(v.numpy(), jv)
    np.testing.assert_array_equal(d.numpy(), jd)
    np.testing.assert_allclose(ch.numpy(), jch, rtol=1e-6, atol=1e-6)
    assert (jv > 0).mean() > 0.2


@pytest.mark.parametrize("cap,big,span", [(7, 3, 2), (0, 0, 4), (5, -2, 1),
                                          (100, 9, 256)])
def test_span_queue_clamps_as_the_kernels(cap, big, span):
    """span_queue clamps each tile's range to the capacity (a range past it
    or reversed walks nothing) and the big count to [0, big_cap], as the
    kernels' walk does; [0] is the zeroed counter."""
    offs = torch.tensor([0, 3, 3, 6, 9, 12, 4], dtype=torch.int32)
    q = praster.span_queue(offs, cap, torch.tensor(big, dtype=torch.int32),
                           4, span)
    o = np.minimum(offs.numpy().astype(np.int64), cap)
    walk = np.maximum(o[1:] - o[:-1], 0) + min(max(big, 0), 4)
    spans = -(-walk // span)
    assert q.tolist() == [0, 0] + np.cumsum(spans).tolist()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the raster kernels are CUDA C++ "
                    "and have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K2"])
@pytest.mark.parametrize("mode", ["seeded", "seeded+tangent", "peel"])
def test_cuda_split_ties_match_plain(cuda_device, kernel, mode):
    """The kernels on the tie scene (equal-z rows in different spans of
    the card's 256-row spans too: the scene's busiest tile walks more) vs
    the plain version: every output exact."""
    pairs, cfg, kw = _case(kernel, "card ties", mode)
    to = lambda x: x.to(cuda_device)
    pairs = type(pairs)(*(to(x) for x in pairs))
    kw = {k: tuple(to(x) for x in v) for k, v in kw.items()}
    got = praster.raster_tiles(pairs, cfg, **kw)
    torch.cuda.synchronize()
    plain = (praster.raster_tiles_plain if kernel == "K1"
             else praster.raster_groups_plain)
    _assert_same([x.cpu() for x in got], [x.cpu() for x in plain(pairs, cfg,
                                                                 **kw)])
    span = praster.SPAN_ROWS // (1 if kernel == "K1" else cfg.group_rows)
    q = _queue(kernel, pairs, cfg, span)
    assert int((q[2:] - q[1:-1]).max()) > 3
    if kernel == "K1":
        n = pairs.pair_data.shape[0]
        qk = praster.span_queue_cuda(pairs.tile_offsets, n, pairs.big_count,
                                     n, span)
    else:
        qk = praster.span_queue_cuda(
            pairs.tile_offsets, pairs.group_ids.shape[0], pairs.big_count,
            pairs.big_ids.shape[0], span)
    assert torch.equal(qk, q)
