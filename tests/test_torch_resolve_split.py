"""The schedule of the CUDA attribute resolve K6 (csrc/resolve.cu),
emulated in plain PyTorch on the CPU and held to its plain version and
the JAX package's references.

On the card K6 is three launches. A table kernel puts each tile's
distinct positive vis ids in a hash table (linear probing, 8192 slots)
and gives each pixel its id's slot. A match kernel takes every walked row
on its own (own rows find their tile by binary search over the offsets;
big rows are (tile, row) items) and, where the row's id is in the tile's
table, keeps the largest walk position per (tile, id) with an atomic max:
i - off[t] for an own row, 2^30 + j for big row j. A pixel kernel reads
its slot's winner and evaluates the planes. `split_resolve` below does
the same, with the hash, the probes and the max spelled as the kernels
spell them, and must equal `resolve_attributes_plain` bit for bit: on the
golden scene, on crafted rows in which one id sits in several own rows
and big rows with different lanes, on a vis drawn from any rows' ids,
with tiles of one and of two 4096-pixel tables, with and without the
tangent channel, whatever order the table inserts and the matches run
in. Two mutations (the first match in place of the last; big rows ranked
below own rows) must fail.

JAX references: `resolve_attributes_ref` (jitted) everywhere and the
Pallas kernel in interpret mode where its 128-row slab start does not
matter (tile ranges that start on slab boundaries, or a raster's own
vis). On a vis that shows a previous tile's ids, the Pallas kernel's slab
walk gives other channels; the port follows the twin there, as its plain
version does.

The CUDA kernel itself runs only on a card
(tests/test_torch_resolve.py::test_cuda_resolve_matches_plain).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
from basicrenderer_tpu.ops import raster_setup as jrs
from basicrenderer_tpu.ops.resolve_pallas import (resolve_attributes_pallas,
                                                  resolve_attributes_ref)
from basicrenderer_tpu_torch import interop
from basicrenderer_tpu_torch.graph.framedata import FrameConfig as PConfig
from basicrenderer_tpu_torch.ops import raster as praster
from basicrenderer_tpu_torch.ops import raster_setup as prs
from basicrenderer_tpu_torch.ops import resolve as presolve

from tests.test_resolve import CFG, _setup_scene_frame

SLICE = 4096           # csrc/resolve.cu kSlice: pixels a table holds
HASH_BITS = 13         # kHashBits: a table has 2^13 slots
HASH = 1 << HASH_BITS
BIG = 1 << 30          # kBig: walk position of big row 0
EMPTY = 2 ** 31 - 1    # kEmpty: an empty table slot
WARP_ITEMS = 256       # match items applied together (one block's)
GOLDEN_KW = dict(width=128, height=128, tile_h=16, tile_w=128,
                 max_pairs=1 << 12)


# ---------------------------------------------------------------------------
# The schedule, emulated
# ---------------------------------------------------------------------------

def hash_of(ids: torch.Tensor) -> torch.Tensor:
    """The table slot an id's probe starts at (csrc/resolve.cu hash_of)."""
    return (ids * 2654435761 % 2 ** 32) >> (32 - HASH_BITS)


def find_slot(table: torch.Tensor, id_: int) -> int:
    """`id_`'s slot in a unit's table by linear probing, or -1."""
    h = int(hash_of(torch.tensor(id_)))
    for _ in range(HASH):
        cur = int(table[h])
        if cur == id_:
            return h
        if cur == EMPTY:
            return -1
        h = (h + 1) % HASH
    return -1


def id_tables(vis, cfg, order="forward"):
    """id_table_kernel, emulated: per table unit (tile, 4096-pixel slice)
    its hash table (HASH slots) holding the unit's distinct positive ids,
    inserted in `order` ("forward": pixel order, "reverse", "shuffle":
    which insert wins a contested slot on the card is a race), and each
    pixel's slot (-1 where vis <= 0), in the tile-local layout (N,
    tile_h * tile_w)."""
    th, tw, N = cfg.tile_h, cfg.tile_w, cfg.num_tiles
    npix = th * tw
    slices = -(-npix // SLICE)
    vis_t = praster._to_tiles(vis, cfg).reshape(N, npix).long()
    gen = torch.Generator().manual_seed(5)
    tables, slots = [], torch.full((N, npix), -1, dtype=torch.long)
    for t in range(N):
        for s in range(slices):
            p0 = s * SLICE
            vals = vis_t[t, p0:p0 + min(SLICE, npix - p0)]
            ids = [int(v) for v in vals if 0 < int(v) < EMPTY]
            distinct = list(dict.fromkeys(ids))
            if order == "reverse":
                distinct.reverse()
            elif order == "shuffle":
                distinct = [distinct[i] for i in
                            torch.randperm(len(distinct), generator=gen)]
            table = torch.full((HASH,), EMPTY, dtype=torch.long)
            at = {}
            for id_ in distinct:
                h = int(hash_of(torch.tensor(id_)))
                while int(table[h]) not in (EMPTY, id_):
                    h = (h + 1) % HASH
                table[h] = id_
                at[id_] = h
            slots[t, p0:p0 + len(vals)] = torch.tensor(
                [at.get(int(v), -1) for v in vals])
            tables.append(table)
    return tables, slots, slices


def match_items(pairs, cfg, slices):
    """last_match_kernel's items in grid order: (unit, id, own, position)
    for every walked own row (per slice of its tile) and every (unit, big
    row) pair."""
    pd = pairs.pair_data
    n_rows, N = pd.shape[0], cfg.num_tiles
    off = pairs.tile_offsets.long()
    first = min(int(off[0]), n_rows)
    n_own = max(min(int(off[N]), n_rows) - first, 0)
    nbig = min(int(pairs.big_count), n_rows)
    rows = torch.arange(first, first + n_own)
    # The tile whose range holds the row: the last t with off[t] <= row.
    tile = torch.searchsorted(off[:N], rows, right=True) - 1
    pos = rows - off[tile]
    ids = pd[rows, 9].to(torch.int32).long()
    own = [(tile * slices + s, ids, torch.ones_like(ids, dtype=torch.bool),
            pos) for s in range(slices)]
    units = torch.arange(N * slices).repeat_interleave(nbig)
    j = torch.arange(nbig).repeat(N * slices)
    big = (units, pd[j, 9].to(torch.int32).long(),
           torch.zeros_like(j, dtype=torch.bool), j)
    return [torch.cat(x) for x in zip(*own, big)]


def split_resolve(pairs, vis, cfg, tile_row0=0, order="forward",
                  table_order="forward", mutation=None):
    """K6's three launches, emulated: (8, H', W') channels. `order`
    ("forward", "reverse", "shuffle") is the order in which the match
    items reach the keys, `table_order` the order of the table inserts;
    `mutation` ("first": the first match wins; "big_below": own rows
    outrank big rows) breaks the kernel on purpose."""
    th, tw, N = cfg.tile_h, cfg.tile_w, cfg.num_tiles
    tables, slots, slices = id_tables(vis, cfg, table_order)
    unit, ids, own, pos = match_items(pairs, cfg, slices)
    if mutation == "big_below":
        key = torch.where(own, BIG + pos, pos)
    else:
        key = torch.where(own, pos, BIG + pos)
    slot_of = torch.tensor([
        find_slot(tables[u], i) if 0 < i < EMPTY else -1
        for u, i in zip(unit.tolist(), ids.tolist())], dtype=torch.long)
    items = torch.nonzero(slot_of >= 0).flatten()
    if order == "reverse":
        items = items.flip(0)
    elif order == "shuffle":
        items = items[torch.randperm(len(items),
                                     generator=torch.Generator().manual_seed(3))]
    none = EMPTY if mutation == "first" else -1
    keys = torch.full((N * slices * HASH,), none, dtype=torch.long)
    for c0 in range(0, len(items), WARP_ITEMS):
        it = items[c0:c0 + WARP_ITEMS]
        keys.scatter_reduce_(0, unit[it] * HASH + slot_of[it], key[it],
                             "amin" if mutation == "first" else "amax")
    # attr_pixels_kernel: one pixel each.
    npix = th * tw
    p = torch.arange(npix)
    u = torch.arange(N)[:, None] * slices + (p // SLICE)[None, :]
    k = torch.where(slots >= 0, keys[u * HASH + slots.clamp(min=0)], none)
    k = torch.where(k == EMPTY, -1, k)
    won = k >= 0
    off = pairs.tile_offsets.long()
    if mutation == "big_below":
        row = torch.where(k >= BIG, off[:N, None] + k - BIG, k)
    else:
        row = torch.where(k >= BIG, k - BIG, off[:N, None] + k)
    r = pairs.pair_data[row.clamp(min=0)]                    # (N, npix, 32)
    t = torch.arange(N)[:, None]
    px = ((t % cfg.tiles_x) * tw + p % tw).float() + 0.5
    py = ((t // cfg.tiles_x + tile_row0) * th + p // tw).float() + 0.5
    ch = torch.zeros((8, N, npix), dtype=torch.float32)
    for c in range(4):
        val = praster.plane_eval(r[..., 15 + 3 * c], r[..., 16 + 3 * c],
                                 r[..., 17 + 3 * c], px, py)
        ch[c] = torch.where(won, val, 0.0)
    ch[4] = torch.where(won, r[..., 10], 0.0)
    if cfg.enable_vertex_tangents:
        ch[5] = torch.where(won, r[..., 27], 0.0)
    return praster._to_image(ch.reshape(8, N, th, tw), cfg)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def _np_fields(nt):
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


def _jax_pairs(pp):
    return jrs.BinnedPairs(**{f: jnp.asarray(getattr(pp, f).numpy())
                              for f in pp._fields})


def _jax_ref(pp, vis, cfg_kw, tangent):
    jc = JConfig(**cfg_kw, enable_vertex_tangents=tangent)
    return np.asarray(jax.jit(lambda p, v: resolve_attributes_ref(p, v, jc))(
        _jax_pairs(pp), jnp.asarray(vis.numpy())))


def _pallas(pp, vis, cfg_kw, tangent):
    jc = JConfig(**cfg_kw, enable_vertex_tangents=tangent)
    return np.asarray(resolve_attributes_pallas(
        _jax_pairs(pp), jnp.asarray(vis.numpy()), jc, interpret=True))


@pytest.fixture(scope="module")
def golden():
    """tests/test_resolve.py's scene: the port's BinnedPairs and vis."""
    _, _, _, pairs, _, vis_p, _, _ = _setup_scene_frame()
    return (interop.binned_pairs(_np_fields(pairs), device="cpu"),
            torch.as_tensor(np.array(vis_p)))


def _with_tangents(pp, seed=7):
    """A random tangent angle per triangle in lane 27 (the same on each of
    its rows)."""
    pd = pp.pair_data.clone()
    rng = np.random.default_rng(seed)
    angle = torch.as_tensor(rng.uniform(
        -np.pi, 5 * np.pi, int(pd[:, 9].max()) + 1).astype(np.float32))
    pd[:, 27] = torch.where(pd[:, 9] > 0.5, angle[pd[:, 9].long()], 0.0)
    return pp._replace(pair_data=pd)


def crafted(seed, tile_h=16, tiles=(2, 2), per_tile=(256, 128, 0, 384),
            bcap=128, nbig=40, pool=24):
    """Rows whose ids come from a small pool, so one id sits in several own
    rows of a tile and in big rows, each row with its own random lanes;
    ids <= 0 among them. Tile ranges start on 128-row slab boundaries
    (the Pallas kernel's walk start is then its range's). Returns (port
    pairs, config kwargs)."""
    rng = np.random.default_rng(seed)
    kw = dict(width=128 * tiles[0], height=tile_h * tiles[1], tile_h=tile_h,
              tile_w=128, max_pairs=1 << 12, max_big_tris=bcap)
    n = bcap + sum(per_tile)
    pd = rng.normal(size=(n, 32)).astype(np.float32) * 0.01
    pd[:, 10] = rng.integers(1, 1000, n)
    pd[:, 27] = rng.uniform(-np.pi, np.pi, n)
    pd[:, 9] = rng.integers(-2, pool, n)
    pd[nbig:bcap, 9] = 0                   # the big list's dead tail
    off = np.concatenate([[0], np.cumsum(per_tile)]).astype(np.int32) + bcap
    pp = prs.BinnedPairs(
        pair_data=torch.as_tensor(pd), tile_offsets=torch.as_tensor(off),
        num_pairs=torch.tensor(sum(per_tile), dtype=torch.int32),
        overflow=torch.tensor(0, dtype=torch.int32),
        big_count=torch.tensor(nbig, dtype=torch.int32))
    return pp, kw


def random_vis(pp, kw, seed, prev_tile=False):
    """A vis whose pixels show ids of the tile's own rows, of big rows and
    (prev_tile) of the previous tile's rows, with zeros and negatives."""
    rng = np.random.default_rng(seed)
    cfg = PConfig(**kw)
    pd, off = pp.pair_data.numpy(), pp.tile_offsets.numpy()
    big = pd[:int(pp.big_count), 9].astype(np.int32)
    tiles = []
    for t in range(cfg.num_tiles):
        src = [pd[off[t]:off[t + 1], 9].astype(np.int32), big, [0, -1]]
        if prev_tile and t > 0:
            src.append(pd[off[t - 1]:off[t], 9].astype(np.int32))
        pool = np.concatenate([np.asarray(s, np.int32) for s in src])
        tiles.append(rng.choice(pool, (cfg.tile_h, cfg.tile_w)))
    tv = torch.as_tensor(np.stack(tiles))
    return praster._to_image(tv[None].float(), cfg)[0].to(torch.int32)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tangent", [False, True])
def test_split_matches_plain_and_jax_on_golden_scene(golden, tangent):
    pp, vis = golden
    if tangent:
        pp = _with_tangents(pp)
    cfg = PConfig(**GOLDEN_KW, enable_vertex_tangents=tangent)
    got = split_resolve(pp, vis, cfg)
    assert torch.equal(got, presolve.resolve_attributes_plain(pp, vis, cfg))
    jc = dataclasses.replace(CFG, enable_vertex_tangents=tangent)
    jp = _jax_pairs(pp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        resolve_attributes_pallas(jp, jnp.asarray(vis.numpy()), jc,
                                  interpret=True)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.jit(
        lambda p, v: resolve_attributes_ref(p, v, jc))(
            jp, jnp.asarray(vis.numpy()))))
    assert (got[4] > 0).float().mean() > 0.3


@pytest.mark.parametrize("tangent", [False, True])
def test_split_last_writer_decides(tangent):
    """One id in several own rows and big rows with different lanes: the
    last row of the walk decides, a big row over any own row."""
    pp, kw = crafted(31)
    vis = random_vis(pp, kw, 32)
    cfg = PConfig(**kw, enable_vertex_tangents=tangent)
    got = split_resolve(pp, vis, cfg)
    plain = presolve.resolve_attributes_plain(pp, vis, cfg)
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(got.numpy(), _jax_ref(pp, vis, kw, tangent))
    np.testing.assert_array_equal(got.numpy(), _pallas(pp, vis, kw, tangent))
    # The case is what it claims: pixels won by a big row whose id also
    # sits in an own row of the tile, and by an own row whose id repeats.
    pd = pp.pair_data
    ids_big = set(pd[:int(pp.big_count), 9].long().tolist())
    own0 = pd[int(pp.tile_offsets[0]):int(pp.tile_offsets[1]), 9].long()
    dup = {i for i in set(own0.tolist()) if i > 0
           and int((own0 == i).sum()) > 1}
    assert dup & ids_big and dup - ids_big
    assert (got[4] > 0).float().mean() > 0.5


@pytest.mark.parametrize("tangent", [False, True])
def test_split_any_vis(tangent):
    """A vis that shows ids of the previous tile's rows too: the split
    schedule and the plain version equal the jitted twin; the Pallas
    kernel, which walks from the slab below each range, meets those rows
    and differs."""
    pp, kw = crafted(41, per_tile=(200, 90, 0, 300), bcap=100)
    vis = random_vis(pp, kw, 42, prev_tile=True)
    cfg = PConfig(**kw, enable_vertex_tangents=tangent)
    got = split_resolve(pp, vis, cfg)
    assert torch.equal(got, presolve.resolve_attributes_plain(pp, vis, cfg))
    np.testing.assert_array_equal(got.numpy(), _jax_ref(pp, vis, kw, tangent))
    assert not np.array_equal(got.numpy(), _pallas(pp, vis, kw, tangent))


def test_split_two_tables_a_tile():
    """64x128 tiles: two 4096-pixel tables a tile, each own row matched
    against both; big rows as (table, row) items."""
    pp, kw = crafted(51, tile_h=64, per_tile=(300, 40, 0, 520), pool=60)
    vis = random_vis(pp, kw, 52, prev_tile=True)
    cfg = PConfig(**kw, enable_vertex_tangents=True)
    assert -(-cfg.tile_h * cfg.tile_w // SLICE) == 2
    got = split_resolve(pp, vis, cfg, tile_row0=3)
    assert torch.equal(got, presolve.resolve_attributes_plain(pp, vis, cfg,
                                                              tile_row0=3))
    jc = JConfig(**kw, enable_vertex_tangents=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.jit(
        lambda p, v: resolve_attributes_ref(p, v, jc, tile_row0=3))(
            _jax_pairs(pp), jnp.asarray(vis.numpy()))))


@pytest.mark.parametrize("order", ["reverse", "shuffle"])
def test_split_order_free(golden, order):
    """The table inserts and the matches may land in any order: an id's
    slot moves with the inserts, but every reader probes the same table,
    and the maximum has no order."""
    pp, kw = crafted(61, pool=1 << 24)
    vis = random_vis(pp, kw, 62, prev_tile=True)
    cfg = PConfig(**kw, enable_vertex_tangents=True)
    plain = presolve.resolve_attributes_plain(pp, vis, cfg)
    tables = [id_tables(vis, cfg, o)[0] for o in ("forward", order)]
    assert any(not torch.equal(a, b) for a, b in zip(*tables))
    assert torch.equal(split_resolve(pp, vis, cfg, order=order,
                                     table_order=order), plain)
    gp, gvis = golden
    gcfg = PConfig(**GOLDEN_KW)
    assert torch.equal(split_resolve(gp, gvis, gcfg, order=order,
                                     table_order=order),
                       presolve.resolve_attributes_plain(gp, gvis, gcfg))


@pytest.mark.parametrize("mutation", ["first", "big_below"])
def test_split_mutations_fail(mutation):
    """The first match in place of the last, or big rows ranked below own
    rows: both differ from the plain version on the crafted rows."""
    pp, kw = crafted(31)
    vis = random_vis(pp, kw, 32)
    cfg = PConfig(**kw)
    plain = presolve.resolve_attributes_plain(pp, vis, cfg)
    assert torch.equal(split_resolve(pp, vis, cfg), plain)
    bad = split_resolve(pp, vis, cfg, mutation=mutation)
    assert not torch.equal(bad, plain)
    # Only which row wins changes: the covered pixels stay covered.
    assert torch.equal(bad[4] != 0, plain[4] != 0)


def test_split_on_a_raster_with_big_rows():
    """A raster's own vis over random triangles with the big list in use
    (the card test's scene at a CPU size): the split schedule equals the
    plain version and K1's fused channels."""
    from tests.test_raster import random_clip_triangles
    rng = np.random.default_rng(23)
    n = 300
    cfg = PConfig(width=256, height=96, tile_h=32, tile_w=128,
                  max_pairs=1 << 13, max_tiles_per_tri=2,
                  enable_vertex_tangents=True)
    clip = torch.as_tensor(random_clip_triangles(rng, n).reshape(-1, 4))
    idx = torch.arange(3 * n, dtype=torch.int32).view(n, 3)
    lanes, bbox, valid, _ = prs.triangle_setup_packed(
        clip, idx, torch.ones(n, dtype=torch.bool), cfg, None, None)
    lanes[:, 27] = torch.where(lanes[:, 9] > 0.5, torch.as_tensor(
        rng.uniform(-np.pi, 5 * np.pi, lanes.shape[0]).astype(np.float32)),
        0.0)
    pairs = prs.bin_pairs(lanes, bbox, valid, cfg)
    assert int(pairs.big_count) > 0
    _, vis, fused = praster.raster_tiles(pairs, cfg)
    got = split_resolve(pairs, vis, cfg)
    assert torch.equal(got, presolve.resolve_attributes_plain(pairs, vis, cfg))
    assert torch.equal(got, fused)
