"""K1's accum schedule on the card (csrc/raster.cu, accum_rows_kernel),
emulated in plain PyTorch on the CPU and held to the plain version of K1.

On the card a block owns a 256-pixel slice of a tile. A producer warp
walks the tile's rows (its own binned rows, then the big rows) in stages
of 64, keeps the live rows (id lane 9 > 0.5; big rows only where their
tile bbox covers the tile) in walk order, and writes each kept row as a
record of its planes (lanes 0-8) and its decoded, scaled payload; the
pixel threads add each record's fragment to their pixel's 8 sums, record
after record. The sums are fused multiply-adds whose rounding depends on
their order, so the compaction must keep walk order.

`k1_schedule` is that schedule with a walk of its own (stages, the keep
test, records, the payload decode, the planes and the sums as fused
multiply-adds emulated in f64) and must equal `raster_tiles_plain(accum=
True)` bit for bit: on the skewed scene of tests/test_torch_accum_skew.py
(one tile walking ~2,000 rows over half of it), banded and not, and on a
scene with big rows (tests/test_torch_raster.py's big-list case). The
mutation that compacts each stage in reverse walk order must differ.
The CUDA kernel against the plain version is in
tests/test_torch_accum_skew.py and tests/test_torch_raster.py (marked
`cuda`).
"""

import pytest
import torch

from basicrenderer_tpu_torch import interop
from basicrenderer_tpu_torch.ops import raster as praster

from tests.test_torch_accum_skew import skewed_k1_case
from tests.test_torch_raster import PEEL_CASES, _np_fields, _peel_pairs

STAGE = 64          # rows a stage of the card's ring
F32 = torch.float32


def fma(a, b, c):
    """a*b + c rounded once to f32 (the f64 product of two f32 values is
    exact)."""
    return (a.double() * b.double() + c.double()).float()


def plane(a, b, c, px, py):
    """fma(a, px, round(b*py)) + c, each step rounded to f32."""
    return fma(a, px, b * py) + c


def decode(row):
    """The record's payload: (a, r, g, b) / 255 and the three optical
    depths * 4 / 255, from lanes 30 (a8 + odr8*256 + odg8*65536), 28 (r8 +
    g8*256 + b8*65536) and 31 (odb8), by f32 floor-divides."""
    inv256 = torch.tensor(1.0 / 256.0, dtype=F32)
    inv255 = torch.tensor(1.0 / 255.0, dtype=F32)
    four255 = torch.tensor(4.0 / 255.0, dtype=F32)
    p28, p30, p31 = row[28], row[30], row[31]
    hi = torch.floor(p30 * inv256)
    hi2 = torch.floor(hi * inv256)
    c1 = torch.floor(p28 * inv256)
    b8 = torch.floor(c1 * inv256)
    bytes_ = (p30 - hi * 256.0, p28 - c1 * 256.0, c1 - b8 * 256.0, b8)
    ods = (hi - hi2 * 256.0, hi2, p31)
    return torch.stack([v * inv255 for v in bytes_]
                       + [v * four255 for v in ods])


def tile_records(pair_data, start, own, nbig, tx, ty, reverse_stages=False):
    """The tile's records in the order the pixel threads see them: the
    walk (own rows start.., then big rows 0..) cut into stages of STAGE
    rows, each stage's kept rows in walk order (reversed by the
    mutation), as (planes (9,), payload (7,)) pairs."""
    out = []
    total = own + nbig
    for c0 in range(0, total, STAGE):
        kept = []
        for w in range(c0, min(c0 + STAGE, total)):
            row = pair_data[start + w] if w < own else pair_data[w - own]
            if not row[9] > 0.5:
                continue
            if w >= own and not (tx >= row[11] and tx <= row[12]
                                 and ty >= row[13] and ty <= row[14]):
                continue
            kept.append((row[:9], decode(row)))
        out.extend(kept[::-1] if reverse_stages else kept)
    return out


def k1_schedule(pairs, cfg, peel=None, reverse_stages=False):
    """(depth, vis, channels) of K1's accum mode by the card's schedule,
    tile by tile, all of a tile's pixels at once."""
    th, tw = cfg.tile_h, cfg.tile_w
    Hp, Wp = cfg.padded_height, cfg.padded_width
    pd = pairs.pair_data
    n = pd.shape[0]
    offs = pairs.tile_offsets.long().clamp(max=n).tolist()
    nbig = max(0, min(int(pairs.big_count), n))
    seed_img = (peel[0] if peel is not None
                else torch.zeros((Hp, Wp), dtype=F32))
    chans = torch.zeros((8, Hp, Wp), dtype=F32)
    for t in range(cfg.num_tiles):
        ty, tx = divmod(t, cfg.tiles_x)
        ys, xs = slice(ty * th, (ty + 1) * th), slice(tx * tw, (tx + 1) * tw)
        px = (torch.arange(tw, dtype=F32) + float(tx * tw) + 0.5)[None, :]
        py = (torch.arange(th, dtype=F32) + float(ty * th) + 0.5)[:, None]
        seed = seed_img[ys, xs]
        bound = peel[1][ys, xs] if peel is not None else None
        ch = [torch.zeros((th, tw), dtype=F32) for _ in range(8)]
        one = torch.ones((), dtype=F32)
        start, own = offs[t], max(0, offs[t + 1] - offs[t])
        for q, v in tile_records(pd, start, own, nbig, float(tx), float(ty),
                                 reverse_stages):
            e0 = plane(q[0], q[1], q[2], px, py)
            e1 = plane(q[3], q[4], q[5], px, py)
            e2 = (1.0 - e0) - e1
            z = plane(q[6], q[7], q[8], px, py)
            ok = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (z > seed)
            if bound is not None:
                ok = ok & (z < bound)
                u = torch.clamp((z - seed) / torch.clamp(bound - seed,
                                                         min=1e-6), 0.0, 1.0)
                w = fma(u, u, torch.tensor(0.05, dtype=F32))
            else:
                w = one
            for k in range(4):
                ch[k] = torch.where(ok, fma(w, v[k], ch[k]), ch[k])
            for k in range(4, 7):
                ch[k] = torch.where(ok, ch[k] + v[k], ch[k])
            ch[7] = torch.where(ok, ch[7] + 1.0, ch[7])
        chans[:, ys, xs] = torch.stack(ch)
    return seed_img.clone(), torch.zeros((Hp, Wp), dtype=torch.int32), chans


def _skewed():
    _, pc, _, ppairs, band = skewed_k1_case()
    return pc, ppairs, band


def _big_list():
    seed, n, kw = PEEL_CASES["big_list"]
    _jc, pc, jpairs, band = _peel_pairs(seed, n, **kw)
    pairs = interop.binned_pairs(_np_fields(jpairs), device="cpu")
    assert int(pairs.big_count) > 0
    return pc, pairs, band


CASES = {"skewed": _skewed, "big_list": _big_list}


@pytest.fixture(scope="module")
def cases():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = CASES[name]()
        return cache[name]
    return get


@pytest.mark.parametrize("banded", [True, False], ids=["banded", "unbanded"])
@pytest.mark.parametrize("case", list(CASES))
def test_k1_schedule_matches_plain(cases, case, banded):
    cfg, pairs, band = cases(case)
    peel = tuple(torch.as_tensor(b) for b in band) if banded else None
    got = k1_schedule(pairs, cfg, peel)
    want = praster.raster_tiles_plain(pairs, cfg, peel=peel, accum=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert (want[2][7] > 1.5).any()          # fragments pile up


def test_k1_schedule_out_of_walk_order_fails(cases):
    """Compacting each stage in reverse walk order changes the sums."""
    cfg, pairs, band = cases("skewed")
    peel = tuple(torch.as_tensor(b) for b in band)
    got = k1_schedule(pairs, cfg, peel, reverse_stages=True)[2]
    want = praster.raster_tiles_plain(pairs, cfg, peel=peel, accum=True)[2]
    assert torch.equal(got[7], want[7])      # the same fragments ...
    assert int((got[:7] != want[:7]).sum()) > 0   # ... summed in another order
