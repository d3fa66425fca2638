"""The accum mode (the OIT tail) of K2 and K1 on a skewed scene: one tile
walks more than 2,000 rows, all of them over the left half of the tile,
so that half of that tile is uncovered and its other tiles are light.

On the card the accum mode cuts each tile by pixels (one pixel a thread,
16 blocks a 32x128 tile), never by walk, because each pixel's 8 sums are
fused multiply-adds in walk order (csrc/raster.cu). A long walk over
deeply overlapping fragments is where a change of that order would show:
here about 20 fragments a pixel of the busy half, up to ~60.
- K2: `raster_groups_plain(accum=True)` must equal the JAX package's
  Pallas group kernel (interpret mode) and its jitted reference twin
  exactly (vis, depth and all 8 channels), with and without a peel band,
  at group_rows 8 and 16.
- K1: the same triangles binned per triangle; `raster_tiles_plain(accum=
  True)` must equal the jitted reference twin `raster_tiles_ref` exactly
  (the Pallas K1 walks from its 128-row slab and counts some rows twice:
  tests/test_torch_raster.py), with and without a peel band.
The CUDA kernels against the plain versions on the same scenes are marked
`cuda` and skip without a card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
from basicrenderer_tpu.ops import raster_setup as jrs
from basicrenderer_tpu.ops.raster_pallas import raster_tiles_pallas
from basicrenderer_tpu.ops.raster_ref import raster_tiles_ref
from basicrenderer_tpu_torch import interop
from basicrenderer_tpu_torch.graph.framedata import FrameConfig as PConfig
from basicrenderer_tpu_torch.ops import raster as praster

from tests.test_raster import setup_from_clip
from tests.test_torch_raster import peel_band, with_payload

KW = dict(width=128, height=128, tile_h=16, tile_w=128, max_pairs=1 << 14,
          max_group_pairs=1 << 11, max_tiles_per_group=6)
BUSY, REST = 2048, 256     # triangles on the busy tile, elsewhere
MIN_WALK = 2000            # rows the busy tile walks, at least


def skewed_clip(rng):
    """(BUSY + REST, 3, 4) clip-space triangles, all facing the camera: the
    first BUSY small ones (~10 pixels across) inside the left half of the
    top tile (pixel x < 64, y < 16), then REST random ones below it (y >
    22)."""
    w = rng.uniform(2.0, 10.0, size=(BUSY + REST, 3, 1)).astype(np.float32)
    c = np.stack([rng.uniform(-0.93, -0.07, BUSY),
                  rng.uniform(0.80, 0.95, BUSY)], -1)[:, None, :]
    busy = np.clip(c + rng.uniform(-0.1, 0.1, (BUSY, 3, 2)),
                   [-0.99, 0.76], [-0.01, 0.99])
    rest = np.stack([rng.uniform(-0.9, 0.9, (REST, 3)),
                     rng.uniform(-0.9, 0.65, (REST, 3))], -1)
    xy = np.concatenate([busy, rest]).astype(np.float32)
    # Counter-clockwise in NDC (the winding the setup keeps): swap the last
    # two vertices of the others.
    e1, e2 = xy[:, 1] - xy[:, 0], xy[:, 2] - xy[:, 0]
    cw = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0] < 0
    xy[cw] = xy[cw][:, [0, 2, 1]]
    z = rng.uniform(0.05, 0.95, size=(BUSY + REST, 3, 1)).astype(np.float32)
    return np.concatenate([xy * w, z * w, w], -1)


def skewed_case(group_rows):
    """(JAX config, port config, JAX GroupBinnedPairs with the accum
    payload, port GroupBinnedPairs, peel band as numpy)."""
    rng = np.random.default_rng(31 + group_rows)
    jc = JConfig(**KW, group_rows=group_rows)
    setup = setup_from_clip(skewed_clip(rng), jc)
    lanes = jnp.asarray(with_payload(rng, jrs.pack_setup_lanes(setup)))
    jpairs = jrs.bin_groups(lanes, setup.bbox, setup.valid, jc)
    pc = PConfig(**KW, group_rows=group_rows)
    ppairs = interop.group_binned_pairs(
        {f: np.asarray(getattr(jpairs, f)) for f in jpairs._fields},
        device="cpu")
    band = peel_band(rng, pc.padded_height, pc.padded_width)
    return jc, pc, jpairs, ppairs, band


def walked_rows(pairs, cfg):
    """Rows each tile's accum walk evaluates (bbox-tested), per tile."""
    offs = praster.expand_group_pairs(pairs, cfg)[1].long()
    return (offs[1:] - offs[:-1]).tolist()


@pytest.fixture(scope="module")
def cases():
    cache = {}

    def get(group_rows):
        if group_rows not in cache:
            cache[group_rows] = skewed_case(group_rows)
        return cache[group_rows]
    return get


@pytest.mark.parametrize("banded", [True, False], ids=["banded", "unbanded"])
@pytest.mark.parametrize("group_rows", [8, 16])
def test_skewed_accum_matches_jax(cases, group_rows, banded):
    jc, pc, jpairs, ppairs, band = cases(group_rows)
    rows = walked_rows(ppairs, pc)
    assert rows[0] >= MIN_WALK and max(rows[1:]) < MIN_WALK // 4, rows
    jband = tuple(jnp.asarray(b) for b in band) if banded else None
    jd, jv, jch = (np.asarray(x) for x in raster_tiles_pallas(
        jpairs, jc, interpret=True, peel=jband, accum=True))
    rd, rch = (np.asarray(x) for x in jax.jit(
        lambda p, b: raster_tiles_ref(p, jc, peel=b, accum=True))(
            jpairs, jband))
    pband = tuple(torch.as_tensor(b) for b in band) if banded else None
    pd, pv, pch = (x.numpy() for x in praster.raster_groups_plain(
        ppairs, pc, peel=pband, accum=True))
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pd, jd)
    np.testing.assert_array_equal(pd, rd)
    np.testing.assert_array_equal(pch, jch)
    np.testing.assert_array_equal(pch, rch)
    count = pch[7]
    # The busy tile: its left half deeply covered, its right half not.
    assert count[:16, :64].mean() > 15 and count[:16, 64:].max() == 0
    assert (count[16:] > 0).any()


def skewed_k1_case():
    """(JAX config, port config, JAX BinnedPairs with the accum payload,
    port BinnedPairs, peel band as numpy): the skewed triangles binned
    per triangle."""
    rng = np.random.default_rng(40)
    jc = JConfig(**KW)
    setup = setup_from_clip(skewed_clip(rng), jc)
    jpairs = jrs.bin_triangles(setup, jc)
    jpairs = jpairs._replace(pair_data=jnp.asarray(
        with_payload(rng, jpairs.pair_data)))
    pc = PConfig(**KW)
    ppairs = interop.binned_pairs(
        {f: np.asarray(getattr(jpairs, f)) for f in jpairs._fields},
        device="cpu")
    band = peel_band(rng, pc.padded_height, pc.padded_width)
    return jc, pc, jpairs, ppairs, band


@pytest.fixture(scope="module")
def k1_case():
    return skewed_k1_case()


@pytest.mark.parametrize("banded", [True, False], ids=["banded", "unbanded"])
def test_skewed_k1_accum_matches_jax_reference(k1_case, banded):
    jc, pc, jpairs, ppairs, band = k1_case
    offs = ppairs.tile_offsets.long()
    rows = (offs[1:] - offs[:-1]).tolist()
    assert rows[0] >= MIN_WALK and max(rows[1:]) < MIN_WALK // 4, rows
    jband = tuple(jnp.asarray(b) for b in band) if banded else None
    rd, rch = (np.asarray(x) for x in jax.jit(
        lambda p, b: raster_tiles_ref(p, jc, peel=b, accum=True))(
            jpairs, jband))
    pband = tuple(torch.as_tensor(b) for b in band) if banded else None
    pd, pv, pch = (x.numpy() for x in praster.raster_tiles_plain(
        ppairs, pc, peel=pband, accum=True))
    assert not pv.any()
    np.testing.assert_array_equal(pd, rd)
    np.testing.assert_array_equal(pch, rch)
    count = pch[7]
    assert count[:16, :64].mean() > 15 and count[:16, 64:].max() == 0
    assert (count[16:] > 0).any()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the group raster kernel is CUDA "
                    "C++ and has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("banded", [True, False], ids=["banded", "unbanded"])
@pytest.mark.parametrize("group_rows", [8, 16])
def test_cuda_skewed_accum_matches_plain(cuda_device, cases, group_rows,
                                         banded):
    """The accum kernel on the skewed scenes vs the plain version: vis,
    depth and all 8 channels exact, one launch."""
    _, pc, _, ppairs, band = cases(group_rows)
    pairs = type(ppairs)(*(x.to(cuda_device) for x in ppairs))
    peel = (tuple(torch.as_tensor(b, device=cuda_device) for b in band)
            if banded else None)
    count = praster.MODE_LAUNCHES[("K2", "accum")]
    before = count.launches
    got = praster.raster_tiles(pairs, pc, peel=peel, accum=True)
    torch.cuda.synchronize()
    assert count.launches == before + 1
    want = praster.raster_groups_plain(pairs, pc, peel=peel, accum=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("banded", [True, False], ids=["banded", "unbanded"])
def test_cuda_skewed_k1_accum_matches_plain(cuda_device, k1_case, banded):
    """K1's accum kernel on the skewed scene vs the plain version: vis,
    depth and all 8 channels exact, one launch."""
    _, pc, _, ppairs, band = k1_case
    pairs = type(ppairs)(*(x.to(cuda_device) for x in ppairs))
    peel = (tuple(torch.as_tensor(b, device=cuda_device) for b in band)
            if banded else None)
    count = praster.MODE_LAUNCHES[("K1", "accum")]
    before = count.launches
    got = praster.raster_tiles(pairs, pc, peel=peel, accum=True)
    torch.cuda.synchronize()
    assert count.launches == before + 1
    want = praster.raster_tiles_plain(pairs, pc, peel=peel, accum=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
