"""Port group raster (K2) vs the JAX package's Pallas group kernel, run in
interpret mode on the CPU as tests/test_raster_pallas.py runs it.

Both are fed the same GroupBinnedPairs: the JAX package's own (random
triangles, and the 128x128 cluster rig's opaque pass), carried across with
basicrenderer_tpu_torch.interop. Plain and seeded modes, including a case
where most groups take the global big-group list. `vis` and `depth` must
be exactly equal; channels allclose at rtol 1e-6, atol 1e-6 (as
tests/test_torch_raster.py).

The CUDA kernel has no CPU mode: its comparison with the plain version is
marked `cuda` and skips without a card.
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
from basicrenderer_tpu_torch.ops import raster_setup as prs

from tests.test_raster import random_clip_triangles, setup_from_clip
from tests.test_torch_raster import (peel_band, seeded_and_tangent_case,
                                     with_payload)

KW = dict(width=256, height=64, tile_h=16, tile_w=128, max_pairs=1 << 12,
          max_group_pairs=1 << 10)


def _np_fields(nt):
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


def _jax_groups(seed, n, **kw):
    """JAX GroupBinnedPairs of n random triangles (n a multiple of 32)."""
    jc = JConfig(**{**KW, **kw})
    setup = setup_from_clip(random_clip_triangles(np.random.default_rng(seed), n),
                            jc)
    lanes = jrs.pack_setup_lanes(setup)
    return jc, PConfig(**{**KW, **kw}), jrs.bin_groups(lanes, setup.bbox,
                                                       setup.valid, jc)


def _compare(jc, pc, jpairs, init=None):
    jd, jv, jch = (np.asarray(x) for x in raster_tiles_pallas(
        jpairs, jc, interpret=True,
        init=None if init is None else tuple(jnp.asarray(x) for x in init)))
    pinit = None if init is None else tuple(torch.as_tensor(np.array(x))
                                            for x in init)
    pd, pv, pch = (x.numpy() for x in praster.raster_tiles(
        interop.group_binned_pairs(_np_fields(jpairs), device="cpu"), pc,
        init=pinit))
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pd, jd)
    np.testing.assert_allclose(pch, jch, rtol=1e-6, atol=1e-6)
    return pd, pv, pch


@pytest.mark.parametrize("seed", [0, 3])
def test_group_plain_matches_pallas_interpret(seed):
    jc, pc, jpairs = _jax_groups(seed, 64)
    assert int(jpairs.num_pairs) > 0
    _, vis, _ = _compare(jc, pc, jpairs)
    assert (vis > 0).mean() > 0.2


def test_group_plain_matches_pallas_interpret_big_list():
    """max_tiles_per_group=1 sends every group spanning two tiles through
    the global big-group list, which both walk with the box pre-test."""
    jc, pc, jpairs = _jax_groups(7, 64, max_tiles_per_group=1)
    assert int(jpairs.big_count) > 0
    _compare(jc, pc, jpairs)


def test_group_seeded_matches_pallas_interpret():
    """Seeded mode continues a previous raster's buffers (phase 2 of the
    two-phase occlusion)."""
    jc, pc, seed_pairs = _jax_groups(11, 32)
    init = raster_tiles_pallas(seed_pairs, jc, interpret=True)
    jc, pc, jpairs = _jax_groups(12, 64, max_tiles_per_group=1)
    d, v, ch = _compare(jc, pc, jpairs, init=[np.asarray(x) for x in init])
    assert (v != np.asarray(init[1])).any() and (v == np.asarray(init[1])).any()


def test_group_plain_matches_pallas_interpret_on_the_rig():
    """The cluster rig's own opaque pass: cut, compaction, setup from the
    cluster pages and group binning, all by the JAX package."""
    from basicrenderer_tpu.graph import frame as jframe
    from basicrenderer_tpu.graph.framedata import FrameParams, make_view
    from tests.test_torch_cluster_frame import BASE, JAX_PKG, build_rig
    sc, bridge = build_rig(JAX_PKG)
    jc = JConfig(**BASE)
    *_, jpairs = jframe.geometry_pass(
        bridge.build_scene_buffers(),
        make_view(*sc.camera_matrices(aspect=1.0)), jc, FrameParams.default())
    assert isinstance(jpairs, jrs.GroupBinnedPairs)
    _, vis, _ = _compare(jc, PConfig(**BASE), jpairs)
    assert (vis > 0).mean() > 0.3


def test_bin_groups_matches_jax():
    """bin_groups fed the JAX package's lanes: every output equal."""
    for kw in ({}, {"max_tiles_per_group": 1}, {"max_group_pairs": 8}):
        jc, pc, jpairs = _jax_groups(5, 96, **kw)
        setup = setup_from_clip(random_clip_triangles(
            np.random.default_rng(5), 96), jc)
        lanes = torch.as_tensor(np.array(jrs.pack_setup_lanes(setup)))
        ppairs = prs.bin_groups(lanes, torch.as_tensor(np.array(setup.bbox)),
                                torch.as_tensor(np.array(setup.valid)), pc)
        for f in jrs.GroupBinnedPairs._fields:
            np.testing.assert_array_equal(getattr(ppairs, f).numpy(),
                                          np.asarray(getattr(jpairs, f)),
                                          err_msg=f"{kw} {f}")


def _jax_peel_groups(seed, n, **kw):
    """_jax_groups with the accum payload on the lanes and a peel band."""
    jc = JConfig(**{**KW, **kw})
    rng = np.random.default_rng(seed)
    setup = setup_from_clip(random_clip_triangles(rng, n), jc)
    lanes = jnp.asarray(with_payload(rng, jrs.pack_setup_lanes(setup)))
    jpairs = jrs.bin_groups(lanes, setup.bbox, setup.valid, jc)
    pc = PConfig(**{**KW, **kw})
    return jc, pc, jpairs, peel_band(rng, pc.padded_height, pc.padded_width)


@pytest.mark.parametrize("accum", [False, True])
def test_group_peel_and_accum_match_jax(accum):
    """K2's peel and accum modes vs the Pallas group kernel in interpret
    mode and vs the jitted reference, on random groups of which some take
    the global big-group list: vis and depth exact, peel channels as
    _compare, the 8 accum sums exact (the fused form of
    ops/raster.py::accum_weight, accum_add, added in K2's walk order)."""
    jc, pc, jpairs, band = _jax_peel_groups(0, 128, max_tiles_per_group=6,
                                            group_rows=8)
    assert int(jpairs.big_count) > 0 and int(jpairs.num_pairs) > 0
    jband = tuple(jnp.asarray(b) for b in band)
    jd, jv, jch = (np.asarray(x) for x in raster_tiles_pallas(
        jpairs, jc, interpret=True, peel=jband, accum=accum))
    rd, rv = (np.asarray(x) for x in jax.jit(
        lambda p, a, b: raster_tiles_ref(p, jc, peel=(a, b), accum=accum))(
            jpairs, *jband))
    pd, pv, pch = (x.numpy() for x in praster.raster_tiles(
        interop.group_binned_pairs(_np_fields(jpairs), device="cpu"), pc,
        peel=tuple(torch.as_tensor(b) for b in band), accum=accum))
    np.testing.assert_array_equal(pd, jd)
    np.testing.assert_array_equal(pd, rd)
    np.testing.assert_array_equal(pv, jv)
    if accum:
        np.testing.assert_array_equal(pch, jch)
        np.testing.assert_array_equal(pch, rv)
        assert (pch[7] > 1.5).mean() > 0.05
    else:
        np.testing.assert_array_equal(pv, rv)
        np.testing.assert_allclose(pch, jch, rtol=1e-6, atol=1e-6)
        assert 0.2 < (pv > 0).mean() < 0.95


def test_expanded_pairs_keep_the_walk_order():
    """The plain version's (row, tile) expansion lists each tile's own
    rows before its big-list rows, and only rows whose bbox covers the
    tile, in K2's walk order: per tile, each (group, tile) pair's rows in
    pair order, then each covering big group's rows in list order. The
    accum mode's sums are taken in this order, so the order is part of
    their value (test_group_peel_and_accum_match_jax)."""
    jc, pc, jpairs = _jax_groups(7, 64, max_tiles_per_group=1)
    pairs = interop.group_binned_pairs(_np_fields(jpairs), device="cpu")
    rows, offs = praster.expand_group_pairs(pairs, pc)
    assert offs[0] == 0 and offs[-1] == rows.shape[0]
    GR = pc.group_rows
    lanes = pairs.lanes.numpy()
    toffs = pairs.tile_offsets.numpy()
    for t in range(pc.num_tiles):
        r = rows[offs[t]:offs[t + 1]]
        tx, ty = t % pc.tiles_x, t // pc.tiles_x
        assert ((r[:, 11] <= tx) & (tx <= r[:, 12])
                & (r[:, 13] <= ty) & (ty <= r[:, 14])).all()
        walk = list(pairs.group_ids.numpy()[toffs[t]:toffs[t + 1]])
        for p in range(int(pairs.big_count)):
            bx, by = int(pairs.big_bx[p]), int(pairs.big_by[p])
            if bx // 2048 <= tx <= bx % 2048 and by // 2048 <= ty <= by % 2048:
                walk.append(int(pairs.big_ids[p]))
        want = [lanes[g * GR + j] for g in walk for j in range(GR)]
        want = [w for w in want
                if w[11] <= tx <= w[12] and w[13] <= ty <= w[14]]
        np.testing.assert_array_equal(r.numpy(),
                                      np.array(want).reshape(-1, 32))


def test_group_rows_must_tile_the_lanes():
    lanes = torch.zeros((40, 32))
    with pytest.raises(ValueError, match="group_rows"):
        prs.bin_groups(lanes, torch.zeros((40, 4), dtype=torch.int32),
                       torch.zeros(40, dtype=torch.bool), PConfig(**KW))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the group raster kernel is CUDA "
                    "C++ and has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seeded", [False, True])
def test_cuda_group_kernel_matches_plain(cuda_device, seeded):
    kw = dict(width=384, height=160, tile_h=32, tile_w=128, max_pairs=1 << 14,
              max_tiles_per_group=2, max_group_pairs=1 << 12)
    cfg = PConfig(**kw)

    def groups(seed, n):
        clip = torch.as_tensor(random_clip_triangles(
            np.random.default_rng(seed), n).reshape(-1, 4), device=cuda_device)
        idx = torch.arange(3 * n, dtype=torch.int32,
                           device=cuda_device).view(n, 3)
        lanes, bbox, valid, _ = prs.triangle_setup_packed(
            clip, idx, torch.ones(n, dtype=torch.bool, device=cuda_device),
            cfg, None, None)
        return prs.bin_groups(lanes, bbox, valid, cfg)

    init = praster.raster_groups_plain(groups(1, 256), cfg) if seeded else None
    pairs = groups(2, 512)
    before = praster.raster_groups_cuda.launches
    kd, kv, kch = praster.raster_tiles(pairs, cfg, init=init)
    torch.cuda.synchronize()
    assert praster.raster_groups_cuda.launches == before + 1
    pd, pv, pch = praster.raster_groups_plain(pairs, cfg, init=init)
    assert torch.equal(kv, pv)
    assert torch.equal(kd, pd)
    torch.testing.assert_close(kch, pch, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("accum", [False, True])
def test_cuda_group_peel_and_accum_match_plain(cuda_device, accum):
    """K2's peel and accum modes on the card vs the plain version: vis,
    depth and every channel exact."""
    kw = dict(width=384, height=160, tile_h=32, tile_w=128, max_pairs=1 << 14,
              max_tiles_per_group=2, max_group_pairs=1 << 12)
    cfg = PConfig(**kw)
    rng = np.random.default_rng(22)
    n = 512
    clip = torch.as_tensor(random_clip_triangles(rng, n).reshape(-1, 4),
                           device=cuda_device)
    idx = torch.arange(3 * n, dtype=torch.int32, device=cuda_device).view(n, 3)
    lanes, bbox, valid, _ = prs.triangle_setup_packed(
        clip, idx, torch.ones(n, dtype=torch.bool, device=cuda_device), cfg,
        None, None)
    lanes = torch.as_tensor(with_payload(rng, lanes.cpu().numpy()),
                            device=cuda_device)
    pairs = prs.bin_groups(lanes, bbox, valid, cfg)
    band = tuple(torch.as_tensor(b, device=cuda_device)
                 for b in peel_band(rng, cfg.padded_height, cfg.padded_width))
    mode = praster.MODE_LAUNCHES[("K2", "accum" if accum else "peel")]
    before = mode.launches
    kd, kv, kch = praster.raster_tiles(pairs, cfg, peel=band, accum=accum)
    torch.cuda.synchronize()
    assert mode.launches == before + 1
    pd, pv, pch = praster.raster_groups_plain(pairs, cfg, peel=band,
                                              accum=accum)
    assert torch.equal(kv, pv)
    assert torch.equal(kd, pd)
    assert torch.equal(kch, pch)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain+tangent", "seeded+tangent",
                                  "peel+tangent"])
def test_cuda_group_tangent_modes_match_plain(cuda_device, mode):
    """K2's tangent modes on the card vs the plain version: vis, depth and
    every channel exact, one launch of the mode."""
    pairs, cfg, kw, plain = seeded_and_tangent_case(cuda_device, "K2", mode)
    count = praster.MODE_LAUNCHES[("K2", mode)]
    before = count.launches
    kd, kv, kch = praster.raster_tiles(pairs, cfg, **kw)
    torch.cuda.synchronize()
    assert count.launches == before + 1
    pd, pv, pch = plain(pairs, cfg, **kw)
    assert torch.equal(kv, pv)
    assert torch.equal(kd, pd)
    assert torch.equal(kch, pch)
