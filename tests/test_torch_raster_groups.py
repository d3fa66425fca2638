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
import jax.numpy as jnp
import pytest
import torch

from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
from basicrenderer_tpu.ops import raster_setup as jrs
from basicrenderer_tpu.ops.raster_pallas import raster_tiles_pallas
from basicrenderer_tpu_torch import interop
from basicrenderer_tpu_torch.graph.framedata import FrameConfig as PConfig
from basicrenderer_tpu_torch.ops import raster as praster
from basicrenderer_tpu_torch.ops import raster_setup as prs

from tests.test_raster import random_clip_triangles, setup_from_clip

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


def test_expanded_pairs_keep_the_walk_order():
    """The plain version's (row, tile) expansion lists each tile's own
    rows before its big-list rows, and only rows whose bbox covers the
    tile."""
    jc, pc, jpairs = _jax_groups(7, 64, max_tiles_per_group=1)
    pairs = interop.group_binned_pairs(_np_fields(jpairs), device="cpu")
    rows, offs = praster.expand_group_pairs(pairs, pc)
    assert offs[0] == 0 and offs[-1] == rows.shape[0]
    for t in range(pc.num_tiles):
        r = rows[offs[t]:offs[t + 1]]
        tx, ty = t % pc.tiles_x, t // pc.tiles_x
        assert ((r[:, 11] <= tx) & (tx <= r[:, 12])
                & (r[:, 13] <= ty) & (ty <= r[:, 14])).all()


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
