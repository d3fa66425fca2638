"""Port attribute resolve (K6) vs the JAX package's Pallas resolve kernel,
run in interpret mode on the CPU as tests/test_resolve.py runs it, and
its jitted reference twin.

Scene: tests/test_resolve.py's (the golden scene of
tests/test_frame_e2e.py, 128x128, soup setup and per-triangle binning by
the JAX package). Both packages get the same BinnedPairs and vis buffer
(basicrenderer_tpu_torch.interop). The channels must be exactly equal:
the planes are evaluated in the form XLA gives the reference
(ops/raster.py::plane_eval). On group-binned pairs the plain version
follows the reference's group walk (the TPU kernel takes per-triangle
pairs only).

The CUDA kernel has no CPU mode: its comparison with the plain version is
marked `cuda` and skips without a card.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
from basicrenderer_tpu.ops import raster_setup as jrs
from basicrenderer_tpu.ops.raster_ref import raster_tiles_ref
from basicrenderer_tpu.ops.resolve_pallas import (resolve_attributes_pallas,
                                                  resolve_attributes_ref)
from basicrenderer_tpu_torch import interop
from basicrenderer_tpu_torch.graph.framedata import FrameConfig as PConfig
from basicrenderer_tpu_torch.ops import raster as praster
from basicrenderer_tpu_torch.ops import raster_setup as prs
from basicrenderer_tpu_torch.ops import resolve as presolve

from tests.test_raster import random_clip_triangles, setup_from_clip
from tests.test_resolve import CFG, _setup_scene_frame

KW = dict(width=128, height=128, tile_h=16, tile_w=128, max_pairs=1 << 12)


def _np_fields(nt):
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


@pytest.fixture(scope="module")
def scene():
    """(JAX pairs, vis, port pairs, port vis) of tests/test_resolve.py's
    scene."""
    _, _, _, pairs, _, vis_p, _, _ = _setup_scene_frame()
    return (pairs, vis_p,
            interop.binned_pairs(_np_fields(pairs), device="cpu"),
            torch.as_tensor(np.array(vis_p)))


def test_resolve_plain_matches_pallas_interpret_and_ref(scene):
    pairs, vis_p, ppairs, pvis = scene
    ch_pl = np.asarray(resolve_attributes_pallas(pairs, vis_p, CFG,
                                                 interpret=True))
    ch_ref = np.asarray(jax.jit(
        lambda p, v: resolve_attributes_ref(p, v, CFG))(pairs, vis_p))
    got = presolve.resolve_attributes(ppairs, pvis, PConfig(**KW)).numpy()
    np.testing.assert_array_equal(got, ch_pl)
    np.testing.assert_array_equal(got, ch_ref)
    assert (got[4] > 0).mean() > 0.3 and not got[5:].any()


def test_resolve_equals_the_fused_channels(scene):
    """K1 fuses this resolve into its raster: on the same pairs its
    channels 0-4 are the resolve's (ids are unique per row here)."""
    _pairs, _vis, ppairs, pvis = scene
    _, vis, fused = praster.raster_tiles(ppairs, PConfig(**KW))
    assert torch.equal(vis, pvis)
    np.testing.assert_array_equal(
        presolve.resolve_attributes(ppairs, vis, PConfig(**KW)).numpy(),
        fused.numpy())


def test_resolve_plain_on_group_pairs_matches_ref():
    """Group-binned pairs (with groups on the big list): the reference's
    group walk, every row of every pair and big group, no box tests."""
    kw = dict(width=256, height=64, tile_h=16, tile_w=128, max_pairs=1 << 12,
              max_group_pairs=1 << 10, max_tiles_per_group=6, group_rows=8)
    jc = JConfig(**kw)
    rng = np.random.default_rng(0)
    setup = setup_from_clip(random_clip_triangles(rng, 128), jc)
    # Random attribute planes and material combos (the soup setup of
    # random clip triangles carries none).
    lanes = np.array(jrs.pack_setup_lanes(setup))
    lanes[:, 15:27] = rng.normal(size=(lanes.shape[0], 12)) * 0.01
    lanes[:, 10] = rng.integers(1, 50, lanes.shape[0])
    jpairs = jrs.bin_groups(jax.numpy.asarray(lanes), setup.bbox,
                            setup.valid, jc)
    assert int(jpairs.big_count) > 0 and int(jpairs.num_pairs) > 0
    _, vis = raster_tiles_ref(jpairs, jc)
    ch_ref = np.asarray(jax.jit(
        lambda p, v: resolve_attributes_ref(p, v, jc))(jpairs, vis))
    got = presolve.resolve_attributes(
        interop.group_binned_pairs(_np_fields(jpairs), device="cpu"),
        torch.as_tensor(np.array(vis)), PConfig(**kw)).numpy()
    np.testing.assert_array_equal(got, ch_ref)
    assert (got[4] > 0).mean() > 0.2


def test_resolve_tangent_mode_raises(scene):
    """The tangent mode is ported (it raised before): with a random
    tangent angle per triangle in lane 27 (the same on each of its pair
    rows), channel 5 takes the matching row's lane 27, equal to the Pallas
    kernel in interpret mode and to the jitted reference twin; the other
    channels are unchanged."""
    pairs, vis_p, ppairs, pvis = scene
    rng = np.random.default_rng(7)
    pd = np.array(pairs.pair_data)
    angle = rng.uniform(-np.pi, 5 * np.pi, int(pd[:, 9].max()) + 1)
    pd[:, 27] = np.where(pd[:, 9] > 0.5, angle[pd[:, 9].astype(np.int64)], 0)
    tpairs = pairs._replace(pair_data=jax.numpy.asarray(pd))
    tcfg = dataclasses.replace(CFG, enable_vertex_tangents=True)
    ch_pl = np.asarray(resolve_attributes_pallas(tpairs, vis_p, tcfg,
                                                 interpret=True))
    ch_ref = np.asarray(jax.jit(
        lambda p, v: resolve_attributes_ref(p, v, tcfg))(tpairs, vis_p))
    got = presolve.resolve_attributes(
        interop.binned_pairs(_np_fields(tpairs), device="cpu"), pvis,
        PConfig(**KW, enable_vertex_tangents=True)).numpy()
    np.testing.assert_array_equal(got, ch_pl)
    np.testing.assert_array_equal(got, ch_ref)
    covered = np.asarray(vis_p) > 0
    assert (got[5][covered] != 0).all() and not got[5][~covered].any()
    plain = presolve.resolve_attributes(ppairs, pvis, PConfig(**KW)).numpy()
    np.testing.assert_array_equal(np.delete(got, 5, 0), np.delete(plain, 5, 0))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the resolve kernel is CUDA C++ "
                    "and has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tangent", [False, True])
def test_cuda_resolve_matches_plain(cuda_device, tangent):
    """K6 on the card vs the plain version, on a raster's own vis with
    the big list in use, then on a random vis drawn from every row's id
    (other tiles' too), zero and -1: every channel exact."""
    rng = np.random.default_rng(23)
    n = 400
    clip = torch.as_tensor(random_clip_triangles(rng, n).reshape(-1, 4),
                           device=cuda_device)
    cfg = PConfig(width=384, height=160, tile_h=32, tile_w=128,
                  max_pairs=1 << 14, max_tiles_per_tri=4,
                  enable_vertex_tangents=tangent)
    idx = torch.arange(3 * n, dtype=torch.int32, device=cuda_device).view(n, 3)
    lanes, bbox, valid, _ = prs.triangle_setup_packed(
        clip, idx, torch.ones(n, dtype=torch.bool, device=cuda_device), cfg,
        None, None)
    lanes[:, 27] = torch.where(lanes[:, 9] > 0.5, torch.as_tensor(
        rng.uniform(-np.pi, 5 * np.pi, lanes.shape[0]).astype(np.float32),
        device=cuda_device), 0.0)
    pairs = prs.bin_pairs(lanes, bbox, valid, cfg)
    assert int(pairs.big_count) > 0
    _, vis, fused = praster.raster_tiles(pairs, cfg)
    before = presolve.resolve_attributes_cuda.launches
    got = presolve.resolve_attributes(pairs, vis, cfg)
    torch.cuda.synchronize()
    assert presolve.resolve_attributes_cuda.launches == before + 1
    assert torch.equal(got, presolve.resolve_attributes_plain(pairs, vis, cfg))
    assert torch.equal(got, fused)
    live = int(pairs.tile_offsets[-1])
    pool = np.concatenate([pairs.pair_data[:live, 9].cpu().numpy()
                           .astype(np.int32), [0, -1]])
    rvis = torch.as_tensor(rng.choice(pool, tuple(vis.shape)),
                           dtype=torch.int32, device=cuda_device)
    got = presolve.resolve_attributes(pairs, rvis, cfg)
    assert torch.equal(got, presolve.resolve_attributes_plain(pairs, rvis,
                                                              cfg))
    assert bool((got[4] != 0).any())
