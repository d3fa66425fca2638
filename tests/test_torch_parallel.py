"""Tile sharding of the port (basicrenderer_tpu_torch/parallel/
tile_sharding.py) against the JAX package's, on the CPU: the port's
ranks are spawned processes in a gloo group, the JAX package's shards
virtual CPU devices (tests/conftest.py).

- World size 1 (a one-rank gloo group in this process) equals the
  single-card frame bit for bit.
- The port sharded over 2 ranks equals the JAX package's
  build_sharded_frame_fn over 2 devices, at 128x128 and at 128x120 (both
  render 128 rows: the last band holds the padded rows).
- tests/test_parallel.py's cases (the full-feature frame, TAA history
  fed back, 4 ranks, two VSM steps, the streaming feedback, OIT), each
  sharded in the port and held to the JAX single-device frame with
  tests/test_parallel.py's `_assert_match`.
- Where the port's shards exchange halo rows (normal maps, anisotropy,
  the IBL and voxel upsamples, the TAA clamp), 2 ranks render the port's
  single-card frame bit for bit, and are held to the JAX single-device
  frame.
- On shards that are not whole sampler blocks (textures and an
  alpha-MASK pass at 128x96), both packages' sharded frames depart from
  their single-device frames, and the port's matches the JAX package's.
- The halo upsample and mip estimate are seam-exact across 2 ranks.

One 2-rank spawn runs every 2-rank case and one 4-rank spawn the other,
while six processes compute the JAX references."""

import dataclasses
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import jax
import pytest
import torch
from jax.sharding import Mesh

from basicrenderer_tpu.graph.frame import build_frame_fn as j_build_frame_fn
from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
from basicrenderer_tpu.graph.framedata import FrameParams as JParams
from basicrenderer_tpu.graph.framedata import make_view as j_make_view
from basicrenderer_tpu.parallel.tile_sharding import \
    build_sharded_frame_fn as j_build_sharded_frame_fn
from basicrenderer_tpu_torch.graph import frame as pframe
from basicrenderer_tpu_torch.graph.framedata import FrameConfig
from basicrenderer_tpu_torch.parallel import tile_sharding as ts

from tests import torch_parallel_ranks as ranks
from tests.test_parallel import _assert_match
from tests.test_torch_bridge import JAX_PKG

TWO_RANKS = ("basic", "basic_120", "full", "taa", "vsm", "streaming", "oit",
             "seams", "seams_full_rate", "seams_voxel", "masked", "halo")
FOUR_RANKS = ("basic_64",)
AGAINST_SINGLE = ("full", "taa", "vsm", "streaming", "oit", "basic_64")


def jax_frames(name, shards=None):
    """Case `name` of torch_parallel_ranks.CASES through the JAX package:
    jax.jit of build_frame_fn, or of build_sharded_frame_fn over the
    first `shards` devices; the last frame's outputs as numpy."""
    from basicrenderer_tpu.ops import vsm as jvsm
    scene = ranks.CASES[name][0]
    if scene == "streaming":
        from tests.test_torch_cluster_frame import wait_for_jax_native
        wait_for_jax_native()
    sc, bridge, fields, frames = ranks.case_scene(JAX_PKG, name)
    cfg = JConfig(**fields, use_pallas_raster=False)
    buf = bridge.build_scene_buffers()
    if scene == "voxel":
        buf = buf.replace(tri_object=jax.numpy.full_like(buf.tri_object, -1))
    view = j_make_view(*sc.camera_matrices(aspect=cfg.width / cfg.height))
    fn = jax.jit(j_build_frame_fn(cfg) if shards is None else
                 j_build_sharded_frame_fn(
                     cfg, Mesh(np.array(jax.devices()[:shards]), ("sp",))))
    hist = None
    st = jvsm.init_state() if cfg.enable_vsm else None
    for _ in range(frames):
        out = fn(buf, view, JParams.default(), None, hist, st)
        hist = out["taa_out"] if cfg.enable_taa else None
        st = out.get("vsm_state")
    return {k: np.asarray(v) for k, v in out.items() if k != "vsm_state"
            and k != "vsm_stats"}


# The JAX references, in six processes (their tracing holds the GIL, so
# threads would not overlap them): (case, shards) pairs, slowest first.
JAX_GROUPS = ((("seams", None),),
              (("full", None), ("streaming", None)),
              (("seams_full_rate", None), ("masked", None), ("masked", 2)),
              (("vsm", None), ("basic_64", None), ("seams_voxel", None)),
              (("oit", None), ("taa", None)),
              (("basic", 2), ("basic_120", 2)))


def _jax_group(group):
    jax.config.update("jax_platforms", "cpu")
    return [jax_frames(name, shards) for name, shards in group]


@pytest.fixture(scope="module")
def runs():
    """{"port": {case: rank 0's assembled outputs}, "jax": {case: the
    JAX single-device frame}, "jax_sharded": {case: the JAX frame over 2
    devices}}: the two spawns and the JAX references run at once."""
    ctx = multiprocessing.get_context("spawn")
    with ThreadPoolExecutor(2) as threads, \
            ProcessPoolExecutor(len(JAX_GROUPS), mp_context=ctx) as procs:
        two = threads.submit(ts.run_ranks, ranks.run_cases, 2, "gloo", "cpu",
                             TWO_RANKS)
        four = threads.submit(ts.run_ranks, ranks.run_cases, 4, "gloo",
                              "cpu", FOUR_RANKS)
        refs = {}
        for group, outs in zip(JAX_GROUPS, procs.map(_jax_group, JAX_GROUPS)):
            for (name, shards), out in zip(group, outs):
                refs["jax" if shards is None else "jax_sharded",
                     name] = out
        return {"port": {**two.result()[0], **four.result()[0]},
                "jax": {n: o for (kind, n), o in refs.items()
                        if kind == "jax"},
                "jax_sharded": {n: o for (kind, n), o in refs.items()
                                if kind == "jax_sharded"}}


def test_world_size_one_equals_single_card(tmp_path):
    """A one-rank group (gloo, in this process) renders what
    build_frame_fn renders, bit for bit."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        sharded = ranks.port_frames("basic", ts.build_sharded_frame_fn)
        whole = ts.assemble(sharded)
    finally:
        dist.destroy_process_group()
    single = ranks.port_frames("basic", pframe.build_frame_fn)
    assert sorted(whole) == sorted(single)
    for k in ts._SHARDED_KEYS:
        assert torch.equal(whole[k], single[k]), k


@pytest.mark.parametrize("name", ["basic", "basic_120"])
def test_sharded_matches_jax_sharded(runs, name):
    """The slice as a whole: 2 ranks of the port against the JAX
    package's sharded frame over 2 devices. At 128x120 both render the
    128 rows of the tile grid."""
    port, jout = runs["port"][name], runs["jax_sharded"][name]
    assert port["image"].shape == jout["image"].shape == (128, 128, 3)
    _assert_match(port, jout)


@pytest.mark.parametrize("name", AGAINST_SINGLE)
def test_sharded_matches_jax_single_device(runs, name):
    """tests/test_parallel.py's cases in the port (4 ranks for
    basic_64, 2 for the others) against the JAX single-device frame:
    vis equal, depth within 1e-5, the image at most 1 apart on under 1%
    of the pixels."""
    port, jout = runs["port"][name], runs["jax"][name]
    _assert_match(port, jout)
    assert port["image"].shape == jout["image"].shape
    if name == "streaming":
        np.testing.assert_allclose(port["touched_groups"],
                                   jout["touched_groups"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(port["tex_wanted"], jout["tex_wanted"])
    if name == "oit":
        assert "oit_overflow" in port["keys"]
    if name == "taa":
        assert port["image"].std() > 10


@pytest.mark.parametrize("name", ranks.AGAINST_PORT)
def test_sharded_equals_single_card_at_the_seams(runs, name):
    """Where a shard's per-pixel work reads its neighbours' rows (normal
    maps and anisotropy by screen derivatives, the IBL's and the voxel
    fallback's upsample, the TAA clamp over a changing history, the
    full-rate sampler's mip estimate) the port exchanges halo rows: 2
    ranks render the port's single-card frame bit for bit. (The JAX
    package's sharded frame differs at the seam rows there.)"""
    port = runs["port"][name]
    for k, v in port["single"].items():
        np.testing.assert_array_equal(port["sharded"][k], v, err_msg=k)


def _rmse(a, b):
    return float(np.sqrt(np.mean((a.astype(np.float32)
                                  - b.astype(np.float32)) ** 2)))


@pytest.mark.parametrize("name", ranks.AGAINST_PORT)
def test_sharded_seams_match_jax_single_device(runs, name):
    """The seam cases, whose halo rows depart from the JAX package's
    sharded frame, held to the JAX single-device frame: vis equal, depth
    within 1e-5. The image: `_assert_match` for the voxel fallback; with
    normal maps, anisotropy, IBL, GTAO, bloom and SSR the port's
    single-card frame itself (which these shards equal bit for bit) sits
    up to 2 apart from the JAX frame on more than 1% of the pixels
    (rounding spread over those passes), so there the image is held to
    at most 2 apart and an RMSE of 1.0 (0-255), the level of
    tests/test_torch_full_frame.py and tests/test_torch_openpbr.py."""
    port, jout = runs["port"][name], runs["jax"][name]
    assert port["image"].shape == jout["image"].shape
    if name == "seams_voxel":
        _assert_match(port, jout)
        return
    np.testing.assert_array_equal(port["vis"], jout["vis"])
    np.testing.assert_allclose(port["depth"], jout["depth"], rtol=1e-5,
                               atol=1e-6)
    diff = np.abs(port["image"].astype(np.int32)
                  - jout["image"].astype(np.int32))
    assert diff.max() <= 2
    assert _rmse(port["image"], jout["image"]) <= 1.0


def test_misaligned_sampler_blocks_match_jax_sharded(runs):
    """Textures with an alpha-MASK pass at texture_downscale 2 on 48-row
    shards (128x96, tile_h 16, 2 ranks): each shard's 24 sampling rows
    are not whole 16-row sampler blocks, so the blocks regroup at the
    seam, their mips change and the mask keeps other texels. The JAX
    package's sharded frame does the same: it departs from its
    single-device frame, and the port's sharded frame matches it at the
    port's alpha-MASK parity level (vis equal on >= 99.9% of the pixels:
    a texel whose sampled alpha sits at the cutoff can flip,
    tests/test_torch_full_frame.py; image RMSE <= 1.0 where vis agrees)."""
    port = runs["port"]["masked"]
    jsh, jone = runs["jax_sharded"]["masked"], runs["jax"]["masked"]
    assert port["image"].shape == jsh["image"].shape == (96, 128, 3)
    assert int((jsh["vis"] != jone["vis"]).sum()) > 50
    agree = port["vis"] == jsh["vis"]
    assert agree.mean() >= 0.999, agree.mean()
    assert _rmse(port["image"][agree], jsh["image"][agree]) <= 1.0


def test_halo_upsample_is_seam_exact(runs):
    """frame.halo_upsample over 2 ranks, gathered, equals the whole
    image's bilinear resize bit for bit (the seam and the frame's edge
    rows included)."""
    h = runs["port"]["halo"]
    np.testing.assert_array_equal(h["up"], h["up_whole"])


def test_halo_mipf_is_seam_exact(runs):
    """frame.halo_mipf over 2 ranks, gathered, equals the whole frame's
    mip estimate bit for bit (the sampler's estimate on one card)."""
    h = runs["port"]["halo"]
    np.testing.assert_array_equal(h["mipf"], h["mipf_whole"])


@pytest.mark.parametrize("grouped", [False, True], ids=["K1", "K2"])
def test_plain_raster_on_a_band_equals_the_whole_frame(grouped):
    """K1's and K2's plain versions on a shard's band of tile rows (its
    slice of the tile offsets, at tile_row0 5) give the whole frame's
    rows of those tiles, plain and seeded: the pairs of the tiles above
    the band (before the slice's first offset) stay out of its walk."""
    from basicrenderer_tpu_torch.ops import raster, raster_setup
    cfg = FrameConfig(width=256, height=256, tile_h=16, tile_w=128,
                      max_pairs=1 << 14, max_group_pairs=1 << 12)
    rng = np.random.default_rng(3)
    n = 512          # 1,024 setup rows with the near-clip slots: 32 groups
    # Small triangles in screen-row order, so that most groups bin into
    # the tiles of a row or two, above, in and below the band.
    centre = np.stack([rng.uniform(-0.9, 0.9, n),
                       np.sort(rng.uniform(-0.9, 0.9, n))], -1)
    xy = centre[:, None, :] + rng.uniform(-0.08, 0.08, (n, 3, 2))
    w = rng.uniform(2.0, 10.0, (n, 3, 1))
    clip = np.concatenate([xy * w, rng.uniform(0.05, 0.95, (n, 3, 1)) * w,
                           w], -1)
    lanes, bbox, valid, _ = raster_setup.triangle_setup_packed(
        torch.as_tensor(clip.reshape(-1, 4), dtype=torch.float32),
        torch.arange(3 * n, dtype=torch.int32).view(n, 3),
        torch.ones(n, dtype=torch.bool), cfg, None, None)
    bin_fn, plain = ((raster_setup.bin_groups, raster.raster_groups_plain)
                     if grouped else
                     (raster_setup.bin_pairs, raster.raster_tiles_plain))
    pairs = bin_fn(lanes, bbox, valid, cfg)
    whole = plain(pairs, cfg)
    seeded = plain(pairs, cfg, 0, whole)
    r0, rows = 5, 8
    t0 = r0 * cfg.tiles_x
    band = pairs._replace(tile_offsets=pairs.tile_offsets[
        t0:t0 + rows * cfg.tiles_x + 1])
    bcfg = dataclasses.replace(cfg, height=rows * cfg.tile_h)
    px = slice(r0 * cfg.tile_h, (r0 + rows) * cfg.tile_h)
    assert int(pairs.tile_offsets[t0]) > 0
    for want, init in ((whole, None), (seeded, whole)):
        got = plain(band, bcfg, r0, None if init is None else tuple(
            x[..., px, :].contiguous() for x in init))
        for g, wnt in zip(got, want):
            torch.testing.assert_close(g, wnt[..., px, :], rtol=0, atol=0)
    assert int((whole[1][px] > 0).sum()) > 0


@pytest.mark.parametrize("fields,shards", [
    (dict(height=112), 2),                      # 7 tile rows
    (dict(enable_taa=True, output_width=256, output_height=256), 2),
])
def test_check_config_sharded_rules(fields, shards):
    """A sharded frame needs its tile rows to divide evenly and renders
    no TAAU."""
    cfg = FrameConfig(**dict(ranks.BASE, **fields))
    pframe.check_config(cfg)
    with pytest.raises(ValueError):
        pframe.check_config(cfg, shards=shards)
