"""Port raster vs the JAX package's Pallas tile rasterizer (run in interpret
mode on the CPU, as tests/test_raster_pallas.py runs it).

Both are fed the same BinnedPairs: the JAX package's own, carried across
with basicrenderer_tpu_torch.interop. `vis` and `depth` must be exactly
equal (the port evaluates planes in the form XLA gives the reference,
ops/raster.py::plane_eval); the channels are allclose at rtol 1e-6,
atol 1e-6 (the same plane form, but a tolerance keeps the test about the
algorithm rather than the last ulp of the interpolated attributes).

The CUDA kernel has no CPU mode: its comparison with the plain version
is marked `cuda` and skips without a card.
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


def _np_fields(nt):
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


def _jax_pairs(clip_tris, **kw):
    jc = JConfig(**kw)
    setup = setup_from_clip(clip_tris, jc)
    return jc, PConfig(**kw), jrs.bin_triangles(setup, jc)


def _compare(jc, pc, jpairs):
    jd, jv, jch = (np.asarray(x) for x in
                   raster_tiles_pallas(jpairs, jc, interpret=True))
    pd, pv, pch = (x.numpy() for x in praster.raster_tiles(
        interop.binned_pairs(_np_fields(jpairs), device="cpu"), pc))
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pd, jd)
    np.testing.assert_allclose(pch, jch, rtol=1e-6, atol=1e-6)
    return pv


@pytest.mark.parametrize("seed", [0, 5])
def test_plain_matches_pallas_interpret(seed):
    rng = np.random.default_rng(seed)
    jc, pc, jpairs = _jax_pairs(random_clip_triangles(rng, 60), width=256,
                                height=64, tile_h=16, tile_w=128,
                                max_pairs=1 << 12)
    vis = _compare(jc, pc, jpairs)
    assert (vis > 0).mean() > 0.2


def test_plain_matches_pallas_interpret_big_list():
    """max_tiles_per_tri=2 sends most triangles through the global
    big-triangle list, which the kernels walk with the bbox test."""
    rng = np.random.default_rng(11)
    jc, pc, jpairs = _jax_pairs(random_clip_triangles(rng, 30), width=256,
                                height=64, tile_h=16, tile_w=128,
                                max_pairs=1 << 12, max_tiles_per_tri=2)
    assert int(jpairs.big_count) > 0
    _compare(jc, pc, jpairs)


def test_plain_matches_pallas_interpret_empty_scene():
    clip_tris = np.zeros((4, 3, 4), np.float32)
    clip_tris[..., 3] = 1.0  # degenerate tris at origin, all culled
    jc, pc, jpairs = _jax_pairs(clip_tris, width=128, height=32, tile_h=16,
                                tile_w=128, max_pairs=256)
    vis = _compare(jc, pc, jpairs)
    assert vis.max() == 0


def test_plane_eval_is_the_contracted_form():
    """plane_eval rounds b*py to f32 first, then adds a*px exactly before a
    single f32 rounding, then adds c in f32: the fma(a, px, b*py) + c
    form. Checked against an exact rational evaluation of that form."""
    from fractions import Fraction
    rng = np.random.default_rng(2)
    a, b, c = (rng.normal(size=200).astype(np.float32) * 7 for _ in range(3))
    px = (rng.integers(0, 1920, 200) + 0.5).astype(np.float32)
    py = (rng.integers(0, 1080, 200) + 0.5).astype(np.float32)
    got = praster.plane_eval(*(torch.as_tensor(v) for v in (a, b, c, px, py)))
    for i in range(200):
        bpy = np.float32(b[i] * py[i])
        exact = Fraction(float(a[i])) * Fraction(float(px[i])) + Fraction(float(bpy))
        want = np.float32(np.float32(float(exact)) + c[i])
        assert got[i].item() == want, i


def test_unported_modes_raise():
    """Every mode of K1 is ported now (the seeded and tangent modes were
    the last to raise): on an empty scene each returns its starting
    buffers, and a seeded raster still refuses a peel band."""
    cfg = PConfig(width=128, height=32, tile_h=16, tile_w=128)
    pairs = prs.BinnedPairs(torch.zeros((256, 32)),
                            torch.full((2,), 256, dtype=torch.int32),
                            *(torch.zeros((), dtype=torch.int32),) * 3)
    img = torch.zeros((32, 128))
    rng = np.random.default_rng(1)
    init = (torch.as_tensor(rng.uniform(0, 1, (32, 128)).astype(np.float32)),
            torch.as_tensor(rng.integers(0, 9, (32, 128)).astype(np.int32)),
            torch.as_tensor(rng.normal(size=(8, 32, 128)).astype(np.float32)))
    for c in (cfg, PConfig(width=128, height=32, tile_h=16, tile_w=128,
                           enable_vertex_tangents=True)):
        d, v, ch = praster.raster_tiles(pairs, c, init=init)
        assert all(torch.equal(x, y) for x, y in zip((d, v, ch), init))
    tcfg = PConfig(width=128, height=32, tile_h=16, tile_w=128,
                   enable_vertex_tangents=True)
    d, v, ch = praster.raster_tiles(pairs, tcfg)
    assert not d.any() and not v.any() and not ch.any()
    with pytest.raises(ValueError, match="neither peel nor accum"):
        praster.raster_tiles(pairs, cfg, init=init, peel=(img, img))
    # The peeled and accum modes: on an empty scene they return their
    # starting buffers.
    seed = torch.full((32, 128), 0.25)
    d, v, ch = praster.raster_tiles(pairs, cfg, peel=(seed, img))
    assert torch.equal(d, seed) and not v.any() and not ch.any()
    d, v, ch = praster.raster_tiles(pairs, cfg, accum=True)
    assert not d.any() and not v.any() and not ch.any()


def with_payload(rng, rows):
    """Random accum payload bytes on the live rows (lanes 28, 30, 31, as
    ops/oit.py packs them), zeros on dead rows."""
    rows = np.array(rows)
    n = rows.shape[0]
    live = rows[:, 9] > 0.5
    a8 = rng.integers(0, 256, n)
    od = rng.integers(0, 256, (n, 3))
    col = rng.integers(0, 256, (n, 3))
    rows[:, 30] = np.where(live, a8 + od[:, 0] * 256.0 + od[:, 1] * 65536.0, 0)
    rows[:, 31] = np.where(live, od[:, 2], 0)
    rows[:, 28] = np.where(live, col[:, 0] + col[:, 1] * 256.0
                           + col[:, 2] * 65536.0, 0)
    return rows.astype(np.float32)


def peel_band(rng, H, W):
    """A random seed depth and peel bound (H, W): the bound is +inf on a
    band of columns (a first layer) and 0 on a band of rows (nothing
    left to peel there)."""
    seed = rng.uniform(0.0, 0.3, (H, W)).astype(np.float32)
    bound = rng.uniform(0.4, 1.0, (H, W)).astype(np.float32)
    bound[:, :40] = np.inf
    bound[-5:] = 0.0
    return seed, bound


def _peel_pairs(seed, n, **kw):
    rng = np.random.default_rng(seed)
    jc, pc, jpairs = _jax_pairs(random_clip_triangles(rng, n), **kw)
    jpairs = jpairs._replace(pair_data=jnp.asarray(
        with_payload(rng, jpairs.pair_data)))
    band = peel_band(rng, pc.padded_height, pc.padded_width)
    return jc, pc, jpairs, band


PEEL_CASES = {
    "binned": (3, 200, dict(width=256, height=64, tile_h=16, tile_w=128,
                            max_pairs=1 << 12)),
    "big_list": (4, 60, dict(width=256, height=64, tile_h=16, tile_w=128,
                             max_pairs=1 << 12, max_tiles_per_tri=2)),
}


@pytest.mark.parametrize("case", list(PEEL_CASES))
def test_peel_mode_matches_jax(case):
    """Peeled mode vs the Pallas kernel in interpret mode and vs the
    jitted reference: vis and depth exact, channels as _compare."""
    seed, n, kw = PEEL_CASES[case]
    jc, pc, jpairs, band = _peel_pairs(seed, n, **kw)
    if case == "big_list":
        assert int(jpairs.big_count) > 0
    jband = tuple(jnp.asarray(b) for b in band)
    jd, jv, jch = (np.asarray(x) for x in raster_tiles_pallas(
        jpairs, jc, interpret=True, peel=jband))
    rd, rv = (np.asarray(x) for x in jax.jit(
        lambda p, s, b: raster_tiles_ref(p, jc, peel=(s, b)))(jpairs, *jband))
    pd, pv, pch = (x.numpy() for x in praster.raster_tiles(
        interop.binned_pairs(_np_fields(jpairs), device="cpu"), pc,
        peel=tuple(torch.as_tensor(b) for b in band)))
    for want_d, want_v in ((jd, jv), (rd, rv)):
        np.testing.assert_array_equal(pv, want_v)
        np.testing.assert_array_equal(pd, want_d)
    np.testing.assert_allclose(pch, jch, rtol=1e-6, atol=1e-6)
    assert 0.2 < (pv > 0).mean() < 0.95
    assert (pd >= band[0]).all()


@pytest.mark.parametrize("case", list(PEEL_CASES))
def test_accum_mode_matches_jax_reference(case):
    """Accum mode over a peel band vs the jitted reference
    (raster_ref.raster_tiles_ref(accum=True)): depth exact (the seed), the
    8 sums exact. XLA's CPU backend fuses the weight u*u + 0.05 and each
    channel's sum + w*v into fused multiply-adds; the plain version spells
    that form (ops/raster.py::accum_weight, accum_add), which differs from
    the separate roundings on ~3% of the pixels."""
    seed, n, kw = PEEL_CASES[case]
    jc, pc, jpairs, band = _peel_pairs(seed, n, **kw)
    jband = tuple(jnp.asarray(b) for b in band)
    rd, racc = (np.asarray(x) for x in jax.jit(
        lambda p, s, b: raster_tiles_ref(p, jc, peel=(s, b), accum=True))(
            jpairs, *jband))
    pd, pv, pch = (x.numpy() for x in praster.raster_tiles(
        interop.binned_pairs(_np_fields(jpairs), device="cpu"), pc,
        peel=tuple(torch.as_tensor(b) for b in band), accum=True))
    np.testing.assert_array_equal(pd, rd)
    np.testing.assert_array_equal(pch, racc)
    assert not pv.any()
    assert (pch[7] > 1.5).mean() > 0.05          # fragments pile up
    assert (pch[0] > 0).any() and (pch[4:7] > 0).any()


def accum_form_mismatches(case="binned"):
    """Pixels (of each of the 8 accum channels) where the plain version
    with each candidate rounding of the weight u*u + 0.05 and of the sums
    chan + w*v differs from the jitted reference: the fused forms (the
    plain version's), the weight rounded apart, the sums rounded apart,
    both apart."""
    seed, n, kw = PEEL_CASES[case]
    jc, pc, jpairs, band = _peel_pairs(seed, n, **kw)
    jband = tuple(jnp.asarray(b) for b in band)
    _, racc = jax.jit(lambda p, s, b: raster_tiles_ref(
        p, jc, peel=(s, b), accum=True))(jpairs, *jband)
    racc = np.asarray(racc)
    pairs = interop.binned_pairs(_np_fields(jpairs), device="cpu")
    band_t = tuple(torch.as_tensor(b) for b in band)

    def w_apart(z, seed_d, bound):
        u = torch.clamp((z - seed_d) / torch.clamp(bound - seed_d, min=1e-6),
                        0.0, 1.0)
        return u * u + torch.tensor(0.05, dtype=torch.float32)

    def add_apart(chan, w, v):
        return chan + w * v
    forms = {"fused": (praster.accum_weight, praster.accum_add),
             "weight apart": (w_apart, praster.accum_add),
             "sums apart": (praster.accum_weight, add_apart),
             "both apart": (w_apart, add_apart)}
    out = {}
    saved = praster.accum_weight, praster.accum_add
    try:
        for name, (wf, af) in forms.items():
            praster.accum_weight, praster.accum_add = wf, af
            ch = praster.raster_tiles(pairs, pc, peel=band_t,
                                      accum=True)[2].numpy()
            out[name] = [int((ch[c] != racc[c]).sum()) for c in range(8)]
    finally:
        praster.accum_weight, praster.accum_add = saved
    return out


def test_accum_rounding_is_xlas_fused_form():
    """Only the fused multiply-add form of the accum sums matches the
    jitted reference; each separately rounded form differs on some
    pixels of the weighted channels 0-3 (4-7 add exact products)."""
    counts = accum_form_mismatches()
    assert counts["fused"] == [0] * 8, counts
    for name in ("weight apart", "sums apart", "both apart"):
        assert min(counts[name][:4]) > 0 and counts[name][4:] == [0] * 4, \
            counts


def test_accum_mode_without_band_matches_jax_reference():
    """Accum mode with no peel band: every fragment in front of depth 0,
    weight 1."""
    seed, n, kw = PEEL_CASES["binned"]
    jc, pc, jpairs, _ = _peel_pairs(seed, n, **kw)
    rd, racc = (np.asarray(x) for x in jax.jit(
        lambda p: raster_tiles_ref(p, jc, accum=True))(jpairs))
    pd, _pv, pch = (x.numpy() for x in praster.raster_tiles(
        interop.binned_pairs(_np_fields(jpairs), device="cpu"), pc,
        accum=True))
    np.testing.assert_array_equal(pd, rd)
    np.testing.assert_array_equal(pch, racc)


def test_pallas_accum_walks_from_the_slab():
    """The Pallas K1 starts each tile's walk at the 128-row DMA slab below
    its range. For the depth test the earlier tiles' rows in that slab are
    harmless; for a sum they count again, so its accum mode differs from
    its reference twin. The port follows the reference; given the Pallas
    kernel's own walk (each tile's range widened down to its slab) its
    plain version equals the Pallas kernel's sums exactly."""
    seed, n, kw = PEEL_CASES["binned"]
    jc, pc, jpairs, band = _peel_pairs(seed, n, **kw)
    jband = tuple(jnp.asarray(b) for b in band)
    _, _, jacc = (np.asarray(x) for x in raster_tiles_pallas(
        jpairs, jc, interpret=True, peel=jband, accum=True))
    pd_np = np.asarray(jpairs.pair_data)
    offs = np.asarray(jpairs.tile_offsets)
    nbig = jc.max_big_tris
    rows, widened = [pd_np[:nbig]], [nbig]
    for t in range(pc.num_tiles):
        rows.append(pd_np[offs[t] // 128 * 128:offs[t + 1]])
        widened.append(widened[-1] + rows[-1].shape[0])
    slab_pairs = prs.BinnedPairs(
        torch.as_tensor(np.concatenate(rows)),
        torch.as_tensor(np.array(widened, np.int32)),
        *(torch.as_tensor(np.int32(int(getattr(jpairs, f))))
          for f in ("num_pairs", "overflow", "big_count")))
    band_t = tuple(torch.as_tensor(b) for b in band)
    _, _, slab = praster.raster_tiles(slab_pairs, pc, peel=band_t, accum=True)
    np.testing.assert_array_equal(slab.numpy(), jacc)
    _, _, own = praster.raster_tiles(
        interop.binned_pairs(_np_fields(jpairs), device="cpu"), pc,
        peel=band_t, accum=True)
    assert (own.numpy()[7] < jacc[7]).any()      # the double count


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the raster kernel is CUDA C++ "
                    "and has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 5])
def test_cuda_kernel_matches_plain(cuda_device, seed):
    rng = np.random.default_rng(seed)
    n = 400
    clip = torch.as_tensor(random_clip_triangles(rng, n).reshape(-1, 4),
                           device=cuda_device)
    cfg = PConfig(width=384, height=160, tile_h=32, tile_w=128,
                  max_pairs=1 << 14, max_tiles_per_tri=4)
    idx = torch.arange(3 * n, dtype=torch.int32, device=cuda_device).view(n, 3)
    lanes, bbox, valid, _ = prs.triangle_setup_packed(
        clip, idx, torch.ones(n, dtype=torch.bool, device=cuda_device), cfg,
        None, None)
    pairs = prs.bin_pairs(lanes, bbox, valid, cfg)
    before = praster.raster_tiles_cuda.launches
    kd, kv, kch = praster.raster_tiles(pairs, cfg)
    torch.cuda.synchronize()
    assert praster.raster_tiles_cuda.launches == before + 1
    pd, pv, pch = praster.raster_tiles_plain(pairs, cfg)
    assert torch.equal(kv, pv)
    assert torch.equal(kd, pd)
    torch.testing.assert_close(kch, pch, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("accum", [False, True])
def test_cuda_peel_and_accum_match_plain(cuda_device, accum):
    """K1's peel and accum modes on the card vs the plain version: vis,
    depth and every channel exact."""
    rng = np.random.default_rng(21)
    n = 400
    clip = torch.as_tensor(random_clip_triangles(rng, n).reshape(-1, 4),
                           device=cuda_device)
    cfg = PConfig(width=384, height=160, tile_h=32, tile_w=128,
                  max_pairs=1 << 14, max_tiles_per_tri=4)
    idx = torch.arange(3 * n, dtype=torch.int32, device=cuda_device).view(n, 3)
    lanes, bbox, valid, _ = prs.triangle_setup_packed(
        clip, idx, torch.ones(n, dtype=torch.bool, device=cuda_device), cfg,
        None, None)
    lanes = torch.as_tensor(with_payload(rng, lanes.cpu().numpy()),
                            device=cuda_device)
    pairs = prs.bin_pairs(lanes, bbox, valid, cfg)
    assert int(pairs.big_count) > 0
    band = tuple(torch.as_tensor(b, device=cuda_device)
                 for b in peel_band(rng, cfg.padded_height, cfg.padded_width))
    mode = praster.MODE_LAUNCHES[("K1", "accum" if accum else "peel")]
    before = mode.launches
    kd, kv, kch = praster.raster_tiles(pairs, cfg, peel=band, accum=accum)
    torch.cuda.synchronize()
    assert mode.launches == before + 1
    pd, pv, pch = praster.raster_tiles_plain(pairs, cfg, peel=band,
                                             accum=accum)
    assert torch.equal(kv, pv)
    assert torch.equal(kd, pd)
    assert torch.equal(kch, pch)


def seeded_and_tangent_case(device, kernel, mode):
    """(kernel-vs-plain) inputs of the seeded and tangent modes on the
    card: 400 random triangles with payload bytes and random tangent
    angles (lane 27), binned per triangle (K1) or in groups (K2); a seed
    rastered from 200 other triangles with random channels 5-7; a peel
    band. Returns (pairs, config, raster keywords, the plain version)."""
    rng = np.random.default_rng(31)
    tangent = mode.endswith("+tangent")
    cfg = PConfig(width=384, height=160, tile_h=32, tile_w=128,
                  max_pairs=1 << 14, max_tiles_per_tri=4,
                  max_tiles_per_group=2, max_group_pairs=1 << 12,
                  enable_vertex_tangents=tangent)
    bin_fn = prs.bin_pairs if kernel == "K1" else prs.bin_groups
    plain = (praster.raster_tiles_plain if kernel == "K1"
             else praster.raster_groups_plain)

    def pairs_of(n):
        clip = torch.as_tensor(random_clip_triangles(rng, n).reshape(-1, 4),
                               device=device)
        idx = torch.arange(3 * n, dtype=torch.int32, device=device).view(n, 3)
        lanes, bbox, valid, _ = prs.triangle_setup_packed(
            clip, idx, torch.ones(n, dtype=torch.bool, device=device), cfg,
            None, None)
        rows = with_payload(rng, lanes.cpu().numpy())
        rows[:, 27] = np.where(rows[:, 9] > 0.5, rng.uniform(
            -np.pi, 5 * np.pi, rows.shape[0]), 0)
        return bin_fn(torch.as_tensor(rows, device=device), bbox, valid, cfg)

    kw = {}
    if mode.startswith("seeded"):
        d0, v0, c0 = plain(pairs_of(256), cfg)
        c0 = c0.clone()
        c0[5:] = torch.as_tensor(rng.normal(size=tuple(c0[5:].shape)).astype(
            np.float32), device=device)
        kw["init"] = (d0, v0, c0)
    elif mode.startswith("peel"):
        kw["peel"] = tuple(torch.as_tensor(b, device=device) for b in
                           peel_band(rng, cfg.padded_height, cfg.padded_width))
    return pairs_of(512), cfg, kw, plain


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["seeded", "plain+tangent", "seeded+tangent",
                                  "peel+tangent"])
def test_cuda_seeded_and_tangent_modes_match_plain(cuda_device, mode):
    """K1's seeded mode and its tangent modes on the card vs the plain
    version: vis, depth and every channel exact, one launch of the mode."""
    pairs, cfg, kw, plain = seeded_and_tangent_case(cuda_device, "K1", mode)
    count = praster.MODE_LAUNCHES[("K1", mode)]
    before = count.launches
    kd, kv, kch = praster.raster_tiles(pairs, cfg, **kw)
    torch.cuda.synchronize()
    assert count.launches == before + 1
    pd, pv, pch = plain(pairs, cfg, **kw)
    assert torch.equal(kv, pv)
    assert torch.equal(kd, pd)
    assert torch.equal(kch, pch)
