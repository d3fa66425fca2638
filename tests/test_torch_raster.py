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
    cfg = PConfig(width=128, height=32, tile_h=16, tile_w=128)
    pairs = prs.BinnedPairs(torch.zeros((256, 32)),
                            torch.full((2,), 256, dtype=torch.int32),
                            *(torch.zeros((), dtype=torch.int32),) * 3)
    img = torch.zeros((32, 128))
    with pytest.raises(NotImplementedError, match="enable_occlusion"):
        praster.raster_tiles(pairs, cfg, init=(img, img, img))
    with pytest.raises(NotImplementedError, match="enable_oit"):
        praster.raster_tiles(pairs, cfg, peel=(img, img))
    with pytest.raises(NotImplementedError, match="enable_oit"):
        praster.raster_tiles(pairs, cfg, accum=True)


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
