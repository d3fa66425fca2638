"""Port post stack (ops/post.py) vs the JAX package's, function by function,
on inputs made from a numpy seed.

Tolerances:
- the blur / downsample / upsample pieces, bloom, _shift2d, _box3,
  taa_resolve and resize_nearest: rtol 1e-6, atol 1e-6 (the same f32
  operations; XLA's CPU backend may contract a multiply-add or sum a
  reduction in another order);
- the luminance histogram: counts equal (no sample of these inputs sits
  within an ulp of a bin edge); auto_exposure: rtol 1e-4;
- GTAO: the integer tap offsets equal for frame_index 0-3 (one ulp of cos
  can move a whole tap, so this is checked first), then AO within atol
  1e-4 (arccos near 1 amplifies the inverse view-projection's last-bit
  differences);
- taa_resolve_mv: atol 1e-5, the history warp's bound (tests/test_motion.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from basicrenderer_tpu.ops import post as jpost
from basicrenderer_tpu_torch.ops import post as ppost

from tests.test_torch_ssr import plane_scene

TIGHT = dict(rtol=1e-6, atol=1e-6)


def _close(p, j, **tol):
    np.testing.assert_allclose(p.numpy(), np.asarray(j), **(tol or TIGHT))


def _hdr(seed, h=48, w=80):
    rng = np.random.default_rng(seed)
    x = rng.lognormal(mean=-1.0, sigma=1.5, size=(h, w, 3)).astype(np.float32)
    return x


@pytest.mark.parametrize("shape", [(48, 80), (33, 51)])
def test_blur_and_resample_pieces_match_jax(shape):
    x = _hdr(1, *shape)
    t = torch.as_tensor(x)
    _close(ppost._downsample2(t), jax.jit(jpost._downsample2)(jnp.asarray(x)))
    _close(ppost._blur3(t), jax.jit(jpost._blur3)(jnp.asarray(x)))
    planes = np.ascontiguousarray(x.transpose(2, 0, 1))
    tp = torch.as_tensor(planes)
    _close(ppost._down2_p(tp), jax.jit(jpost._down2_p)(jnp.asarray(planes)))
    _close(ppost._blur3_p(tp), jax.jit(jpost._blur3_p)(jnp.asarray(planes)))
    h, w = shape
    _close(ppost._up2_p(tp, 2 * h + 1, 2 * w + 3),
           jax.jit(jpost._up2_p, static_argnums=(1, 2))(
               jnp.asarray(planes), 2 * h + 1, 2 * w + 3))


@pytest.mark.parametrize("size", [(64, 96), (54, 90)])
def test_bloom_matches_jax(size):
    x = _hdr(2, *size) * 3.0
    p = ppost.bloom(torch.as_tensor(x), torch.tensor(1.0), torch.tensor(0.04))
    j = jax.jit(jpost.bloom)(jnp.asarray(x), jnp.float32(1.0),
                             jnp.float32(0.04))
    _close(p, j, rtol=1e-5, atol=1e-6)
    assert float((p - torch.as_tensor(x)).abs().max()) > 1e-3


def test_luminance_histogram_and_exposure_match_jax():
    x = _hdr(3, 64, 128)
    p = ppost.luminance_histogram(torch.as_tensor(x))
    j = np.asarray(jax.jit(jpost.luminance_histogram)(jnp.asarray(x)))
    np.testing.assert_array_equal(p.numpy(), j)
    assert p.dtype == torch.int32 and int(p.sum()) == 64 * 128
    for bins, lo, hi in ((256, -10.0, 6.0), (64, -8.0, 4.0)):
        pe = ppost.auto_exposure(torch.as_tensor(x), bins=bins, log_min=lo,
                                 log_max=hi)
        je = jax.jit(jpost.auto_exposure,
                     static_argnames=("bins", "log_min", "log_max"))(
            jnp.asarray(x), bins=bins, log_min=lo, log_max=hi)
        np.testing.assert_allclose(float(pe), float(je), rtol=1e-4)


def test_linearize_depth_matches_jax():
    d = np.random.default_rng(4).uniform(0, 1, (16, 24)).astype(np.float32)
    d[0, :4] = 0.0
    _close(ppost.linearize_depth(torch.as_tensor(d), torch.tensor(0.1)),
           jpost.linearize_depth(jnp.asarray(d), jnp.float32(0.1)))


def _jax_taps(radius, frame_index, num_dirs=2, num_steps=3, pad=96):
    """The JAX package's tap offsets, spelled as in ops/post.py:209-243."""
    base = jnp.pi * (jnp.int32(frame_index).astype(jnp.float32) % 4.0) \
        / (4.0 * num_dirs)
    out = []
    for d in range(num_dirs):
        ang = base + d * jnp.pi / num_dirs
        ca, sa = jnp.cos(ang), jnp.sin(ang)
        for s in range(1, num_steps + 1):
            r_px = jnp.float32(radius) * s * 24.0 / num_steps
            out.append((int(jnp.clip((sa * r_px).astype(jnp.int32), -pad, pad)),
                        int(jnp.clip((ca * r_px).astype(jnp.int32), -pad, pad))))
    return out


@pytest.mark.parametrize("radius", [0.5, 1.3])
def test_gtao_tap_offsets_match_jax(radius):
    for fi in range(4):
        taps = ppost.gtao_taps(torch.tensor(radius), torch.tensor(fi,
                                                               dtype=torch.int32))
        got = [(int(dy), int(dx)) for row in taps for dy, dx in row]
        assert got == _jax_taps(radius, fi), (fi, got)


@pytest.mark.parametrize("frame_index", [0, 1, 2, 3])
def test_gtao_matches_jax(frame_index):
    sc = plane_scene(64, 96)
    pv, jv = sc["pview"], sc["jview"]
    p = ppost.gtao(torch.as_tensor(sc["depth"]), torch.as_tensor(sc["normal"]),
                   pv, pv.near, torch.tensor(0.5), torch.tensor(1.0),
                   torch.tensor(frame_index, dtype=torch.int32))
    j = jax.jit(jpost.gtao)(jnp.asarray(sc["depth"]),
                            jnp.asarray(sc["normal"]), jv, jv.near,
                            jnp.float32(0.5), jnp.float32(1.0),
                            jnp.int32(frame_index))
    np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-4)
    assert float(p.min()) < 0.9   # the wall occludes the floor's corner


def test_shift_and_box_match_jax():
    x = np.random.default_rng(5).normal(size=(20, 30)).astype(np.float32)
    # Shifts up to one image: JAX pads one image on each side.
    for dy, dx in ((0, 0), (3, -7), (-20, 30), (19, -29), (20, -30)):
        _close(ppost._shift2d(torch.as_tensor(x), dy, dx),
               jpost._shift2d(jnp.asarray(x), dy, dx))
    _close(ppost._box3(torch.as_tensor(x)), jpost._box3(jnp.asarray(x)))


def test_halton_jitter_matches_jax():
    np.testing.assert_array_equal(ppost.HALTON_23, jpost.HALTON_23)
    for i in range(10):
        np.testing.assert_array_equal(ppost.taa_jitter(i), jpost.taa_jitter(i))


def test_taa_resolve_matches_jax():
    cur, hist = _hdr(6), _hdr(7)
    p = ppost.taa_resolve(torch.as_tensor(cur), torch.as_tensor(hist),
                          torch.tensor(0.1))
    j = jpost.taa_resolve(jnp.asarray(cur), jnp.asarray(hist), jnp.float32(0.1))
    _close(p, j)
    assert ppost.taa_resolve(torch.as_tensor(cur), None, 0.1) is not None


@pytest.mark.parametrize("out_shape", [(120, 128), (36, 70), (60, 64)])
def test_resize_nearest_matches_jax(out_shape):
    x = np.random.default_rng(8).normal(size=(60, 64)).astype(np.float32)
    _close(ppost.resize_nearest(torch.as_tensor(x), *out_shape),
           jax.image.resize(jnp.asarray(x), out_shape, "nearest"))


def test_taa_resolve_mv_matches_jax():
    """60x250 frame on a 32x128 tile grid (edge-padded to 64x256), the
    residual at half rate of the padded grid (resized nearest to 60x250)."""
    rng = np.random.default_rng(9)
    H, W, th, tw = 60, 250, 32, 128
    cur, hist = _hdr(10, H, W), _hdr(11, H, W)
    T = 2 * 2
    dy = rng.uniform(-12, 12, T).astype(np.float32)
    dx = rng.uniform(-40, 40, T).astype(np.float32)
    resid = rng.uniform(0, 3, (32, 128)).astype(np.float32)
    p = ppost.taa_resolve_mv(torch.as_tensor(cur), torch.as_tensor(hist),
                             torch.tensor(0.1), torch.as_tensor(dy),
                             torch.as_tensor(dx), torch.as_tensor(resid), th, tw)
    j = jax.jit(jpost.taa_resolve_mv, static_argnums=(6, 7),
                static_argnames=("use_kernel",))(
        jnp.asarray(cur), jnp.asarray(hist), jnp.float32(0.1), jnp.asarray(dy),
        jnp.asarray(dx), jnp.asarray(resid), th, tw, use_kernel=False)
    np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-5)
    # Rejected pixels take the current frame.
    rej = ppost.resize_nearest(torch.as_tensor(resid), H, W) > 1.5
    assert 0.2 < float(rej.float().mean()) < 0.8
    np.testing.assert_array_equal(p.numpy()[rej.numpy()], cur[rej.numpy()])
