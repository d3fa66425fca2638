"""Port image-based lighting (ops/ibl.py, models/environment.py) vs the JAX
package's, on cubemaps and G-buffer planes made from a numpy seed.

Tolerances:
- face_directions, _sh_basis, env_brdf_karis, make_procedural_environment:
  rtol 1e-6, atol 1e-6 (the same f32 operations);
- _hammersley: equal;
- project_sh, eval_sh_irradiance: rtol 1e-5, atol 1e-6 (einsum sums in
  another order);
- nearest-texel lookups (sample_cubemap_precompute, prefilter_specular,
  runtime_specular_ibl): a direction whose texel coordinate sits within an
  ulp of a texel edge may round to the neighbour in the other package, so
  >= 99.5% of values within 1e-5, and all within 1e-3 after averaging
  (prefilter sums 16-64 taps per texel);
- resize_linear (jax.image.resize "linear", antialiased when shrinking):
  rtol 1e-5, atol 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from basicrenderer_tpu.models import environment as jenv
from basicrenderer_tpu.ops import ibl as jibl
from basicrenderer_tpu_torch.models import environment as penv
from basicrenderer_tpu_torch.ops import ibl as pibl

TIGHT = dict(rtol=1e-6, atol=1e-6)
SUMS = dict(rtol=1e-5, atol=1e-6)


def _cube(res, seed=0):
    rng = np.random.default_rng(seed)
    return rng.lognormal(-0.5, 0.8, (6, res, res, 3)).astype(np.float32)


def _dirs(n, seed=1):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _mostly_close(p, j, share=0.995, atol=1e-5):
    diff = np.abs(np.asarray(p, np.float64) - np.asarray(j, np.float64))
    assert (diff <= atol).mean() >= share, (diff <= atol).mean()


@pytest.mark.parametrize("res", [4, 16])
def test_face_directions_and_basis_match_jax(res):
    p = pibl.face_directions(res, "cpu")
    j = jax.jit(jibl.face_directions, static_argnums=0)(res)
    np.testing.assert_allclose(p.numpy(), np.asarray(j), **TIGHT)
    np.testing.assert_allclose(
        pibl._sh_basis(p).numpy(),
        np.asarray(jax.jit(jibl._sh_basis)(jnp.asarray(p.numpy()))), **TIGHT)


def test_sh_projection_and_irradiance_match_jax():
    cube = _cube(16)
    p = pibl.project_sh(torch.as_tensor(cube))
    j = np.array(jax.jit(jibl.project_sh)(jnp.asarray(cube)))
    np.testing.assert_allclose(p.numpy(), j, **SUMS)
    n = _dirs(500).reshape(20, 25, 3)
    np.testing.assert_allclose(
        pibl.eval_sh_irradiance(torch.as_tensor(j), torch.as_tensor(n)).numpy(),
        np.asarray(jax.jit(jibl.eval_sh_irradiance)(jnp.asarray(j),
                                                    jnp.asarray(n))),
        **SUMS)


def test_hammersley_matches_jax():
    np.testing.assert_array_equal(pibl._hammersley(64), jibl._hammersley(64))


def test_sample_cubemap_matches_jax():
    cube = _cube(16, 2)
    d = _dirs(4000, 3).reshape(40, 100, 3)
    p = pibl.sample_cubemap_precompute(torch.as_tensor(cube), torch.as_tensor(d))
    j = jax.jit(jibl.sample_cubemap_precompute)(jnp.asarray(cube),
                                                jnp.asarray(d))
    _mostly_close(p.numpy(), j)


def test_prefilter_specular_matches_jax():
    cube = _cube(16, 4)
    p = pibl.prefilter_specular(torch.as_tensor(cube), mips=5, samples=16)
    # Eager, as Environment.precompute runs it: compiled whole, XLA rounds
    # a quarter of the texel lookups the other way.
    j = jibl.prefilter_specular(jnp.asarray(cube), mips=5, samples=16)
    assert [tuple(m.shape) for m in p] == [tuple(m.shape) for m in j]
    for a, b in zip(p, j):
        _mostly_close(a.numpy(), b)
        np.testing.assert_allclose(a.numpy().mean(), float(jnp.mean(b)),
                                   atol=1e-3)


def test_env_brdf_and_procedural_match_jax():
    rng = np.random.default_rng(5)
    ndv = rng.uniform(1e-4, 1, (30, 40)).astype(np.float32)
    rough = rng.uniform(0, 1, (30, 40)).astype(np.float32)
    for a, b in zip(pibl.env_brdf_karis(torch.as_tensor(ndv),
                                        torch.as_tensor(rough)),
                    jax.jit(jibl.env_brdf_karis)(jnp.asarray(ndv),
                                                 jnp.asarray(rough))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TIGHT)
    for kw in ({}, dict(intensity=2.0, sun_dir=(0.3, -1.0, 0.2))):
        np.testing.assert_allclose(
            pibl.make_procedural_environment(16, **kw, device="cpu").numpy(),
            np.asarray(jax.jit(jibl.make_procedural_environment,
                               static_argnums=0, static_argnames=tuple(kw))(
                16, **kw)), **TIGHT)


@pytest.mark.parametrize("downscale", [2, 4])
def test_runtime_specular_ibl_matches_jax(downscale):
    rng = np.random.default_rng(6)
    H, W = 32, 48
    n = _dirs(H * W, 7).reshape(H, W, 3)
    v = _dirs(H * W, 8).reshape(H, W, 3)
    rough = rng.uniform(0, 1, (H, W)).astype(np.float32)
    mips = np.stack([_cube(8, 10 + m) for m in range(5)])
    p = pibl.runtime_specular_ibl(torch.as_tensor(n), torch.as_tensor(v),
                                  torch.as_tensor(rough), torch.as_tensor(mips),
                                  downscale=downscale)
    j = jax.jit(jibl.runtime_specular_ibl, static_argnames=("downscale",))(
        jnp.asarray(n), jnp.asarray(v), jnp.asarray(rough), jnp.asarray(mips),
        downscale=downscale)
    assert p.shape == (H, W, 3)
    _mostly_close(p.numpy(), j)


@pytest.mark.parametrize("src,dst", [((6, 128, 128, 3), (6, 64, 64, 3)),
                                     ((6, 8, 8, 3), (6, 64, 64, 3)),
                                     ((6, 20, 12, 3), (6, 7, 30, 3))])
def test_resize_linear_matches_jax(src, dst):
    x = np.random.default_rng(9).normal(size=src).astype(np.float32)
    np.testing.assert_allclose(
        penv.resize_linear(torch.as_tensor(x), dst).numpy(),
        np.asarray(jax.image.resize(jnp.asarray(x), dst, "linear")), **SUMS)


def test_environment_precompute_matches_jax(tmp_path, monkeypatch):
    """A 16^2 procedural cubemap: SH and every prefiltered mip (resampled
    to SPEC_RES) against the JAX package's precompute; the .npz cache
    under the port's build directory returns the same arrays."""
    monkeypatch.setattr(penv, "CACHE_DIR", tmp_path)
    cube = np.asarray(jibl.make_procedural_environment(16))
    j = jenv.Environment.precompute(cube, use_cache=False)
    p = penv.Environment.precompute(cube, device="cpu")
    assert p.spec_mips.shape == (penv.SPEC_MIPS, 6, penv.SPEC_RES,
                                 penv.SPEC_RES, 3)
    np.testing.assert_allclose(p.sh, j.sh, **SUMS)
    _mostly_close(p.spec_mips, j.spec_mips, share=0.99, atol=1e-4)
    np.testing.assert_allclose(p.spec_mips.mean(axis=(1, 2, 3, 4)),
                               j.spec_mips.mean(axis=(1, 2, 3, 4)), rtol=1e-3)
    assert len(list(tmp_path.glob("*.npz"))) == 1
    again = penv.Environment.procedural(res=16, device="cpu")
    np.testing.assert_array_equal(again.spec_mips, p.spec_mips)


def test_environment_precompute_equirect_matches_jax(tmp_path, monkeypatch):
    """A 16x32 equirect panorama (a sky gradient with a sun spot), also
    read back from a Radiance .hdr file: the cubemap resample
    (sample_equirect), SH and every prefiltered mip against the JAX
    package's precompute, within the cubemap test's tolerances."""
    monkeypatch.setattr(penv, "CACHE_DIR", tmp_path)
    rng = np.random.default_rng(8)
    yy = np.linspace(0.0, 1.0, 16, dtype=np.float32)[:, None, None]
    eq = (np.array([0.2, 0.4, 0.9], np.float32) * (1.2 - yy)
          + rng.random((16, 32, 3)).astype(np.float32) * 0.1)
    eq = np.broadcast_to(eq, (16, 32, 3)).copy()
    eq[3:5, 20:23] = 40.0
    dirs = np.asarray(jibl.face_directions(16))
    # The longitude and latitude of each texel come from atan2 / arccos,
    # whose last bits differ between the backends: sampled like the
    # nearest-texel lookup above.
    _mostly_close(
        pibl.equirect_to_cubemap(torch.as_tensor(eq), 16).numpy(),
        np.asarray(jibl.sample_equirect(jnp.asarray(eq), jnp.asarray(dirs))))
    j = jenv.Environment.precompute(eq, cubemap_res=16, use_cache=False)
    p = penv.Environment.precompute(eq, cubemap_res=16, device="cpu")
    np.testing.assert_allclose(p.sh, j.sh, **SUMS)
    _mostly_close(p.spec_mips, j.spec_mips, share=0.99, atol=1e-4)
    np.testing.assert_allclose(p.spec_mips.mean(axis=(1, 2, 3, 4)),
                               j.spec_mips.mean(axis=(1, 2, 3, 4)), rtol=1e-3)
    # The equirect resample does not move the roughest mip: the port's
    # precompute of the JAX package's own cubemap resample gives its mean.
    from_j_cube = penv.Environment.precompute(
        np.asarray(jibl.equirect_to_cubemap(jnp.asarray(eq), 16)),
        use_cache=False, device="cpu")
    np.testing.assert_allclose(p.spec_mips[-1].mean(),
                               from_j_cube.spec_mips[-1].mean(), rtol=1e-6)
    from basicrenderer_tpu_torch.models.texprocess import save_hdr
    path = str(tmp_path / "sky.hdr")
    save_hdr(path, eq)
    h = penv.Environment.from_hdr(path, cubemap_res=16, use_cache=False,
                                  device="cpu")
    jh = jenv.Environment.from_hdr(path, cubemap_res=16, use_cache=False)
    assert h.name == "sky.hdr"
    np.testing.assert_allclose(h.sh, jh.sh, **SUMS)
    with pytest.raises(ValueError, match="equirect"):
        penv.Environment.precompute(np.zeros((8, 16, 4), np.float32),
                                    device="cpu")
