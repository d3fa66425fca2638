"""OpenPBR energy compensation and the fuzz lobe: ops/brdf_energy.py of the
port vs the JAX package on the CPU.

Tolerances:
- the albedo tables and the Chebyshev coefficients: equal (the host part
  is a copy);
- ggx_energy, energy_compensation and sheen_energy on a 64x64
  (NoV, roughness) grid: within 2e-6 absolute (the port spells the fused
  multiply-adds XLA makes of the T_k chain and the reciprocal it makes of
  the sheen warp's division, and takes correctly rounded roots: equal on
  this grid);
- d_charlie, v_ashikhmin and eval_sheen on random inputs: rtol 1e-5
  (atol 1e-9 and 1e-7: sin^(1/alpha) near grazing is ~1e-9, where pow's
  last ulp is a larger share).
"""

import numpy as np
import jax
import pytest
import torch

from basicrenderer_tpu.ops import brdf_energy as jbe
from basicrenderer_tpu_torch.ops import brdf_energy as pbe
from basicrenderer_tpu_torch.ops import shade as pshade

ABS = 2e-6


def _grid(n=64):
    mu, r = np.meshgrid(np.linspace(0.0, 1.0, n, dtype=np.float32),
                        np.linspace(0.0, 1.0, n, dtype=np.float32),
                        indexing="ij")
    return mu, r


@pytest.mark.parametrize("name", ["ggx_albedo_table", "sheen_albedo_table",
                                  "sheen_alpha_axis", "_ggx_coeffs",
                                  "_sheen_coeffs"])
def test_host_tables_and_coefficients_equal(name):
    np.testing.assert_array_equal(np.asarray(getattr(pbe, name)()),
                                  np.asarray(getattr(jbe, name)()))


@pytest.mark.parametrize("fn", ["ggx_energy", "sheen_energy"])
def test_fitted_albedo_matches_jax(fn):
    mu, r = _grid()
    j = np.asarray(jax.jit(getattr(jbe, fn))(mu, r))
    p = getattr(pbe, fn)(torch.as_tensor(mu), torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(p, j, rtol=0, atol=ABS)


def test_energy_compensation_matches_jax():
    mu, r = _grid()
    f0 = np.random.default_rng(0).uniform(0, 1, mu.shape + (3,)) \
        .astype(np.float32)
    j = np.asarray(jax.jit(jbe.energy_compensation)(f0, mu, r))
    p = pbe.energy_compensation(torch.as_tensor(f0), torch.as_tensor(mu),
                                torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(p, j, rtol=0, atol=ABS)


def test_sheen_lobe_matches_jax():
    rng = np.random.default_rng(1)

    def unit(shape):
        v = rng.normal(size=shape).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)
    n, v, l = unit((32, 32, 3)), unit((32, 32, 3)), unit((32, 32, 3))
    v = np.where(np.sum(n * v, -1, keepdims=True) < 0, -v, v)
    rough = rng.uniform(0.0, 1.2, (32, 32)).astype(np.float32)
    ndh = rng.uniform(0.0, 1.0, (32, 32)).astype(np.float32)
    j = np.asarray(jax.jit(jbe.eval_sheen)(n, v, l, rough))
    p = pbe.eval_sheen(*map(torch.as_tensor, (n, v, l, rough))).numpy()
    np.testing.assert_allclose(p, j, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        pbe.d_charlie(torch.as_tensor(ndh), torch.as_tensor(rough)).numpy(),
        np.asarray(jax.jit(jbe.d_charlie)(ndh, rough)), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(
        pbe.v_ashikhmin(torch.as_tensor(ndh), torch.as_tensor(rough)).numpy(),
        np.asarray(jax.jit(jbe.v_ashikhmin)(ndh, rough)), rtol=1e-5, atol=1e-9)


def test_fits_follow_their_tables():
    """tests/test_brdf_energy.py's fit and range checks on the port."""
    mu = (np.arange(32) + 0.5) / 32
    MU, R = np.meshgrid(mu, mu, indexing="ij")
    fit = pbe.ggx_energy(torch.tensor(MU, dtype=torch.float32),
                         torch.tensor(R, dtype=torch.float32)).numpy()
    assert np.abs(fit - pbe.ggx_albedo_table()).max() < 0.015
    MU, A = np.meshgrid(mu, pbe.sheen_alpha_axis(), indexing="ij")
    fit = pbe.sheen_energy(torch.tensor(MU, dtype=torch.float32),
                           torch.tensor(A, dtype=torch.float32)).numpy()
    assert np.abs(fit - pbe.sheen_albedo_table()).max() < 0.015


def test_energy_compensation_white_furnace():
    """f0 = 1: the compensated albedo is 1; f0 = 0: no compensation."""
    mu = torch.tensor([[0.3]])
    r = torch.tensor([[0.9]])
    comp = pbe.energy_compensation(torch.ones((1, 1, 3)), mu, r)
    e = pbe.ggx_energy(mu, r)
    np.testing.assert_allclose((e[..., None] * comp).numpy(), 1.0, atol=1e-6)
    comp0 = pbe.energy_compensation(torch.zeros((1, 1, 3)), mu, r)
    np.testing.assert_allclose(comp0.numpy(), 1.0, atol=1e-6)


def _gbuffer(h=4, w=4, metallic=1.0, roughness=0.8, fuzz_w=0.0, fuzz_r=0.5):
    """tests/test_brdf_energy.py's flat G-buffer, every field the port's
    GBuffer carries filled."""
    z = torch.zeros((h, w))
    z3 = torch.zeros((h, w, 3))
    up = torch.tensor([0.0, 1.0, 0.0]).expand(h, w, 3)
    ids = torch.zeros((h, w), dtype=torch.int32)
    return pshade.GBuffer(
        world_pos=z3, normal=up, albedo=torch.full((h, w, 3), 0.9),
        metallic=torch.full((h, w), metallic),
        roughness=torch.full((h, w), roughness), emissive=z3,
        valid=torch.ones((h, w), dtype=torch.bool), depth=z,
        material_id=ids, uv=torch.zeros((h, w, 2)), alpha=z + 1,
        object_id=ids, base_tex=ids - 1, normal_tex=ids - 1, mr_tex=ids - 1,
        emissive_tex=ids - 1, normal_scale=z + 1, trans_weight=z,
        trans_color=z3 + 1, trans_depth=z + 1, ior=z + 1.5, tangent_theta=z,
        coat_weight=z, coat_rough=z + 0.3,
        fuzz_weight=torch.full((h, w), fuzz_w),
        fuzz_rough=torch.full((h, w), fuzz_r), sss_weight=z,
        sss_color=z3 + 1, sss_radius=z, aniso_strength=z, aniso_rotation=z)


def _dir_row(d=(0.0, -1.0, 0.0)):
    row = torch.zeros(16)
    row[4:7] = torch.tensor(d) / torch.linalg.vector_norm(torch.tensor(d))
    row[7] = 1.0
    row[8:11] = 1.0
    return row


def _view(d):
    v = torch.tensor(d, dtype=torch.float32)
    return (v / torch.linalg.vector_norm(v)).expand(4, 4, 3)


def test_energy_comp_brightens_rough_metal():
    """tests/test_brdf_energy.py's check on the port: multi-scatter adds
    energy to a rough metal at a grazing view and ~none to a smooth one."""
    v = _view([0.95, 0.312, 0.0])
    row = _dir_row()
    for rough, check in ((0.85, lambda g: g > 1.1), (0.05, lambda g: g < 1.05)):
        gb = _gbuffer(metallic=1.0, roughness=rough)
        base = pshade.shade_one_light(gb, row, v, gb.normal)
        comp, fe = pshade.openpbr_terms(gb, v, gb.normal, True, False)
        assert fe is None
        lit = pshade.shade_one_light(gb, row, v, gb.normal, spec_comp=comp)
        gain = float(lit.mean() / torch.clamp(base.mean(), min=1e-9))
        assert check(gain), (rough, gain)


def test_fuzz_adds_grazing_rim():
    """tests/test_brdf_energy.py's check on the port: a grazing light and
    view on velvet gain the sheen rim; zero fuzz weight is a no-op."""
    gb = _gbuffer(metallic=0.0, roughness=0.6, fuzz_w=1.0, fuzz_r=0.4)
    row = _dir_row((-0.95, -0.25, 0.0))
    v = _view([0.98, 0.2, 0.0])
    base = pshade.shade_one_light(gb, row, v, gb.normal)
    _, fe = pshade.openpbr_terms(gb, v, gb.normal, False, True)
    assert float(fe.max()) <= 1.0
    fuzzed = pshade.shade_one_light(gb, row, v, gb.normal, fuzz_e=fe)
    assert float(fuzzed.mean()) > float(base.mean())
    gb0 = _gbuffer(fuzz_w=0.0)
    _, fe0 = pshade.openpbr_terms(gb0, v, gb0.normal, False, True)
    np.testing.assert_allclose(
        pshade.shade_one_light(gb0, row, v, gb0.normal, fuzz_e=fe0).numpy(),
        pshade.shade_one_light(gb0, row, v, gb0.normal).numpy(), atol=1e-6)


def test_fit_coordinates_take_correctly_rounded_roots():
    """The fitted coordinates' roots (utils/math3d.sqrt_rn) are the f32
    square roots rounded once, as XLA's and numpy's are, over the fits'
    whole range and the values PyTorch's CPU f32 sqrt has missed
    (0.03125006; 1.0, approximated on part of a tensor)."""
    from basicrenderer_tpu_torch.utils.math3d import sqrt_rn
    x = np.random.default_rng(3).uniform(0.0, 1.0, 1 << 16) \
        .astype(np.float32)
    x[:3] = (0.03125006, 1.0, 1.0 / 64)
    np.testing.assert_array_equal(sqrt_rn(torch.as_tensor(x)).numpy(),
                                  np.sqrt(x))
