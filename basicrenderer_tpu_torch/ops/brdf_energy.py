"""OpenPBR energy compensation and the fuzz (sheen) lobe through fitted
polynomials.

Port of basicrenderer_tpu/ops/brdf_energy.py. The host part is a copy:
the directional-albedo tables are integrated once on the host (numpy
quasi-Monte-Carlo over Hammersley points) and least-squares fitted to
tensor Chebyshev polynomials in (NoV, roughness), so the coefficients
equal the JAX package's bit for bit. Per pixel the fit is evaluated by
the T_k recurrence (a multiply-add chain, no table fetch).

Terms:
- GGX single-scatter directional albedo E_ss(NoV, r) and the Kulla-Conty
  multi-scatter factor 1 + f0 * (1 - E_ss) / E_ss on the specular lobe;
- Charlie-sheen directional albedo E_fuzz(NoV, r) for the fuzz layer's
  energy, and the D_charlie / V_ashikhmin lobe itself.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..utils.math3d import sqrt_rn
from .raster_setup import fma

# Table + fit resolution. 32x32 cells, 16384 QMC samples each integrates in
# ~1 s on host (once per process, lru-cached); tensor polynomials in
# sqrt-warped coordinates (the albedo varies sharpest at grazing mu and
# low roughness, and sqrt stretches exactly those corners) fit GGX to
# <1e-2 and sheen to <1.5e-2 max error — far below visible threshold for
# compensation terms that are themselves <30% corrections.
_N = 32
_SAMPLES = 16384
_GGX_DEG = (8, 8)      # coefficients per (mu, r) axis
_SHEEN_DEG = (12, 8)
_SHEEN_A0 = 0.05       # sheen alpha domain [0.05, 1] (matches the
                       # fuzz_rough clamp in shade.gbuffer_from_channels)


def _hammersley(n: int) -> np.ndarray:
    """(n, 2) Van-der-Corput / Hammersley points (deterministic QMC)."""
    i = np.arange(n, dtype=np.uint32)
    bits = i.copy()
    bits = ((bits << 16) | (bits >> 16)) & 0xFFFFFFFF
    bits = ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)
    bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
    bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
    bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
    return np.stack([i / n, bits.astype(np.float64) * 2.3283064365386963e-10],
                    axis=-1)


def _axes() -> tuple:
    mu = (np.arange(_N) + 0.5) / _N          # NoV in (0, 1)
    r = (np.arange(_N) + 0.5) / _N           # perceptual roughness in (0, 1)
    return mu, r


def ggx_albedo_table() -> np.ndarray:
    """E_ss[mu, r]: GGX + height-correlated Smith, F=1 directional albedo.

    GGX-NDF importance sampling: estimator G * VoH / (NoV * NoH) (the
    standard split-sum albedo integrand with Fresnel split off)."""
    mu, r = _axes()
    xi = _hammersley(_SAMPLES)
    a = np.maximum(r, 1e-3) ** 2                       # alpha = r^2
    # Sample half-vectors around +z for each roughness: theta_h from GGX.
    cos_h = np.sqrt((1.0 - xi[:, 0][None, :]) /
                    (1.0 + (a[:, None] ** 2 - 1.0) * xi[:, 0][None, :]))
    sin_h = np.sqrt(np.maximum(1.0 - cos_h ** 2, 0.0))   # (R, S)
    phi = 2.0 * np.pi * xi[:, 1]                         # (S,)
    hx = sin_h * np.cos(phi)[None, :]
    hy = sin_h * np.sin(phi)[None, :]
    hz = cos_h
    # View vector in the xz plane: v = (sin_v, 0, mu).
    sin_v = np.sqrt(np.maximum(1.0 - mu ** 2, 0.0))
    E = np.zeros((_N, _N))
    for i, m in enumerate(mu):
        vx, vz = sin_v[i], m
        v_dot_h = vx * hx + vz * hz                      # (R, S)
        lz = 2.0 * v_dot_h * hz - vz                     # only NoL is needed
        n_dot_l = np.maximum(lz, 0.0)
        # Height-correlated Smith G (matches ops/shade.py _g_smith * 4
        # NoV NoL).
        a2 = (a ** 2)[:, None]
        gv = n_dot_l * np.sqrt(np.maximum(m * m * (1 - a2) + a2, 1e-12))
        gl = m * np.sqrt(np.maximum(n_dot_l ** 2 * (1 - a2) + a2, 1e-12))
        G_vis = 0.5 / np.maximum(gv + gl, 1e-8)          # = G/(4 NoV NoL)
        ok = (n_dot_l > 0) & (v_dot_h > 0) & (hz > 0)
        est = np.where(ok, 4.0 * G_vis * n_dot_l * v_dot_h /
                       np.maximum(hz, 1e-8), 0.0)
        E[i] = est.mean(axis=1)
    return np.clip(E, 1e-3, 1.0)


def sheen_alpha_axis() -> np.ndarray:
    """Sheen tables live on alpha in [_SHEEN_A0, 1] directly — fuzz_rough
    is clamped to that range downstream, and tabulating the clamped-flat
    region below 0.05 would poison the polynomial fit."""
    return _SHEEN_A0 + (1.0 - _SHEEN_A0) * (np.arange(_N) + 0.5) / _N


def sheen_albedo_table() -> np.ndarray:
    """E_fuzz[mu, alpha]: Charlie sheen + Ashikhmin visibility directional
    albedo, cosine-hemisphere sampled (estimator = pi * D * V)."""
    mu, _ = _axes()
    alpha = sheen_alpha_axis()
    xi = _hammersley(_SAMPLES)
    # Cosine-weighted hemisphere directions.
    cos_l = np.sqrt(1.0 - xi[:, 0])
    sin_l = np.sqrt(xi[:, 0])
    phi = 2.0 * np.pi * xi[:, 1]
    lx, ly, lz = sin_l * np.cos(phi), sin_l * np.sin(phi), cos_l
    sin_v = np.sqrt(np.maximum(1.0 - mu ** 2, 0.0))
    E = np.zeros((_N, _N))
    for i, m in enumerate(mu):
        hx = lx + sin_v[i]
        hy = ly
        hz = lz + m
        hl = np.sqrt(hx * hx + hy * hy + hz * hz)
        n_dot_h = np.clip(hz / np.maximum(hl, 1e-9), 0.0, 1.0)
        sin2 = np.maximum(1.0 - n_dot_h ** 2, 1e-8)      # (S,)
        inv_a = 1.0 / alpha                              # (R,)
        D = (2.0 + inv_a[:, None]) * sin2[None, :] ** (inv_a[:, None] * 0.5) \
            / (2.0 * np.pi)
        V = 1.0 / np.maximum(4.0 * (lz[None, :] + m - lz[None, :] * m), 1e-6)
        E[i] = (np.pi * D * V).mean(axis=1)
    return np.clip(E, 0.0, 1.0)


def _fit_poly2d(table: np.ndarray, x: np.ndarray, y: np.ndarray,
                deg: tuple) -> np.ndarray:
    """Least-squares tensor CHEBYSHEV fit c[i,j] * T_i(2x-1) * T_j(2y-1)
    over the warped grid axes x, y (each len _N) -> (deg[0], deg[1]).

    Chebyshev, not monomial: at degree 12 a monomial LSQ fit has O(1e4)
    coefficients whose float32 Horner evaluation cancels catastrophically
    on device (~0.9 absolute error observed); Chebyshev coefficients stay
    O(10) and the T_k recurrence is float32-stable."""
    from numpy.polynomial import chebyshev as _cheb
    X, Y = np.meshgrid(2.0 * x - 1.0, 2.0 * y - 1.0, indexing="ij")
    basis = _cheb.chebvander2d(X.ravel(), Y.ravel(), [deg[0] - 1, deg[1] - 1])
    coeffs, *_ = np.linalg.lstsq(basis, table.reshape(-1), rcond=None)
    return coeffs.reshape(deg)


@functools.lru_cache(maxsize=None)
def _ggx_coeffs() -> tuple:
    mu, r = _axes()
    return tuple(map(tuple, _fit_poly2d(ggx_albedo_table(),
                                        np.sqrt(mu), np.sqrt(r), _GGX_DEG)))


def _sheen_warp_alpha(a):
    """alpha in [_SHEEN_A0, 1] -> fit coordinate in [0, 1] (numpy or
    torch). The tensor form multiplies by the reciprocal, as XLA does a
    division by a constant, and takes the correctly rounded root."""
    if isinstance(a, torch.Tensor):
        return sqrt_rn((a - _SHEEN_A0) * (1.0 / (1.0 - _SHEEN_A0)))
    return ((a - _SHEEN_A0) / (1.0 - _SHEEN_A0)) ** 0.5


@functools.lru_cache(maxsize=None)
def _sheen_coeffs() -> tuple:
    mu, _ = _axes()
    return tuple(map(tuple, _fit_poly2d(
        sheen_albedo_table(), np.sqrt(mu),
        _sheen_warp_alpha(sheen_alpha_axis()), _SHEEN_DEG)))


def _eval_poly2d(coeffs, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Tensor-Chebyshev evaluation at warped coords x, y in [0, 1] via the
    T_k recurrence, in the fused multiply-adds XLA's CPU backend makes of
    the JAX package's chain (bit for bit on a 64x64 grid of both fits):
    T_k = fma(2t, T_{k-1}, -T_{k-2}), each row c_0 + sum_j c_j T_j(y) as
    fma(T_j, c_j, row) and the sum over rows as fma(row_i, T_i(x), acc)."""
    tx = 2.0 * x - 1.0
    ty = 2.0 * y - 1.0
    dm, dr = len(coeffs), len(coeffs[0])

    def cheb(t, n):
        ts = [torch.ones_like(t), t]
        t2 = 2.0 * t
        for _ in range(2, n):
            ts.append(fma(t2, ts[-1], -ts[-2]))
        return ts
    t_y, t_x = cheb(ty, dr), cheb(tx, dm)
    acc = None
    for i in range(dm):
        c = [float(np.float32(v)) for v in coeffs[i]]
        row = fma(t_y[1], c[1], c[0])
        for j in range(2, dr):
            row = fma(t_y[j], c[j], row)
        acc = row if acc is None else fma(row, t_x[i], acc)
    return acc


def ggx_energy(n_dot_v: torch.Tensor, roughness: torch.Tensor) -> torch.Tensor:
    """Fitted single-scatter GGX directional albedo E_ss in (0, 1]."""
    mu = sqrt_rn(torch.clamp(n_dot_v, 1.0 / (2 * _N), 1.0))
    r = sqrt_rn(torch.clamp(roughness, 0.0, 1.0))
    return torch.clamp(_eval_poly2d(_ggx_coeffs(), mu, r), 5e-2, 1.0)


def energy_compensation(f0: torch.Tensor, n_dot_v: torch.Tensor,
                        roughness: torch.Tensor) -> torch.Tensor:
    """Kulla-Conty multi-scatter factor for the specular lobe:
    spec *= 1 + f0 * (1 - E_ss) / E_ss. f0 is (..., 3); result (..., 3)."""
    e = ggx_energy(n_dot_v, roughness)[..., None]
    return 1.0 + f0 * (1.0 - e) / e


def sheen_energy(n_dot_v: torch.Tensor, fuzz_rough: torch.Tensor
                 ) -> torch.Tensor:
    """Fitted Charlie-sheen directional albedo (fuzz layer opacity)."""
    mu = sqrt_rn(torch.clamp(n_dot_v, 1.0 / (2 * _N), 1.0))
    a = _sheen_warp_alpha(torch.clamp(fuzz_rough, _SHEEN_A0, 1.0))
    return torch.clamp(_eval_poly2d(_sheen_coeffs(), mu, a), 0.0, 1.0)


def d_charlie(n_dot_h: torch.Tensor, fuzz_rough: torch.Tensor) -> torch.Tensor:
    alpha = torch.clamp(fuzz_rough, 0.05, 1.0)
    inv_a = 1.0 / alpha
    sin2 = torch.clamp(1.0 - n_dot_h * n_dot_h, min=1e-8)
    return (2.0 + inv_a) * torch.pow(sin2, inv_a * 0.5) / (2.0 * math.pi)


def v_ashikhmin(n_dot_v: torch.Tensor, n_dot_l: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.clamp(4.0 * (n_dot_l + n_dot_v - n_dot_l * n_dot_v),
                             min=1e-6)


def eval_sheen(n: torch.Tensor, v: torch.Tensor, l: torch.Tensor,
               fuzz_rough: torch.Tensor) -> torch.Tensor:
    """White Charlie-sheen lobe * NoL, shape (..., 1). Multiply by the fuzz
    weight and the radiance at the call site."""
    h = l + v
    h = h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True),
                        min=1e-12)
    n_dot_l = torch.clamp(torch.sum(n * l, -1, keepdim=True), min=0.0)
    n_dot_v = torch.clamp(torch.sum(n * v, -1, keepdim=True), min=1e-4)
    n_dot_h = torch.clamp(torch.sum(n * h, -1, keepdim=True), min=0.0)
    return d_charlie(n_dot_h, fuzz_rough[..., None]) * \
        v_ashikhmin(n_dot_v, n_dot_l) * n_dot_l
