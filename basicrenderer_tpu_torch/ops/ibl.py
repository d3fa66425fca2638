"""Image-based lighting: environment precompute + runtime ambient terms.

Port of basicrenderer_tpu/ops/ibl.py.

- Precompute, once per environment and off the frame path: an equirect
  panorama resampled to a cubemap (bilinear, wrapping in longitude),
  cubemap face directions, 9-coefficient SH radiance projection with solid-angle
  weights, GGX importance-sampled prefiltered radiance mips.
- Runtime diffuse: SH irradiance evaluated per pixel (closed form).
- Runtime specular: the Karis analytic fit of the split-sum environment
  BRDF, and the prefiltered radiance looked up nearest-texel at
  1/downscale rate in the mip pair around the roughness, bilinearly
  upsampled.
Cubemap faces are ordered +X, -X, +Y, -Y, +Z, -Z.
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import numpy as np
import torch

from .shadows import downsample2d
from .textures import resize_bilinear
from ..utils.math3d import sqrt_rn


def face_directions(res: int, device="cuda") -> torch.Tensor:
    """(6, res, res, 3) unit direction of each cubemap texel centre."""
    t = (torch.arange(res, dtype=torch.float32, device=device) + 0.5) \
        / res * 2.0 - 1.0
    v, u = torch.meshgrid(t, t, indexing="ij")   # v = down the face rows
    one = torch.ones_like(u)
    faces = [
        torch.stack([one, -v, -u], -1),    # +X
        torch.stack([-one, -v, u], -1),    # -X
        torch.stack([u, one, v], -1),      # +Y
        torch.stack([u, -one, -v], -1),    # -Y
        torch.stack([u, -v, one], -1),     # +Z
        torch.stack([-u, -v, -one], -1),   # -Z
    ]
    d = torch.stack(faces)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def sample_equirect(equirect: torch.Tensor, dirs: torch.Tensor
                    ) -> torch.Tensor:
    """Bilinear sample of an equirect (H, W, 3) image along (..., 3) dirs
    (precompute): longitude wraps, latitude clamps."""
    H, W = equirect.shape[:2]
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    u = (torch.atan2(x, -z) / (2 * math.pi) + 0.5) * W - 0.5
    v = (torch.arccos(torch.clamp(y, -1, 1)) / math.pi) * H - 0.5
    u0 = torch.floor(u).to(torch.int64)
    v0 = torch.floor(v).to(torch.int64)
    fu = u - u0
    fv = v - v0
    flat = equirect.reshape(-1, 3)

    def tex(ui, vi):
        return flat[torch.clamp(vi, 0, H - 1) * W + torch.remainder(ui, W)]

    return (tex(u0, v0) * ((1 - fu) * (1 - fv))[..., None]
            + tex(u0 + 1, v0) * (fu * (1 - fv))[..., None]
            + tex(u0, v0 + 1) * ((1 - fu) * fv)[..., None]
            + tex(u0 + 1, v0 + 1) * (fu * fv)[..., None])


def equirect_to_cubemap(equirect: torch.Tensor, res: int = 128
                        ) -> torch.Tensor:
    """(H, W, 3) equirect -> (6, res, res, 3) cubemap (precompute)."""
    return sample_equirect(equirect, face_directions(res, equirect.device))


def _sh_basis(d: torch.Tensor) -> torch.Tensor:
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.stack([
        0.282095 * torch.ones_like(x),
        0.488603 * y, 0.488603 * z, 0.488603 * x,
        1.092548 * x * y, 1.092548 * y * z,
        0.315392 * (3 * z * z - 1.0),
        1.092548 * x * z, 0.546274 * (x * x - y * y),
    ], dim=-1)


def project_sh(cubemap: torch.Tensor) -> torch.Tensor:
    """Cubemap radiance (6, R, R, 3) -> 9 RGB SH coefficients (9, 3), each
    texel weighted by its solid angle du dv / (1 + u^2 + v^2)^(3/2)."""
    res = cubemap.shape[1]
    dev = cubemap.device
    d = face_directions(res, dev)
    t = (torch.arange(res, dtype=torch.float32, device=dev) + 0.5) \
        / res * 2.0 - 1.0
    v, u = torch.meshgrid(t, t, indexing="ij")
    tmp = 1.0 + u * u + v * v
    dw = (2.0 / res) ** 2 / (torch.sqrt(tmp) * tmp)
    dw = dw.expand(6, res, res)
    basis = _sh_basis(d)                                   # (6, R, R, 9)
    return torch.einsum("frcb,frc,frck->bk", basis, dw, cubemap)


_SH_LOBE = (3.141593, 2.094395, 2.094395, 2.094395,
            0.785398, 0.785398, 0.785398, 0.785398, 0.785398)


def eval_sh_irradiance(sh: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """Convolved irradiance E(n) / pi from radiance SH (Ramamoorthi-Hanrahan
    cosine-lobe weights): (..., 3) linear diffuse irradiance."""
    A = torch.tensor(_SH_LOBE, dtype=torch.float32, device=sh.device)
    basis = _sh_basis(normals)                             # (..., 9)
    e = torch.einsum("...b,b,bk->...k", basis, A, sh)
    return torch.clamp(e, min=0.0) / math.pi


def _hammersley(n: int) -> np.ndarray:
    i = np.arange(n)
    bits = i.astype(np.uint32)
    bits = (bits << 16) | (bits >> 16)
    bits = ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)
    bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
    bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
    bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
    return np.stack([i / n, bits.astype(np.float64) * 2.3283064365386963e-10], -1)


def prefilter_specular(cubemap: torch.Tensor, mips: int = 5,
                       samples: int = 64) -> List[torch.Tensor]:
    """GGX importance-sampled prefiltered radiance mips: a list of
    (6, r, r, 3), r halving per mip (at least 8); mip m ~ roughness
    m / (mips - 1)."""
    base = cubemap.shape[1]
    dev = cubemap.device
    out = []
    for m in range(mips):
        r = max(base >> m, 8)
        rough = m / max(mips - 1, 1)
        dirs = face_directions(r, dev)                     # N = R (= V)
        if rough < 1e-3:
            out.append(sample_cubemap_precompute(cubemap, dirs))
            continue
        xi = torch.as_tensor(_hammersley(samples), dtype=torch.float32,
                             device=dev)
        a = rough * rough
        phi = 2 * math.pi * xi[:, 0]
        cos_t = sqrt_rn((1 - xi[:, 1]) / (1 + (a * a - 1) * xi[:, 1]))
        sin_t = sqrt_rn(torch.clamp(1 - cos_t ** 2, min=0))
        hx = sin_t * torch.cos(phi)
        hy = sin_t * torch.sin(phi)
        hz = cos_t                                          # (S,)
        n = dirs[..., None, :]                              # (6, r, r, 1, 3)
        up = torch.where(torch.abs(n[..., 2:3]) < 0.999,
                         torch.tensor([0, 0, 1.0], device=dev),
                         torch.tensor([1.0, 0, 0], device=dev))
        tgx = torch.linalg.cross(up, n)
        tgx = tgx / torch.clamp(torch.linalg.vector_norm(
            tgx, dim=-1, keepdim=True), min=1e-9)
        tgy = torch.linalg.cross(n, tgx)
        h = tgx * hx[:, None] + tgy * hy[:, None] + n * hz[:, None]
        v = n
        l = 2.0 * torch.sum(v * h, -1, keepdim=True) * h - v  # (6,r,r,S,3)
        ndl = torch.clamp(torch.sum(n * l, -1, keepdim=True), min=0.0)
        rad = sample_cubemap_precompute(cubemap, l)        # (6,r,r,S,3)
        col = torch.sum(rad * ndl, dim=-2) / torch.clamp(
            torch.sum(ndl, dim=-2), min=1e-4)
        out.append(col)
    return out


def _cube_face_uv(dirs: torch.Tensor):
    """Face index and face-local (u, v) over max-axis of (..., 3) dirs, in
    face_directions' conventions."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)
    face = torch.where(is_x, torch.where(x > 0, 0, 1),
                       torch.where(is_y, torch.where(y > 0, 2, 3),
                                   torch.where(z > 0, 4, 5)))
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az))
    u = torch.where(is_x, torch.where(x > 0, -z, z),
                    torch.where(is_y, x, torch.where(z > 0, x, -x)))
    v = torch.where(is_x, -y, torch.where(is_y, torch.where(y > 0, z, -z),
                                          -y))
    return face, ma, u, v


def _texel(coord: torch.Tensor, ma: torch.Tensor, res: int) -> torch.Tensor:
    """Nearest texel index of a face coordinate (round half to even)."""
    t = (coord / torch.clamp(ma, min=1e-9) + 1.0) * 0.5 * res - 0.5
    return torch.clamp(torch.round(t).to(torch.int32), 0, res - 1)


def sample_cubemap_precompute(cubemap: torch.Tensor, dirs: torch.Tensor
                              ) -> torch.Tensor:
    """Nearest-texel cubemap sample along (..., 3) dirs (precompute)."""
    res = cubemap.shape[1]
    face, ma, u, v = _cube_face_uv(dirs)
    ui, vi = _texel(u, ma, res), _texel(v, ma, res)
    flat = cubemap.reshape(-1, 3)
    return flat[((face * res + vi) * res + ui).long()]


def env_brdf_karis(n_dot_v: torch.Tensor, roughness: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Karis mobile analytic fit of the split-sum environment BRDF:
    (scale, bias)."""
    c0 = (-1.0, -0.0275, -0.572, 0.022)
    c1 = (1.0, 0.0425, 1.04, -0.04)
    r = [roughness * a + b for a, b in zip(c0, c1)]
    a004 = torch.minimum(r[0] * r[0], torch.exp2(-9.28 * n_dot_v)) * r[0] + r[1]
    scale = a004 * -1.04 + r[2]
    bias = a004 * 1.04 + r[3]
    return scale, bias


def make_procedural_environment(res: int = 128, intensity: float = 1.0,
                                sun_dir=(-0.45, -1.0, -0.3), device="cuda"
                                ) -> torch.Tensor:
    """The procedural gradient sky (ops/shade.procedural_sky) plus a sun
    disk baked into a (6, res, res, 3) cubemap."""
    d = face_directions(res, device)
    t = torch.clamp(d[..., 1] * 0.5 + 0.5, 0.0, 1.0)[..., None]

    def rgb(*c):
        return torch.tensor(c, dtype=torch.float32, device=device)

    horizon, zenith = rgb(0.45, 0.55, 0.70), rgb(0.10, 0.25, 0.55)
    ground = rgb(0.18, 0.16, 0.14)
    sky = horizon * (1 - t) + zenith * t
    col = torch.where(d[..., 1:2] >= 0.0, sky, ground) * intensity
    sun = -torch.tensor(sun_dir, dtype=torch.float32, device=device)
    sun = sun / torch.linalg.vector_norm(sun)
    cd = torch.sum(d * sun, -1, keepdim=True)
    return col + torch.where(cd > 0.9995, 50.0, 0.0) * rgb(1.0, 0.95, 0.85)


def runtime_specular_ibl(normals: torch.Tensor, view_dirs: torch.Tensor,
                         roughness: torch.Tensor, env_mips: torch.Tensor,
                         downscale: int = 2,
                         upsample: Callable = None) -> torch.Tensor:
    """Prefiltered radiance at 1/downscale rate, bilinearly upsampled
    (by `upsample(img, H, W)` when given: a shard's seam-exact resize,
    graph/frame.halo_upsample).

    normals / view_dirs: (H, W, 3); env_mips: (M, 6, r, r, 3), every mip
    at one resolution, so the mip pick is a lerp between two gathers.
    Returns (H, W, 3)."""
    H, W = roughness.shape
    n = torch.stack([downsample2d(normals[..., c], downscale)
                     for c in range(3)], dim=-1)
    v = torch.stack([downsample2d(view_dirs[..., c], downscale)
                     for c in range(3)], dim=-1)
    rg = downsample2d(roughness, downscale)
    r_refl = 2.0 * torch.sum(n * v, -1, keepdim=True) * n - v
    M = env_mips.shape[0]
    mip_f = torch.clamp(rg * (M - 1), 0, M - 1)
    m0 = torch.floor(mip_f).to(torch.int32)
    fm = (mip_f - m0)[..., None]
    res = env_mips.shape[2]
    flat = env_mips.reshape(-1, 3)
    face, ma, u, vv = _cube_face_uv(r_refl)
    ui, vi = _texel(u, ma, res), _texel(vv, ma, res)

    def samp(mi):
        return flat[(((mi * 6 + face) * res + vi) * res + ui).long()]

    c = samp(m0) * (1 - fm) + samp(torch.clamp(m0 + 1, max=M - 1)) * fm
    if upsample is not None:
        return upsample(c, H, W)
    return resize_bilinear(c, H, W, row_dim=0)
