"""The plain reference's shading: GGX with one directional light, the
gradient sky where no triangle covers a pixel, the ACES fit and sRGB, as
the renderer defines its deferred frame with no shadows, ambient or post
effects:

- Cook-Torrance: GGX distribution, height-correlated Smith visibility,
  Schlick Fresnel with F0 = 0.04 for dielectrics and the base colour for
  metals, alpha = roughness^2 (at least 1e-3), n.v at least 1e-4; a
  Lambert diffuse lobe weighted by (1 - F)(1 - metallic); radiance =
  colour x intensity, from the light's reverse direction;
- the sky: the pixel centre's view ray d, horizon (0.45, 0.55, 0.70) to
  zenith (0.10, 0.25, 0.55) by t = d.y / 2 + 1/2 above the horizon, ground
  (0.18, 0.16, 0.14) below, times the sky intensity;
- image = round(255 srgb(aces(hdr x exposure))), ACES by Narkowicz's fit.
"""

from __future__ import annotations

import math

import torch

HORIZON = (0.45, 0.55, 0.70)
ZENITH = (0.10, 0.25, 0.55)
GROUND = (0.18, 0.16, 0.14)


def _unit(v):
    return v / v.norm(dim=-1, keepdim=True).clamp(min=1e-30)


def _dot(a, b):
    return (a * b).sum(-1, keepdim=True)


def ggx_sun(n, v, l, albedo, metallic, roughness, radiance):
    h = _unit(l + v)
    ndl = _dot(n, l).clamp(min=0.0)
    ndv = _dot(n, v).clamp(min=1e-4)
    ndh = _dot(n, h).clamp(min=0.0)
    vdh = _dot(v, h).clamp(min=0.0)
    alpha = (roughness ** 2).clamp(min=1e-3)
    a2 = alpha * alpha
    f0 = 0.04 * (1.0 - metallic) + albedo * metallic
    fres = f0 + (1.0 - f0) * (1.0 - vdh) ** 5
    d = ndh * ndh * (a2 - 1.0) + 1.0
    dist = a2 / (math.pi * d * d).clamp(min=1e-8)
    vis = 0.5 / (ndl * torch.sqrt(ndv * ndv * (1 - a2) + a2)
                 + ndv * torch.sqrt(ndl * ndl * (1 - a2) + a2)).clamp(min=1e-8)
    diffuse = (1.0 - fres) * (1.0 - metallic) * albedo / math.pi * ndl
    return (diffuse + dist * vis * fres * ndl) * radiance


def sky(view: torch.Tensor, fov_y: float, aspect: float, width: int,
        height: int, intensity: float, dtype, device) -> torch.Tensor:
    """(H, W, 3) sky colour along each pixel centre's view ray."""
    t = math.tan(fov_y / 2)
    x = ((torch.arange(width, dtype=dtype, device=device) + 0.5) / width
         * 2 - 1) * t * aspect
    y = (1 - (torch.arange(height, dtype=dtype, device=device) + 0.5)
         / height * 2) * t
    rot = view[:3, :3].to(device, dtype)          # world -> view rows
    d = (rot[0] * x[None, :, None] + rot[1] * y[:, None, None]
         - rot[2])
    d = _unit(d)
    up = (d[..., 1:2] * 0.5 + 0.5).clamp(0.0, 1.0)
    hz, zn, gr = (torch.tensor(c, dtype=dtype, device=device)
                  for c in (HORIZON, ZENITH, GROUND))
    return torch.where(d[..., 1:2] >= 0, hz * (1 - up) + zn * up, gr) \
        * intensity


def aces(x):
    return ((x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14)
            ).clamp(0.0, 1.0)


def srgb(x):
    x = x.clamp(0.0, 1.0)
    return torch.where(x <= 0.0031308, x * 12.92,
                       1.055 * x.clamp(min=1e-12) ** (1 / 2.4) - 0.055)


def to_image(hdr, exposure: float) -> torch.Tensor:
    return torch.floor(srgb(aces(hdr * exposure)) * 255.0 + 0.5) \
        .to(torch.uint8)
