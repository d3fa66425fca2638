"""Screen-space reflections.

Port of basicrenderer_tpu/ops/ssr.py. The march runs at 1/ssr_downscale
rate: receivers unproject from the point-sampled depth plane, reflect the
view ray about the normal, and step linearly in (screen, NDC depth) - exact
under the infinite reverse-Z projection. All rays take ssr_coarse_steps
lockstep coarse steps against a block-max depth mip (conservative under
reverse-Z), then bisect inside their first bracketing interval; a final
sample with a thickness band decides the hit, and the lit colour at the
hit is gathered. Roughness, facing and screen-edge fades weight the
result, which is bilinearly upsampled back to full rate.
"""

from __future__ import annotations

import math

import torch

from ..graph.framedata import FrameConfig, ViewData
from ..utils import math3d
from .shade import _inverse, _iota
from .shadows import downsample2d
from .textures import resize_bilinear


def ssr(hdr: torch.Tensor, depth: torch.Tensor, normal: torch.Tensor,
        roughness: torch.Tensor, metallic: torch.Tensor, view: ViewData,
        config: FrameConfig, full_h: int = None):
    """Returns (reflection (H, W, 3), weight (H, W)) to composite into the
    specular term. All inputs full-rate; the march runs at
    config.ssr_downscale."""
    del metallic   # the JAX signature carries it; the weights need none
    H, W = depth.shape
    full_h = full_h or H
    ds = config.ssr_downscale
    steps = config.ssr_steps
    d = downsample2d(depth, ds)
    h, w = d.shape
    dev = d.device

    nx = downsample2d(normal[..., 0], ds)
    ny = downsample2d(normal[..., 1], ds)
    nz = downsample2d(normal[..., 2], ds)
    rg = downsample2d(roughness, ds)

    sx = _iota(w, 1, (h, w), dev) * ds + 0.5
    sy = _iota(h, 0, (h, w), dev) * ds + 0.5
    ndc_x = sx / W * 2.0 - 1.0
    ndc_y = 1.0 - sy / full_h * 2.0
    inv_vp = _inverse(view.viewproj)
    px, py, pz, pw = math3d.mat4_columns(inv_vp, ndc_x, ndc_y, d)
    iw = 1.0 / torch.where(torch.abs(pw) > 1e-12, pw, 1.0)
    px, py, pz = px * iw, py * iw, pz * iw

    vx = px - view.cam_pos[0]
    vy = py - view.cam_pos[1]
    vz = pz - view.cam_pos[2]
    vl = torch.sqrt(vx * vx + vy * vy + vz * vz)
    il = 1.0 / torch.clamp(vl, min=1e-6)
    vx, vy, vz = vx * il, vy * il, vz * il
    vdotn = vx * nx + vy * ny + vz * nz
    rx = vx - 2.0 * vdotn * nx
    ry = vy - 2.0 * vdotn * ny
    rz = vz - 2.0 * vdotn * nz

    dist = config.ssr_max_distance
    cx, cy, cz, cw = math3d.mat4_columns(
        view.viewproj, px + rx * dist, py + ry * dist, pz + rz * dist)
    wv = torch.where(torch.abs(cw) > 1e-6, cw, 1e-6)
    ex = (cx / wv * 0.5 + 0.5) * W
    ey = (0.5 - cy / wv * 0.5) * full_h
    ez = cz / wv
    behind = cw <= 1e-4

    x0, y0, z0 = sx, sy, d

    # Coarse lockstep march against the block-max mip.
    coarse = config.ssr_coarse_steps
    cc = 4
    hc, wc = max(h // cc, 1), max(w // cc, 1)
    dsrc = d
    if h < hc * cc or w < wc * cc:
        dsrc = torch.nn.functional.pad(d, (0, max(wc * cc - w, 0),
                                           0, max(hc * cc - h, 0)))
    dc = dsrc[:hc * cc, :wc * cc].reshape(hc, cc, wc, cc).amax((1, 3))
    dc_flat = dc.reshape(-1)
    dx_c = (ex - x0) / coarse
    dy_c = (ey - y0) / coarse
    dz_c = (ez - z0) / coarse

    c_any = torch.zeros((h, w), dtype=torch.bool, device=dev)
    c_step = torch.full((h, w), float(coarse), dtype=torch.float32, device=dev)
    for s in range(1, coarse + 1):
        xs = x0 + dx_c * s
        ys = y0 + dy_c * s
        zs = z0 + dz_c * s
        ui = torch.clamp((xs / (ds * cc)).to(torch.int32), 0, wc - 1)
        vi = torch.clamp((ys / (ds * cc)).to(torch.int32), 0, hc - 1)
        zd = dc_flat[(vi * wc + ui).long()]
        on = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < full_h)
        crossed = on & (zd > zs)
        first = crossed & ~c_any
        c_step = torch.where(first, float(s), c_step)
        c_any = c_any | crossed

    # Bisection inside [c_step - 1, c_step].
    nbis = max(1, math.ceil(math.log2(steps))) if steps > 1 else 1
    lo = c_step - 1.0
    hi = c_step
    thick = config.ssr_thickness
    d_flat = d.reshape(-1)

    def sample(t):
        xs = x0 + dx_c * t
        ys = y0 + dy_c * t
        zs = z0 + dz_c * t
        ui = torch.clamp((xs / ds).to(torch.int32), 0, w - 1)
        vi = torch.clamp((ys / ds).to(torch.int32), 0, h - 1)
        zd = d_flat[(vi * w + ui).long()]
        on = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < full_h)
        return xs, ys, zs, zd, on

    for _ in range(nbis):
        mid = 0.5 * (lo + hi)
        _, _, zs, zd, on = sample(mid)
        crossed = on & (zd > zs)
        lo = torch.where(crossed, lo, mid)
        hi = torch.where(crossed, mid, hi)

    xs, ys, zs, zd, on = sample(hi)
    hit_any = c_any & on & (zd > 0) & (zd > zs) & (zd < zs + thick)
    cidx = (torch.clamp(ys.to(torch.int32), 0, H - 1) * W
            + torch.clamp(xs.to(torch.int32), 0, W - 1))
    col = hdr.reshape(-1, 3)[cidx.long()]

    wgt = torch.clamp(1.0 - rg * 2.0, 0.0, 1.0)
    wgt = wgt * torch.clamp(-vdotn * 4.0, 0.0, 1.0)
    edge_x = torch.clamp(torch.minimum(xs, W - xs) / (0.1 * W), 0.0, 1.0)
    edge_y = torch.clamp(torch.minimum(ys, full_h - ys) / (0.1 * full_h),
                         0.0, 1.0)
    wgt = wgt * edge_x * edge_y
    wgt = torch.where(hit_any & ~behind & (d > 0), wgt, 0.0)

    if ds > 1:
        col = resize_bilinear(col, H, W, row_dim=0)
        wgt = resize_bilinear(wgt, H, W, row_dim=0)
    return col, wgt
