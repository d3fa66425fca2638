"""Post-processing stack: bloom, luminance auto-exposure, GTAO, TAA.

Port of basicrenderer_tpu/ops/post.py. Every pass is plain tensor code
that runs on the device of its inputs; the one kernel of the stack, the
per-tile history warp of the motion-vector TAA resolve, lives in
ops/taa_warp.py.

- Bloom: threshold, a 5-level down chain starting at half resolution in
  (3, H, W) planes, a blurred up chain, added back scaled.
- Auto-exposure: a 256-bin log2-luminance histogram of a point-sampled
  quarter-rate image, clipped to its 5-95% range, its mean as the exposure.
- GTAO: the XeGTAO horizon integral with fixed per-frame screen-space tap
  offsets read as shifted images (the slice set rotates with frame_index).
- TAA: the Halton jitter, the static 3x3-clamped history blend, and the
  motion-vector resolve (tile-warped history, per-pixel residual reject).

Edge padding, JAX's `jnp.pad(mode="edge")` followed by a slice, is spelled
here as an index gather with clamped indices: the same values, and it takes
offsets that live on the device without reading them back.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..graph.framedata import ViewData
from ..utils import math3d
from .shade import _inverse, _iota


def _clamped_index(n: int, shift, length: int, dev) -> torch.Tensor:
    """arange(n) + shift clamped into [0, length - 1], as int64 indices;
    `shift` is an int or a 0-d integer tensor."""
    i = torch.arange(n, device=dev, dtype=torch.int64) + shift
    return torch.clamp(i, 0, length - 1)


def _shift_read(img: torch.Tensor, dy, dx, row_dim: int = 0) -> torch.Tensor:
    """img shifted so that out[y, x] = img[clamp(y + dy), clamp(x + dx)]
    over dims (row_dim, row_dim + 1): an edge-padded image sliced at an
    offset."""
    h, w = img.shape[row_dim], img.shape[row_dim + 1]
    dev = img.device
    rows = _clamped_index(h, dy, h, dev)
    cols = _clamped_index(w, dx, w, dev)
    return img.index_select(row_dim, rows).index_select(row_dim + 1, cols)


# ---------------------------------------------------------------------------
# Bloom
# ---------------------------------------------------------------------------

def _downsample2(img: torch.Tensor) -> torch.Tensor:
    """(h, w, C) 2x box downsample."""
    h, w = img.shape[:2]
    h2, w2 = h // 2, w // 2
    return img[:h2 * 2, :w2 * 2].reshape(h2, 2, w2, 2, -1).mean((1, 3))


def _blur3(img: torch.Tensor) -> torch.Tensor:
    """(h, w, C) separable 1-2-1 blur, edge-padded."""
    k = (0.25, 0.5, 0.25)
    horiz = 0
    for dx in range(3):
        horiz = horiz + _shift_read(img, 0, dx - 1) * k[dx]
    out = 0
    for dy in range(3):
        out = out + _shift_read(horiz, dy - 1, 0) * k[dy]
    return out


def _down2_p(img: torch.Tensor) -> torch.Tensor:
    """(C, h, w) plane-layout 2x box downsample."""
    c, h, w = img.shape
    h2, w2 = h // 2, w // 2
    return img[:, :h2 * 2, :w2 * 2].reshape(c, h2, 2, w2, 2).mean((2, 4))


def _blur3_p(img: torch.Tensor) -> torch.Tensor:
    """(C, h, w) separable 1-2-1 blur, edge-padded."""
    v = (_shift_read(img, -1, 0, 1) + 2.0 * img
         + _shift_read(img, 1, 0, 1)) * 0.25
    return (_shift_read(v, 0, -1, 1) + 2.0 * v
            + _shift_read(v, 0, 1, 1)) * 0.25


def _up2_p(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(C, h2, w2) -> (C, h, w): pixel repeat (edge-extended past 2x) and a
    tent smooth."""
    up = img.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    dev = img.device
    rows = torch.clamp(torch.arange(h, device=dev), max=up.shape[1] - 1)
    cols = torch.clamp(torch.arange(w, device=dev), max=up.shape[2] - 1)
    return _blur3_p(up.index_select(1, rows).index_select(2, cols))


def bloom(hdr: torch.Tensor, threshold, intensity, mips: int = 5
          ) -> torch.Tensor:
    """(H, W, 3) HDR -> HDR plus bloom: threshold, mip down chain starting
    at half resolution in (3, h, w) planes, blurred up chain, add."""
    lum = hdr[..., 0] * 0.2126 + hdr[..., 1] * 0.7152 + hdr[..., 2] * 0.0722
    scale = torch.clamp((lum - threshold) / torch.clamp(threshold, min=1e-3),
                        0.0, 1e3)
    bright = hdr * scale[..., None]
    H0, W0 = bright.shape[:2]
    h2, w2 = H0 // 2, W0 // 2
    rows = bright[:h2 * 2].reshape(h2, 2, W0, 3)[:, 0]
    half = rows[:, :w2 * 2].reshape(h2, w2, 2, 3).mean(2)
    chain = [half.permute(2, 0, 1)]
    for _ in range(mips - 2):
        chain.append(_blur3_p(_down2_p(chain[-1])))
    up = chain[-1]
    for m in range(len(chain) - 2, -1, -1):
        _c, h, w = chain[m].shape
        up = chain[m] + _up2_p(up, h, w)
    H, W = hdr.shape[:2]
    return hdr + _up2_p(up, H, W).permute(1, 2, 0) * (intensity / mips)


# ---------------------------------------------------------------------------
# Luminance histogram + auto exposure
# ---------------------------------------------------------------------------

def luminance_histogram(hdr: torch.Tensor, bins: int = 256,
                        log_min: float = -10.0, log_max: float = 6.0,
                        downscale: int = 4) -> torch.Tensor:
    """(bins,) i32 counts of log2 luminance over the image point-sampled
    every `downscale` pixels, each sample counting downscale^2 pixels.
    An integer scatter-add gives the counts the JAX package sums from a
    one-hot matrix, with no read-back (`torch.bincount` reads its largest
    index back to the host)."""
    lum = hdr[..., 0] * 0.2126 + hdr[..., 1] * 0.7152 + hdr[..., 2] * 0.0722
    ds = downscale
    h, w = lum.shape
    if ds > 1:
        lum = lum[:h // ds * ds:ds, :w // ds * ds:ds]
    loglum = torch.log2(torch.clamp(lum, min=1e-6))
    t = torch.clamp((loglum - log_min) / (log_max - log_min), 0.0, 1.0)
    idx = torch.clamp((t * bins).to(torch.int32), 0, bins - 1)
    idx = idx.reshape(-1).to(torch.int64)
    counts = torch.zeros(bins, dtype=torch.int64, device=idx.device) \
        .scatter_add_(0, idx, torch.ones_like(idx))
    return (counts * (downscale * downscale)).to(torch.int32)


def auto_exposure(hdr: torch.Tensor, target_gray: float = 0.18,
                  low_clip: float = 0.05, high_clip: float = 0.95,
                  bins: int = 256, log_min: float = -10.0,
                  log_max: float = 6.0) -> torch.Tensor:
    """Histogram-clipped geometric-mean exposure: a 0-d multiplier on the
    device of `hdr` (no read-back)."""
    hist = luminance_histogram(hdr, bins, log_min, log_max).to(torch.float32)
    cdf = torch.cumsum(hist, 0)
    total = cdf[-1]
    lo = low_clip * total
    hi = high_clip * total
    prev = torch.cat([torch.zeros((1,), dtype=torch.float32,
                                  device=hdr.device), cdf[:-1]])
    inside = torch.clamp(torch.minimum(cdf, hi) - torch.maximum(prev, lo),
                         min=0.0)
    centers = log_min + (torch.arange(bins, dtype=torch.float32,
                                      device=hdr.device) + 0.5) \
        / bins * (log_max - log_min)
    avg_log = torch.sum(inside * centers) / torch.clamp(torch.sum(inside),
                                                        min=1.0)
    avg_lum = torch.exp2(avg_log)
    return target_gray / torch.clamp(avg_lum, min=1e-5)


# ---------------------------------------------------------------------------
# GTAO
# ---------------------------------------------------------------------------

def linearize_depth(depth: torch.Tensor, near) -> torch.Tensor:
    """Reverse-Z NDC -> view-space distance (infinite-far projection)."""
    return near / torch.clamp(depth, min=1e-6)


def gtao_angles(frame_index: torch.Tensor, num_dirs: int = 2
                ) -> List[torch.Tensor]:
    """The slice angles of a frame: pi * (frame_index % 4) / (4 * num_dirs)
    plus d * pi / num_dirs, as f32 0-d tensors."""
    base = math.pi * (frame_index.to(torch.float32) % 4.0) / (4.0 * num_dirs)
    return [base + d * math.pi / num_dirs for d in range(num_dirs)]


def gtao_taps(radius: torch.Tensor, frame_index: torch.Tensor,
              num_dirs: int = 2, num_steps: int = 3, pad: int = 96
              ) -> List[List[Tuple[torch.Tensor, torch.Tensor]]]:
    """The integer screen offsets (dy, dx) of every (direction, step) tap,
    int32 0-d tensors on the device of `radius`: (sin, cos)(angle) times the
    step's pixel radius, truncated toward zero, clipped to +-pad."""
    taps = []
    for ang in gtao_angles(frame_index, num_dirs):
        ca, sa = torch.cos(ang), torch.sin(ang)
        row = []
        for s in range(1, num_steps + 1):
            r_px = radius * s * 24.0 / num_steps
            dx = torch.clamp((ca * r_px).to(torch.int32), -pad, pad)
            dy = torch.clamp((sa * r_px).to(torch.int32), -pad, pad)
            row.append((dy, dx))
        taps.append(row)
    return taps


def gtao(depth: torch.Tensor, normal: torch.Tensor, view: ViewData,
         near, radius, intensity, frame_index,
         num_dirs: int = 2, num_steps: int = 3, pad: int = 96
         ) -> torch.Tensor:
    """(H, W) ground-truth ambient occlusion in [0, 1] (1 = unoccluded):
    per slice, march both sides for the max horizon cosines, project the
    normal onto the slice plane and evaluate XeGTAO's cosine-weighted
    visible arc, weighted by the projected normal length."""
    del near   # the JAX signature carries it; the world-space march needs none
    H, W = depth.shape
    dev = depth.device
    ndc_x = (_iota(W, 1, (H, W), dev) + 0.5) / W * 2.0 - 1.0
    ndc_y = 1.0 - (_iota(H, 0, (H, W), dev) + 0.5) / H * 2.0
    inv_vp = _inverse(view.viewproj)
    ux, uy, uz, uw = math3d.mat4_columns(inv_vp, ndc_x, ndc_y, depth)
    iw = 1.0 / torch.where(torch.abs(uw) > 1e-12, uw, 1.0)
    px, py, pz = ux * iw, uy * iw, uz * iw
    vx = view.cam_pos[0] - px
    vy = view.cam_pos[1] - py
    vz = view.cam_pos[2] - pz
    il = torch.rsqrt(torch.clamp(vx * vx + vy * vy + vz * vz, min=1e-12))
    vx, vy, vz = vx * il, vy * il, vz * il
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    r_world = radius * 8.0
    pstack = torch.stack([px, py, pz])                  # (3, H, W)
    half_pi = math.pi / 2
    taps = gtao_taps(radius, frame_index, num_dirs, num_steps, pad)
    visibility = torch.zeros((H, W), dtype=torch.float32, device=dev)
    for d, ang in enumerate(gtao_angles(frame_index, num_dirs)):
        ca, sa = torch.cos(ang), torch.sin(ang)
        ox, oy, oz, ow = math3d.mat4_columns(
            inv_vp, ndc_x + ca * 2.0 / W, ndc_y - sa * 2.0 / H, depth)
        iow = 1.0 / torch.where(torch.abs(ow) > 1e-12, ow, 1.0)
        dxw = ox * iow - px
        dyw = oy * iow - py
        dzw = oz * iow - pz
        t = dxw * vx + dyw * vy + dzw * vz
        gx, gy, gz = dxw - t * vx, dyw - t * vy, dzw - t * vz
        gl = torch.rsqrt(torch.clamp(gx * gx + gy * gy + gz * gz, min=1e-18))
        gx, gy, gz = gx * gl, gy * gl, gz * gl
        n_v = nx * vx + ny * vy + nz * vz
        n_o = nx * gx + ny * gy + nz * gz
        proj_len = torch.sqrt(torch.clamp(n_v * n_v + n_o * n_o, min=1e-12))
        cos_norm = torch.clamp(n_v / proj_len, 0.0, 1.0)
        n_ang = torch.sign(n_o) * torch.arccos(cos_norm)
        sin_n = torch.sin(n_ang)
        hcos_pos = -sin_n
        hcos_neg = sin_n
        for s in range(num_steps):
            dy, dx = taps[d][s]
            for sgn in (1, -1):
                sp = _shift_read(pstack, sgn * dy, sgn * dx, row_dim=1)
                ex, ey, ez = sp[0] - px, sp[1] - py, sp[2] - pz
                dist2 = ex * ex + ey * ey + ez * ez
                idist = torch.rsqrt(torch.clamp(dist2, min=1e-12))
                cos_s = (ex * vx + ey * vy + ez * vz) * idist
                w = torch.clamp(1.0 - dist2 / (r_world * r_world), 0.0, 1.0)
                w = torch.where(dist2 > 1e-10, w, 0.0)
                if sgn > 0:
                    adj = hcos_pos + w * (cos_s - hcos_pos)
                    hcos_pos = torch.maximum(hcos_pos, adj)
                else:
                    adj = hcos_neg + w * (cos_s - hcos_neg)
                    hcos_neg = torch.maximum(hcos_neg, adj)
        h_pos = n_ang + torch.clamp(
            torch.arccos(torch.clamp(hcos_pos, -1.0, 1.0)) - n_ang,
            -half_pi, half_pi)
        h_neg = n_ang + torch.clamp(
            -torch.arccos(torch.clamp(hcos_neg, -1.0, 1.0)) - n_ang,
            -half_pi, half_pi)
        arc = (cos_norm + 2.0 * h_pos * sin_n - torch.cos(2.0 * h_pos - n_ang)
               + cos_norm + 2.0 * h_neg * sin_n
               - torch.cos(2.0 * h_neg - n_ang)) * 0.25
        visibility = visibility + proj_len * arc
    vis = torch.clamp(visibility / num_dirs, 0.0, 1.0)
    ao = 1.0 - intensity * (1.0 - vis)
    return torch.clamp(_box3(ao), 0.0, 1.0)


def _shift2d(img: torch.Tensor, dy, dx) -> torch.Tensor:
    """(H, W) read at (y + dy, x + dx), edge-extended, for |dy| <= H and
    |dx| <= W (the JAX package pads by one image on each side)."""
    return _shift_read(img, dy, dx)


def _box3(img: torch.Tensor) -> torch.Tensor:
    """(H, W) 3x3 box mean, edge-padded."""
    acc = 0
    for dy in range(3):
        for dx in range(3):
            acc = acc + _shift_read(img, dy - 1, dx - 1)
    return acc / 9.0


# ---------------------------------------------------------------------------
# TAA
# ---------------------------------------------------------------------------

HALTON_23 = np.array([
    [0.5, 0.333333], [0.25, 0.666667], [0.75, 0.111111], [0.125, 0.444444],
    [0.625, 0.777778], [0.375, 0.222222], [0.875, 0.555556], [0.0625, 0.888889],
], np.float32) - 0.5


def taa_jitter(frame_index: int) -> np.ndarray:
    """Sub-pixel NDC jitter (x, y) for the projection matrix."""
    return HALTON_23[int(frame_index) % 8]


def _neighbourhood_clamp(current: torch.Tensor, history: torch.Tensor
                         ) -> torch.Tensor:
    """History clipped into the min/max box of current's 3x3 neighbourhood
    (edge-padded)."""
    neigh = torch.stack([_shift_read(current, dy - 1, dx - 1)
                         for dy in range(3) for dx in range(3)])
    return torch.minimum(torch.maximum(history, neigh.amin(0)),
                         neigh.amax(0))


def taa_resolve(current: torch.Tensor, history: Optional[torch.Tensor],
                blend) -> torch.Tensor:
    """Camera-static history blend with the 3x3 neighbourhood clamp (the
    jitter in the projection makes successive frames sample different
    sub-pixels)."""
    if history is None:
        return current
    hist = _neighbourhood_clamp(current, history)
    return current * blend + hist * (1.0 - blend)


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(h, w) -> (out_h, out_w) as jax.image.resize(..., "nearest"): output
    pixel i reads input floor((i + 0.5) * n_in / n_out), in f32."""
    dev = x.device
    for dim, n in ((0, out_h), (1, out_w)):
        m = x.shape[dim]
        if m == n:
            continue
        off = (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) * m / n
        x = x.index_select(dim, torch.floor(off).to(torch.int64))
    return x


def taa_resolve_mv(current: torch.Tensor, history: Optional[torch.Tensor],
                   blend, tile_dy: torch.Tensor, tile_dx: torch.Tensor,
                   residual: torch.Tensor, tile_h: int, tile_w: int,
                   reject_px: float = 1.5) -> torch.Tensor:
    """Motion-vector TAA resolve: history warped per tile by the tile's
    mean motion (ops/taa_warp.py: the kernel on CUDA tensors), clamped to
    the current 3x3 neighbourhood; pixels whose own motion disagrees with
    their tile's by more than `reject_px` (`residual`, at any reduced rate,
    resized to (H, W) nearest) drop history."""
    if history is None:
        return current
    from .taa_warp import warp_history
    H, W = current.shape[:2]
    ph, pw = (-H) % tile_h, (-W) % tile_w
    if ph or pw:
        dev = history.device
        rows = torch.clamp(torch.arange(H + ph, device=dev), max=H - 1)
        cols = torch.clamp(torch.arange(W + pw, device=dev), max=W - 1)
        hist_p = history.index_select(0, rows).index_select(1, cols)
    else:
        hist_p = history
    hist = warp_history(hist_p.contiguous(), tile_dy, tile_dx, tile_h,
                        tile_w)[:H, :W]
    hist = _neighbourhood_clamp(current, hist)
    if tuple(residual.shape) != (H, W):
        residual = resize_nearest(residual, H, W)
    w_cur = torch.where(residual > reject_px, 1.0, blend)[..., None]
    return current * w_cur + hist * (1.0 - w_cur)
