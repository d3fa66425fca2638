"""Per-pixel motion vectors and per-tile motion aggregation for TAA.

Port of basicrenderer_tpu/ops/motion.py. Camera motion is column math:
unproject from depth with the current inverse view-projection and
re-project with the previous (un-jittered) one. A small budget of moved
objects (ids and relative matrices prev_viewproj @ prev_model @
inv(cur_model)) overrides the static reprojection where the object id of
the combo channel matches. Motion is computed at a reduced rate and
averaged per raster tile; each pixel's disagreement with its tile's mean
is the residual that rejects history in ops/post.taa_resolve_mv.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..graph.framedata import FrameConfig, ViewData
from ..utils import math3d
from .raster_setup import OBJ_COMBO
from .shade import _inverse, _iota
from .shadows import downsample2d

MAX_MOVING = 16   # budget for per-object motion corrections per frame


def motion_field(depth: torch.Tensor, combo_ch: torch.Tensor, view: ViewData,
                 prev_viewproj: torch.Tensor, moving_rel: torch.Tensor,
                 moving_ids: torch.Tensor, config: FrameConfig,
                 ds: int = 2, full_h: int = None, full_w: int = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Returns (du, dv, valid, effective_ds) at 1/ds rate, in full-rate
    pixel units: (du, dv) = previous screen xy - current screen xy.

    depth: (H, W) reverse-Z NDC; combo_ch: (H, W) f32 combo channel
    (material + OBJ_COMBO * object); moving_rel: (MAX_MOVING, 4, 4) f32;
    moving_ids: (MAX_MOVING,) i32 object ids (-1 = unused slot)."""
    del config   # the JAX signature carries it; the field needs none
    H, W = depth.shape
    full_h = full_h or H
    full_w = full_w or W
    while ds > 1 and (H % ds or W % ds):
        ds -= 1
    d = downsample2d(depth, ds)
    combo = downsample2d(combo_ch, ds)
    obj = torch.div(torch.round(combo).to(torch.int32), OBJ_COMBO,
                    rounding_mode="floor")
    h, w = d.shape
    dev = d.device

    sx = _iota(w, 1, (h, w), dev) * ds + 0.5
    sy = _iota(h, 0, (h, w), dev) * ds + 0.5
    ndc_x = sx / full_w * 2.0 - 1.0
    ndc_y = 1.0 - sy / full_h * 2.0
    inv_vp = _inverse(view.viewproj)
    px, py, pz, pw = math3d.mat4_columns(inv_vp, ndc_x, ndc_y, d)
    iw = 1.0 / torch.where(torch.abs(pw) > 1e-12, pw, 1.0)
    px, py, pz = px * iw, py * iw, pz * iw

    cx, cy, _cz, cw = math3d.mat4_columns(prev_viewproj, px, py, pz)
    for k in range(MAX_MOVING):
        mk = (obj == moving_ids[k]) & (moving_ids[k] >= 0)
        kx, ky, _kz, kw = math3d.mat4_columns(moving_rel[k], px, py, pz)
        cx = torch.where(mk, kx, cx)
        cy = torch.where(mk, ky, cy)
        cw = torch.where(mk, kw, cw)

    front = cw > 1e-6
    qi = 1.0 / torch.where(front, cw, 1.0)
    prev_sx = (cx * qi * 0.5 + 0.5) * full_w
    prev_sy = (0.5 - cy * qi * 0.5) * full_h
    du = prev_sx - sx
    dv = prev_sy - sy
    valid = (d > 0.0) & front
    return du, dv, valid, ds


def tile_motion(du: torch.Tensor, dv: torch.Tensor, valid: torch.Tensor,
                config: FrameConfig, ds: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mean motion per raster tile. du/dv/valid at 1/ds rate; returns
    (tile_dy, tile_dx) each (tiles_y * tiles_x,) f32 in full-rate pixels,
    and the per-pixel residual magnitude (same 1/ds rate) against the tile
    mean."""
    th, tw = config.tile_h // ds, config.tile_w // ds
    h, w = du.shape
    ty, tx = h // th, w // tw

    def tile_mean(x, m):
        xt = (x * m).reshape(ty, th, tx, tw).sum((1, 3))
        mt = m.reshape(ty, th, tx, tw).sum((1, 3))
        return xt / torch.clamp(mt, min=1.0)

    def per_pixel(t):
        return t.repeat_interleave(th, 0).repeat_interleave(tw, 1)

    m = valid.to(torch.float32)
    mdx = tile_mean(du, m)
    mdy = tile_mean(dv, m)
    rx = du - per_pixel(mdx)
    ry = dv - per_pixel(mdy)
    residual = torch.sqrt(rx * rx + ry * ry) * valid
    return mdy.reshape(-1), mdx.reshape(-1), residual
