"""Reyes-style micro-tessellation: adaptive dice of large on-screen
triangles into displaced micro-triangles.

Port of basicrenderer_tpu/ops/reyes.py (reference: the Reyes split/dice
pipeline, BasicRenderer CLodExtension.cpp:366 and its Reyes*.cpp /
reyes*.hlsl passes). No kernel of its own: the micro rows ride the
ordinary binning and raster (K2, or K1 with group_binning=False).

- SELECT: triangles whose projected edge exceeds `reyes_px` and whose
  material carries a displacement scale, compacted into a fixed
  `reyes_tris` parent budget (the first eligible rows in row order;
  overflow surfaces in a counter).
- SPLIT (reyes_split_tris > 0): parents over reyes_px * reyes_split_factor
  take a 4-way barycentric midpoint split first, within their own budget;
  the children enter the same dice.
- DICE: every parent uniformly into D^2 micro-triangles on the barycentric
  grid (D = `reyes_dice`). Shared parent edges stay crack-free: grid
  vertices on an edge blend only the edge's two corners, and the
  displacement sample is a function of the shared UV.
- DISPLACE: micro-vertices move along the interpolated normal by the
  material's displacement texture (point-sampled R byte of the strip
  atlas at its finest mip of size <= 128) times material lane 28.
- APPEND: diced parents leave the main stream, and the micro-triangles
  are set up with the same plane setup into extra lane rows.

Numerics: the micro corners go back to world space through the inverse
of the view-projection, taken by cofactors (`inverse4`) so that the card
and the CPU give the same rows. Against the JAX package (XLA's LU
inverse) the selection, `parent_keep` and the overflow are exact and the
micro rows' lanes agree within a tolerance (tests/test_torch_reyes.py),
not bit for bit.
"""

from __future__ import annotations

import itertools
from typing import List, Tuple

import numpy as np
import torch

from ..graph.framedata import FrameConfig
from . import raster_setup
from .raster_setup import dot3, fma
from .textures import infer_strip_resolution, mip_layout, strip_layout

# Children of the split tier (corner barycentrics on the parent); corner
# order keeps the parent's winding.
_SPLIT = np.array([
    [(1, 0, 0), (.5, .5, 0), (.5, 0, .5)],
    [(.5, .5, 0), (0, 1, 0), (0, .5, .5)],
    [(.5, 0, .5), (0, .5, .5), (0, 0, 1)],
    [(.5, .5, 0), (0, .5, .5), (.5, 0, .5)],    # center (flipped)
], np.float32)                                  # (4, 3, 3)


def _cofactor_tables():
    """(16, 6, 3) flat indices and (16, 6) signs of the six triple
    products of each entry's 3x3 minor (cofactor sign included)."""
    idx = np.zeros((16, 6, 3), np.int64)
    sign = np.zeros((16, 6), np.float32)
    for i in range(4):
        for j in range(4):
            rows = [r for r in range(4) if r != i]
            cols = [c for c in range(4) if c != j]
            for t, perm in enumerate(itertools.permutations(range(3))):
                inversions = sum(perm[a] > perm[b] for a in range(3)
                                 for b in range(a + 1, 3))
                idx[i * 4 + j, t] = [rows[k] * 4 + cols[perm[k]]
                                     for k in range(3)]
                sign[i * 4 + j, t] = (-1.0) ** (inversions + i + j)
    return idx, sign


_COF_IDX, _COF_SIGN = _cofactor_tables()


def inverse4(m: torch.Tensor) -> torch.Tensor:
    """Inverse of a 4x4 f32 matrix by cofactors: a fixed sequence of f32
    products, sums and one division, so the card and the CPU give the
    same bits (an LU inverse pivots and rounds apart on them)."""
    flat = m.reshape(16)
    idx = torch.from_numpy(_COF_IDX).to(m.device)
    t = flat[idx[..., 0]] * flat[idx[..., 1]] * flat[idx[..., 2]] \
        * torch.from_numpy(_COF_SIGN).to(m.device)              # (16, 6)
    cof = t[:, 0] + t[:, 1] + t[:, 2] + t[:, 3] + t[:, 4] + t[:, 5]
    det = flat[0] * cof[0] + flat[1] * cof[1] + flat[2] * cof[2] \
        + flat[3] * cof[3]
    return cof.reshape(4, 4).T / det


def _bary_grid(D: int) -> np.ndarray:
    """(D*D, 3, 3) f32: for each micro-triangle, its 3 corners' barycentric
    weights on the parent (upright and inverted grid cells)."""
    tris = []
    for i in range(D):
        for j in range(D - i):
            # Upright cell (i, j): corners (i,j), (i+1,j), (i,j+1).
            tris.append([(i, j), (i + 1, j), (i, j + 1)])
            # The inverted cell shares the diagonal.
            if i + j <= D - 2:
                tris.append([(i + 1, j), (i + 1, j + 1), (i, j + 1)])
    assert len(tris) == D * D, (len(tris), D)
    out = np.zeros((D * D, 3, 3), np.float32)
    for t, corners in enumerate(tris):
        for c, (i, j) in enumerate(corners):
            u, v = i / D, j / D
            out[t, c] = (1.0 - u - v, u, v)
    return out


def _sample_height(strips: torch.Tensor, num_layers: int, tex_id: torch.Tensor,
                   u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Point-sample the R byte of the strip atlas words at the finest mip
    of size <= 128 (one strip row per y, lane = x). tex_id/u/v: (N,)
    columns. The atlas is read as RGBA8 words whatever its format, as in
    the JAX package."""
    R = infer_strip_resolution(strips.shape[0] // num_layers)
    sizes, _ = mip_layout(R)
    offs, rows_per_layer = strip_layout(R)
    m = next(i for i, s in enumerate(sizes) if s <= 128)
    sz, off = sizes[m], offs[m]
    uu = u - torch.floor(u)
    vv = v - torch.floor(v)
    xi = torch.clamp(raster_setup._to_i32(uu * sz), 0, sz - 1)
    yi = torch.clamp(raster_setup._to_i32(vv * sz), 0, sz - 1)
    layer = torch.clamp(tex_id, min=0)
    idx = (layer * rows_per_layer + off + yi) * 128 + xi
    flat = strips.reshape(-1)
    # An index past the atlas clamps, as an XLA gather does.
    word = flat[torch.clamp(idx, 0, flat.shape[0] - 1).long()]
    return (word & 0xFF).to(torch.float32) * (1.0 / 255.0)


def _first_rows(mask: torch.Tensor, budget: int) -> torch.Tensor:
    """The row indices of the first `budget` set rows of `mask`, padded
    with len(mask) (dead); fewer than `budget` when mask is shorter, as a
    slice of the JAX package's sorted keys is."""
    n = mask.shape[0]
    key = torch.where(mask, torch.arange(n, dtype=torch.int32,
                                         device=mask.device), n)
    return torch.sort(key).values[:budget]


def _diced(n: int, slot: torch.Tensor) -> torch.Tensor:
    """(n,) bool: the rows a slot list names (dead slots name row n)."""
    hit = torch.zeros((n + 1,), dtype=torch.bool, device=slot.device)
    hit[slot.long()] = True
    return hit[:n]


def dice_reyes(gs: List[torch.Tensor], tri_valid: torch.Tensor, comp, scene,
               viewproj: torch.Tensor, config: FrameConfig,
               id_base: int) -> Tuple:
    """Select, dice and displace (see the module docstring).

    gs: the 3 per-corner (Kt, 9) row tables [clip4 | wnormal3 | uv2] of
    the clustered setup. Returns (elanes, ebbox, evalid, parent_keep,
    overflow): the caller sets up its main stream with tri_valid &
    parent_keep (diced parents must not render twice) and appends the
    micro rows, whose ids start past `id_base`."""
    K, D = config.reyes_tris, config.reyes_dice
    W, H = config.width, config.height
    Kt = tri_valid.shape[0]
    dev = tri_valid.device

    # --- SELECT -----------------------------------------------------------
    mt = scene.material_table
    mid = comp.material.long()
    in_table = (mid >= 0) & (mid < mt.shape[0])
    # A material id outside the table reads a zero row (the JAX package's
    # one-hot gather).
    drow = torch.where(in_table[:, None],
                       mt[torch.clamp(mid, 0, mt.shape[0] - 1), 28:30], 0.0)
    dscale, dtex = drow[:, 0], drow[:, 1].to(torch.int32)
    wmin = torch.minimum(torch.minimum(gs[0][:, 3], gs[1][:, 3]), gs[2][:, 3])
    sx, sy = [], []
    for c in range(3):
        iw = 1.0 / torch.clamp(gs[c][:, 3], min=1e-6)
        sx.append((gs[c][:, 0] * iw * 0.5 + 0.5) * W)
        sy.append((0.5 - gs[c][:, 1] * iw * 0.5) * H)
    edge_px = torch.maximum(
        torch.maximum(torch.abs(sx[1] - sx[0]) + torch.abs(sy[1] - sy[0]),
                      torch.abs(sx[2] - sx[1]) + torch.abs(sy[2] - sy[1])),
        torch.abs(sx[0] - sx[2]) + torch.abs(sy[0] - sy[2]))
    eligible = (tri_valid & (dscale > 0.0) & (wmin > 1e-3)
                & (edge_px > config.reyes_px))

    # --- SPLIT tier: parents over reyes_split_factor * reyes_px take a
    # 4-way midpoint split first, in their own budget.
    SL = config.reyes_split_tris
    if SL > 0:
        huge = eligible & (edge_px > config.reyes_px
                           * config.reyes_split_factor)
        norm_el = eligible & ~huge
    else:
        norm_el = eligible
    slot = _first_rows(norm_el, K)
    live = slot < Kt
    src = torch.clamp(slot, max=Kt - 1).long()
    overflow = torch.clamp(norm_el.sum() - K, min=0).to(torch.int32)
    parent_keep = ~_diced(Kt, torch.where(live, slot, Kt))

    inv_vp = inverse4(viewproj)
    pc = [g[src] for g in gs]                            # (K, 9) row gathers
    src_all, live_all = src, live
    if SL > 0:
        slot2 = _first_rows(huge, SL)
        live2 = slot2 < Kt
        src2 = torch.clamp(slot2, max=Kt - 1).long()
        overflow = overflow + torch.clamp(huge.sum() - SL, min=0).to(
            torch.int32)
        parent_keep = parent_keep & ~_diced(Kt, torch.where(live2, slot2, Kt))
        p2 = [g[src2] for g in gs]                       # (SL, 9)
        n2 = src2.shape[0]
        kids = []
        for c in range(3):
            # Weights 0, 0.5 and 1: every product is exact, so any
            # rounding order gives the same sums.
            rows = torch.stack([
                float(_SPLIT[ch, c, 0]) * p2[0]
                + float(_SPLIT[ch, c, 1]) * p2[1]
                + float(_SPLIT[ch, c, 2]) * p2[2]
                for ch in range(4)], dim=1)              # (SL, 4, 9)
            kids.append(rows.reshape(n2 * 4, 9))
        pc = [torch.cat([pc[c], kids[c]], dim=0) for c in range(3)]
        src_all = torch.cat([src, src2.repeat_interleave(4)])
        live_all = torch.cat([live, live2.repeat_interleave(4)])

    def world_cols(g):
        # clip -> homogeneous world through inv(viewproj), column math.
        cx, cy, cz, cw = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
        w = [fma(inv_vp[r, 3], cw, dot3(inv_vp[r, 0], cx, inv_vp[r, 1], cy,
                                       inv_vp[r, 2], cz)) for r in range(4)]
        iw = 1.0 / torch.where(torch.abs(w[3]) > 1e-9, w[3], 1.0)
        return w[0] * iw, w[1] * iw, w[2] * iw

    pw = [world_cols(g) for g in pc]                     # 3 x (wx, wy, wz)
    bary = torch.from_numpy(_bary_grid(D)).to(dev)       # (D^2, 3, 3)
    D2 = D * D
    scale_m = dscale[src_all].repeat_interleave(D2)
    dtex_m = dtex[src_all].repeat_interleave(D2)
    mat_m = comp.material[src_all].repeat_interleave(D2)
    obj_m = comp.object[src_all].repeat_interleave(D2)
    ev = live_all.repeat_interleave(D2)

    def blend(cols3, c):
        """Parent-corner columns (3 x (K,)) -> micro corner c (K*D2,)."""
        b = bary[:, c, :]                                # (D2, 3)
        return dot3(cols3[0][:, None], b[None, :, 0], cols3[1][:, None],
                    b[None, :, 1], cols3[2][:, None], b[None, :, 2]).reshape(-1)

    hs = []
    vp = viewproj
    num_layers = scene.tex_flags.shape[0]
    for c in range(3):
        wx = blend([pw[i][0] for i in range(3)], c)
        wy = blend([pw[i][1] for i in range(3)], c)
        wz = blend([pw[i][2] for i in range(3)], c)
        nx = blend([pc[i][:, 4] for i in range(3)], c)
        ny = blend([pc[i][:, 5] for i in range(3)], c)
        nz = blend([pc[i][:, 6] for i in range(3)], c)
        u = blend([pc[i][:, 7] for i in range(3)], c)
        v = blend([pc[i][:, 8] for i in range(3)], c)
        # 1/sqrt rounded once (f64 root: PyTorch's CPU f32 sqrt is not
        # correctly rounded).
        rl = (1.0 / torch.sqrt(torch.clamp(dot3(nx, nx, ny, ny, nz, nz),
                                           min=1e-12).double())).float()
        h = _sample_height(scene.tex_strips, num_layers, dtex_m, u, v) - 0.5
        d = h * scale_m * rl
        wx, wy, wz = fma(nx, d, wx), fma(ny, d, wy), fma(nz, d, wz)
        clip = [dot3(vp[r, 0], wx, vp[r, 1], wy, vp[r, 2], wz) + vp[r, 3]
                for r in range(4)]
        hs.append(torch.stack(clip + [nx * rl, ny * rl, nz * rl, u, v],
                              dim=1))

    setup = raster_setup._setup_from_corners(
        hs[0], hs[1], hs[2], ev, config, has_normals=True, has_uvs=True)
    elanes = raster_setup.pack_setup_lanes(setup, mat_m, obj_m)
    # Unique nonzero vis ids past the caller's rows.
    elanes[:, 9] = torch.where(setup.valid, elanes[:, 9] + float(id_base),
                               0.0)
    return elanes, setup.bbox, setup.valid, parent_keep, overflow
