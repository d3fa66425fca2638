"""Shadow maps: cascades for the primary directional light, per-light
perspective maps for shadow-casting spot lights and six-face cube maps
for shadow-casting point lights.

Port of basicrenderer_tpu/ops/shadows.py (reference analogue: the
LightManager's directional cascades and per-light shadow cameras,
shadows.hlsli sampling).

- Each map is a depth-only run of the main view's binning and raster
  (K1 on per-triangle pairs of the soup, K2 on the cluster cut's group
  pairs) in a FrameConfig specialised to the map's size.
- The shadow term is evaluated from the camera's depth buffer at
  1/downscale rate with one compare tap per pixel, bilinearly upsampled
  and smoothed 3x3: the filter runs on the result mask, not as multi-tap
  PCF.
- Spot and cube slots with no light behind them are rendered and shaded
  all the same and masked by their `live` flag, as in the JAX package: a
  dead slot's view comes from an all-zero light row, so no host read
  decides how many slots to run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..graph.framedata import FrameConfig, SceneBuffers, ViewData
from ..utils import math3d
from . import raster_setup
from .raster import raster_tiles
from .shade import _inverse, _normalize
from .textures import resize_bilinear


def downsample2d(x: torch.Tensor, ds: int) -> torch.Tensor:
    """(H, W) -> (H//ds, W//ds) POINT sample: the top-left pixel of every
    ds x ds block (not an average), as the JAX package's reshape-index
    form computes it."""
    if ds == 1:
        return x
    h, w = x.shape
    return x[:h // ds * ds:ds, :w // ds * ds:ds]


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Small f32 matrix product as an explicit sum of products (no BLAS,
    no TF32 on the card)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _view_matrix(R: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """(4, 4) world->view from rotation rows R (3, 3) and the eye pos."""
    t = _mm(-R, pos[:, None])[:, 0]
    top = torch.cat([R, t[:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=torch.float32,
                          device=R.device)
    return torch.cat([top, bottom], dim=0)


def _up_for(d: torch.Tensor) -> torch.Tensor:
    """+Y unless d is within ~18 degrees of vertical, then +X."""
    dev = d.device
    return torch.where(torch.abs(d[1]) < 0.95,
                       torch.tensor([0.0, 1.0, 0.0], device=dev),
                       torch.tensor([1.0, 0.0, 0.0], device=dev))


# ---------------------------------------------------------------------------
# Cascaded shadow maps (directional light)
# ---------------------------------------------------------------------------

def shadow_config(config: FrameConfig) -> FrameConfig:
    """FrameConfig specialisation for cascade rendering."""
    res = config.shadow_resolution
    return dataclasses.replace(
        config, width=res, height=res, enable_occlusion=False,
        near_clip_tris=0,   # ortho cascades: w == 1, nothing ever crosses
        max_pairs=min(config.max_pairs, 1 << 17),
        max_tiles_per_tri=min(config.max_tiles_per_tri, 8))


def cascade_matrices(view: ViewData, light_dir: torch.Tensor,
                     num_cascades: int, near: float = 0.1,
                     max_dist: float = 60.0, lam: float = 0.7
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit one ortho viewproj per cascade around exponential view-frustum
    slices (practical split scheme). Returns (vps (K, 4, 4), splits (K,))
    where splits[k] is the far view-distance of cascade k."""
    dev = view.viewproj.device
    f32 = torch.float32
    inv_vp = _inverse(view.viewproj)
    ks = torch.arange(1, num_cascades + 1, dtype=f32, device=dev) \
        / num_cascades
    uniform = near + (max_dist - near) * ks
    logd = near * torch.pow(torch.tensor(max_dist / near, dtype=f32,
                                         device=dev), ks)
    splits = lam * logd + (1 - lam) * uniform             # (K,)

    d = _normalize(light_dir, 1e-9)
    s = _normalize(torch.linalg.cross(_up_for(d), -d), 1e-9)
    u = torch.linalg.cross(-d, s)
    R = torch.stack([s, u, -d])                           # (3, 3)

    # Frustum slice corners in world space: the 4 NDC corners at reverse-Z
    # z = near/dist of each slice boundary, unprojected.
    prev = torch.cat([torch.tensor([near], dtype=f32, device=dev),
                      splits[:-1]])
    dists = torch.cat([prev, splits])                     # (2K,)
    z = near / dists
    xy = torch.tensor([[x, y] for x in (-1, 1) for y in (-1, 1)], dtype=f32,
                      device=dev)
    cx = xy[None, :, 0].expand(2 * num_cascades, 4)
    cy = xy[None, :, 1].expand(2 * num_cascades, 4)
    cz = z[:, None].expand(2 * num_cascades, 4)
    wx, wy, wz, ww = math3d.mat4_columns(inv_vp, cx, cy, cz)
    pts = torch.stack([wx / ww, wy / ww, wz / ww], dim=-1)   # (2K, 4, 3)
    pts = torch.cat([pts[:num_cascades], pts[num_cascades:]], dim=1)
    lp = _mm(pts, R.T)                                    # (K, 8, 3)
    mn = lp.amin(dim=1)
    mx = lp.amax(dim=1)
    pad = (mx - mn) * 0.05 + 1e-3
    mn = mn - pad
    # Light-space z = -d.p grows toward the light, so the far bound reaches
    # toward the light to keep casters between the slice and the light.
    mx = mx + pad + torch.tensor([0.0, 0.0, 50.0], dtype=f32, device=dev)
    sx = 2.0 / (mx[:, 0] - mn[:, 0])
    sy = 2.0 / (mx[:, 1] - mn[:, 1])
    sz = 1.0 / (mx[:, 2] - mn[:, 2])
    tx = -(mx[:, 0] + mn[:, 0]) / (mx[:, 0] - mn[:, 0])
    ty = -(mx[:, 1] + mn[:, 1]) / (mx[:, 1] - mn[:, 1])
    tz = -mn[:, 2] * sz
    zero = torch.zeros_like(sx)
    # proj @ [R 0; 0 1], written out (proj's other entries are 0 and 1).
    rows = [torch.cat([sx[:, None] * R[0], tx[:, None]], dim=1),
            torch.cat([sy[:, None] * R[1], ty[:, None]], dim=1),
            torch.cat([sz[:, None] * R[2], tz[:, None]], dim=1),
            torch.stack([zero, zero, zero, torch.ones_like(sx)], dim=1)]
    return torch.stack(rows, dim=1), splits


def render_cascade(scene: SceneBuffers, cascade_vp: torch.Tensor,
                   config: FrameConfig, compacted=None) -> torch.Tensor:
    """Depth-only raster of the shadow casters from a cascade's viewproj.
    `compacted` is the cluster cut's CompactedTris (setup from the cluster
    pages, group binning, K2); without it the soup (vertex transform,
    setup, per-triangle binning, K1). Returns the padded (H', W') depth
    of shadow_config(config), reverse style (1 = nearest to the light)."""
    scfg = shadow_config(config)
    if compacted is not None:
        lanes, bbox, valid, _ovf = raster_setup.setup_from_compacted(
            scene, compacted, cascade_vp, scfg)
        pairs = raster_setup.bin_clustered(lanes, bbox, valid, scfg)
    else:
        clip, _ = raster_setup.transform_vertices(
            scene.positions, scene.vert_object, scene.object_mats, cascade_vp)
        lanes, bbox, valid, _ovf = raster_setup.triangle_setup_packed(
            clip, scene.indices, scene.tri_object >= 0, scfg, None, None,
            None)
        pairs = raster_setup.bin_pairs(lanes, bbox, valid, scfg)
    return raster_tiles(pairs, scfg)[0]


def _receivers(depth: torch.Tensor, view: ViewData, downscale: int,
               row0: int, full_h: int):
    """The downsampled depth d (h, w) and its world positions (px, py, pz)
    unprojected in column math at the low-res pixel centres."""
    H, W = depth.shape
    d = downsample2d(depth, downscale)
    h, w = d.shape
    dev = depth.device
    ds = downscale
    ndc_x = (torch.arange(w, dtype=torch.float32, device=dev)[None, :]
             .expand(h, w) * ds + 0.5) / W * 2.0 - 1.0
    ndc_y = 1.0 - (torch.arange(h, dtype=torch.float32, device=dev)[:, None]
                   .expand(h, w) * ds + 0.5 + row0) / full_h * 2.0
    px, py, pz, pw = math3d.mat4_columns(_inverse(view.viewproj), ndc_x,
                                         ndc_y, d)
    iw = 1.0 / torch.where(torch.abs(pw) > 1e-12, pw, 1.0)
    return d, px * iw, py * iw, pz * iw


def _texel(x: torch.Tensor, y: torch.Tensor, Rp: int):
    """Map texel (u, v) of NDC (x, y), truncated toward zero as XLA's
    f32 -> i32 conversion does, clamped to the map."""
    u = torch.clamp(raster_setup._to_i32((x * 0.5 + 0.5) * Rp), 0, Rp - 1)
    v = torch.clamp(raster_setup._to_i32((0.5 - y * 0.5) * Rp), 0, Rp - 1)
    return u, v


def _upsample_smooth(lit: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Bilinear upsample to (H, W), then a 3x3 box smooth with edge
    padding (the PCF analogue on the result mask)."""
    lit = resize_bilinear(lit, H, W)
    p = torch.nn.functional.pad(lit[None, None], (1, 1, 1, 1),
                                mode="replicate")[0, 0]
    acc = 0
    for dy in range(3):
        for dx in range(3):
            acc = acc + p[dy:dy + H, dx:dx + W]
    return acc / 9.0


def _diff(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Forward difference along `dim`, 0 at the last index (jnp.diff with
    the last slice appended)."""
    last = a[:, -1:] if dim == 1 else a[-1:]
    return torch.diff(a, dim=dim, append=last)


def sample_shadow_cascades(depth: torch.Tensor, view: ViewData,
                           cascade_vps: torch.Tensor,
                           shadow_maps: torch.Tensor, bias: torch.Tensor,
                           downscale: int = 2, row0: int = 0,
                           full_h: int = None) -> torch.Tensor:
    """(H, W) shadow visibility in [0, 1] from the camera's depth buffer.

    depth (H, W) reverse-Z NDC; cascade_vps (K, 4, 4); shadow_maps
    (K, R', R') from render_cascade. Receivers are unprojected from the
    downsampled depth and offset ~1.5 shadow texels along their geometric
    normal (from low-res world-position gradients); the receiver-plane
    slope bias comes from the light-space depth gradient. The first
    cascade that contains a receiver samples it; one gather reads all
    cascades. The result is upsampled and 3x3-smoothed."""
    H, W = depth.shape
    full_h = full_h or H
    K, Rp = shadow_maps.shape[0], shadow_maps.shape[1]
    d, px, py, pz = _receivers(depth, view, downscale, row0, full_h)
    h, w = d.shape
    dev = depth.device

    txx, txy, txz = _diff(px, 1), _diff(py, 1), _diff(pz, 1)
    tyx, tyy, tyz = _diff(px, 0), _diff(py, 0), _diff(pz, 0)
    gnx = txy * tyz - txz * tyy
    gny = txz * tyx - txx * tyz
    gnz = txx * tyy - txy * tyx
    gnl = torch.clamp(torch.sqrt(gnx * gnx + gny * gny + gnz * gnz),
                      min=1e-20)
    gnx, gny, gnz = gnx / gnl, gny / gnl, gnz / gnl
    # Face the camera (the gradient's orientation is view-dependent).
    cx, cy, cz = view.cam_pos[0], view.cam_pos[1], view.cam_pos[2]
    face = gnx * (cx - px) + gny * (cy - py) + gnz * (cz - pz)
    sgn = torch.where(face < 0.0, -1.0, 1.0)
    gnx, gny, gnz = gnx * sgn, gny * sgn, gnz * sgn

    flat_maps = shadow_maps.reshape(-1)
    sel_idx = torch.zeros((h, w), dtype=torch.int32, device=dev)
    sel_z = torch.zeros((h, w), dtype=torch.float32, device=dev)
    sel_bias = torch.zeros((h, w), dtype=torch.float32, device=dev)
    chosen = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for k in range(K):
        # Normal offset by ~1.5 shadow texels (world size from the
        # cascade's NDC scale: x_ndc spans 2 over Rp texels).
        scale_k = torch.linalg.vector_norm(cascade_vps[k, 0, :3])
        off = 1.5 * 2.0 / (Rp * torch.clamp(scale_k, min=1e-12))
        x, y, z, _w4 = math3d.mat4_columns(
            cascade_vps[k], px + gnx * off, py + gny * off, pz + gnz * off)
        inside = (torch.abs(x) < 0.99) & (torch.abs(y) < 0.99) \
            & (z > 0) & (z < 1)
        use = inside & ~chosen
        u, v = _texel(x, y, Rp)
        dzdx = torch.abs(_diff(z, 1))
        dzdy = torch.abs(_diff(z, 0))
        texels_x = torch.abs(_diff(x, 1)) * Rp * 0.5
        texels_y = torch.abs(_diff(y, 0)) * Rp * 0.5
        slope = (dzdx + dzdy) / torch.clamp(texels_x + texels_y, min=0.5)
        sel_bias = torch.where(use, bias + torch.minimum(slope * 2.0,
                                                         20.0 * bias),
                               sel_bias)
        sel_idx = torch.where(use, (k * Rp + v) * Rp + u, sel_idx)
        sel_z = torch.where(use, z, sel_z)
        chosen = chosen | inside
    smp = flat_maps[sel_idx.long()]
    # Reverse style: lit if the light depth >= map depth - bias; empty
    # texels (0 = nothing rendered) never occlude.
    lit = ((sel_z + sel_bias >= smp) | (smp <= 0.0)).to(torch.float32)
    lit = torch.where(chosen & (d > 0.0), lit, 1.0)
    return _upsample_smooth(lit, H, W)


# ---------------------------------------------------------------------------
# Spot-light shadow views (the reference's per-light shadow cameras)
# ---------------------------------------------------------------------------

def _slot_rows(lights: torch.Tensor, lane: int, n: int):
    """For slots 0..n-1 of light lane `lane`: the owning light's row (all
    zero for a dead slot, as the JAX package's one-hot product gives), its
    index (0 when dead) and the live flags."""
    sel = torch.abs(lights[None, :, lane]
                    - torch.arange(n, dtype=torch.float32,
                                   device=lights.device)[:, None]) < 0.5
    live = sel.any(dim=1)
    idx = torch.argmax(sel.to(torch.int32), dim=1).to(torch.int32)
    rows = torch.where(live[:, None], lights[idx.long()], 0.0)
    return rows, idx, live


def spot_shadow_matrices(lights: torch.Tensor, max_slots: int,
                         near: float = 0.05):
    """Per-slot perspective viewproj for shadow-casting spot lights.
    Returns (vps (K, 4, 4), light_index (K,) i32, live (K,) bool). Slot ids
    live in light lane 14 (scene/bridge.py packs spots only)."""
    rows, idxs, lives = _slot_rows(lights, 14, max_slots)
    vps = []
    for k in range(max_slots):
        row = rows[k]
        pos, d = row[0:3], _normalize(row[4:7], 1e-9)
        rng = torch.clamp(row[11], min=near * 2.0)
        outer = torch.arccos(torch.clamp(row[13], -0.999, 0.999))
        fov = torch.clamp(outer * 2.0 * 1.05, 0.1, 3.0)
        s = _normalize(torch.linalg.cross(d, _up_for(d)), 1e-9)
        u = torch.linalg.cross(s, d)
        # View: right-handed looking down -Z -> rows (s, u, -d).
        viewm = _view_matrix(torch.stack([s, u, -d]), pos)
        proj = math3d.perspective(fov, 1.0, near, rng)
        vps.append(_mm(proj, viewm))
    return torch.stack(vps), idxs, lives


def _project(vp: torch.Tensor, px, py, pz):
    """Perspective-project world points; returns (x, y, z, front) with the
    points behind the view left undivided."""
    x, y, z, wq = math3d.mat4_columns(vp, px, py, pz)
    front = wq > 1e-6
    qi = 1.0 / torch.where(front, wq, 1.0)
    return x * qi, y * qi, z * qi, front


def sample_spot_shadow(depth: torch.Tensor, view: ViewData, vp: torch.Tensor,
                       shadow_map: torch.Tensor, bias, downscale: int = 4,
                       row0: int = 0, full_h: int = None) -> torch.Tensor:
    """(H, W) visibility for one spot light from the camera's depth buffer
    (the cascades' unprojection). Perspective reverse-Z depth is about
    near/dist, so the bias is multiplicative: lit iff the receiver lies
    within ~4% of the caster distance. `bias` is unused, as in the JAX
    package."""
    H, W = depth.shape
    full_h = full_h or H
    Rp = shadow_map.shape[0]
    d, px, py, pz = _receivers(depth, view, downscale, row0, full_h)
    x, y, z, front = _project(vp, px, py, pz)
    inside = front & (torch.abs(x) < 0.99) & (torch.abs(y) < 0.99) \
        & (z > 0) & (z < 1)
    u, v = _texel(x, y, Rp)
    smp = shadow_map.reshape(-1)[(v * Rp + u).long()]
    lit = ((z >= smp * 0.96) | (smp <= 0.0)).to(torch.float32)
    lit = torch.where(inside & (d > 0), lit, 1.0)
    return _upsample_smooth(lit, H, W)


# ---------------------------------------------------------------------------
# Point-light cube shadows (6 perspective faces; the reference's omni
# shadow cameras)
# ---------------------------------------------------------------------------

_CUBE_DIRS = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
              (0, 0, -1)]
_CUBE_UPS = [(0, 1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1), (0, 1, 0),
             (0, 1, 0)]


def point_cube_matrices(lights: torch.Tensor, max_cubes: int,
                        near: float = 0.05):
    """(max_cubes, 6, 4, 4) face viewprojs + (max_cubes,) light index and
    live flags. The cube index lives in light lane 15 (scene/bridge.py)."""
    rows, idxs, lives = _slot_rows(lights, 15, max_cubes)
    dev = lights.device
    fov = torch.tensor(math.pi / 2 * 1.02, dtype=torch.float32, device=dev)
    vps = []
    for c in range(max_cubes):
        pos = rows[c, 0:3]
        rng = torch.clamp(rows[c, 11], min=near * 2.0)
        # 90-degree faces with a little overlap for seam-free selection.
        proj = math3d.perspective(fov, 1.0, near, rng)
        face_vps = []
        for dd, up in zip(_CUBE_DIRS, _CUBE_UPS):
            d = torch.tensor(dd, dtype=torch.float32, device=dev)
            up = torch.tensor(up, dtype=torch.float32, device=dev)
            s = _normalize(torch.linalg.cross(d, up), 1e-9)
            u = torch.linalg.cross(s, d)
            face_vps.append(_mm(proj, _view_matrix(torch.stack([s, u, -d]),
                                                   pos)))
        vps.append(torch.stack(face_vps))
    return torch.stack(vps), idxs, lives


def sample_point_shadow(depth: torch.Tensor, view: ViewData,
                        light_pos: torch.Tensor, face_vps: torch.Tensor,
                        face_maps: torch.Tensor, downscale: int = 4,
                        row0: int = 0, full_h: int = None) -> torch.Tensor:
    """(H, W) visibility for one point light. face_maps (6, R', R'); the
    face is picked per pixel by the dominant axis of (p - light), then
    one gather samples all faces (the cascade strategy)."""
    H, W = depth.shape
    full_h = full_h or H
    Rp = face_maps.shape[1]
    d, px, py, pz = _receivers(depth, view, downscale, row0, full_h)
    h, w = d.shape
    dev = depth.device
    tx = px - light_pos[0]
    ty = py - light_pos[1]
    tz = pz - light_pos[2]
    ax, ay, az = torch.abs(tx), torch.abs(ty), torch.abs(tz)
    face = torch.where((ax >= ay) & (ax >= az), torch.where(tx > 0, 0, 1),
                       torch.where(ay >= az, torch.where(ty > 0, 2, 3),
                                   torch.where(tz > 0, 4, 5)))
    sel_idx = torch.zeros((h, w), dtype=torch.int32, device=dev)
    sel_z = torch.zeros((h, w), dtype=torch.float32, device=dev)
    inside_any = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for f in range(6):
        x, y, z, front = _project(face_vps[f], px, py, pz)
        use = (face == f) & front & (z > 0) & (z < 1)
        u, v = _texel(x, y, Rp)
        sel_idx = torch.where(use, (f * Rp + v) * Rp + u, sel_idx)
        sel_z = torch.where(use, z, sel_z)
        inside_any = inside_any | use
    smp = face_maps.reshape(-1)[sel_idx.long()]
    lit = ((sel_z >= smp * 0.96) | (smp <= 0.0)).to(torch.float32)
    lit = torch.where(inside_any & (d > 0), lit, 1.0)
    return _upsample_smooth(lit, H, W)
