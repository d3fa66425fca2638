"""Vertex transform, triangle setup, and tile binning (triangle-soup path).

Port of the soup half of basicrenderer_tpu/ops/raster_setup.py:

1. Vertex transform: per-vertex model/normal matrices by plain indexing
   (the JAX package's one-hot MXU gather exists only for the TPU).
2. Triangle setup: per-triangle screen-space plane equations packed into
   the 32-lane row layout below, which the raster kernel and its plain
   version read. The layout is the data contract with the JAX package and
   is kept exactly.
3. Tile binning: every triangle emits K tile slots; one stable sort of an
   int64 (tile, slot) key groups them by tile; a bounded gather
   materializes the pair rows. Triangles spanning more than K tiles go to
   a global big-triangle list every tile walks.

Everything is fixed-shape and free of host synchronisation, so the whole
front end queues on the card without a round trip; truncation is surfaced
via `overflow` counters.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..graph.framedata import FrameConfig

# Triangle payload lane layout, row-per-triangle (P, SETUP_LANES):
#  0-2: edge0 A,B,C   (normalized: E_i(x,y) IS the barycentric weight of v_i;
#       the raster derives edge2 = 1 - edge0 - edge1)
#  3-5: edge1
#  6-8: depth plane   (z_ndc = A*x + B*y + C; reverse-Z, bigger = closer)
#  9:  triangle id + 1 AS A FLOAT (ids < 2^24 exact)
#  10: material id + OBJ_COMBO * object id AS A FLOAT (combo < 2^24 exact)
#  11-14: tile bbox as SEPARATE FLOAT lanes (tx0, tx1, ty0, ty1); invalid
#      rows carry inverted ranges
#  15-17: octu/w plane (octahedral world-normal u over clip w)
#  18-20: octv/w plane
#  21-23: u/w plane
#  24-26: v/w plane
#  27: per-tri FLAT tangent theta (enable_vertex_tangents: the corner-0
#      tangent's angle in the canonical ONB of the world normal, +4pi when
#      its handedness is negative; zero otherwise and on near-clip rows)
#  28-31: unused here (28/30/31 carry OIT payloads in the JAX package)
# There is NO 1/w plane: the shading pass derives 1/w from the depth
# buffer (shade.inv_w_from_depth).
SETUP_LANES = 32
# Lane-10 packing: combo = material + OBJ_COMBO * object. Exact in f32 while
# material < 1024 and object < 8192 (combo < 2^23).
OBJ_COMBO = 1024


class TriangleSetup(NamedTuple):
    """Per-triangle raster data (capacity T, masked by `valid`)."""
    bbox: torch.Tensor          # (T, 4) i32 tile-space x0,y0,x1,y1 inclusive
    valid: torch.Tensor         # (T,) bool
    lane_cols: List[torch.Tensor]  # the 32 (T,) payload columns


def fma(a, b, c):
    """a * b + c rounded once, as XLA's CPU backend contracts a product
    feeding an add (torch.addcmul: a true fused multiply-add on both the
    CPU and the card)."""
    if not isinstance(c, torch.Tensor):
        c = torch.full_like(a if isinstance(a, torch.Tensor) else b, c)
    if not isinstance(b, torch.Tensor):
        # A fill on the tensor's own device: torch.tensor(b, device=...)
        # would be a blocking host-to-device copy on the card.
        b = torch.full_like(c, b)
    return torch.addcmul(c, a, b)


def dot3(a0, b0, a1, b1, a2, b2):
    """a0*b0 + a1*b1 + a2*b2 in XLA's contracted form:
    fma(a2, b2, fma(a0, b0, a1*b1))."""
    return fma(a2, b2, fma(a0, b0, a1 * b1))


def oct_encode_cols(nx, ny, nz):
    """(T,)-column octahedral encode: unit-ish normal -> (ou, ov) in
    [-1, 1] (decoded per pixel by shade.oct_decode_cols)."""
    an = torch.clamp(torch.abs(nx) + torch.abs(ny) + torch.abs(nz), min=1e-20)
    x, y = nx / an, ny / an
    fold = nz < 0.0
    xf = torch.where(fold, (1.0 - torch.abs(y)) * torch.where(x >= 0, 1.0, -1.0), x)
    yf = torch.where(fold, (1.0 - torch.abs(x)) * torch.where(y >= 0, 1.0, -1.0), y)
    return xf, yf


def _onb_cols(nx, ny, nz):
    """Column form of the branchless canonical ONB of a unit normal
    (shade._onb): the encode and the decode share this construction."""
    s = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    return ((1.0 + s * nx * nx * a, s * b, -s * nx),
            (b, s + ny * ny * a, -ny))


def encode_theta_cols(tx, ty, tz, w, nx, ny, nz):
    """World tangent + handedness -> the per-triangle theta wire encoding:
    the tangent's angle within the canonical ONB of the world normal,
    +4pi when w < 0. (T,)-column math; shade.tangent_from_theta inverts
    it per pixel."""
    nl = torch.rsqrt(torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-20))
    nx, ny, nz = nx * nl, ny * nl, nz * nl
    d = tx * nx + ty * ny + tz * nz
    tx, ty, tz = tx - d * nx, ty - d * ny, tz - d * nz
    t0, b0 = _onb_cols(nx, ny, nz)
    ct = tx * t0[0] + ty * t0[1] + tz * t0[2]
    st = tx * b0[0] + ty * b0[1] + tz * b0[2]
    theta = torch.atan2(st, ct)
    return theta + torch.where(w < 0.0, 4.0 * math.pi, 0.0)


def rotate_cols_3x3(m_cols, idx, x, y, z):
    """Per-row 3x3 products with the matrices given as flattened column
    lists; `idx` maps the 9 entries (row-major) into m_cols positions."""
    ox = m_cols[idx[0]] * x + m_cols[idx[1]] * y + m_cols[idx[2]] * z
    oy = m_cols[idx[3]] * x + m_cols[idx[4]] * y + m_cols[idx[5]] * z
    oz = m_cols[idx[6]] * x + m_cols[idx[7]] * y + m_cols[idx[8]] * z
    return ox, oy, oz


# The model matrix's 3x3 inside its row-major 4x4 (tangents rotate with
# the model matrix, not with the normal matrix).
_MODEL3 = (0, 1, 2, 4, 5, 6, 8, 9, 10)


def _affine_rows(m: torch.Tensor, x, y, z):
    """World (x, y, z) of per-row row-major 4x4s (V, 16): each output as
    the sequential chain fma(m3, 1, fma(m2, z, fma(m1, y, m0 * x))) that
    XLA's CPU backend evaluates a batched dot with (the JAX package's
    einsum "vij,vj->vi"). m3 * 1 is exact, so its fma rounds as m3 + c."""
    return tuple(m[:, 4 * r + 3] + fma(m[:, 4 * r + 2], z,
                                       fma(m[:, 4 * r + 1], y, m[:, 4 * r] * x))
                 for r in range(3))


def _clip_columns(viewproj: torch.Tensor, wx, wy, wz) -> torch.Tensor:
    """(V, 4) clip of world columns: math3d.mat4_columns with w = 1 as XLA
    contracts it, fma(m2, z, fma(m0, x, m1 * y)) + m3 (setup.dot3)."""
    return torch.stack([dot3(viewproj[r, 0], wx, viewproj[r, 1], wy,
                             viewproj[r, 2], wz) + viewproj[r, 3]
                        for r in range(4)], dim=-1)


def transform_vertices(positions: torch.Tensor, vert_object: torch.Tensor,
                       object_mats: torch.Tensor, viewproj: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Object-space verts -> (clip (V, 4), world (V, 3)), in column math
    (the shadow passes need no normals). Bit-equal to the JAX package's
    jitted transform on the CPU."""
    m = object_mats.reshape(-1, 16)[vert_object.long()]   # (V, 16)
    wx, wy, wz = _affine_rows(m, positions[:, 0], positions[:, 1],
                              positions[:, 2])
    return _clip_columns(viewproj, wx, wy, wz), torch.stack([wx, wy, wz], -1)


def transform_geometry(positions: torch.Tensor, normals: torch.Tensor,
                       vert_object: torch.Tensor, object_mats: torch.Tensor,
                       object_normal_mats: torch.Tensor, viewproj: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Object-space verts+normals -> (clip (V,4), world (V,3), wnormal (V,3)).
    Column math throughout, no matmul: every lane is the fused chain XLA's
    CPU dot evaluates, so the lanes equal the JAX package's bit for bit."""
    clip, world = transform_vertices(positions, vert_object, object_mats,
                                     viewproj)
    nm = object_normal_mats.reshape(-1, 9)[vert_object.long()]   # (V, 9)
    nx, ny, nz = normals[:, 0], normals[:, 1], normals[:, 2]
    wn = torch.stack([fma(nm[:, 3 * r + 2], nz,
                          fma(nm[:, 3 * r + 1], ny, nm[:, 3 * r] * nx))
                      for r in range(3)], dim=-1)
    return clip, world, wn


def vertex_world_theta(scene, world_normals: torch.Tensor) -> torch.Tensor:
    """(V,) per-vertex world tangent theta for the soup setup: the object
    tangents (SceneBuffers.tangents) rotated by each vertex's model 3x3
    and encoded against its world normal."""
    t4 = scene.tangents
    m = scene.object_mats.reshape(-1, 16)[scene.vert_object.long()]
    wtx, wty, wtz = rotate_cols_3x3([m[:, i] for i in range(16)], _MODEL3,
                                    t4[:, 0], t4[:, 1], t4[:, 2])
    return encode_theta_cols(wtx, wty, wtz, t4[:, 3], world_normals[:, 0],
                             world_normals[:, 1], world_normals[:, 2])


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> i32 with XLA's conversion semantics where they matter: NaN
    -> 0 and out-of-range values saturated (kept far off screen, which is
    all the bbox code needs of them)."""
    x = torch.nan_to_num(x, nan=0.0, posinf=2.0 ** 30, neginf=-2.0 ** 30)
    return torch.clamp(x, -2.0 ** 30, 2.0 ** 30).to(torch.int32)


def _setup_from_corners(g0, g1, g2, tri_valid, config: FrameConfig,
                        has_normals: bool, has_uvs: bool,
                        tangent_col: Optional[torch.Tensor] = None
                        ) -> TriangleSetup:
    """Per-corner rows g_i = [clip4 | wnormal3 | uv2] -> TriangleSetup.
    `tangent_col` (T,) is the per-triangle theta of lane 27. Everything
    stays (T,)-column shaped."""
    W, H = config.width, config.height
    tw, th = config.tile_w, config.tile_h

    w_c = [g0[:, 3], g1[:, 3], g2[:, 3]]
    w_ok = (w_c[0] > 1e-6) & (w_c[1] > 1e-6) & (w_c[2] > 1e-6)
    iw_c = [1.0 / torch.where(torch.abs(wc) > 1e-9, wc, 1.0) for wc in w_c]
    # D3D viewport transform: y flips (NDC +y up -> screen y down). The
    # screen coordinates are products by W and H; in the area below XLA
    # fuses such a product into the difference of two (ndx/ndy: a * W - b
    # rounded once), while the edges' differences stay plain.
    nx_c = [g[:, 0] * iw * 0.5 + 0.5 for g, iw in zip((g0, g1, g2), iw_c)]
    ny_c = [0.5 - g[:, 1] * iw * 0.5 for g, iw in zip((g0, g1, g2), iw_c)]
    sx_c = [n * W for n in nx_c]
    sy_c = [n * H for n in ny_c]
    z_c = [g[:, 2] * iw for g, iw in zip((g0, g1, g2), iw_c)]

    def ndx(a, b):   # sx_c[a] - sx_c[b]
        return fma(nx_c[a], float(W), -sx_c[b])

    def ndy(a, b):   # sy_c[a] - sy_c[b]
        return fma(ny_c[a], float(H), -sy_c[b])

    x0, y0 = sx_c[0], sy_c[0]
    x1, y1 = sx_c[1], sy_c[1]
    x2, y2 = sx_c[2], sy_c[2]
    # Signed 2*area in y-down screen space; world-CCW front faces => s < 0.
    # Below ~1e-3 px^2 a triangle is a degenerate sliver whose normalized
    # planes would blow up (see the JAX package's note).
    s = fma(ndx(1, 0), ndy(2, 0), -(ndx(2, 0) * ndy(1, 0)))
    front = s < -1e-3
    valid = tri_valid & w_ok & front
    # Normalize by the SIGNED area so E_i(v_i) = +1 regardless of winding.
    inv_area2 = torch.where(
        front, 1.0 / torch.where(torch.abs(s) > 1e-6, s, -1e-6), 0.0)

    def edge(a, b):
        # Columns (A, B, C) of the edge plane of corners a->b, normalized
        # to barycentric.
        ax, ay, bx, by = sx_c[a], sy_c[a], sx_c[b], sy_c[b]
        return ((ay - by) * inv_area2, (bx - ax) * inv_area2,
                fma(ax, by, -(ay * bx)) * inv_area2)

    e0 = edge(1, 2)   # barycentric weight plane of vertex 0
    e1 = edge(2, 0)
    e2 = edge(0, 1)
    # XLA computes e1's A column for the lane rows in the fusion of the
    # area, where y2 - y0 is contracted; the planes below take the plain
    # difference.
    e1_lane = (ndy(2, 0) * inv_area2,) + e1[1:]

    def plane_from(v0, v1, v2):
        """Per-vertex scalars -> affine plane columns (A, B, C)."""
        return tuple(dot3(v0, e0[c], v1, e1[c], v2, e2[c]) for c in range(3))

    zplane_c = plane_from(*z_c)

    # Perspective-correct attribute planes (attr/w is affine in screen
    # space): [octu/w, octv/w, u/w, v/w]. The JAX package also builds a
    # 1/w plane that never reaches the lane rows; it is not built here.
    plane_cols = []
    zero = torch.zeros_like(s)
    off = 4
    if has_normals:
        ocs = [oct_encode_cols(g[:, off], g[:, off + 1], g[:, off + 2])
               for g in (g0, g1, g2)]
        for c in range(2):
            plane_cols.append(plane_from(ocs[0][c] * iw_c[0],
                                         ocs[1][c] * iw_c[1],
                                         ocs[2][c] * iw_c[2]))
        off += 3
    else:
        plane_cols += [(zero, zero, zero)] * 2
    if has_uvs:
        for c in range(2):
            plane_cols.append(plane_from(g0[:, off + c] * iw_c[0],
                                         g1[:, off + c] * iw_c[1],
                                         g2[:, off + c] * iw_c[2]))
    else:
        plane_cols += [(zero, zero, zero)] * 2

    # Tile-space bbox (inclusive), clamped to screen.
    minx = torch.minimum(torch.minimum(x0, x1), x2)
    miny = torch.minimum(torch.minimum(y0, y1), y2)
    maxx = torch.maximum(torch.maximum(x0, x1), x2)
    maxy = torch.maximum(torch.maximum(y0, y1), y2)
    bx0 = _to_i32(torch.floor(minx))
    by0 = _to_i32(torch.floor(miny))
    bx1 = _to_i32(torch.ceil(maxx))
    by1 = _to_i32(torch.ceil(maxy))
    offscreen = (bx1 < 0) | (by1 < 0) | (bx0 >= W) | (by0 >= H)
    valid = valid & ~offscreen

    def tile_of(v, size, n):
        return torch.clamp(torch.div(v, size, rounding_mode="floor"), 0, n - 1)

    tx0 = tile_of(bx0, tw, config.tiles_x)
    ty0 = tile_of(by0, th, config.tiles_y)
    tx1 = tile_of(bx1, tw, config.tiles_x)
    ty1 = tile_of(by1, th, config.tiles_y)
    bbox = torch.stack([tx0, ty0, tx1, ty1], dim=-1).to(torch.int32)
    return TriangleSetup(bbox, valid,
                         _lane_columns(e0, e1_lane, zplane_c, plane_cols, valid,
                                       tx0, ty0, tx1, ty1, tangent_col))


def _lane_columns(e0, e1, zplane_c, plane_cols, valid, tx0, ty0, tx1, ty1,
                  tangent_col=None):
    """The 32 payload columns in lane order (material filled by pack).
    Invalid rows are masked IN the table (id 0 + inverted bbox), and so is
    the tangent theta."""
    T = valid.shape[0]
    dev = valid.device
    f32 = torch.float32
    tri_ids = torch.where(
        valid, (torch.arange(T, device=dev) + 1).to(f32), 0.0)
    cols = list(e0) + list(e1)
    cols += list(zplane_c)                                  # lanes 6-8
    cols.append(tri_ids)                                    # lane 9
    cols.append(torch.zeros((T,), dtype=f32, device=dev))   # lane 10
    # Lanes 11-14: float bbox for the kernels' scalar row skip.
    cols.append(torch.where(valid, tx0.to(f32), 4096.0))
    cols.append(torch.where(valid, tx1.to(f32), -1.0))
    cols.append(torch.where(valid, ty0.to(f32), 4096.0))
    cols.append(torch.where(valid, ty1.to(f32), -1.0))
    for p in plane_cols:                                    # lanes 15-26
        cols.extend(p)
    z = torch.zeros((T,), dtype=f32, device=dev)
    cols.append(z if tangent_col is None                    # lane 27
                else torch.where(valid, tangent_col, 0.0))
    cols += [z, z, z, z]                                    # lanes 28-31
    return cols


def pack_setup_lanes(setup: TriangleSetup,
                     tri_material: Optional[torch.Tensor] = None,
                     tri_object: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(T, SETUP_LANES) row-per-triangle raster payload (see lane layout).
    With `tri_object`, lane 10 carries the material+object combo."""
    cols = list(setup.lane_cols)
    if tri_material is not None:
        mat = tri_material.to(torch.float32)
        if tri_object is not None:
            mat = mat + OBJ_COMBO * torch.clamp(tri_object, min=0).to(torch.float32)
        cols[10] = mat
    return torch.stack(cols, dim=1)


def clip_near_tris(g0: torch.Tensor, g1: torch.Tensor, g2: torch.Tensor,
                   tri_valid: torch.Tensor, cap: int, eps: float = 1e-3):
    """Clip triangles crossing the w = eps plane into up to 2 output
    triangles each, within a fixed budget of `cap` source triangles.

    g0/g1/g2: (T, L) corner rows [clip4 | attrs...] (attributes are lerped
    in homogeneous space, like a hardware clipper). Returns
    (h0, h1, h2 (2*cap, L), extra_valid (2*cap,), src (cap,) source
    triangle ids, overflow () i32).
    """
    T, L = g0.shape
    dev = g0.device
    w0, w1, w2 = g0[:, 3], g1[:, 3], g2[:, 3]
    ins = torch.stack([w0 > eps, w1 > eps, w2 > eps], dim=1)   # (T, 3)
    n_in = ins.sum(dim=1)
    crossing = tri_valid & (n_in >= 1) & (n_in <= 2)
    key = torch.where(crossing, torch.arange(T, device=dev), T)
    sel = torch.sort(key).values
    if cap <= T:
        sel = sel[:cap]
    else:
        sel = torch.cat([sel, torch.full((cap - T,), T, device=dev,
                                         dtype=sel.dtype)])
    overflow = torch.clamp(crossing.sum() - cap, min=0).to(torch.int32)
    live = sel < T
    src = torch.clamp(sel, max=T - 1)

    stack = torch.stack([g0[src], g1[src], g2[src]], dim=1)      # (cap, 3, L)
    ia = ins[src].to(torch.int32)                               # (cap, 3)
    two_in = ia.sum(dim=1) == 2
    in_pos = torch.argmax(ia, dim=1)      # first inside corner
    out_pos = torch.argmin(ia, dim=1)     # first outside corner
    # Rotate corners so the canonical layout holds: 2-inside -> outside
    # vertex at slot 2; 1-inside -> inside vertex at slot 0. Winding is
    # preserved (cyclic rotation).
    k = torch.where(two_in, (out_pos + 1) % 3, in_pos)
    idx = (k[:, None] + torch.arange(3, device=dev)[None]) % 3
    rot = torch.take_along_dim(stack, idx[:, :, None], dim=1)
    A, B, C = rot[:, 0], rot[:, 1], rot[:, 2]

    def lerp(u, v):
        """Intersection of segment u->v with the w = eps plane."""
        wu, wv = u[:, 3], v[:, 3]
        t = (eps - wu) / torch.where(torch.abs(wv - wu) > 1e-12, wv - wu, 1.0)
        t = torch.clamp(t, 0.0, 1.0)[:, None]
        # u + t * (v - u) as XLA fuses it: one rounding of the product-sum.
        return fma(t, v - u, u)

    i_bc = lerp(B, C)       # two-inside case
    i_ca = lerp(C, A)       # shared: C->A crossing (both cases)
    i_ab = lerp(A, B)       # one-inside case

    # First output triangle: (A, B, i_bc) when 2-in else (A, i_ab, i_ca).
    t1_1 = torch.where(two_in[:, None], B, i_ab)
    t1_2 = torch.where(two_in[:, None], i_bc, i_ca)
    # Second output triangle (only 2-in): (A, i_bc, i_ca).
    h0 = torch.cat([A, A], dim=0)
    h1 = torch.cat([t1_1, i_bc], dim=0)
    h2 = torch.cat([t1_2, i_ca], dim=0)
    extra_valid = torch.cat([live, live & two_in], dim=0)
    return h0, h1, h2, extra_valid, src, overflow


def _append_clipped(lanes, bbox, valid, gs, tri_valid, config: FrameConfig,
                    tri_material, tri_object, has_normals: bool,
                    has_uvs: bool):
    """Run the near-plane clip stage and append its output triangles to the
    packed lane rows. Returns (lanes, bbox, valid, clip_overflow)."""
    cap = config.near_clip_tris
    h0, h1, h2, ev, src, ovf = clip_near_tris(gs[0], gs[1], gs[2],
                                              tri_valid, cap)
    setup = _setup_from_corners(h0, h1, h2, ev, config,
                                has_normals=has_normals, has_uvs=has_uvs)
    mat = None if tri_material is None else tri_material[src].repeat(2)
    obj = None if tri_object is None else tri_object[src].repeat(2)
    elanes = pack_setup_lanes(setup, mat, obj)
    # _setup_from_corners numbers rows locally: offset the ids past the
    # soup so the visibility buffer stays unique and nonzero.
    T = valid.shape[0]
    elanes[:, 9] = torch.where(ev, elanes[:, 9] + T, 0.0)
    lanes = torch.cat([lanes, elanes], dim=0)
    bbox = torch.cat([bbox, setup.bbox], dim=0)
    valid = torch.cat([valid, setup.valid], dim=0)
    return lanes, bbox, valid, ovf


def triangle_setup_packed(clip: torch.Tensor, indices: torch.Tensor,
                          tri_valid: torch.Tensor, config: FrameConfig,
                          world_normals: Optional[torch.Tensor],
                          uvs: Optional[torch.Tensor],
                          tri_material: Optional[torch.Tensor] = None,
                          tri_object: Optional[torch.Tensor] = None,
                          vertex_theta: Optional[torch.Tensor] = None):
    """Production setup: returns (lanes (T', SETUP_LANES) f32, bbox (T', 4)
    i32, valid (T',) bool, clip_overflow () i32), where T' = T plus
    2 * near_clip_tris appended clip rows when near clipping is on. With
    enable_vertex_tangents, `vertex_theta` (V,) (vertex_world_theta) gives
    each triangle its corner-0 theta in lane 27; the near-clip rows carry
    none, as in the JAX package."""
    parts = [clip]
    if world_normals is not None:
        parts.append(world_normals)
    if uvs is not None:
        parts.append(uvs)
    packed = torch.cat(parts, dim=-1) if len(parts) > 1 else clip
    idx = indices.long()
    g0 = packed[idx[:, 0]]
    g1 = packed[idx[:, 1]]
    g2 = packed[idx[:, 2]]
    tangent_col = None
    if config.enable_vertex_tangents and vertex_theta is not None:
        tangent_col = vertex_theta[idx[:, 0]]
    setup = _setup_from_corners(g0, g1, g2, tri_valid, config,
                                world_normals is not None, uvs is not None,
                                tangent_col)
    lanes = pack_setup_lanes(setup, tri_material, tri_object)
    bbox, valid = setup.bbox, setup.valid
    ovf = torch.zeros((), dtype=torch.int32, device=clip.device)
    if config.near_clip_tris > 0:
        lanes, bbox, valid, ovf = _append_clipped(
            lanes, bbox, valid, (g0, g1, g2), tri_valid, config,
            tri_material, tri_object, world_normals is not None,
            uvs is not None)
    return lanes, bbox, valid, ovf


class BinnedPairs(NamedTuple):
    pair_data: torch.Tensor     # (Bcap + smalls, SETUP_LANES) f32: rows
    #                             [0, Bcap=max_big_tris) are the global
    #                             large-triangle list (walked by EVERY tile);
    #                             the per-tile binned rows follow. Rows past
    #                             a live range carry tri id 0.
    tile_offsets: torch.Tensor  # (num_tiles + 1,) i32 row ranges per tile
    #                             (already offset by Bcap)
    num_pairs: torch.Tensor     # () i32 live binned pairs
    overflow: torch.Tensor      # () i32 pairs/big-tris dropped (capacity)
    big_count: torch.Tensor     # () i32 live rows in the big-triangle list


def bin_pairs(lanes: torch.Tensor, bbox: torch.Tensor, valid: torch.Tensor,
              config: FrameConfig) -> BinnedPairs:
    """Sort-based tile binning over packed lane rows.

    Every triangle owns K = max_tiles_per_tri implicit slots; slot k holds
    the k-th tile of its bbox span in row-major order, or a sentinel tile
    that sorts last. One stable sort of the int64 key tile * (T*K) + slot
    puts the live pairs in (tile, triangle) order: the order both branches
    of the JAX package's sort give. Triangles spanning MORE than K tiles go
    to a separate global list of capacity max_big_tris that every tile
    also walks. Capacity misses on either list count toward `overflow`.
    """
    P = config.max_pairs
    K = config.max_tiles_per_tri
    Bcap = config.max_big_tris
    T = valid.shape[0]
    num_tiles = config.num_tiles
    dev = lanes.device
    i32 = torch.int32

    tx0, ty0, tx1, ty1 = bbox[:, 0], bbox[:, 1], bbox[:, 2], bbox[:, 3]
    spanx = tx1 - tx0 + 1
    spany = ty1 - ty0 + 1
    ntiles = torch.where(valid, spanx * spany, 0)
    big = ntiles > K                                     # large-triangle path
    ntiles_small = torch.where(big, 0, ntiles)

    # Slot k of a small triangle -> (kx, ky) inside its span. Exact integer
    # division (the JAX package's float-reciprocal trick exists for the
    # TPU's vector unit and gives the same quotients; a test pins that).
    ks = torch.arange(K, dtype=i32, device=dev)[None, :]            # (1, K)
    span1 = torch.clamp(spanx, min=1)[:, None]
    ky = torch.div(ks, span1, rounding_mode="floor")
    kx = ks - ky * span1
    tile_kt = (ty0[:, None] + ky) * config.tiles_x + (tx0[:, None] + kx)
    live_kt = ks < ntiles_small[:, None]
    tile_kt = torch.where(live_kt, tile_kt, num_tiles)   # sentinel sorts last

    slots = T * K
    key = tile_kt.to(torch.int64) * slots + torch.arange(
        slots, dtype=torch.int64, device=dev).view(T, K)
    key = torch.sort(key.view(-1), stable=True).values[:P]
    flat_tile = key // slots
    flat_tri = (key % slots) // K

    total = ntiles_small.sum()
    big_total = big.sum()
    overflow = (torch.clamp(total - P, min=0)
                + torch.clamp(big_total - Bcap, min=0)).to(i32)

    tile_offsets = torch.searchsorted(
        flat_tile, torch.arange(num_tiles + 1, dtype=torch.int64, device=dev))
    # The big-triangle list occupies rows [0, Bcap); binned rows follow.
    tile_offsets = (torch.clamp(tile_offsets, max=P) + Bcap).to(i32)
    num_pairs = torch.clamp(total, max=P).to(i32)

    # Sentinel rows route through a zero row appended at index T.
    live = flat_tile < num_tiles
    lanes_z = torch.cat(
        [lanes, torch.zeros((1, lanes.shape[1]), dtype=lanes.dtype, device=dev)])
    pair_data = lanes_z[torch.where(live, flat_tri, T)]  # (<=P, SETUP_LANES)

    # Global big-triangle list: big-tri indices in ascending order, Bcap kept.
    big_key = torch.where(big, torch.arange(T, device=dev), T)
    big_key = torch.sort(big_key).values[:Bcap]
    if Bcap > T:
        big_key = torch.cat([big_key, torch.full(
            (Bcap - T,), T, dtype=big_key.dtype, device=dev)])
    big_rows = lanes_z[big_key]                          # (Bcap, SETUP_LANES)
    big_count = torch.clamp(big_total, max=Bcap).to(i32)

    pair_data = torch.cat([big_rows, pair_data], dim=0)
    return BinnedPairs(pair_data, tile_offsets, num_pairs, overflow, big_count)


# ---------------------------------------------------------------------------
# Cluster path: setup from cluster-local vertex pages + group binning
# ---------------------------------------------------------------------------

def _transform_corner_cols(px, py, pz, nx0, ny0, nz0, u, v, m, viewproj):
    """Object-space corner columns + per-row matrix columns `m` (25 x
    (Kt,): model 4x4 row-major, then the normal 3x3) -> corner rows
    [clip4 | wnormal3 | uv2] (Kt, 9)."""
    wx = dot3(m[0], px, m[1], py, m[2], pz) + m[3]
    wy = dot3(m[4], px, m[5], py, m[6], pz) + m[7]
    wz = dot3(m[8], px, m[9], py, m[10], pz) + m[11]
    vp = viewproj
    cx = dot3(vp[0, 0], wx, vp[0, 1], wy, vp[0, 2], wz) + vp[0, 3]
    cy = dot3(vp[1, 0], wx, vp[1, 1], wy, vp[1, 2], wz) + vp[1, 3]
    cz = dot3(vp[2, 0], wx, vp[2, 1], wy, vp[2, 2], wz) + vp[2, 3]
    cw = dot3(vp[3, 0], wx, vp[3, 1], wy, vp[3, 2], wz) + vp[3, 3]
    nx = dot3(m[16], nx0, m[17], ny0, m[18], nz0)
    ny = dot3(m[19], nx0, m[20], ny0, m[21], nz0)
    nz = dot3(m[22], nx0, m[23], ny0, m[24], nz0)
    return torch.stack([cx, cy, cz, cw, nx, ny, nz, u, v], dim=1)


def _dequantized_corner_cols(q6, dq, meshlet_tris: int):
    """Quantized corner value columns (6 x (Kt,) f32 holding 16-bit values:
    px, py, pz, oct, u-half, v-half) + per-page dequant rows (Kc, 8) ->
    object-space columns (px, py, pz, nx, ny, nz, u, v)
    (models/pageblob.py layout)."""
    def rep(col):
        return col.repeat_interleave(meshlet_tris)
    inv = 1.0 / 65535.0
    px = fma(q6[0], rep(dq[:, 3]) * inv, rep(dq[:, 0]))
    py = fma(q6[1], rep(dq[:, 4]) * inv, rep(dq[:, 1]))
    pz = fma(q6[2], rep(dq[:, 5]) * inv, rep(dq[:, 2]))
    o = q6[3].to(torch.int32)
    a = fma((o & 255).to(torch.float32), 2.0 / 255.0, -1.0)
    b = fma((o >> 8).to(torch.float32), 2.0 / 255.0, -1.0)
    z = 1.0 - torch.abs(a) - torch.abs(b)
    t = torch.clamp(-z, 0.0, 1.0)
    x = a + torch.where(a >= 0, -t, t)
    y = b + torch.where(b >= 0, -t, t)
    rl = 1.0 / torch.sqrt(torch.clamp(dot3(x, x, y, y, z, z), min=1e-20))

    def half(col):   # 16-bit value -> its bits as an f16 -> f32
        return col.to(torch.int32).to(torch.int16).view(torch.float16).to(
            torch.float32)
    return px, py, pz, x * rl, y * rl, z * rl, half(q6[4]), half(q6[5])


def setup_from_compacted(scene, comp, viewproj: torch.Tensor,
                         config: FrameConfig):
    """Setup of a CompactedTris: from the cluster pages, or with
    enable_skinning from the global vertex table (ops/skinning.py rewrites
    the vertex positions and normals; the static pages would be stale)."""
    if config.enable_skinning:
        return triangle_setup_compacted(
            scene.positions, scene.normals, scene.uvs, scene.object_mats,
            scene.object_normal_mats, viewproj, comp.indices, comp.valid,
            config, comp.material, comp.object)
    return triangle_setup_clustered(scene, comp, viewproj, config)


def triangle_setup_compacted(positions: torch.Tensor, normals: torch.Tensor,
                             uvs: torch.Tensor, object_mats: torch.Tensor,
                             object_normal_mats: torch.Tensor,
                             viewproj: torch.Tensor, indices: torch.Tensor,
                             tri_valid: torch.Tensor, config: FrameConfig,
                             tri_material: torch.Tensor,
                             tri_object: torch.Tensor):
    """Setup of the compacted visible triangles from the global vertex
    table: each corner's position, normal and uv gathered by its vertex id
    and transformed with the owning object's matrices (`tri_object`, from
    the cluster rows: instances share vertex data). The JAX package reads
    a (V, 10) vertex table [pos3, nrm3, uv2, objid] that repeats these
    fields; the port reads the fields themselves. No Reyes dicing and no
    tangent lane, as in the JAX package's vertex-table path. Returns
    (lanes, bbox, valid, overflow) like triangle_setup_packed."""
    O = object_mats.shape[0]
    mat_table = torch.cat([object_mats.reshape(O, 16),
                           object_normal_mats.reshape(O, 9)], dim=-1)
    mm = mat_table[tri_object.long()]
    m_cols = [mm[:, i] for i in range(25)]
    gs = []
    for corner in range(3):
        vid = indices[:, corner].long()
        p, n, uv = positions[vid], normals[vid], uvs[vid]
        gs.append(_transform_corner_cols(p[:, 0], p[:, 1], p[:, 2], n[:, 0],
                                         n[:, 1], n[:, 2], uv[:, 0], uv[:, 1],
                                         m_cols, viewproj))
    setup = _setup_from_corners(gs[0], gs[1], gs[2], tri_valid, config,
                                has_normals=True, has_uvs=True)
    lanes = pack_setup_lanes(setup, tri_material, tri_object)
    bbox, valid = setup.bbox, setup.valid
    ovf = torch.zeros((), dtype=torch.int32, device=tri_valid.device)
    if config.near_clip_tris > 0:
        lanes, bbox, valid, ovf = _append_clipped(
            lanes, bbox, valid, gs, tri_valid, config, tri_material,
            tri_object, True, True)
    return lanes, bbox, valid, ovf


def triangle_setup_clustered(scene, comp, viewproj: torch.Tensor,
                             config: FrameConfig):
    """Setup from cluster-local vertex pages. `comp` is a
    clod.CompactedTris. Each visible slot fetches its geometry cluster's
    quantized page as one row; pages are corner-major (row j = corner * 128
    + tri), so each corner's values are a contiguous lane block. Returns
    (lanes (Kt', SETUP_LANES), bbox (Kt', 4) i32, valid (Kt',) bool,
    overflow () i32) like triangle_setup_packed. With enable_reyes the
    micro rows of ops/reyes.py follow the main rows (before the near-clip
    rows), and the overflow adds the Reyes budgets' to the near clip's."""
    from ..models.clusters import MESHLET_TRIS, SLAB_VERTS
    O = scene.object_mats.shape[0]
    mat_table = torch.cat([scene.object_mats.reshape(O, 16),
                           scene.object_normal_mats.reshape(O, 9)], dim=-1)
    G = scene.geom_slot.shape[0]
    slots = scene.geom_slot[torch.clamp(comp.geom, 0, G - 1).long()]
    gids = torch.clamp(slots, 0, scene.cluster_verts.shape[0] - 1).long()
    slabs = scene.cluster_verts[gids]                   # (Kc, SLAB*3) i32 bits
    dq = scene.cluster_dequant[gids]                    # (Kc, 8) f32
    S = SLAB_VERTS
    w = [slabs[:, k * S:(k + 1) * S] for k in range(3)]
    planes = []
    for wk in w:                                        # two 16-bit values
        planes.append((wk & 0xFFFF).to(torch.float32))
        planes.append(((wk >> 16) & 0xFFFF).to(torch.float32))
    m_slot = mat_table[comp.slot_object.long()]          # (Kc, 25)
    m_cols = [m_slot[:, i].repeat_interleave(MESHLET_TRIS) for i in range(25)]
    M = MESHLET_TRIS

    def corner_cols(c):
        q6 = [p[:, c * M:(c + 1) * M].reshape(-1) for p in planes]
        return _dequantized_corner_cols(q6, dq, M)

    gs = [_transform_corner_cols(*corner_cols(c), m_cols, viewproj)
          for c in range(3)]
    tri_ok = comp.valid
    extra = None
    ovf = torch.zeros((), dtype=torch.int32, device=comp.valid.device)
    if config.enable_reyes and config.reyes_tris > 0:
        # Reyes micro-tessellation (ops/reyes.py): diced parents leave the
        # main stream; the micro rows go after the main pack.
        from . import reyes as reyes_ops
        elanes, ebbox, evalid, keep, r_ovf = reyes_ops.dice_reyes(
            gs, comp.valid, comp, scene, viewproj, config,
            id_base=comp.valid.shape[0])
        tri_ok = comp.valid & keep
        extra = (elanes, ebbox, evalid)
        ovf = ovf + r_ovf
    tangent_col = None
    if config.enable_vertex_tangents:
        # The corner-0 object tangents, fetched in the vertex pages' slot
        # order, rotate to world with the model 3x3 and encode against
        # the corner-0 world normal (an object-space angle would break
        # under instance rotation: ONB(R n) != R ONB(n)).
        G2 = scene.cluster_tangents.shape[0]
        trows = scene.cluster_tangents[torch.clamp(gids, 0, G2 - 1)]
        ot = [trows[:, k * M:(k + 1) * M].reshape(-1) for k in range(4)]
        wtx, wty, wtz = rotate_cols_3x3(m_cols, _MODEL3, *ot[:3])
        tangent_col = encode_theta_cols(wtx, wty, wtz, ot[3], gs[0][:, 4],
                                        gs[0][:, 5], gs[0][:, 6])
    setup = _setup_from_corners(gs[0], gs[1], gs[2], tri_ok, config,
                                has_normals=True, has_uvs=True,
                                tangent_col=tangent_col)
    lanes = pack_setup_lanes(setup, comp.material, comp.object)
    bbox, valid = setup.bbox, setup.valid
    if extra is not None:
        lanes = torch.cat([lanes, extra[0]], dim=0)
        bbox = torch.cat([bbox, extra[1]], dim=0)
        valid = torch.cat([valid, extra[2]], dim=0)
    if config.near_clip_tris > 0:
        lanes, bbox, valid, clip_ovf = _append_clipped(
            lanes, bbox, valid, gs, tri_ok, config, comp.material,
            comp.object, True, True)
        ovf = ovf + clip_ovf
    return lanes, bbox, valid, ovf


class GroupBinnedPairs(NamedTuple):
    """Group-granular bin output of the clustered path: pairs are
    (group_rows-row group, tile). The raster reads each group's contiguous
    rows straight from `lanes`, so there is no per-pair payload."""
    lanes: torch.Tensor         # (T, SETUP_LANES) f32 raw setup rows
    group_ids: torch.Tensor     # (Pc,) i32 group ids sorted by tile
    tile_offsets: torch.Tensor  # (num_tiles + 1,) i32 pair ranges per tile
    num_pairs: torch.Tensor     # () i32 live (group, tile) pairs
    overflow: torch.Tensor      # () i32 pairs/big groups dropped (capacity)
    big_ids: torch.Tensor       # (Bg,) i32 global large-group list
    big_count: torch.Tensor     # () i32 live rows in big_ids
    big_bx: torch.Tensor        # (Bg,) i32 group tile box tx0*2048+tx1
    big_by: torch.Tensor        # (Bg,) i32 ty0*2048+ty1 (dead: inverted)


def bin_groups(lanes: torch.Tensor, bbox: torch.Tensor, valid: torch.Tensor,
               config: FrameConfig) -> GroupBinnedPairs:
    """Bin group_rows-row groups of consecutive setup rows to tiles.

    Same sort-based scheme as bin_pairs over T/GR groups: a group's bbox
    is the union of its valid rows' tile boxes; groups spanning more than
    max_tiles_per_group tiles go to a global list every tile walks.
    Invalid rows are masked in the lane table itself (id 0 + inverted
    bbox), so `valid` must be the validity baked into `lanes`."""
    GR = config.group_rows
    T = valid.shape[0]
    if T % GR:
        raise ValueError(f"{T} setup rows are not a multiple of group_rows "
                         f"{GR}")
    NG = T // GR
    Kg = config.max_tiles_per_group
    Pc = config.max_group_pairs
    Bg = config.max_big_groups
    num_tiles = config.num_tiles
    dev = lanes.device
    i32 = torch.int32

    huge = 1 << 20
    vx0 = torch.where(valid, bbox[:, 0], huge).reshape(NG, GR).amin(dim=1)
    vy0 = torch.where(valid, bbox[:, 1], huge).reshape(NG, GR).amin(dim=1)
    vx1 = torch.where(valid, bbox[:, 2], -huge).reshape(NG, GR).amax(dim=1)
    vy1 = torch.where(valid, bbox[:, 3], -huge).reshape(NG, GR).amax(dim=1)
    gvalid = valid.reshape(NG, GR).any(dim=1)

    spanx = vx1 - vx0 + 1
    spany = vy1 - vy0 + 1
    ntiles = torch.where(gvalid, spanx * spany, 0)
    big = ntiles > Kg
    ntiles_small = torch.where(big, 0, ntiles)

    ks = torch.arange(Kg, dtype=i32, device=dev)[None, :]
    span1 = torch.clamp(spanx, min=1)[:, None]
    ky = torch.div(ks, span1, rounding_mode="floor")
    kx = ks - ky * span1
    tile_kg = (vy0[:, None] + ky) * config.tiles_x + (vx0[:, None] + kx)
    live_kg = ks < ntiles_small[:, None]
    tile_kg = torch.where(live_kg, tile_kg, num_tiles)

    slots = NG * Kg
    key = tile_kg.to(torch.int64).reshape(-1) * slots + torch.arange(
        slots, dtype=torch.int64, device=dev)
    key = torch.sort(key).values
    flat_tile = key // slots
    flat_gid = (key % slots) // Kg

    total = ntiles_small.sum()
    big_total = big.sum()
    overflow = (torch.clamp(total - Pc, min=0)
                + torch.clamp(big_total - Bg, min=0)).to(i32)

    if Pc < slots:
        flat_tile, flat_gid = flat_tile[:Pc], flat_gid[:Pc]
    elif Pc > slots:
        flat_tile = torch.cat([flat_tile, torch.full(
            (Pc - slots,), num_tiles, dtype=flat_tile.dtype, device=dev)])
        flat_gid = torch.cat([flat_gid, torch.zeros(
            (Pc - slots,), dtype=flat_gid.dtype, device=dev)])
    tile_offsets = torch.searchsorted(
        flat_tile, torch.arange(num_tiles + 1, dtype=torch.int64,
                                device=dev)).to(i32)
    num_pairs = torch.clamp(total, max=Pc).to(i32)
    group_ids = torch.clamp(flat_gid, max=NG - 1).to(i32)

    big_key = torch.sort(torch.where(
        big, torch.arange(NG, dtype=i32, device=dev), NG)).values
    if Bg <= NG:
        big_key = big_key[:Bg]
    else:
        big_key = torch.cat([big_key, torch.full(
            (Bg - NG,), NG, dtype=big_key.dtype, device=dev)])
    live_big = big_key < NG
    big_ids = torch.clamp(big_key, max=NG - 1).to(i32)
    big_count = torch.clamp(big_total, max=Bg).to(i32)
    inv_box = 2047 * 2048
    bl = big_ids.long()
    big_bx = torch.where(live_big, vx0[bl] * 2048 + vx1[bl], inv_box).to(i32)
    big_by = torch.where(live_big, vy0[bl] * 2048 + vy1[bl], inv_box).to(i32)
    return GroupBinnedPairs(lanes, group_ids, tile_offsets, num_pairs,
                            overflow, big_ids, big_count, big_bx, big_by)


def bin_clustered(lanes: torch.Tensor, bbox: torch.Tensor, valid: torch.Tensor,
                  config: FrameConfig):
    """Binning entry for clustered (row-contiguous) setup output: group
    binning when enabled, else the per-triangle path."""
    if config.group_binning:
        return bin_groups(lanes, bbox, valid, config)
    return bin_pairs(lanes, bbox, valid, config)
