"""The plain reference's geometry: vertex transform, the clip at the
camera plane, and a rasterizer that tests every pixel centre inside each
triangle's box.

Semantics, as the renderer defines its visibility buffer:

- world = T R S p per object (R a turn about +y, S uniform), normals
  turned by R; clip = P V world with V a look-at view (right-handed, -z
  forward) and P the reverse-Z perspective with an infinite far plane,
  so a fragment's depth is near / w;
- triangles are clipped at w = 1e-3 (corners and their attributes lerped
  in homogeneous space); the viewport flips y (NDC +y up, pixel rows
  down); front faces run counter-clockwise in the world, which is a
  negative signed area in pixels, and a triangle under 1e-3 square pixels
  (twice its area) is not drawn;
- a pixel is covered where its centre lies inside or on every edge; of
  the triangles covering it the one with the largest depth wins, the
  first in draw order on a tie (the scene's objects in order, each
  mesh's triangles in order, the clipped pieces after all of them);
- vis = 1 + the winning triangle's index in the scene (0: none); the
  pieces of a clipped triangle take ids past the scene's triangles,
  which the check takes as pieces (reference "piece") without telling
  them apart;
  attributes interpolate perspective-correctly: the world position, and
  the octahedral encoding of the world normal, decoded per pixel.

`mode` "ref" computes in float64; "tf32" is the control: float32, with
every matrix product's operands rounded to TF32 (a 10-bit mantissa) and
summed in float32, as TF32 tensor cores do.
"""

from __future__ import annotations

import math

import torch

CLIP_W = 1e-3
MIN_AREA2 = 1e-3
CHUNK = 1 << 23          # (triangle, pixel) candidates a block


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa, to nearest even."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def matvec(m: torch.Tensor, v: torch.Tensor, mode: str) -> torch.Tensor:
    """(..., r, c) matrices times (..., c) vectors."""
    if mode == "tf32":
        m, v = tf32(m), tf32(v)
    return (m * v[..., None, :]).sum(-1)


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> torch.Tensor:
    eye, target, up = (torch.tensor(x, dtype=torch.float64)
                       for x in (eye, target, up))
    f = target - eye
    f = f / f.norm()
    r = torch.linalg.cross(f, up)
    r = r / r.norm()
    u = torch.linalg.cross(r, f)
    m = torch.eye(4, dtype=torch.float64)
    m[0, :3], m[1, :3], m[2, :3] = r, u, -f
    m[0, 3], m[1, 3], m[2, 3] = -(r @ eye), -(u @ eye), f @ eye
    return m


def perspective(fov_y: float, aspect: float, near: float) -> torch.Tensor:
    f = 1.0 / math.tan(fov_y / 2)
    m = torch.zeros((4, 4), dtype=torch.float64)
    m[0, 0], m[1, 1], m[2, 3], m[3, 2] = f / aspect, f, near, -1.0
    return m


class Geometry:
    """The scene's meshes placed by their objects, on `device`: every
    triangle's corners and corner normals in the world (T, 3, 3), its
    material."""

    def __init__(self, desc: dict, device, mode: str = "ref"):
        dt = torch.float64 if mode == "ref" else torch.float32
        pos, nrm, mats, models, rots = [], [], [], [], []
        for ob in desc["objects"]:
            mesh = desc["meshes"][ob["mesh"]]
            idx = torch.as_tensor(mesh["indices"]).long()
            pos.append(torch.as_tensor(mesh["positions"])[idx])
            nrm.append(torch.as_tensor(mesh["normals"])[idx])
            c, s = math.cos(ob["yaw"]), math.sin(ob["yaw"])
            rot = torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]],
                               dtype=torch.float64)
            model = torch.eye(4, dtype=torch.float64)
            model[:3, :3] = rot * ob["scale"]
            model[:3, 3] = torch.tensor(ob["position"], dtype=torch.float64)
            n = len(idx)
            models.append(model.expand(n, 4, 4))
            rots.append(rot.expand(n, 3, 3))
            mats.append(torch.full((n,), ob["material"], dtype=torch.long))
        self.mode, self.dtype, self.device = mode, dt, device
        self.material = torch.cat(mats).to(device)
        corners = torch.cat(pos).to(device, dt)             # (T, 3, 3)
        ones = torch.ones_like(corners[..., :1])
        self.world = matvec(torch.cat(models).to(device, dt)[:, None],
                            torch.cat([corners, ones], -1), mode)[..., :3]
        self.wnormal = matvec(torch.cat(rots).to(device, dt)[:, None],
                              torch.cat(nrm).to(device, dt), mode)


def oct_encode(n: torch.Tensor) -> torch.Tensor:
    """Unit vectors (..., 3) -> octahedral (..., 2) in [-1, 1]."""
    p = n[..., :2] / n.abs().sum(-1, keepdim=True).clamp(min=1e-300)
    fold = (1.0 - p.flip(-1).abs()) * torch.where(p >= 0, 1.0, -1.0)
    return torch.where(n[..., 2:] < 0, fold, p)


def oct_decode(e: torch.Tensor) -> torch.Tensor:
    z = 1.0 - e.abs().sum(-1, keepdim=True)
    t = (-z).clamp(min=0.0)
    xy = e - torch.where(e >= 0, t, -t)
    v = torch.cat([xy, z], -1)
    return v / v.norm(dim=-1, keepdim=True).clamp(min=1e-300)


def _clip(rows: torch.Tensor, ids: torch.Tensor):
    """Corner rows (T, 3, L) with clip w in lane 3 -> the rows and source
    ids of the triangles kept at w > CLIP_W: those wholly in front as
    they are, then the pieces of those crossing the plane; and the count
    of the whole ones."""
    inside = rows[..., 3] > CLIP_W
    n_in = inside.sum(1)
    keep = n_in == 3
    cross = (n_in == 1) | (n_in == 2)
    out, out_ids = [rows[keep]], [ids[keep]]
    if cross.any():
        r, i, ins = rows[cross], ids[cross], inside[cross]
        one = ins.sum(1) == 1
        # Turn the corners so that the lone corner (inside for one in,
        # outside for two) comes first; the winding is kept.
        lone = torch.where(one, ins.int().argmax(1), (~ins).int().argmax(1))
        order = (lone[:, None] + torch.arange(3, device=r.device)) % 3
        a, b, c = (r[torch.arange(len(r), device=r.device), order[:, k]]
                   for k in range(3))

        def cut(u, v):
            t = (CLIP_W - u[:, 3:4]) / (v[:, 3:4] - u[:, 3:4])
            return u + t * (v - u)
        ab, ac = cut(a, b), cut(a, c)
        pieces = [(torch.stack([a, ab, ac], 1)[one], i[one]),
                  (torch.stack([ab, b, c], 1)[~one], i[~one]),
                  (torch.stack([ab, c, ac], 1)[~one], i[~one])]
        for p, pi in pieces:
            out.append(p)
            out_ids.append(pi)
    return torch.cat(out), torch.cat(out_ids), int(keep.sum())


def _edges(sx, sy, px, py):
    """Barycentric numerators of pixel centres (px, py) in triangles with
    screen corners sx, sy (..., 3)."""
    e0 = (sx[:, 2] - sx[:, 1]) * (py - sy[:, 1]) - \
        (sy[:, 2] - sy[:, 1]) * (px - sx[:, 1])
    e1 = (sx[:, 0] - sx[:, 2]) * (py - sy[:, 2]) - \
        (sy[:, 0] - sy[:, 2]) * (px - sx[:, 2])
    e2 = (sx[:, 1] - sx[:, 0]) * (py - sy[:, 0]) - \
        (sy[:, 1] - sy[:, 0]) * (px - sx[:, 0])
    return e0, e1, e2


def rasterize(geo: Geometry, view: torch.Tensor, proj: torch.Tensor,
              near: float, width: int, height: int) -> dict:
    """The visibility buffer of one view: {"vis" (H, W) i64, "depth" (H, W),
    "world" (H, W, 3), "normal" (H, W, 3), "material" (H, W) i64, "piece"
    (H, W): the winner is a piece of a triangle clipped at the camera
    plane}."""
    mode, dt, dev = geo.mode, geo.dtype, geo.device
    vp = (proj @ view).to(dev, dt)
    ones = torch.ones_like(geo.world[..., :1])
    clip = matvec(vp, torch.cat([geo.world, ones], -1), mode)
    rows = torch.cat([clip, geo.world, oct_encode(geo.wnormal)], -1)
    T = len(rows)
    rows, src, whole = _clip(rows, torch.arange(T, device=dev))
    iw = 1.0 / rows[..., 3]
    sx = (rows[..., 0] * iw * 0.5 + 0.5) * width
    sy = (0.5 - rows[..., 1] * iw * 0.5) * height
    z = near * iw
    area = (sx[:, 1] - sx[:, 0]) * (sy[:, 2] - sy[:, 0]) - \
        (sx[:, 2] - sx[:, 0]) * (sy[:, 1] - sy[:, 0])
    x0 = torch.ceil(sx.min(1).values - 0.5).clamp(0, width)
    x1 = torch.floor(sx.max(1).values - 0.5).clamp(-1, width - 1)
    y0 = torch.ceil(sy.min(1).values - 0.5).clamp(0, height)
    y1 = torch.floor(sy.max(1).values - 0.5).clamp(-1, height - 1)
    nx = (x1 - x0 + 1).clamp(min=0).long()
    ny = (y1 - y0 + 1).clamp(min=0).long()
    live = (area < -MIN_AREA2) & (nx > 0) & (ny > 0)
    order = torch.nonzero(live).squeeze(1)    # draw order, clipped last
    x0, y0, nx = x0[order].long(), y0[order].long(), nx[order]
    count = nx * ny[order]
    sx, sy, z, area = sx[order], sy[order], z[order], area[order]
    npx = width * height
    zbuf = torch.zeros(npx, dtype=dt, device=dev)
    big = len(order)
    winner = torch.full((npx,), big, dtype=torch.long, device=dev)

    def blocks():
        ends = torch.cumsum(count, 0)
        start = 0
        while start < big:
            limit = (ends[start - 1] if start else 0) + CHUNK
            stop = max(int(torch.searchsorted(ends, limit, right=True)),
                       start + 1)
            yield start, stop
            start = stop

    def fragments(a, b):
        """Covered (row, pixel, depth) of rows a..b."""
        cnt = count[a:b]
        row = torch.repeat_interleave(torch.arange(a, b, device=dev), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        k = torch.arange(len(row), device=dev) - \
            torch.repeat_interleave(first, cnt)
        px = x0[row] + k % nx[row]
        py = y0[row] + torch.div(k, nx[row], rounding_mode="floor")
        cx, cy = px.to(dt) + 0.5, py.to(dt) + 0.5
        e0, e1, e2 = _edges(sx[row], sy[row], cx, cy)
        s = area[row]
        b0, b1, b2 = e0 / s, e1 / s, e2 / s
        d = b0 * z[row, 0] + b1 * z[row, 1] + b2 * z[row, 2]
        cov = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & (d > 0)
        return row[cov], (py * width + px)[cov], d[cov]

    spans = list(blocks())
    for a, b in spans:
        _, pix, d = fragments(a, b)
        zbuf.scatter_reduce_(0, pix, d, "amax")
    for a, b in spans:
        row, pix, d = fragments(a, b)
        won = d == zbuf[pix]
        winner.scatter_reduce_(0, pix[won], row[won], "amin")

    covered = winner < big
    r = winner[covered]
    p = torch.nonzero(covered).squeeze(1)
    cx = (p % width).to(dt) + 0.5
    cy = torch.div(p, width, rounding_mode="floor").to(dt) + 0.5
    e = torch.stack(_edges(sx[r], sy[r], cx, cy), -1) / area[r, None]
    zr = z[r]
    persp = e * zr
    persp = persp / persp.sum(-1, keepdim=True)
    corner = rows[order[r]]                              # (n, 3, L)
    out = {
        "vis": torch.zeros(npx, dtype=torch.long, device=dev),
        "depth": torch.zeros(npx, dtype=dt, device=dev),
        "world": torch.zeros((npx, 3), dtype=dt, device=dev),
        "normal": torch.zeros((npx, 3), dtype=dt, device=dev),
        "material": torch.full((npx,), -1, dtype=torch.long, device=dev),
        "piece": torch.zeros(npx, dtype=torch.bool, device=dev),
    }
    tri = src[order[r]]
    out["vis"][p] = tri + 1
    out["depth"][p] = (e * zr).sum(-1)
    out["world"][p] = (persp[..., None] * corner[..., 4:7]).sum(1)
    out["normal"][p] = oct_decode((persp[..., None] * corner[..., 7:9])
                                  .sum(1))
    out["material"][p] = geo.material[tri]
    out["piece"][p] = order[r] >= whole
    return {k: v.reshape((height, width) + v.shape[1:])
            for k, v in out.items()}
