"""Tiled light culling and per-tile shading of many local lights: the CUDA
kernel (csrc/tiled_shade.cu) and its plain PyTorch version.

Port of basicrenderer_tpu/ops/lighting.py (`tile_world_bounds`,
`cull_lights_tiles`, the Pallas `_tiled_shade_kernel` and its twin
`tiled_shade_ref`). Lights are culled per raster tile against the tile's
world-space AABB from its depth min/max, into a fixed-capacity list of
max_lights_per_cluster light rows per tile; the shading walks each tile's
list and evaluates GGX / Smith / Schlick / Lambert for every pixel of the
tile. Directional lights stay in the full-screen pass (ops/shade.py).

`tiled_shade` picks the implementation by the device of its inputs: CUDA
tensors launch the kernel (or raise), CPU tensors run the plain version.
On the card one thread shades one pixel and a block a 256-pixel slice of a
tile; a warp of 32 pixels (row-major within the tile) none of which is
valid writes +0.0 without walking the lights, which is what the plain
version gives there (see csrc/tiled_shade.cu).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from ..graph.framedata import LIGHT_STRIDE, FrameConfig, ViewData
from ..utils import cuda_build, math3d

SHADE_IN_CHANNELS = 12  # [n xyz, albedo rgb, metallic, roughness, wpos xyz, valid]
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "tiled_shade.cu"


def tile_world_bounds(depth_p: torch.Tensor, view: ViewData,
                      config: FrameConfig, row0_tiles: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile world-space AABB (mins (NT, 3), maxs (NT, 3)) from the
    padded depth buffer; empty pixels (z = 0) clamp to a small epsilon so
    boxes stay finite."""
    th, tw = config.tile_h, config.tile_w
    tx = config.tiles_x
    ty = depth_p.shape[0] // th
    dev = depth_p.device
    d = depth_p.reshape(ty, th, tx, tw)
    zmax = d.amax(dim=(1, 3)).reshape(-1)           # nearest (reverse-Z)
    zmin = torch.clamp(d.amin(dim=(1, 3)).reshape(-1), min=1e-4)
    zmax = torch.maximum(zmax, zmin)
    tile_i = torch.arange(ty * tx, dtype=torch.int32, device=dev)
    cx0 = (tile_i % tx) * tw
    cy0 = (tile_i // tx + row0_tiles) * th
    x0 = cx0 / config.width * 2.0 - 1.0
    x1 = (cx0 + tw) / config.width * 2.0 - 1.0
    y0 = 1.0 - cy0 / config.height * 2.0
    y1 = 1.0 - (cy0 + th) / config.height * 2.0
    inv_vp = torch.linalg.inv_ex(view.viewproj)[0]

    def unproject(x, y, z):
        wx, wy, wz, ww = math3d.mat4_columns(inv_vp, x, y, z)
        iw = 1.0 / torch.where(torch.abs(ww) > 1e-12, ww, 1.0)
        return torch.stack([wx * iw, wy * iw, wz * iw], dim=-1)

    pts = torch.stack([unproject(xx, yy, zz) for xx in (x0, x1)
                       for yy in (y0, y1) for zz in (zmin, zmax)], dim=1)
    return pts.amin(dim=1), pts.amax(dim=1)


def cull_lights_tiles(depth_p: torch.Tensor, lights: torch.Tensor,
                      num_lights: torch.Tensor, view: ViewData,
                      config: FrameConfig, row0_tiles: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Light-vs-tile culling: (payload (NT, MAX, LIGHT_STRIDE) f32, counts
    (NT,) i32, overflow () i32). Positional lights (type != 0) are tested
    sphere (range) against the tile AABB; each tile keeps its first MAX
    hits in light order, dead slots carry intensity 0."""
    L = lights.shape[0]
    MAX = config.max_lights_per_cluster
    dev = lights.device
    mins, maxs = tile_world_bounds(depth_p, view, config, row0_tiles)
    lpos, ltype, lrange = lights[:, 0:3], lights[:, 3], lights[:, 11]
    live = (torch.arange(L, device=dev) < num_lights) & (ltype != 0.0)
    if config.max_shadow_lights > 0:
        live = live & ~((lights[:, 14] >= 0.0)
                        & (lights[:, 14] < float(config.max_shadow_lights)))
    if config.max_shadow_cubes > 0:
        live = live & ~((lights[:, 15] >= 0.0)
                        & (lights[:, 15] < float(config.max_shadow_cubes)))
    d = (torch.clamp(mins[:, None, :] - lpos[None, :, :], min=0.0)
         + torch.clamp(lpos[None, :, :] - maxs[:, None, :], min=0.0))
    dist2 = (d * d).sum(dim=-1)
    hit = live[None, :] & (dist2 <= (lrange * lrange)[None, :])   # (NT, L)
    counts = hit.sum(dim=1).to(torch.int32)
    overflow = torch.clamp(counts - MAX, min=0).sum().to(torch.int32)
    key = torch.where(hit, torch.arange(L, dtype=torch.int32, device=dev)[None],
                      L)
    key = torch.sort(key, dim=1).values
    if MAX <= L:
        key = key[:, :MAX]
    else:
        key = torch.cat([key, torch.full((key.shape[0], MAX - L), L,
                                         dtype=key.dtype, device=dev)], 1)
    payload = lights[torch.clamp(key, max=L - 1).long()]      # (NT, MAX, 16)
    payload[:, :, 7] = torch.where(key < L, payload[:, :, 7], 0.0)
    return payload, torch.clamp(counts, max=MAX), overflow


def _check_inputs(shade_in, payload, counts, cam_pos, config: FrameConfig):
    Hp, Wp = config.padded_height, config.padded_width
    NT = config.num_tiles
    MAX = config.max_lights_per_cluster
    if shade_in.dtype != torch.float32 or tuple(shade_in.shape) != (
            SHADE_IN_CHANNELS, Hp, Wp):
        raise ValueError(f"shade_in must be ({SHADE_IN_CHANNELS}, {Hp}, {Wp})"
                         f" f32, got {tuple(shade_in.shape)} {shade_in.dtype}")
    if payload.dtype != torch.float32 or tuple(payload.shape) != (
            NT, MAX, LIGHT_STRIDE):
        raise ValueError(f"payload must be ({NT}, {MAX}, {LIGHT_STRIDE}) "
                         f"f32, got {tuple(payload.shape)} {payload.dtype}")
    if counts.dtype != torch.int32 or tuple(counts.shape) != (NT,):
        raise ValueError(f"counts must be ({NT},) i32, got "
                         f"{tuple(counts.shape)} {counts.dtype}")
    if cam_pos.dtype != torch.float32 or cam_pos.numel() != 3:
        raise ValueError("cam_pos must be 3 f32")
    for name, x in (("shade_in", shade_in), ("payload", payload),
                    ("counts", counts), ("cam_pos", cam_pos)):
        if x.device != shade_in.device:
            raise ValueError(f"{name} is on {x.device}, shade_in on "
                             f"{shade_in.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def tiled_shade(shade_in: torch.Tensor, payload: torch.Tensor,
                counts: torch.Tensor, cam_pos: torch.Tensor,
                config: FrameConfig) -> torch.Tensor:
    """shade_in (SHADE_IN_CHANNELS, H', W') on the padded grid -> the
    local-light HDR contribution (3, H', W')."""
    _check_inputs(shade_in, payload, counts, cam_pos, config)
    dev = shade_in.device
    if dev.type == "cuda":
        return tiled_shade_cuda(shade_in, payload, counts, cam_pos, config)
    if dev.type == "cpu":
        return tiled_shade_plain(shade_in, payload, counts, cam_pos, config)
    raise ValueError(f"no tiled shader for device {dev}")


def tiled_shade_plain(shade_in: torch.Tensor, payload: torch.Tensor,
                      counts: torch.Tensor, cam_pos: torch.Tensor,
                      config: FrameConfig) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the JAX package's
    tiled_shade_ref): every tile at once, one light slot per step, slots
    past a tile's count masked. It spells the kernel's f32 operations in
    the kernel's order (component sums left to right, x^4 and x^5 by
    products, 1 / sqrt for rsqrt), so on the card the two agree to the
    ulp even where specular peaks amplify rounding."""
    _check_inputs(shade_in, payload, counts, cam_pos, config)
    th, tw = config.tile_h, config.tile_w
    tiles_x, tiles_y = config.tiles_x, config.tiles_y
    C = SHADE_IN_CHANNELS
    NT = tiles_x * tiles_y
    g = shade_in.reshape(C, tiles_y, th, tiles_x, tw).permute(1, 3, 0, 2, 4)
    g = g.reshape(NT, C, th, tw)
    nx, ny, nz, ar, ag, ab = (g[:, k] for k in range(6))
    metallic, roughness = g[:, 6], g[:, 7]
    wx, wy, wz, valid = g[:, 8], g[:, 9], g[:, 10], g[:, 11]

    def rsqrt(x):
        return 1.0 / torch.sqrt(x)

    vx, vy, vz = cam_pos[0] - wx, cam_pos[1] - wy, cam_pos[2] - wz
    vl = rsqrt(vx * vx + vy * vy + vz * vz + 1e-12)
    vx, vy, vz = vx * vl, vy * vl, vz * vl
    n_dot_v = torch.clamp(nx * vx + ny * vy + nz * vz, min=1e-4)
    alpha = torch.clamp(roughness * roughness, min=1e-3)
    a2 = alpha * alpha
    f0 = [0.04 * (1.0 - metallic) + c * metallic for c in (ar, ag, ab)]
    kd = 1.0 - metallic
    gv_sq = torch.sqrt(torch.clamp(n_dot_v * n_dot_v * (1.0 - a2) + a2,
                                   min=1e-12))
    acc = [torch.zeros_like(nx) for _ in range(3)]
    for j in range(payload.shape[1]):
        L = [payload[:, j, k].view(NT, 1, 1) for k in range(14)]
        tlx, tly, tlz = L[0] - wx, L[1] - wy, L[2] - wz
        dist2 = tlx * tlx + tly * tly + tlz * tlz
        inv_d = rsqrt(dist2 + 1e-12)
        ux, uy, uz = tlx * inv_d, tly * inv_d, tlz * inv_d
        att = 1.0 / torch.clamp(dist2, min=1e-4)
        dist = dist2 * inv_d
        q = dist / torch.clamp(L[11], min=1e-3)
        q2 = q * q
        win = torch.clamp(1.0 - q2 * q2, 0.0, 1.0)
        att = att * win * win
        cd = -(ux * L[4] + uy * L[5] + uz * L[6])
        spot = torch.clamp((cd - L[13]) / torch.clamp(L[12] - L[13], min=1e-4),
                           0.0, 1.0)
        att = torch.where(L[3] == 2.0, att * spot * spot, att)
        hx, hy, hz = ux + vx, uy + vy, uz + vz
        hl = rsqrt(hx * hx + hy * hy + hz * hz + 1e-12)
        hx, hy, hz = hx * hl, hy * hl, hz * hl
        n_dot_l = torch.clamp(nx * ux + ny * uy + nz * uz, min=0.0)
        n_dot_h = torch.clamp(nx * hx + ny * hy + nz * hz, min=0.0)
        v_dot_h = torch.clamp(vx * hx + vy * hy + vz * hz, min=0.0)
        dd = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
        D = a2 / torch.clamp(3.14159265 * dd * dd, min=1e-8)
        gv = n_dot_l * gv_sq
        gl = n_dot_v * torch.sqrt(torch.clamp(
            n_dot_l * n_dot_l * (1.0 - a2) + a2, min=1e-12))
        vis = 0.5 / torch.clamp(gv + gl, min=1e-8)
        om = 1.0 - v_dot_h
        om2 = om * om
        fres = om2 * om2 * om
        DV = D * vis
        rad = L[7] * att * n_dot_l * valid
        live = (j < counts).view(NT, 1, 1)
        for c, (alb, f0c) in enumerate(zip((ar, ag, ab), f0)):
            F = f0c + (1.0 - f0c) * fres
            term = (kd * (1.0 - F) * alb * 0.3183098861837907 + DV * F) \
                * L[8 + c] * rad
            acc[c] = torch.where(live, acc[c] + term, acc[c])
    out = torch.stack(acc, dim=1)                        # (NT, 3, th, tw)
    return out.reshape(tiles_y, tiles_x, 3, th, tw).permute(
        2, 0, 3, 1, 4).reshape(3, tiles_y * th, tiles_x * tw)


_fns = {}


def _kernel_fn(name: str = "br_tiled_shade"):
    """An entry point of the built library with its ctypes signature."""
    if name not in _fns:
        fn = getattr(cuda_build.load(SOURCE).lib, name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p, p, p, p, p, i, i, i, i, i, p]
                       if name == "br_tiled_shade" else [i])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def blocks_per_sm(config: FrameConfig) -> int:
    """Resident blocks an SM of the kernel at `config`'s light slots a
    tile (256 threads, one pixel each)."""
    return _kernel_fn("br_tiled_shade_blocks_per_sm")(
        config.max_lights_per_cluster)


def tiled_shade_cuda(shade_in: torch.Tensor, payload: torch.Tensor,
                     counts: torch.Tensor, cam_pos: torch.Tensor,
                     config: FrameConfig) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronisation).
    `tiled_shade_cuda.launches` counts the launches."""
    _check_inputs(shade_in, payload, counts, cam_pos, config)
    dev = shade_in.device
    if dev.type != "cuda":
        raise ValueError(f"tiled_shade_cuda needs CUDA tensors, got {dev}")
    out = torch.empty((3, config.padded_height, config.padded_width),
                      dtype=torch.float32, device=dev)
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(shade_in.data_ptr(), payload.data_ptr(), counts.data_ptr(),
                 cam_pos.data_ptr(), out.data_ptr(), config.tiles_x,
                 config.tiles_y, config.tile_h, config.tile_w,
                 config.max_lights_per_cluster, stream)
    if err != 0:
        raise RuntimeError(f"tiled shade kernel launch failed: CUDA error {err}")
    tiled_shade_cuda.launches += 1
    return out


tiled_shade_cuda.launches = 0
