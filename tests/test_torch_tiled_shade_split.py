"""The tiled shade's schedule on the card (csrc/tiled_shade.cu), emulated in
plain PyTorch on the CPU and held to the plain version of K3.

On the card one thread shades one pixel, a block a 256-pixel slice of a
tile, and a warp of 32 pixels (row-major within the tile) none of which
has valid != 0 writes +0.0 without walking the lights. That skip is exact
only if every pixel with valid == 0 comes out as +0.0 (sign bit included)
from the plain walk as well, which holds when every intermediate of the
walk is finite: its terms are then finite products times valid = 0.

Two inputs: the shade_in, light slots and counts that the port's clustered
128x128 frame (tests/test_torch_cluster_frame.py's rig) hands to K3, and
a built case with sky and pad pixels sharing tiles and warps with valid
pixels under live point and spot lights, whole invalid warps, a tile with
no lights and a light with a negative colour channel (so that some terms
at invalid pixels are -0.0). On both:
- `tiled_shade_plain` and the JAX package's `tiled_shade_pallas`
  (interpret mode) give exactly +0.0 at every pixel with valid == 0, and
  every floating-point intermediate of the plain walk is finite;
- `k3_schedule` (the card's schedule with the warp skip, each tile's
  walking warps summing their tile's slots up to its count with the
  light values of the kernel's staging, by a walk of its own) equals
  `tiled_shade_plain` bit for bit, and the mutation that skips a warp
  unless all its pixels are valid differs from it.
The CUDA kernel against the plain version on the same inputs is marked
`cuda` and skips without a card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch.overrides import TorchFunctionMode

from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
from basicrenderer_tpu.ops import lighting as jl
from basicrenderer_tpu_torch.graph.frame import build_frame_fn
from basicrenderer_tpu_torch.graph.framedata import (FrameConfig, FrameParams,
                                                     make_view)
from basicrenderer_tpu_torch.ops import lighting as pl

from tests.test_torch_cluster_frame import BASE, PORT_PKG, build_rig

THREADS = 256   # pixels a block
WARP = 32
BUILT = dict(width=256, height=60, tile_h=16, tile_w=128,
             max_lights_per_cluster=8)    # padded to 64 rows: 4 pad rows


# ---------------------------------------------------------------------------
# The schedule, emulated
# ---------------------------------------------------------------------------

def any_valid(valid: torch.Tensor) -> torch.Tensor:
    """The kernel's test: a warp walks the lights if any lane is valid."""
    return (valid != 0).any(-1)


def all_valid(valid: torch.Tensor) -> torch.Tensor:
    """A mutation: a warp walks the lights only if every lane is valid."""
    return (valid != 0).all(-1)


def walk_tile(g, lights, count, cam):
    """One tile's walk as a block of the kernel does it, over the pixels
    of its walking warps: g (SHADE_IN_CHANNELS, P); lights (MAX, 16) the
    tile's slots, of which it walks 0..count-1 with no masking; the range
    clamp, the cone denominator and the spot flag computed once a light
    (the kernel's staging). Returns (3, P)."""
    nx, ny, nz, ar, ag, ab, metallic, roughness, wx, wy, wz, valid = g
    vx, vy, vz = cam[0] - wx, cam[1] - wy, cam[2] - wz
    vl = 1.0 / torch.sqrt(vx * vx + vy * vy + vz * vz + 1e-12)
    vx, vy, vz = vx * vl, vy * vl, vz * vl
    n_dot_v = torch.clamp(nx * vx + ny * vy + nz * vz, min=1e-4)
    alpha = torch.clamp(roughness * roughness, min=1e-3)
    a2 = alpha * alpha
    f0 = [0.04 * (1.0 - metallic) + c * metallic for c in (ar, ag, ab)]
    kd = 1.0 - metallic
    gv_sq = torch.sqrt(torch.clamp(n_dot_v * n_dot_v * (1.0 - a2) + a2,
                                   min=1e-12))
    acc = [torch.zeros_like(nx) for _ in range(3)]
    for j in range(count):
        L = lights[j]
        rng_ = torch.clamp(L[11], min=1e-3)
        cone = torch.clamp(L[12] - L[13], min=1e-4)
        is_spot = bool(L[3] == 2.0)
        tlx, tly, tlz = L[0] - wx, L[1] - wy, L[2] - wz
        dist2 = tlx * tlx + tly * tly + tlz * tlz
        inv_d = 1.0 / torch.sqrt(dist2 + 1e-12)
        ux, uy, uz = tlx * inv_d, tly * inv_d, tlz * inv_d
        att = 1.0 / torch.clamp(dist2, min=1e-4)
        q = dist2 * inv_d / rng_
        q2 = q * q
        win = torch.clamp(1.0 - q2 * q2, 0.0, 1.0)
        att = att * win * win
        if is_spot:
            cd = -(ux * L[4] + uy * L[5] + uz * L[6])
            spot = torch.clamp((cd - L[13]) / cone, 0.0, 1.0)
            att = att * spot * spot
        hx, hy, hz = ux + vx, uy + vy, uz + vz
        hl = 1.0 / torch.sqrt(hx * hx + hy * hy + hz * hz + 1e-12)
        hx, hy, hz = hx * hl, hy * hl, hz * hl
        n_dot_l = torch.clamp(nx * ux + ny * uy + nz * uz, min=0.0)
        n_dot_h = torch.clamp(nx * hx + ny * hy + nz * hz, min=0.0)
        v_dot_h = torch.clamp(vx * hx + vy * hy + vz * hz, min=0.0)
        dd = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
        D = a2 / torch.clamp(3.14159265 * dd * dd, min=1e-8)
        gl = n_dot_v * torch.sqrt(torch.clamp(
            n_dot_l * n_dot_l * (1.0 - a2) + a2, min=1e-12))
        vis = 0.5 / torch.clamp(n_dot_l * gv_sq + gl, min=1e-8)
        om = 1.0 - v_dot_h
        om2 = om * om
        fres = om2 * om2 * om
        DV = D * vis
        rad = L[7] * att * n_dot_l * valid
        for c, (alb, f0c) in enumerate(zip((ar, ag, ab), f0)):
            F = f0c + (1.0 - f0c) * fres
            acc[c] = acc[c] + (kd * (1.0 - F) * alb * 0.3183098861837907
                               + DV * F) * L[8 + c] * rad
    return torch.stack(acc)


def k3_schedule(shade_in, payload, counts, cam_pos, cfg, walks=any_valid):
    """K3 by the card's schedule: each tile's pixels in row-major order cut
    into 256-pixel slices (blocks) of 32-pixel warps; lanes past the tile
    are invalid; a warp for which `walks(valid of its 32 lanes)` is false
    writes +0.0, the others walk their tile's lights (`walk_tile`)."""
    th, tw = cfg.tile_h, cfg.tile_w
    nt, npix = cfg.num_tiles, th * tw
    C = pl.SHADE_IN_CHANNELS
    slices = -(-npix // THREADS)
    g = shade_in.reshape(C, cfg.tiles_y, th, cfg.tiles_x, tw).permute(
        0, 1, 3, 2, 4).reshape(C, nt, npix)
    g = torch.nn.functional.pad(g, (0, slices * THREADS - npix))
    g = g.reshape(C, nt, -1, WARP)                  # (C, tiles, warps, 32)
    walking = walks(g[11])
    out = torch.zeros((3,) + tuple(g.shape[1:]), dtype=torch.float32)
    for t in range(nt):
        w = walking[t].nonzero()[:, 0]
        if w.numel():
            out[:, t, w] = walk_tile(g[:, t, w].reshape(C, -1), payload[t],
                                     int(counts[t]), cam_pos).reshape(
                                         3, -1, WARP)
    out = out.reshape(3, nt, -1)[:, :, :npix]
    return out.reshape(3, cfg.tiles_y, cfg.tiles_x, th, tw).permute(
        0, 1, 3, 2, 4).reshape(3, cfg.padded_height, cfg.padded_width)


class FiniteIntermediates(TorchFunctionMode):
    """Records every floating-point tensor a torch call returns inside
    the mode, and the calls whose result holds a non-finite value."""

    def __init__(self):
        super().__init__()
        self.seen = 0
        self.bad = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(x, torch.Tensor) and x.is_floating_point():
                self.seen += 1
                if not bool(torch.isfinite(x).all()):
                    self.bad.append(getattr(func, "__name__", str(func)))
        return out


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def frame_case():
    """K3's arguments in the port's clustered 128x128 rig frame (CPU)."""
    sc, bridge = build_rig(PORT_PKG)
    cfg = FrameConfig(**BASE, enable_clustered=True)
    calls = []
    real = pl.tiled_shade

    def capture(*a):
        calls.append(a)
        return real(*a)

    pl.tiled_shade = capture
    try:
        build_frame_fn(cfg)(bridge.build_scene_buffers(device="cpu"),
                            make_view(*sc.camera_matrices(aspect=1.0),
                                      device="cpu"),
                            FrameParams.default("cpu"))
    finally:
        pl.tiled_shade = real
    assert len(calls) == 1
    return calls[0], JConfig(**BASE, enable_clustered=True)


def built_case():
    """Sky and pad pixels among valid ones under point and spot lights."""
    rng = np.random.default_rng(7)
    cfg = FrameConfig(**BUILT)
    H, W = cfg.padded_height, cfg.padded_width
    n = rng.normal(size=(3, H, W))
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    valid = (rng.uniform(0, 1, (H, W)) > 0.15).astype(np.float32)
    valid[0:3, :] = 0.0                 # whole invalid warps (sky rows)
    valid[3:6, ::2] = 0.0               # every other lane of these warps
    valid[20:24, 200:232] = 0.0         # one whole warp inside a tile
    shade_in = np.concatenate([
        n, rng.uniform(0, 1, (3, H, W)), rng.uniform(0, 1, (1, H, W)),
        rng.uniform(0.05, 1, (1, H, W)), rng.uniform(-2, 2, (3, H, W)),
        valid[None]]).astype(np.float32)
    shade_in[:, cfg.height:] = 0.0      # pad rows: zeros, as the frame pads
    nt, mx = cfg.num_tiles, cfg.max_lights_per_cluster
    lights = np.zeros((nt, mx, 16), np.float32)
    lights[..., 0:3] = rng.uniform(-2.5, 2.5, (nt, mx, 3))
    lights[..., 3] = np.where(np.arange(mx) % 2 == 0, 1.0, 2.0)  # point, spot
    d = rng.normal(size=(nt, mx, 3))
    lights[..., 4:7] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    lights[..., 7] = rng.uniform(1, 10, (nt, mx))
    lights[..., 8:11] = rng.uniform(0.2, 1, (nt, mx, 3))
    lights[0, 1, 9] = -0.5              # a negative channel: -0.0 terms
    lights[..., 11] = rng.uniform(2, 6, (nt, mx))
    lights[..., 12] = np.cos(0.3)
    lights[..., 13] = np.cos(0.9)
    counts = rng.integers(3, mx + 1, nt).astype(np.int32)
    counts[0] = mx
    counts[5] = 0                       # a tile with no lights
    for t in range(nt):                 # dead slots: intensity 0 (the cull)
        lights[t, counts[t]:, 7] = 0.0
    args = (torch.as_tensor(shade_in), torch.as_tensor(lights),
            torch.as_tensor(counts), torch.tensor([3.0, 2.0, 4.0]), cfg)
    return args, JConfig(**BUILT)


CASES = {"frame": frame_case, "built": built_case}


@pytest.fixture(scope="module")
def cases():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = CASES[name]()
        return cache[name]
    return get


def _warp_view(x, cfg):
    """(tiles, warps, 32) of a (H', W') plane, in the kernel's lane order
    (tiles here have a multiple of 32 pixels)."""
    th, tw = cfg.tile_h, cfg.tile_w
    return x.reshape(cfg.tiles_y, th, cfg.tiles_x, tw).permute(
        0, 2, 1, 3).reshape(cfg.num_tiles, -1, WARP)


def _bits(x):
    return x.contiguous().view(torch.int32)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_invalid_pixels_shade_to_positive_zero(cases, case):
    """The skip's premise: at every valid == 0 pixel the plain version and
    the Pallas kernel (interpret mode) give +0.0 in all three channels, and
    no intermediate of the plain walk is infinite or NaN. The case holds
    such pixels in warps with valid pixels, in tiles with live point and
    spot lights."""
    args, jc = cases(case)
    shade_in, payload, counts, cam, cfg = args
    valid = shade_in[11]
    inv = valid == 0
    wv = _warp_view(valid, cfg)
    partial = ((wv == 0) & (wv != 0).any(-1, keepdim=True)).any(-1)
    tile_of = torch.arange(cfg.num_tiles)[:, None].expand_as(partial)
    lit = tile_of[partial]
    kinds = {float(v) for t in lit.unique().tolist()
             for v in payload[t, :int(counts[t]), 3]}
    assert int(partial.sum()) > 0 and kinds >= {1.0, 2.0}, (partial.sum(),
                                                            kinds)
    with FiniteIntermediates() as mode:
        p = pl.tiled_shade_plain(*args)
    assert mode.seen > 100 and not mode.bad, mode.bad[:5]
    j = torch.as_tensor(np.array(jl.tiled_shade_pallas(
        jnp.asarray(shade_in.numpy()), jnp.asarray(payload.numpy()),
        jnp.asarray(counts.numpy()), jnp.asarray(cam.numpy()), jc,
        interpret=True)))
    for out in (p, j):
        assert bool(torch.isfinite(out).all())
        assert int((_bits(out)[:, inv] != 0).sum()) == 0
    assert float(p[:, ~inv].abs().max()) > 0.01


@pytest.mark.parametrize("case", list(CASES))
def test_card_schedule_matches_plain(cases, case):
    """The card's schedule (one pixel a thread, 32-pixel warps that skip
    when no lane is valid) equals the plain walk bit for bit, and it does
    skip warps."""
    args, _ = cases(case)
    cfg = args[-1]
    got = k3_schedule(*args)
    want = pl.tiled_shade_plain(*args)
    assert torch.equal(_bits(got), _bits(want))
    wv = _warp_view(args[0][11], cfg)
    assert int((~any_valid(wv)).sum()) > 0


@pytest.mark.parametrize("case", list(CASES))
def test_skipping_partly_valid_warps_is_caught(cases, case):
    """The mutation that skips a warp unless every lane is valid drops
    light from valid pixels: the emulation then differs from the plain
    walk."""
    args, _ = cases(case)
    got = k3_schedule(*args, walks=all_valid)
    want = pl.tiled_shade_plain(*args)
    assert int((_bits(got) != _bits(want)).sum()) > 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the tiled shade kernel is CUDA "
                    "C++ and has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_tiled_shade_matches_plain_with_skips(cuda_device, cases, case):
    """The kernel on both inputs vs the plain version (on the card): within
    rtol 1e-3 / atol 1e-4, and +0.0 exactly at every valid == 0 pixel."""
    args, _ = cases(case)
    args = tuple(x.to(cuda_device) if isinstance(x, torch.Tensor) else x
                 for x in args)
    before = pl.tiled_shade_cuda.launches
    k = pl.tiled_shade(*args)
    torch.cuda.synchronize()
    assert pl.tiled_shade_cuda.launches == before + 1
    torch.testing.assert_close(k, pl.tiled_shade_plain(*args), rtol=1e-3,
                               atol=1e-4)
    inv = args[0][11] == 0
    assert int((_bits(k)[:, inv] != 0).sum()) == 0
