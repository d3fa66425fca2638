"""The schedule of the CUDA history warp K5 (csrc/taa_warp.cu), emulated
in plain PyTorch on the CPU and held to its plain version and the JAX
package's references.

On the card a block takes a band of up to 16 rows of one tile. All rows
of a tile share one (dy, dx), so the band's source is a window of R + 1
rows by tile_w + 1 columns, clamped to the image once at staging. Each
window float is blended vertically once (v = h[i] * gy + h[i + 1] * fy,
each step rounded to f32), and output float e of a band row is
v[e] * gx + v[e + C] * fx, written 4 floats at a time (for C = 3 from
two float4 reads of the staged row) where the row's start in the image
is a multiple of 4 floats, with the rest of the row stored as scalars.
`split_warp` below does the same, store by store, and must equal
`warp_history_plain` bit for bit: at every image edge, with shifts past
and on the clip limits and with negative fractions, for C = 3, 4 and 5,
with bands cut short by the tile's height and with rows that take the
scalar path. Blending x before y must fail.

JAX references: `warp_history_ref` and the Pallas kernel in interpret mode
(`warp_history_tiles(interpret=True)`) at tests/test_torch_motion.py's
64x256 with 32x128 tiles, within its 1e-5.

The CUDA kernel itself runs only on a card
(tests/test_torch_motion.py::test_cuda_warp_matches_plain).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basicrenderer_tpu.ops import taa_warp as jwarp
from basicrenderer_tpu_torch.ops import taa_warp as pwarp

BAND = 16                  # csrc/taa_warp.cu kBand: output rows a block
MAX_SHARED = 48 * 1024     # kMaxShared: bytes of staged rows a block


# ---------------------------------------------------------------------------
# The schedule, emulated
# ---------------------------------------------------------------------------

def band_rows(tile_h, tile_w, C):
    """br_taa_warp's band height and shared row stride (floats)."""
    stride = ((tile_w + 1) * C + 3) // 4 * 4
    rows = min(tile_h, BAND)
    while rows > 1 and (rows * stride + 4) * 4 > MAX_SHARED:
        rows -= 1
    return rows, stride


def split_warp(hist, tile_dy, tile_dx, tile_h, tile_w, x_first=False,
               aligned16=True):
    """K5's blocks, emulated: (H, W, C). `x_first` blends the window's
    columns before its rows (a mutation that must fail)."""
    H, W, C = hist.shape
    tiles_x = W // tile_w
    R, stride = band_rows(tile_h, tile_w, C)
    bands = -(-tile_h // R)
    flat = hist.reshape(-1)
    out = torch.full((H * W * C,), float("nan"))
    dy, dx = pwarp._clipped(tile_dy, tile_dx)
    for tile in range(len(tile_dy)):
        ty, tx = divmod(tile, tiles_x)
        y0f, x0f = torch.floor(dy[tile]), torch.floor(dx[tile])
        fy, fx = dy[tile] - y0f, dx[tile] - x0f
        gy, gx = 1.0 - fy, 1.0 - fx
        y0, x0 = int(y0f), int(x0f)
        col_base = tx * tile_w
        cstart = col_base + x0
        run = (tile_w + 1) * C
        e = torch.arange(run)
        if cstart >= 0 and cstart + tile_w <= W - 1:
            col_off = cstart * C + e
        else:
            col_off = (cstart + e // C).clamp(0, W - 1) * C + e % C
        for band in range(bands):
            row0 = ty * tile_h + band * R
            rows = min(R, tile_h - band * R)
            src = (torch.arange(rows + 1) + row0 + y0).clamp(0, H - 1)
            h = flat[src[:, None] * (W * C) + col_off[None, :]]
            if x_first:
                hx = h[:, :-C] * gx + h[:, C:] * fx
                v = torch.zeros((rows, stride + 4))
                v[:, :run - C] = hx[:-1] * gy + hx[1:] * fy
                vals = v[:, :tile_w * C]
            else:
                v = torch.zeros((rows, stride + 4))
                v[:, :run] = h[:-1] * gy + h[1:] * fy
                vals = None
            out_run = tile_w * C
            vec = (aligned16 and (W * C) % 4 == 0
                   and (col_base * C) % 4 == 0)
            nvec = out_run // 4 if vec else 0
            tail = out_run - 4 * nvec
            base = (torch.arange(rows) + row0) * (W * C) + col_base * C
            # One float4 a store: q -> (band row k, first float e4).
            q = torch.arange(rows * nvec)
            k, e4 = q // max(nvec, 1), 4 * (q % max(nvec, 1))
            lane = torch.arange(4)
            if vals is not None:
                r = vals[k[:, None], e4[:, None] + lane]
            elif C == 3:    # (a.x, a.w) (a.y, b.x) (a.z, b.y) (a.w, b.z)
                a = v[k[:, None], e4[:, None] + lane]
                b = v[k[:, None], e4[:, None] + 4 + lane]
                nxt = torch.stack([a[:, 3], b[:, 0], b[:, 1], b[:, 2]], 1)
                r = a * gx + nxt * fx
            else:
                r = (v[k[:, None], e4[:, None] + lane] * gx
                     + v[k[:, None], e4[:, None] + C + lane] * fx)
            out[(base[k] + e4)[:, None] + lane] = r
            # The scalar rest of each row.
            q = torch.arange(rows * tail)
            k, ee = q // max(tail, 1), 4 * nvec + q % max(tail, 1)
            out[base[k] + ee] = (vals[k, ee] if vals is not None else
                                 v[k, ee] * gx + v[k, ee + C] * fx)
    return out.reshape(H, W, C)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def warp_case(seed, H, W, C, tile_h, tile_w):
    """Random history and per-tile shifts: uniform over +-80 rows and
    +-220 columns (past the clip limits); the corner tiles pushed out
    over their two image edges; tiles exactly on the limits and on
    negative fractions."""
    rng = np.random.default_rng(seed)
    ty, tx = H // tile_h, W // tile_w
    dy = rng.uniform(-80, 80, (ty, tx)).astype(np.float32)
    dx = rng.uniform(-220, 220, (ty, tx)).astype(np.float32)
    dy[0, 0], dx[0, 0] = -5.5, -7.25          # over the top and left edges
    dy[0, -1], dx[0, -1] = -70.0, 190.0       # top, right; on the limits
    dy[-1, 0], dx[-1, 0] = 69.5, -0.75        # bottom, left
    dy[-1, -1], dx[-1, -1] = 95.3, 250.7      # bottom, right; past them
    if ty > 2 and tx > 2:                     # an interior tile
        dy[1, 1], dx[1, 1] = -0.25, -189.25
    hist = rng.random((H, W, C)).astype(np.float32) * 4.0
    return (torch.as_tensor(hist), torch.as_tensor(dy.reshape(-1)),
            torch.as_tensor(dx.reshape(-1)), tile_h, tile_w)


CASES = {
    # (H, W, C, tile_h, tile_w)
    "64x256 C3": (64, 256, 3, 32, 128),
    "64x256 C4": (64, 256, 4, 32, 128),
    "96x384 C3": (96, 384, 3, 32, 128),
    "short band 80x256 C3": (80, 256, 3, 40, 128),
    "scalar rows 24x30 C3": (24, 30, 3, 8, 10),
    "scalar rows 24x30 C5": (24, 30, 5, 8, 10),
    "float4 rows with a tail 24x40 C3": (24, 40, 3, 8, 10),
    "16-row tiles 64x256 C4": (64, 256, 4, 16, 128),
}


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_split_matches_plain(case):
    args = warp_case(list(CASES).index(case), *CASES[case])
    assert torch.equal(split_warp(*args), pwarp.warp_history_plain(*args))


def test_split_on_unaligned_output_takes_scalars():
    """An output the kernel is not given 16-byte aligned: every store is
    a scalar, the values the same."""
    args = warp_case(5, *CASES["64x256 C3"])
    assert torch.equal(split_warp(*args, aligned16=False),
                       pwarp.warp_history_plain(*args))


@pytest.mark.parametrize("C", [3, 4])
def test_split_matches_jax(C):
    """At the JAX tests' size: the split schedule against warp_history_ref
    and the Pallas kernel in interpret mode."""
    hist, dy, dx, th, tw = warp_case(7 + C, 64, 256, C, 32, 128)
    got = split_warp(hist, dy, dx, th, tw).numpy()
    j = (jnp.asarray(hist.numpy()), jnp.asarray(dy.numpy()),
         jnp.asarray(dx.numpy()), th, tw)
    ref = np.asarray(jwarp.warp_history_ref(*j))
    kern = np.asarray(jwarp.warp_history_tiles(*j, interpret=True))
    assert np.abs(got - ref).max() < 1e-5
    assert np.abs(got - kern).max() < 1e-5


def test_x_before_y_fails():
    """Blending each window row across x first, then down y, rounds
    differently: the mutation differs from the plain version."""
    args = warp_case(9, *CASES["64x256 C3"])
    plain = pwarp.warp_history_plain(*args)
    assert torch.equal(split_warp(*args), plain)
    assert not torch.equal(split_warp(*args, x_first=True), plain)
