"""Block-window texture sampling from the strip atlas: the CUDA kernel
(csrc/tex_block.cu) and its plain PyTorch version; normal mapping.

Port of basicrenderer_tpu/ops/textures.py (`mip_layout`, `layer_words`,
`strip_layout`, `strip_layout_bc`, `infer_strip_resolution`,
`compute_mip`, `_min_abs_grad`, `_blockify`, `_unblockify`,
`sample_pyramid_blocked`, `sample_pyramid_blocked_planes`,
`bc3_decode_rows`, `_ddx`, `_ddy`, `apply_normal_map_sampled`,
`wanted_mips` and the Pallas `_tex_block_kernel`, RGBA8 and BC3 windows).

Pixels are sampled in 16x16 screen blocks. Each block makes one sampling
JOB per (channel, layer rank) -- rank 0 = the block's dominant layer, plus
a runner-up job for the first channel -- and each job picks one mip and
one window of 24 atlas rows x 128 texels (models/textures.strip_pyramid
stores every mip row as 128-texel strips at 64-texel x phases, so a
window is 24 gathered rows). With the BC3 atlas a window is 7 gathered
block rows that decode to 28 texel rows. Per pixel, the job's bilinear
taps are read from that window: `tex_block_eval` is the kernel's entry
point.

`tex_block_eval` picks the implementation by the device of its inputs:
CUDA tensors launch the kernel (or raise), CPU tensors run the plain
version. Both compute the TPU kernel's hat-function identity at the two
lanes and two rows where it is nonzero: x weights max(0, 1-|l-x|) +
max(0, 1-|l-x+128|) (the second term is the lane-127 -> 0 wrap) rounded
to bf16, y weights in f32, byte channels as exact small integers, and
the same two-term f32 sums, so the result is the TPU kernel's to the ulp.
In BC3 mode the kernel decodes each tap's texel from the window's block
words in shared memory; the plain version runs `bc3_decode_rows` first,
as the reference does. An optional `live` mask (JN, P) makes the result
0 at dead pixels (the sampler passes its job masks, so that the kernel
skips the jobs a frame masks away; it zeroes those pixels anyway).

Not ported: the per-pixel `sample_pyramid` reference (no frame calls
it).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from ..utils import cuda_build

MIN_MIP = 4           # coarsest mip edge in texels
BLOCK = 16            # pixel block edge
WROWS = 24            # window rows (y texels)
BC_WROWS = 7          # BC3 window: gathered block rows ...
BC_TEXEL_ROWS = 28    # ... and the texel rows they decode to
FIT_TEXELS = 20.0     # max block footprint per axis before a mip bump
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "tex_block.cu"


@functools.lru_cache(maxsize=None)
def mip_layout(resolution: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Static (sizes, offsets) of the flat per-layer mip chain."""
    sizes, offsets = [], []
    off, r = 0, resolution
    while r >= MIN_MIP:
        sizes.append(r)
        offsets.append(off)
        off += r * r
        r //= 2
    return tuple(sizes), tuple(offsets)


def layer_words(resolution: int) -> int:
    """Flat u32 words per layer of the mip chain."""
    sizes, offsets = mip_layout(resolution)
    return offsets[-1] + sizes[-1] * sizes[-1]


@functools.lru_cache(maxsize=None)
def strip_layout(resolution: int) -> Tuple[Tuple[int, ...], int]:
    """(row offset of each mip, rows per layer) in the strip atlas."""
    sizes, _ = mip_layout(resolution)
    offs, off = [], 0
    for sz in sizes:
        offs.append(off)
        off += sz if sz <= 128 else (sz // 64 - 1) * sz
    return tuple(offs), off


@functools.lru_cache(maxsize=None)
def strip_layout_bc(resolution: int) -> Tuple[Tuple[int, ...], int]:
    """(row offset of each mip, rows per layer) in the BC3 strip atlas:
    rows are BLOCK rows (one row = 32 BC3 blocks = 128 texels x 4 texel
    rows, interleaved [a_lo, a_hi, c_ends, c_idx] per block). Mips below
    4 texels wrap-fill one block row."""
    sizes, _ = mip_layout(resolution)
    offs, off = [], 0
    for sz in sizes:
        offs.append(off)
        nbr = max(sz // 4, 1)
        off += nbr if sz <= 128 else (sz // 64 - 1) * nbr
    return tuple(offs), off


@functools.lru_cache(maxsize=None)
def infer_strip_resolution(rows_per_layer: int, fmt: str = "rgba8") -> int:
    """Atlas resolution from its rows per layer, for either format."""
    if fmt not in ("rgba8", "bc3"):
        raise ValueError(f"unknown texture atlas format {fmt!r}")
    layout = strip_layout_bc if fmt == "bc3" else strip_layout
    r = MIN_MIP
    while r <= 1 << 16:
        if layout(r)[1] == rows_per_layer:
            return r
        r *= 2
    raise ValueError(f"no {fmt} strip layout has {rows_per_layer} rows")


def _u32(x: torch.Tensor) -> torch.Tensor:
    """i32 words holding u32 bits -> the same unsigned values in i64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def _i32_bits(x: torch.Tensor) -> torch.Tensor:
    """u32 values in i64 -> i32 words with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def bc3_decode_rows(win: torch.Tensor) -> torch.Tensor:
    """(B, R, 128) i32 BC3 block rows (u32 bits) -> (B, R*4, 128) i32
    RGBA8-packed texel rows. Lane math only: a block's 4 texel lanes read
    its 4 words, and the texel index within the block is static per lane
    and row. Matches models/texprocess.bc3_decode on the blocks its
    encoder writes (4-colour BC1, 8-step BC4 alpha).

    Rounding: the palette lerps are f32 products and sums rounded to a
    byte half to even, as the reference writes them. Over every 565
    endpoint pair and every alpha endpoint pair, the separate form and
    both fused multiply-add contractions round to the same byte (no lerp
    lands within an ulp of a .5 tie), so the reference's compiled form
    cannot change a decoded texel."""
    B, R, _ = win.shape
    dev = win.device
    w = _u32(win).reshape(B, R, 32, 4)

    def rep(x):   # one value per block -> its 4 texel lanes
        return x.repeat_interleave(4, dim=-1)             # (B, R, 128)

    a_lo, a_hi, c_end, c_idx = (rep(w[..., i]) for i in range(4))
    f32 = torch.float32
    a0 = (a_lo & 0xFF).to(f32)
    a1 = ((a_lo >> 8) & 0xFF).to(f32)
    low = (a_lo >> 16) | ((a_hi & 0xFFFF) << 16)       # alpha idx bits 0-31
    hi16 = a_hi >> 16                                  # alpha idx bits 32-47
    q0, q1 = c_end & 0xFFFF, c_end >> 16
    # RGB565 bit-replicating expand (texprocess._dequant565).
    r0 = ((q0 >> 11) & 31).to(f32) * (255.0 / 31.0)
    g0 = ((q0 >> 5) & 63).to(f32) * (255.0 / 63.0)
    b0 = (q0 & 31).to(f32) * (255.0 / 31.0)
    r1 = ((q1 >> 11) & 31).to(f32) * (255.0 / 31.0)
    g1 = ((q1 >> 5) & 63).to(f32) * (255.0 / 63.0)
    b1 = (q1 & 31).to(f32) * (255.0 / 31.0)
    sx = torch.arange(128, device=dev) % 4             # (128,) static

    def q8(x):
        return torch.clamp(torch.round(x), 0, 255).to(torch.int64)

    rows = []
    for yy in range(4):
        t = 4 * yy + sx
        ci = (c_idx >> (2 * t)) & 3
        # 4-colour palette weight of c0: [1, 0, 2/3, 1/3][ci].
        w0 = torch.where(ci == 0, 1.0, torch.where(
            ci == 1, 0.0, torch.where(ci == 2, 2.0 / 3.0, 1.0 / 3.0))).to(f32)
        rr = q8(r0 * w0 + r1 * (1.0 - w0))
        gg = q8(g0 * w0 + g1 * (1.0 - w0))
        bb = q8(b0 * w0 + b1 * (1.0 - w0))
        bp = 3 * t                                     # static, 0..45
        ai = torch.where(
            bp <= 29, (low >> torch.clamp(bp, max=29)) & 7,
            torch.where(bp == 30, ((low >> 30) & 3) | ((hi16 & 1) << 2),
                        (hi16 >> torch.clamp(bp - 32, min=0)) & 7)).to(f32)
        # 8-step palette: [a0, a1, lerp (8-k)/7 for k >= 2].
        aa = q8(torch.where(ai == 0.0, a0, torch.where(
            ai == 1.0, a1, (a0 * (8.0 - ai) + a1 * (ai - 1.0)) * (1.0 / 7.0))))
        rows.append(rr | (gg << 8) | (bb << 16) | (aa << 24))
    return _i32_bits(torch.stack(rows, dim=2).reshape(B, R * 4, 128))


def _min_abs_grad(img: torch.Tensor, dim: int) -> torch.Tensor:
    """Per-pixel min(|forward diff|, |backward diff|) along an image axis
    (edge pixels repeat themselves): a seam-robust ddx/ddy."""
    n = img.shape[dim]
    fwd = torch.abs(torch.diff(img, dim=dim, append=img.narrow(dim, n - 1, 1)))
    bwd = torch.abs(torch.diff(img, dim=dim, prepend=img.narrow(dim, 0, 1)))
    return torch.minimum(fwd, bwd)


def compute_mip(uv: torch.Tensor, resolution: int, num_mips: int
                ) -> torch.Tensor:
    """(H, W, 2) uv -> (H, W) f32 mip level in [0, num_mips-1]."""
    dudx = _min_abs_grad(uv[..., 0], 1)
    dudy = _min_abs_grad(uv[..., 0], 0)
    dvdx = _min_abs_grad(uv[..., 1], 1)
    dvdy = _min_abs_grad(uv[..., 1], 0)
    rho = torch.sqrt(torch.maximum(dudx * dudx + dvdx * dvdx,
                                   dudy * dudy + dvdy * dvdy)) * resolution
    mip = torch.log2(torch.clamp(rho, min=1e-6))
    return torch.clamp(mip, 0.0, num_mips - 1.0)


def _blockify(img: torch.Tensor) -> torch.Tensor:
    """(h, w, ...) -> (nb, BLOCK*BLOCK, ...)."""
    h, w = img.shape[:2]
    hb, wb = h // BLOCK, w // BLOCK
    x = img.reshape((hb, BLOCK, wb, BLOCK) + tuple(img.shape[2:]))
    x = x.transpose(1, 2)
    return x.reshape((hb * wb, BLOCK * BLOCK) + tuple(img.shape[2:]))


def _unblockify(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    hb, wb = h // BLOCK, w // BLOCK
    x = blocks.reshape((hb, wb, BLOCK, BLOCK) + tuple(blocks.shape[2:]))
    x = x.transpose(1, 2)
    return x.reshape((h, w) + tuple(blocks.shape[2:]))


def _pad_edge(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Pad the two leading dims by repeating the last row / column."""
    h, w = x.shape[:2]
    rows = torch.clamp(torch.arange(h + ph, device=x.device), max=h - 1)
    cols = torch.clamp(torch.arange(w + pw, device=x.device), max=w - 1)
    return x[rows][:, cols]


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int,
                    row_dim: int = 0) -> torch.Tensor:
    """Bilinear resize of dims (row_dim, row_dim + 1) with the semantics of
    jax.image.resize(..., "bilinear") when upscaling: half-pixel centres,
    triangle weights, taps outside the image dropped and the remaining
    weights renormalised. Rows are resampled first, then columns, as
    jax.image.resize does."""
    for dim, n_out in ((row_dim, out_h), (row_dim + 1, out_w)):
        n_in = img.shape[dim]
        if n_in == n_out:
            continue
        if n_out < n_in:
            raise ValueError("resize_bilinear only upscales")
        dev = img.device
        inv_scale = n_in / n_out
        s = (torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5) \
            * inv_scale - 0.5
        i0 = torch.floor(s).to(torch.int64)
        i1 = i0 + 1
        w0 = torch.clamp(1.0 - torch.abs(s - i0.to(torch.float32)), min=0.0)
        w1 = torch.clamp(1.0 - torch.abs(s - i1.to(torch.float32)), min=0.0)
        w0 = torch.where((i0 >= 0) & (i0 < n_in), w0, 0.0)
        w1 = torch.where((i1 >= 0) & (i1 < n_in), w1, 0.0)
        tot = w0 + w1
        w0, w1 = w0 / tot, w1 / tot
        shape = [1] * img.dim()
        shape[dim] = n_out
        a = img.index_select(dim, torch.clamp(i0, 0, n_in - 1))
        b = img.index_select(dim, torch.clamp(i1, 0, n_in - 1))
        img = a * w0.view(shape) + b * w1.view(shape)
    return img


def sample_pyramid_blocked(strips: torch.Tensor, tex_flags: torch.Tensor,
                           tex_ids: torch.Tensor, uv: torch.Tensor,
                           downscale: int = 1, filter: str = "bilinear",
                           fmt: str = "rgba8",
                           mipf: torch.Tensor = None) -> torch.Tensor:
    """Sample K channel layers sharing one UV image at full resolution
    (downscale 1) or at every downscale-th pixel, bilinearly upsampled.

    strips (N * rows_per_layer, 128) i32 atlas words; tex_flags (N,) i32;
    tex_ids (K, H, W) i32 (-1 = none -> white); uv (H, W, 2); `mipf`
    overrides the mip estimate of the sampled pixels. Returns (K, H, W,
    4) f32 linear."""
    ds = downscale
    st = uv[::ds, ::ds]
    tids = tex_ids[:, ::ds, ::ds]
    return sample_pyramid_blocked_planes(
        strips, tex_flags, tids, st[..., 0], st[..., 1], uv.shape[0],
        uv.shape[1], ds, filter, mipf=mipf, fmt=fmt)


def sample_pyramid_blocked_planes(strips: torch.Tensor, tex_flags: torch.Tensor,
                                  tids: torch.Tensor, u_ds: torch.Tensor,
                                  v_ds: torch.Tensor, H: int, W: int,
                                  ds: int = 1, filter: str = "bilinear",
                                  upsample: bool = True,
                                  mipf: torch.Tensor = None,
                                  fmt: str = "rgba8") -> torch.Tensor:
    """Sample K channel layers sharing one UV image.

    strips (N * rows_per_layer, 128) i32 atlas words (RGBA8 texels, or
    BC3 block rows with fmt="bc3"); tex_flags (N,) i32;
    tids (K, h, w) i32 (-1 = none -> white); u_ds / v_ds (h, w) at the
    sampling rate (h = H // ds). Returns (K, H, W, 4) f32 linear, or the
    sampling-rate image (K, h, w, 4) with `upsample=False`. `mipf` (h, w)
    overrides the per-pixel mip estimate.

    Blocks straddling UV wrap seams or with oversized footprints sample a
    coarser mip (blur, never wrong memory); the first channel blends two
    layers per block, the others one."""
    K = tids.shape[0]
    N = tex_flags.shape[0]
    bc = fmt == "bc3"
    R = infer_strip_resolution(strips.shape[0] // N, fmt)
    sizes, _ = mip_layout(R)
    M = len(sizes)
    row_offs, RPL = strip_layout_bc(R) if bc else strip_layout(R)
    # BC3: gather 7 block rows per window (28 texel rows after decode);
    # RGBA8: 24 texel rows directly.
    WR_G = BC_WROWS if bc else WROWS
    WR = BC_TEXEL_ROWS if bc else WROWS
    dev = u_ds.device
    i32 = torch.int32
    h, w = u_ds.shape
    ph, pw = (-h) % BLOCK, (-w) % BLOCK

    st = torch.stack([u_ds, v_ds], dim=-1)
    if mipf is None:
        mipf = compute_mip(st, R, M)
    if ph or pw:
        st = _pad_edge(st, ph, pw)
        mipf = _pad_edge(mipf, ph, pw)
        tids = torch.nn.functional.pad(tids, (0, pw, 0, ph), value=-1)
    hp, wp = h + ph, w + pw

    u = st[..., 0] - torch.floor(st[..., 0])
    v = st[..., 1] - torch.floor(st[..., 1])
    ub, vb = _blockify(u), _blockify(v)                    # (nb, P)
    mb_px = _blockify(torch.round(mipf).to(i32))
    tb = torch.stack([_blockify(tids[k]) for k in range(K)])   # (K, nb, P)
    nb, P = ub.shape

    # Jobs: (channel, layer rank); rank 1 only for the first channel.
    btid = tb.amax(dim=2)
    btid2 = torch.where(tb == btid[:, :, None], -1, tb).amax(dim=2)
    mask = (tb == btid[:, :, None]) & (tb >= 0)
    mask2 = (tb == btid2[:, :, None]) & (tb >= 0)
    jtid = torch.cat([btid, btid2[:1]], 0)                 # (J, nb)
    jmask = torch.cat([mask, mask2[:1]], 0)                # (J, nb, P)
    layer_j = torch.clamp(jtid, 0, N - 1)
    inf = float("inf")

    def jmin(x):
        return torch.where(jmask, x[None], inf).amin(dim=2)

    def jmax(x):
        return torch.where(jmask, x[None], -inf).amax(dim=2)

    any_live = jmask.any(dim=2)
    ext = torch.where(any_live, torch.maximum(jmax(ub) - jmin(ub),
                                              jmax(vb) - jmin(vb)), 0.0)
    m_fit = torch.ceil(torch.log2(torch.clamp(ext * R / FIT_TEXELS,
                                              min=1e-6)))
    # Block mip: the mean of the job's pixel mips, rounded up.
    cnt = torch.clamp(jmask.sum(dim=2), min=1).to(i32)
    m0 = torch.ceil(torch.where(jmask, mb_px[None], 0).sum(dim=2).to(i32)
                    / cnt).to(i32)
    fl_j = tex_flags[layer_j.long()]
    m0 = torch.maximum(m0, (fl_j >> 1) & 31)     # streaming min-mip clamp
    mb = torch.clamp(torch.maximum(m0, m_fit.to(i32)), 0, M - 1)

    rm = torch.zeros_like(mb)
    rm_b = torch.zeros_like(mb)                  # bc3: block rows per mip
    off = torch.zeros_like(mb)
    for m, sz in enumerate(sizes):
        rm = torch.where(mb == m, sz, rm)
        rm_b = torch.where(mb == m, max(sz // 4, 1), rm_b)
        off = torch.where(mb == m, row_offs[m], off)
    rf = rm.to(torch.float32)
    wide = rm > 128                                       # phase-strip regime

    txf = ub[None] * rf[:, :, None] - 0.5                 # (J, nb, P)
    tyf = vb[None] * rf[:, :, None] - 0.5
    txmin = torch.where(any_live, torch.where(jmask, txf, inf).amin(dim=2),
                        0.0)
    tymin = torch.where(any_live, torch.where(jmask, tyf, inf).amin(dim=2),
                        0.0)
    xb = torch.div(torch.floor(txmin).to(i32), 64, rounding_mode="floor") * 64
    xb = torch.minimum(torch.clamp(xb, min=0), torch.clamp(rm - 128, min=0))
    xb = torch.where(wide, xb, 0)
    y0 = torch.floor(tymin).to(i32)

    # Window rows (J, nb, WR_G) in each job's layer. BC3 rows are block
    # rows: the window starts at the block row holding y0, wraps at the
    # mip's block-row count and decodes to 4 texel rows each (mip heights
    # are multiples of 4; tiny mips wrap-fill their one block).
    jrow = torch.arange(WR_G, dtype=i32, device=dev)[None, None, :]
    xph = torch.div(xb, 64, rounding_mode="floor")
    if bc:
        y0b = torch.div(y0, 4, rounding_mode="floor")
        yrow = torch.remainder(y0b[:, :, None] + jrow, rm_b[:, :, None])
        phase_rows = torch.where(wide, xph * rm_b, 0)
        y0_win = y0b * 4                                  # first texel row
    else:
        yrow = torch.remainder(y0[:, :, None] + jrow, rm[:, :, None])
        phase_rows = torch.where(wide, xph * rm, 0)
        y0_win = y0
    rows_k = (layer_j[:, :, None] * RPL + off[:, :, None]
              + phase_rows[:, :, None] + yrow)            # (J, nb, WR_G)

    ix0f = torch.floor(txf)
    fx = txf - ix0f
    ix0 = ix0f.to(i32)
    ix0 = torch.where(wide[:, :, None],
                      torch.clamp(ix0 - xb[:, :, None], 0, 126),
                      torch.remainder(ix0, 128))
    ix1 = torch.where(wide[:, :, None], ix0 + 1, torch.remainder(ix0 + 1, 128))
    iy0f = torch.floor(tyf)
    fy = tyf - iy0f
    wy0 = torch.clamp(iy0f.to(i32) - y0_win[:, :, None], 0, WR - 2)
    if filter == "nearest":
        ix0 = torch.where(fx > 0.5, ix1, ix0)
        fx = torch.zeros_like(fx)
        wy0 = torch.clamp(wy0 + (fy > 0.5).to(i32), 0, WR - 1)
        fy = torch.zeros_like(fy)
    elif filter != "bilinear":
        raise ValueError(f"unknown texture filter {filter!r}")
    x_hat = ix0.to(torch.float32) + fx
    yf = wy0.to(torch.float32) + fy

    J = K + 1
    out = tex_block_eval(strips, rows_k.reshape(J * nb, WR_G).contiguous(),
                         x_hat.reshape(J * nb, P).contiguous(),
                         yf.reshape(J * nb, P).contiguous(), fmt=fmt,
                         live=jmask.reshape(J * nb, P).contiguous())
    out = out.reshape(J, nb, P, 4) / 255.0

    srgb = (fl_j & 1) > 0
    dec = torch.where(out <= 0.04045, out / 12.92,
                      torch.pow(torch.clamp((out + 0.055) / 1.055, min=1e-6),
                                2.4))
    out = torch.where(srgb[:, :, None, None],
                      torch.cat([dec[..., :3], out[..., 3:]], -1), out)
    out = torch.where(jmask[..., None], out, 0.0)
    # Channel 0 merges its two disjoint-masked jobs; the rest keep rank 0.
    sel = torch.cat([out[:1] + out[K:K + 1], out[1:K]], 0)
    covered = torch.cat([mask[:1] | mask2[:1], mask[1:]], 0)[..., None]
    out = torch.where(covered, sel, 1.0).permute(1, 2, 0, 3)  # (nb, P, K, 4)
    img = _unblockify(out, hp, wp)[:h, :w].permute(2, 0, 1, 3)
    if ds > 1 and upsample:
        img = resize_bilinear(img, H, W, row_dim=1)
    return img


# ---------------------------------------------------------------------------
# Normal mapping (derivative tangent frame)
# ---------------------------------------------------------------------------

def _ddx(img: torch.Tensor) -> torch.Tensor:
    """Forward difference along columns; the last column is 0."""
    return torch.cat([img[:, 1:] - img[:, :-1], img[:, -1:] * 0], dim=1)


def _ddy(img: torch.Tensor) -> torch.Tensor:
    """Forward difference along rows; the last row is 0."""
    return torch.cat([img[1:] - img[:-1], img[-1:] * 0], dim=0)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


def apply_normal_map_sampled(normal: torch.Tensor, world_pos: torch.Tensor,
                             uv: torch.Tensor, smp: torch.Tensor,
                             normal_tex: torch.Tensor, normal_scale=1.0,
                             frame=None) -> torch.Tensor:
    """Perturb G-buffer normals (H, W, 3) with an already-sampled
    tangent-space normal map `smp` (H, W, 4).

    The tangent frame comes from screen-space forward differences of world
    position and UV (`_ddx` / `_ddy`, which zero the last column / row --
    not the seam-robust `_min_abs_grad` of the mip estimate), Gram-Schmidt
    against the interpolated normal. `frame` = (T, B) supplies an explicit
    per-pixel tangent frame instead. Pixels with no normal map or a
    degenerate frame keep the geometric normal."""
    n_ts = smp[..., :3] * 2.0 - 1.0
    n_ts = torch.cat([n_ts[..., :2] * normal_scale, n_ts[..., 2:]], -1)
    if frame is not None:
        t, b = frame
        n2 = (t * n_ts[..., 0:1] + b * n_ts[..., 1:2]
              + normal * n_ts[..., 2:3])
        n2 = n2 / torch.clamp(_norm(n2), min=1e-9)
        return torch.where((normal_tex >= 0)[..., None], n2, normal)

    dpdx, dpdy = _ddx(world_pos), _ddy(world_pos)
    dudx, dudy = _ddx(uv[..., 0]), _ddy(uv[..., 0])
    dvdx, dvdy = _ddx(uv[..., 1]), _ddy(uv[..., 1])
    det = dudx * dvdy - dudy * dvdx
    safe = torch.where(torch.abs(det) > 1e-12, det, 1.0)
    t = (dpdx * dvdy[..., None] - dpdy * dvdx[..., None]) / safe[..., None]
    t = t - normal * torch.sum(t * normal, -1, keepdim=True)
    tlen = _norm(t)
    t = t / torch.clamp(tlen, min=1e-9)
    b = torch.linalg.cross(normal, t, dim=-1)
    n2 = (t * n_ts[..., 0:1] + b * n_ts[..., 1:2] + normal * n_ts[..., 2:3])
    n2 = n2 / torch.clamp(_norm(n2), min=1e-9)
    ok = (normal_tex >= 0) & (torch.abs(det) > 1e-12) & (tlen[..., 0] > 1e-9)
    return torch.where(ok[..., None], n2, normal)


# ---------------------------------------------------------------------------
# The window evaluator: K4
# ---------------------------------------------------------------------------

def wanted_mips(tex_flags: torch.Tensor, tids: torch.Tensor,
                u_ds: torch.Tensor, v_ds: torch.Tensor,
                resolution: int) -> torch.Tensor:
    """Texture-streaming feedback: (N,) i32 FINEST mip each texture wants
    this frame (not clamped by residency: the streamer compares it with
    the resident level). tids (K, h, w) at the sampling rate, u/v (h, w);
    M (the mip count) means "not sampled". The JAX package reduces by a
    broadcast-compare masked min over the texture axis; this is one
    `scatter_reduce("amin")`, which is order-free and so gives the same
    integers."""
    N = tex_flags.shape[0]
    M = len(mip_layout(resolution)[0])
    mipf = compute_mip(torch.stack([u_ds, v_ds], -1), resolution, M)
    mip_i = torch.round(mipf).to(torch.int32)
    flat_m = mip_i[None].expand(tids.shape).reshape(-1)
    flat_t = tids.reshape(-1).long()
    ok = (flat_t >= 0) & (flat_t < N)
    out = torch.full((N + 1,), M, dtype=torch.int32, device=tids.device)
    out.scatter_reduce_(0, torch.where(ok, flat_t, N), flat_m, "amin")
    return out[:N]


def _check_inputs(strips, rows, x_hat, yf, fmt="rgba8", live=None):
    if strips.dtype != torch.int32 or strips.dim() != 2 or strips.shape[1] != 128:
        raise ValueError(f"strips must be (NR, 128) i32, got "
                         f"{tuple(strips.shape)} {strips.dtype}")
    if rows.dtype != torch.int32 or rows.dim() != 2:
        raise ValueError(f"rows must be (JN, WR) i32, got {rows.dtype}")
    if fmt == "bc3" and rows.shape[1] != BC_WROWS:
        raise ValueError(f"BC3 windows are {BC_WROWS} block rows, got "
                         f"{rows.shape[1]}")
    elif fmt not in ("rgba8", "bc3"):
        raise ValueError(f"unknown texture atlas format {fmt!r}")
    JN = rows.shape[0]
    for name, x in (("x_hat", x_hat), ("yf", yf)):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != JN:
            raise ValueError(f"{name} must be ({JN}, P) f32, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if x_hat.shape != yf.shape:
        raise ValueError("x_hat and yf differ in shape")
    named = [("strips", strips), ("rows", rows), ("x_hat", x_hat),
             ("yf", yf)]
    if live is not None:
        if live.dtype not in (torch.bool, torch.uint8) \
                or live.shape != x_hat.shape:
            raise ValueError(f"live must be {tuple(x_hat.shape)} bool or "
                             f"uint8, got {tuple(live.shape)} {live.dtype}")
        named.append(("live", live))
    for name, x in named:
        if x.device != strips.device:
            raise ValueError(f"{name} is on {x.device}, strips on "
                             f"{strips.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def tex_block_eval(strips: torch.Tensor, rows: torch.Tensor,
                   x_hat: torch.Tensor, yf: torch.Tensor,
                   fmt: str = "rgba8", live: torch.Tensor = None
                   ) -> torch.Tensor:
    """Evaluate sampling jobs: strips (NR, 128) i32 atlas words, rows
    (JN, WR) i32 atlas rows of each job's window (24 RGBA8 texel rows, or
    7 BC3 block rows with fmt="bc3", decoded to 28 texel rows), x_hat / yf
    (JN, P) f32 fractional tap centres in window lanes / texel rows,
    `live` (JN, P) bool or uint8 (None: every pixel live). Returns (JN, P,
    4) f32 RGBA in [0, 255], 0 where live is 0. CUDA tensors launch the
    kernel of the atlas format; CPU tensors run the plain version."""
    _check_inputs(strips, rows, x_hat, yf, fmt, live)
    dev = strips.device
    bc = fmt == "bc3"
    if dev.type == "cuda":
        return (tex_block_eval_bc3_cuda if bc else tex_block_eval_cuda)(
            strips, rows, x_hat, yf, live)
    if dev.type == "cpu":
        return (tex_block_eval_bc3_plain if bc else tex_block_eval_plain)(
            strips, rows, x_hat, yf, live)
    raise ValueError(f"no texture sampler for device {dev}")


def _gather_window(strips: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(JN, WR) atlas row ids -> (JN, WR, 128) i32 window words (ids
    clamped into the atlas, as the kernel reads them)."""
    NR = strips.shape[0]
    return strips[torch.clamp(rows, 0, NR - 1).long()]


def _eval_window(win: torch.Tensor, x_hat: torch.Tensor,
                 yf: torch.Tensor) -> torch.Tensor:
    """(JN, WR, 128) RGBA8 texel windows -> (JN, P, 4) f32: the kernel's
    two bf16 x taps and two f32 y taps per pixel, in its order."""
    JN, WR, _ = win.shape
    f32 = torch.float32
    win = win.reshape(JN, WR * 128)

    def hat(lane):
        d = lane.to(f32) - x_hat
        return (torch.clamp(1.0 - torch.abs(d), min=0.0)
                + torch.clamp(1.0 - torch.abs(d + 128.0), min=0.0))

    l0 = torch.floor(x_hat).to(torch.int64) & 127
    l1 = (l0 + 1) & 127
    wa = hat(l0).to(torch.bfloat16).to(f32)
    wb = hat(l1).to(torch.bfloat16).to(f32)
    r0 = torch.floor(yf).to(torch.int64)
    out = torch.zeros(x_hat.shape + (4,), dtype=f32, device=x_hat.device)
    for r in (r0, r0 + 1):
        ok = r < WR
        rc = torch.clamp(r, 0, WR - 1)
        wy = torch.where(ok, torch.clamp(1.0 - torch.abs(r.to(f32) - yf),
                                         min=0.0), 0.0)
        ta = torch.gather(win, 1, rc * 128 + l0)
        tb = torch.gather(win, 1, rc * 128 + l1)
        for c in range(4):
            ca = ((ta >> (8 * c)) & 255).to(f32)
            cb = ((tb >> (8 * c)) & 255).to(f32)
            out[..., c] += (ca * wa + cb * wb) * wy
    return out


def _masked(out: torch.Tensor, live) -> torch.Tensor:
    """`out` where `live` (None: everywhere), else 0."""
    if live is None:
        return out
    return torch.where(live.bool()[..., None], out, 0.0)


def tex_block_eval_plain(strips: torch.Tensor, rows: torch.Tensor,
                         x_hat: torch.Tensor, yf: torch.Tensor,
                         live: torch.Tensor = None) -> torch.Tensor:
    """Plain PyTorch version of the RGBA8 kernel (same taps, same
    roundings; 0 where `live` is 0)."""
    _check_inputs(strips, rows, x_hat, yf, live=live)
    return _masked(_eval_window(_gather_window(strips, rows), x_hat, yf),
                   live)


def tex_block_eval_bc3_plain(strips: torch.Tensor, rows: torch.Tensor,
                             x_hat: torch.Tensor, yf: torch.Tensor,
                             live: torch.Tensor = None) -> torch.Tensor:
    """Plain PyTorch version of the BC3 kernel: the reference's separate
    `bc3_decode_rows`, then the RGBA8 evaluation over 28 texel rows (0
    where `live` is 0)."""
    _check_inputs(strips, rows, x_hat, yf, "bc3", live)
    return _masked(_eval_window(bc3_decode_rows(_gather_window(strips, rows)),
                                x_hat, yf), live)


_tex_fns = {}


def _kernel_fn(name: str):
    if name not in _tex_fns:
        fn = getattr(cuda_build.load(SOURCE).lib, name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, ctypes.c_longlong, p, p, p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
        _tex_fns[name] = fn
    return _tex_fns[name]


def _launch(entry: str, strips, rows, x_hat, yf, live) -> torch.Tensor:
    dev = strips.device
    if dev.type != "cuda":
        raise ValueError(f"the texture kernel needs CUDA tensors, got {dev}")
    if strips.data_ptr() % 16:
        raise ValueError("strips must be 16-byte aligned")
    JN, WR = rows.shape
    P = x_hat.shape[1]
    out = torch.empty((JN, P, 4), dtype=torch.float32, device=dev)
    if JN == 0:
        return out
    fn = _kernel_fn(entry)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(strips.data_ptr(), strips.shape[0], rows.data_ptr(),
                 x_hat.data_ptr(), yf.data_ptr(),
                 live.data_ptr() if live is not None else None,
                 out.data_ptr(), JN, WR, P, stream)
    if err != 0:
        raise RuntimeError(f"texture kernel launch failed: CUDA error {err}")
    return out


def tex_block_eval_cuda(strips: torch.Tensor, rows: torch.Tensor,
                        x_hat: torch.Tensor, yf: torch.Tensor,
                        live: torch.Tensor = None) -> torch.Tensor:
    """Launch the RGBA8 kernel on the current stream (no synchronisation).
    `tex_block_eval_cuda.launches` counts its launches."""
    _check_inputs(strips, rows, x_hat, yf, live=live)
    out = _launch("br_tex_block_eval", strips, rows, x_hat, yf, live)
    if rows.shape[0]:
        tex_block_eval_cuda.launches += 1
    return out


def tex_block_eval_bc3_cuda(strips: torch.Tensor, rows: torch.Tensor,
                            x_hat: torch.Tensor, yf: torch.Tensor,
                            live: torch.Tensor = None) -> torch.Tensor:
    """Launch the BC3 kernel (window gather, each tap's texel decoded from
    the block words in shared memory) on the current stream.
    `tex_block_eval_bc3_cuda.launches` counts its launches."""
    _check_inputs(strips, rows, x_hat, yf, "bc3", live)
    out = _launch("br_tex_block_eval_bc3", strips, rows, x_hat, yf, live)
    if rows.shape[0]:
        tex_block_eval_bc3_cuda.launches += 1
    return out


tex_block_eval_cuda.launches = 0
tex_block_eval_bc3_cuda.launches = 0
