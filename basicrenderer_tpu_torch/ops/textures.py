"""Block-window texture sampling from the strip atlas: the CUDA kernel
(csrc/tex_block.cu) and its plain PyTorch version.

Port of the RGBA8 path of basicrenderer_tpu/ops/textures.py
(`mip_layout`, `layer_words`, `strip_layout`, `compute_mip`,
`_min_abs_grad`, `_blockify`, `_unblockify`,
`sample_pyramid_blocked_planes` and the Pallas `_tex_block_kernel`).

Pixels are sampled in 16x16 screen blocks. Each block makes one sampling
JOB per (channel, layer rank) -- rank 0 = the block's dominant layer, plus
a runner-up job for the first channel -- and each job picks one mip and
one window of 24 atlas rows x 128 texels (models/textures.strip_pyramid
stores every mip row as 128-texel strips at 64-texel x phases, so a
window is 24 gathered rows). Per pixel, the job's bilinear taps are read
from that window: `tex_block_eval` is the kernel's entry point.

`tex_block_eval` picks the implementation by the device of its inputs:
CUDA tensors launch the kernel (or raise), CPU tensors run the plain
version. Both compute the TPU kernel's hat-function identity at the two
lanes and two rows where it is nonzero: x weights max(0, 1-|l-x|) +
max(0, 1-|l-x+128|) (the second term is the lane-127 -> 0 wrap) rounded
to bf16, y weights in f32, byte channels as exact small integers, and
the same two-term f32 sums, so the result is the TPU kernel's to the ulp.

Not ported: the BC3 atlas (`bc3_decode_rows` raises) and the per-pixel
`sample_pyramid` reference.
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
def infer_strip_resolution(rows_per_layer: int, fmt: str = "rgba8") -> int:
    """Atlas resolution from its rows per layer."""
    if fmt != "rgba8":
        raise NotImplementedError(f"texture atlas format {fmt!r} is not "
                                  "ported yet (FrameConfig.tex_format)")
    r = MIN_MIP
    while r <= 1 << 16:
        if strip_layout(r)[1] == rows_per_layer:
            return r
        r *= 2
    raise ValueError(f"no strip layout has {rows_per_layer} rows")


def bc3_decode_rows(win: torch.Tensor) -> torch.Tensor:
    raise NotImplementedError(
        "BC3 block decode is not ported yet (FrameConfig.tex_format='bc3')")


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


def sample_pyramid_blocked_planes(strips: torch.Tensor, tex_flags: torch.Tensor,
                                  tids: torch.Tensor, u_ds: torch.Tensor,
                                  v_ds: torch.Tensor, H: int, W: int,
                                  ds: int = 1, filter: str = "bilinear",
                                  upsample: bool = True,
                                  mipf: torch.Tensor = None,
                                  fmt: str = "rgba8") -> torch.Tensor:
    """Sample K channel layers sharing one UV image.

    strips (N * rows_per_layer, 128) i32 RGBA8 words; tex_flags (N,) i32;
    tids (K, h, w) i32 (-1 = none -> white); u_ds / v_ds (h, w) at the
    sampling rate (h = H // ds). Returns (K, H, W, 4) f32 linear, or the
    sampling-rate image (K, h, w, 4) with `upsample=False`. `mipf` (h, w)
    overrides the per-pixel mip estimate.

    Blocks straddling UV wrap seams or with oversized footprints sample a
    coarser mip (blur, never wrong memory); the first channel blends two
    layers per block, the others one."""
    K = tids.shape[0]
    N = tex_flags.shape[0]
    R = infer_strip_resolution(strips.shape[0] // N, fmt)
    sizes, _ = mip_layout(R)
    M = len(sizes)
    row_offs, RPL = strip_layout(R)
    WR = WROWS
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
    off = torch.zeros_like(mb)
    for m, sz in enumerate(sizes):
        rm = torch.where(mb == m, sz, rm)
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

    jrow = torch.arange(WR, dtype=i32, device=dev)[None, None, :]
    yrow = torch.remainder(y0[:, :, None] + jrow, rm[:, :, None])
    phase_rows = torch.where(wide, torch.div(xb, 64, rounding_mode="floor")
                             * rm, 0)
    rows_k = (layer_j[:, :, None] * RPL + off[:, :, None]
              + phase_rows[:, :, None] + yrow)            # (J, nb, WR)

    ix0f = torch.floor(txf)
    fx = txf - ix0f
    ix0 = ix0f.to(i32)
    ix0 = torch.where(wide[:, :, None],
                      torch.clamp(ix0 - xb[:, :, None], 0, 126),
                      torch.remainder(ix0, 128))
    ix1 = torch.where(wide[:, :, None], ix0 + 1, torch.remainder(ix0 + 1, 128))
    iy0f = torch.floor(tyf)
    fy = tyf - iy0f
    wy0 = torch.clamp(iy0f.to(i32) - y0[:, :, None], 0, WR - 2)
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
    out = tex_block_eval(strips, rows_k.reshape(J * nb, WR).contiguous(),
                         x_hat.reshape(J * nb, P).contiguous(),
                         yf.reshape(J * nb, P).contiguous())
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
# The window evaluator: K4
# ---------------------------------------------------------------------------

def _check_inputs(strips, rows, x_hat, yf):
    if strips.dtype != torch.int32 or strips.dim() != 2 or strips.shape[1] != 128:
        raise ValueError(f"strips must be (NR, 128) i32, got "
                         f"{tuple(strips.shape)} {strips.dtype}")
    if rows.dtype != torch.int32 or rows.dim() != 2:
        raise ValueError(f"rows must be (JN, WR) i32, got {rows.dtype}")
    JN = rows.shape[0]
    for name, x in (("x_hat", x_hat), ("yf", yf)):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != JN:
            raise ValueError(f"{name} must be ({JN}, P) f32, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if x_hat.shape != yf.shape:
        raise ValueError("x_hat and yf differ in shape")
    for name, x in (("strips", strips), ("rows", rows), ("x_hat", x_hat),
                    ("yf", yf)):
        if x.device != strips.device:
            raise ValueError(f"{name} is on {x.device}, strips on "
                             f"{strips.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def tex_block_eval(strips: torch.Tensor, rows: torch.Tensor,
                   x_hat: torch.Tensor, yf: torch.Tensor) -> torch.Tensor:
    """Evaluate sampling jobs: strips (NR, 128) i32 RGBA8 words, rows
    (JN, WR) i32 atlas rows of each job's window, x_hat / yf (JN, P) f32
    fractional tap centres in window lanes / rows. Returns (JN, P, 4) f32
    RGBA in [0, 255]. CUDA tensors launch the kernel; CPU tensors run the
    plain version."""
    _check_inputs(strips, rows, x_hat, yf)
    dev = strips.device
    if dev.type == "cuda":
        return tex_block_eval_cuda(strips, rows, x_hat, yf)
    if dev.type == "cpu":
        return tex_block_eval_plain(strips, rows, x_hat, yf)
    raise ValueError(f"no texture sampler for device {dev}")


def tex_block_eval_plain(strips: torch.Tensor, rows: torch.Tensor,
                         x_hat: torch.Tensor, yf: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same taps, same roundings)."""
    _check_inputs(strips, rows, x_hat, yf)
    NR = strips.shape[0]
    JN, WR = rows.shape
    f32 = torch.float32
    win = strips[torch.clamp(rows, 0, NR - 1).long()].reshape(JN, WR * 128)

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


_tex_fn = None


def _kernel_fn():
    global _tex_fn
    if _tex_fn is None:
        fn = cuda_build.load(SOURCE).lib.br_tex_block_eval
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, ctypes.c_longlong, p, p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
        _tex_fn = fn
    return _tex_fn


def tex_block_eval_cuda(strips: torch.Tensor, rows: torch.Tensor,
                        x_hat: torch.Tensor, yf: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronisation).
    `tex_block_eval_cuda.launches` counts the launches."""
    _check_inputs(strips, rows, x_hat, yf)
    dev = strips.device
    if dev.type != "cuda":
        raise ValueError(f"tex_block_eval_cuda needs CUDA tensors, got {dev}")
    JN, WR = rows.shape
    P = x_hat.shape[1]
    out = torch.empty((JN, P, 4), dtype=torch.float32, device=dev)
    if JN == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(strips.data_ptr(), strips.shape[0], rows.data_ptr(),
                 x_hat.data_ptr(), yf.data_ptr(), out.data_ptr(), JN, WR, P,
                 stream)
    if err != 0:
        raise RuntimeError(f"texture kernel launch failed: CUDA error {err}")
    tex_block_eval_cuda.launches += 1
    return out


tex_block_eval_cuda.launches = 0
