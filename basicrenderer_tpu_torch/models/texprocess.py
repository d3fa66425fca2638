"""Texture processing, the BC block codec: BC1 colour, BC4 single-channel
and BC3 (= BC4 alpha + BC1 colour) 4x4-block encoders and decoders.

Host-only numpy, copied from basicrenderer_tpu/models/texprocess.py with
its behaviour unchanged (`_to_blocks`, `_from_blocks`, `_quant565`,
`_dequant565`, `bc1_encode`/`bc1_decode`, `bc4_encode`/`bc4_decode`,
`bc3_encode`/`bc3_decode`). models/textures.py encodes the BC3 strip
atlas with it; ops/textures.bc3_decode_rows and the CUDA texture kernel
decode the same blocks on the device.

Not ported yet: the DDS and HDR containers, the alpha-coverage mip scale
and the processed-texture disk cache (they come with the importers).
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# BC1 (DXT1) color blocks: 8 bytes per 4x4 block.


def _to_blocks(img: np.ndarray) -> np.ndarray:
    """(H, W, C) -> (B, 16, C) row-major 4x4 blocks. H, W must be %4."""
    h, w, c = img.shape
    return (img.reshape(h // 4, 4, w // 4, 4, c)
            .transpose(0, 2, 1, 3, 4).reshape(-1, 16, c))


def _from_blocks(blocks: np.ndarray, h: int, w: int) -> np.ndarray:
    c = blocks.shape[-1]
    return (blocks.reshape(h // 4, w // 4, 4, 4, c)
            .transpose(0, 2, 1, 3, 4).reshape(h, w, c))


def _quant565(c: np.ndarray) -> np.ndarray:
    """(B, 3) float 0..255 -> (B,) uint16 RGB565."""
    r = np.clip(np.round(c[:, 0] * 31.0 / 255.0), 0, 31).astype(np.uint16)
    g = np.clip(np.round(c[:, 1] * 63.0 / 255.0), 0, 63).astype(np.uint16)
    b = np.clip(np.round(c[:, 2] * 31.0 / 255.0), 0, 31).astype(np.uint16)
    return (r << 11) | (g << 5) | b


def _dequant565(q: np.ndarray) -> np.ndarray:
    """(B,) uint16 -> (B, 3) float 0..255 (the bit-replicating expand
    real decoders use)."""
    r = ((q >> 11) & 31).astype(np.float32)
    g = ((q >> 5) & 63).astype(np.float32)
    b = (q & 31).astype(np.float32)
    return np.stack([(r * 255.0 / 31.0), (g * 255.0 / 63.0),
                     (b * 255.0 / 31.0)], -1)


def bc1_encode(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (B, 8) uint8 DXT1 blocks (4-color mode).

    Endpoints: the two block colors extreme along the color-range axis
    (classic fast range-fit), quantized to 565; indices pick the nearest
    of the 4 decoded palette entries, so encode/decode round-trips
    exactly on <=2-color blocks."""
    blocks = _to_blocks(rgb.astype(np.float32))         # (B, 16, 3)
    B = blocks.shape[0]
    mn, mx = blocks.min(1), blocks.max(1)
    axis = mx - mn                                       # (B, 3)
    t = np.einsum("bkc,bc->bk", blocks - mn[:, None], axis)
    c0 = blocks[np.arange(B), t.argmax(1)]
    c1 = blocks[np.arange(B), t.argmin(1)]
    q0, q1 = _quant565(c0), _quant565(c1)
    # 4-color mode requires q0 > q1; swap, and nudge apart if equal.
    swap = q0 < q1
    q0s = np.where(swap, q1, q0)
    q1s = np.where(swap, q0, q1)
    same = q0s == q1s
    d0, d1 = _dequant565(q0s), _dequant565(q1s)          # (B, 3)
    palette = np.stack([d0, d1, (2 * d0 + d1) / 3.0, (d0 + 2 * d1) / 3.0],
                       1)                                # (B, 4, 3)
    dist = ((blocks[:, :, None] - palette[:, None]) ** 2).sum(-1)
    idx = dist.argmin(-1).astype(np.uint32)              # (B, 16)
    idx = np.where(same[:, None], 0, idx)
    bits = (idx << (2 * np.arange(16, dtype=np.uint32))).sum(-1,
                                                             dtype=np.uint64)
    out = np.empty((B, 8), np.uint8)
    out[:, 0] = q0s & 0xFF
    out[:, 1] = q0s >> 8
    out[:, 2] = q1s & 0xFF
    out[:, 3] = q1s >> 8
    for k in range(4):
        out[:, 4 + k] = (bits >> np.uint64(8 * k)).astype(np.uint64) & np.uint64(0xFF)
    return out


def bc1_decode(blocks: np.ndarray, h: int, w: int) -> np.ndarray:
    """(B, 8) uint8 DXT1 -> (H, W, 3) uint8. Handles both 4-color and
    3-color+black modes (third-party files use the latter for punch-through
    alpha; we decode black, alpha handled by BC3/BC4 when present)."""
    blocks = blocks.astype(np.uint16)
    q0 = blocks[:, 0] | (blocks[:, 1] << 8)
    q1 = blocks[:, 2] | (blocks[:, 3] << 8)
    d0, d1 = _dequant565(q0), _dequant565(q1)
    four = (q0 > q1)[:, None]
    p2 = np.where(four, (2 * d0 + d1) / 3.0, (d0 + d1) * 0.5)
    p3 = np.where(four, (d0 + 2 * d1) / 3.0, 0.0)
    palette = np.stack([d0, d1, p2, p3], 1)              # (B, 4, 3)
    bits = (blocks[:, 4].astype(np.uint64)
            | (blocks[:, 5].astype(np.uint64) << 8)
            | (blocks[:, 6].astype(np.uint64) << 16)
            | (blocks[:, 7].astype(np.uint64) << 24))
    idx = ((bits[:, None] >> (2 * np.arange(16, dtype=np.uint64))) & 3
           ).astype(np.int64)                            # (B, 16)
    cols = np.take_along_axis(palette, idx[..., None], 1)
    return np.clip(np.round(_from_blocks(cols, h, w)), 0,
                   255).astype(np.uint8)


# ---------------------------------------------------------------------------
# BC4 single-channel blocks (the alpha half of BC3): 8 bytes per block.


def bc4_encode(a: np.ndarray) -> np.ndarray:
    """(H, W) uint8 -> (B, 8) uint8 BC4 blocks (8-step a0>a1 mode)."""
    blocks = _to_blocks(a.astype(np.float32)[..., None])[..., 0]  # (B, 16)
    a0 = blocks.max(1)
    a1 = blocks.min(1)
    # a0 > a1 selects the 8-interpolant mode; equal blocks encode as-is.
    w = np.arange(7, 0, -1, np.float32) / 7.0            # 7/7 .. 1/7
    interp = a0[:, None] * w + a1[:, None] * (1.0 - w)   # (B, 7) incl a0
    palette = np.concatenate([interp[:, :1], a1[:, None], interp[:, 1:]], 1)
    dist = np.abs(blocks[:, :, None] - palette[:, None])
    idx = dist.argmin(-1).astype(np.uint64)              # (B, 16) 3-bit codes
    bits = (idx << (3 * np.arange(16, dtype=np.uint64))).sum(
        -1, dtype=np.uint64)                             # 48 bits
    B = blocks.shape[0]
    out = np.empty((B, 8), np.uint8)
    out[:, 0] = np.round(a0).astype(np.uint8)
    out[:, 1] = np.round(a1).astype(np.uint8)
    for k in range(6):
        out[:, 2 + k] = (bits >> np.uint64(8 * k)) & np.uint64(0xFF)
    return out


def bc4_decode(blocks: np.ndarray, h: int, w: int) -> np.ndarray:
    """(B, 8) uint8 BC4 -> (H, W) uint8 (both 8-step and 6-step modes)."""
    a0 = blocks[:, 0].astype(np.float32)
    a1 = blocks[:, 1].astype(np.float32)
    eight = (blocks[:, 0] > blocks[:, 1])[:, None]
    w8 = np.arange(7, 0, -1, np.float32) / 7.0
    p8 = np.concatenate([(a0[:, None] * w8 + a1[:, None] * (1 - w8))[:, :1],
                         a1[:, None],
                         (a0[:, None] * w8 + a1[:, None] * (1 - w8))[:, 1:]],
                        1)                               # (B, 8)
    w6 = np.arange(5, 0, -1, np.float32) / 5.0
    p6 = np.concatenate([a0[:, None], a1[:, None],
                         a0[:, None] * w6[1:] + a1[:, None] * (1 - w6[1:]),
                         np.zeros_like(a0[:, None]),
                         np.full_like(a0[:, None], 255.0)], 1)
    palette = np.where(eight, p8, p6)
    bits = np.zeros(blocks.shape[0], np.uint64)
    for k in range(6):
        bits |= blocks[:, 2 + k].astype(np.uint64) << np.uint64(8 * k)
    idx = ((bits[:, None] >> (3 * np.arange(16, dtype=np.uint64))) & 7
           ).astype(np.int64)
    vals = np.take_along_axis(palette, idx, 1)           # (B, 16)
    return np.clip(np.round(_from_blocks(vals[..., None], h, w)[..., 0]),
                   0, 255).astype(np.uint8)


def bc3_encode(rgba: np.ndarray) -> np.ndarray:
    """(H, W, 4) uint8 -> (B, 16) uint8 DXT5 blocks (BC4 alpha + BC1 color)."""
    return np.concatenate([bc4_encode(rgba[..., 3]),
                           bc1_encode(rgba[..., :3])], -1)


def bc3_decode(blocks: np.ndarray, h: int, w: int) -> np.ndarray:
    a = bc4_decode(blocks[:, :8], h, w)
    rgb = bc1_decode(blocks[:, 8:], h, w)
    return np.concatenate([rgb, a[..., None]], -1)
