"""Texture processing: BC block compression, DDS/HDR containers,
alpha-coverage mips, processed-texture disk cache.

Host-only numpy, copied from basicrenderer_tpu/models/texprocess.py with
its behaviour unchanged:
- the BC codec: BC1 colour, BC4 single-channel and BC3 (= BC4 alpha +
  BC1 colour) 4x4-block encoders and decoders. models/textures.py encodes
  the BC3 strip atlas with it; ops/textures.bc3_decode_rows and the CUDA
  texture kernel decode the same blocks on the device;
- the DDS container (raw RGBA8/BGRA8, DXT1, DXT5) and the Radiance .hdr
  container (flat and RLE scanlines; models/environment.py reads
  equirect panoramas with it);
- `alpha_coverage_scale`, the alpha scale that keeps an alpha-MASK
  layer's coverage at each mip (models/textures.py);
- `ProcessedTextureCache` and `process_for_registry`, the importer's
  decode + resize (+ BC3 round trip for colour) of image bytes to the
  registry resolution, and `decode_image_bytes` (DDS, HDR, else PNG/JPEG
  through PIL).
"""

from __future__ import annotations

import hashlib
import os
import struct
import threading
from typing import Optional

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


# ---------------------------------------------------------------------------
# DDS container (reference: TextureFactory's DDS path).

_DDS_MAGIC = b"DDS "
_DDPF_FOURCC = 0x4
_DDPF_RGB = 0x40
_DDPF_ALPHAPIXELS = 0x1


def save_dds(path: str, img: np.ndarray, fourcc: Optional[str] = None
             ) -> None:
    """Write (H, W, 4) uint8 as DDS: raw RGBA8, or 'DXT1'/'DXT5' blocks."""
    h, w = img.shape[:2]
    if fourcc is None:
        pf = struct.pack("<II4sIIIII", 32, _DDPF_RGB | _DDPF_ALPHAPIXELS,
                         b"\0\0\0\0", 32, 0x000000FF, 0x0000FF00,
                         0x00FF0000, 0xFF000000)
        payload = np.ascontiguousarray(img[..., :4], np.uint8).tobytes()
        pitch = w * 4
    else:
        pf = struct.pack("<II4sIIIII", 32, _DDPF_FOURCC,
                         fourcc.encode(), 0, 0, 0, 0, 0)
        enc = {"DXT1": bc1_encode, "DXT5": bc3_encode}[fourcc]
        payload = enc(img if fourcc == "DXT5" else img[..., :3]).tobytes()
        pitch = len(payload)
    header = struct.pack("<I", 124)                      # dwSize
    header += struct.pack("<IIIII", 0x1 | 0x2 | 0x4 | 0x1000, h, w, pitch, 0)
    header += struct.pack("<I", 1)                       # mipMapCount
    header += b"\0" * 44                                 # reserved
    header += pf
    header += struct.pack("<IIIII", 0x1000, 0, 0, 0, 0)  # caps
    with open(path, "wb") as f:
        f.write(_DDS_MAGIC + header + payload)


def load_dds(data: bytes) -> np.ndarray:
    """DDS bytes -> (H, W, 4) uint8. Supports DXT1/DXT5 and 32-bit
    uncompressed RGBA/BGRA; reads the top mip (the registry rebuilds
    chains with alpha-coverage handling anyway)."""
    if data[:4] != _DDS_MAGIC:
        raise ValueError("not a DDS file")
    h, w = struct.unpack("<II", data[12:20])
    pf_flags, = struct.unpack("<I", data[80:84])
    fourcc = data[84:88]
    body = data[128:]
    if pf_flags & _DDPF_FOURCC:
        if fourcc == b"DX10":
            raise ValueError("DX10 extended DDS not supported")
        # DXT block counts round UP; non-multiple-of-4 dims are legal in
        # third-party files — decode the padded extent, crop to (h, w).
        bh, bw = -(-h // 4), -(-w // 4)
        nblocks = bh * bw
        hp, wp = bh * 4, bw * 4
        if fourcc == b"DXT1":
            blocks = np.frombuffer(body[:nblocks * 8],
                                   np.uint8).reshape(-1, 8)
            rgb = bc1_decode(blocks, hp, wp)[:h, :w]
            return np.concatenate(
                [rgb, np.full((h, w, 1), 255, np.uint8)], -1)
        if fourcc in (b"DXT4", b"DXT5"):
            blocks = np.frombuffer(body[:nblocks * 16],
                                   np.uint8).reshape(-1, 16)
            return np.ascontiguousarray(bc3_decode(blocks, hp, wp)[:h, :w])
        raise ValueError(f"unsupported DDS fourCC {fourcc!r}")
    bitcount, rmask = struct.unpack("<II", data[88:96])
    if bitcount != 32:
        raise ValueError(f"unsupported DDS bit count {bitcount}")
    px = np.frombuffer(body[:h * w * 4], np.uint8).reshape(h, w, 4)
    if rmask == 0x00FF0000:                              # BGRA
        px = px[..., [2, 1, 0, 3]]
    return np.ascontiguousarray(px)


# ---------------------------------------------------------------------------
# Radiance .hdr (RGBE) — HDR environment maps (reference: TextureFactory
# HDR path feeding EnvironmentManager).


def save_hdr(path: str, img: np.ndarray) -> None:
    """(H, W, 3) float32 -> Radiance RGBE, flat (non-RLE) scanlines."""
    h, w = img.shape[:2]
    rgb = np.maximum(np.asarray(img, np.float32), 0.0)
    maxc = rgb.max(-1).astype(np.float64)
    # frexp puts the mantissa of the dominant channel in [128, 256) like
    # canonical float2rgbe (ceil(log2) clipped exact powers of two to 255).
    _, exp = np.frexp(np.maximum(maxc, 1e-32))
    exp = np.where(maxc > 1e-32, exp.astype(np.float64), -128.0)
    scale = np.where(maxc > 1e-32, np.exp2(-exp) * 256.0, 0.0)
    # mantissa in [0,256); clip 255 (v = m * 2^(e-136) on decode)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(np.round(rgb * scale[..., None]), 0,
                            255).astype(np.uint8)
    rgbe[..., 3] = np.where(maxc > 1e-32, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def load_hdr(data: bytes) -> np.ndarray:
    """Radiance RGBE bytes -> (H, W, 3) float32 linear. Handles flat and
    new-style (per-component) RLE scanlines."""
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance HDR file")
    pos = 0
    h = w = None
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line.startswith(b"-Y"):
            parts = line.split()
            h, w = int(parts[1]), int(parts[3])
            break
        if pos > len(data):
            raise ValueError("truncated HDR header")
    body = np.frombuffer(data, np.uint8, offset=pos)
    rgbe = np.zeros((h, w, 4), np.uint8)
    if w < 8 or w > 0x7FFF or not (
            body[0] == 2 and body[1] == 2 and
            (int(body[2]) << 8 | int(body[3])) == w):
        rgbe = body[:h * w * 4].reshape(h, w, 4).copy()
    else:
        off = 0
        for y in range(h):
            if not (body[off] == 2 and body[off + 1] == 2):
                raise ValueError("mixed RLE/flat HDR scanlines")
            off += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = int(body[off]); off += 1
                    if count > 128:                      # run
                        rgbe[y, x:x + count - 128, c] = body[off]
                        off += 1
                        x += count - 128
                    else:                                # literal span
                        rgbe[y, x:x + count, c] = body[off:off + count]
                        off += count
                        x += count
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


# ---------------------------------------------------------------------------
# Alpha-coverage-preserving mips (reference: TextureProcessingManager's
# alpha-tested mip scaling — without it, MASK foliage thins to nothing at
# distance because box-filtered alpha drifts below the cutoff).


def alpha_coverage_scale(alpha: np.ndarray, cutoff: float,
                         ref_coverage: float, iters: int = 12) -> float:
    """Binary-search the alpha scale that restores mean(alpha*s > cutoff)
    to the level-0 coverage."""
    lo, hi = 0.25, 8.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cov = float(np.mean(np.minimum(alpha * mid, 1.0) > cutoff))
        if cov < ref_coverage:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


# ---------------------------------------------------------------------------
# Processed-texture disk cache (reference: the processed-texture cache the
# TextureProcessingManager keeps so re-imports skip decode+mips+encode).


class ProcessedTextureCache:
    """Content-addressed cache of import-processed textures: decoded,
    resized to the registry resolution, and BC3-compressed (color) or kept
    raw (data textures, where BC on normals would bias shading). Hits skip
    image decode AND resize; hit/miss produce bit-identical registry
    content because the miss path also round-trips through the stored
    form before registering."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.hits = 0
        self.misses = 0
        self._stat_lock = threading.Lock()  # decodes run on the task pool

    @staticmethod
    def key(data: bytes, srgb: bool, resolution: int) -> str:
        hsh = hashlib.sha1()
        hsh.update(data)
        hsh.update(b"s" if srgb else b"d")
        hsh.update(struct.pack("<I", resolution))
        return hsh.hexdigest()

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key + ".npz")

    def load(self, key: str) -> Optional[np.ndarray]:
        """-> (R, R, 4) uint8 (sRGB-encoded for color layers) or None.
        A corrupt/truncated entry is treated as a miss (and will be
        overwritten by the next store)."""
        p = self._path(key)
        if not os.path.exists(p):
            with self._stat_lock:
                self.misses += 1
            return None
        try:
            with np.load(p) as z:
                if "bc3" in z:
                    r = int(z["res"])
                    out = bc3_decode(z["bc3"], r, r)
                else:
                    out = z["raw"]
        except Exception:
            with self._stat_lock:
                self.misses += 1
            return None
        with self._stat_lock:
            self.hits += 1
        return out

    def store(self, key: str, img_u8: np.ndarray, srgb: bool) -> np.ndarray:
        """Store an (R, R, 4) uint8 processed image; returns the image as
        the cache will reproduce it (BC-round-tripped for color).
        Writes go to a temp file in the same dir + os.replace so concurrent
        workers / a crash mid-write can never leave a truncated entry."""
        p = self._path(key)
        r = img_u8.shape[0]
        tmp = f"{p}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            if srgb:
                blocks = bc3_encode(img_u8)
                np.savez(tmp, bc3=blocks, res=np.int32(r))
            else:
                np.savez(tmp, raw=img_u8)
            # np.savez appends .npz when the name lacks it.
            os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", p)
        except OSError:
            for cand in (tmp, tmp + ".npz"):
                if os.path.exists(cand):
                    os.remove(cand)
        if srgb:
            return bc3_decode(blocks, r, r)
        return img_u8


def process_for_registry(data: bytes, srgb: bool, resolution: int,
                         cache: Optional[ProcessedTextureCache] = None,
                         ) -> Optional[np.ndarray]:
    """Decode image bytes (PNG/JPEG via PIL, DDS, HDR) -> (R, R, 4) uint8
    at the registry resolution, through the processed cache when given."""
    key = None
    if cache is not None:
        key = cache.key(data, srgb, resolution)
        hit = cache.load(key)
        if hit is not None:
            return hit
    img = decode_image_bytes(data)
    if img is None:
        return None
    # Resize in linear space (matches TextureRegistry._resize quality),
    # then re-encode to the stored uint8 form.
    from .textures import _resize
    f = img.astype(np.float32) / 255.0
    if srgb:
        lin = np.where(f[..., :3] <= 0.04045, f[..., :3] / 12.92,
                       ((f[..., :3] + 0.055) / 1.055) ** 2.4)
        f = np.concatenate([lin, f[..., 3:]], -1)
    f = _resize(f, resolution)
    rgb = f[..., :3]
    if srgb:
        rgb = np.where(rgb <= 0.0031308, rgb * 12.92,
                       1.055 * np.maximum(rgb, 1e-8) ** (1 / 2.4) - 0.055)
    out = np.clip(np.concatenate([rgb, f[..., 3:]], -1) * 255.0 + 0.5,
                  0, 255).astype(np.uint8)
    if cache is not None:
        out = cache.store(key, out, srgb)
    return out


def decode_image_bytes(data: bytes) -> Optional[np.ndarray]:
    """bytes -> (H, W, 4) uint8: DDS and HDR natively, else PIL."""
    if data[:4] == _DDS_MAGIC:
        return load_dds(data)
    if data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE"):
        hdr = load_hdr(data)
        # Tone-less clamp to LDR for the albedo path; environment maps
        # should call load_hdr directly to keep radiance.
        u8 = np.clip(hdr * 255.0, 0, 255).astype(np.uint8)
        return np.concatenate([u8, np.full(u8.shape[:2] + (1,), 255,
                                           np.uint8)], -1)
    try:
        from io import BytesIO
        from PIL import Image
        with Image.open(BytesIO(data)) as im:
            return np.asarray(im.convert("RGBA"))
    except Exception:
        return None
