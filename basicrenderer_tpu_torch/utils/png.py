"""Minimal PNG reader and writer (stdlib zlib + numpy).

Reads the non-interlaced 8-bit grayscale, RGB and RGBA files the golden
corpus holds, so golden checks need no imaging package; writes RGB8 files
(the UI server's frames, the showcase's images).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_CHANNELS = {0: 1, 2: 3, 6: 4}   # PNG colour type -> samples per pixel


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def read_png(path) -> np.ndarray:
    """(H, W, C) uint8 image (C = 1, 3 or 4)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: unsupported PNG (depth {depth}, colour "
                         f"type {ctype}, interlace {interlace})")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        line = raw[y * (stride + 1):(y + 1) * (stride + 1)]
        ftype = line[0]
        cur = np.frombuffer(line[1:], np.uint8).astype(np.int64)
        if ftype == 1:          # Sub
            for x in range(bpp, stride):
                cur[x] = (cur[x] + cur[x - bpp]) & 0xFF
        elif ftype == 2:        # Up
            cur = (cur + prev) & 0xFF
        elif ftype == 3:        # Average
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                cur[x] = (cur[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif ftype == 4:        # Paeth
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                up_left = prev[x - bpp] if x >= bpp else 0
                cur[x] = (cur[x] + _paeth(int(left), int(prev[x]),
                                          int(up_left))) & 0xFF
        elif ftype != 0:
            raise ValueError(f"{path}: bad filter type {ftype} on row {y}")
        out[y] = cur
        prev = cur
    return out.reshape(h, w, bpp)


def encode_png(img) -> bytes:
    """Minimal RGB8 PNG encoder (a grayscale image is repeated to RGB)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    h, w = img.shape[:2]

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + \
            struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path, img) -> None:
    """Write an (H, W, 3) or (H, W) uint8 image as an RGB8 PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
