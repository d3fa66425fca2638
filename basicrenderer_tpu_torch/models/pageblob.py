"""Quantized cluster vertex pages + the disk page-blob container.

Port of basicrenderer_tpu/models/pageblob.py (host only; the byte format
is the JAX package's, so a container either package writes opens in the
other). A page row is PLANAR: three contiguous SLAB-lane u32 blocks
[px|py, pz|oct, u|v], each word holding two 16-bit values: positions quantized to 16 bits
in the page's AABB, octahedral normals as two 8-bit values, UVs as half
floats. The setup path (ops/raster_setup.triangle_setup_clustered) undoes
the quantization per corner column.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Dict, Optional

import numpy as np

MAGIC = b"BRPB"
VERSION = 3  # v3: pages are CORNER-MAJOR (row j = corner*meshlet + tri)

# Dequant row layout: [aabb_min xyz, aabb_extent xyz, pad, pad]
DEQUANT_LANES = 8


def oct_encode(n: np.ndarray) -> np.ndarray:
    """(N, 3) unit-ish normals -> (N, 2) octahedral in [0, 1]."""
    n = np.asarray(n, np.float32)
    denom = np.abs(n).sum(axis=1, keepdims=True)
    denom = np.where(denom < 1e-20, 1.0, denom)
    v = n / denom
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    fold = z < 0
    xf = np.where(fold, (1.0 - np.abs(y)) * np.where(x >= 0, 1.0, -1.0), x)
    yf = np.where(fold, (1.0 - np.abs(x)) * np.where(y >= 0, 1.0, -1.0), y)
    return np.stack([xf, yf], axis=1) * 0.5 + 0.5


def oct_decode_np(e: np.ndarray) -> np.ndarray:
    """(N, 2) in [0,1] -> (N, 3) unit normals (numpy twin of the jit path)."""
    f = np.asarray(e, np.float32) * 2.0 - 1.0
    x, y = f[:, 0], f[:, 1]
    z = 1.0 - np.abs(x) - np.abs(y)
    t = np.clip(-z, 0.0, 1.0)
    x = x + np.where(x >= 0, -t, t)
    y = y + np.where(y >= 0, -t, t)
    n = np.stack([x, y, z], axis=1)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.where(ln < 1e-20, 1.0, ln)


def quantize_page(rows10: np.ndarray, slab_verts: int):
    """Quantize one cluster page's (nv, 10) f32 vertex rows
    [pos3, nrm3, uv2, pad2] into the planar packed row.

    Returns (packed (3*slab_verts,) u32, dequant (DEQUANT_LANES,) f32).
    """
    nv = rows10.shape[0]
    packed = np.zeros(3 * slab_verts, np.uint32)
    dq = np.zeros(DEQUANT_LANES, np.float32)
    if nv == 0:
        dq[3:6] = 1.0
        return packed, dq
    pos = rows10[:, 0:3].astype(np.float32)
    mn = pos.min(axis=0)
    ext = np.maximum(pos.max(axis=0) - mn, 1e-20)
    q = np.round((pos - mn) / ext * 65535.0).astype(np.uint32)
    oct_ = np.round(oct_encode(rows10[:, 3:6]) * 255.0).astype(np.uint32)
    oct16 = oct_[:, 0] | (oct_[:, 1] << 8)
    uvh = rows10[:, 6:8].astype(np.float16).view(np.uint16).astype(np.uint32)
    packed[0:nv] = q[:, 0] | (q[:, 1] << 16)
    packed[slab_verts:slab_verts + nv] = q[:, 2] | (oct16 << 16)
    packed[2 * slab_verts:2 * slab_verts + nv] = uvh[:, 0] | (uvh[:, 1] << 16)
    dq[0:3] = mn
    dq[3:6] = ext
    return packed, dq


def dequantize_page_np(packed: np.ndarray, dequant: np.ndarray,
                       slab_verts: int) -> np.ndarray:
    """Numpy twin of the device dequant (tests): -> (slab_verts, 8) f32
    [pos3, nrm3, uv2]."""
    w0 = packed[0:slab_verts].astype(np.uint32)
    w1 = packed[slab_verts:2 * slab_verts].astype(np.uint32)
    w2 = packed[2 * slab_verts:3 * slab_verts].astype(np.uint32)
    px = (w0 & 0xFFFF).astype(np.float32) / 65535.0
    py = (w0 >> 16).astype(np.float32) / 65535.0
    pz = (w1 & 0xFFFF).astype(np.float32) / 65535.0
    pos = np.stack([px, py, pz], axis=1) * dequant[3:6] + dequant[0:3]
    oct16 = (w1 >> 16)
    e = np.stack([(oct16 & 255).astype(np.float32) / 255.0,
                  (oct16 >> 8).astype(np.float32) / 255.0], axis=1)
    nrm = oct_decode_np(e)
    uv = np.stack([(w2 & 0xFFFF).astype(np.uint16).view(np.float16),
                   ((w2 >> 16).astype(np.uint16)).view(np.float16)],
                  axis=1).astype(np.float32)
    return np.concatenate([pos, nrm, uv], axis=1)


# ---------------------------------------------------------------------------
# Disk container
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PageBlobHeader:
    num_pages: int
    slab_verts: int
    meshlet_tris: int
    num_groups: int


class PageBlobContainer:
    """Fixed-stride paged binary container with a group locator table.

    File layout (little-endian):
      [0:4]   magic 'BRPB'
      [4:8]   version u32
      [8:12]  header JSON length u32
      [12:..] header JSON (num_pages, slab_verts, meshlet_tris, num_groups)
      geom_group   (G,)   i32   — owning streaming group per page (-1 pinned)
      dequant      (G, 8) f32   — per-page AABB min/extent
      locators     (G, 2) u64   — byte offset + length of each page blob
      page blobs   G x (3*slab_verts) u32 — quantized planar CORNER-MAJOR
                                  vertex pages (row j = corner*meshlet + tri)

    The locator table mirrors the reference's per-page blob locators
    (CLodCache.h) even though this version writes fixed-stride blobs —
    readers must go through it, so variable-size (compressed) blobs are a
    format-compatible future change.
    """

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(12)
            if head[:4] != MAGIC:
                raise ValueError(f"{path}: not a page-blob container")
            version, jlen = struct.unpack("<II", head[4:12])
            if version != VERSION:
                raise ValueError(f"{path}: version {version} != {VERSION}")
            meta = json.loads(f.read(jlen))
        self.header = PageBlobHeader(**meta)
        g = self.header.num_pages
        off = 12 + jlen
        self.geom_group = np.fromfile(path, np.int32, g, offset=off)
        off += 4 * g
        self.dequant = np.fromfile(path, np.float32, g * DEQUANT_LANES,
                                   offset=off).reshape(g, DEQUANT_LANES)
        off += 4 * g * DEQUANT_LANES
        self.locators = np.fromfile(path, np.uint64, g * 2,
                                    offset=off).reshape(g, 2)
        # Page blobs are memory-mapped: the streaming worker reads only the
        # pages it needs (the host never holds the whole geometry set — the
        # DirectStorage-analogue property the host-RAM streamer lacked).
        self._mm = np.memmap(path, np.uint8, mode="r")
        self.group_pages: Dict[int, np.ndarray] = {}
        for grp in np.unique(self.geom_group):
            if grp >= 0:
                self.group_pages[int(grp)] = \
                    np.nonzero(self.geom_group == grp)[0]

    def read_page(self, page: int) -> np.ndarray:
        """(3*slab_verts,) u32 quantized planar page row."""
        off, length = self.locators[page]
        raw = self._mm[int(off):int(off) + int(length)]
        return raw.view(np.uint32).copy()

    @property
    def page_lanes(self) -> int:
        return 3 * self.header.slab_verts


def write_container(path: str, packed_pages: np.ndarray,
                    geom_group: np.ndarray,
                    dequant: np.ndarray, num_groups: int,
                    num_pages: Optional[int] = None) -> None:
    """Serialize the packed scene geometry into a page-blob container.

    packed_pages: (G, 3*SLAB) u32 corner-major quantized pages;
    geom_group: (G,) i32; dequant: (G, 8) f32.
    """
    g = int(num_pages if num_pages is not None else packed_pages.shape[0])
    slab3 = packed_pages.shape[1]
    meta = {"num_pages": g, "slab_verts": slab3 // 3,
            "meshlet_tris": slab3 // 9, "num_groups": int(num_groups)}
    blob = json.dumps(meta).encode()
    page_bytes = 4 * slab3
    fixed = 12 + len(blob) + 4 * g + 4 * g * DEQUANT_LANES + 16 * g
    locs = np.empty((g, 2), np.uint64)
    locs[:, 0] = fixed + np.arange(g, dtype=np.uint64) * page_bytes
    locs[:, 1] = page_bytes
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC + struct.pack("<II", VERSION, len(blob)) + blob)
        np.ascontiguousarray(geom_group[:g], np.int32).tofile(f)
        np.ascontiguousarray(dequant[:g], np.float32).tofile(f)
        locs.tofile(f)
        np.ascontiguousarray(packed_pages[:g], np.uint32).tofile(f)
    os.replace(tmp, path)
