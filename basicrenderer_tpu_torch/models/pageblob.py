"""Quantized cluster vertex pages.

Port of the page quantization of basicrenderer_tpu/models/pageblob.py
(the disk page-blob container is streaming work and is not ported). A
page row is PLANAR: three contiguous SLAB-lane u32 blocks [px|py, pz|oct,
u|v], each word holding two 16-bit values: positions quantized to 16 bits
in the page's AABB, octahedral normals as two 8-bit values, UVs as half
floats. The setup path (ops/raster_setup.triangle_setup_clustered) undoes
the quantization per corner column.
"""

from __future__ import annotations

import numpy as np

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

