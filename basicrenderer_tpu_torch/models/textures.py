"""Texture registry + the strip-layout atlas the block-window sampler reads.

Port of basicrenderer_tpu/models/textures.py. All textures
share one square power-of-two resolution; every mip row of every layer is
stored as 128-texel strips of RGBA8 texels packed into one 32-bit word
(R | G<<8 | B<<16 | A<<24), at x phases 0, 64, ... so that any 128-wide x
window whose base is 64-aligned is one row (ops/textures.strip_layout).
Color data is stored sRGB8 and decoded after the tap; data textures
(normals, metallic-roughness) are stored linear; a per-layer flag word
tells the sampler which.

`strip_pyramid(fmt="bc3")` stores the same mips BC3-compressed at rest:
one strip row is 32 BC3 blocks, a 128-texel x window by 4 texel rows
(ops/textures.strip_layout_bc), encoded by models/texprocess.py and
decoded by the sampler.

A layer added with `alpha_cutoff >= 0` (an alpha-MASK material's base
colour) gets coverage-preserving mips: each half-resolution level's alpha
is scaled so that the share of texels above the cutoff stays that of
level 0 (models/texprocess.alpha_coverage_scale), in both formats.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..ops.textures import mip_layout, strip_layout, strip_layout_bc
from .texprocess import alpha_coverage_scale, bc3_encode

FLAG_SRGB = 1


class TextureRegistry:
    def __init__(self, resolution: int = 256, processed_cache=None):
        self.resolution = resolution
        self.images: List[np.ndarray] = []   # (R, R, 4) f32 LINEAR
        self.srgb: List[bool] = []           # stored-encoding flag per layer
        self.alpha_cutoffs: List[float] = []  # >=0: MASK coverage-fix mips
        # Optional texprocess.ProcessedTextureCache the importers route
        # image bytes through (decode+resize+BC skip on hit).
        self.processed_cache = processed_cache

    def add(self, image: np.ndarray, srgb: bool = True,
            alpha_cutoff: float = -1.0) -> int:
        """Register an (H, W, 3|4) uint8/float image; returns texture id.
        `srgb=True` marks color data (decoded to linear here, re-encoded
        sRGB8 in the atlas); False marks data textures (normals, ORM).
        `alpha_cutoff >= 0` marks an alpha-MASK layer whose mip chain gets
        coverage-preserving alpha scaling (texprocess)."""
        img = np.asarray(image)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
            if srgb:
                img = np.where(img <= 0.04045, img / 12.92,
                               ((img + 0.055) / 1.055) ** 2.4)
        img = img.astype(np.float32)
        if img.ndim == 2:
            img = img[..., None].repeat(3, -1)
        if img.shape[-1] == 3:
            img = np.concatenate([img, np.ones_like(img[..., :1])], -1)
        self.images.append(_resize(img, self.resolution))
        self.srgb.append(bool(srgb))
        self.alpha_cutoffs.append(float(alpha_cutoff))
        return len(self.images) - 1

    def _downsample(self, level: np.ndarray, sz: int, layer: int
                    ) -> np.ndarray:
        """Half-res box filter (linear space) + alpha-coverage fix for MASK
        layers."""
        out = level.reshape(sz // 2, 2, sz // 2, 2, 4).mean((1, 3))
        cutoff = self.alpha_cutoffs[layer]
        if cutoff >= 0.0:
            ref = float(np.mean(self.images[layer][..., 3] > cutoff))
            s = alpha_coverage_scale(out[..., 3], cutoff, ref)
            out = out.copy()
            out[..., 3] = np.minimum(out[..., 3] * s, 1.0)
        return out

    def checkerboard(self, a=(0.9, 0.9, 0.9), b=(0.2, 0.2, 0.2),
                     squares: int = 8) -> int:
        r = self.resolution
        yy, xx = np.mgrid[0:r, 0:r]
        mask = ((yy * squares // r) + (xx * squares // r)) % 2 == 0
        img = np.where(mask[..., None], np.asarray(a, np.float32),
                       np.asarray(b, np.float32))
        return self.add(np.concatenate([img, np.ones((r, r, 1), np.float32)], -1),
                        srgb=False)

    def strip_pyramid(self, capacity: Optional[int] = None,
                      fmt: str = "rgba8"
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Strip-layout atlas: (strips (N * ROWS, 128) uint32, flags (N,)
        int32), rows laid out by ops/textures.strip_layout(resolution).
        Mips of at most 128 texels tile x to fill the strip (wrap
        addressing for REPEAT sampling); wider mips store one strip per
        64-texel phase. fmt="bc3" stores BC3 block rows instead (layout
        strip_layout_bc): 4x fewer bytes at rest and per window gather."""
        if fmt == "bc3":
            return self._strip_pyramid_bc3(capacity)
        if fmt != "rgba8":
            raise ValueError(f"unknown texture atlas format {fmt!r}")
        n = capacity or max(len(self.images), 1)
        r = self.resolution
        sizes, _offsets = mip_layout(r)
        row_of_mip, rows_per_layer = strip_layout(r)
        strips = np.full((n * rows_per_layer, 128), 0xFFFFFFFF, np.uint32)
        flags = np.zeros((n,), np.int32)
        for i in range(min(len(self.images), n)):
            out = strips[i * rows_per_layer:(i + 1) * rows_per_layer]
            level = self.images[i]
            for m, sz in enumerate(sizes):
                packed = _pack_rgba8(level, self.srgb[i])   # (sz, sz)
                base = row_of_mip[m]
                if sz <= 128:
                    out[base:base + sz] = np.tile(packed, (1, 128 // sz))
                else:
                    for ph in range(sz // 64 - 1):
                        out[base + ph * sz: base + (ph + 1) * sz] = \
                            packed[:, ph * 64: ph * 64 + 128]
                if sz > sizes[-1]:
                    level = self._downsample(level, sz, i)
            flags[i] = FLAG_SRGB if self.srgb[i] else 0
        return strips, flags

    def _strip_pyramid_bc3(self, capacity: Optional[int] = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """BC3 strip atlas: (strips (N * ROWS, 128) uint32, flags (N,)
        int32), rows by strip_layout_bc(resolution). Each row holds 32
        blocks interleaved [a_lo, a_hi, c_ends, c_idx]; mips below 4
        texels wrap-fill one block row."""
        n = capacity or max(len(self.images), 1)
        r = self.resolution
        sizes, _offsets = mip_layout(r)
        row_of_mip, rows_per_layer = strip_layout_bc(r)
        strips = np.zeros((n * rows_per_layer, 128), np.uint32)
        flags = np.zeros((n,), np.int32)

        def band_rows(band_u8: np.ndarray) -> np.ndarray:
            """(4*R, 128, 4) u8 texel band -> (R, 128) u32 block rows."""
            blocks = bc3_encode(band_u8)                 # (R*32, 16) u8
            return np.ascontiguousarray(blocks).view('<u4').reshape(-1, 128)

        for i in range(min(len(self.images), n)):
            out = strips[i * rows_per_layer:(i + 1) * rows_per_layer]
            level = self.images[i]
            for m, sz in enumerate(sizes):
                img8 = _quant_rgba8(level, self.srgb[i])  # (sz, sz, 4) u8
                base = row_of_mip[m]
                nbr = max(sz // 4, 1)
                if sz <= 128:
                    ys = np.arange(4 * nbr) % sz          # wrap-fill tiny
                    xs = np.arange(128) % sz              # mips, tile x
                    out[base:base + nbr] = band_rows(img8[ys][:, xs])
                else:
                    for ph in range(sz // 64 - 1):
                        out[base + ph * nbr: base + (ph + 1) * nbr] = \
                            band_rows(img8[:, ph * 64: ph * 64 + 128])
                if sz > sizes[-1]:
                    level = self._downsample(level, sz, i)
            flags[i] = FLAG_SRGB if self.srgb[i] else 0
        return strips, flags

    def __len__(self):
        return len(self.images)


def _quant_rgba8(img: np.ndarray, srgb: bool) -> np.ndarray:
    """(H, W, 4) f32 linear -> (H, W, 4) uint8, rgb sRGB-encoded when
    flagged."""
    rgb = img[..., :3]
    if srgb:
        rgb = np.where(rgb <= 0.0031308, rgb * 12.92,
                       1.055 * np.maximum(rgb, 1e-8) ** (1 / 2.4) - 0.055)
    return np.clip(np.concatenate([rgb, img[..., 3:]], -1) * 255.0 + 0.5,
                   0, 255).astype(np.uint8)


def _pack_rgba8(img: np.ndarray, srgb: bool) -> np.ndarray:
    """(H, W, 4) f32 linear -> (H, W) uint32 packed (R | G<<8 | B<<16 | A<<24),
    rgb sRGB-encoded when flagged."""
    q = _quant_rgba8(img, srgb).astype(np.uint32)
    return q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (q[..., 3] << 24)


def _resize(img: np.ndarray, r: int) -> np.ndarray:
    """Resize to (r, r): box binning when downscaling by an integer factor,
    nearest otherwise."""
    h, w = img.shape[:2]
    if (h, w) == (r, r):
        return img
    if h >= r and w >= r and h % r == 0 and w % r == 0:
        return img.reshape(r, h // r, r, w // r, -1).mean((1, 3))
    ys = (np.arange(r) * (h / r)).astype(np.int32).clip(0, h - 1)
    xs = (np.arange(r) * (w / r)).astype(np.int32).clip(0, w - 1)
    return img[ys][:, xs]
