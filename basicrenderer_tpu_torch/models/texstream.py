"""Texture streaming: mip-granular residency over the strip atlas, driven
by sampler feedback.

Port of basicrenderer_tpu/models/texstream.py (the container's byte format
is the JAX package's, so a container either package writes opens in the
other):

- The strip atlas (models/textures.py strip_pyramid) stays a fixed-shape
  device tensor; streaming manages its CONTENT. Each texture starts with
  only its coarse mips uploaded; finer mip rows stream in from a disk
  container (np.memmap) on the background StreamingWorker thread.
- Residency is advertised per texture as a FINEST-RESIDENT-MIP field in
  bits 1-5 of the texture's flag word; the samplers clamp their mip to it
  (ops/textures.py), so misses degrade to the resident coarse content.
- Feedback: ops/textures.wanted_mips reduces the frame's per-pixel mip
  demand to a per-texture finest-wanted mip; the renderer reads it back
  (pipelined, like the geometry touched groups) and calls update(). A
  fine-row budget bounds the resident fine content; LRU textures demote
  (their min mip rises) when the budget is exceeded.

The atlas is an int32 tensor holding the u32 words on `device` (the card
unless the caller names another). An update that loads makes a new atlas
tensor (the frames already queued keep reading the old one).
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.textures import mip_layout, strip_layout
from .streaming import StreamingWorker, _StagingPool, host_to_device
from .textures import FLAG_SRGB

MAGIC = b"BRTS"
VERSION = 1


def save_strip_container(path: str, strips: np.ndarray, flags: np.ndarray,
                         resolution: int) -> None:
    """Write the full strip atlas to a disk container the streamer memmaps.
    Header: magic, version, N layers, resolution; then flags (N,) i32 and
    strips (N*rows, 128) u32 raw."""
    n = flags.shape[0]
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<III", VERSION, n, resolution))
        f.write(np.asarray(flags, np.int32).tobytes())
        f.write(np.ascontiguousarray(strips).view(np.uint32).tobytes())


class TextureStreamContainer:
    """Disk-backed strip atlas (np.memmap reads happen on the streaming
    worker thread)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            head = f.read(16)
        if head[:4] != MAGIC:
            raise ValueError(f"{path}: not a texture stream container")
        version, n, resolution = struct.unpack("<III", head[4:16])
        if version != VERSION:
            raise ValueError(f"{path}: version {version} != {VERSION}")
        self.num_layers = n
        self.resolution = resolution
        self.flags = np.fromfile(path, np.int32, n, offset=16)
        _, self.rows_per_layer = strip_layout(resolution)
        self.strips = np.memmap(path, np.uint32, mode="r",
                                offset=16 + 4 * n,
                                shape=(n * self.rows_per_layer, 128))

    def read_mip_rows(self, layer: int, mip: int) -> Tuple[int, np.ndarray]:
        """(device row offset, rows) of one mip of one layer."""
        sizes, _ = mip_layout(self.resolution)
        offs, rpl = strip_layout(self.resolution)
        sz = sizes[mip]
        nrows = sz if sz <= 128 else (sz // 64 - 1) * sz
        base = layer * rpl + offs[mip]
        return base, np.array(self.strips[base:base + nrows])


class TextureStreamer:
    """Feedback-driven mip streaming over the device strip atlas."""

    def __init__(self, container: TextureStreamContainer,
                 coarse_mip: Optional[int] = None,
                 fine_row_budget: int = 1 << 14,
                 loads_per_update: int = 4, device="cuda"):
        self.c = container
        self.device = torch.device(device)
        sizes, _ = mip_layout(container.resolution)
        self.offs, self.rpl = strip_layout(container.resolution)
        self.sizes = sizes
        self.M = len(sizes)
        # Default coarse tier: mips of edge <= 32 stay always-resident.
        if coarse_mip is None:
            coarse_mip = next((i for i, s in enumerate(sizes) if s <= 32),
                              self.M - 1)
        self.coarse_mip = coarse_mip
        self.budget = fine_row_budget
        self.loads_per_update = loads_per_update
        n = container.num_layers
        self.resident_mip = np.full(n, coarse_mip, np.int32)
        self.last_touch = np.zeros(n, np.int64)
        self.tick = 0
        self.loads = 0
        self.demotions = 0
        self.fine_rows = 0
        # Device atlas: the coarse tier uploaded at init (one synchronous
        # read per layer — cold start, before any frame).
        strips = np.zeros((n * self.rpl, 128), np.uint32)
        for layer in range(n):
            for m in range(coarse_mip, self.M):
                base, rows = container.read_mip_rows(layer, m)
                strips[base:base + len(rows)] = rows
        self.strips = host_to_device(strips, self.device)
        # IO thread stages requested (layer, mip) rows into a host dict.
        self._staged: Dict[int, np.ndarray] = {}
        self._io = StreamingWorker(_StagingPool(self._staged), self._read_key,
                                   budget_per_tick=8)

    def _key(self, layer: int, mip: int) -> int:
        return layer * 64 + mip

    def _read_key(self, key: int) -> np.ndarray:
        return self.c.read_mip_rows(key // 64, key % 64)[1]

    def _mip_rows(self, mip: int) -> int:
        sz = self.sizes[mip]
        return sz if sz <= 128 else (sz // 64 - 1) * sz

    def flags_device(self) -> torch.Tensor:
        """(N,) i32 flag words: sRGB bit + finest-resident mip bits 1-5."""
        return host_to_device((self.c.flags & FLAG_SRGB)
                              | (self.resident_mip << 1), self.device)

    def update(self, wanted: np.ndarray):
        """Feed one frame's per-texture finest-wanted mips (N,) — values
        >= M mean 'not sampled'. Returns (strips, flags) device tensors."""
        self.tick += 1
        n = self.c.num_layers
        wanted = np.minimum(np.asarray(wanted[:n], np.int32), self.M)
        touched = wanted < self.M
        self.last_touch[touched] = self.tick
        # Promote the most-recently-touched under-resident textures, one
        # mip level per update each (finer mips stream progressively).
        order = np.argsort(-self.last_touch)
        budget = self.loads_per_update
        strips = None
        for layer in order:
            if budget <= 0:
                break
            if wanted[layer] >= self.resident_mip[layer]:
                continue
            m = int(self.resident_mip[layer]) - 1
            need = self._mip_rows(m)
            while self.fine_rows + need > self.budget:
                if not self._demote_one(protect=int(layer)):
                    need = None
                    break
            if need is None:
                break
            key = self._key(int(layer), m)
            rows = self._staged.pop(key, None)
            if rows is None:
                self._io.request(key, priority=-float(self.tick))
                continue
            base = int(layer) * self.rpl + self.offs[m]
            if strips is None:
                strips = self.strips.clone()
            strips[base:base + len(rows)] = host_to_device(rows, self.device)
            self.resident_mip[layer] = m
            self.fine_rows += need
            self.loads += 1
            budget -= 1
        if strips is not None:
            self.strips = strips
        return self.strips, self.flags_device()

    def _demote_one(self, protect: int) -> bool:
        """Raise the LRU texture's min mip one level, freeing its finest
        resident rows (content stays in place; the flag clamp makes it
        unreadable, so no device write is needed)."""
        cands = [l for l in range(self.c.num_layers)
                 if l != protect and self.resident_mip[l] < self.coarse_mip]
        if not cands:
            return False
        victim = min(cands, key=lambda l: self.last_touch[l])
        self.fine_rows -= self._mip_rows(int(self.resident_mip[victim]))
        self.resident_mip[victim] += 1
        self.demotions += 1
        return True

    def stop(self):
        self._io.stop()
