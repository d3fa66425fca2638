"""Geometry streaming: page pool + LRU + async worker + the frame-driven
GeometryStreamer.

Port of basicrenderer_tpu/models/streaming.py (reference: PagePool.h,
CLodStreamingSystem.h:100-118 — the fixed page slab, the streaming worker
thread with its priority queue, budgeted loads and LRU eviction). The host
logic is the JAX package's, unchanged: the parent-chain closure of the
wanted groups, parents-first loads, the LRU that never evicts a group
with a resident child, the pinned `group == -1` pages.

The device slabs are tensors on `device` (the card unless the caller names
another). Pages are u32 words, kept as int32 tensors holding the same
bits (graph/framedata.py). An update's page uploads are spliced at once:
one host-to-device copy of the stacked rows (from pinned memory on the
card) and one out-of-place `index_copy` per slab, so the tables a frame
already holds keep the content they were made for until the caller
splices the new ones in (the JAX package's functional `.at[].set`).
"""

from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .pageblob import DEQUANT_LANES


def host_to_device(a: np.ndarray, device) -> torch.Tensor:
    """A copy of host array `a` on `device` (u32 as int32 bits): through
    pinned memory on the card, a private copy on the CPU."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    t = torch.from_numpy(a.copy())
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@dataclasses.dataclass
class PageSlot:
    key: int = -1            # content key resident in this slot (-1 free)
    generation: int = 0      # bumps on every (re)assignment
    last_used: float = 0.0   # LRU timestamp


class PagePool:
    """Fixed-capacity device page slab with host-side LRU bookkeeping."""

    def __init__(self, num_pages: int, page_rows: int, row_lanes: int,
                 dtype=torch.float32, device="cuda"):
        self.num_pages = num_pages
        self.page_rows = page_rows
        self.slab = torch.zeros((num_pages * page_rows, row_lanes),
                                dtype=dtype, device=device)
        self.slots: List[PageSlot] = [PageSlot() for _ in range(num_pages)]
        self.key_to_slot: Dict[int, int] = {}

    # -- queries -------------------------------------------------------------
    def is_resident(self, key: int) -> bool:
        return key in self.key_to_slot

    def slot_of(self, key: int) -> int:
        return self.key_to_slot.get(key, -1)

    def touch(self, key: int) -> None:
        s = self.key_to_slot.get(key)
        if s is not None:
            self.slots[s].last_used = time.monotonic()

    def residency_mask(self, num_keys: int) -> np.ndarray:
        m = np.zeros(num_keys, bool)
        for k in self.key_to_slot:
            if 0 <= k < num_keys:
                m[k] = True
        return m

    def slot_table(self, num_keys: int) -> np.ndarray:
        """(num_keys,) i32 key -> slot (-1 non-resident): the page map the
        frame translates through (reference: MeshManager.h:50-63)."""
        t = np.full(num_keys, -1, np.int32)
        for k, s in self.key_to_slot.items():
            if 0 <= k < num_keys:
                t[k] = s
        return t

    # -- mutation --------------------------------------------------------------
    def upload(self, key: int, rows: np.ndarray) -> int:
        """Load page content into a slot (evicting LRU if full). Returns slot."""
        if key in self.key_to_slot:
            slot = self.key_to_slot[key]
        else:
            slot = self._alloc()
            old = self.slots[slot].key
            if old >= 0:
                del self.key_to_slot[old]
            self.key_to_slot[key] = slot
            self.slots[slot].key = key
            self.slots[slot].generation += 1
        self.slots[slot].last_used = time.monotonic()
        if len(rows) < self.page_rows:
            pad = np.zeros((self.page_rows - len(rows), rows.shape[1]),
                           rows.dtype)
            rows = np.concatenate([rows, pad])
        at = slot * self.page_rows
        slab = self.slab.clone()
        slab[at:at + self.page_rows] = host_to_device(
            rows[:self.page_rows], slab.device).to(slab.dtype)
        self.slab = slab
        return slot

    def evict(self, key: int) -> None:
        slot = self.key_to_slot.pop(key, None)
        if slot is not None:
            self.slots[slot].key = -1

    def _alloc(self) -> int:
        for i, s in enumerate(self.slots):
            if s.key < 0:
                return i
        # LRU eviction.
        return min(range(self.num_pages), key=lambda i: self.slots[i].last_used)


class StreamingWorker:
    """Background loader thread with a priority queue (StreamingWorkerMain
    analogue). `loader(key) -> np.ndarray rows` pulls page content (disk /
    cache / builder); results are uploaded into the pool on the worker."""

    def __init__(self, pool, loader: Callable[[int], np.ndarray],
                 budget_per_tick: int = 8):
        self.pool = pool
        self.loader = loader
        self.budget = budget_per_tick
        self._queue: List[Tuple[float, int]] = []
        self._queued: set = set()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._completed: List[int] = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def request(self, key: int, priority: float = 0.0) -> None:
        """Lower priority value = more urgent (reference: CLodPriorityMode)."""
        with self._lock:
            if key in self._queued or self.pool.is_resident(key):
                return
            heapq.heappush(self._queue, (priority, key))
            self._queued.add(key)
        self._wake.set()

    def drain_completed(self) -> List[int]:
        """Keys that finished loading since the last call (reference:
        DrainCompletedCLodDiskStreamingGroups, MeshManager.h:133)."""
        with self._lock:
            out, self._completed = self._completed, []
        return out

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def stop(self) -> None:
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=5)

    def _run(self) -> None:
        while not self._stop:
            self._wake.wait(timeout=0.05)
            self._wake.clear()
            for _ in range(self.budget):
                with self._lock:
                    if not self._queue:
                        break
                    _prio, key = heapq.heappop(self._queue)
                    self._queued.discard(key)
                rows = self.loader(key)
                self.pool.upload(key, rows)
                with self._lock:
                    self._completed.append(key)


class _StagingPool:
    """Adapter so StreamingWorker can stage loaded blobs into a host dict:
    the worker thread does the DISK read (the slow part); the device
    upload happens in the streamer's update."""

    def __init__(self, staged: Dict[int, np.ndarray]):
        self._staged = staged

    def is_resident(self, key: int) -> bool:
        return key in self._staged

    def upload(self, key: int, rows: np.ndarray) -> int:
        self._staged[key] = rows
        return 0


class GeometryStreamer:
    """Frame-integrated geometry streaming: cluster vertex PAGES move
    between the host (the packed arrays, or a page-blob container on disk)
    and a fixed device slab, driven by the frame's touched-group feedback.

    Reference analogue: CLodStreamingSystem (CLodStreamingSystem.cpp:
    986-1258). Pages with group -1 (top LOD levels + non-LOD meshes) are
    PINNED at init: the cut can always fall back to them, so streaming
    misses coarsen, never hole.
    """

    def __init__(self, packed=None, max_groups: int = 0, num_slots: int = 0,
                 loads_per_update: int = 16, container=None, device="cuda"):
        """Source is EITHER `packed` (host PackedGeometry arrays) or
        `container` (a pageblob.PageBlobContainer — pages pulled from disk
        on a background IO thread)."""
        self.device = torch.device(device)
        # Parent-chain adjacency: group g's parents are the groups its
        # OUTPUT clusters feed. Residency stays DOWNWARD-CLOSED along the
        # chains (a fine group resident under a missing intermediate one
        # would let the coarse ancestor's eff_self=0 fallback render on
        # top of the fine cut): update() expands wants to the ancestor
        # closure, _load_group defers until the parents are resident, and
        # _evict_one never evicts a group with a resident child.
        self.group_parents: Dict[int, list] = {}
        self.group_children: Dict[int, List[int]] = {}
        if packed is not None and getattr(packed, "cluster_feeds", None) \
                is not None:
            feeds = np.asarray(packed.cluster_feeds)
            made = np.asarray(packed.cluster_made)
            ok = (made >= 0) & (feeds >= 0) & (made != feeds)
            pairs = np.unique(np.stack([made[ok], feeds[ok]], 1), axis=0)
            for g, p in pairs:
                self.group_parents.setdefault(int(g), []).append(int(p))
                self.group_children.setdefault(int(p), []).append(int(g))
        # Chain depth (coarse roots = 0): loads within one tick run
        # parents-first so a whole missing chain streams in one update.
        self.group_depth: Dict[int, int] = {}

        def depth(g, seen=()):
            if g in self.group_depth:
                return self.group_depth[g]
            ps = self.group_parents.get(g, [])
            d = 0 if not ps else 1 + max(
                depth(p) for p in ps if p not in seen)
            self.group_depth[g] = d
            return d

        for g in list(self.group_parents) + list(self.group_children):
            depth(g)
        self.container = container
        if container is not None:
            self.geom_group = container.geom_group
            self.dq_full = container.dequant
            self.v_full = None                      # pages live on disk
            v_lanes = container.page_lanes
            G = container.header.num_pages
            self.group_pages = dict(container.group_pages)
        else:
            self.v_full = packed.cluster_verts      # (G, SLAB*3) u32 host
            self.dq_full = packed.cluster_dequant   # (G, 8) f32 host
            self.geom_group = packed.geom_group     # (G,) host
            v_lanes = self.v_full.shape[1]
            G = self.v_full.shape[0]
            self.group_pages = {}
            for g in np.unique(self.geom_group):
                if g >= 0:
                    self.group_pages[int(g)] = \
                        np.nonzero(self.geom_group == g)[0]
        self.max_groups = max_groups
        self.loads_per_update = loads_per_update
        pinned = np.nonzero(self.geom_group == -1)[0]
        if len(pinned) > num_slots:
            raise ValueError(
                f"streaming slab too small: {len(pinned)} pinned pages "
                f"> {num_slots} slots")
        self.num_slots = num_slots
        self.geom_slot = np.full(G, -1, np.int32)
        self.resident = np.zeros(max_groups, bool)
        self.group_slots: Dict[int, np.ndarray] = {}   # group -> its slots
        self.last_touch: Dict[int, int] = {}
        self.tick = 0
        self.loads = 0
        self.evictions = 0
        self._free = list(range(num_slots))[::-1]
        self.slab_v = torch.zeros((num_slots, v_lanes), dtype=torch.int32,
                                  device=self.device)
        self.slab_dq = torch.zeros((num_slots, DEQUANT_LANES),
                                   dtype=torch.float32, device=self.device)
        self._pending = []               # [(slot, v_row, dq_row)]
        # Disk mode: an IO worker prefetches requested groups' page bytes
        # into a host staging dict; update() uploads staged groups. The
        # frame loop never blocks on disk (reference: StreamingWorkerMain).
        self._staged: Dict[int, np.ndarray] = {}
        self._io: Optional[StreamingWorker] = None
        if container is not None:
            self._io = StreamingWorker(_StagingPool(self._staged),
                                       self._read_group_pages,
                                       budget_per_tick=16)
        # Pin the always-resident pages (disk mode reads them synchronously
        # once at init — cold start, before any frame runs).
        for p in pinned:
            s = self._free.pop()
            self.geom_slot[p] = s
            self._upload(int(p), s)
        self._flush_uploads()

    def _read_group_pages(self, g: int) -> np.ndarray:
        """IO-thread loader: (n_pages, lanes) u32 for group g from disk."""
        pages = self.group_pages[g]
        return np.stack([self.container.read_page(int(p)) for p in pages])

    def _page_rows(self, page: int) -> np.ndarray:
        if self.v_full is not None:
            return self.v_full[page:page + 1]
        return self.container.read_page(page)[None, :]

    def _upload(self, page: int, slot: int, rows: np.ndarray = None) -> None:
        if rows is None:
            rows = self._page_rows(page)
        self._pending.append((slot, rows[0], self.dq_full[page]))
        self.loads += 1

    def _flush_uploads(self) -> None:
        """Splice every pending page: one host-to-device copy per slab and
        one out-of-place index_copy into it."""
        if not self._pending:
            return
        slots = host_to_device(
            np.asarray([p[0] for p in self._pending], np.int64), self.device)
        rows_v = host_to_device(
            np.stack([np.asarray(p[1], np.uint32) for p in self._pending]),
            self.device)
        rows_dq = host_to_device(
            np.stack([np.asarray(p[2], np.float32) for p in self._pending]),
            self.device)
        self.slab_v = self.slab_v.index_copy(0, slots, rows_v)
        self.slab_dq = self.slab_dq.index_copy(0, slots, rows_dq)
        self._pending.clear()

    def _load_group(self, g: int) -> bool:
        pages = self.group_pages.get(g)
        if pages is None:
            return False
        # Downward-closed residency: defer until every chain parent is in
        # (update() orders loads parents-first, so within one tick the
        # whole chain streams unless the budget runs out).
        for p in self.group_parents.get(g, ()):
            if not self.resident[p]:
                return False
        rows_stack = None
        if self.container is not None:
            # Disk mode: only consume groups the IO thread has staged;
            # otherwise queue the read and come back next frame.
            rows_stack = self._staged.pop(g, None)
            if rows_stack is None:
                self._io.request(g, priority=-float(self.tick))
                return False
        while len(self._free) < len(pages):
            if not self._evict_one(protect=g):
                return False
        slots = []
        for j, p in enumerate(pages):
            s = self._free.pop()
            self.geom_slot[p] = s
            self._upload(int(p), s,
                         rows=None if rows_stack is None
                         else rows_stack[j:j + 1])
            slots.append(s)
        self.group_slots[g] = np.asarray(slots, np.int32)
        self.resident[g] = True
        return True

    def _evict_one(self, protect: int) -> bool:
        # Leaf-first: a group with any resident child is not evictable
        # (downward-closed residency invariant, see __init__).
        cands = [g for g in self.group_slots
                 if g != protect
                 and not any(self.resident[c]
                             for c in self.group_children.get(g, ()))]
        if not cands:
            return False
        victim = min(cands, key=lambda g: self.last_touch.get(g, -1))
        for s in self.group_slots.pop(victim):
            self._free.append(int(s))
        for p in self.group_pages[victim]:
            self.geom_slot[p] = -1
        self.resident[victim] = False
        self.evictions += 1
        return True

    def update(self, touched: np.ndarray):
        """Feed one frame's touched-group feedback; returns the device
        tensors (slab_v, slab_dq, geom_slot, group_resident) to splice into
        SceneBuffers (cluster_verts, cluster_dequant, geom_slot,
        group_resident). `touched` is either a bool mask or an f32 PRIORITY
        array (ops/clod.touched_groups — reference: CLodPriorityMode
        Max/Sum): when the per-frame load budget is short, the most
        oversized groups stream first."""
        self.tick += 1
        # Expand wants to the ancestor closure (parents-first order).
        # Ancestors inherit the max priority of any descendant that wants
        # them.
        t = np.asarray(touched[:self.max_groups], np.float32)
        pri = {int(g): float(t[g]) for g in np.nonzero(t > 0)[0]}
        stack = list(pri)
        while stack:
            g = stack.pop()
            for p in self.group_parents.get(g, ()):
                if pri.get(p, 0.0) < pri[g]:
                    pri[p] = pri[g]
                    stack.append(p)
        # Parents-first (chain consistency), most-urgent-first within a
        # depth level (budget goes to the worst screen error).
        want = sorted(pri, key=lambda g: (self.group_depth.get(g, 0),
                                          -pri[g]))
        for g in want:
            self.last_touch[g] = self.tick
        budget = self.loads_per_update
        for g in want:
            if self.resident[g]:
                continue
            if budget <= 0:
                break
            if self._load_group(g):
                budget -= 1
        self._flush_uploads()
        return (self.slab_v, self.slab_dq,
                host_to_device(self.geom_slot, self.device),
                host_to_device(self.resident, self.device))

    def stop(self) -> None:
        if self._io is not None:
            self._io.stop()

    @property
    def resident_groups(self) -> int:
        return int(self.resident.sum())
