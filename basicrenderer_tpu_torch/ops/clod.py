"""Runtime cluster-LOD selection (the DAG cut) and visible-cluster
compaction.

Port of basicrenderer_tpu/ops/clod.py: `select_cluster_cut`,
`compact_visible_tris` (with `_compact_from_slots`), the budgeted window
cut `cut_slots_windowed`, `slot_world_spheres` and the streaming feedback
`touched_groups`. Because the error metric is monotonic along every
DAG path, a cluster belongs to the cut iff

    screen_err(self_error)  <= tau  <  screen_err(parent_error)

which is one vectorized pass over the fixed-capacity cluster table. The
compaction then gathers the cut's clusters into a fixed budget of
`max_visible` slots of 128 triangles, so everything downstream (setup,
bin, raster) scales with the budget and not with the LOD soup.

Everything is fixed-shape and free of host synchronisation. The JAX
package's one-hot matmul row lookups are plain indexing here: both are
exact. Its broadcast-compare group reduction in `touched_groups` is a
`scatter_reduce` here (see there).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..graph.framedata import FrameConfig, SceneBuffers, ViewData
from ..models.clusters import CLUSTER_STRIDE
from ..utils import math3d
from .raster_setup import dot3


class CompactedTris(NamedTuple):
    """Visible-cluster triangle compaction (fixed budget Kc x 128)."""
    indices: torch.Tensor    # (Kt, 3) i32 global vertex ids
    material: torch.Tensor   # (Kt,) i32
    object: torch.Tensor     # (Kt,) i32
    valid: torch.Tensor      # (Kt,) bool
    overflow: torch.Tensor   # () i32 clusters dropped over budget
    geom: torch.Tensor       # (Kc,) i32 geometry-cluster page ids
    slot_cluster: torch.Tensor  # (Kc,) i32 cluster id (-1 dead)
    slot_object: torch.Tensor   # (Kc,) i32 owning object
    slot_bound: torch.Tensor    # (Kc, 4) f32 tight object-space sphere


def _object_rows(scene: SceneBuffers, obj: torch.Tensor):
    """Per-row model matrices (N, 16) and their largest axis scale (N,)."""
    m = scene.object_mats.reshape(-1, 16)[obj.long()]
    scale = torch.sqrt(torch.maximum(
        torch.maximum(m[:, 0] ** 2 + m[:, 4] ** 2 + m[:, 8] ** 2,
                      m[:, 1] ** 2 + m[:, 5] ** 2 + m[:, 9] ** 2),
        m[:, 2] ** 2 + m[:, 6] ** 2 + m[:, 10] ** 2))
    return m, scale


def _screen_error_factor(view: ViewData, height: int) -> torch.Tensor:
    """World-space error -> on-screen pixels ~ err * f / dist, with
    f = proj[1,1] * height / 2 (the perspective scale)."""
    return view.proj[1, 1] * (height * 0.5)


def _world_point(m, px, py, pz):
    return (m[:, 0] * px + m[:, 1] * py + m[:, 2] * pz + m[:, 3],
            m[:, 4] * px + m[:, 5] * py + m[:, 6] * pz + m[:, 7],
            m[:, 8] * px + m[:, 9] * py + m[:, 10] * pz + m[:, 11])


def select_cluster_cut(scene: SceneBuffers, view: ViewData, config: FrameConfig,
                       tau_px: torch.Tensor,
                       object_visible: Optional[torch.Tensor] = None,
                       frustum: bool = True, return_bounds: bool = False
                       ) -> Tuple[torch.Tensor, ...]:
    """Returns (selected (C,) bool, num_selected () i32); with
    `return_bounds` also the world-space tight cluster spheres
    (center_w (C, 3), radius_w (C,)).

    Cluster bounds and errors are object-space; each cluster is
    transformed by its owning object's matrix and tested against the
    camera. Self and parent errors project with their own group spheres
    (lanes 0-3 and 12-15), so both sides of a LOD switch compute the same
    threshold; culling uses the tight sphere (lanes 16-19)."""
    tbl = scene.cluster_table
    C = tbl.shape[0]
    dev = tbl.device
    m, scale = _object_rows(scene, scene.cluster_object)
    f = _screen_error_factor(view, config.height)
    cam = view.cam_pos

    def project_px(center_l, radius_l, err_l):
        wx, wy, wz = _world_point(m, center_l[:, 0], center_l[:, 1],
                                  center_l[:, 2])
        rw = radius_l * scale
        dist = torch.sqrt((wx - cam[0]) ** 2 + (wy - cam[1]) ** 2
                          + (wz - cam[2]) ** 2)
        dist = torch.maximum(dist - rw, view.near)
        return err_l * scale * f / dist, torch.stack([wx, wy, wz], -1), rw

    self_px, _, _ = project_px(tbl[:, 0:3], tbl[:, 3], tbl[:, 4])
    parent_px, _, _ = project_px(tbl[:, 12:15], tbl[:, 15], tbl[:, 5])
    _, center_w, radius_w = project_px(tbl[:, 16:19], tbl[:, 19],
                                       torch.zeros_like(tbl[:, 4]))

    live = torch.arange(C, device=dev) < scene.num_clusters
    # Streaming residency patch: identity with the all-resident masks the
    # bridge uploads (a cluster whose group page is missing is
    # unselectable; one whose child group is missing gets self error 0).
    GR = scene.group_resident.shape[0]
    feeds, made = scene.cluster_feeds, scene.cluster_made
    res_feeds = (feeds < 0) | scene.group_resident[
        torch.clamp(feeds, 0, GR - 1).long()]
    res_made = (made < 0) | scene.group_resident[
        torch.clamp(made, 0, GR - 1).long()]
    eff_self = torch.where(res_made, self_px, 0.0)
    cut = live & res_feeds & (eff_self <= tau_px) & (parent_px > tau_px)
    if frustum:
        planes = math3d.frustum_planes(view.viewproj)
        cut = cut & math3d.sphere_in_frustum(planes, center_w, radius_w)
    if object_visible is not None:
        cut = cut & object_visible[scene.cluster_object.long()]
    n = cut.sum().to(torch.int32)
    if return_bounds:
        return cut, n, center_w, radius_w
    return cut, n


def compact_visible_tris(scene: SceneBuffers, cut: torch.Tensor,
                         max_visible: int, tris_per_cluster: int = 128
                         ) -> CompactedTris:
    """Gather the cut clusters' triangles into a fixed budget of
    `max_visible` slots (ascending cluster id); clusters past the budget
    count toward `overflow`."""
    C = cut.shape[0]
    Kc = max_visible
    dev = cut.device
    slot = torch.sort(torch.where(
        cut, torch.arange(C, dtype=torch.int32, device=dev), C)).values
    if Kc <= C:
        slot = slot[:Kc]
    else:
        slot = torch.cat([slot, torch.full((Kc - C,), C, dtype=slot.dtype,
                                           device=dev)])
    overflow = torch.clamp(cut.sum() - Kc, min=0).to(torch.int32)
    return _compact_from_slots(scene, slot, overflow, max_visible,
                               tris_per_cluster)


def _compact_from_slots(scene: SceneBuffers, slot: torch.Tensor,
                        overflow: torch.Tensor, max_visible: int,
                        tris_per_cluster: int = 128) -> CompactedTris:
    """Sorted cluster ids (sentinel = C) -> CompactedTris. Object and
    material come from the cluster rows: instances share triangle ranges
    and differ only in their cluster rows."""
    C = scene.cluster_table.shape[0]
    T = scene.indices.shape[0]
    Kc = max_visible
    dev = slot.device
    live_slot = slot < C
    ci = torch.clamp(slot, max=C - 1).long()
    rows = scene.cluster_table[ci]
    off = rows[:, 7].to(torch.int32)
    cnt = rows[:, 8].to(torch.int32)
    obj_of_slot = scene.cluster_object[ci]
    mat_of_slot = rows[:, 9].to(torch.int32)
    geom_of_slot = rows[:, 11].to(torch.int32)
    lane = torch.arange(tris_per_cluster, dtype=torch.int32, device=dev)[None, :]
    tri_ids = off[:, None] + lane
    tri_ok = live_slot[:, None] & (lane < cnt[:, None])
    flat = torch.clamp(tri_ids.reshape(-1), 0, T - 1).long()
    K = tris_per_cluster
    return CompactedTris(
        indices=scene.indices[flat],
        material=mat_of_slot.repeat_interleave(K),
        object=obj_of_slot.repeat_interleave(K),
        valid=tri_ok.reshape(-1),
        overflow=overflow,
        geom=geom_of_slot,
        slot_cluster=torch.where(live_slot, ci.to(torch.int32), -1),
        slot_object=obj_of_slot,
        slot_bound=rows[:, 16:20])


def slot_world_spheres(comp: CompactedTris, scene: SceneBuffers
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World-space tight spheres of the compacted slots: (Kc, 3) centers
    and (Kc,) radii."""
    m, scale = _object_rows(scene, comp.slot_object)
    b = comp.slot_bound
    wx, wy, wz = _world_point(m, b[:, 0], b[:, 1], b[:, 2])
    return torch.stack([wx, wy, wz], -1), b[:, 3] * scale


def cut_slots_windowed(scene: SceneBuffers, view: ViewData,
                       config: FrameConfig, tau_px: torch.Tensor,
                       max_visible: int, frustum: bool = True,
                       row_filter=None) -> CompactedTris:
    """Two-phase budgeted LOD cut (the DAG-frontier traversal analogue,
    computeCulling.hlsl:17-50): cost tracks the cut, not the table.

    Phase A tests the C/128 cluster WINDOWS (SceneBuffers.cluster_windows:
    object-space union sphere + max parent error): a window whose
    conservative parent screen error cannot exceed tau holds no cut
    member, and one outside the frustum no visible one. Mixed-object
    windows always survive. Phase B takes the first config.cut_windows
    surviving windows (ascending id), gathers their table rows and runs
    select_cluster_cut's exact test on those rows only.

    `row_filter(flag_lane) -> bool` applies the pass's surface-class
    selection. The result equals compact_visible_tris(select_cluster_cut
    (...)) whenever the window budget suffices; dropped windows count in
    CompactedTris.overflow."""
    wt = scene.cluster_windows
    NW = wt.shape[0]
    C = scene.cluster_table.shape[0]
    dev = wt.device
    if C % 128 != 0 or NW != C // 128:
        raise ValueError(
            f"cut_windows needs a packed window table: C={C}, windows={NW} "
            "(bridge.pack_cluster_windows)")
    O = scene.object_mats.shape[0]
    Wmax = min(config.cut_windows, NW)
    f = _screen_error_factor(view, config.height)
    cam = view.cam_pos

    # ---- Phase A: window tests --------------------------------------------
    obj = wt[:, 5].to(torch.int32)
    mixed = obj < 0
    mw, wscale = _object_rows(scene, torch.clamp(obj, 0, O - 1))
    wx, wy, wz = _world_point(mw, wt[:, 0], wt[:, 1], wt[:, 2])
    rw = wt[:, 3] * wscale
    dist = torch.sqrt((wx - cam[0]) ** 2 + (wy - cam[1]) ** 2
                      + (wz - cam[2]) ** 2)
    dist = torch.maximum(dist - rw, view.near)
    ppx_max = wt[:, 4] * wscale * f / dist
    survive = (wt[:, 6] > 0.5) & (mixed | (ppx_max > tau_px))
    if frustum:
        planes = math3d.frustum_planes(view.viewproj)
        inf = math3d.sphere_in_frustum(planes, torch.stack([wx, wy, wz], -1),
                                       rw)
        survive = survive & (mixed | inf)

    # ---- Window budget compaction + row gather -----------------------------
    ids = torch.arange(NW, dtype=torch.int32, device=dev)
    wsel = torch.sort(torch.where(survive, ids, NW)).values[:Wmax]
    w_overflow = torch.clamp(survive.sum() - Wmax, min=0)
    live_w = wsel < NW
    wi = torch.clamp(wsel, max=NW - 1).long()
    L = CLUSTER_STRIDE
    rows = scene.cluster_table.reshape(NW, 128 * L)[wi].reshape(Wmax * 128, L)
    cobj = scene.cluster_object.reshape(NW, 128)[wi].reshape(-1)
    feeds = scene.cluster_feeds.reshape(NW, 128)[wi].reshape(-1)
    made = scene.cluster_made.reshape(NW, 128)[wi].reshape(-1)
    gid = (wi.to(torch.int32)[:, None] * 128
           + torch.arange(128, dtype=torch.int32, device=dev)[None, :]
           ).reshape(-1)
    live = live_w.repeat_interleave(128) & (gid < scene.num_clusters)

    # ---- Phase B: the exact per-cluster cut on the survivors ---------------
    m, scale = _object_rows(scene, cobj)

    def project_px(center_l, radius_l, err_l):
        ax, ay, az = _world_point(m, center_l[:, 0], center_l[:, 1],
                                  center_l[:, 2])
        rr = radius_l * scale
        d = torch.sqrt((ax - cam[0]) ** 2 + (ay - cam[1]) ** 2
                       + (az - cam[2]) ** 2)
        d = torch.maximum(d - rr, view.near)
        return err_l * scale * f / d, torch.stack([ax, ay, az], -1), rr

    self_px, _, _ = project_px(rows[:, 0:3], rows[:, 3], rows[:, 4])
    parent_px, _, _ = project_px(rows[:, 12:15], rows[:, 15], rows[:, 5])
    _, center_w, radius_w = project_px(rows[:, 16:19], rows[:, 19],
                                       torch.zeros_like(rows[:, 4]))
    GR = scene.group_resident.shape[0]
    res_feeds = (feeds < 0) | scene.group_resident[
        torch.clamp(feeds, 0, GR - 1).long()]
    res_made = (made < 0) | scene.group_resident[
        torch.clamp(made, 0, GR - 1).long()]
    eff_self = torch.where(res_made, self_px, 0.0)
    cut = live & res_feeds & (eff_self <= tau_px) & (parent_px > tau_px)
    if frustum:
        cut = cut & math3d.sphere_in_frustum(planes, center_w, radius_w)
    if row_filter is not None:
        cut = cut & row_filter(rows[:, 10])

    # ---- Slot compaction by global cluster id (order parity) ---------------
    slot = torch.sort(torch.where(cut, gid, C)).values
    Kc = max_visible
    if Kc <= slot.shape[0]:
        slot = slot[:Kc]
    else:
        slot = torch.cat([slot, torch.full((Kc - slot.shape[0],), C,
                                           dtype=slot.dtype, device=dev)])
    overflow = (torch.clamp(cut.sum() - Kc, min=0)
                + w_overflow).to(torch.int32)
    return _compact_from_slots(scene, slot, overflow, max_visible)


def touched_groups(scene: SceneBuffers, view: ViewData, config: FrameConfig,
                   tau_px) -> torch.Tensor:
    """(GR,) f32 load priorities (0 = untouched): the streaming groups the
    IDEAL cut (residency ignored) wants this frame, plus one finer level
    as prefetch at half weight, each weighted by how far its parent's
    screen error exceeds tau (reference: the GPU feedback readback,
    CLodStreamingSystem.cpp:986-1258; priority modes CLodCommon.h:50-53).
    `config.streaming_priority` "max" takes the worst cluster per group,
    "sum" the total over the group's clusters.

    The JAX package reduces by a broadcast compare over (clusters, groups);
    here each term is one `scatter_reduce` over the clusters. "amax" is
    order-free, so "max" is bit-equal to it; "sum" adds in another order
    (tests/test_torch_streaming.py states its tolerance)."""
    tbl = scene.cluster_table
    C = tbl.shape[0]
    dev = tbl.device
    GR = scene.group_resident.shape[0]
    m = scene.object_mats.reshape(-1, 16)[scene.cluster_object.long()]
    # The priorities are values, not just a mask: the sums of products
    # take XLA's contracted form (raster_setup.dot3) and the roots are
    # correctly rounded (math3d.sqrt_rn), as the JAX frame computes them.
    scale = math3d.sqrt_rn(torch.maximum(
        torch.maximum(dot3(m[:, 0], m[:, 0], m[:, 4], m[:, 4], m[:, 8],
                           m[:, 8]),
                      dot3(m[:, 1], m[:, 1], m[:, 5], m[:, 5], m[:, 9],
                           m[:, 9])),
        dot3(m[:, 2], m[:, 2], m[:, 6], m[:, 6], m[:, 10], m[:, 10])))
    f = _screen_error_factor(view, config.height)
    cam = view.cam_pos

    def px_of(center_l, radius_l, err_l):
        px, py, pz = center_l[:, 0], center_l[:, 1], center_l[:, 2]
        dx = dot3(m[:, 0], px, m[:, 1], py, m[:, 2], pz) + m[:, 3] - cam[0]
        dy = dot3(m[:, 4], px, m[:, 5], py, m[:, 6], pz) + m[:, 7] - cam[1]
        dz = dot3(m[:, 8], px, m[:, 9], py, m[:, 10], pz) + m[:, 11] - cam[2]
        dist = math3d.sqrt_rn(dot3(dx, dx, dy, dy, dz, dz))
        dist = torch.maximum(dist - radius_l * scale, view.near)
        return err_l * scale * f / dist

    self_px = px_of(tbl[:, 0:3], tbl[:, 3], tbl[:, 4])
    parent_px = px_of(tbl[:, 12:15], tbl[:, 15], tbl[:, 5])
    live = torch.arange(C, device=dev) < scene.num_clusters
    wanted = live & (self_px <= tau_px) & (parent_px > tau_px)
    urg = torch.where(wanted, parent_px / torch.clamp(tau_px, min=1e-6), 0.0)
    mode = "sum" if config.streaming_priority == "sum" else "amax"

    def reduce(group, w):
        # Unwanted clusters and ids outside [0, GR) land in a dump slot.
        ok = wanted & (group >= 0) & (group < GR)
        out = torch.zeros((GR + 1,), dtype=torch.float32, device=dev)
        out.scatter_reduce_(0, torch.where(ok, group, GR).long(), w, mode)
        return out[:GR]

    w_feeds = reduce(scene.cluster_feeds, urg)
    w_made = reduce(scene.cluster_made, 0.5 * urg)   # one level finer
    if mode == "sum":
        return w_feeds + w_made
    return torch.maximum(w_feeds, w_made)
