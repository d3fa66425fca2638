"""Runtime cluster-LOD selection (the DAG cut) and visible-cluster
compaction.

Port of basicrenderer_tpu/ops/clod.py: `select_cluster_cut`,
`compact_visible_tris` (with `_compact_from_slots`) and
`slot_world_spheres`. Because the error metric is monotonic along every
DAG path, a cluster belongs to the cut iff

    screen_err(self_error)  <= tau  <  screen_err(parent_error)

which is one vectorized pass over the fixed-capacity cluster table. The
compaction then gathers the cut's clusters into a fixed budget of
`max_visible` slots of 128 triangles, so everything downstream (setup,
bin, raster) scales with the budget and not with the LOD soup.

Everything is fixed-shape and free of host synchronisation. The JAX
package's one-hot matmul row lookups are plain indexing here: both are
exact.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..graph.framedata import FrameConfig, SceneBuffers, ViewData
from ..utils import math3d


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
    f = view.proj[1, 1] * (config.height * 0.5)
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
