"""Virtual shadow maps: clipmapped, page-cached shadows for directional
lights.

Port of basicrenderer_tpu/ops/vsm.py, single card. Per frame and light:

- mark: the screen's receivers (depth unprojected at
  `vsm_mark_downscale`) map to clipmap pages by their light-space
  footprint; a cell of the toroidal page table is needed when a receiver
  lands in it, and wants the absolute page id of its receivers (an
  integer scatter-max; the reference's one-hot reduce over cells is a TPU
  workaround for scatters);
- allocate: dirty cells (needed, not holding their wanted page), coarse
  levels first, meet the free or least recently used physical slots that
  no needed valid cell protects -- two stable argsorts, as jnp.argsort
  is stable and many slots share one age;
- render: the first `vsm_pages_per_frame` dirty pages raster depth-only
  through the cluster path (LOD cut with the page's frustum ->
  setup_from_compacted -> bin_clustered -> the raster kernel) on a
  page-sized config, written into the persistent atlas, and the tables
  follow, page by page in the reference's order;
- sample: per receiver at `vsm_sample_downscale`, the page slot lookup
  and a point tap, a 2x2 tap filter (`vsm_filter_taps >= 4`) or SMRT rays
  (`vsm_rays > 0`), then a bilinear upsample and a 3x3 box smooth.

The reference skips the whole page budget with `lax.cond` when nothing is
dirty. Here the frame reads the number of pages to render once per frame
and light (one host synchronisation), renders exactly those, and queues
nothing for a converged cache. Dirty cells come first in the ranking, so
the pages to render are a prefix of the budget; the reference's masked
updates of the rest are no-ops.

The state persists across frames: graph/temporal.py keeps it, drops it
when a light changes and invalidates the pages of moved objects
(`invalidate_pages`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..graph.framedata import FrameConfig, SceneBuffers, ViewData
from ..utils import math3d
from . import raster_setup
from .raster import raster_tiles
from .shadows import downsample2d
from .textures import resize_bilinear

PAGE = 128            # texels per page edge (default)
LEVELS = 6            # clipmap levels (default)
PAGES = 8             # page grid edge per level (default)
SLOTS = 128           # physical pages in the pool (default)
BASE_EXTENT = 16.0    # world extent of clipmap level 0 window (default)
AGE_MAX = 1 << 20     # age of a never-used slot


def geometry(config: Optional[FrameConfig]):
    """(page, levels, pages, slots, base_extent) from the `vsm_*` fields
    of `config`, or the module defaults."""
    if config is None:
        return PAGE, LEVELS, PAGES, SLOTS, BASE_EXTENT
    return (config.vsm_page_size, config.vsm_levels, config.vsm_page_grid,
            config.vsm_slots, config.vsm_base_extent)


@dataclasses.dataclass
class VsmState:
    slot_of_cell: torch.Tensor   # (L*P*P,) i32 physical slot or -1
    abs_of_cell: torch.Tensor    # (L*P*P,) i32 absolute page id tag
    cell_of_slot: torch.Tensor   # (SLOTS,) i32 owning cell or -1
    age: torch.Tensor            # (SLOTS,) i32 frames since last use
    atlas: torch.Tensor          # (SLOTS, PAGE, PAGE) f32 depth (1 = near)
    z_range: torch.Tensor        # (2,) f32 light-space z normalisation
    initialized: torch.Tensor    # () bool


def init_state(config: Optional[FrameConfig] = None,
               device="cuda") -> VsmState:
    page, levels, pages, slots, _base = geometry(config)
    n = levels * pages * pages
    i32 = dict(dtype=torch.int32, device=device)
    return VsmState(
        slot_of_cell=torch.full((n,), -1, **i32),
        abs_of_cell=torch.full((n,), -1, **i32),
        cell_of_slot=torch.full((slots,), -1, **i32),
        age=torch.full((slots,), AGE_MAX, **i32),
        atlas=torch.zeros((slots, page, page), dtype=torch.float32,
                          device=device),
        z_range=torch.tensor([0.0, 1.0], dtype=torch.float32, device=device),
        initialized=torch.tensor(False, device=device))


def init_states(config: FrameConfig, device="cuda"):
    """Frame-ready state: one VsmState for one VSM light, a tuple of
    independent states for `vsm_num_lights > 1`."""
    nl = config.vsm_num_lights
    if nl <= 1:
        return init_state(config, device)
    return tuple(init_state(config, device) for _ in range(nl))


def _vnorm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v))


def light_basis(light_dir: torch.Tensor) -> torch.Tensor:
    """(3, 3) rotation world -> light (rows s, u, -d; z grows toward the
    light)."""
    d = light_dir / torch.clamp(_vnorm(light_dir), min=1e-9)
    e = torch.eye(3, dtype=d.dtype, device=d.device)
    up = torch.where(torch.abs(d[1]) < 0.95, e[1], e[0])
    s = torch.linalg.cross(up, -d, dim=-1)
    s = s / torch.clamp(_vnorm(s), min=1e-9)
    u = torch.linalg.cross(-d, s, dim=-1)
    return torch.stack([s, u, -d])


def _level_of_point(lx, ly, cx, cy, levels, pages, base):
    """Clipmap level per light-space point, from the camera-centred window
    hierarchy (marking and sampling share it). A level's live footprint
    stays under `pages` page widths, so two needed pages never alias to
    one toroidal cell."""
    m = torch.maximum(torch.abs(lx - cx), torch.abs(ly - cy))
    margin = (pages - 1) / (2.0 * pages)
    lev = torch.ceil(torch.log2(torch.clamp(m / (base * margin), min=1e-6)))
    return torch.clamp(lev, 0, levels - 1).to(torch.int32)


def _page_world(level: torch.Tensor, base, pages) -> torch.Tensor:
    """World size of one page at `level`."""
    return base * torch.pow(2.0, level.to(torch.float32)) / pages


def _abs_id(ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
    """Absolute page id in 20 bits (pages clamped to +-512 of the origin)."""
    ix = torch.clamp(ix, -512, 511)
    iy = torch.clamp(iy, -512, 511)
    return (iy + 512) * 1024 + (ix + 512)


def _cells(lx, ly, cx, cy, levels, pages, base):
    """(level, page x, page y, page world size, table cell, absolute id)
    of light-space points."""
    lev = _level_of_point(lx, ly, cx, cy, levels, pages, base)
    pw = _page_world(lev, base, pages)
    ix = torch.floor(lx / pw).to(torch.int32)
    iy = torch.floor(ly / pw).to(torch.int32)
    cell = (lev * pages + torch.remainder(iy, pages)) * pages \
        + torch.remainder(ix, pages)
    return lev, ix, iy, pw, cell, _abs_id(ix, iy)


def invalidate_pages(state: VsmState, spheres: torch.Tensor,
                     light_dir: torch.Tensor,
                     config: Optional[FrameConfig] = None) -> VsmState:
    """Per-page invalidation for moved objects. spheres: (K, 4) world
    [centre xyz, radius] covering each moved object's old and new
    placement (radius < 0: unused row). Cells whose absolute page overlaps
    a sphere's light-space XY box lose their id tag, so the next mark pass
    re-renders them within the page budget."""
    _page, levels, pages, _slots, base = geometry(config)
    R = light_basis(light_dir)
    n = levels * pages * pages
    dev = state.abs_of_cell.device
    lev = torch.arange(n, dtype=torch.int32, device=dev) // (pages * pages)
    aid = state.abs_of_cell
    ix = torch.remainder(aid, 1024) - 512
    iy = torch.div(aid, 1024, rounding_mode="floor") - 512
    pw = _page_world(lev, base, pages)
    stale = torch.zeros((n,), dtype=torch.bool, device=dev)
    for k in range(spheres.shape[0]):
        c, r = spheres[k, :3], spheres[k, 3]
        lx = torch.sum(R[0] * c)
        ly = torch.sum(R[1] * c)
        x0 = torch.floor((lx - r) / pw).to(torch.int32)
        x1 = torch.floor((lx + r) / pw).to(torch.int32)
        y0 = torch.floor((ly - r) / pw).to(torch.int32)
        y1 = torch.floor((ly + r) / pw).to(torch.int32)
        stale = stale | ((ix >= x0) & (ix <= x1) & (iy >= y0) & (iy <= y1)
                         & (r >= 0.0) & (aid >= 0))
    return dataclasses.replace(state,
                               abs_of_cell=torch.where(stale, -1, aid))


def _page_viewprojs(R: torch.Tensor, cells: torch.Tensor,
                    wanted: torch.Tensor, z0: torch.Tensor, z1: torch.Tensor,
                    pages: int, base: float) -> torch.Tensor:
    """(n, 4, 4) ortho view-projections of the pages wanted by `cells`:
    the page's light-space window -> NDC, z normalised to the frozen
    range."""
    n = cells.shape[0]
    lev = torch.div(cells, pages * pages, rounding_mode="floor")
    a = wanted[cells]
    a_iy = torch.div(a, 1024, rounding_mode="floor") - 512
    a_ix = torch.remainder(a, 1024) - 512
    pwk = _page_world(lev, base, pages)
    x0 = a_ix.to(torch.float32) * pwk
    y0 = a_iy.to(torch.float32) * pwk
    sx = 2.0 / pwk
    sz = 1.0 / torch.clamp(z1 - z0, min=1e-6)
    zero = torch.zeros_like(sx)
    proj = torch.stack([
        torch.stack([sx, zero, zero, -(2.0 * x0 / pwk) - 1.0], -1),
        torch.stack([zero, sx, zero, -(2.0 * y0 / pwk) - 1.0], -1),
        torch.stack([zero, zero, sz.expand(n), (-z0 * sz).expand(n)], -1),
        torch.stack([zero, zero, zero, torch.ones_like(sx)], -1)], 1)
    Rw = torch.zeros((4, 4), dtype=torch.float32, device=R.device)
    Rw[:3, :3] = R
    Rw[3, 3] = 1.0
    return proj @ Rw


def _put(t: torch.Tensor, idx: torch.Tensor, val) -> None:
    """t[idx] = val for a one-element index tensor, queued on the device
    (no host read of the index)."""
    if not isinstance(val, torch.Tensor):
        val = torch.tensor(val, dtype=t.dtype, device=t.device)
    t.index_put_((idx.reshape(1).long(),), val.reshape(1).to(t.dtype))


def update_vsm(scene: SceneBuffers, view: ViewData, config: FrameConfig,
               params, state: VsmState, depth: torch.Tensor,
               shadow_compact_fn: Callable, row0: int = 0,
               full_h: int = None, light_row: int = 0,
               ) -> Tuple[torch.Tensor, VsmState, dict]:
    """One VSM frame step for ONE light: mark -> allocate -> render dirty
    -> sample.

    depth: (H, W) reverse-Z NDC, whose first row is screen row `row0` of
    a frame `full_h` rows tall (default H: the whole frame; a sharded
    frame passes its gathered rows). `shadow_compact_fn(vp)` -> the compacted
    caster triangles for a page view-projection (the cluster-cut shadow
    set). `light_row` selects the scene light (directional lights come
    first in the table). Returns ((H, W) visibility, new state, stats
    {"dirty", "needed", "rendered"} as i32 tensors)."""
    PAGE_, LEVELS_, PAGES_, SLOTS_, BASE_ = geometry(config)
    H, W = depth.shape
    full_h = full_h or H
    dev = depth.device
    f32, i32 = torch.float32, torch.int32
    inv_vp = torch.linalg.inv_ex(view.viewproj)[0]

    def unproject_ds(ds):
        d = downsample2d(depth, ds)
        h, w = d.shape
        nx = (torch.arange(w, dtype=f32, device=dev)[None, :].expand(h, w)
              * ds + 0.5) / W * 2.0 - 1.0
        ny = 1.0 - (torch.arange(h, dtype=f32, device=dev)[:, None]
                    .expand(h, w) * ds + 0.5 + row0) / full_h * 2.0
        px, py, pz, pw = math3d.mat4_columns(inv_vp, nx, ny, d)
        iw = 1.0 / torch.where(torch.abs(pw) > 1e-12, pw, 1.0)
        return px * iw, py * iw, pz * iw, d > 0.0

    ds = config.vsm_sample_downscale
    while ds > 1 and (H % ds or W % ds):   # downsample2d needs exact tiling
        ds -= 1
    R = light_basis(scene.lights[light_row, 4:7])
    n_cells = LEVELS_ * PAGES_ * PAGES_

    # Scene z range along the light axis, frozen at first use so cached
    # pages stay comparable across frames.
    centers = scene.object_bounds[:, :3]
    radii = scene.object_bounds[:, 3]
    lz = centers @ R[2]
    zmax = torch.max(torch.where(scene.object_valid, lz + radii, -1e9)) + 1.0
    zmin = torch.min(torch.where(scene.object_valid, lz - radii, 1e9)) - 1.0
    z0 = torch.where(state.initialized, state.z_range[0], zmin)
    z1 = torch.where(state.initialized, state.z_range[1], zmax)

    cam_l = R @ view.cam_pos
    cx, cy = cam_l[0], cam_l[1]

    # --- mark: which absolute pages does the screen need? ----------------
    mx, my, mz, vmask = unproject_ds(config.vsm_mark_downscale)
    lx, ly, _lz = math3d.mat3_columns(R, mx.reshape(-1), my.reshape(-1),
                                      mz.reshape(-1))
    _lev, _ix, _iy, _pw, cell, aid = _cells(lx, ly, cx, cy, LEVELS_, PAGES_,
                                            BASE_)
    cell = torch.where(vmask.reshape(-1), cell, n_cells).long()  # dead: spill
    needed = torch.zeros((n_cells + 1,), dtype=torch.bool, device=dev) \
        .index_fill_(0, cell, True)[:n_cells]
    # All receivers of a cell agree on its page up to window-edge races,
    # which the largest id settles, as in the reference.
    wanted = torch.full((n_cells + 1,), -1, dtype=i32, device=dev) \
        .scatter_reduce_(0, cell, aid, "amax")[:n_cells]
    valid_cell = (state.abs_of_cell == wanted) & (state.slot_of_cell >= 0)
    dirty = needed & ~valid_cell

    # --- allocate: oldest/free slots meet dirty cells (coarse first) -----
    K = config.vsm_pages_per_frame
    lev_of_cell = torch.arange(n_cells, dtype=i32, device=dev) \
        // (PAGES_ * PAGES_)
    cell_rank = torch.where(dirty, -lev_of_cell, 1 << 20)
    cell_order = torch.argsort(cell_rank, stable=True)[:K]
    live_k = dirty[cell_order]
    slot_cell = torch.clamp(state.cell_of_slot, 0, n_cells - 1).long()
    protected = (state.cell_of_slot >= 0) & needed[slot_cell] \
        & valid_cell[slot_cell]
    slot_rank = torch.where(protected, -1, state.age)
    slot_order = torch.argsort(-slot_rank, stable=True)[:K]

    atlas = state.atlas.clone()
    slot_of_cell = state.slot_of_cell.clone()
    abs_of_cell = state.abs_of_cell.clone()
    cell_of_slot = state.cell_of_slot.clone()
    age = torch.clamp(state.age + 1, max=AGE_MAX)

    # --- render the dirty pages through the cluster-cut raster -----------
    # The one host read of the frame's VSM step: how many of the budget's
    # pages are dirty (a prefix of the ranking). A converged cache renders
    # nothing and queues no page work.
    n_live = int(live_k.sum())
    if n_live:
        page_cfg = dataclasses.replace(
            config, width=PAGE_, height=PAGE_, tile_h=32,
            tile_w=min(128, PAGE_), enable_occlusion=False,
            max_pairs=config.vsm_page_pairs,
            near_clip_tris=0,   # ortho pages: w == 1 never crosses
            max_tiles_per_tri=8, max_big_tris=128)
        cells_live, slots_live = cell_order[:n_live], slot_order[:n_live]
        vps = _page_viewprojs(R, cells_live, wanted, z0, z1, PAGES_, BASE_)
        for k in range(n_live):
            c, s, vp = cells_live[k:k + 1], slots_live[k:k + 1], vps[k]
            comp = shadow_compact_fn(vp)
            lanes, bbox, tvalid, _ovf = raster_setup.setup_from_compacted(
                scene, comp, vp, page_cfg)
            pairs = raster_setup.bin_clustered(lanes, bbox, tvalid, page_cfg)
            page_depth = raster_tiles(pairs, page_cfg)[0]
            atlas.index_copy_(0, s, page_depth[None, :PAGE_, :PAGE_])
            # The tables, in the reference's order of updates.
            old = cell_of_slot[s]
            old_cell = torch.clamp(old, 0, n_cells - 1)
            drop = (old >= 0) & (old_cell != c)
            _put(slot_of_cell, old_cell,
                 torch.where(drop, -1, slot_of_cell[old_cell.long()]))
            _put(slot_of_cell, c, s)
            _put(abs_of_cell, c, wanted[c])
            _put(cell_of_slot, s, c)
            _put(age, s, 0)

    # Refresh the ages of the slots used this frame (a scatter-min; the
    # "unused" index SLOTS lands in a spill lane).
    used_slot = torch.where(needed & (slot_of_cell >= 0), slot_of_cell,
                            SLOTS_).long()
    age_pad = torch.cat([age, torch.full((1,), AGE_MAX, dtype=i32,
                                         device=dev)])
    age = age_pad.scatter_reduce_(
        0, used_slot, torch.where(used_slot < SLOTS_, 0, AGE_MAX).to(i32),
        "amin")[:SLOTS_]

    new_state = VsmState(
        slot_of_cell=slot_of_cell, abs_of_cell=abs_of_cell,
        cell_of_slot=cell_of_slot, age=age, atlas=atlas,
        z_range=torch.stack([z0, z1]),
        initialized=torch.ones((), dtype=torch.bool, device=dev))

    # --- sample ----------------------------------------------------------
    sx_, sy_, sz_, smask = unproject_ds(ds)
    h, w = sx_.shape
    lx, ly, lz = math3d.mat3_columns(R, sx_.reshape(-1), sy_.reshape(-1),
                                     sz_.reshape(-1))
    lev, ix, iy, pw, cell, aid = _cells(lx, ly, cx, cy, LEVELS_, PAGES_,
                                        BASE_)
    cell = cell.long()
    slot = slot_of_cell[cell]
    mapped = (slot >= 0) & (abs_of_cell[cell] == aid)
    # Texel within the page.
    fx = lx / pw - ix.to(f32)
    fy = ly / pw - iy.to(f32)
    txf = fx * PAGE_ - 0.5
    tyf = (1.0 - fy) * PAGE_ - 0.5
    flat = atlas.reshape(-1)
    zref = (lz - z0) / torch.clamp(z1 - z0, min=1e-6)
    bias = params.shadow_bias * torch.pow(2.0, lev.to(f32))
    sbase = torch.clamp(slot, 0, SLOTS_ - 1).long() * PAGE_

    def texel(txi, tyi):
        txi = torch.clamp(txi, 0, PAGE_ - 1).long()
        tyi = torch.clamp(tyi, 0, PAGE_ - 1).long()
        return flat[(sbase + tyi) * PAGE_ + txi]

    def tap(txi, tyi):
        smp = texel(txi, tyi)
        return ((zref + bias >= smp) | (smp <= 0.0)).to(f32)

    rays = config.vsm_rays
    if rays > 0:
        # SMRT tier: per-pixel jittered rays toward points on the light
        # cone; a ray is blocked if any of its samples has a cached caster
        # above it; visibility is the unblocked fraction (contact-hardening
        # penumbrae sized by params.light_size).
        S = max(2, config.vsm_ray_samples)
        tan_a = params.light_size
        pxi = torch.arange(w, dtype=f32, device=dev)[None, :].expand(h, w) \
            .reshape(-1)
        pyi = torch.arange(h, dtype=f32, device=dev)[:, None].expand(h, w) \
            .reshape(-1)
        # Interleaved gradient noise rotates the rays from pixel to pixel.
        ign = torch.remainder(52.9829189 * torch.remainder(
            0.06711056 * pxi + 0.00583715 * pyi, 1.0), 1.0)
        theta0 = ign * (2.0 * torch.pi)
        dmax = torch.clamp(z1 - lz, min=1e-3)   # world distance to the top
        zspan = torch.clamp(z1 - z0, min=1e-6)
        texpp = PAGE_ / pw                       # texels per world unit
        # Rays end where the cone's spread reaches about half a page.
        t_ray = torch.minimum(dmax, 0.9 * pw / max(tan_a, 0.02))
        occ = torch.zeros_like(zref)
        for r in range(rays):
            rad = ((r + 0.5) / rays) ** 0.5     # stratified disk radius
            th = theta0 + r * 2.3999632         # golden-angle spiral
            jx = rad * torch.cos(th)
            jy = rad * torch.sin(th)
            blocked = torch.zeros(zref.shape, dtype=torch.bool, device=dev)
            for s_i in range(S):
                t = (s_i / (S - 1.0)) ** 2
                tw = t * t_ray
                off = torch.minimum(tan_a * tw, 0.45 * pw)
                txs = torch.round(txf + jx * off * texpp).to(i32)
                tys = torch.round(tyf - jy * off * texpp).to(i32)
                smp = texel(txs, tys)
                zs = (lz + tw - z0) / zspan
                blocked = blocked | ((smp > zs + bias) & (smp > 0.0))
            occ = occ + blocked.to(f32)
        lit = 1.0 - occ / rays
    elif config.vsm_filter_taps >= 4:
        # 2x2 taps with bilinear weights on the visibility results; taps
        # clamp at page edges.
        x0i = torch.floor(txf).to(i32)
        y0i = torch.floor(tyf).to(i32)
        wxf = txf - x0i.to(f32)
        wyf = tyf - y0i.to(f32)
        lit = (tap(x0i, y0i) * (1 - wxf) * (1 - wyf)
               + tap(x0i + 1, y0i) * wxf * (1 - wyf)
               + tap(x0i, y0i + 1) * (1 - wxf) * wyf
               + tap(x0i + 1, y0i + 1) * wxf * wyf)
    else:
        lit = tap(torch.round(txf).to(i32), torch.round(tyf).to(i32))
    lit = torch.where(smask, torch.where(mapped, lit, 1.0).reshape(h, w),
                      1.0)

    lit = resize_bilinear(lit, H, W)
    p = torch.nn.functional.pad(lit[None, None], (1, 1, 1, 1),
                                mode="replicate")[0, 0]
    acc = 0
    for dy in range(3):
        for dx in range(3):
            acc = acc + p[dy:dy + H, dx:dx + W]
    stats = {"dirty": dirty.sum().to(i32), "needed": needed.sum().to(i32),
             "rendered": live_k.sum().to(i32)}
    return acc / 9.0, new_state, stats
