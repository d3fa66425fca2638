"""Frame graph: composes the pass functions into one frame function.

Port of basicrenderer_tpu/graph/frame.py. The JAX package
traces the whole frame into one jit program; here the frame is a plain
function that queues its work on the device of its inputs (CUDA tensors:
the card, with the raster, the tiled shading and the texture window
evaluation as hand-written kernels; CPU tensors: their plain versions).

Ported paths:
- the triangle-soup frame (default FrameConfig): vertex transform ->
  triangle setup (+ near-plane clip) -> object frustum cull -> tile
  binning -> tile raster with fused attribute resolve (K1). With
  enable_occlusion and a previous frame's depth, the object-granular
  two-phase HZB occlusion: phase 1 rasters the objects in the frustum
  that pass the previous HZB, phase 2 re-tests the rest against the HZB
  of phase 1's depth and rasters the newly visible ones into phase 1's
  buffers (K1 seeded);
- the cluster-LOD frame (enable_clod): LOD cut + visible-cluster
  compaction -> setup from the cluster vertex pages -> group binning ->
  group raster (K2). With enable_occlusion and a previous frame's depth,
  the slot-granular two-phase HZB occlusion: phase 1 rasters the slots
  that pass the previous HZB, phase 2 re-tests the rejected ones against
  the fresh HZB and rasters the newly visible clusters into phase 1's
  buffers (K2 seeded);
- the alpha-MASK pass (enable_alpha_mask): masked clusters raster into
  their own buffers, base-texture alpha is sampled at texture_downscale
  (K4; full rate at texture_downscale 1) and surviving texels
  depth-merge into the opaque targets; with mask_peels > 1 each further
  masked layer behind the last is peeled (K1/K2 peel mode) and merged
  the same way;
- material textures (enable_textures): the channels of
  FrameConfig.tex_channels (base colour + alpha, tangent-space normal,
  metallic-roughness, emissive) in one block-window sampler call (K4, on
  the RGBA8 or the BC3 atlas of FrameConfig.tex_format), at
  texture_downscale and bilinearly upsampled, or at full rate; normal
  maps perturb the G-buffer normals through the derivative tangent
  frame, or with enable_vertex_tangents through the per-triangle
  mikktspace tangent that setup lane 27 carries to raster channel 5
  (K1/K2 tangent mode);
- virtual shadow maps (enable_vsm, with a `vsm_state`): one clipmapped
  page cache per VSM'd directional light (ops/vsm.py), dirty pages
  rastered through the cluster path, the shadow term multiplying each
  directional light;
- otherwise cascaded shadow maps (enable_shadows) for light 0, the
  primary directional light (ops/shadows.py): num_cascades ortho maps of
  the casters (the cluster cut of shadow_clusters with enable_clod, K2;
  else the soup, K1), sampled from the depth buffer;
- clustered lighting (enable_clustered): per-tile light culling and the
  tiled local-light shading (K3), directional lights full-screen. With
  max_shadow_cubes / max_shadow_lights, the shadow-casting point and spot
  lights leave the tiled loop; each point light renders a six-face cube
  map and each spot light a perspective map of the caster cut (K2), and
  shades full-screen with its shadow term, after the deferred shade;
- the OpenPBR lobes (enable_coat, enable_fuzz, enable_energy_comp,
  enable_sss, enable_aniso) in the deferred shade, and coat, fuzz and
  energy compensation in the IBL composite too.
Then G-buffer -> deferred shade -> sky, and the post stack: screen-space
reflections (enable_ssr), GTAO (enable_gtao), the IBL ambient composite
(enable_ibl: SH diffuse + split-sum specular, SSR hits replacing the
prefiltered environment; without IBL the reflection is added with the
Fresnel-at-normal tint and AO darkens the lit frame), TAA (enable_taa:
with `prev_viewproj` the motion-vector resolve, whose per-tile history
warp is K5, else the static resolve; with output_width / output_height,
TAAU: the frame is resized bilinearly to the output size first, and the
history, K5's warp and the rest of the post stack run there), bloom
(enable_bloom), auto-exposure (enable_auto_exposure) -> ACES -> sRGB. Order-independent transparency
(enable_oit, with enable_clod: ops/oit.py, K1/K2 peel and accum modes,
the OpenPBR transmission split with enable_transmission) composites onto
the lit frame after the IBL composite and before TAA. graph/temporal.py
drives the TAA inputs (and the VSM state) from frame to frame.
With enable_reyes, the cluster setups (the main view's, the shadow maps',
the VSM pages' and OIT's) dice large displaced triangles into micro rows
(ops/reyes.py); the soup path never dices, as in the JAX package. A
debug_view ("normals", "depth", "albedo", "material", "clusters", "ao",
"uv") replaces the image after the post stack, and `wireframe` overlays
the vis buffer's triangle edges before the tonemap (not under TAAU).
With enable_skinning a linear-blend prepass (ops/skinning.py) deforms the
vertex positions and normals first, and the cluster setups read the
global vertex table instead of the static pages. With cut_windows > 0 the
cluster cut runs the budgeted window pre-cull (ops/clod.cut_slots_windowed).
With enable_streaming the frame returns "touched_groups" (the load
priorities of the groups the ideal cut wants, ops/clod.touched_groups)
and with enable_texture_streaming "tex_wanted" (each texture's finest
wanted mip, ops/textures.wanted_mips); models/streaming.py and
models/texstream.py consume them. enable_voxel_fallback fills uncovered
pixels from the voxel pyramid under the sky, enable_voxel_rt cone-traces
it for reflections, and enable_rt_reflect (with enable_clod) traces the
resident cut's triangles (ops/voxel_rt.py, ops/rt_reflect.py); the three
reflection tiers composite into the IBL's specular slot under SSR.
`FrameProgramCache` keeps one frame function per FrameConfig
(renderer.py's). Every FrameConfig of the JAX package builds here.

The same body renders one screen-row shard of a frame
(parallel/tile_sharding.py: `_render_body(..., lcfg=, row0_tiles=,
rows=)`). The geometry, the binning and the shadow and VSM pages are
replicated on every shard; the raster (on the shard's slice of the tile
offsets, at its tile-row offset), the G-buffer, the textures, the
shading, OIT, TAA and the tonemap run on the shard's rows; the passes
that cross rows (the HZBs, the VSM, cascade and local shadow terms, SSR,
the voxel and triangle reflections, GTAO, bloom, auto-exposure) gather
the frame's rows, run on the whole frame and keep their own rows; the
per-pixel work that reads a neighbouring row (the texture, IBL and
voxel upsamples, the mip estimate, the normal-map and anisotropy
derivatives, the TAA clamp) takes one halo row from each neighbour, so
the shards render the unsharded frame; "tex_wanted" is the minimum over
the shards.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from ..ops import clod as clod_ops
from ..ops import culling, ibl, lighting, motion, post, raster_setup
from ..ops import oit as oit_ops
from ..ops import brdf_energy
from ..ops import rt_reflect as rt_ops
from ..ops import shade as shade_ops
from ..ops import shadows as shadow_ops
from ..ops import skinning as skin_ops
from ..ops import ssr as ssr_ops
from ..ops import textures as tex_ops
from ..ops import voxel_rt as vox_ops
from ..ops import vsm as vsm_ops
from ..ops.raster import raster_tiles
from ..ops.shadows import downsample2d
from ..utils import math3d
from .framedata import FrameConfig, FrameParams, SceneBuffers, ViewData

_TEX_LANE = {"base": 0, "normal": 1, "mr": 2, "emissive": 3}


def check_config(config: FrameConfig, shards: int = None) -> None:
    """Raise ValueError for upscaling without TAA, NotImplementedError for
    an output size below the render size (the JAX frame only upscales
    either). With `shards` (a frame whose tile rows are split over that
    many ranks, parallel/tile_sharding.py): ValueError unless the tile
    rows divide evenly, or with upscaling (TAAU is single-card, as in the
    JAX package)."""
    if shards is not None:
        if config.tiles_y % shards:
            raise ValueError(f"tiles_y={config.tiles_y} not divisible by "
                             f"{shards} shards")
        if _upscaling(config):
            raise ValueError("TAAU upscaling (FrameConfig.output_width / "
                             "output_height) is single-card")
    if _upscaling(config):
        if not config.enable_taa:
            raise ValueError("upscaling (FrameConfig.output_width / "
                             "output_height) requires enable_taa")
        if config.output_width < config.width \
                or config.output_height < config.height:
            raise NotImplementedError(
                f"FrameConfig.output_width/output_height "
                f"{config.output_width}x{config.output_height} below the "
                f"render size {config.width}x{config.height}: only upscaling "
                f"is ported to basicrenderer_tpu_torch")


def _upscaling(config: FrameConfig) -> bool:
    """TAAU: the frame renders at (height, width) and presents at
    (output_height, output_width)."""
    return config.output_width > 0 and (
        config.output_width, config.output_height) != (config.width,
                                                       config.height)


def object_mask_to_tris(object_visible: torch.Tensor,
                        tri_object: torch.Tensor) -> torch.Tensor:
    """(O,) object visibility -> (T,) triangle mask."""
    return object_visible[torch.clamp(tri_object, min=0).long()]


def _opaque_row_filter(config: FrameConfig):
    """Surface-class routing of the opaque pass (cluster lane 10: 0 opaque,
    1 transparent, 2 MASK) as a per-row predicate, or None."""
    if not (config.enable_oit or config.enable_alpha_mask):
        return None

    def filt(flag):
        ok = torch.ones_like(flag, dtype=torch.bool)
        if config.enable_oit:
            ok = ok & ~((flag > 0.5) & (flag < 1.5))
        if config.enable_alpha_mask:
            ok = ok & (flag < 1.5)   # MASK clusters take the masked pass
        return ok
    return filt


def clod_cut(scene: SceneBuffers, view: ViewData, config: FrameConfig,
             params: FrameParams, frustum: bool = True,
             return_bounds: bool = False):
    """Opaque-pass LOD cut mask (C,); with `return_bounds` the tuple
    (cut, center_w (C, 3), radius_w (C,)) of the clusters' world-space
    tight spheres."""
    out = clod_ops.select_cluster_cut(scene, view, config,
                                      params.clod_error_px, frustum=frustum,
                                      return_bounds=return_bounds)
    cut = out[0]
    filt = _opaque_row_filter(config)
    if filt is not None:
        cut = cut & filt(scene.cluster_table[:, 10])
    return (cut,) + tuple(out[2:]) if return_bounds else cut


def clod_compact(scene: SceneBuffers, view: ViewData, config: FrameConfig,
                 params: FrameParams, frustum: bool = True,
                 max_visible: int = None) -> clod_ops.CompactedTris:
    """LOD cut + visible-triangle compaction into max_visible slots. With
    config.cut_windows > 0 the cut runs the budgeted window pre-cull
    (ops/clod.cut_slots_windowed: cost tracks the cut, not the table)."""
    if config.cut_windows > 0:
        return clod_ops.cut_slots_windowed(
            scene, view, config, params.clod_error_px,
            max_visible or config.max_visible_clusters, frustum=frustum,
            row_filter=_opaque_row_filter(config))
    cut = clod_cut(scene, view, config, params, frustum=frustum)
    return clod_ops.compact_visible_tris(
        cut=cut, scene=scene,
        max_visible=max_visible or config.max_visible_clusters)


def geometry_pass(scene: SceneBuffers, view: ViewData, config: FrameConfig,
                  params: FrameParams = None,
                  stage_hook: Callable[[str], None] = None):
    """Setup + culled binning. With enable_clod: the visible-cluster
    compaction, setup from the cluster pages and group binning; otherwise
    the full soup with object-level frustum culling. Returns (clip,
    world_pos, world_normals, overflow, pairs); the clod path returns None
    for the first three. `stage_hook(name)` marks "setup" and "bin"."""
    def stage(name):
        if stage_hook is not None:
            stage_hook(name)

    if config.enable_clod:
        comp = clod_compact(scene, view, config, params)
        stage("setup")
        lanes, bbox, valid, clip_ovf = raster_setup.setup_from_compacted(
            scene, comp, view.viewproj, config)
        stage("bin")
        pairs = raster_setup.bin_clustered(lanes, bbox, valid, config)
        return None, None, None, comp.overflow + clip_ovf, pairs
    clip, world_pos, world_normals, lanes, bbox, valid, clip_ovf = \
        geometry_setup(scene, view, config)
    if config.enable_culling:
        obj_vis = culling.frustum_cull_spheres(
            view.viewproj, scene.object_bounds[:, :3],
            scene.object_bounds[:, 3], scene.object_valid)
        valid = valid & object_rows_mask(obj_vis, scene.tri_object,
                                         valid.shape[0])
    stage("bin")
    pairs = raster_setup.bin_pairs(lanes, bbox, valid, config)
    return clip, world_pos, world_normals, clip_ovf, pairs


def geometry_setup(scene: SceneBuffers, view: ViewData, config: FrameConfig):
    """Vertex transform + triangle setup of the soup (with the per-vertex
    tangent theta under enable_vertex_tangents). Returns (clip, world_pos,
    world_normals, lanes, bbox, valid, clip_overflow); the two-phase
    occlusion bins the same setup once per phase."""
    clip, world_pos, world_normals = raster_setup.transform_geometry(
        scene.positions, scene.normals, scene.vert_object, scene.object_mats,
        scene.object_normal_mats, view.viewproj)
    vtheta = (raster_setup.vertex_world_theta(scene, world_normals)
              if config.enable_vertex_tangents else None)
    lanes, bbox, valid, clip_ovf = raster_setup.triangle_setup_packed(
        clip, scene.indices, scene.tri_object >= 0, config, world_normals,
        scene.uvs, scene.tri_material, scene.tri_object, vertex_theta=vtheta)
    return clip, world_pos, world_normals, lanes, bbox, valid, clip_ovf


def object_rows_mask(object_visible: torch.Tensor, tri_object: torch.Tensor,
                     rows: int) -> torch.Tensor:
    """(O,) object visibility -> (rows,) setup-row mask. Near-clip rows
    appended past the soup cross the camera plane, so no culled or
    occluded object owns them: they are kept."""
    m = object_mask_to_tris(object_visible, tri_object)
    if rows != m.shape[0]:
        m = torch.cat([m, torch.ones(rows - m.shape[0], dtype=torch.bool,
                                     device=m.device)])
    return m


def visibility_pass(pairs, lcfg: FrameConfig, init=None, tile_row0: int = 0):
    """Rasterize binned triangles -> (depth, vis, channels) on the padded
    tile grid, with the attribute resolve fused into the raster. `init`
    seeds the buffers (two-phase occlusion replay)."""
    return raster_tiles(pairs, lcfg, tile_row0=tile_row0, init=init)


class _OneCard:
    """The row helpers of parallel/tile_sharding.RowShards for a frame
    that is not sharded: each is the identity, and `halo_rows` adds no
    row."""
    world = 1

    @staticmethod
    def gather_rows(x):
        return x

    local_rows = localize = pmin = gather_rows

    @staticmethod
    def halo_rows(x, row_axis: int = 0):
        return x, 0, 0


_ONE_CARD = _OneCard()


def halo_upsample(img_ds: torch.Tensor, ds: int, out_h: int, out_w: int,
                  row_axis: int = 1, rows=_ONE_CARD) -> torch.Tensor:
    """Bilinear ds -> full upsample of img_ds (..., h, w, C), `row_axis`
    its row dim (the same as jax.image.resize(..., "bilinear")). On a
    shard of `rows` (a parallel/tile_sharding.RowShards) the image takes
    the neighbours' halo rows, is resized with ds more output rows for
    each halo row, and is cropped back: the shard's rows equal the whole
    frame's (bit for bit when ds is a power of two). Unlike the JAX
    package's, which pads the frame's top and bottom with the shard's own
    edge row, it adds no row there, so those rows are exact too."""
    if ds == 1:
        return img_ds
    ext, top, bot = rows.halo_rows(img_ds, row_axis)
    up = tex_ops.resize_bilinear(ext, out_h + (top + bot) * ds, out_w,
                                 row_dim=row_axis)
    return up.narrow(row_axis, top * ds, out_h)


def _seam_rows(rows, fn: Callable, *imgs: torch.Tensor):
    """fn(*imgs) for per-pixel work that reads the neighbouring rows of
    images (H, W, ...) of a shard's rows (screen derivatives, the TAA
    clamp's 3x3 box): the images take the neighbours' halo rows (one
    exchange; int32 ids travel as exact f32) and fn's outputs, a tensor
    or a tuple of them, are cropped back to the shard's rows, so that its
    seam rows come out as in the whole frame. The JAX package runs this
    work on the shard's rows alone. Plain fn(*imgs) on one card."""
    if rows.world == 1:
        return fn(*imgs)
    H, W = imgs[0].shape[:2]
    flat = [x.reshape(H, W, -1) for x in imgs]
    ext, top, _bot = rows.halo_rows(torch.cat(
        [x.to(torch.float32) for x in flat], -1))
    parts, c = [], 0
    for x, f in zip(imgs, flat):
        k = f.shape[-1]
        parts.append(ext[..., c:c + k].to(x.dtype)
                     .reshape((ext.shape[0],) + x.shape[1:]))
        c += k
    out = fn(*parts)
    if isinstance(out, tuple):
        return tuple(y[top:top + H] for y in out)
    return out[top:top + H]


def _atlas_resolution(scene: SceneBuffers, config: FrameConfig) -> int:
    return tex_ops.infer_strip_resolution(
        scene.tex_strips.shape[0] // scene.tex_flags.shape[0],
        config.tex_format)


def halo_mipf(u_ds: torch.Tensor, v_ds: torch.Tensor, resolution: int,
              rows=_ONE_CARD) -> Optional[torch.Tensor]:
    """The sampler's per-pixel mip estimate (h, w) of a shard's u/v
    planes over an atlas of `resolution`, with seam-exact row
    derivatives: the min-|grad| ddy of the shard's first and last rows
    sees the neighbours' halo rows. None on one card, where the sampler
    computes the same estimate itself."""
    if rows.world == 1:
        return None
    M = len(tex_ops.mip_layout(resolution)[0])
    ext, top, _bot = rows.halo_rows(torch.stack([u_ds, v_ds], -1))
    return tex_ops.compute_mip(ext, resolution, M)[top:top + u_ds.shape[0]]


def _pad_to(x: torch.Tensor, cfg: FrameConfig) -> torch.Tensor:
    """(H, W) -> (H', W') zero-padded to the tile grid."""
    return torch.nn.functional.pad(x, (0, cfg.padded_width - x.shape[1],
                                       0, cfg.padded_height - x.shape[0]))


def _render_body(scene: SceneBuffers, view: ViewData, params: FrameParams,
                 prev_depth: Optional[torch.Tensor], config: FrameConfig,
                 stage_hook: Callable[[str], None] = None,
                 taa_history: Optional[torch.Tensor] = None,
                 prev_viewproj: Optional[torch.Tensor] = None,
                 moving_rel: Optional[torch.Tensor] = None,
                 moving_ids: Optional[torch.Tensor] = None,
                 vsm_state=None, *, lcfg: FrameConfig = None,
                 row0_tiles: int = 0, rows=None) -> Dict[str, torch.Tensor]:
    """The frame. `config` is the whole frame's; with `rows` (a
    parallel/tile_sharding.RowShards) the body renders that rank's shard:
    `lcfg` is `config` at the shard's height, `row0_tiles` its first tile
    row, `prev_depth` and `taa_history` its own rows (and no
    `prev_viewproj`: it resolves TAA with the camera jitter), and the
    image outputs are its rows. The defaults render the whole frame."""
    if lcfg is None:
        lcfg = config
    sh = rows if rows is not None else _ONE_CARD
    H, W = lcfg.height, config.width
    full_h = config.height
    row0_px = row0_tiles * config.tile_h
    dev = scene.positions.device

    def stage(name):
        if stage_hook is not None:
            stage_hook(name)

    # The light loops' bounds, read once before this frame queues any work:
    # on the card the read then waits only for earlier frames.
    num_lights = int(scene.num_lights)
    num_dir = int(scene.num_dir_lights) if config.enable_clustered else 0
    use_vsm = config.enable_vsm and vsm_state is not None

    if config.enable_skinning:
        # Linear-blend skinning prepass: every path below (the soup setup,
        # the cluster setups through the vertex table) reads the deformed
        # positions and normals.
        stage("skinning")
        scene = skin_ops.apply_skinning(scene, scene.joint_palette,
                                        scene.vert_joints, scene.vert_weights)

    if config.enable_occlusion and config.enable_clod \
            and prev_depth is not None:
        # Slot-granular two-phase HZB occlusion: compact the cut first,
        # then test only the budget slots with their tight spheres.
        def raster_cut(c, budget, init=None, comp=None, slot_keep=None,
                       names=("setup", "bin", "raster")):
            if comp is None:
                comp = clod_ops.compact_visible_tris(
                    cut=c, scene=scene, max_visible=budget)
            if slot_keep is not None:
                comp = comp._replace(valid=comp.valid & slot_keep[:, None]
                                     .expand(budget, 128).reshape(-1))
            stage(names[0])
            lanes, bboxt, valid, clip_ovf = raster_setup.setup_from_compacted(
                scene, comp, view.viewproj, config)
            # Pair capacity sized to the pass's own triangle budget.
            bcfg = dataclasses.replace(
                config,
                max_pairs=min(config.max_pairs, max(budget * 256, 1 << 14)),
                max_group_pairs=min(config.max_group_pairs,
                                    max(budget * 1024 // config.group_rows,
                                        1 << 12)))
            stage(names[1])
            prs = raster_setup.bin_clustered(lanes, bboxt, valid, bcfg)
            stage(names[2])
            d, v, ch = visibility_pass(sh.localize(prs), lcfg, init=init,
                                       tile_row0=row0_tiles)
            return d, v, ch, prs, comp.overflow + clip_ovf

        stage("cut")
        Kc = config.max_visible_clusters
        comp1 = clod_compact(scene, view, config, params, max_visible=Kc)
        stage("hzb")
        prev_hzb = culling.build_hzb(sh.gather_rows(prev_depth),
                                     config.hzb_levels)
        cw, rw = clod_ops.slot_world_spheres(comp1, scene)
        bb, zn, behind = culling.project_sphere_bounds(
            view.viewproj, cw, rw, config.width, full_h)
        live_s = comp1.slot_cluster >= 0
        unocc = culling.occlusion_test_hzb(prev_hzb, bb, zn, behind,
                                           config.width, full_h)
        depth_p, vis_p, channels, pairs, ovf1 = raster_cut(
            None, Kc, comp=comp1, slot_keep=unocc)
        stage("hzb2")
        hzb_now = culling.build_hzb(sh.gather_rows(depth_p),
                                    config.hzb_levels)
        retest_s = live_s & ~unocc & culling.occlusion_test_hzb(
            hzb_now, bb, zn, behind, config.width, full_h)
        # Slot verdicts -> (C,) mask for the phase-2 compaction (dead and
        # kept slots scatter past the end and are dropped).
        C = scene.cluster_table.shape[0]
        idx = torch.where(retest_s, comp1.slot_cluster, C).long()
        retest = torch.zeros((C + 1,), dtype=torch.bool, device=dev)
        retest[idx] = True
        stage("cut2")
        depth_p, vis_p, channels, pairs2, ovf2 = raster_cut(
            retest[:C], config.max_phase2_clusters,
            init=(depth_p, vis_p, channels),
            names=("setup2", "bin2", "raster2"))
        pairs = pairs._replace(
            overflow=pairs.overflow + pairs2.overflow,
            num_pairs=pairs.num_pairs + pairs2.num_pairs)
        cluster_overflow = ovf1 + ovf2
    elif config.enable_occlusion and prev_depth is not None:
        # Object-granular two-phase HZB occlusion of the soup: one setup;
        # phase 1 rasters the objects in the frustum that pass the
        # previous frame's HZB, phase 2 re-tests the rest against the HZB
        # of phase 1's depth and rasters the newly visible ones into
        # phase 1's buffers (K1 seeded).
        stage("setup")
        # The JAX package's branch drops the near-clip overflow here (its
        # counter stays 0); so does this one.
        _c, _wp, _wn, lanes, bbox, valid, _clip_ovf = geometry_setup(
            scene, view, config)
        cluster_overflow = torch.zeros((), dtype=torch.int32, device=dev)
        stage("hzb")
        centers, radii = scene.object_bounds[:, :3], scene.object_bounds[:, 3]
        prev_hzb = culling.build_hzb(sh.gather_rows(prev_depth),
                                     config.hzb_levels)
        vis1, cand = culling.two_phase_object_cull(
            view.viewproj, centers, radii, scene.object_valid, prev_hzb,
            config.width, full_h)
        stage("bin")
        pairs = raster_setup.bin_pairs(
            lanes, bbox,
            valid & object_rows_mask(vis1, scene.tri_object, valid.shape[0]),
            config)
        stage("raster")
        depth_p, vis_p, channels = visibility_pass(
            sh.localize(pairs), lcfg, tile_row0=row0_tiles)
        stage("hzb2")
        hzb_now = culling.build_hzb(sh.gather_rows(depth_p),
                                    config.hzb_levels)
        bb2, zn2, behind2 = culling.project_sphere_bounds(
            view.viewproj, centers, radii, config.width, full_h)
        vis2 = cand & culling.occlusion_test_hzb(hzb_now, bb2, zn2, behind2,
                                                 config.width, full_h)
        stage("bin2")
        pairs2 = raster_setup.bin_pairs(
            lanes, bbox,
            valid & object_rows_mask(vis2, scene.tri_object, valid.shape[0]),
            config)
        stage("raster2")
        depth_p, vis_p, channels = visibility_pass(
            sh.localize(pairs2), lcfg, init=(depth_p, vis_p, channels),
            tile_row0=row0_tiles)
        pairs = pairs._replace(
            overflow=pairs.overflow + pairs2.overflow,
            num_pairs=pairs.num_pairs + pairs2.num_pairs)
    else:
        stage("cut" if config.enable_clod else "setup")
        _c, _wp, _wn, cluster_overflow, pairs = geometry_pass(
            scene, view, config, params, stage_hook)
        stage("raster")
        depth_p, vis_p, channels = visibility_pass(
            sh.localize(pairs), lcfg, tile_row0=row0_tiles)

    if config.enable_alpha_mask:
        # Alpha-cutoff (MASK) materials: raster the masked clusters into
        # their own buffers, sample base-texture alpha at their pixels and
        # depth-merge the texels that pass the material cutoff.
        stage("mask")
        base_cut, _ = clod_ops.select_cluster_cut(scene, view, config,
                                                  params.clod_error_px)
        cut_m = base_cut & (scene.cluster_table[:, 10] > 1.5)
        comp_m = clod_ops.compact_visible_tris(
            cut=cut_m, scene=scene, max_visible=config.mask_clusters)
        lanes_m, bbox_m, valid_m, _mask_clip_ovf = \
            raster_setup.setup_from_compacted(scene, comp_m, view.viewproj,
                                              config)
        pairs_m = sh.localize(raster_setup.bin_clustered(
            lanes_m, bbox_m, valid_m, config))
        depth_pre_mask = depth_p
        dm, vm, chm = visibility_pass(pairs_m, lcfg, tile_row0=row0_tiles)
        for k in range(config.mask_peels):
            if k > 0:
                # The next-farther masked layer: the peel band excludes the
                # previous layer's fragments, and the merge admits texels
                # only where every nearer masked texel failed its cutoff.
                stage(f"mask_peel{k + 1}")
                dm, vm, chm = raster_tiles(
                    pairs_m, lcfg, tile_row0=row0_tiles,
                    peel=(depth_pre_mask, dm * (1.0 - oit_ops.PEEL_EPS)))
            keep = _mask_alpha_keep(scene, view, lcfg, dm, vm, chm, depth_p,
                                    rows=sh)
            depth_p = torch.where(keep, dm, depth_p)
            vis_p = torch.where(keep, vm, vis_p)
            channels = torch.where(keep[None], chm, channels)

    stage("gbuffer")
    depth = depth_p[:H, :W]
    vis = vis_p[:H, :W]
    gb = shade_ops.gbuffer_from_channels(
        channels[:, :H, :W], depth, vis, view, scene.material_table,
        config.width, config.height, row0=row0_px)
    feedback = {}
    if config.enable_textures:
        stage("textures")
        smp, tex_wanted = _sample_material_textures(scene, view, lcfg, gb,
                                                    channels, depth, vis, sh)
        if tex_wanted is not None:
            # Each shard saw its own rows' samples: the finest wanted mip
            # is the minimum over the shards.
            feedback["tex_wanted"] = sh.pmin(tex_wanted)
        stage("normal_map")
        gb = _apply_textures(gb, smp, config.tex_channels,
                             config.enable_vertex_tangents, sh)

    casters = []   # the shadow passes' caster cut, made once a frame
    whole = {}     # the frame's rows of depth and normals, gathered once

    def frame_rows(name):
        """The whole frame's rows of the shard's "depth" or "normal"
        image, for the passes that cross rows (the image itself on one
        card)."""
        if name not in whole:
            whole[name] = sh.gather_rows(depth if name == "depth"
                                         else gb.normal)
        return whole[name]

    def shadow_casters():
        if not casters:
            casters.append(clod_compact(scene, view, config, params,
                                        frustum=False,
                                        max_visible=config.shadow_clusters))
        return casters[0]

    shadow_fn = None
    vsm_out = {}
    if use_vsm:
        stage("vsm")
        shadow_fn, vsm_out = _vsm_pass(scene, view, params, config,
                                       vsm_state, frame_rows("depth"), sh)
    elif config.enable_shadows:
        stage("shadows")
        shadow_fn = _csm_pass(scene, view, params, config,
                              frame_rows("depth"),
                              shadow_casters() if config.enable_clod
                              else None, sh)
    terms = shade_ops.view_terms(gb, view, config.enable_energy_comp,
                                 config.enable_fuzz)
    shade_kw = dict(coat=config.enable_coat, sss=config.enable_sss,
                    aniso=config.enable_aniso, terms=terms)
    if config.enable_aniso and sh.world > 1:
        # The anisotropy tangent frame's screen derivatives, seam-exact.
        shade_kw["aniso_frame"] = _seam_rows(
            sh, shade_ops.tangent_frame, gb.world_pos, gb.uv, gb.normal,
            gb.aniso_rotation)
    if config.enable_clustered:
        # Tiled many-light pass: local lights per tile (K3), directional
        # lights full-screen.
        stage("light_cull")
        payload, counts, light_overflow = lighting.cull_lights_tiles(
            depth_p, scene.lights, scene.num_lights, view, config,
            row0_tiles=row0_tiles)
        stage("tiled_shade")
        shade_in = torch.stack([
            _pad_to(x, lcfg) for x in (
                gb.normal[..., 0], gb.normal[..., 1], gb.normal[..., 2],
                gb.albedo[..., 0], gb.albedo[..., 1], gb.albedo[..., 2],
                gb.metallic, gb.roughness, gb.world_pos[..., 0],
                gb.world_pos[..., 1], gb.world_pos[..., 2],
                gb.valid.to(torch.float32))])
        local = lighting.tiled_shade(shade_in, payload, counts,
                                     view.cam_pos.contiguous(), lcfg)
        stage("shade")
        hdr = shade_ops.shade_deferred(gb, scene, view, num_dir,
                                       shadow_fn=shadow_fn,
                                       directional_only=True, **shade_kw)
        hdr = hdr + local[:, :H, :W].permute(1, 2, 0)
    else:
        stage("shade")
        light_overflow = torch.zeros((), dtype=torch.int32, device=dev)
        hdr = shade_ops.shade_deferred(gb, scene, view, num_lights,
                                       shadow_fn=shadow_fn, **shade_kw)
    if config.enable_clustered:
        hdr = _local_shadow_pass(hdr, gb, scene, view, params, config,
                                 frame_rows, sh, shadow_casters, terms, stage)
    sky = shade_ops.procedural_sky(view, H, W, params.sky_intensity,
                                   row0=row0_px, full_h=full_h)
    if config.enable_voxel_fallback:
        # Voxel LOD fallback: pixels the cut or the streaming residency
        # left uncovered march the voxel pyramid instead of showing sky
        # (reference: VoxelGroupBuilder.cpp + voxelSoftwareRaster.hlsl).
        stage("voxel_primary")
        ds_v = config.voxel_rt_downscale
        vox_col, vox_tr = vox_ops.voxel_primary(
            scene, view, config, H, W, row0=row0_px, full_h=full_h,
            upsample=lambda x, h, w: halo_upsample(x, ds_v, h, w, 0, sh))
        sky = vox_col + vox_tr[..., None] * sky
    hdr = torch.where(gb.valid[..., None], hdr, sky)
    hdr, ao = _post_composite(hdr, frame_rows, sh, gb, scene, view, params,
                              config, stage)
    oit_overflow = torch.zeros((), dtype=torch.int32, device=dev)
    if config.enable_oit and config.enable_clod:
        hdr, oit_overflow = oit_ops.composite_oit(
            scene, view, config, params, depth_p, hdr, num_lights, stage,
            lcfg=lcfg, row0_tiles=row0_tiles, localize=sh.localize)

    if _upscaling(config):
        # TAAU: the jittered render-size frame is resized to the output
        # size, where the history accumulates (the sub-pixel jitter
        # sequence recovers detail past the render size).
        stage("upscale")
        hdr = tex_ops.resize_bilinear(hdr, config.output_height,
                                      config.output_width)
    if config.enable_taa and taa_history is not None:
        if prev_viewproj is not None:
            # Motion-vector reprojection: per-pixel motion from depth and
            # object ids, history warped per tile (K5), pixels whose motion
            # disagrees with their tile's reject history. A sharded frame
            # takes no prev_viewproj and keeps the camera-jitter resolve,
            # as in the JAX package: its history is the shard's rows, and
            # the warps cross them.
            stage("motion")
            if moving_rel is None:
                moving_rel = torch.zeros((motion.MAX_MOVING, 4, 4),
                                         dtype=torch.float32, device=dev)
                moving_ids = torch.full((motion.MAX_MOVING,), -1,
                                        dtype=torch.int32, device=dev)
            du, dv, mvalid, mds = motion.motion_field(
                depth_p, channels[4], view, prev_viewproj, moving_rel,
                moving_ids, config, full_h=full_h, full_w=config.width)
            tdy, tdx, resid = motion.tile_motion(du, dv, mvalid, config, mds)
            oh, ow = hdr.shape[:2]
            if (oh, ow) != (H, W):
                # TAAU: motion at the render size; the tile maps are
                # resized (nearest) to the output's tile grid and scaled
                # to output pixels.
                sy_s, sx_s = oh / H, ow / W
                oty, otx = -(-oh // config.tile_h), -(-ow // config.tile_w)
                tdy = post.resize_nearest(
                    tdy.reshape(config.tiles_y, config.tiles_x) * sy_s,
                    oty, otx).reshape(-1)
                tdx = post.resize_nearest(
                    tdx.reshape(config.tiles_y, config.tiles_x) * sx_s,
                    oty, otx).reshape(-1)
                resid = resid * max(sy_s, sx_s)
            stage("taa")
            hdr = post.taa_resolve_mv(hdr, taa_history, params.taa_blend,
                                      tdy, tdx, resid, config.tile_h,
                                      config.tile_w)
        else:
            stage("taa")
            hdr = _seam_rows(sh, lambda cur, hist: post.taa_resolve(
                cur, hist, params.taa_blend), hdr, taa_history)
    taa_out = hdr
    bloomed = None   # the whole frame's rows after bloom
    if config.enable_bloom:
        stage("bloom")
        bloomed = post.bloom(sh.gather_rows(hdr), params.bloom_threshold,
                             params.bloom_intensity)
        hdr = sh.local_rows(bloomed)
    exposure = params.exposure
    if config.enable_auto_exposure:
        stage("exposure")
        exposure = exposure * post.auto_exposure(
            bloomed if bloomed is not None else sh.gather_rows(hdr))
    if config.debug_view != "none":
        # A debug view replaces the image (reference: the Menu's debug-view
        # selector and its resolve pass); its outputs leave out the
        # OIT counter, as the JAX frame's do.
        hdr = _debug_view(config.debug_view, gb, vis, ao, hdr)
        image = (torch.clamp(hdr, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
        stage("end")
        return {
            "image": image, "hdr": hdr, "depth": depth,
            "depth_padded": depth_p, "vis": vis,
            "bin_overflow": pairs.overflow, "num_pairs": pairs.num_pairs,
            "cluster_overflow": cluster_overflow,
            "light_overflow": light_overflow, "taa_out": hdr,
            **vsm_out, **feedback,
        }
    if config.wireframe and hdr.shape[:2] == vis.shape:
        # Triangle-edge overlay from the visibility buffer: a covered pixel
        # whose id differs from its left or upper neighbour's sits on an
        # edge (skipped under TAAU, where the frame is output-size).
        hdr = torch.where(_vis_edges(vis)[..., None], torch.tensor(
            [0.05, 1.0, 0.25], dtype=torch.float32, device=dev), hdr)
    ldr = shade_ops.aces_tonemap(hdr * exposure)
    srgb = shade_ops.linear_to_srgb(ldr)
    image = (srgb * 255.0 + 0.5).to(torch.uint8)
    if config.enable_streaming:
        # Geometry streaming feedback: the groups the ideal cut wants,
        # with load priorities (models/streaming.py reads it back).
        stage("touched_groups")
        feedback["touched_groups"] = clod_ops.touched_groups(
            scene, view, config, params.clod_error_px)
    stage("end")
    return {
        "image": image,
        "hdr": hdr,
        **feedback,
        "depth": depth,
        "depth_padded": depth_p,   # next frame's occlusion HZB source
        "vis": vis,
        "bin_overflow": pairs.overflow,
        "num_pairs": pairs.num_pairs,
        "cluster_overflow": cluster_overflow,
        "light_overflow": light_overflow,
        "oit_overflow": oit_overflow,
        "taa_out": taa_out,
        **vsm_out,
    }


def _debug_view(mode: str, gb: shade_ops.GBuffer, vis: torch.Tensor,
                ao: Optional[torch.Tensor], hdr: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) debug visualisation `mode` of the G-buffer, the vis
    buffer or the AO, black where nothing is covered. Any other mode (and
    "ao" without GTAO) shows the frame's HDR there, as in the JAX
    package."""
    if mode == "normals":
        out = gb.normal * 0.5 + 0.5
    elif mode == "depth":
        d = torch.clamp(gb.depth / torch.clamp(gb.depth.max(), min=1e-6),
                        0.0, 1.0)
        out = torch.stack([d, d, d], -1)
    elif mode == "albedo":
        out = gb.albedo
    elif mode == "material":
        mid = gb.material_id.to(torch.float32)
        out = torch.stack([torch.sin(mid * 3.1) * 0.5 + 0.5,
                           torch.sin(mid * 7.7) * 0.5 + 0.5,
                           torch.sin(mid * 13.3) * 0.5 + 0.5], -1)
    elif mode == "clusters":
        cid = vis.to(torch.float32) / 128.0
        out = torch.stack([torch.sin(cid * 12.9898) * 0.5 + 0.5,
                           torch.sin(cid * 78.233) * 0.5 + 0.5,
                           torch.sin(cid * 37.719) * 0.5 + 0.5], -1)
    elif mode == "ao" and ao is not None:
        out = torch.stack([ao, ao, ao], -1)
    elif mode == "uv":
        out = torch.cat([gb.uv, torch.zeros_like(gb.uv[..., :1])], -1)
    else:
        out = hdr
    return torch.where(gb.valid[..., None], out, 0.0)


def _vis_edges(vis: torch.Tensor) -> torch.Tensor:
    """(H, W) bool: covered pixels whose vis id differs from the left or
    the upper neighbour's (0 past the border)."""
    left = torch.nn.functional.pad(vis, (1, 0))[:, :-1]
    up = torch.nn.functional.pad(vis, (0, 0, 1, 0))[:-1, :]
    return ((vis != left) | (vis != up)) & (vis > 0)


def _sample_ds_planes(scene: SceneBuffers, view: ViewData,
                      config: FrameConfig, depth: torch.Tensor,
                      channels: torch.Tensor, vis: torch.Tensor,
                      lanes, rows=_ONE_CARD):
    """(K, H, W, 4) samples at texture_downscale ds: u, v (divided by the
    depth's inverse w) and the material's texture ids of `lanes` of the
    material table are point-sampled at ds from the raster's depth,
    channels and vis (padded or not), ids -1 where uncovered; one sampler
    call over the ds-rate planes, bilinearly upsampled to (H, W). On a
    shard (`config` at its height, `rows` its RowShards) the mip estimate
    and the upsample take halo rows from the neighbours. Returns
    (samples, tids_ds, u_ds, v_ds)."""
    H, W = config.height, config.width
    ds = config.texture_downscale
    mt = scene.material_table
    c0 = shade_ops.inv_w_from_depth(downsample2d(depth[:H, :W], ds), view.proj)
    iw = torch.where(torch.abs(c0) > 1e-12, c0, 1.0)
    u_ds = downsample2d(channels[2][:H, :W], ds) / iw
    v_ds = downsample2d(channels[3][:H, :W], ds) / iw
    mid_ds = torch.clamp(torch.remainder(
        torch.round(downsample2d(channels[4][:H, :W], ds)).to(torch.int32),
        raster_setup.OBJ_COMBO), 0, mt.shape[0] - 1)
    covered_ds = downsample2d(vis[:H, :W], ds) > 0
    trow = mt[:, 13:17][mid_ds.reshape(-1).long()]
    tids_ds = torch.stack([
        torch.where(covered_ds, torch.round(trow[:, lane]).to(torch.int32)
                    .reshape(covered_ds.shape), -1) for lane in lanes])
    smp = tex_ops.sample_pyramid_blocked_planes(
        scene.tex_strips, scene.tex_flags, tids_ds, u_ds, v_ds, H, W, ds,
        config.texture_filter, upsample=False,
        mipf=halo_mipf(u_ds, v_ds, _atlas_resolution(scene, config), rows),
        fmt=config.tex_format)
    return (halo_upsample(smp, ds, H, W, row_axis=1, rows=rows), tids_ds,
            u_ds, v_ds)


def _sample_material_textures(scene: SceneBuffers, view: ViewData,
                              config: FrameConfig, gb: shade_ops.GBuffer,
                              channels: torch.Tensor, depth: torch.Tensor,
                              vis: torch.Tensor, rows=_ONE_CARD):
    """(K, H, W, 4) samples of the K texture channels of
    config.tex_channels, all in one sampler call (one window geometry),
    and the texture-streaming feedback (ops/textures.wanted_mips) or None.
    With texture_downscale ds > 1 dividing the frame, the sampler takes
    ds-rate planes (u, v and the texture ids point-sampled from the raster
    channels) and its result is bilinearly upsampled; with
    enable_texture_streaming the feedback comes from those planes.
    Otherwise the sampler reads every ds-th pixel of the G-buffer's uv
    and there is no feedback, as in the JAX frame. On a shard, `config`
    is at its height and `rows` is its RowShards; the feedback is the
    shard's own."""
    H, W = config.height, config.width
    ds, filt = config.texture_downscale, config.texture_filter
    chans = config.tex_channels
    if ds > 1 and H % ds == 0 and W % ds == 0:
        smp, tids_ds, u_ds, v_ds = _sample_ds_planes(
            scene, view, config, depth, channels, vis,
            [_TEX_LANE[c] for c in chans], rows)
        wanted = None
        if config.enable_texture_streaming:
            wanted = tex_ops.wanted_mips(
                scene.tex_flags, tids_ds, u_ds, v_ds,
                _atlas_resolution(scene, config))
        return smp, wanted
    id_of = {"base": gb.base_tex, "normal": gb.normal_tex, "mr": gb.mr_tex,
             "emissive": gb.emissive_tex}
    return tex_ops.sample_pyramid_blocked(
        scene.tex_strips, scene.tex_flags, torch.stack([id_of[c] for c in chans]),
        gb.uv, ds, filt, fmt=config.tex_format,
        mipf=_full_rate_mipf(scene, config, gb.uv, rows)), None


def _full_rate_mipf(scene: SceneBuffers, config: FrameConfig,
                    uv: torch.Tensor, rows) -> Optional[torch.Tensor]:
    """A shard's seam-exact mip estimate for the full-rate sampler
    (texture_downscale 1; halo_mipf), else None."""
    if config.texture_downscale != 1:
        return None
    return halo_mipf(uv[..., 0], uv[..., 1],
                     _atlas_resolution(scene, config), rows)


def _apply_textures(gb: shade_ops.GBuffer, smp: torch.Tensor, chans,
                    vertex_tangents: bool = False,
                    rows=_ONE_CARD) -> shade_ops.GBuffer:
    """Texture samples multiply the material factors (glTF semantics:
    base colour and alpha, G = roughness, B = metallic, emissive); the
    normal map perturbs the normals, in the tangent frame decoded from
    the G-buffer's tangent angle with `vertex_tangents`, else in the
    screen-derivative frame (on a shard of `rows`, with the neighbours'
    halo rows: _seam_rows)."""
    s_of = {c: smp[k] for k, c in enumerate(chans)}
    rep = {}
    if "base" in s_of:
        rep["albedo"] = gb.albedo * s_of["base"][..., :3]
        rep["alpha"] = gb.alpha * s_of["base"][..., 3]
    if "normal" in s_of and vertex_tangents:
        rep["normal"] = tex_ops.apply_normal_map_sampled(
            gb.normal, gb.world_pos, gb.uv, s_of["normal"], gb.normal_tex,
            normal_scale=gb.normal_scale[..., None],
            frame=shade_ops.tangent_from_theta(gb.normal, gb.tangent_theta))
    elif "normal" in s_of:
        rep["normal"] = _seam_rows(
            rows, lambda n, wp, uv, smp_n, tex, scale:
            tex_ops.apply_normal_map_sampled(n, wp, uv, smp_n, tex,
                                             normal_scale=scale[..., None]),
            gb.normal, gb.world_pos, gb.uv, s_of["normal"], gb.normal_tex,
            gb.normal_scale)
    if "mr" in s_of:
        rep["roughness"] = gb.roughness * s_of["mr"][..., 1]
        rep["metallic"] = gb.metallic * s_of["mr"][..., 2]
    if "emissive" in s_of:
        rep["emissive"] = gb.emissive * s_of["emissive"][..., :3]
    return gb._replace(**rep)


def _vsm_pass(scene: SceneBuffers, view: ViewData, params: FrameParams,
              config: FrameConfig, vsm_state, depth: torch.Tensor, rows):
    """Virtual shadow maps for the first vsm_num_lights directional lights
    (one page cache each; `vsm_state` is one VsmState, or a tuple of them
    with vsm_num_lights > 1). Pages raster through the cluster cut with
    the camera's LOD selection and the page's frustum. `depth` is the
    whole frame's rows; each term keeps the rows of `rows` (a sharded
    frame renders the same pages on every shard). Returns (shadow_fn,
    {"vsm_state", "vsm_stats"})."""
    bounds = []   # the camera's cut, made when the first dirty page needs it

    def page_compact(vp):
        if not bounds:
            bounds.extend(clod_cut(scene, view, config, params,
                                   frustum=False, return_bounds=True))
        cut, cw, rw = bounds
        keep = cut & math3d.sphere_in_frustum(math3d.frustum_planes(vp),
                                              cw, rw)
        return clod_ops.compact_visible_tris(
            cut=keep, scene=scene, max_visible=config.vsm_page_clusters)

    nl = config.vsm_num_lights
    states_in = (vsm_state,) if nl <= 1 else tuple(vsm_state)
    terms, states, stats = [], [], None
    for k in range(nl):
        term, st, st_stats = vsm_ops.update_vsm(
            scene, view, config, params, states_in[k], depth, page_compact,
            full_h=config.height, light_row=k)
        terms.append(torch.where(scene.num_dir_lights > k,
                                 rows.local_rows(term), 1.0))
        states.append(st)
        stats = st_stats if stats is None else {
            key: stats[key] + st_stats[key] for key in stats}

    def shadow_fn(i, world_pos, normal):
        return terms[i] if i < nl else torch.ones_like(terms[0])

    return shadow_fn, {"vsm_state": states[0] if nl <= 1 else tuple(states),
                       "vsm_stats": stats}


def _csm_pass(scene: SceneBuffers, view: ViewData, params: FrameParams,
              config: FrameConfig, depth: torch.Tensor, casters, rows):
    """Cascaded shadow maps for light 0 (the bridge packs directional
    lights first); the term is 1 when the scene has no directional light.
    `casters` is the cluster cut (None: the soup). The term is sampled
    from `depth`, the whole frame's rows, and keeps the rows of `rows`.
    Returns shadow_fn."""
    cascade_vps, _splits = shadow_ops.cascade_matrices(
        view, scene.lights[0, 4:7], config.num_cascades)
    smaps = torch.stack([
        shadow_ops.render_cascade(scene, cascade_vps[k], config,
                                  compacted=casters)
        for k in range(config.num_cascades)])
    term = rows.local_rows(shadow_ops.sample_shadow_cascades(
        depth, view, cascade_vps, smaps, params.shadow_bias,
        full_h=config.height))
    term = torch.where(scene.num_dir_lights > 0, term, 1.0)

    def shadow_fn(i, world_pos, normal):
        return term if i == 0 else torch.ones_like(term)
    return shadow_fn


def _local_shadow_pass(hdr: torch.Tensor, gb: shade_ops.GBuffer,
                       scene: SceneBuffers, view: ViewData,
                       params: FrameParams, config: FrameConfig,
                       frame_rows: Callable, rows, casters: Callable, terms,
                       stage: Callable[[str], None]) -> torch.Tensor:
    """Shadow-casting point lights (stage cube_shadows: six perspective
    faces a slot, the face picked per pixel by the dominant axis), then
    spot lights (stage spot_shadows: one perspective view a slot), in the
    JAX package's order so that the HDR sums add alike. Per slot: the
    caster cut `casters()` rendered into each view, the slot's term
    sampled from those maps, and the light's full-screen shade (`terms`
    from shade_ops.view_terms) times the term added where the slot is
    live. The terms are sampled from the whole frame's depth
    (`frame_rows("depth")`) and keep the rows of `rows`."""
    v, comp, fuzz = terms
    L = scene.lights.shape[0]
    R = config.point_shadow_resolution

    def cube_views():
        return shadow_ops.point_cube_matrices(scene.lights,
                                              config.max_shadow_cubes)

    def spot_views():
        vps, idx, live = shadow_ops.spot_shadow_matrices(
            scene.lights, config.max_shadow_lights)
        return vps[:, None], idx, live

    def cube_term(row, vps, maps):
        return shadow_ops.sample_point_shadow(
            frame_rows("depth"), view, row[0:3], vps, maps[:, :R, :R],
            full_h=config.height)

    def spot_term(row, vps, maps):
        return shadow_ops.sample_spot_shadow(
            frame_rows("depth"), view, vps[0], maps[0], params.shadow_bias,
            full_h=config.height)

    for name, slots, res, views, sample in (
            ("cube_shadows", config.max_shadow_cubes, R, cube_views,
             cube_term),
            ("spot_shadows", config.max_shadow_lights,
             config.spot_shadow_resolution, spot_views, spot_term)):
        if slots == 0:
            continue
        stage(name)
        vps, idx, live = views()
        cfg = dataclasses.replace(config, shadow_resolution=res)
        for k in range(slots):
            maps = torch.stack([
                shadow_ops.render_cascade(scene, vp, cfg,
                                          compacted=casters())
                for vp in vps[k]])
            row = scene.lights[torch.clamp(idx[k], 0, L - 1).long()]
            term = rows.local_rows(sample(row, vps[k], maps))
            contrib = shade_ops.shade_one_light(gb, row, v, gb.normal,
                                                spec_comp=comp, fuzz_e=fuzz)
            hdr = hdr + torch.where(live[k], contrib * term[..., None], 0.0)
    return hdr


def _post_composite(hdr: torch.Tensor, frame_rows: Callable, rows,
                    gb: shade_ops.GBuffer, scene: SceneBuffers,
                    view: ViewData, params: FrameParams, config: FrameConfig,
                    stage: Callable[[str], None]) -> torch.Tensor:
    """Screen-space reflections, the voxel and triangle ray-traced
    reflections, GTAO and the IBL ambient composite on the lit frame (sky
    included). SSR marches the direct-lit frame. With IBL the reflections
    fill the env-specular slot in tiers: the voxel cone trace replaces the
    prefiltered environment by 1 - its transmittance, triangle hits
    (enable_rt_reflect, with enable_clod) override both, and SSR hits
    override everything; AO scales the ambient term. Without IBL the
    voxel and SSR reflections are added with the Fresnel-at-normal tint
    (triangle hits need the IBL slot, as in the JAX frame) and AO darkens
    the lit frame. SSR, the reflection tiers and GTAO cross rows: they
    run on the whole frame's rows (`frame_rows("depth")`,
    `frame_rows("normal")` and the others gathered by `rows`) and keep
    the rows of `rows`. Returns (hdr, ao), ao None without GTAO."""
    valid3 = gb.valid[..., None]
    full_h = config.height
    ssr_col = ssr_wgt = None
    if config.enable_ssr:
        stage("ssr")
        ssr_col, ssr_wgt = (rows.local_rows(x) for x in ssr_ops.ssr(
            rows.gather_rows(hdr), frame_rows("depth"), frame_rows("normal"),
            rows.gather_rows(gb.roughness), rows.gather_rows(gb.metallic),
            view, config, full_h=full_h))
    vox_ref = vox_ref_tr = None
    if config.enable_voxel_rt:
        # Off-screen reflections: cone-trace the voxel pyramid along the
        # reflected view ray (reference: RayTracedReflectionsPass over the
        # cluster BLAS, CLodRayTracingSystem.h:16-75).
        stage("voxel_reflect")
        vox_ref, vox_ref_tr = (rows.local_rows(x) for x in
                               vox_ops.voxel_reflections(
                                   scene, frame_rows("depth"),
                                   frame_rows("normal"), view, config,
                                   full_h=full_h))
    rt_col = rt_hit = None
    if config.enable_rt_reflect and config.enable_clod:
        # Triangle-accurate reflections over the resident cut (the
        # opaque pass's compaction, made again as the JAX frame does).
        stage("rt_reflect")
        comp_rt = clod_compact(scene, view, config, params)
        rt_col, rt_hit = (rows.local_rows(x) for x in
                          rt_ops.trace_reflections(
                              scene, comp_rt, frame_rows("depth"),
                              frame_rows("normal"), view, config,
                              full_h=full_h))
    ao = None
    if config.enable_gtao:
        stage("gtao")
        ao = rows.local_rows(post.gtao(
            frame_rows("depth"), frame_rows("normal"), view, view.near,
            params.gtao_radius, params.gtao_intensity, params.frame_index))
        ao = torch.where(gb.valid, ao, 1.0)
    metal3 = gb.metallic[..., None]
    if config.enable_ibl:
        stage("ibl")
        v = view.cam_pos - gb.world_pos
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                            min=1e-9)
        ndv = torch.clamp(torch.sum(gb.normal * v, -1), min=1e-4)
        irr = ibl.eval_sh_irradiance(scene.env_sh, gb.normal)
        f0 = 0.04 * (1 - metal3) + gb.albedo * metal3
        kd = (1.0 - f0) * (1.0 - metal3)
        diffuse_ibl = kd * gb.albedo * irr
        scale, bias = ibl.env_brdf_karis(ndv, gb.roughness)
        ds_i = config.ibl_specular_downscale

        def upsample(x, h, w):   # seam-exact on a shard
            return halo_upsample(x, ds_i, h, w, 0, rows)
        prefiltered = ibl.runtime_specular_ibl(
            gb.normal, v, gb.roughness, scene.env_specular,
            downscale=ds_i, upsample=upsample)
        if vox_ref is not None:
            prefiltered = vox_ref + prefiltered * vox_ref_tr[..., None]
        if rt_col is not None:
            prefiltered = prefiltered * (1.0 - rt_hit[..., None]) \
                + rt_col * rt_hit[..., None]
        if ssr_col is not None:
            prefiltered = prefiltered * (1.0 - ssr_wgt[..., None]) \
                + ssr_col * ssr_wgt[..., None]
        spec_ibl = prefiltered * (f0 * scale[..., None] + bias[..., None])
        if config.enable_energy_comp:
            # Kulla-Conty on the environment specular too (the analytic
            # lights' factor, so the furnace stays white).
            spec_ibl = spec_ibl * brdf_energy.energy_compensation(
                f0, ndv, gb.roughness)
        if config.enable_fuzz:
            # Fuzz over the environment: the base attenuated by the layer's
            # directional albedo, plus a sheen-coloured irradiance term.
            fe = (gb.fuzz_weight * brdf_energy.sheen_energy(
                ndv, gb.fuzz_rough))[..., None]
            spec_ibl = spec_ibl * (1.0 - fe) + irr * fe
            diffuse_ibl = diffuse_ibl * (1.0 - fe)
        if config.enable_coat:
            # Coat over the environment: a second prefiltered fetch at the
            # coat roughness, the base attenuated by the coat's Fresnel.
            cf = shade_ops._f_schlick(ndv[..., None],
                                      shade_ops.coat_f0(ndv.device))
            cw = gb.coat_weight[..., None]
            coat_pref = ibl.runtime_specular_ibl(
                gb.normal, v, gb.coat_rough, scene.env_specular,
                downscale=ds_i, upsample=upsample)
            spec_ibl = spec_ibl * (1.0 - cf * cw) + coat_pref * cf * cw
            diffuse_ibl = diffuse_ibl * (1.0 - cf * cw)
        ambient = (diffuse_ibl + spec_ibl) * params.ibl_intensity
        if ao is not None:
            ambient = ambient * ao[..., None]
        hdr = hdr + torch.where(valid3, ambient, 0.0)
    elif ao is not None:
        hdr = hdr * (0.5 + 0.5 * ao[..., None])
    if (config.enable_ssr or vox_ref is not None) and not config.enable_ibl:
        f0 = 0.04 * (1 - metal3) + gb.albedo * metal3
        refl = vox_ref if vox_ref is not None else torch.zeros_like(hdr)
        if config.enable_ssr:
            refl = refl * (1.0 - ssr_wgt[..., None]) \
                + ssr_col * ssr_wgt[..., None]
        hdr = hdr + torch.where(valid3, refl * f0, 0.0)
    return hdr, ao


def _mask_alpha_keep(scene: SceneBuffers, view: ViewData, config: FrameConfig,
                     dm: torch.Tensor, vm: torch.Tensor, chm: torch.Tensor,
                     depth_ref_p: torch.Tensor,
                     rows=_ONE_CARD) -> torch.Tensor:
    """Padded keep mask of the masked raster: covered, nearer than the
    current depth, and the sampled base alpha times the material's alpha
    reaches the material cutoff. With texture_downscale ds > 1 dividing
    the frame, texture coordinates, material ids and coverage are
    point-sampled at ds, sampled, and the alpha bilinearly upsampled;
    otherwise the full-rate sampler reads every ds-th pixel's uv. On a
    shard, `config` is at its height and `rows` is its RowShards."""
    H, W = config.height, config.width
    ds, filt = config.texture_downscale, config.texture_filter
    mt = scene.material_table
    M = mt.shape[0]
    mid_m = torch.remainder(torch.round(chm[4]).to(torch.int32),
                            raster_setup.OBJ_COMBO)[:H, :W]
    mrow = mt[torch.clamp(mid_m.reshape(-1), 0, M - 1).long()]
    cutoff = mrow[:, 11].reshape(H, W)
    factor_a = mrow[:, 3].reshape(H, W)
    if ds > 1 and H % ds == 0 and W % ds == 0:
        smp_a = _sample_ds_planes(scene, view, config, dm, chm, vm,
                                  [_TEX_LANE["base"]], rows)[0][0]
    else:
        iwm_p = shade_ops.inv_w_from_depth(dm, view.proj)
        iwm = torch.where(torch.abs(iwm_p) > 1e-12, iwm_p, 1.0)
        uv_m = torch.stack([chm[2] / iwm, chm[3] / iwm], dim=-1)[:H, :W]
        btex = torch.round(mrow[:, 13]).to(torch.int32).reshape(H, W)
        smp_a = tex_ops.sample_pyramid_blocked(
            scene.tex_strips, scene.tex_flags, btex[None], uv_m, ds, filt,
            fmt=config.tex_format,
            mipf=_full_rate_mipf(scene, config, uv_m, rows))[0]
    alpha_m = _pad_to(smp_a[..., 3] * factor_a, config)
    keep = (vm > 0) & (dm > depth_ref_p)
    return keep & (alpha_m >= _pad_to(cutoff, config))


def build_frame_fn(config: FrameConfig) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns the frame function `frame(scene, view, params,
    prev_depth=None, taa_history=None, *, vsm_state=None,
    prev_viewproj=None, moving_rel=None, moving_ids=None, stage_hook=None)`
    for `config`, after check_config.
    With enable_occlusion the frame takes the previous frame's padded depth
    (its "depth_padded" output; graph/temporal.py carries it); the first
    frame passes None and takes the single-phase path. With enable_taa it takes the previous
    frame's "taa_out" as `taa_history` (None on the first frame); with
    `prev_viewproj` (the previous un-jittered view-projection) and the
    moved objects' `moving_rel` (MAX_MOVING, 4, 4) / `moving_ids`
    (MAX_MOVING,) it resolves with motion vectors. graph/temporal.py makes
    these inputs. With enable_vsm the frame takes the previous frame's
    "vsm_state" (ops/vsm.init_states on the first frame; without a state
    the frame renders no VSM) and returns the new "vsm_state" and
    "vsm_stats". With enable_streaming it returns "touched_groups" (GR,)
    f32, with enable_texture_streaming (and texture_downscale > 1 dividing
    the frame) "tex_wanted" (N,) i32. The outputs carry the JAX frame's
    keys for these paths.

    `frame(..., stage_hook=fn)` calls fn(name) as the frame enters each
    stage, so a caller can time the stages with CUDA events: "skinning"
    first (enable_skinning), then "setup", "bin", "raster" on the soup
    path, with occlusion "setup", "hzb",
    "bin", "raster", "hzb2", "bin2", "raster2"; "cut", "setup", "bin",
    "raster" on the cluster path, with occlusion "cut", "hzb", "setup",
    "bin", "raster", "hzb2", "cut2", "setup2", "bin2", "raster2"; then "mask"
    (alpha-MASK pass; "mask_peel2", ... for its further peels),
    "gbuffer", "textures" and "normal_map" (enable_textures), "vsm" or
    "shadows" (CSM), "light_cull" and "tiled_shade" (clustered), "shade",
    "cube_shadows" and "spot_shadows" (the shadowed point and spot
    lights), "voxel_primary" (enable_voxel_fallback), then the post
    stages "ssr", "voxel_reflect", "rt_reflect", "gtao", "ibl" of the
    enabled passes, OIT's "oit_cut",
    "oit_setup", "oit_bin", "oit_peel0", ... (one per layer rastered),
    "oit_accum", "oit_shade", "oit_composite", then "upscale" (TAAU),
    "motion", "taa", "bloom", "exposure", "touched_groups"
    (enable_streaming) and "end".

    With FrameConfig.output_width / output_height (TAAU, enable_taa
    required) the frame renders at (height, width), resizes the HDR frame
    bilinearly to the output size after the OIT composite, and resolves
    TAA, bloom, exposure and the tonemap there: "image", "hdr" and
    "taa_out" (the next frame's `taa_history`) are output-size, the
    buffers ("depth", "vis", ...) render-size."""
    check_config(config)

    def frame(scene: SceneBuffers, view: ViewData, params: FrameParams,
              prev_depth: torch.Tensor = None,
              taa_history: torch.Tensor = None, *,
              vsm_state=None,
              prev_viewproj: torch.Tensor = None,
              moving_rel: torch.Tensor = None,
              moving_ids: torch.Tensor = None,
              stage_hook: Callable[[str], None] = None
              ) -> Dict[str, torch.Tensor]:
        return _render_body(scene, view, params, prev_depth, config,
                            stage_hook, taa_history, prev_viewproj,
                            moving_rel, moving_ids, vsm_state)

    return frame


class FrameProgramCache:
    """Frame functions keyed by FrameConfig (the counterpart of the JAX
    package's jit-specialization cache). A frame function compiles
    nothing: the kernels are built once per process (utils/cuda_build),
    so the cache only saves rebuilding the closure and its config
    checks."""

    def __init__(self):
        self._cache: Dict[FrameConfig, Callable] = {}

    def get(self, config: FrameConfig) -> Callable:
        fn = self._cache.get(config)
        if fn is None:
            fn = build_frame_fn(config)
            self._cache[config] = fn
        return fn
