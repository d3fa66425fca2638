"""Frame-level data structures: the device buffers the frame function
consumes, and the static frame configuration.

Port of basicrenderer_tpu/graph/framedata.py. `FrameConfig` is copied field
for field, so that the same keyword arguments describe the same frame in
both packages. The buffer types are dataclasses of tensors with an explicit
`.to(device)`; `SceneBuffers` holds the JAX package's fields but its
(V, 10) `vertex_table`, which repeats the positions, normals, uvs and
object ids the skinned setup reads from their own fields. Words that the
JAX package keeps as uint32 (quantized vertex pages, packed RGBA8 texels,
voxel and SGGX words) are int32 tensors here holding the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

# Packed light layout (float lanes), reference: LightInfo ShaderBuffers.h:377-404
LIGHT_STRIDE = 16
# 0-2 position, 3 type, 4-6 direction, 7 intensity, 8-10 color, 11 range,
# 12 cos(inner), 13 cos(outer), 14 spot shadow slot (-1 none, plain float),
# 15 point cube shadow index (-1 none)

# Hard caps on per-light shadow slots (bridge.snapshot_lights assigns them;
# the values must agree with the JAX package so light tables match).
MAX_SHADOW_SPOT_SLOTS = 4
MAX_SHADOW_CUBE_SLOTS = 2


def _to(obj, device):
    """Copy of a tensor dataclass with every tensor field moved to `device`."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


@dataclasses.dataclass
class SceneBuffers:
    """Scene-constant + per-frame-updated device tensors (soup fields)."""
    # Geometry (instance-flattened; see models/mesh.py docstring)
    positions: torch.Tensor       # (V, 3) f32 object-space
    normals: torch.Tensor         # (V, 3) f32
    tangents: torch.Tensor        # (V, 4) f32
    uvs: torch.Tensor             # (V, 2) f32
    vert_object: torch.Tensor     # (V,) i32 instance id
    indices: torch.Tensor         # (T, 3) i32 global vertex ids
    tri_material: torch.Tensor    # (T,) i32
    tri_object: torch.Tensor      # (T,) i32 (-1 = unused slot)
    num_tris: torch.Tensor        # () i32
    num_verts: torch.Tensor       # () i32
    # Per-object
    object_mats: torch.Tensor         # (O, 4, 4) f32 model->world
    object_normal_mats: torch.Tensor  # (O, 3, 3) f32 inverse-transpose
    object_bounds: torch.Tensor       # (O, 4) f32 world bounding sphere xyz+r
    object_valid: torch.Tensor        # (O,) bool live objects
    # Materials / lights
    material_table: torch.Tensor  # (M, MAT_STRIDE) f32
    lights: torch.Tensor          # (L, LIGHT_STRIDE) f32, directional first
    num_lights: torch.Tensor      # () i32
    num_dir_lights: torch.Tensor  # () i32 directional count (table prefix)
    # Cluster-LOD (virtualized geometry; ops/clod.py, models/clusters.py).
    tri_cluster: torch.Tensor     # (T,) i32 global cluster id or -1
    cluster_table: torch.Tensor   # (C, CLUSTER_STRIDE) f32 (object space)
    cluster_object: torch.Tensor  # (C,) i32 owning object
    num_clusters: torch.Tensor    # () i32
    # Cluster-local vertex pages, one per GEOMETRY cluster (instances share
    # them): corner-major quantized planar rows (models/pageblob.py) and
    # each page's dequant row [aabb min3, extent3, pad2].
    cluster_verts: torch.Tensor    # (G, SLAB*3) i32 (u32 bits)
    cluster_dequant: torch.Tensor  # (G, 8) f32
    # Streaming residency (identity when fully resident): page -> slot,
    # per-cluster streaming groups, resident groups.
    cluster_feeds: torch.Tensor    # (C,) i32 streaming group of cluster
    cluster_made: torch.Tensor     # (C,) i32 group cluster was built from
    geom_slot: torch.Tensor        # (G,) i32 page -> slot (-1 missing)
    group_resident: torch.Tensor   # (GR,) bool
    # Window pre-cull table, one row per 128 cluster rows: [cx, cy, cz, r,
    # max parent_err, object (-1 mixed), live count, pad].
    cluster_windows: torch.Tensor  # (C/128, 8) f32
    # Texture atlas (models/textures.strip_pyramid): every mip row as
    # 128-texel RGBA8 strips; flag bit 0 = sRGB-stored.
    tex_strips: torch.Tensor       # (N * rows_per_layer, 128) i32 (u32 bits)
    tex_flags: torch.Tensor        # (N,) i32
    # Environment lighting (models/environment.py): SH radiance, the
    # prefiltered radiance mips at one resolution, and the split-sum BRDF
    # LUT (carried; the runtime uses the analytic fit).
    env_sh: torch.Tensor           # (9, 3) f32
    env_specular: torch.Tensor     # (mips, 6, R, R, 3) f32
    env_brdf_lut: torch.Tensor     # (32, 32, 2) f32
    # Mikktspace vertex tangents, per-triangle flat (the corner-0 wedge):
    # object-space [tx|ty|tz|w] plane-major per geometry cluster. The
    # clustered setup rotates them to world and encodes a theta against
    # the world corner normal (raster_setup.encode_theta_cols); read with
    # FrameConfig.enable_vertex_tangents; size-1 placeholder otherwise.
    cluster_tangents: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros((1, 512), dtype=torch.float32))
    # Skinning (ops/skinning.py): zero weights = unskinned vertex. The
    # bridge always fills them; the defaults are size-1 placeholders.
    vert_joints: torch.Tensor = dataclasses.field(       # (V, 4) i32
        default_factory=lambda: torch.zeros((1, 4), dtype=torch.int32))
    vert_weights: torch.Tensor = dataclasses.field(      # (V, 4) f32
        default_factory=lambda: torch.zeros((1, 4), dtype=torch.float32))
    joint_palette: torch.Tensor = dataclasses.field(     # (Jcap, 16) f32
        default_factory=lambda: torch.eye(4).reshape(1, 16))
    # Voxel scene pyramid (models/voxels.py: the voxel reflection and
    # primary fallback tiers; size-1 placeholders until the bridge builds
    # one).
    voxel_grid: torch.Tensor = dataclasses.field(        # (Ncells,) u32 bits
        default_factory=lambda: torch.zeros(1, dtype=torch.int32))
    voxel_meta: torch.Tensor = dataclasses.field(        # origin3, cell, n,
        default_factory=lambda: torch.zeros(8, dtype=torch.float32))
    #                                          levels, radiance scale, pad
    voxel_sggx: torch.Tensor = dataclasses.field(        # (2*Ncells,) SGGX
        default_factory=lambda: torch.zeros(2, dtype=torch.int32))

    def to(self, device) -> "SceneBuffers":
        return _to(self, device)


@dataclasses.dataclass
class ViewData:
    """Per-view camera data (primary camera or a shadow view)."""
    view: torch.Tensor       # (4, 4)
    proj: torch.Tensor       # (4, 4)
    viewproj: torch.Tensor   # (4, 4)
    cam_pos: torch.Tensor    # (3,)
    near: torch.Tensor       # () f32

    def to(self, device) -> "ViewData":
        return _to(self, device)


def make_view(view_mat, proj_mat, cam_pos, near: float = 0.1,
              device="cuda") -> ViewData:
    """ViewData on `device`; viewproj = proj @ view in f32."""
    view_mat = torch.as_tensor(np.asarray(view_mat, np.float32), device=device)
    proj_mat = torch.as_tensor(np.asarray(proj_mat, np.float32), device=device)
    return ViewData(
        view=view_mat,
        proj=proj_mat,
        viewproj=proj_mat @ view_mat,
        cam_pos=torch.as_tensor(np.asarray(cam_pos, np.float32), device=device),
        near=torch.tensor(near, dtype=torch.float32, device=device),
    )


@dataclasses.dataclass(frozen=True)
class FrameConfig:
    """Static (hashable) frame configuration, copied field for field from
    the JAX package. Mirrors the reference's structural settings that force
    a render-graph rebuild (Renderer.cpp:1794-1800). `use_pallas_raster`
    and `pallas_interpret` choose JAX backends and mean nothing here: the
    port's raster runs its CUDA kernel on CUDA tensors and its plain
    version on CPU tensors."""
    width: int = 1280
    height: int = 720
    # Upscaled presentation (reference: UpscalingManager.h:23-80 — render
    # low, accumulate + present high). 0 = native (no upscale). Requires
    # enable_taa (the jitter accumulation IS the detail recovery).
    output_width: int = 0
    output_height: int = 0
    tile_h: int = 32
    tile_w: int = 128
    max_pairs: int = 1 << 20          # (tile, triangle) bin capacity
    max_tiles_per_tri: int = 32       # small-tri fast path bin span cap
    max_big_tris: int = 256           # global large-triangle list capacity
    #                                   (span > max_tiles_per_tri tiles;
    #                                   multiple of 128 — raster DMA slabs)
    near_clip_tris: int = 256         # near-plane clip budget per pass
    #                                   (crossing tris -> up to 2 outputs;
    #                                   0 disables -> guard-band reject)
    # Group (sub-cluster) binning for clustered paths: pairs are
    # (32-row group, tile) instead of (triangle, tile) — the bin sort
    # shrinks ~GR x and the raster kernel DMAs each group's contiguous
    # setup rows straight from the lane table (no materialized pair
    # gather), skipping non-overlapping rows with a scalar bbox test
    # (ops/raster_setup.bin_groups, ops/raster_pallas group kernel).
    group_binning: bool = True
    group_rows: int = 32              # rows per BIN group (8, 16 or 32; the
    #                                   raster DMA slab stays 32 rows — finer
    #                                   groups only narrow the row walk)
    # Triangle-accurate ray-traced reflections over the resident cut
    # (ops/rt_reflect.py; reference: CLodRayTracingSystem + 
    # rayTracedReflections.rt.hlsl). Consumes SSR misses; voxel tier
    # remains the final fallback.
    enable_rt_reflect: bool = False
    rt_downscale: int = 4             # reflection ray grid = screen / ds
    rt_nodes_per_ray: int = 2         # BVH L1 nodes visited per ray
    rt_candidates: int = 4            # clusters intersected per node
    rt_ray_eps: float = 0.02          # self-intersection offset (world)
    # Hierarchical (window-level) pre-cull for the LOD cut: >0 enables the
    # budgeted two-phase cut (ops/clod.cut_slots_windowed) with this many
    # surviving 128-cluster windows; 0 = the O(C) separable scan. The
    # reference's DAG-frontier traversal analogue (computeCulling.hlsl:17-50)
    # — cut cost tracks the CUT, not the table capacity.
    cut_windows: int = 0
    max_group_pairs: int = 1 << 15    # (group, tile) bin capacity
    max_tiles_per_group: int = 16     # small-group bin span cap
    max_big_groups: int = 256         # global large-group list capacity
    #                                   (every tile box-tests each entry;
    #                                   slab DMA only on overlap)
    enable_shadows: bool = False
    num_cascades: int = 4
    shadow_resolution: int = 1024
    shadow_clusters: int = 512        # caster cut budget (x128 tris)
    max_shadow_lights: int = 0        # shadow-casting spot-light slots
    spot_shadow_resolution: int = 512
    max_shadow_cubes: int = 0         # shadow-casting point lights (6 faces)
    point_shadow_resolution: int = 256
    enable_clustered: bool = False
    max_lights_per_cluster: int = 64
    enable_ibl: bool = False
    ibl_specular_downscale: int = 4   # prefiltered radiance is low-frequency;
    #                                   ds4 cuts the per-pixel gathers 4x
    enable_textures: bool = False
    texture_downscale: int = 2
    # Atlas-at-rest format: "rgba8" | "bc3" (BC3-compressed block rows —
    # 4x less HBM + sampler gather bandwidth; models/textures.strip_pyramid
    # + ops/textures.bc3_decode_rows; reference: compressed-at-rest VRAM
    # textures, TextureProcessingManager).
    tex_format: str = "rgba8"
    texture_filter: str = "bilinear"   # "nearest" | "bilinear"
    # Which channel samples the frame traces (renderer derives from the
    # materials actually registered — unused channels cost nothing).
    tex_channels: Tuple[str, ...] = ("base", "normal", "mr", "emissive")
    # Streaming feedback priority aggregation (reference: CLodPriorityMode
    # Max/Sum, CLodCommon.h:50-53): "max" = worst oversized cluster per
    # group, "sum" = total demand across clusters.
    streaming_priority: str = "max"
    enable_bloom: bool = False
    enable_gtao: bool = False
    enable_ssr: bool = False
    # SSR cost = steps x (W/ds x H/ds) x ~7ns (per-element gather floor):
    # ds8/steps12 = ~2.7 ms at 1080p; ds4/steps8 was ~7 ms for little
    # visible gain after the bilinear upsample + roughness fade.
    ssr_steps: int = 12
    ssr_downscale: int = 8
    ssr_coarse_steps: int = 12   # hierarchical march: coarse bracket steps
    ssr_max_distance: float = 30.0
    ssr_thickness: float = 0.03
    # Voxel ray tier (ops/voxel_rt.py + models/voxels.py; reference:
    # CLodRayTracingSystem + VoxelGroupBuilder). voxel_n/level_offsets are
    # build constants of the scene's grid (static: the trace loop's shapes
    # and the flat-offset select chain depend on them). Cost = steps x
    # (W/ds x H/ds) x ~7ns: ds8/steps12 ~ 2.7 ms per consumer at 1080p.
    enable_voxel_rt: bool = False        # reflection cone trace (SSR miss)
    enable_voxel_fallback: bool = False  # primary-visibility hole fill
    voxel_n: int = 64
    voxel_sggx: bool = False   # anisotropic SGGX occlusion in cone traces
    #                            (two extra gathers per march step)
    voxel_level_offsets: Tuple[int, ...] = (0,)
    voxel_rt_downscale: int = 8
    voxel_rt_steps: int = 12
    voxel_primary_steps: int = 20
    # Texture streaming feedback (models/texstream.py): emit per-texture
    # finest-wanted mips for the renderer's readback loop.
    enable_texture_streaming: bool = False
    # Reyes micro-tessellation (ops/reyes.py; reference: Reyes*.cpp
    # split/dice). Parents over reyes_px projected edge with a
    # displacement material dice into reyes_dice^2 micro-tris each, within
    # a reyes_tris parent budget.
    enable_reyes: bool = False
    reyes_tris: int = 512
    reyes_dice: int = 4
    reyes_px: float = 48.0
    reyes_split_tris: int = 0     # split-stage budget: parents over
    #                               reyes_px*reyes_split_factor take a
    #                               4-way midpoint split before dicing
    #                               (the statically-unrolled analogue of
    #                               the reference's split ping-pong)
    reyes_split_factor: float = 4.0
    enable_taa: bool = False
    enable_oit: bool = False
    oit_layers: int = 4
    oit_clusters: int = 256           # transparent caster cut budget (x128)
    oit_max_lights: int = 8           # analytic lights per OIT layer shade
    #                                   (directional-first table prefix;
    #                                   0 = the full light table — a
    #                                   1000-light scene would otherwise
    #                                   shade every peel full-screen
    #                                   against every light)
    oit_overflow_probe: bool = True   # count beyond-K fragments (1 extra
    #                                   pass) + estimated transmittance
    oit_overflow_alpha: float = 0.5   # alpha estimate for beyond-K fade
    oit_max_pairs: int = 1 << 16      # transparent bin capacity (smaller
    #                                   than max_pairs: the sort-based
    #                                   binning prices by CAPACITY, and
    #                                   transparent geometry is sparse)
    enable_alpha_mask: bool = False   # alpha-cutoff (MASK) material pass
    enable_coat: bool = False         # OpenPBR clear-coat lobe
    enable_fuzz: bool = False         # OpenPBR fuzz (Charlie sheen) lobe
    enable_energy_comp: bool = False  # GGX multi-scatter energy LUT fit
    enable_sss: bool = False          # OpenPBR subsurface (wrap diffusion)
    enable_aniso: bool = False        # OpenPBR GGX anisotropy
    enable_transmission: bool = False  # OpenPBR transmission (via OIT peel)
    mask_clusters: int = 256          # masked caster cut budget (x128 tris)
    mask_peels: int = 1               # alpha-MASK depth layers (>=2 shows
    #                                   masked surfaces through failed-
    #                                   cutoff texels of nearer ones)
    enable_vertex_tangents: bool = False  # mikktspace tangent frames for
    #                                   normal maps/anisotropy (channel 6;
    #                                   clustered path, full residency);
    #                                   off = screen-derivative frames
    enable_auto_exposure: bool = False
    enable_skinning: bool = False
    enable_vsm: bool = False            # virtual shadow maps (ops/vsm.py)
    vsm_pages_per_frame: int = 4        # dirty-page render budget
    vsm_sample_downscale: int = 3   # atlas gather ~7ns/px: ds3 = ~1.6 ms
    vsm_mark_downscale: int = 4
    vsm_page_pairs: int = 1 << 15       # raster bin capacity per page
    vsm_page_clusters: int = 512        # cluster budget per page
    vsm_filter_taps: int = 1            # 1 = point, 4 = 2x2 PCF
    #                                     (each tap costs a per-pixel gather)
    vsm_rays: int = 0                   # SMRT quality tier: jittered rays
    #                                     toward the light cone (0 = off;
    #                                     cost = rays*samples gathers at the
    #                                     vsm sample rate)
    vsm_ray_samples: int = 3            # march samples per SMRT ray
    vsm_num_lights: int = 1             # VSM'd directional lights (each
    #                                     carries an independent page cache)
    vsm_page_size: int = 128            # texels per page edge
    vsm_levels: int = 6                 # clipmap levels
    vsm_page_grid: int = 8              # page-grid edge per level
    vsm_slots: int = 128                # physical pages in the pool
    vsm_base_extent: float = 16.0       # world extent of clipmap level 0
    enable_culling: bool = True
    enable_clod: bool = False        # cluster-LOD cut selection (ops/clod.py)
    enable_streaming: bool = False   # geometry page streaming feedback
    max_visible_clusters: int = 2048  # visible-cluster budget (x128 tris)
    max_phase2_clusters: int = 512    # occlusion phase-2 replay budget
    enable_occlusion: bool = False   # two-phase HZB occlusion culling
    hzb_levels: int = 8
    debug_view: str = "none"
    wireframe: bool = False           # overlay triangle edges on the image
    use_pallas_raster: bool = True
    pallas_interpret: bool = False   # interpret-mode Pallas (CPU tests)

    @property
    def tiles_x(self) -> int:
        return (self.width + self.tile_w - 1) // self.tile_w

    @property
    def tiles_y(self) -> int:
        return (self.height + self.tile_h - 1) // self.tile_h

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def padded_width(self) -> int:
        return self.tiles_x * self.tile_w

    @property
    def padded_height(self) -> int:
        return self.tiles_y * self.tile_h



@dataclasses.dataclass
class FrameParams:
    """Per-frame value settings (0-d tensors; never change the frame's
    structure)."""
    exposure: torch.Tensor
    bloom_intensity: torch.Tensor
    bloom_threshold: torch.Tensor
    ibl_intensity: torch.Tensor
    shadow_bias: torch.Tensor
    sky_intensity: torch.Tensor
    taa_blend: torch.Tensor
    gtao_radius: torch.Tensor
    gtao_intensity: torch.Tensor
    clod_error_px: torch.Tensor  # LOD cut threshold tau (pixels)
    frame_index: torch.Tensor  # i32
    light_size: float = 0.03  # tangent of the sun's angular radius

    @staticmethod
    def default(device="cuda") -> "FrameParams":
        def f(x):
            return torch.tensor(x, dtype=torch.float32, device=device)
        return FrameParams(
            exposure=f(1.0), bloom_intensity=f(0.04), bloom_threshold=f(1.0),
            ibl_intensity=f(1.0), shadow_bias=f(0.0015), sky_intensity=f(1.0),
            taa_blend=f(0.1), gtao_radius=f(0.5), gtao_intensity=f(1.0),
            clod_error_px=f(1.0),
            frame_index=torch.tensor(0, dtype=torch.int32, device=device),
        )

    def to(self, device) -> "FrameParams":
        return _to(self, device)
