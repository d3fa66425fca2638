"""Frame graph: composes the pass functions into one frame function.

Port of the soup-frame path of basicrenderer_tpu/graph/frame.py. The JAX
package traces the whole frame into one jit program; here the frame is a
plain function that queues its work on the device of its inputs (CUDA
tensors: the card, with the raster as a hand-written kernel; CPU tensors:
the plain versions).

Pass order (Renderer.cpp:2433-2754 in the reference): vertex transform ->
triangle setup (+ near-plane clip) -> object frustum cull -> tile binning
-> tile raster with fused attribute resolve -> G-buffer -> deferred shade
-> sky -> ACES -> sRGB.

Only the default `FrameConfig` structure is ported. Every structural
toggle of a later slice raises NotImplementedError naming its field.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..ops import culling, raster_setup
from ..ops import shade as shade_ops
from ..ops.raster import raster_tiles
from .framedata import FrameConfig, FrameParams, SceneBuffers, ViewData

# FrameConfig fields that switch on passes this port does not have yet,
# with the value that leaves the pass off.
_UNPORTED_TOGGLES = (
    ("enable_clod", False), ("enable_occlusion", False),
    ("enable_alpha_mask", False), ("enable_textures", False),
    ("enable_texture_streaming", False), ("enable_shadows", False),
    ("max_shadow_lights", 0), ("max_shadow_cubes", 0),
    ("enable_vsm", False), ("enable_clustered", False),
    ("enable_ibl", False), ("enable_ssr", False), ("enable_gtao", False),
    ("enable_bloom", False), ("enable_taa", False), ("enable_oit", False),
    ("enable_skinning", False), ("enable_reyes", False),
    ("enable_voxel_rt", False), ("enable_voxel_fallback", False),
    ("enable_rt_reflect", False), ("enable_streaming", False),
    ("enable_auto_exposure", False), ("output_width", 0),
    ("output_height", 0), ("debug_view", "none"), ("wireframe", False),
    ("enable_vertex_tangents", False), ("enable_coat", False),
    ("enable_fuzz", False), ("enable_energy_comp", False),
    ("enable_sss", False), ("enable_aniso", False),
    ("enable_transmission", False),
)


def check_config(config: FrameConfig) -> None:
    """Raise NotImplementedError for any structural toggle outside the
    ported soup frame."""
    for name, off in _UNPORTED_TOGGLES:
        if getattr(config, name) != off:
            raise NotImplementedError(
                f"FrameConfig.{name}={getattr(config, name)!r} is not ported "
                f"to basicrenderer_tpu_torch yet (supported: {off!r})")


def object_mask_to_tris(object_visible: torch.Tensor,
                        tri_object: torch.Tensor) -> torch.Tensor:
    """(O,) object visibility -> (T,) triangle mask."""
    return object_visible[torch.clamp(tri_object, min=0).long()]


def geometry_pass(scene: SceneBuffers, view: ViewData, config: FrameConfig,
                  stage_hook: Callable[[str], None] = None):
    """Setup + culled binning of the full soup with object-level frustum
    culling. Returns (clip, world_pos, world_normals, clip_overflow,
    pairs). `stage_hook("bin")` marks the start of the binning."""
    if config.enable_clod:
        raise NotImplementedError(
            "the cluster-LOD geometry path is not ported yet "
            "(FrameConfig.enable_clod)")
    clip, world_pos, world_normals = raster_setup.transform_geometry(
        scene.positions, scene.normals, scene.vert_object, scene.object_mats,
        scene.object_normal_mats, view.viewproj)
    tri_valid = scene.tri_object >= 0
    lanes, bbox, valid, clip_ovf = raster_setup.triangle_setup_packed(
        clip, scene.indices, tri_valid, config, world_normals, scene.uvs,
        scene.tri_material, scene.tri_object)
    if config.enable_culling:
        obj_vis = culling.frustum_cull_spheres(
            view.viewproj, scene.object_bounds[:, :3],
            scene.object_bounds[:, 3], scene.object_valid)
        tri_mask = object_mask_to_tris(obj_vis, scene.tri_object)
        if valid.shape[0] != tri_mask.shape[0]:
            # Near-clip rows appended past the soup cross the camera plane,
            # so no frustum-culled object owns them.
            tri_mask = torch.cat([tri_mask, torch.ones(
                valid.shape[0] - tri_mask.shape[0], dtype=torch.bool,
                device=tri_mask.device)])
        valid = valid & tri_mask
    if stage_hook is not None:
        stage_hook("bin")
    pairs = raster_setup.bin_pairs(lanes, bbox, valid, config)
    return clip, world_pos, world_normals, clip_ovf, pairs


def visibility_pass(pairs, lcfg: FrameConfig, tile_row0: int = 0):
    """Rasterize binned triangles -> (depth, vis, channels) on the padded
    tile grid, with the attribute resolve fused into the raster."""
    return raster_tiles(pairs, lcfg, tile_row0=tile_row0)


def _render_body(scene: SceneBuffers, view: ViewData, params: FrameParams,
                 config: FrameConfig,
                 stage_hook: Callable[[str], None] = None
                 ) -> Dict[str, torch.Tensor]:
    H, W = config.height, config.width
    dev = scene.positions.device

    def stage(name):
        if stage_hook is not None:
            stage_hook(name)

    # The light loop's bound, read once before this frame queues any work:
    # on the card the read then waits only for earlier frames, never for
    # this frame's raster.
    num_lights = int(scene.num_lights)

    stage("setup")
    clip, world_pos, world_normals, clip_ovf, pairs = geometry_pass(
        scene, view, config, stage_hook)
    stage("raster")
    depth_p, vis_p, channels = visibility_pass(pairs, config)
    stage("shade")

    depth = depth_p[:H, :W]
    vis = vis_p[:H, :W]
    gb = shade_ops.gbuffer_from_channels(
        channels[:, :H, :W], depth, vis, view, scene.material_table,
        config.width, config.height)
    hdr = shade_ops.shade_deferred(gb, scene, view, num_lights,
                                   coat=config.enable_coat,
                                   energy=config.enable_energy_comp,
                                   fuzz=config.enable_fuzz,
                                   sss=config.enable_sss,
                                   aniso=config.enable_aniso)
    sky = shade_ops.procedural_sky(view, H, W, params.sky_intensity)
    hdr = torch.where(gb.valid[..., None], hdr, sky)
    taa_out = hdr
    ldr = shade_ops.aces_tonemap(hdr * params.exposure)
    srgb = shade_ops.linear_to_srgb(ldr)
    image = (srgb * 255.0 + 0.5).to(torch.uint8)
    stage("end")
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return {
        "image": image,
        "hdr": hdr,
        "depth": depth,
        "depth_padded": depth_p,
        "vis": vis,
        "bin_overflow": pairs.overflow,
        "num_pairs": pairs.num_pairs,
        "cluster_overflow": clip_ovf,
        "light_overflow": zero,
        "oit_overflow": zero,
        "taa_out": taa_out,
    }


def build_frame_fn(config: FrameConfig) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns the frame function `frame(scene, view, params)` for
    `config`, after checking that every structural toggle of `config` is
    ported. The outputs carry the JAX frame's keys for this path.

    `frame(..., stage_hook=fn)` calls fn(name) as the frame enters each
    stage ("setup", "bin", "raster", "shade", "end"), so a caller can time the
    stages with CUDA events."""
    check_config(config)

    def frame(scene: SceneBuffers, view: ViewData, params: FrameParams,
              stage_hook: Callable[[str], None] = None
              ) -> Dict[str, torch.Tensor]:
        return _render_body(scene, view, params, config, stage_hook)

    return frame
