"""Order-independent transparency by K-layer depth peeling.

Port of basicrenderer_tpu/ops/oit.py (`composite_oit`), for a whole
frame or one screen-row shard of it (parallel/tile_sharding.py).
Clusters whose material has alpha_blend set carry the transparency flag
(cluster-table lane 10 = 1); the opaque pass leaves them out
(graph/frame.py) and this pass cuts and compacts them on their own, sets
them up, bins them at the transparent bin capacity and peels the K
nearest transparent layers in front of the opaque depth with the
rasters' peel mode (K1 or K2, by the pairs `bin_clustered` gives). Each
layer's channels come fused from its raster (the JAX package's portable
path resolves them with `resolve_attributes_ref`, K6's function; the
values are those of the same winning rows). With the overflow probe, an
accum raster over the band behind the K-th layer sums the tail's
optical depths, depth-warp-weighted colour and fragment count; the tail
attenuates and tints the background. The layers composite back to front
(with the OpenPBR transmission split when enable_transmission).

Where the JAX package skips a layer with `lax.cond` on the previous
layer's coverage, the port reads that coverage on the host: one
synchronisation for each layer after the first and one for the tail.
A skipped layer is empty and changes nothing, so it is neither
rastered nor shaded. A shard reads its own rows' coverage, as the JAX
package's `lax.cond` does under `shard_map`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..graph.framedata import FrameConfig, FrameParams, SceneBuffers, ViewData
from . import clod as clod_ops
from . import raster_setup
from . import shade as shade_ops
from .raster import raster_tiles

# The next layer must lie strictly behind this share of the previous one's
# depth: adjacent triangles evaluate slightly different planes at the same
# pixel, so a mesh's shared edge would otherwise peel as a phantom layer a
# few ulps behind the real one.
PEEL_EPS = 1e-4


def pack_probe_payload(lanes: torch.Tensor,
                       material_table: torch.Tensor) -> torch.Tensor:
    """The accum raster's per-triangle payload (JAX oit.py:53-86), on a
    copy of `lanes`: lane 30 = a8 + odr8*256 + odg8*65536 and lane 31 =
    odb8, the material's alpha and per-channel optical depth
    -ln(T_c)/4 of its layer transmittance T_c = (1-tw)(1-a) + tw*tint_c,
    8-bit quantised; lane 28 = r8 + g8*256 + b8*65536, the albedo times the
    non-transmissive coverage a*(1-tw). Dead rows get zeros."""
    M = material_table.shape[0]
    mat_ids = torch.clamp(torch.remainder(
        lanes[:, 10], raster_setup.OBJ_COMBO).to(torch.int32), 0, M - 1)
    mrow = material_table[mat_ids.long()]
    a_tri = torch.clamp(mrow[:, 3], 0.0, 1.0)
    tw_tri = torch.clamp(mrow[:, 30], 0.0, 1.0)
    tint = torch.clamp(mrow[:, 32:35], 0.0, 1.0)
    t_c = torch.clamp((1.0 - tw_tri[:, None]) * (1.0 - a_tri[:, None])
                      + tw_tri[:, None] * tint, 0.02, 1.0)
    od8 = torch.round(torch.clamp(-torch.log(t_c) * 0.25, 0.0, 1.0) * 255.0)
    a8 = torch.round(a_tri * 255.0)
    live = lanes[:, 9] > 0.5
    c8 = torch.round(torch.clamp(mrow[:, 0:3], 0.0, 1.0)
                     * (a_tri * (1.0 - tw_tri))[:, None] * 255.0)
    out = lanes.clone()
    out[:, 30] = torch.where(live, a8 + od8[:, 0] * 256.0
                             + od8[:, 1] * 65536.0, 0.0)
    out[:, 31] = torch.where(live, od8[:, 2], 0.0)
    out[:, 28] = torch.where(live, c8[:, 0] + c8[:, 1] * 256.0
                             + c8[:, 2] * 65536.0, 0.0)
    return out


def _layer_terms(gb: shade_ops.GBuffer, col: torch.Tensor,
                 view: ViewData, transmission: bool):
    """(premultiplied surface term, per-channel background transmittance)
    of one shaded layer. Without transmission: col*a and 1-a. With it
    (OpenPBR transmissionWeight/Color): the covered part splits into an
    opaque share (1 - tw) that alpha-blends and a transmissive share that
    tints the background by the colour, scaled by 1 - Fresnel."""
    a = torch.clamp(gb.alpha, 0.0, 1.0)[..., None]
    if not transmission:
        return col * a, 1.0 - a
    tw = torch.clamp(gb.trans_weight, 0.0, 1.0)[..., None]
    vdir = view.cam_pos[None, None, :] - gb.world_pos
    vdir = vdir / torch.clamp(torch.linalg.vector_norm(vdir, dim=-1,
                                                       keepdim=True), min=1e-9)
    ndv = torch.clamp(torch.sum(gb.normal * vdir, -1), min=1e-4)
    f0 = ((gb.ior - 1.0) / (gb.ior + 1.0)) ** 2
    F = shade_ops._f_schlick(ndv[..., None], f0[..., None])
    tint = torch.clamp(gb.trans_color, 0.0, 1.0)
    trans3 = (1.0 - a) * (1.0 - tw) + tw * tint * (1.0 - F)
    surf3 = col * (a * (1.0 - tw) + tw)
    return surf3, trans3


def composite_oit(scene: SceneBuffers, view: ViewData, config: FrameConfig,
                  params: FrameParams, opaque_depth_p: torch.Tensor,
                  hdr: torch.Tensor, num_lights: int,
                  stage_hook: Optional[Callable[[str], None]] = None,
                  lcfg: FrameConfig = None, row0_tiles: int = 0,
                  localize: Callable = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Renders the K = config.oit_layers nearest transparent layers in
    front of `opaque_depth_p` (the padded opaque depth) onto `hdr`
    (H, W, 3), with the beyond-K tail when config.oit_overflow_probe.
    `num_lights` is the live light count read on the host; each layer
    shades min(num_lights, config.oit_max_lights) lights (all of them when
    oit_max_lights is 0). Returns (hdr, oit_overflow): the count of pixels
    with a fragment beyond the K-th layer (0 without the probe).
    `stage_hook(name)` marks "oit_cut", "oit_setup", "oit_bin",
    "oit_peel<k>" for each layer rastered, "oit_accum", "oit_shade" and
    "oit_composite".

    `lcfg`, `row0_tiles` and `localize` place a screen-row shard in the
    frame (graph/frame._render_body): `lcfg` is the shard's config (its
    height), `row0_tiles` its first tile row, `localize(pairs)` slices
    the full-screen tile offsets to the shard's tiles. The cut, the setup
    and the binning are full-screen (the same on every shard); the layers
    raster only the shard's tile rows, and `hdr` and `opaque_depth_p` are
    the shard's rows."""
    if lcfg is None:
        lcfg = config
    if localize is None:
        def localize(p):
            return p

    def stage(name):
        if stage_hook is not None:
            stage_hook(name)

    H, W = lcfg.height, config.width
    dev = hdr.device
    stage("oit_cut")
    cut, _ = clod_ops.select_cluster_cut(scene, view, config,
                                         params.clod_error_px)
    flag = scene.cluster_table[:, 10]
    cut = cut & (flag > 0.5) & (flag < 1.5)            # 2 = alpha-MASK
    comp = clod_ops.compact_visible_tris(cut=cut, scene=scene,
                                         max_visible=config.oit_clusters)
    stage("oit_setup")
    lanes, bbox, valid, _clip_ovf = raster_setup.setup_from_compacted(
        scene, comp, view.viewproj, config)
    if config.oit_overflow_probe:
        lanes = pack_probe_payload(lanes, scene.material_table)
    stage("oit_bin")
    # Transparent binning at its own (smaller) pair capacity.
    bcfg = dataclasses.replace(
        config, max_pairs=min(config.oit_max_pairs, config.max_pairs))
    pairs = localize(raster_setup.bin_clustered(lanes, bbox, valid, bcfg))

    peel_bound = torch.full((lcfg.padded_height, lcfg.padded_width),
                            float("inf"), dtype=torch.float32, device=dev)
    layers = []
    live = True          # the previous layer has coverage
    for k in range(config.oit_layers):
        if not live:
            break
        stage(f"oit_peel{k}")
        d, v, ch = raster_tiles(pairs, lcfg, tile_row0=row0_tiles,
                                peel=(opaque_depth_p, peel_bound))
        layers.append((d, v, ch))
        peel_bound = torch.where(v > 0, d * (1.0 - PEEL_EPS), 0.0)
        if k + 1 < config.oit_layers or config.oit_overflow_probe:
            live = bool((v > 0).any())      # the host read

    acc = None
    if config.oit_overflow_probe and live:
        stage("oit_accum")
        acc = raster_tiles(pairs, lcfg, tile_row0=row0_tiles,
                           peel=(opaque_depth_p, peel_bound), accum=True)[2]

    stage("oit_shade")
    n_lights = (num_lights if config.oit_max_lights <= 0
                else min(num_lights, config.oit_max_lights))
    shaded = []
    for d, v, ch in layers:
        gb = shade_ops.gbuffer_from_channels(
            ch[:, :H, :W], d[:H, :W], v[:H, :W], view, scene.material_table,
            config.width, config.height, row0=row0_tiles * config.tile_h)
        col = shade_ops.shade_deferred(
            gb, scene, view, n_lights,
            transmission=config.enable_transmission)
        surf3, trans3 = _layer_terms(gb, col, view,
                                     config.enable_transmission)
        shaded.append((surf3, trans3, (v[:H, :W] > 0)[..., None]))

    stage("oit_composite")
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    if acc is not None:
        # The tail: exp(-sum od_c) per channel over the background, plus
        # the depth-warp-weighted colour average with the mean-od coverage.
        overflow = torch.sum(acc[7][:H, :W] > 0.5).to(torch.int32)
        od = acc[4:7, :H, :W]
        t3 = torch.exp(-od).permute(1, 2, 0)
        wa = acc[0, :H, :W]
        cbar = acc[1:4, :H, :W].permute(1, 2, 0) \
            / torch.clamp(wa, min=1e-6)[..., None]
        a_tail = 1.0 - torch.exp(-torch.mean(od, dim=0))
        hdr = hdr * t3 + cbar * a_tail[..., None]
    out = hdr
    for surf3, trans3, covered in reversed(shaded):
        out = torch.where(covered, surf3 + out * trans3, out)
    return out, overflow
