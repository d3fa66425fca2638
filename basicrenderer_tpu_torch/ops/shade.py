"""Visibility-buffer resolve + deferred PBR shading.

Port of the base path of basicrenderer_tpu/ops/shade.py: the G-buffer from
the raster's channel planes, Cook-Torrance GGX + Lambert per analytic
light, ACES tonemapping, sRGB encoding and the procedural sky, and the
OpenPBR extension lobes: transmission (the OIT layers' shading,
ops/oit.py), clear coat, fuzz (Charlie sheen), Kulla-Conty energy
compensation (ops/brdf_energy.py), subsurface wrap diffusion and GGX
anisotropy along the screen-derivative tangent frame.

Reference analogue: shaders/VisUtilEvaluate.hlsl (G-buffer resolve) and
shaders/deferred.hlsl + PBR.hlsli (full-screen Cook-Torrance).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..graph.framedata import SceneBuffers, ViewData
from ..utils import math3d
from . import brdf_energy
from .raster_setup import OBJ_COMBO
from .textures import _ddx, _ddy


class GBuffer(NamedTuple):
    """The G-buffer of the frame: surface attributes and the OpenPBR
    extension inputs, per pixel."""
    world_pos: torch.Tensor   # (H, W, 3) f32
    normal: torch.Tensor      # (H, W, 3) f32 (world space, normalized)
    albedo: torch.Tensor      # (H, W, 3) f32 (linear)
    metallic: torch.Tensor    # (H, W) f32
    roughness: torch.Tensor   # (H, W) f32
    emissive: torch.Tensor    # (H, W, 3) f32
    valid: torch.Tensor       # (H, W) bool (covered by geometry)
    depth: torch.Tensor       # (H, W) f32 (reverse-Z NDC)
    material_id: torch.Tensor  # (H, W) i32
    uv: torch.Tensor          # (H, W, 2) f32
    alpha: torch.Tensor       # (H, W) f32 material base alpha
    object_id: torch.Tensor   # (H, W) i32 owning object (-1 = sky)
    base_tex: torch.Tensor    # (H, W) i32 base-colour texture id (-1 none)
    normal_tex: torch.Tensor  # (H, W) i32 normal texture id (-1 none)
    mr_tex: torch.Tensor      # (H, W) i32 metallic-roughness texture id
    emissive_tex: torch.Tensor  # (H, W) i32 emissive texture id
    normal_scale: torch.Tensor  # (H, W) f32 glTF normalTexture.scale
    trans_weight: torch.Tensor  # (H, W) f32 OpenPBR transmission weight
    trans_color: torch.Tensor   # (H, W, 3) f32 transmission tint
    trans_depth: torch.Tensor   # (H, W) f32 Beer-Lambert depth
    ior: torch.Tensor           # (H, W) f32 index of refraction
    tangent_theta: torch.Tensor  # (H, W) f32 encoded per-triangle tangent
    #                              (channel 5; tangent_from_theta decodes;
    #                              read with enable_vertex_tangents)
    coat_weight: torch.Tensor   # (H, W) f32 OpenPBR coat weight
    coat_rough: torch.Tensor    # (H, W) f32 coat roughness
    fuzz_weight: torch.Tensor   # (H, W) f32 OpenPBR fuzz weight
    fuzz_rough: torch.Tensor    # (H, W) f32 fuzz roughness
    sss_weight: torch.Tensor    # (H, W) f32 OpenPBR subsurface weight
    sss_color: torch.Tensor     # (H, W, 3) f32 subsurface tint
    sss_radius: torch.Tensor    # (H, W) f32 wrap-diffusion width
    aniso_strength: torch.Tensor  # (H, W) f32 GGX anisotropy
    aniso_rotation: torch.Tensor  # (H, W) f32 tangent rotation (rad)


def _iota(n: int, dim: int, shape, dev) -> torch.Tensor:
    """f32 index along `dim` broadcast to `shape` (jax.lax.broadcasted_iota)."""
    v = torch.arange(n, dtype=torch.float32, device=dev)
    view = [1] * len(shape)
    view[dim] = n
    return v.view(view).expand(shape)


def oct_decode_cols(ou, ov):
    """Octahedral (ou, ov) in [-1, 1] -> unit normal component planes
    (inverse of raster_setup.oct_encode_cols)."""
    z = 1.0 - torch.abs(ou) - torch.abs(ov)
    t = torch.clamp(-z, min=0.0)
    x = ou - torch.where(ou >= 0.0, t, -t)
    y = ov - torch.where(ov >= 0.0, t, -t)
    rl = torch.rsqrt(torch.clamp(x * x + y * y + z * z, min=1e-20))
    return x * rl, y * rl, z * rl


def _onb(n: torch.Tensor):
    """Branchless canonical ONB of a unit normal (Duff et al. / revised
    Frisvad), the construction raster_setup.encode_theta_cols encodes
    against."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t0 = torch.stack([1.0 + s * n[..., 0] ** 2 * a, s * b, -s * n[..., 0]],
                     -1)
    b0 = torch.stack([b, s + n[..., 1] ** 2 * a, -n[..., 1]], -1)
    return t0, b0


def tangent_from_theta(n: torch.Tensor, enc: torch.Tensor):
    """Decode the per-triangle tangent angle (+4pi = negative handedness,
    raster_setup.encode_theta_cols) against the interpolated pixel normal
    n (..., 3). Returns (T, B), each (..., 3), orthonormal to n, B
    carrying the handedness."""
    neg = enc > 2.0 * math.pi
    w = torch.where(neg, -1.0, 1.0)
    theta = enc - torch.where(neg, 4.0 * math.pi, 0.0)
    t0, b0 = _onb(n)
    t = torch.cos(theta)[..., None] * t0 + torch.sin(theta)[..., None] * b0
    t = t - n * torch.sum(t * n, -1, keepdim=True)
    t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True),
                        min=1e-9)
    return t, torch.linalg.cross(n, t, dim=-1) * w[..., None]


def inv_w_from_depth(depth: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """1/clip.w recovered from the depth buffer: for a projection with
    clip.z = A*vz + B and clip.w = P32*vz, z_ndc = A/P32 + B*(1/w)."""
    za = proj[2, 2] / torch.where(torch.abs(proj[3, 2]) > 1e-20, proj[3, 2], 1.0)
    zb = torch.where(torch.abs(proj[2, 3]) > 1e-20, proj[2, 3], 1.0)
    return (depth - za) / zb


def _inverse(m: torch.Tensor) -> torch.Tensor:
    """f32 matrix inverse without the error check's host synchronisation."""
    return torch.linalg.inv_ex(m)[0]


def gbuffer_from_channels(channels: torch.Tensor, depth: torch.Tensor,
                          vis: torch.Tensor, view: ViewData,
                          material_table: torch.Tensor,
                          full_w: int, full_h: int, row0=0) -> GBuffer:
    """Build the GBuffer from the raster's channel images (no per-vertex
    gathers).

    channels: (8, H, W) = [octu/w, octv/w, u/w, v/w, mat_id, tangent,
    unused, accum] cropped to the visible region (1/w derives from
    `depth`; normals decode from the two octahedral channels).
    """
    H, W = depth.shape
    dev = depth.device
    covered = vis > 0
    inv_w = inv_w_from_depth(depth, view.proj)
    safe_iw = torch.where(torch.abs(inv_w) > 1e-12, inv_w, 1.0)
    nrm = torch.stack(oct_decode_cols(channels[0] / safe_iw,
                                      channels[1] / safe_iw), dim=-1)
    uv = torch.stack([channels[2] / safe_iw, channels[3] / safe_iw], dim=-1)
    # Channel 4 carries material + OBJ_COMBO * object (ops/raster_setup.py).
    combo = torch.round(channels[4]).to(torch.int32)
    mat_id = torch.remainder(combo, OBJ_COMBO)
    object_id = torch.div(combo, OBJ_COMBO, rounding_mode="floor")

    # World position from depth (reverse-Z NDC) + inverse viewproj.
    ndc_x = (_iota(W, 1, (H, W), dev) + 0.5) / full_w * 2.0 - 1.0
    ndc_y = 1.0 - (_iota(H, 0, (H, W), dev) + 0.5 + row0) / full_h * 2.0
    inv_vp = _inverse(view.viewproj)
    wx, wy, wz, ww = math3d.mat4_columns(inv_vp, ndc_x, ndc_y, depth)
    iw = 1.0 / torch.where(torch.abs(ww) > 1e-12, ww, 1.0)
    wp = torch.stack([wx * iw, wy * iw, wz * iw], dim=-1)

    flat_ids = torch.clamp(mat_id.reshape(-1), 0,
                           material_table.shape[0] - 1).long()
    mat = material_table[flat_ids]                        # (HW, MAT_STRIDE)
    albedo = mat[:, 0:3].reshape(H, W, 3)
    alpha = mat[:, 3].reshape(H, W)
    metallic = mat[:, 4].reshape(H, W)
    roughness = mat[:, 5].reshape(H, W)
    emissive = mat[:, 6:9].reshape(H, W, 3)

    def tex_id(lane):
        return torch.where(covered, torch.round(mat[:, lane]).to(torch.int32)
                           .reshape(H, W), -1)

    c3 = covered[..., None]
    return GBuffer(
        world_pos=torch.where(c3, wp, 0.0),
        normal=torch.where(c3, nrm, 0.0),
        albedo=torch.where(c3, albedo, 0.0),
        metallic=torch.where(covered, metallic, 0.0),
        roughness=torch.where(covered, roughness, 1.0),
        emissive=torch.where(c3, emissive, 0.0),
        valid=covered,
        depth=depth,
        material_id=torch.where(covered, mat_id, -1),
        uv=torch.where(c3, uv, 0.0),
        alpha=torch.where(covered, alpha, 0.0),
        object_id=torch.where(covered, object_id, -1),
        base_tex=tex_id(13), normal_tex=tex_id(14), mr_tex=tex_id(15),
        emissive_tex=tex_id(16),
        normal_scale=torch.where(covered, mat[:, 9].reshape(H, W), 1.0),
        trans_weight=torch.where(covered, mat[:, 30].reshape(H, W), 0.0),
        trans_color=torch.where(c3, mat[:, 32:35].reshape(H, W, 3), 1.0),
        trans_depth=torch.clamp(mat[:, 31].reshape(H, W), min=1e-4),
        ior=torch.where(covered, mat[:, 12].reshape(H, W), 1.5),
        tangent_theta=channels[5],
        coat_weight=torch.where(covered, mat[:, 18].reshape(H, W), 0.0),
        coat_rough=torch.clamp(mat[:, 19].reshape(H, W), 0.05, 1.0),
        fuzz_weight=torch.where(covered, mat[:, 22].reshape(H, W), 0.0),
        fuzz_rough=torch.clamp(mat[:, 23].reshape(H, W), 0.05, 1.0),
        sss_weight=torch.where(covered, mat[:, 36].reshape(H, W), 0.0),
        sss_color=torch.where(c3, mat[:, 37:40].reshape(H, W, 3), 1.0),
        sss_radius=torch.clamp(mat[:, 40].reshape(H, W), 0.0, 1.0),
        aniso_strength=torch.where(covered, mat[:, 41].reshape(H, W), 0.0),
        aniso_rotation=mat[:, 42].reshape(H, W),
    )


# ---------------------------------------------------------------------------
# GGX / Cook-Torrance BRDF (reference: shaders/Include/PBR.hlsli)
# ---------------------------------------------------------------------------

def _d_ggx(n_dot_h, alpha):
    a2 = alpha * alpha
    d = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(math.pi * d * d, min=1e-8)


def _g_smith(n_dot_v, n_dot_l, alpha):
    # Height-correlated Smith visibility (matches UE4/reference's PBR.hlsli)
    a2 = alpha * alpha
    gv = n_dot_l * torch.sqrt(torch.clamp(n_dot_v * n_dot_v * (1 - a2) + a2, min=1e-12))
    gl = n_dot_v * torch.sqrt(torch.clamp(n_dot_l * n_dot_l * (1 - a2) + a2, min=1e-12))
    return 0.5 / torch.clamp(gv + gl, min=1e-8)


def _f_schlick(v_dot_h, f0):
    return f0 + (1.0 - f0) * torch.pow(torch.clamp(1.0 - v_dot_h, 0.0, 1.0), 5.0)


def _dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def _normalize(v, eps):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=eps)


def tangent_frame(world_pos: torch.Tensor, uv: torch.Tensor,
                  normal: torch.Tensor, rotation: torch.Tensor):
    """Screen-derivative cotangent frame (Schueler), rotated about the
    normal by `rotation` (H, W) radians: the anisotropy tangent.
    Returns (T, B) each (H, W, 3); degenerate UV areas fall back to an
    arbitrary normal-orthogonal frame."""
    dpdx, dpdy = _ddx(world_pos), _ddy(world_pos)
    dudx, dudy = _ddx(uv[..., 0]), _ddy(uv[..., 0])
    dvdx, dvdy = _ddx(uv[..., 1]), _ddy(uv[..., 1])
    det = dudx * dvdy - dudy * dvdx
    t = dpdx * dvdy[..., None] - dpdy * dvdx[..., None]
    t = t - normal * _dot(t, normal)
    tlen = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
    dev = normal.device
    up = torch.where(torch.abs(normal[..., 1:2]) < 0.9,
                     torch.tensor([0.0, 1.0, 0.0], device=dev),
                     torch.tensor([1.0, 0.0, 0.0], device=dev))
    alt = _normalize(torch.linalg.cross(up * torch.ones_like(normal), normal,
                                        dim=-1), 1e-9)
    ok = (torch.abs(det) > 1e-12) & (tlen[..., 0] > 1e-9)
    t = torch.where(ok[..., None], t / torch.clamp(tlen, min=1e-9), alt)
    b = torch.linalg.cross(normal, t, dim=-1)
    c = torch.cos(rotation)[..., None]
    s = torch.sin(rotation)[..., None]
    t = t * c + b * s
    return t, torch.linalg.cross(normal, t, dim=-1)


def eval_brdf(n, v, l, albedo, metallic, roughness, spec_scale=None,
              sss=None, trans_w=None, aniso=None):
    """Cook-Torrance specular + Lambert diffuse; all (..., 3)/(...,) tensors.
    Returns the radiance factor to multiply by the light's radiance.
    `spec_scale` (..., 3) multiplies the specular lobe only (the
    Kulla-Conty compensation). OpenPBR extensions:
    - `sss` = (weight, color3, radius): wrap-diffusion subsurface replaces
      the Lambert term by weight (light bleeds past the terminator by the
      radius, tinted by the colour; white furnace kept for colour 1);
    - `trans_w` (H, W): the transmission weight removes that share of the
      diffuse lobe (the light passes through; ops/oit.py tints the
      background instead);
    - `aniso` = (T, B, strength): anisotropic GGX along the tangent frame
      (Burley parameterisation, Heitz height-correlated visibility)."""
    h = _normalize(l + v, 1e-12)
    ndl_s = _dot(n, l)
    n_dot_l = torch.clamp(ndl_s, min=0.0)
    n_dot_v = torch.clamp(_dot(n, v), min=1e-4)
    n_dot_h = torch.clamp(_dot(n, h), min=0.0)
    v_dot_h = torch.clamp(_dot(v, h), min=0.0)
    alpha = torch.clamp(roughness[..., None] ** 2, min=1e-3)
    f0 = 0.04 * (1.0 - metallic[..., None]) + albedo * metallic[..., None]
    F = _f_schlick(v_dot_h, f0)
    if aniso is not None:
        T, B, strength = aniso
        s = torch.clamp(strength, 0.0, 0.98)[..., None]
        ax = torch.clamp(alpha * (1.0 + s), min=1e-3)
        ay = torch.clamp(alpha * (1.0 - s), min=1e-3)
        t_h, b_h = _dot(T, h), _dot(B, h)
        t_v, b_v = _dot(T, v), _dot(B, v)
        t_l, b_l = _dot(T, l), _dot(B, l)
        d = (t_h / ax) ** 2 + (b_h / ay) ** 2 + n_dot_h ** 2
        D = 1.0 / torch.clamp(math.pi * ax * ay * d * d, min=1e-8)
        lv = n_dot_l * torch.sqrt(torch.clamp(
            (t_v * ax) ** 2 + (b_v * ay) ** 2 + n_dot_v ** 2, min=1e-12))
        ll = n_dot_v * torch.sqrt(torch.clamp(
            (t_l * ax) ** 2 + (b_l * ay) ** 2 + n_dot_l ** 2, min=1e-12))
        Vis = 0.5 / torch.clamp(lv + ll, min=1e-8)
    else:
        D = _d_ggx(n_dot_h, alpha)
        Vis = _g_smith(n_dot_v, n_dot_l, alpha)
    specular = D * Vis * F
    if spec_scale is not None:
        specular = specular * spec_scale
    kd = (1.0 - F) * (1.0 - metallic[..., None])
    diffuse = kd * albedo / math.pi * n_dot_l
    if sss is not None:
        w8, scol, rad = sss
        wrap = torch.clamp(rad, 0.0, 1.0)[..., None]
        wrapped = torch.clamp((ndl_s + wrap) / ((1.0 + wrap) ** 2), 0.0, 1.0)
        sss_d = kd * albedo * scol / math.pi * wrapped
        diffuse = diffuse + w8[..., None] * (sss_d - diffuse)
    if trans_w is not None:
        diffuse = diffuse * (1.0 - trans_w[..., None])
    return diffuse + specular * n_dot_l


def coat_f0(dev) -> torch.Tensor:
    """The coat's F0 as an f32 scalar (1 - F0 is then rounded in f32, as
    the JAX package's jnp.float32(0.05) is)."""
    return torch.tensor(0.05, dtype=torch.float32, device=dev)


def apply_coat(base: torch.Tensor, gb: GBuffer, n: torch.Tensor,
               v: torch.Tensor, l: torch.Tensor, radiance: torch.Tensor
               ) -> torch.Tensor:
    """OpenPBR clear coat: a second GGX lobe at the coat roughness over an
    attenuated base. Coat F0 ~0.05 (ior 1.6); energy: base *= (1 - Fc *
    weight)."""
    w = gb.coat_weight[..., None]
    h = _normalize(l + v, 1e-12)
    n_dot_l = torch.clamp(_dot(n, l), min=0.0)
    n_dot_v = torch.clamp(_dot(n, v), min=1e-4)
    n_dot_h = torch.clamp(_dot(n, h), min=0.0)
    v_dot_h = torch.clamp(_dot(v, h), min=0.0)
    alpha = torch.clamp(gb.coat_rough[..., None] ** 2, min=1e-3)
    Fc = _f_schlick(v_dot_h, coat_f0(n.device))
    spec = _d_ggx(n_dot_h, alpha) * _g_smith(n_dot_v, n_dot_l, alpha) * Fc
    return base * (1.0 - Fc * w) + spec * n_dot_l * radiance * w


def openpbr_terms(gb: GBuffer, v: torch.Tensor, n: torch.Tensor,
                  energy: bool, fuzz: bool):
    """Light-independent OpenPBR factors, computed once a frame and shared
    by every light pass: the Kulla-Conty specular compensation (..., 3)
    with `energy` and the fuzz layer's directional albedo (H, W) with
    `fuzz`, each None when off."""
    ndv = torch.clamp(torch.sum(n * v, -1), min=1e-4)
    spec_comp = None
    if energy:
        f0 = 0.04 * (1.0 - gb.metallic[..., None]) \
            + gb.albedo * gb.metallic[..., None]
        spec_comp = brdf_energy.energy_compensation(f0, ndv, gb.roughness)
    fuzz_e = None
    if fuzz:
        fuzz_e = gb.fuzz_weight * brdf_energy.sheen_energy(ndv, gb.fuzz_rough)
    return spec_comp, fuzz_e


def view_terms(gb: GBuffer, view: ViewData, energy: bool, fuzz: bool):
    """(v, spec_comp, fuzz_e): the unit view directions (H, W, 3) and
    openpbr_terms' factors, computed once a frame and shared by the
    deferred loop and the shadowed local-light passes."""
    v = _normalize(view.cam_pos[None, None, :] - gb.world_pos, 1e-12)
    return (v,) + openpbr_terms(gb, v, gb.normal, energy, fuzz)


def shade_one_light(gb: GBuffer, row: torch.Tensor, v: torch.Tensor,
                    n: torch.Tensor, directional_only: bool = False,
                    coat: bool = False, spec_comp=None, fuzz_e=None,
                    sss=None, trans_w=None, aniso=None) -> torch.Tensor:
    """Full-screen contribution of ONE packed light row (H, W, 3), shared
    by the deferred loop and the shadowed local-light passes.
    `spec_comp`/`fuzz_e` are openpbr_terms' factors; `coat` layers the
    clear coat over the result."""
    lpos, ltype = row[0:3], row[3]
    ldir, intensity = row[4:7], row[7]
    color, rng = row[8:11], row[11]
    cos_in, cos_out = row[12], row[13]
    is_dir = ltype == 0.0
    to_light = torch.where(is_dir, -ldir[None, None, :],
                           lpos[None, None, :] - gb.world_pos)
    dist = torch.linalg.vector_norm(to_light, dim=-1, keepdim=True)
    l = to_light / torch.clamp(dist, min=1e-9)
    # Inverse-square falloff with range window (reference lighting.hlsli).
    att = torch.where(is_dir, 1.0, 1.0 / torch.clamp(dist * dist, min=1e-4))
    window = torch.clamp(1.0 - (dist / torch.clamp(rng, min=1e-3)) ** 4,
                         0.0, 1.0) ** 2
    att = torch.where(is_dir, att, att * window)
    # Spot cone.
    cd = torch.sum(-l * ldir[None, None, :], dim=-1, keepdim=True)
    spot = torch.clamp((cd - cos_out) / torch.clamp(cos_in - cos_out, min=1e-4),
                       0.0, 1.0)
    att = torch.where(ltype == 2.0, att * spot * spot, att)
    radiance = color[None, None, :] * (intensity * att)
    out = eval_brdf(n, v, l, gb.albedo, gb.metallic, gb.roughness,
                    spec_scale=spec_comp, sss=sss, trans_w=trans_w,
                    aniso=aniso) * radiance
    if fuzz_e is not None:
        # The Charlie-sheen lobe layered over the base, which the layer's
        # directional albedo attenuates.
        sheen = brdf_energy.eval_sheen(n, v, l, gb.fuzz_rough) \
            * gb.fuzz_weight[..., None]
        out = out * (1.0 - fuzz_e[..., None]) + sheen * radiance
    if coat:
        out = apply_coat(out, gb, n, v, l, radiance)
    if directional_only:
        out = out * torch.where(ltype == 0.0, 1.0, 0.0)
    return out


def shade_deferred(gb: GBuffer, scene: SceneBuffers, view: ViewData,
                   num_lights: int, shadow_fn=None, ambient: float = 0.0,
                   directional_only: bool = False, coat: bool = False,
                   energy: bool = False, fuzz: bool = False,
                   sss: bool = False, aniso: bool = False,
                   transmission: bool = False, terms=None,
                   aniso_frame=None) -> torch.Tensor:
    """Full-screen deferred lighting -> HDR (H, W, 3).

    `num_lights` is the light loop's bound as a host integer: the live
    light count (or, with `directional_only`, the directional prefix). The
    JAX package loops to a traced device scalar; here the caller reads the
    count once per frame before queuing any work (see graph/frame.py), so
    the loop runs exactly the live lights and queues no masked passes.
    The flags switch on the OpenPBR lobes: `coat`, `energy` (Kulla-Conty),
    `fuzz`, `sss`, `aniso` (in the screen-derivative tangent frame rotated
    by the material's angle) and `transmission` (each light's diffuse lobe
    loses the pixel's transmission weight). The light-independent inputs
    are computed once and shared by every light; `terms` hands in
    view_terms' result when the caller already has it, `aniso_frame` the
    tangent frame's (T, B) (a shard's, made with its neighbours' rows).
    """
    H, W = gb.valid.shape
    n = gb.normal
    v, spec_comp, fuzz_e = terms or view_terms(gb, view, energy, fuzz)
    sss_t = (gb.sss_weight, gb.sss_color, gb.sss_radius) if sss else None
    trans_w = gb.trans_weight if transmission else None
    aniso_t = None
    if aniso:
        T, B = aniso_frame or tangent_frame(gb.world_pos, gb.uv, n,
                                            gb.aniso_rotation)
        aniso_t = (T, B, gb.aniso_strength)
    total = torch.zeros((H, W, 3), dtype=torch.float32, device=gb.valid.device)
    for i in range(num_lights):
        out = shade_one_light(gb, scene.lights[i], v, n,
                              directional_only=directional_only, coat=coat,
                              spec_comp=spec_comp, fuzz_e=fuzz_e, sss=sss_t,
                              trans_w=trans_w, aniso=aniso_t)
        if shadow_fn is not None:
            out = out * shadow_fn(i, gb.world_pos, n)[..., None]
        total = total + out
    total = total + gb.emissive + ambient * gb.albedo
    return torch.where(gb.valid[..., None], total, 0.0)


# ---------------------------------------------------------------------------
# Tonemapping + sky (reference: Tonemapping.h AMD LPM path + skybox.hlsl)
# ---------------------------------------------------------------------------

def aces_tonemap(hdr: torch.Tensor) -> torch.Tensor:
    """Narkowicz ACES fit (reference offers LPM/ACES variants)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    x = hdr
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.0031308, x * 12.92,
                       1.055 * torch.pow(torch.clamp(x, min=1e-8), 1.0 / 2.4) - 0.055)


def procedural_sky(view: ViewData, H: int, W: int, intensity=1.0,
                   row0=0, full_h: int = None) -> torch.Tensor:
    """Gradient sky for pixels with no geometry. `row0`/`full_h` place an
    (H, W) screen-row shard inside the full frame."""
    if full_h is None:
        full_h = H
    dev = view.viewproj.device
    x = (_iota(W, 1, (H, W), dev) + 0.5) / W * 2.0 - 1.0
    y = 1.0 - (_iota(H, 0, (H, W), dev) + 0.5 + row0) / full_h * 2.0
    inv_vp = _inverse(view.viewproj)
    wx, wy, wz, ww = math3d.mat4_columns(
        inv_vp, x, y, torch.full((H, W), 0.5, dtype=torch.float32, device=dev))
    iw = 1.0 / torch.where(torch.abs(ww) > 1e-9, ww, 1.0)
    dx = wx * iw - view.cam_pos[0]
    dy = wy * iw - view.cam_pos[1]
    dz = wz * iw - view.cam_pos[2]
    inv_len = 1.0 / torch.clamp(torch.sqrt(dx * dx + dy * dy + dz * dz), min=1e-9)
    dirs = torch.stack([dx * inv_len, dy * inv_len, dz * inv_len], dim=-1)
    t = torch.clamp(dirs[..., 1] * 0.5 + 0.5, 0.0, 1.0)[..., None]
    horizon = torch.tensor([0.45, 0.55, 0.70], dtype=torch.float32, device=dev)
    zenith = torch.tensor([0.10, 0.25, 0.55], dtype=torch.float32, device=dev)
    ground = torch.tensor([0.18, 0.16, 0.14], dtype=torch.float32, device=dev)
    sky = horizon * (1 - t) + zenith * t
    col = torch.where(dirs[..., 1:2] >= 0.0, sky, ground)
    return col * intensity
