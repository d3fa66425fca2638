"""The OpenPBR lobes (coat, fuzz, energy compensation, subsurface,
anisotropy) of the port's ops/shade.py and frame vs the JAX package on the
CPU.

- Lobe functions on random G-buffer planes made from a numpy seed
  (roughness 0.3-1, so no lobe is sharp enough to turn the last ulp of a
  dot product into more than 1e-5): eval_brdf with every extension,
  tangent_frame, apply_coat, openpbr_terms and shade_one_light, rtol 1e-5
  (atol 1e-6 for values near 0).
- tests/test_openpbr_ext.py's behaviour checks on the port: subsurface
  softens the terminator, its white furnace holds, anisotropy elongates
  the highlight and is isotropic at strength 0.
- Frames at 128x128, tile_h 16: vis equal and image RMSE <= 1.0 (0-255)
  against the JAX frame, on tests/test_brdf_energy.py's velvet sphere
  (fuzz + energy compensation, as there; then clear-coated, with every
  lobe and IBL) and tests/test_openpbr_ext.py's glass scene (OIT
  transmission with every lobe).
- tests/test_goldens_512.py's g512_openpbr rendered by the port against
  its golden PNG at RMSE <= 6, the golden limit.
"""

import importlib
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from basicrenderer_tpu.graph.frame import build_frame_fn as j_build_frame_fn
from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
from basicrenderer_tpu.graph.framedata import FrameParams as JParams
from basicrenderer_tpu.graph.framedata import make_view as j_make_view
from basicrenderer_tpu.ops import shade as jshade
from basicrenderer_tpu.utils import math3d as jm3
from basicrenderer_tpu_torch.graph.frame import build_frame_fn
from basicrenderer_tpu_torch.graph.framedata import (FrameConfig, FrameParams,
                                                     make_view)
from basicrenderer_tpu_torch.ops import shade as pshade
from basicrenderer_tpu_torch.utils.png import read_png

JAX_PKG = "basicrenderer_tpu"
PORT_PKG = "basicrenderer_tpu_torch"
LOBES = dict(rtol=1e-5, atol=1e-6)
QX90 = np.asarray(jm3.quat_from_axis_angle((1, 0, 0), np.pi / 2))
ALL_LOBES = dict(enable_coat=True, enable_fuzz=True, enable_energy_comp=True,
                 enable_sss=True, enable_aniso=True)


def _mod(root, name):
    return importlib.import_module(f"{root}.{name}")


# ---------------------------------------------------------------------------
# Lobe functions on random G-buffers
# ---------------------------------------------------------------------------

def _unit(rng, shape):
    v = rng.normal(size=shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def planes():
    """Random (16, 16) G-buffer planes and directions, one seed; v and l
    in the normal's hemisphere, the world position and uv smooth fields so
    the derivative frame is well defined."""
    rng = np.random.default_rng(21)
    h = w = 16
    n = _unit(rng, (h, w, 3))
    v = _unit(rng, (h, w, 3))
    v = np.where(np.sum(n * v, -1, keepdims=True) < 0, -v, v)
    l = _unit(rng, (h, w, 3))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    wp = np.stack([xx * 0.1 + 0.01 * yy * yy, yy * 0.1 + 0.02 * xx,
                   0.05 * np.sin(xx * 0.3)], -1).astype(np.float32)
    uv = np.stack([xx / w + 0.01 * yy, yy / h - 0.02 * xx], -1) \
        .astype(np.float32)
    f = lambda *s: rng.uniform(*s, (h, w)).astype(np.float32)  # noqa: E731
    return dict(
        n=n, v=v, l=l, wp=wp, uv=uv, albedo=rng.uniform(0.05, 1.0, (h, w, 3))
        .astype(np.float32), metallic=f(0, 1), rough=f(0.3, 1.0),
        spec=rng.uniform(1.0, 1.3, (h, w, 3)).astype(np.float32),
        sss_w=f(0, 1), sss_c=rng.uniform(0.2, 1.0, (h, w, 3))
        .astype(np.float32), sss_r=f(0, 1), trans=f(0, 1), aniso_s=f(0, 1),
        aniso_rot=f(-3, 3), coat_w=f(0, 1), coat_r=f(0.3, 1.0),
        fuzz_w=f(0, 1), fuzz_r=f(0.05, 1.0))


def _gbuffers(p):
    """The same G-buffer in both packages from the planes."""
    h, w = p["metallic"].shape
    z = np.zeros((h, w), np.float32)
    ids = np.zeros((h, w), np.int32)
    fields = dict(
        world_pos=p["wp"], normal=p["n"], albedo=p["albedo"],
        metallic=p["metallic"], roughness=p["rough"], emissive=z[..., None]
        .repeat(3, -1), valid=np.ones((h, w), bool), depth=z + 0.5,
        material_id=ids, uv=p["uv"], alpha=z + 1, base_tex=ids - 1,
        normal_tex=ids - 1, mr_tex=ids - 1, emissive_tex=ids - 1,
        coat_weight=p["coat_w"], coat_rough=p["coat_r"], normal_scale=z + 1,
        object_id=ids, fuzz_weight=p["fuzz_w"], fuzz_rough=p["fuzz_r"],
        trans_weight=p["trans"], trans_color=z[..., None].repeat(3, -1) + 1,
        trans_depth=z + 1, sss_weight=p["sss_w"], sss_color=p["sss_c"],
        sss_radius=p["sss_r"], aniso_strength=p["aniso_s"],
        aniso_rotation=p["aniso_rot"], ior=z + 1.5, tangent_theta=z)
    jgb = jshade.GBuffer(**{k: jnp.asarray(v) for k, v in fields.items()})
    pgb = pshade.GBuffer(**{k: torch.as_tensor(v) for k, v in fields.items()})
    return jgb, pgb


def _t(*xs):
    return [torch.as_tensor(np.array(x)) for x in xs]


def test_eval_brdf_extensions_match_jax(planes):
    p = planes
    jT, jB = jax.jit(jshade.tangent_frame)(p["wp"], p["uv"], p["n"],
                                           p["aniso_rot"])
    pT, pB = pshade.tangent_frame(*_t(p["wp"], p["uv"], p["n"],
                                      p["aniso_rot"]))
    np.testing.assert_allclose(pT.numpy(), np.asarray(jT), **LOBES)
    np.testing.assert_allclose(pB.numpy(), np.asarray(jB), **LOBES)
    base = (p["n"], p["v"], p["l"], p["albedo"], p["metallic"], p["rough"])
    for ext in ("sss", "aniso", "all"):
        kw = {}
        if ext in ("sss", "all"):
            kw["sss"] = (p["sss_w"], p["sss_c"], p["sss_r"])
        if ext in ("aniso", "all"):
            kw["aniso"] = (np.asarray(jT), np.asarray(jB), p["aniso_s"])
        if ext == "all":
            kw.update(spec_scale=p["spec"], trans_w=p["trans"])
        j = jax.jit(jshade.eval_brdf)(*base, **kw)
        pk = {k: (tuple(_t(*x)) if isinstance(x, tuple) else _t(x)[0])
              for k, x in kw.items()}
        pr = pshade.eval_brdf(*_t(*base), **pk)
        np.testing.assert_allclose(pr.numpy(), np.asarray(j), err_msg=ext,
                                   **LOBES)


def test_coat_terms_and_one_light_match_jax(planes):
    p = planes
    jgb, pgb = _gbuffers(p)
    rad = np.random.default_rng(22).uniform(0, 3, p["n"].shape) \
        .astype(np.float32)
    spec = np.asarray(jax.jit(jshade.eval_brdf)(
        p["n"], p["v"], p["l"], p["albedo"], p["metallic"], p["rough"]))
    j = jax.jit(jshade.apply_coat)(spec, jgb, p["n"], p["v"], p["l"], rad)
    pr = pshade.apply_coat(*_t(spec), pgb, *_t(p["n"], p["v"], p["l"], rad))
    np.testing.assert_allclose(pr.numpy(), np.asarray(j), **LOBES)
    jc, jf = jax.jit(lambda gb, v, n: jshade.openpbr_terms(
        gb, v, n, True, True))(jgb, p["v"], p["n"])
    pc, pf = pshade.openpbr_terms(pgb, *_t(p["v"], p["n"]), True, True)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), **LOBES)
    np.testing.assert_allclose(pf.numpy(), np.asarray(jf), **LOBES)
    T, B = pshade.tangent_frame(pgb.world_pos, pgb.uv, pgb.normal,
                                pgb.aniso_rotation)
    for ltype, pos in ((0.0, (0, 0, 0)), (1.0, (0.8, 0.9, 1.5)),
                       (2.0, (0.7, 0.6, 2.0))):
        row = np.zeros(16, np.float32)
        row[0:3], row[3] = pos, ltype
        row[4:7] = np.array([0.2, -0.3, -0.9]) / np.linalg.norm(
            [0.2, -0.3, -0.9])
        row[7], row[8:11], row[11] = 4.0, (1.0, 0.9, 0.8), 6.0
        row[12], row[13] = np.cos(0.2), np.cos(0.8)

        def jone(gb, row, v, n, comp, fe, T, B):
            return jshade.shade_one_light(
                gb, row, v, n, coat=True, spec_comp=comp, fuzz_e=fe,
                sss=(gb.sss_weight, gb.sss_color, gb.sss_radius),
                trans_w=gb.trans_weight, aniso=(T, B, gb.aniso_strength))
        j = jax.jit(jone)(jgb, row, p["v"], p["n"], jc, jf, T.numpy(),
                          B.numpy())
        pr = pshade.shade_one_light(
            pgb, torch.as_tensor(row), *_t(p["v"], p["n"]), coat=True,
            spec_comp=pc, fuzz_e=pf,
            sss=(pgb.sss_weight, pgb.sss_color, pgb.sss_radius),
            trans_w=pgb.trans_weight, aniso=(T, B, pgb.aniso_strength))
        np.testing.assert_allclose(pr.numpy(), np.asarray(j),
                                   err_msg=str(ltype), **LOBES)


# ---------------------------------------------------------------------------
# tests/test_openpbr_ext.py's behaviour checks on the port
# ---------------------------------------------------------------------------

def _flat(h=2, w=2):
    n = torch.tensor([0.0, 1.0, 0.0]).expand(h, w, 3)
    return (n, torch.full((h, w, 3), 0.8), torch.zeros((h, w)),
            torch.full((h, w), 0.5))


def _dir(v, h=2, w=2):
    v = torch.tensor(v, dtype=torch.float32)
    return (v / torch.linalg.vector_norm(v)).expand(h, w, 3)


def test_sss_softens_terminator():
    n, albedo, metallic, rough = _flat()
    v = _dir([0.0, 1.0, 0.3])
    l = _dir([1.0, -0.15, 0.0])                         # below the horizon
    base = pshade.eval_brdf(n, v, l, albedo, metallic, rough)
    sss = (torch.ones((2, 2)), torch.tensor([1.0, 0.3, 0.3]).expand(2, 2, 3),
           torch.full((2, 2), 0.6))
    w8 = pshade.eval_brdf(n, v, l, albedo, metallic, rough, sss=sss)
    assert float(base[0, 0].max()) < 1e-5
    assert float(w8[0, 0, 0]) > 1e-3
    assert float(w8[0, 0, 0]) > float(w8[0, 0, 1]) * 2


def test_sss_white_furnace_conserves():
    n, albedo, metallic, rough = _flat(1, 1)
    v = _dir([0.0, 1.0, 0.0], 1, 1)
    dirs = np.random.default_rng(0).normal(size=(4096, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    l = torch.as_tensor(dirs)[:, None, :]               # (4096, 1, 3)
    sss = (torch.ones((1, 1)), torch.ones((1, 1, 3)), torch.full((1, 1), 0.7))
    a = pshade.eval_brdf(n, v, l, albedo, metallic, rough)
    b = pshade.eval_brdf(n, v, l, albedo, metallic, rough, sss=sss)
    spec = pshade.eval_brdf(n, v, l, torch.zeros_like(albedo), metallic,
                            rough)
    tot_l = float((a - spec)[..., 0].sum())
    tot_s = float((b - spec)[..., 0].sum())
    assert abs(tot_s - tot_l) / max(tot_l, 1e-9) < 0.03


def test_aniso_elongates_highlight():
    n, albedo, _, _ = _flat()
    rough = torch.full((2, 2), 0.4)
    metallic = torch.ones((2, 2))
    v = _dir([0.0, 1.0, 0.0])
    l_t, l_b = _dir([0.5, 1.0, 0.0]), _dir([0.0, 1.0, 0.5])
    T = torch.tensor([1.0, 0.0, 0.0]).expand(2, 2, 3)
    B = torch.tensor([0.0, 0.0, 1.0]).expand(2, 2, 3)
    iso_t = pshade.eval_brdf(n, v, l_t, albedo, metallic, rough)
    iso_b = pshade.eval_brdf(n, v, l_b, albedo, metallic, rough)
    np.testing.assert_allclose(iso_t.numpy(), iso_b.numpy(), rtol=1e-5)
    s = torch.full((2, 2), 0.8)
    a_t = pshade.eval_brdf(n, v, l_t, albedo, metallic, rough, aniso=(T, B, s))
    a_b = pshade.eval_brdf(n, v, l_b, albedo, metallic, rough, aniso=(T, B, s))
    assert float(a_t.mean()) > float(a_b.mean()) * 1.5
    s_t = pshade.eval_brdf(n, v, l_t, albedo, metallic, rough,
                           aniso=(B, -T, s))
    s_b = pshade.eval_brdf(n, v, l_b, albedo, metallic, rough,
                           aniso=(B, -T, s))
    assert float(s_b.mean()) > float(s_t.mean()) * 1.5


def test_aniso_zero_strength_matches_iso():
    n, albedo, metallic, rough = _flat()
    v, l = _dir([0.3, 1.0, 0.1]), _dir([0.4, 1.0, -0.2])
    T = torch.tensor([1.0, 0.0, 0.0]).expand(2, 2, 3)
    B = torch.tensor([0.0, 0.0, 1.0]).expand(2, 2, 3)
    iso = pshade.eval_brdf(n, v, l, albedo, metallic, rough)
    an = pshade.eval_brdf(n, v, l, albedo, metallic, rough,
                          aniso=(T, B, torch.zeros((2, 2))))
    np.testing.assert_allclose(an.numpy(), iso.numpy(), rtol=1e-3, atol=1e-5)


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

def velvet_scene(root, coat=False):
    """tests/test_brdf_energy.py's velvet sphere (fuzz over a rough red
    metal); `coat` clear-coats it too."""
    Material = _mod(root, "models.materials").Material
    meshes = _mod(root, "models.mesh").MeshRegistry()
    mats = _mod(root, "models.materials").MaterialRegistry()
    br = _mod(root, "scene.bridge")
    sphere = meshes.add(_mod(root, "models.procedural").make_uv_sphere(
        1.0, 12, 18))
    velvet = mats.add(Material(
        base_color=np.asarray([0.6, 0.1, 0.1, 1], np.float32), metallic=1.0,
        roughness=0.8, fuzz_weight=0.8, fuzz_roughness=0.4,
        **(dict(coat_weight=0.6, coat_roughness=0.15) if coat else {})))
    sc = _mod(root, "scene.scene").Scene()
    sc.create_renderable(sphere, velvet)
    sc.create_directional_light(direction=(-0.5, -1, -0.2), intensity=3.0)
    sc.set_camera(position=(0, 0.5, 3.2), target=(0, 0, 0), aspect=1.0)
    sc.propagate_transforms()
    caps = br.BridgeCapacities(max_vertices=1 << 10, max_triangles=1 << 10,
                               max_objects=4, max_materials=4, max_lights=2)
    return sc, br.SceneRenderBridge(sc, meshes, mats, caps)


def glass_scene(root):
    """tests/test_openpbr_ext.py's green glass quad before a white floor."""
    Material = _mod(root, "models.materials").Material
    meshes = _mod(root, "models.mesh").MeshRegistry()
    mats = _mod(root, "models.materials").MaterialRegistry()
    br = _mod(root, "scene.bridge")
    plane = meshes.add(_mod(root, "models.procedural").make_plane(8.0, 1))
    white = mats.add(Material(base_color=np.array([1, 1, 1, 1], np.float32),
                              roughness=1.0))
    glass = mats.add(Material(
        base_color=np.array([1, 1, 1, 1], np.float32), roughness=0.05,
        transmission_weight=1.0,
        transmission_color=np.asarray([0.15, 1.0, 0.15], np.float32)))
    sc = _mod(root, "scene.scene").Scene()
    sc.create_renderable(plane, white, position=(0, 0, -2), rotation=QX90)
    sc.create_renderable(plane, glass, position=(0, 0, 0), rotation=QX90,
                         scale=(0.4, 1, 0.4))
    sc.create_directional_light(direction=(0, -0.3, -1), intensity=3.0)
    sc.set_camera(position=(0, 0, 5), target=(0, 0, 0), aspect=1.0)
    sc.propagate_transforms()
    caps = br.BridgeCapacities(max_vertices=1 << 8, max_triangles=1 << 8,
                               max_objects=8, max_materials=8, max_lights=4,
                               max_clusters=64)
    return sc, br.SceneRenderBridge(sc, meshes, mats, caps)


def openpbr_rig(root):
    """tests/test_goldens_512.py's OpenPBR rig: glass (transmission), skin
    (subsurface) and brushed-metal (anisotropy) spheres over a checkered
    floor."""
    Material = _mod(root, "models.materials").Material
    meshes = _mod(root, "models.mesh").MeshRegistry()
    mats = _mod(root, "models.materials").MaterialRegistry()
    tex = _mod(root, "models.textures").TextureRegistry(resolution=64)
    clusters = _mod(root, "models.clusters")
    proc = _mod(root, "models.procedural")
    br = _mod(root, "scene.bridge")
    checker = tex.checkerboard(a=(1, 1, 1), b=(0.15, 0.15, 0.15), squares=8)
    sphere = meshes.add(clusters.to_mesh_data(clusters.build_cluster_lod(
        proc.make_uv_sphere(0.8, rings=24, sectors=48))))
    plane = meshes.add(proc.make_plane(8.0, 2))
    floor_m = mats.add(Material(
        base_color=np.array([0.7, 0.7, 0.72, 1], np.float32),
        roughness=0.3, base_color_texture=checker))
    glass_m = mats.add(Material(
        base_color=np.array([1, 1, 1, 1], np.float32), roughness=0.05,
        transmission_weight=1.0,
        transmission_color=np.array([0.4, 0.9, 0.5], np.float32), ior=1.5))
    skin_m = mats.add(Material(
        base_color=np.array([0.85, 0.62, 0.52, 1], np.float32),
        roughness=0.55, subsurface_weight=0.8,
        subsurface_color=np.array([1.0, 0.35, 0.25], np.float32),
        subsurface_radius=0.6))
    brushed_m = mats.add(Material(
        base_color=np.array([0.9, 0.9, 0.92, 1], np.float32),
        roughness=0.35, metallic=1.0, anisotropy_strength=0.85,
        anisotropy_rotation=0.6))
    sc = _mod(root, "scene.scene").Scene()
    sc.create_renderable(plane, floor_m)
    sc.create_renderable(sphere, glass_m, position=(-1.6, 0.8, 0))
    sc.create_renderable(sphere, skin_m, position=(0, 0.8, -0.4))
    sc.create_renderable(sphere, brushed_m, position=(1.6, 0.8, 0))
    sc.create_directional_light(direction=(-0.5, -1, -0.35), intensity=2.5)
    sc.create_point_light(position=(0.0, 2.2, 2.0), color=(1.0, 0.9, 0.8),
                          intensity=5.0)
    sc.set_camera(position=(0.4, 2.0, 4.2), target=(0, 0.7, 0), aspect=1.0)
    sc.propagate_transforms()
    caps = br.BridgeCapacities(max_vertices=1 << 15, max_triangles=1 << 15,
                               max_objects=16, max_materials=8, max_lights=8,
                               max_clusters=1 << 10, max_geom_clusters=1 << 10)
    return sc, br.SceneRenderBridge(sc, meshes, mats, caps, textures=tex)


SMALL = dict(width=128, height=128, tile_h=16, tile_w=128)
FRAMES = {
    "velvet": (velvet_scene, dict(SMALL, max_pairs=1024, enable_fuzz=True,
                                  enable_energy_comp=True)),
    "glass": (glass_scene, dict(SMALL, max_pairs=1 << 11, enable_clod=True,
                                max_visible_clusters=64, enable_oit=True,
                                oit_layers=2, enable_transmission=True,
                                **ALL_LOBES)),
    # The coated velvet under every lobe and IBL: the composite's energy,
    # fuzz and coat branches with nonzero weights.
    "velvet_coat_ibl": (lambda root: velvet_scene(root, coat=True), dict(
        SMALL, max_pairs=1024, enable_ibl=True, **ALL_LOBES)),
}


def _rmse(a, b):
    return float(np.sqrt(np.mean((a.astype(np.float32)
                                  - b.astype(np.float32)) ** 2)))


@pytest.fixture(scope="module")
def frames():
    """{name: (JAX image, JAX vis, port image, port vis)}."""
    def run(name):
        build, flags = FRAMES[name]
        (jsc, jb), (psc, pb) = build(JAX_PKG), build(PORT_PKG)
        jo = jax.jit(j_build_frame_fn(JConfig(**flags,
                                              use_pallas_raster=False)))(
            jb.build_scene_buffers(), j_make_view(*jsc.camera_matrices(
                aspect=1.0)), JParams.default())
        po = build_frame_fn(FrameConfig(**flags))(
            pb.build_scene_buffers(device="cpu"),
            make_view(*psc.camera_matrices(aspect=1.0), device="cpu"),
            FrameParams.default("cpu"))
        return name, (np.asarray(jo["image"]), np.asarray(jo["vis"]),
                      po["image"].numpy(), po["vis"].numpy())

    return dict(map(run, FRAMES))


@pytest.mark.parametrize("name", list(FRAMES))
def test_frame_matches_jax(frames, name):
    jimg, jvis, pimg, pvis = frames[name]
    np.testing.assert_array_equal(pvis, jvis)
    assert _rmse(pimg, jimg) <= 1.0


def test_lobes_change_the_velvet_frame(frames):
    """tests/test_brdf_energy.py's frame check on the port: fuzz + energy
    compensation shade visibly apart from the plain frame."""
    build, flags = FRAMES["velvet"]
    sc, bridge = build(PORT_PKG)
    plain = {k: v for k, v in flags.items()
             if k not in ("enable_fuzz", "enable_energy_comp")}
    out = build_frame_fn(FrameConfig(**plain))(
        bridge.build_scene_buffers(device="cpu"),
        make_view(*sc.camera_matrices(aspect=1.0), device="cpu"),
        FrameParams.default("cpu"))
    pbr = frames["velvet"][2]
    assert np.abs(out["image"].numpy().astype(np.float32)
                  - pbr.astype(np.float32)).max() > 2.0


def test_g512_openpbr_golden():
    """tests/test_goldens_512.py's g512_openpbr frame rendered by the port
    on the CPU, against the golden PNG at the golden limit."""
    sc, bridge = openpbr_rig(PORT_PKG)
    cfg = FrameConfig(width=512, height=512, tile_h=16, tile_w=128,
                      max_pairs=1 << 15, enable_clod=True,
                      max_visible_clusters=1024, enable_textures=True,
                      texture_downscale=1, enable_oit=True, oit_layers=2,
                      enable_transmission=True, enable_sss=True,
                      enable_aniso=True, enable_ibl=True)
    out = build_frame_fn(cfg)(bridge.build_scene_buffers(device="cpu"),
                              make_view(*sc.camera_matrices(aspect=1.0),
                                        device="cpu"),
                              FrameParams.default("cpu"))
    golden = read_png(os.path.join(os.path.dirname(__file__), "goldens",
                                   "g512_openpbr.png"))
    err = _rmse(out["image"].numpy(), golden)
    assert err <= 6.0, f"g512_openpbr RMSE {err:.4f}"
