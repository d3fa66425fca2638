"""Port shading vs the JAX package: G-buffer, deferred lighting, sky,
tonemap and sRGB from the same raster channels, depth and vis.

The inputs come from the JAX frame's own raster of a lit scene (two
directional, a point and two spot lights; metals and emissive), carried
across with basicrenderer_tpu_torch.interop.

Tolerances (f32 throughout): material lookups and the validity mask are
exact; everything computed is allclose at rtol 1e-5, atol 1e-5 (matrix
inverse, rsqrt and pow differ by an ulp or two between XLA and PyTorch,
and XLA contracts multiply-adds), except the HDR radiance at rtol 5e-4:
the sharp GGX lobes (roughness 0.1-0.35) amplify those ulps, measured up
to 1.65e-4 relative on 13 of 49152 values.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from basicrenderer_tpu.graph import frame as jframe
from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
from basicrenderer_tpu.graph.framedata import make_view as j_make_view
from basicrenderer_tpu.ops import shade as jshade
from basicrenderer_tpu_torch import interop
from basicrenderer_tpu_torch.ops import shade as pshade

from tests.test_torch_bridge import JAX_PKG, build_scene

RTOL = ATOL = 1e-5
HDR_RTOL = 5e-4
W = H = 128


def _fields(x):
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


@pytest.fixture(scope="module")
def inputs():
    sc, bridge = build_scene(JAX_PKG, "mixed")
    buf = bridge.build_scene_buffers()
    view, proj, pos = sc.camera_matrices(aspect=1.0)
    vd = j_make_view(view, proj, pos)
    cfg = JConfig(width=W, height=H, tile_h=16, tile_w=128, max_pairs=1 << 12,
                  use_pallas_raster=False)

    @jax.jit
    def raster(buf, vd):
        *_, pairs = jframe.geometry_pass(buf, vd, cfg)
        d, v, ch = jframe.visibility_pass(pairs, cfg)
        return d[:H, :W], v[:H, :W], ch[:, :H, :W]

    depth, vis, ch = (np.asarray(x) for x in raster(buf, vd))
    assert (vis > 0).mean() > 0.3
    return dict(jscene=buf, jview=vd, depth=depth, vis=vis, ch=ch,
                pscene=interop.scene_buffers(_fields(buf), device="cpu"),
                pview=interop.view_data(_fields(vd), device="cpu"))


def _gbuffers(inputs):
    i = inputs
    jgb = jax.jit(lambda ch, d, v, vd, mt: jshade.gbuffer_from_channels(
        ch, d, v, vd, mt, W, H))(i["ch"], i["depth"], i["vis"], i["jview"],
                                 i["jscene"].material_table)
    pgb = pshade.gbuffer_from_channels(
        torch.tensor(i["ch"]), torch.tensor(i["depth"]),
        torch.tensor(i["vis"]), i["pview"], i["pscene"].material_table,
        W, H)
    return jgb, pgb


def test_gbuffer_matches_jax(inputs):
    jgb, pgb = _gbuffers(inputs)
    for f in ("valid", "material_id", "object_id", "albedo", "metallic",
              "roughness", "emissive", "alpha"):
        np.testing.assert_array_equal(getattr(pgb, f).numpy(),
                                      np.asarray(getattr(jgb, f)), err_msg=f)
    for f in ("world_pos", "normal", "uv", "depth"):
        np.testing.assert_allclose(getattr(pgb, f).numpy(),
                                   np.asarray(getattr(jgb, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)


def test_deferred_hdr_matches_jax(inputs):
    jgb, pgb = _gbuffers(inputs)
    i = inputs
    jhdr = jax.jit(lambda gb, s, v: jshade.shade_deferred(gb, s, v))(
        jgb, i["jscene"], i["jview"])
    n_lights = int(i["pscene"].num_lights)
    assert n_lights == 5
    phdr = pshade.shade_deferred(pgb, i["pscene"], i["pview"], n_lights)
    np.testing.assert_allclose(phdr.numpy(), np.asarray(jhdr),
                               rtol=HDR_RTOL, atol=ATOL)
    assert np.asarray(jhdr).max() > 0.1


def test_transmission_lobe_matches_jax(inputs):
    """The OpenPBR transmission lobe (the OIT layers' shading): the
    G-buffer's transmission fields and, with the light loop bounded as
    ops/oit.py bounds it (4 of the 5 live lights), the HDR radiance."""
    i = inputs
    mt = np.array(i["jscene"].material_table)
    M = mt.shape[0]
    mt[:, 30] = np.linspace(0.0, 1.0, M)              # weight
    mt[:, 31] = np.linspace(0.0, 2.0, M)              # depth
    mt[:, 32:35] = np.linspace(0.2, 0.9, 3 * M).reshape(M, 3)
    mt[:, 12] = np.linspace(1.1, 1.8, M)              # ior
    jscene = dataclasses.replace(i["jscene"], material_table=mt)
    pscene = dataclasses.replace(i["pscene"],
                                 material_table=torch.as_tensor(mt))
    jgb = jax.jit(lambda ch, d, v, vd, m: jshade.gbuffer_from_channels(
        ch, d, v, vd, m, W, H))(i["ch"], i["depth"], i["vis"], i["jview"], mt)
    pgb = pshade.gbuffer_from_channels(
        torch.tensor(i["ch"]), torch.tensor(i["depth"]),
        torch.tensor(i["vis"]), i["pview"], pscene.material_table, W, H)
    for f in ("trans_weight", "trans_color", "trans_depth", "ior"):
        np.testing.assert_array_equal(getattr(pgb, f).numpy(),
                                      np.asarray(getattr(jgb, f)), err_msg=f)
    jhdr = jax.jit(lambda gb, s, v: jshade.shade_deferred(
        gb, s, v, transmission=True, max_lights=4))(jgb, jscene, i["jview"])
    phdr = pshade.shade_deferred(pgb, pscene, i["pview"], 4,
                                 transmission=True)
    np.testing.assert_allclose(phdr.numpy(), np.asarray(jhdr),
                               rtol=HDR_RTOL, atol=ATOL)
    plain = pshade.shade_deferred(pgb, pscene, i["pview"], 4)
    assert (phdr < plain - 1e-3).any()      # the diffuse share passes


def test_sky_tonemap_srgb_match_jax(inputs):
    i = inputs
    jsky = jshade.procedural_sky(i["jview"], H, W, 1.0)
    psky = pshade.procedural_sky(i["pview"], H, W, 1.0)
    np.testing.assert_allclose(psky.numpy(), np.asarray(jsky), rtol=RTOL,
                               atol=ATOL)
    x = np.random.default_rng(0).uniform(0, 8, size=(64, 64, 3)).astype(np.float32)
    jt = jshade.aces_tonemap(x)
    pt = pshade.aces_tonemap(torch.as_tensor(x))
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pshade.linear_to_srgb(pt).numpy(),
                               np.asarray(jshade.linear_to_srgb(jt)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("lobes", [
    dict(coat=True, energy=True, fuzz=True),
    dict(coat=True, energy=True, fuzz=True, sss=True, aniso=True,
         transmission=True)])
def test_openpbr_lobes_match_jax(inputs, lobes):
    """The layered lobes, then every lobe, on the scene's G-buffer with
    the extension lanes of the material table filled from a seed (coat
    18-19, fuzz 22-23, subsurface 36-40, anisotropy 41-42, transmission
    30-34): the G-buffer's extension fields equal the JAX package's and
    the HDR radiance agrees at the deferred test's tolerance."""
    i = inputs
    mt = np.array(i["jscene"].material_table)
    M = mt.shape[0]
    rng = np.random.default_rng(11)
    for lane, lo, hi in ((18, 0.2, 1.0), (19, 0.02, 0.8), (22, 0.2, 1.0),
                         (23, 0.02, 1.0), (30, 0.0, 0.5), (36, 0.2, 1.0),
                         (40, 0.0, 1.2), (41, 0.0, 1.0), (42, -3.0, 3.0)):
        mt[:, lane] = rng.uniform(lo, hi, M)
    mt[:, 37:40] = rng.uniform(0.2, 1.0, (M, 3))
    jscene = dataclasses.replace(i["jscene"], material_table=mt)
    pscene = dataclasses.replace(i["pscene"],
                                 material_table=torch.as_tensor(mt))
    jgb = jax.jit(lambda ch, d, v, vd, m: jshade.gbuffer_from_channels(
        ch, d, v, vd, m, W, H))(i["ch"], i["depth"], i["vis"], i["jview"], mt)
    pgb = pshade.gbuffer_from_channels(
        torch.tensor(i["ch"]), torch.tensor(i["depth"]),
        torch.tensor(i["vis"]), i["pview"], pscene.material_table, W, H)
    for f in ("coat_weight", "coat_rough", "fuzz_weight", "fuzz_rough",
              "sss_weight", "sss_color", "sss_radius", "aniso_strength",
              "aniso_rotation"):
        np.testing.assert_array_equal(getattr(pgb, f).numpy(),
                                      np.asarray(getattr(jgb, f)), err_msg=f)
    n_lights = int(i["pscene"].num_lights)
    jhdr = jax.jit(lambda gb, s, v: jshade.shade_deferred(
        gb, s, v, **lobes))(jgb, jscene, i["jview"])
    phdr = pshade.shade_deferred(pgb, pscene, i["pview"], n_lights, **lobes)
    np.testing.assert_allclose(phdr.numpy(), np.asarray(jhdr),
                               rtol=HDR_RTOL, atol=ATOL)
    plain = pshade.shade_deferred(pgb, pscene, i["pview"], n_lights)
    assert np.abs(phdr.numpy() - plain.numpy()).max() > 1e-3
