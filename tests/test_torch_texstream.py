"""Texture streaming and the flagship frame: the port against the JAX
package on the CPU.

Mirrors tests/test_texstream.py. Tolerances:
- strip containers: byte-equal files, and each package opens the other's;
- TextureStreamer over 8 synchronous ticks fed the same wanted mips (each
  IO worker drained between ticks): resident mips, loads, demotions, the
  atlas and the flag words bit-equal;
- ops/textures.wanted_mips: equal;
- the flagship frame, __graft_entry__._build_small_inputs(full=True,
  pallas=False) (cluster LOD, CSM, clustered lights, IBL, textures with
  sampler feedback, SSR, OIT, geometry-streaming feedback, VSM, Reyes,
  GTAO, bloom, TAA, exposure) at 256x128: vis equal, image RMSE <= 1.0 on
  the 0-255 scale, "touched_groups" and "tex_wanted" equal.
"""

import dataclasses
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from basicrenderer_tpu.models import texstream as jts
from basicrenderer_tpu.models.textures import TextureRegistry as JTextures
from basicrenderer_tpu.ops import textures as jtex
from basicrenderer_tpu_torch.models import texstream as pts
from basicrenderer_tpu_torch.models.textures import TextureRegistry
from basicrenderer_tpu_torch.ops import textures as ptex

TICKS = 8


def _flagship_jax():
    from __graft_entry__ import _build_small_inputs
    from basicrenderer_tpu.graph.frame import build_frame_fn
    cfg, buf, vd, params = _build_small_inputs(pallas=False, full=True)
    out = jax.jit(build_frame_fn(cfg))(buf, vd, params)
    return cfg, {k: np.asarray(out[k]) for k in
                 ("vis", "image", "touched_groups", "tex_wanted")}


def _atlas(registry_cls, res=128):
    tex = registry_cls(resolution=res)
    tex.checkerboard(a=(1, 0, 0), b=(0, 0, 1), squares=16)
    tex.checkerboard(a=(0, 1, 0), b=(1, 1, 0), squares=4)
    rng = np.random.default_rng(7)
    tex.add(rng.random((res, res, 3)).astype(np.float32), srgb=False)
    strips, flags = tex.strip_pyramid()
    return tex, np.asarray(strips), np.asarray(flags)


def test_strip_containers_cross_open(tmp_path):
    _, jstrips, jflags = _atlas(JTextures)
    _, pstrips, pflags = _atlas(TextureRegistry)
    np.testing.assert_array_equal(pstrips, jstrips)
    jpath, ppath = str(tmp_path / "j.brts"), str(tmp_path / "p.brts")
    jts.save_strip_container(jpath, jstrips, jflags, 128)
    pts.save_strip_container(ppath, pstrips, pflags, 128)
    with open(jpath, "rb") as fj, open(ppath, "rb") as fp:
        assert fj.read() == fp.read()
    pc, jc = pts.TextureStreamContainer(jpath), jts.TextureStreamContainer(ppath)
    assert (pc.num_layers, pc.resolution, pc.rows_per_layer) == \
        (jc.num_layers, jc.resolution, jc.rows_per_layer)
    np.testing.assert_array_equal(pc.flags, jc.flags)
    np.testing.assert_array_equal(np.asarray(pc.strips), np.asarray(jc.strips))
    for layer, mip in ((0, 0), (1, 2), (2, 4)):
        pb, prow = pc.read_mip_rows(layer, mip)
        jb, jrow = jc.read_mip_rows(layer, mip)
        assert pb == jb
        np.testing.assert_array_equal(prow, jrow)


def _record_requests(st):
    asked = []
    request = st._io.request

    def recording(key, priority=0.0):
        asked.append(key)
        request(key, priority)
    st._io.request = recording
    return asked


def _drain(st, asked):
    """Wait until every (layer, mip) the streamer asked for this tick is
    staged, so both packages' next ticks see the same staged set."""
    for _ in range(1000):
        if all(k in st._staged for k in asked):
            asked.clear()
            return
        time.sleep(0.005)
    raise TimeoutError("IO worker did not stage its requests")


def test_streamer_ticks_match_jax(tmp_path):
    """8 synchronous ticks of seeded wanted mips under a fine-row budget
    small enough to demote."""
    _, strips, flags = _atlas(JTextures)
    path = str(tmp_path / "atlas.brts")
    jts.save_strip_container(path, strips, flags, 128)
    jst = jts.TextureStreamer(jts.TextureStreamContainer(path),
                              fine_row_budget=200, loads_per_update=2)
    pst = pts.TextureStreamer(pts.TextureStreamContainer(path),
                              fine_row_budget=200, loads_per_update=2,
                              device="cpu")
    asked = [_record_requests(st) for st in (jst, pst)]
    rng = np.random.default_rng(5)
    try:
        for tick in range(TICKS):
            wanted = rng.integers(0, 3, 3).astype(np.int32)
            wanted[rng.random(3) < 0.2] = jst.M       # not sampled
            jstrips, jfl = jst.update(wanted)
            pstrips, pfl = pst.update(wanted)
            np.testing.assert_array_equal(pstrips.numpy(),
                                          np.asarray(jstrips).view(np.int32))
            np.testing.assert_array_equal(pfl.numpy(), np.asarray(jfl))
            np.testing.assert_array_equal(pst.resident_mip, jst.resident_mip)
            assert (pst.loads, pst.demotions, pst.fine_rows) == \
                (jst.loads, jst.demotions, jst.fine_rows), tick
            _drain(jst, asked[0])
            _drain(pst, asked[1])
        assert pst.loads > 0 and pst.demotions > 0
    finally:
        jst.stop()
        pst.stop()


@pytest.mark.parametrize("seed", [0, 1])
def test_wanted_mips_match_jax(seed):
    """Texture ids (-1 = uncovered) over bands of uv planes whose texel
    rates span mips 0-4; one texture is not sampled."""
    rng = np.random.default_rng(seed)
    N, h, w = 6, 25, 40
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    band = (yy // 5).astype(np.int32)          # one texel rate a band
    tids = ((band + seed) % N)[None].astype(np.int32)
    tids[rng.random(tids.shape) < 0.2] = -1
    scale = (2.0 ** band / 256.0).astype(np.float32)
    u = (xx * scale).astype(np.float32)
    v = (yy * scale * 0.7).astype(np.float32)
    flags = np.zeros(N, np.int32)
    j = np.asarray(jax.jit(jtex.wanted_mips, static_argnums=4)(
        jnp.asarray(flags), jnp.asarray(tids), jnp.asarray(u),
        jnp.asarray(v), 256))
    p = ptex.wanted_mips(torch.as_tensor(flags), torch.as_tensor(tids),
                         torch.as_tensor(u), torch.as_tensor(v), 256).numpy()
    np.testing.assert_array_equal(p, j)
    assert len(set(p.tolist())) > 1


def _renderer(streaming, fmt="rgba8"):
    from basicrenderer_tpu_torch.models import procedural
    from basicrenderer_tpu_torch.models.materials import Material
    from basicrenderer_tpu_torch.renderer import Renderer
    from basicrenderer_tpu_torch.scene.bridge import BridgeCapacities
    from basicrenderer_tpu_torch.scene.scene import Scene
    r = Renderer(caps=BridgeCapacities(
        max_vertices=1 << 12, max_triangles=1 << 12, max_objects=4,
        max_materials=4, max_lights=4, max_clusters=1 << 8,
        max_geom_clusters=1 << 8), device="cpu")
    checker = r.textures.checkerboard(a=(1, 1, 1), b=(0, 0, 0), squares=32)
    plane = r.meshes.add(procedural.make_plane(6.0, 2))
    m = r.materials.add(Material(base_color=np.array([1, 1, 1, 1],
                                                     np.float32),
                                 base_color_texture=checker))
    sc = Scene()
    sc.create_renderable(plane, m)
    sc.create_directional_light(direction=(-0.3, -1, -0.2), intensity=3)
    sc.set_camera(position=(0, 2.5, 2.5), target=(0, 0, 0), aspect=1.0)
    sc.propagate_transforms()
    for k, v in (("renderResolution", (128, 128)), ("tileSize", (16, 128)),
                 ("maxTrianglePairs", 1 << 13), ("enableShadows", False),
                 ("enableClusteredLighting", False), ("enableBloom", False),
                 ("textureFormat", fmt)):
        r.settings.set(k, v)
    r.settings.set("enableTextureStreaming", streaming)
    r.set_current_scene(sc)
    return r


def test_renderer_texture_stream_feedback_loop():
    """The Renderer's pipelined texture feedback converges to the fully
    resident image exactly; the first frame renders from the coarse mips
    (its default container lands under the port's build directory)."""
    from basicrenderer_tpu_torch.utils.cuda_build import BUILD_DIR
    ref = _renderer(False)
    ref.update()
    full = ref.render_to_numpy()
    r = _renderer(True)
    imgs = []
    for _ in range(60):
        r.update()
        imgs.append(r.render_to_numpy())
        if np.array_equal(imgs[-1], full):
            break
        time.sleep(0.02)
    st = r._tex_streamer
    assert st.loads > 0
    assert not np.array_equal(imgs[0], full)
    np.testing.assert_array_equal(imgs[-1], full)
    assert str(st.c.strips.filename).startswith(str(BUILD_DIR / "texstream"))
    st.stop()


def test_bc3_texture_streaming_refused():
    """The JAX package streams RGBA8 strip rows only; so does the port."""
    with pytest.raises(ValueError, match="bc3"):
        _renderer(True, fmt="bc3")


def test_flagship_frame_matches_jax():
    from tests.test_torch_frame import flagship_scene
    from basicrenderer_tpu_torch.graph.frame import build_frame_fn
    from basicrenderer_tpu_torch.graph.framedata import (FrameConfig,
                                                         FrameParams,
                                                         make_view)
    jcfg, jout = _flagship_jax()
    cfg = FrameConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(jcfg)})
    sc, bridge = flagship_scene(full=True)
    pout = build_frame_fn(cfg)(
        bridge.build_scene_buffers(device="cpu"),
        make_view(*sc.camera_matrices(aspect=2.0), device="cpu"),
        FrameParams.default("cpu"))
    np.testing.assert_array_equal(pout["vis"].numpy(), jout["vis"])
    img = pout["image"].numpy().astype(np.float32)
    assert float(np.sqrt(np.mean((img - jout["image"]) ** 2))) <= 1.0
    np.testing.assert_array_equal(pout["touched_groups"].numpy(),
                                  jout["touched_groups"])
    np.testing.assert_array_equal(pout["tex_wanted"].numpy(),
                                  jout["tex_wanted"])
