"""The post stack frame: port vs the JAX frame program on the CPU.

Scene: the cluster rig of tests/test_torch_cluster_frame.py at 128x128,
over 3 frames in which the camera orbits and the cube slides. The port's
graph/temporal.py makes each frame's inputs (jittered view, frame_index,
prev_viewproj, the moved cube's relative matrix); the JAX frame gets the
same matrices and its own previous outputs (prev_depth, taa_history), as
Renderer.render would give it. From the second frame on, TAA resolves with
motion vectors (the history warp). Two toggle sets: GTAO + bloom + TAA +
auto-exposure + SSR (bench.py's config4_post over the cluster base), and
the same with IBL over a procedural environment (the same precomputed
arrays in both packages).

Parity: vis equal on every frame; image RMSE vs the JAX frame <= 1.0
(0-255) on every frame; the same output keys.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from basicrenderer_tpu.graph.frame import build_frame_fn as j_build_frame_fn
from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
from basicrenderer_tpu.graph.framedata import FrameParams as JParams
from basicrenderer_tpu.graph.framedata import make_view as j_make_view
from basicrenderer_tpu_torch.graph.frame import build_frame_fn
from basicrenderer_tpu_torch.graph.framedata import FrameConfig
from basicrenderer_tpu_torch.graph.temporal import TemporalState
from basicrenderer_tpu_torch.models.environment import Environment
from basicrenderer_tpu_torch.ops.ibl import make_procedural_environment

from tests.test_torch_cluster_frame import JAX_PKG, PORT_PKG, build_rig

BASE = dict(width=128, height=128, tile_h=16, tile_w=128, max_pairs=1 << 15,
            enable_clod=True, max_visible_clusters=64)
POST = dict(enable_gtao=True, enable_bloom=True, enable_taa=True,
            enable_auto_exposure=True, enable_ssr=True, ssr_downscale=2)
TOGGLES = {"post": POST, "post_ibl": dict(POST, enable_ibl=True,
                                          ibl_specular_downscale=2)}
FRAMES = 3
CUBE_AT = (-1.4, 0.35, 0.6)


def _move(sc, root, i):
    """Frame i's camera (a small orbit) and cube position (+0.08 x)."""
    import importlib
    Position = importlib.import_module(f"{root}.scene.components").Position
    ang = 0.04 * i
    c, s = np.cos(ang), np.sin(ang)
    sc.set_camera(position=(2.6 * c - 3.2 * s, 2.0, 2.6 * s + 3.2 * c),
                  target=(0, 0.6, 0), aspect=1.0)
    for eid, (pos,) in list(sc.world.query(Position)):
        if np.allclose(pos.value, CUBE_AT) or getattr(sc, "_cube", None) == eid:
            sc._cube = eid
            sc.world.set(eid, Position(np.array(CUBE_AT, np.float32)
                                       + np.array([0.08 * i, 0, 0], np.float32)))
    sc.propagate_transforms()


@pytest.fixture(scope="module")
def environment():
    """One precomputed procedural environment (16^2 cubemap) for both:
    the port's precompute, which tests/test_torch_ibl.py holds to the JAX
    package's."""
    env = Environment.precompute(
        make_procedural_environment(16, device="cpu").numpy(),
        use_cache=False, device="cpu")
    return dict(env_sh=env.sh, env_specular=env.spec_mips)


@pytest.fixture(scope="module")
def sequences(environment):
    """Per toggle set: the 3 frames' (port kwargs, moved ids, JAX outputs,
    port outputs). Each package's rig is built once; frame 0 puts the
    camera and the cube back where every sequence starts."""
    (jsc, jb), (psc, pb) = build_rig(JAX_PKG), build_rig(PORT_PKG)
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        flags = TOGGLES[name]
        env = environment if flags.get("enable_ibl") else {}
        jcfg = JConfig(**BASE, **flags, use_pallas_raster=False)
        pcfg = FrameConfig(**BASE, **flags)
        jf = jax.jit(j_build_frame_fn(jcfg))
        pf = build_frame_fn(pcfg)
        temporal = TemporalState(pcfg, device="cpu")
        jbuf = jb.build_scene_buffers(**env)
        pbuf = pb.build_scene_buffers(**env, device="cpu")
        jprev = jnp.zeros((jcfg.padded_height, jcfg.padded_width), jnp.float32)
        jhist = None
        outs = []
        for i in range(FRAMES):
            _move(jsc, JAX_PKG, i)
            _move(psc, PORT_PKG, i)
            jbuf, pbuf = jb.update_dynamic(jbuf), pb.update_dynamic(pbuf)
            view, params, kw = temporal.inputs(psc, pb)
            jkw = {k: jnp.asarray(kw[k].numpy()) for k in
                   ("prev_viewproj", "moving_rel", "moving_ids") if k in kw}
            jout = jf(jbuf, j_make_view(view.view.numpy(), view.proj.numpy(),
                                        view.cam_pos.numpy()),
                      dataclasses.replace(JParams.default(),
                                          frame_index=jnp.int32(i)),
                      prev_depth=jprev, taa_history=jhist, **jkw)
            pout = pf(pbuf, view, params, **kw)
            temporal.carry(pout)
            jprev, jhist = jout["depth_padded"], jout["taa_out"]
            ids = kw["moving_ids"].numpy() if "moving_ids" in kw else None
            outs.append((sorted(kw), ids,
                         {k: np.asarray(v) for k, v in jout.items()},
                         {k: v.numpy() for k, v in pout.items()}))
        cache[name] = outs
        return outs
    return get


@pytest.mark.parametrize("toggles", list(TOGGLES))
def test_post_frames_match_jax(sequences, toggles):
    outs = sequences(toggles)
    assert outs[0][0] == ["prev_depth", "taa_history"]
    assert outs[1][0] == ["moving_ids", "moving_rel", "prev_depth",
                          "prev_viewproj", "taa_history"]
    for i, (_kw, _ids, jout, pout) in enumerate(outs):
        assert set(pout) == set(jout)
        np.testing.assert_array_equal(pout["vis"], jout["vis"], err_msg=f"frame {i}")
        err = np.sqrt(np.mean((pout["image"].astype(np.float32)
                               - jout["image"].astype(np.float32)) ** 2))
        assert err <= 1.0, f"frame {i}: image RMSE {err:.4f}"
        assert 0.3 < (pout["vis"] > 0).mean() < 0.95


def test_moved_cube_reaches_the_frame(sequences):
    """The temporal state names the cube, and only the cube, as moved; the last
    frame's outputs are finite, and taa_out is the resolved HDR before
    bloom (bloom only adds light)."""
    outs = sequences("post")
    for _kw, ids, _j, _p in outs[1:]:
        assert (ids >= 0).sum() == 1 and ids[0] == 2, ids
    last = outs[-1][3]
    assert last["taa_out"].shape == (128, 128, 3)
    assert np.isfinite(last["hdr"]).all()
    assert (last["hdr"] >= last["taa_out"] - 1e-6).all()


def test_ibl_lights_the_frame(sequences):
    plain, ibl = sequences("post")[-1][3], sequences("post_ibl")[-1][3]
    lit = plain["vis"] > 0
    assert (ibl["taa_out"][lit].mean() > plain["taa_out"][lit].mean() + 1e-3)


def test_post_toggles_build():
    for flags in TOGGLES.values():
        build_frame_fn(FrameConfig(**BASE, **flags))
