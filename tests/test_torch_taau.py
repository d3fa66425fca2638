"""TAAU (render low, present high): port vs the JAX frame program on the CPU.

Scene: the golden scene (tests/test_torch_bridge.build_scene "basic"),
built by each package from its own host modules; the soup frame with
enable_taa and FrameConfig.output_width / output_height.

- The mirror of tests/test_post.py::test_taau_upscaling_renders_and_converges:
  a 128x64 render presented at 256x128 over six jittered frames with a
  static camera (the static resolve), every frame's image against the JAX
  frame's.
- A motion-vector sequence through graph/temporal.TemporalState with an
  orbiting camera: a 128x72 render presented at 192x108 (1.5x, neither
  size a whole number of 16x128 tiles, as bench.py's 1280x720 ->
  1920x1080 on 32x128 tiles), so that from the second frame on the
  history warp (K5's plain version on the CPU) runs at the padded output
  size. The JAX frame is fed the same jittered views and previous
  view-projections.
- The history survives TemporalState.inputs at the output shape.

Parity: image RMSE vs the JAX frame <= 1.0 (0-255), vis equal on >= 99.9%
of pixels, output-size image and history.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from basicrenderer_tpu.graph.frame import build_frame_fn as j_build_frame_fn
from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
from basicrenderer_tpu.graph.framedata import FrameParams as JParams
from basicrenderer_tpu.graph.framedata import make_view as j_make_view
from basicrenderer_tpu_torch.graph.frame import build_frame_fn
from basicrenderer_tpu_torch.graph.framedata import FrameConfig, FrameParams, make_view
from basicrenderer_tpu_torch.graph.temporal import TemporalState
from basicrenderer_tpu_torch.ops import taa_warp
from basicrenderer_tpu_torch.ops.post import taa_jitter

from tests.test_torch_bridge import JAX_PKG, PORT_PKG, build_scene

MIRROR = dict(width=128, height=64, tile_h=16, tile_w=128, max_pairs=1 << 12,
              enable_taa=True, output_width=256, output_height=128)
MOVING = dict(width=128, height=72, tile_h=16, tile_w=128, max_pairs=1 << 12,
              enable_taa=True, output_width=192, output_height=108)
MOVING_FRAMES = 3


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float32)
                                  - np.asarray(b, np.float32)) ** 2)))


def _orbit(sc, i, aspect):
    """Frame i's camera: the golden scene's, turned 0.05 rad a frame."""
    ang = 0.05 * i
    c, s = np.cos(ang), np.sin(ang)
    sc.set_camera(position=(3 * c + 4 * s, 2.5, -3 * s + 4 * c),
                  target=(0, 0.5, 0), aspect=aspect)
    sc.propagate_transforms()


@pytest.fixture(scope="module")
def mirror_frames():
    """The six jittered frames of test_post's TAAU test in both packages:
    [(JAX outputs, port outputs)] as numpy."""
    jsc, jb = build_scene(JAX_PKG, "basic")
    psc, pb = build_scene(PORT_PKG, "basic")
    view, proj, pos = jsc.camera_matrices(aspect=2.0)
    jf = jax.jit(j_build_frame_fn(JConfig(**MIRROR, use_pallas_raster=False)))
    pf = build_frame_fn(FrameConfig(**MIRROR))
    jbuf = jb.build_scene_buffers()
    pbuf = pb.build_scene_buffers(device="cpu")
    jhist = phist = None
    outs = []
    for i in range(6):
        jx, jy = taa_jitter(i)
        pj = proj.copy()
        pj[0] += (2.0 * jx / MIRROR["width"]) * pj[3]
        pj[1] += (2.0 * jy / MIRROR["height"]) * pj[3]
        jo = jf(jbuf, j_make_view(view, pj, pos), JParams.default(),
                taa_history=jhist)
        po = pf(pbuf, make_view(view, pj, pos, device="cpu"),
                FrameParams.default("cpu"), taa_history=phist)
        jhist, phist = jo["taa_out"], po["taa_out"]
        outs.append(({k: np.asarray(v) for k, v in jo.items()},
                     {k: v.numpy() for k, v in po.items()}))
    return outs


def test_taau_mirror_shapes(mirror_frames):
    for jo, po in mirror_frames:
        assert po["image"].shape == jo["image"].shape == (128, 256, 3)
        assert po["taa_out"].shape == jo["taa_out"].shape == (128, 256, 3)
        assert po["vis"].shape == jo["vis"].shape == (64, 128)
    assert mirror_frames[-1][1]["image"].std() > 10


@pytest.mark.parametrize("frame", range(6))
def test_taau_mirror_matches_jax(mirror_frames, frame):
    jo, po = mirror_frames[frame]
    assert (po["vis"] == jo["vis"]).mean() >= 0.999
    err = _rmse(po["image"], jo["image"])
    assert err <= 1.0, f"frame {frame}: image RMSE {err:.4f}"


@pytest.fixture(scope="module")
def moving_frames():
    """The motion-vector TAAU sequence in both packages: ([(JAX outputs,
    port outputs, port frame kwargs)], the history shapes K5's plain
    version warped)."""
    jsc, jb = build_scene(JAX_PKG, "basic")
    psc, pb = build_scene(PORT_PKG, "basic")
    aspect = MOVING["width"] / MOVING["height"]
    jf = jax.jit(j_build_frame_fn(JConfig(**MOVING, use_pallas_raster=False)))
    pcfg = FrameConfig(**MOVING)
    pf = build_frame_fn(pcfg)
    temporal = TemporalState(pcfg, device="cpu")
    jbuf = jb.build_scene_buffers()
    pbuf = pb.build_scene_buffers(device="cpu")
    jprev = jnp.zeros((pcfg.padded_height, pcfg.padded_width), jnp.float32)
    jhist = None
    warped = []
    plain = taa_warp.warp_history

    def spy(hist, *a, **kw):
        warped.append(tuple(hist.shape))
        return plain(hist, *a, **kw)

    outs = []
    taa_warp.warp_history = spy
    try:
        for i in range(MOVING_FRAMES):
            _orbit(jsc, i, aspect)
            _orbit(psc, i, aspect)
            view, params, kw = temporal.inputs(psc, pb)
            jkw = {k: jnp.asarray(kw[k].numpy()) for k in
                   ("prev_viewproj", "moving_rel", "moving_ids") if k in kw}
            jo = jf(jbuf, j_make_view(view.view.numpy(), view.proj.numpy(),
                                      view.cam_pos.numpy()),
                    dataclasses.replace(JParams.default(),
                                        frame_index=jnp.int32(i)),
                    prev_depth=jprev, taa_history=jhist, **jkw)
            po = pf(pbuf, view, params, **kw)
            temporal.carry(po)
            jprev, jhist = jo["depth_padded"], jo["taa_out"]
            outs.append(({k: np.asarray(v) for k, v in jo.items()},
                         {k: v.numpy() for k, v in po.items()}, kw))
    finally:
        taa_warp.warp_history = plain
    return outs, warped


def test_taau_motion_sequence_warps_at_output_size(moving_frames):
    outs, warped = moving_frames
    # Frame 0 has no history; every later frame warps the padded
    # output-size history (108 -> 112 rows, 192 -> 256 columns).
    assert warped == [(112, 256, 3)] * (MOVING_FRAMES - 1)
    for i, (_jo, po, kw) in enumerate(outs):
        assert ("prev_viewproj" in kw) == (i > 0)
        hist = kw["taa_history"]
        assert (hist is None) == (i == 0)
        if hist is not None:
            assert tuple(hist.shape) == (108, 192, 3)
        assert po["image"].shape == po["taa_out"].shape == (108, 192, 3)
        assert po["vis"].shape == (72, 128)


@pytest.mark.parametrize("frame", range(MOVING_FRAMES))
def test_taau_motion_sequence_matches_jax(moving_frames, frame):
    jo, po, _kw = moving_frames[0][frame]
    assert (po["vis"] == jo["vis"]).mean() >= 0.999
    err = _rmse(po["image"], jo["image"])
    assert err <= 1.0, f"frame {frame}: image RMSE {err:.4f}"
    assert _rmse(po["taa_out"] * 255, jo["taa_out"] * 255) <= 1.0


def test_history_survives_temporal_inputs_at_output_size():
    psc, pb = build_scene(PORT_PKG, "basic")
    pb.build_scene_buffers(device="cpu")
    cfg = FrameConfig(**MOVING)
    temporal = TemporalState(cfg, device="cpu")
    out_hist = torch.ones((108, 192, 3))
    temporal.taa_history = out_hist
    _view, _params, kw = temporal.inputs(psc, pb)
    assert kw["taa_history"] is out_hist
    # A render-size history is not this config's: it is dropped.
    temporal.taa_history = torch.ones((72, 128, 3))
    assert temporal.inputs(psc, pb)[2]["taa_history"] is None
    # Without upscaling the render size is the history's size.
    native = TemporalState(dataclasses.replace(cfg, output_width=0,
                                               output_height=0), device="cpu")
    native.taa_history = torch.ones((72, 128, 3))
    assert native.inputs(psc, pb)[2]["taa_history"] is native.taa_history


def test_upscaling_requires_taa():
    with pytest.raises(ValueError, match="enable_taa"):
        build_frame_fn(FrameConfig(**dict(MOVING, enable_taa=False)))
