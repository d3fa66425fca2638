"""The whole soup frame: port vs the JAX frame program on the CPU.

Scene: tests/test_frame_e2e.build_test_scene (the golden scene), built by
each package from its own host modules, at 128x128 with tile_h=16.

Parity levels:
- `vis` equal on >= 99.9% of pixels. The port's setup rounds differently
  from XLA's fused setup, which can move a pixel that sits exactly on an
  edge; on this scene 0 of 16384 pixels differ (measured).
- image RMSE vs the JAX frame <= 1.0 on the 0-255 scale (measured 0.0).
- image RMSE vs tests/goldens/basic_deferred.png <= 6, the check of
  tests/test_goldens.py.
- equal bin_overflow and num_pairs.
"""

import dataclasses
import os

import numpy as np
import jax
import pytest
import torch

from basicrenderer_tpu.graph.frame import build_frame_fn as j_build_frame_fn
from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
from basicrenderer_tpu.graph.framedata import FrameParams as JParams
from basicrenderer_tpu.graph.framedata import make_view as j_make_view
from basicrenderer_tpu_torch.graph.frame import build_frame_fn
from basicrenderer_tpu_torch.graph.framedata import FrameConfig, FrameParams, make_view
from basicrenderer_tpu_torch.utils.png import read_png

from tests.test_torch_bridge import JAX_PKG, PORT_PKG, build_scene

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "basic_deferred.png")
CFG_KW = dict(width=128, height=128, tile_h=16, tile_w=128, max_pairs=1 << 12,
              use_pallas_raster=False)


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float32)
                                  - np.asarray(b, np.float32)) ** 2)))


def _frames(variant):
    jsc, jb = build_scene(JAX_PKG, variant)
    view, proj, pos = jsc.camera_matrices(aspect=1.0)
    jout = jax.jit(j_build_frame_fn(JConfig(**CFG_KW)))(
        jb.build_scene_buffers(), j_make_view(view, proj, pos), JParams.default())
    psc, pb = build_scene(PORT_PKG, variant)
    view, proj, pos = psc.camera_matrices(aspect=1.0)
    pout = build_frame_fn(FrameConfig(**CFG_KW))(
        pb.build_scene_buffers(device="cpu"),
        make_view(view, proj, pos, device="cpu"), FrameParams.default("cpu"))
    return ({k: np.asarray(v) for k, v in jout.items()},
            {k: v.numpy() for k, v in pout.items()})


@pytest.fixture(scope="module")
def basic_frames():
    return _frames("basic")


def test_frame_vis_matches_jax(basic_frames):
    jout, pout = basic_frames
    agree = (pout["vis"] == jout["vis"]).mean()
    assert agree >= 0.999, f"vis agreement {agree:.5f}"
    assert 0.3 < (pout["vis"] > 0).mean() < 0.95


def test_frame_image_matches_jax(basic_frames):
    jout, pout = basic_frames
    assert pout["image"].shape == jout["image"].shape == (128, 128, 3)
    assert pout["image"].dtype == np.uint8
    assert _rmse(pout["image"], jout["image"]) <= 1.0


def test_frame_matches_golden(basic_frames):
    _, pout = basic_frames
    assert _rmse(pout["image"], read_png(GOLDEN)) <= 6.0


def test_frame_counters_and_keys_match_jax(basic_frames):
    jout, pout = basic_frames
    assert set(pout) == set(jout)
    for k in ("bin_overflow", "num_pairs", "cluster_overflow",
              "light_overflow", "oit_overflow"):
        assert int(pout[k]) == int(jout[k]), k
    assert int(pout["bin_overflow"]) == 0


def test_frame_with_local_lights_matches_jax():
    """Point and spot lights, metals and emissive through the same path."""
    jout, pout = _frames("mixed")
    assert (pout["vis"] == jout["vis"]).mean() >= 0.999
    assert _rmse(pout["image"], jout["image"]) <= 1.0


@pytest.mark.parametrize("field,value", [
    ("enable_texture_streaming", True), ("enable_reyes", True),
    ("enable_shadows", True),
    ("enable_voxel_rt", True), ("enable_coat", True), ("enable_skinning", True),
    ("enable_oit", True), ("max_shadow_lights", 2), ("debug_view", "normals"),
    ("wireframe", True), ("enable_vertex_tangents", True),
    ("output_width", 256),
])
def test_unported_toggles_raise(field, value):
    cfg = dataclasses.replace(FrameConfig(**CFG_KW), **{field: value})
    with pytest.raises(NotImplementedError, match=field):
        build_frame_fn(cfg)


def test_png_reader_matches_imageio():
    import imageio.v3 as iio
    for name in ("basic_deferred.png", "g512_oit.png"):
        path = os.path.join(os.path.dirname(GOLDEN), name)
        if not os.path.exists(path):
            continue
        np.testing.assert_array_equal(read_png(path), iio.imread(path))
    assert read_png(GOLDEN).shape == (128, 128, 3)
