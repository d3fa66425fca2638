"""Port motion vectors (ops/motion.py) and the history warp K5
(ops/taa_warp.py) vs the JAX package's.

Tolerances:
- motion_field: du, dv within atol 2e-3 px (unproject through the inverse
  view-projection, whose last bits differ between the packages, then
  re-project), valid equal;
- tile_motion on the same inputs: rtol 1e-5, atol 1e-5 (sums of a tile in
  another order);
- warp_history_plain vs warp_history_ref and vs warp_history_tiles in
  interpret mode: atol 1e-5, the bound of tests/test_motion.py;
- the CUDA kernel vs warp_history_plain on the card: max abs error 0 (the
  same f32 operations in the same order), checked to 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
from basicrenderer_tpu.graph.framedata import make_view as j_make_view
from basicrenderer_tpu.ops import motion as jmotion
from basicrenderer_tpu.ops import taa_warp as jwarp
from basicrenderer_tpu.ops.raster_setup import OBJ_COMBO
from basicrenderer_tpu_torch.graph.framedata import FrameConfig, make_view
from basicrenderer_tpu_torch.ops import motion as pmotion
from basicrenderer_tpu_torch.ops import taa_warp as pwarp
from basicrenderer_tpu_torch.utils import math3d

H, W, TH, TW = 64, 256, 32, 128


def _setup():
    """A camera that moved between frames, a depth field with sky holes,
    and an object-id channel with one moved object (id 3)."""
    rng = np.random.default_rng(21)
    proj = math3d.np_perspective(np.radians(60.0), W / H, 0.1, None)
    v0 = math3d.np_look_at((0.0, 1.0, 5.0), (0, 0, 0), (0, 1, 0))
    v1 = math3d.np_look_at((0.3, 1.1, 4.8), (0.05, 0, 0), (0, 1, 0))
    prev_vp = (proj @ v0).astype(np.float32)
    depth = rng.uniform(0.02, 0.2, (H, W)).astype(np.float32)
    depth[:8] = 0.0
    obj = np.where(np.arange(W)[None, :] < W // 3, 3, 1) \
        * np.ones((H, 1), np.int64)
    combo = (obj * OBJ_COMBO + 2).astype(np.float32)
    prev_model = np.eye(4, dtype=np.float32)
    prev_model[0, 3] = -0.4
    rel = np.zeros((jmotion.MAX_MOVING, 4, 4), np.float32)
    ids = np.full((jmotion.MAX_MOVING,), -1, np.int32)
    rel[2] = prev_vp @ prev_model
    ids[2] = 3
    pos = np.array([0.3, 1.1, 4.8], np.float32)
    return dict(depth=depth, combo=combo, prev_vp=prev_vp, rel=rel, ids=ids,
                pview=make_view(v1, proj, pos, device="cpu"),
                jview=j_make_view(v1, proj, pos))


@pytest.fixture(scope="module")
def fields():
    s = _setup()
    cfg = dict(width=W, height=H, tile_h=TH, tile_w=TW)
    p = pmotion.motion_field(
        torch.as_tensor(s["depth"]), torch.as_tensor(s["combo"]), s["pview"],
        torch.as_tensor(s["prev_vp"]), torch.as_tensor(s["rel"]),
        torch.as_tensor(s["ids"]), FrameConfig(**cfg))
    j = jax.jit(jmotion.motion_field, static_argnums=6)(
        jnp.asarray(s["depth"]), jnp.asarray(s["combo"]), s["jview"],
        jnp.asarray(s["prev_vp"]), jnp.asarray(s["rel"]),
        jnp.asarray(s["ids"]), JConfig(**cfg))
    return p, j, cfg


def test_motion_field_matches_jax(fields):
    (pdu, pdv, pvalid, pds), (jdu, jdv, jvalid, jds), _ = fields
    assert pds == jds == 2 and pdu.shape == (H // 2, W // 2)
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(pdu.numpy(), np.asarray(jdu), atol=2e-3)
    np.testing.assert_allclose(pdv.numpy(), np.asarray(jdv), atol=2e-3)
    # The moved object's pixels take its own reprojection.
    live = pvalid.numpy()
    left, right = pdu.numpy()[:, :W // 6 - 2], pdu.numpy()[:, W // 6 + 2:]
    assert np.abs(left[live[:, :W // 6 - 2]].mean()
                  - right[live[:, W // 6 + 2:]].mean()) > 1.0


def test_tile_motion_matches_jax(fields):
    (du, dv, valid, ds), _, cfg = fields
    p = pmotion.tile_motion(du, dv, valid, FrameConfig(**cfg), ds)
    j = jmotion.tile_motion(jnp.asarray(du.numpy()), jnp.asarray(dv.numpy()),
                            jnp.asarray(valid.numpy()), JConfig(**cfg), ds)
    assert p[0].shape == (4,) and p[2].shape == (H // 2, W // 2)
    for a, b in zip(p, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def _warp_inputs(seed, h=H, w=W, limits=False):
    rng = np.random.default_rng(seed)
    hist = rng.random((h, w, 3)).astype(np.float32)
    T = (h // TH) * (w // TW)
    dy = rng.uniform(-10, 10, T).astype(np.float32)
    dx = rng.uniform(-30, 30, T).astype(np.float32)
    if limits:   # past the clip limits, exactly on them, negative fractions
        dy[:4] = (-95.3, 70.0, -70.0, -0.25)
        dx[:4] = (250.7, -190.0, -190.6, -0.75)
    return hist, dy, dx


@pytest.mark.parametrize("seed,limits", [(7, False), (8, True)])
def test_warp_plain_matches_jax(seed, limits):
    hist, dy, dx = _warp_inputs(seed, limits=limits)
    p = pwarp.warp_history_plain(torch.as_tensor(hist), torch.as_tensor(dy),
                                 torch.as_tensor(dx), TH, TW).numpy()
    ref = np.asarray(jwarp.warp_history_ref(jnp.asarray(hist), jnp.asarray(dy),
                                            jnp.asarray(dx), TH, TW))
    kern = np.asarray(jwarp.warp_history_tiles(
        jnp.asarray(hist), jnp.asarray(dy), jnp.asarray(dx), TH, TW,
        interpret=True))
    assert np.abs(p - ref).max() < 1e-5
    assert np.abs(p - kern).max() < 1e-5


def test_warp_wrapper_takes_plain_on_cpu():
    hist, dy, dx = _warp_inputs(9)
    args = (torch.as_tensor(hist), torch.as_tensor(dy), torch.as_tensor(dx),
            TH, TW)
    before = pwarp.warp_history_tiles.launches
    assert torch.equal(pwarp.warp_history(*args), pwarp.warp_history_plain(*args))
    assert pwarp.warp_history_tiles.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        pwarp.warp_history_tiles(*args)
    with pytest.raises(ValueError, match="multiple"):
        pwarp.warp_history(args[0][:60], *args[1:])
    z = torch.zeros(4)
    np.testing.assert_array_equal(
        pwarp.warp_history(args[0], z, z, TH, TW).numpy(), hist)
    assert (pwarp.PAD_Y, pwarp.PAD_YB, pwarp.PAD_XL, pwarp.PAD_XR) == (
        jwarp.PAD_Y, jwarp.PAD_YB, jwarp.PAD_XL, jwarp.PAD_XR)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the history warp kernel is CUDA "
                    "C++ and has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("size,limits", [((64, 256), True),
                                         ((1088, 1920), True)])
def test_cuda_warp_matches_plain(cuda_device, size, limits):
    hist, dy, dx = _warp_inputs(11, *size, limits=limits)
    args = (torch.as_tensor(hist, device=cuda_device),
            torch.as_tensor(dy, device=cuda_device),
            torch.as_tensor(dx, device=cuda_device), TH, TW)
    before = pwarp.warp_history_tiles.launches
    k = pwarp.warp_history(*args)
    torch.cuda.synchronize()
    assert pwarp.warp_history_tiles.launches == before + 1
    assert float((k - pwarp.warp_history_plain(*args)).abs().max()) <= 1e-5
