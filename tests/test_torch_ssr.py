"""Port screen-space reflections (ops/ssr.py) vs the JAX package's.

Input: an analytic two-plane G-buffer (a glossy floor y = 0 in front of a
checkered wall z = -2, sky above), made in numpy from one camera, so the
floor reflects the wall and the march has hits, misses and off-screen
rays.

The march is discontinuous: its integer gathers and its bisection decide
hit or miss from f32 comparisons, and the inverse view-projection of the
two packages differs in its last bits. So:
- the hit mask (weight > 0 at the march rate, ssr_downscale 1) may differ
  on at most 0.1% of pixels;
- where both hit, colour and weight within atol 1e-4;
- at ssr_downscale 2 (bilinear upsample), colour and weight within atol
  1e-4 on >= 99% of pixels.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
from basicrenderer_tpu.graph.framedata import make_view as j_make_view
from basicrenderer_tpu.ops import ssr as jssr
from basicrenderer_tpu_torch.graph.framedata import FrameConfig, make_view
from basicrenderer_tpu_torch.ops import ssr as pssr
from basicrenderer_tpu_torch.utils import math3d


def plane_scene(H, W, eye=(0.4, 1.2, 3.0), target=(0.0, 0.5, -1.0)):
    """An analytic G-buffer of a floor (y = 0, normal +y, roughness 0.1,
    metallic 0.5) and a wall (z = -2, normal +z, roughness 0.6) seen from
    `eye`; sky pixels have depth 0. Returns numpy planes and both
    packages' ViewData."""
    view = math3d.np_look_at(eye, target, (0, 1, 0))
    proj = math3d.np_perspective(np.radians(60.0), W / H, 0.1, None)
    vp = proj.astype(np.float64) @ view.astype(np.float64)
    inv = np.linalg.inv(vp)
    ys, xs = np.mgrid[0:H, 0:W]
    ndc = np.stack([(xs + 0.5) / W * 2 - 1, 1 - (ys + 0.5) / H * 2,
                    np.full((H, W), 0.5), np.ones((H, W))], -1)
    p = ndc @ inv.T
    p = p[..., :3] / p[..., 3:]
    e = np.asarray(eye, np.float64)
    ray = p - e
    with np.errstate(divide="ignore", invalid="ignore"):
        t_floor = np.where(ray[..., 1] < 0, -e[1] / ray[..., 1], np.inf)
        t_wall = np.where(ray[..., 2] < 0, (-2.0 - e[2]) / ray[..., 2], np.inf)
    t = np.minimum(t_floor, t_wall)
    hit = np.isfinite(t)
    wall = hit & (t_wall < t_floor)
    world = e + ray * np.where(hit, t, 0.0)[..., None]
    clip = np.concatenate([world, np.ones((H, W, 1))], -1) @ vp.T
    depth = np.where(hit, clip[..., 2] / clip[..., 3], 0.0).astype(np.float32)
    normal = np.zeros((H, W, 3), np.float32)
    normal[hit & ~wall] = (0, 1, 0)
    normal[wall] = (0, 0, 1)
    checker = ((np.floor(world[..., 0] * 2) + np.floor(world[..., 1] * 2)) % 2)
    hdr = np.where(wall[..., None], 0.5 + 2.0 * checker[..., None]
                   * np.array([1.0, 0.6, 0.3]), 0.2).astype(np.float32)
    hdr[~hit] = (0.3, 0.5, 0.9)
    roughness = np.where(wall, 0.6, np.where(hit, 0.1, 1.0)).astype(np.float32)
    metallic = np.where(hit & ~wall, 0.5, 0.0).astype(np.float32)
    pos = np.asarray(eye, np.float32)
    return dict(depth=depth, normal=normal, hdr=hdr, roughness=roughness,
                metallic=metallic,
                pview=make_view(view, proj, pos, device="cpu"),
                jview=j_make_view(view, proj, pos))


def _both(sc, **cfg):
    H, W = sc["depth"].shape
    pc = FrameConfig(width=W, height=H, **cfg)
    jc = JConfig(width=W, height=H, **cfg)
    names = ("hdr", "depth", "normal", "roughness", "metallic")
    p = pssr.ssr(*(torch.as_tensor(sc[k]) for k in names), sc["pview"], pc)
    j = jax.jit(jssr.ssr, static_argnums=6)(
        *(jnp.asarray(sc[k]) for k in names), sc["jview"], jc)
    return [x.numpy() for x in p], [np.asarray(x) for x in j]


@pytest.fixture(scope="module")
def scene():
    return plane_scene(96, 128)


def test_ssr_hits_match_jax(scene):
    (pc, pw), (jc, jw) = _both(scene, ssr_downscale=1)
    ph, jh = pw > 0, jw > 0
    assert jh.mean() > 0.05, "the floor should reflect the wall"
    assert (ph != jh).mean() <= 1e-3, (ph != jh).mean()
    both = ph & jh
    np.testing.assert_allclose(pw[both], jw[both], atol=1e-4)
    np.testing.assert_allclose(pc[both], jc[both], atol=1e-4)


@pytest.mark.parametrize("cfg", [dict(ssr_downscale=2),
                                 dict(ssr_downscale=4, ssr_steps=6,
                                      ssr_coarse_steps=8)])
def test_ssr_upsampled_matches_jax(scene, cfg):
    (pc, pw), (jc, jw) = _both(scene, **cfg)
    assert pc.shape == (96, 128, 3) and pw.shape == (96, 128)
    assert (np.abs(pw - jw) <= 1e-4).mean() >= 0.99
    assert (np.abs(pc - jc).max(-1) <= 1e-4).mean() >= 0.99
    assert (jw > 0).mean() > 0.05
