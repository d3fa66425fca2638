"""Virtual shadow maps: ops/vsm.py of the port vs the JAX package on the
CPU, function by function.

Scene: the cluster rig of tests/test_torch_cluster_frame.py at 128x128 on
a small VSM geometry (3 clipmap levels of 8x8 pages of 64^2 texels, 16
physical slots, 2 pages a frame), its receivers' depth rendered by the
port's cluster frame from a camera that orbits a little each frame; the
same depth goes to both packages. Five frames of the point tier, with the
cube's pages invalidated before the fourth (`invalidate_pages`); then one
frame each of the 2x2 tap filter and SMRT tiers from the JAX package's
state, carried into the port by interop.vsm_state.

Parity:
- the page tables (slot_of_cell, abs_of_cell, cell_of_slot, age), the
  frozen z range, the initialised flag and the stats are equal: the
  stable argsorts allocate the same slots;
- the atlas agrees within 2e-4 where a page was written (the setup
  planes' tolerance of tests/test_torch_raster_setup.py: the JAX setup's
  multiply-adds are contracted);
- the shadow term agrees within 1e-5 on all but at most 0.1% of pixels.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from basicrenderer_tpu.graph import frame as jframe
from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
from basicrenderer_tpu.graph.framedata import FrameParams as JParams
from basicrenderer_tpu.graph.framedata import make_view as j_make_view
from basicrenderer_tpu.ops import clod as jclod
from basicrenderer_tpu.ops import vsm as jvsm
from basicrenderer_tpu.utils import math3d as jm3
from basicrenderer_tpu_torch import interop
from basicrenderer_tpu_torch.graph import frame as pframe
from basicrenderer_tpu_torch.graph.framedata import FrameConfig, FrameParams, make_view
from basicrenderer_tpu_torch.ops import vsm as pvsm

from tests.test_torch_cluster_frame import JAX_PKG, PORT_PKG, build_rig

SMALL = dict(width=128, height=128, tile_h=16, tile_w=128, max_pairs=1 << 15,
             enable_clod=True, max_visible_clusters=64, enable_vsm=True,
             vsm_pages_per_frame=2, vsm_slots=16, vsm_levels=3,
             vsm_page_size=64, vsm_page_grid=8, vsm_page_clusters=64,
             vsm_page_pairs=1 << 13)
TABLES = ("slot_of_cell", "abs_of_cell", "cell_of_slot", "age", "z_range",
          "initialized")
TIERS = {"point": {}, "pcf": dict(vsm_filter_taps=4),
         "smrt": dict(vsm_rays=3, vsm_ray_samples=3)}
FRAMES = 5
INVALIDATE_BEFORE = 3
CUBE_SPHERE = np.array([[-1.4, 0.35, 0.6, 0.7]], np.float32)


def _camera(sc, i):
    ang = 0.05 * i
    c, s = np.cos(ang), np.sin(ang)
    sc.set_camera(position=(2.6 * c - 3.2 * s, 2.0, 2.6 * s + 3.2 * c),
                  target=(0, 0.6, 0), aspect=1.0)
    sc.propagate_transforms()


def _j_step(cfg):
    """jax.jit of one update_vsm step with the frame's page compaction."""
    def step(scene, view, params, state, depth):
        def page_compact(vp):
            cut, cw, rw = jframe.clod_cut(scene, view, cfg, params,
                                          frustum=False, return_bounds=True)
            cut = cut & jm3.sphere_in_frustum(jm3.frustum_planes(vp), cw, rw)
            return jclod.compact_visible_tris(
                cut=cut, scene=scene, max_visible=cfg.vsm_page_clusters)
        return jvsm.update_vsm(scene, view, cfg, params, state, depth,
                               page_compact)
    return jax.jit(step)


def _p_step(cfg, scene, view, params, state, depth):
    cut, cw, rw = pframe.clod_cut(scene, view, cfg, params, frustum=False,
                                  return_bounds=True)

    def page_compact(vp):
        keep = cut & pframe.math3d.sphere_in_frustum(
            pframe.math3d.frustum_planes(vp), cw, rw)
        return pframe.clod_ops.compact_visible_tris(
            cut=keep, scene=scene, max_visible=cfg.vsm_page_clusters)
    return pvsm.update_vsm(scene, view, cfg, params, state, depth,
                           page_compact)


def _np_state(st):
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(pvsm.VsmState)}


@pytest.fixture(scope="module")
def rig():
    (jsc, jb), (psc, pb) = build_rig(JAX_PKG), build_rig(PORT_PKG)
    return dict(jsc=jsc, psc=psc, jbuf=jb.build_scene_buffers(),
                pbuf=pb.build_scene_buffers(device="cpu"),
                depth_fn=pframe.build_frame_fn(FrameConfig(**dict(
                    SMALL, enable_vsm=False))))


def _inputs(rig, i):
    """Frame i's views for both packages and the port's depth."""
    _camera(rig["jsc"], i)
    _camera(rig["psc"], i)
    pview = make_view(*rig["psc"].camera_matrices(aspect=1.0), device="cpu")
    jview = j_make_view(pview.view.numpy(), pview.proj.numpy(),
                        pview.cam_pos.numpy())
    depth = rig["depth_fn"](rig["pbuf"], pview, FrameParams.default("cpu"))
    return jview, pview, depth["depth"]


def _compare(jout, pout, label):
    jterm, jst, jstats = jout
    pterm, pst, pstats = pout
    js, ps = _np_state(jst), _np_state(pst)
    for f in TABLES:
        np.testing.assert_array_equal(ps[f], js[f], err_msg=f"{label}: {f}")
    assert {k: int(v) for k, v in pstats.items()} == \
        {k: int(v) for k, v in jstats.items()}, label
    written = js["cell_of_slot"] >= 0
    np.testing.assert_allclose(ps["atlas"][written], js["atlas"][written],
                               rtol=0, atol=2e-4, err_msg=label)
    diff = np.abs(pterm.numpy() - np.asarray(jterm))
    assert (diff > 1e-5).mean() <= 1e-3, f"{label}: {(diff > 1e-5).mean()}"
    return np.asarray(jterm)


@pytest.fixture(scope="module")
def j_steps(rig):
    """Per tier, (JAX config, jitted JAX step), each compiled by a first
    call on the initial state; the three run in threads so that their XLA
    compiles overlap."""
    jview, _pview, depth = _inputs(rig, 0)

    def compiled(flags):
        cfg = JConfig(**SMALL, **flags, use_pallas_raster=False)
        f = _j_step(cfg)
        f(rig["jbuf"], jview, JParams.default(), jvsm.init_state(cfg),
          jnp.asarray(depth.numpy()))
        return cfg, f
    with ThreadPoolExecutor(len(TIERS)) as pool:
        return dict(zip(TIERS, pool.map(compiled, TIERS.values())))


@pytest.fixture(scope="module")
def point_run(rig, j_steps):
    """The point tier over FRAMES frames: per frame the JAX and port
    (term, state, stats), the invalidation's two results, and the last
    inputs."""
    jcfg, jf = j_steps["point"]
    pcfg = FrameConfig(**SMALL)
    jp, pp = JParams.default(), FrameParams.default("cpu")
    jst, pst = jvsm.init_state(jcfg), pvsm.init_state(pcfg, device="cpu")
    outs, inval = [], None
    for i in range(FRAMES):
        if i == INVALIDATE_BEFORE:
            ldir = rig["pbuf"].lights[0, 4:7]
            jst = jvsm.invalidate_pages(jst, jnp.asarray(CUBE_SPHERE),
                                        jnp.asarray(ldir.numpy()), jcfg)
            pst = pvsm.invalidate_pages(pst, torch.as_tensor(CUBE_SPHERE),
                                        ldir, pcfg)
            inval = (np.asarray(jst.abs_of_cell), pst.abs_of_cell.numpy())
        jview, pview, depth = _inputs(rig, i)
        jo = jf(rig["jbuf"], jview, jp, jst, jnp.asarray(depth.numpy()))
        po = _p_step(pcfg, rig["pbuf"], pview, pp, pst, depth)
        outs.append((jo, po))
        jst, pst = jo[1], po[1]
    return outs, inval, (jview, pview, depth)


def test_update_vsm_point_tier_matches_jax(point_run):
    outs, _inval, _last = point_run
    rendered = 0
    for i, (jo, po) in enumerate(outs):
        term = _compare(jo, po, f"frame {i}")
        rendered += int(po[2]["rendered"])
        assert int(po[2]["rendered"]) <= SMALL["vsm_pages_per_frame"]
    assert rendered >= 2 * FRAMES - 1          # the budget is used
    assert (term < 0.5).mean() > 0.005         # some receivers in shadow
    assert bool(outs[-1][1][1].initialized)


def test_invalidate_pages_matches_jax(point_run):
    _outs, (jabs, pabs), _last = point_run
    np.testing.assert_array_equal(pabs, jabs)
    before = np.asarray(_outs[INVALIDATE_BEFORE - 1][0][1].abs_of_cell)
    cleared = (before >= 0) & (jabs < 0)
    assert cleared.any()                       # the cube's pages went
    assert (jabs[~cleared] == before[~cleared]).all()


@pytest.mark.parametrize("tier", ["pcf", "smrt"])
def test_update_vsm_filter_tiers_match_jax(rig, j_steps, point_run, tier):
    """One frame of the tier from the JAX package's last state, carried
    into the port."""
    outs, _inval, (jview, pview, depth) = point_run
    _jcfg, jf = j_steps[tier]
    pcfg = FrameConfig(**SMALL, **TIERS[tier])
    jst = outs[-1][0][1]
    pst = interop.vsm_state(_np_state(jst), device="cpu")
    jo = jf(rig["jbuf"], jview, JParams.default(), jst,
            jnp.asarray(depth.numpy()))
    po = _p_step(pcfg, rig["pbuf"], pview, FrameParams.default("cpu"), pst,
                 depth)
    term = _compare(jo, po, tier)
    soft = (term > 0.02) & (term < 0.98)
    assert soft.any()                          # a filtered penumbra


def test_vsm_state_defaults():
    st = pvsm.init_states(FrameConfig(**dict(SMALL, vsm_num_lights=2)),
                          device="cpu")
    assert isinstance(st, tuple) and len(st) == 2
    js = jvsm.init_state(JConfig(**SMALL))
    ps = _np_state(st[0])
    for f, v in _np_state(js).items():
        np.testing.assert_array_equal(ps[f], v, err_msg=f)
    d = np.array([-0.5, -1.0, -0.35], np.float32)
    np.testing.assert_allclose(
        pvsm.light_basis(torch.as_tensor(d)).numpy(),
        np.asarray(jax.jit(jvsm.light_basis)(jnp.asarray(d))), atol=1e-6)
