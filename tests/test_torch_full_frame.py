"""The FULL config's frame (bench.py's `full` and `full_bc3` rows, cut to
128x128): port vs the JAX frame program on the CPU.

Scene: the cluster rig of tests/test_torch_cluster_frame.py with a
tangent-space normal map and a metallic-roughness map on the floor and
the sphere (base colour on the floor), over IBL (a procedural 16^2
environment), and the toggles of `full`: cluster LOD, two-phase
occlusion, texture channels ("base", "normal", "mr"), VSM on a small
geometry, GTAO, bloom, TAA with motion vectors, auto-exposure and SSR.
Three variants:
- "rgba8": the RGBA8 atlas sampled at texture_downscale 2, VSM's 2x2 tap
  filter;
- "bc3": the BC3 atlas sampled at full rate (texture_downscale 1), VSM's
  SMRT tier;
- "oit": "rgba8" plus bench.py's `full_oit` toggles (two OIT layers, 512
  transparent clusters, transmission, two alpha-MASK peels, with the
  alpha-MASK pass that bench.py's `full` carries), the glass quad given
  bench.py's transmission.

The camera orbits and the cube slides over a warm-up frame and three
compared frames, driven by graph/temporal.py (jitter, frame index,
motion, the VSM cache with the moved cube's pages invalidated). The
warm-up frame is the port's: its previous depth, TAA history and VSM
state go to the JAX frame as they are, so the JAX frame compiles once
per variant (its first frame, without history, is another program). On
the JAX side the test keeps the VSM cache as Renderer.update does
(renderer.py:383-427).

Parity on each compared frame: vis equal on every pixel (with the
alpha-MASK pass, on >= 99.9% of them); image RMSE vs
the JAX frame <= 1.0 (0-255); the same output keys and oit_overflow; with
OIT every peeled layer's vis (tests/test_torch_oit.py's recorders); the
VSM page tables and stats equal.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from basicrenderer_tpu.graph.frame import build_frame_fn as j_build_frame_fn
from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
from basicrenderer_tpu.graph.framedata import FrameParams as JParams
from basicrenderer_tpu.graph.framedata import make_view as j_make_view
from basicrenderer_tpu.ops import vsm as jvsm
from basicrenderer_tpu.ops.motion import MAX_MOVING
from basicrenderer_tpu_torch.graph.frame import build_frame_fn
from basicrenderer_tpu_torch.graph.framedata import FrameConfig
from basicrenderer_tpu_torch.graph.temporal import TemporalState
from basicrenderer_tpu_torch.models.environment import Environment
from basicrenderer_tpu_torch.ops.ibl import make_procedural_environment

from tests.test_torch_cluster_frame import JAX_PKG, PORT_PKG, build_rig
from tests.test_torch_oit import _local, layer_recorders
from tests.test_torch_post_frame import _move

BASE = dict(width=128, height=128, tile_h=16, tile_w=128, max_pairs=1 << 15,
            enable_clod=True, max_visible_clusters=64, enable_occlusion=True)
FULL = dict(enable_ibl=True, ibl_specular_downscale=2, enable_textures=True,
            tex_channels=("base", "normal", "mr"), enable_gtao=True,
            enable_bloom=True, enable_taa=True, enable_auto_exposure=True,
            enable_ssr=True, ssr_downscale=2, enable_vsm=True,
            vsm_pages_per_frame=1, vsm_slots=16, vsm_levels=3,
            vsm_page_size=64, vsm_page_clusters=64, vsm_page_pairs=1 << 13)
# bench.py's full_oit (bench.py:367-369): full + OIT.
FULL_OIT = dict(enable_oit=True, oit_layers=2, oit_clusters=512,
                enable_transmission=True, mask_peels=2)
VARIANTS = {
    "rgba8": dict(tex_format="rgba8", texture_downscale=2, vsm_filter_taps=4),
    "bc3": dict(tex_format="bc3", texture_downscale=1, vsm_rays=2),
    "oit": dict(tex_format="rgba8", texture_downscale=2, vsm_filter_taps=4,
                enable_alpha_mask=True, **FULL_OIT),
}
FRAMES = 3          # compared, after one warm-up frame
TABLES = ("slot_of_cell", "abs_of_cell", "cell_of_slot", "age", "z_range",
          "initialized")


def textured_rig(root, fmt, transmission=False):
    """build_rig plus a normal map and a metallic-roughness map (64^2,
    linear) on the floor and the sphere, the atlas in `fmt`; with
    `transmission` the glass quad takes bench.py's full_oit glass
    (bench.py:361-365)."""
    sc, br = build_rig(root)
    tex = br.textures
    r = tex.resolution
    yy, xx = np.mgrid[0:r, 0:r].astype(np.float32) / r
    bump = np.sin(xx * 25.0) * np.cos(yy * 25.0) * 0.35
    nrm = np.stack([bump, np.roll(bump, 5, 0),
                    np.sqrt(np.clip(1 - 2 * bump ** 2, 0.05, 1))], -1)
    t_n = tex.add(nrm * 0.5 + 0.5, srgb=False)
    orm = np.stack([np.ones_like(xx), 0.5 + 0.45 * np.sin(xx * 13.0),
                    (yy > 0.5).astype(np.float32)], -1)
    t_mr = tex.add(orm, srgb=False)
    mats = br.materials.materials
    for i in (1, 2):                      # the floor and the gold sphere
        mats[i] = dataclasses.replace(mats[i], normal_texture=t_n,
                                      metallic_roughness_texture=t_mr)
    if transmission:                      # the glass quad
        mats[3] = dataclasses.replace(
            mats[3], transmission_weight=0.9, ior=1.5, roughness=0.05,
            transmission_color=np.array([0.55, 0.7, 0.65], np.float32))
    br.tex_format = fmt
    return sc, br


class JaxVsmCache:
    """Renderer.update's VSM bookkeeping (renderer.py:383-427) for the JAX
    frame: drop on a light change, invalidate the pages of moved
    objects."""

    def __init__(self, cfg):
        self.cfg, self.state = cfg, None
        self.light_hash = self.mats = self.bounds = None

    def update(self, bridge):
        mats, _n, bounds, _v = bridge.snapshot_objects()
        lights = bridge.snapshot_lights()[0]
        lh = hash(lights.tobytes())
        if lh != self.light_hash:
            self.state = None
        self.light_hash = lh
        if self.mats is not None and self.state is not None:
            moved = np.nonzero(np.abs(mats - self.mats).max(axis=(1, 2))
                               > 1e-7)[0]
            assert len(moved) <= MAX_MOVING
            if len(moved):
                spheres = np.full((MAX_MOVING, 4), -1.0, np.float32)
                for i, o in enumerate(moved):
                    c0, r0 = self.bounds[o, :3], self.bounds[o, 3]
                    c1, r1 = bounds[o, :3], bounds[o, 3]
                    rad = float(np.linalg.norm(c1 - c0)) * 0.5 \
                        + max(float(r0), float(r1))
                    spheres[i] = [*((c0 + c1) * 0.5), rad]
                self.state = jvsm.invalidate_pages(
                    self.state, jnp.asarray(spheres),
                    jnp.asarray(lights[0, 4:7]), self.cfg)
        self.mats, self.bounds = mats.copy(), bounds.copy()


def _to_jax_state(pst):
    return jvsm.VsmState(**{f: jnp.asarray(getattr(pst, f).numpy())
                            for f in TABLES + ("atlas",)})


@pytest.fixture(scope="module")
def environment():
    env = Environment.precompute(
        make_procedural_environment(16, device="cpu").numpy(),
        use_cache=False, device="cpu")
    return dict(env_sh=env.sh, env_specular=env.spec_mips)


@pytest.fixture(scope="module")
def sequences(environment):
    """sequences(variant): the compared frames' (JAX outputs, port
    outputs, JAX and port VSM tables and stats, output keys in one only)
    as numpy, computed when a test first reads the variant."""
    def run(name):
        fmt = VARIANTS[name]["tex_format"]
        tr = VARIANTS[name].get("enable_transmission", False)
        (jsc, jb), (psc, pb) = textured_rig(JAX_PKG, fmt, tr), \
            textured_rig(PORT_PKG, fmt, tr)
        jl, pl = _local.layers = ([], [])
        flags = dict(BASE, **FULL, **VARIANTS[name])
        jcfg = JConfig(**flags, use_pallas_raster=False)
        pcfg = FrameConfig(**flags)
        jf = jax.jit(j_build_frame_fn(jcfg))
        pf = build_frame_fn(pcfg)
        temporal = TemporalState(pcfg, device="cpu")
        jcache = JaxVsmCache(jcfg)
        jbuf = jb.build_scene_buffers(**environment)
        pbuf = pb.build_scene_buffers(**environment, device="cpu")
        outs = []
        for i in range(FRAMES + 1):
            _move(jsc, JAX_PKG, i)
            _move(psc, PORT_PKG, i)
            jbuf, pbuf = jb.update_dynamic(jbuf), pb.update_dynamic(pbuf)
            jcache.update(jb)
            view, params, kw = temporal.inputs(psc, pb)
            pl.clear()
            pout = pf(pbuf, view, params, **kw)
            temporal.carry(pout)
            if i == 0:             # the warm-up frame is the port's
                jprev = jnp.asarray(pout["depth_padded"].numpy())
                jhist = jnp.asarray(pout["taa_out"].numpy())
                jcache.state = _to_jax_state(pout["vsm_state"])
                continue
            jkw = {k: jnp.asarray(kw[k].numpy())
                   for k in ("prev_viewproj", "moving_rel", "moving_ids")}
            jl.clear()
            jout = jf(jbuf, j_make_view(view.view.numpy(), view.proj.numpy(),
                                        view.cam_pos.numpy()),
                      dataclasses.replace(JParams.default(),
                                          frame_index=jnp.int32(i)),
                      prev_depth=jprev, taa_history=jhist,
                      vsm_state=jcache.state, **jkw)
            jprev, jhist = jout["depth_padded"], jout["taa_out"]
            jcache.state = jout["vsm_state"]
            jax.effects_barrier()

            def tables(st, conv):
                return {f: conv(getattr(st, f)) for f in TABLES}
            outs.append((
                {k: np.asarray(v) for k, v in jout.items()
                 if k not in ("vsm_state", "vsm_stats")},
                {k: v.numpy() for k, v in pout.items()
                 if k not in ("vsm_state", "vsm_stats")},
                tables(jout["vsm_state"], np.asarray),
                tables(pout["vsm_state"], lambda t: t.numpy()),
                {k: int(v) for k, v in jout["vsm_stats"].items()},
                {k: int(v) for k, v in pout["vsm_stats"].items()},
                sorted(set(jout) ^ set(pout)), list(jl), list(pl)))
        return outs

    @functools.cache
    def sequence(name):
        with layer_recorders():
            return run(name)
    return sequence


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_full_frames_match_jax(sequences, variant):
    for i, (jout, pout, *_rest, keys_diff, jl, pl) in enumerate(
            sequences(variant)):
        assert keys_diff == [], keys_diff
        if VARIANTS[variant].get("enable_alpha_mask"):
            # A masked texel whose sampled alpha sits at the cutoff can
            # flip (tests/test_torch_cluster_frame.py's parity level).
            agree = (pout["vis"] == jout["vis"]).mean()
            assert agree >= 0.999, f"frame {i + 1}: vis agreement {agree}"
        else:
            np.testing.assert_array_equal(pout["vis"], jout["vis"],
                                          err_msg=f"frame {i + 1}")
        assert int(pout["oit_overflow"]) == int(jout["oit_overflow"])
        # The OIT layers (full_oit): each peeled layer's vis.
        assert len(pl) == len(jl) and (len(pl) > 0) == (variant == "oit")
        for k, (jv, pv) in enumerate(zip(jl, pl)):
            np.testing.assert_array_equal(pv, jv, err_msg=f"frame {i + 1} "
                                          f"layer {k}")
        err = np.sqrt(np.mean((pout["image"].astype(np.float32)
                               - jout["image"].astype(np.float32)) ** 2))
        assert err <= 1.0, f"frame {i + 1}: image RMSE {err:.4f}"
        assert 0.3 < (pout["vis"] > 0).mean() < 0.95
        assert np.isfinite(pout["hdr"]).all()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_full_frames_vsm_state_matches_jax(sequences, variant):
    rendered = 0
    for i, (_j, _p, jt, pt, jstats, pstats, *_k) in enumerate(
            sequences(variant)):
        for f in TABLES:
            np.testing.assert_array_equal(pt[f], jt[f],
                                          err_msg=f"frame {i + 1}: {f}")
        assert pstats == jstats, f"frame {i + 1}"
        rendered += pstats["rendered"]
    assert rendered > 0                        # pages render every frame


def test_full_toggles_build_and_unported_ones_raise():
    for v in VARIANTS.values():          # full_oit's toggles among them
        build_frame_fn(FrameConfig(**BASE, **FULL, **v))
    # Vertex tangents and the soup frame's occlusion are ported now.
    build_frame_fn(FrameConfig(**BASE, **FULL, enable_vertex_tangents=True))
    build_frame_fn(FrameConfig(**{**BASE, **FULL, "enable_clod": False}))
    # So is texture streaming, the `full_streaming` row's feedback.
    build_frame_fn(FrameConfig(**BASE, **FULL, enable_texture_streaming=True,
                               enable_streaming=True))
