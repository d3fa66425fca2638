"""Port clustered lighting vs the JAX package: per-tile light culling and
the tiled local-light shading (K3).

- tile_world_bounds: allclose at rtol 1e-5, atol 1e-5 (the inverse
  view-projection comes from different LAPACK builds);
- cull_lights_tiles on a random depth buffer and 40 random lights: counts,
  overflow and payload equal (light ids are integers; a light within
  rounding of a tile box's edge would show here first);
- K3's plain version vs tiled_shade_pallas(interpret=True) and
  tiled_shade_ref on the same inputs: rtol 1e-3, atol 1e-4, the tolerance
  tests/test_lighting.py holds the two JAX versions to.
The CUDA kernel's comparison with the plain version is marked `cuda`.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from basicrenderer_tpu.graph.framedata import FrameConfig as JConfig
from basicrenderer_tpu.graph.framedata import make_view as j_make_view
from basicrenderer_tpu.ops import lighting as jl
from basicrenderer_tpu.utils import math3d as jmath3d
from basicrenderer_tpu_torch import interop
from basicrenderer_tpu_torch.graph.framedata import FrameConfig as PConfig
from basicrenderer_tpu_torch.ops import lighting as pl

KW = dict(width=256, height=64, tile_h=16, tile_w=128,
          max_lights_per_cluster=8)


def _view():
    view = jmath3d.np_look_at(np.array([3.0, 2.0, 4.0]), np.zeros(3),
                              np.array([0.0, 1.0, 0.0]))
    proj = jmath3d.np_perspective(1.0, 4.0, 0.1, None)
    vd = j_make_view(view, proj, np.array([3.0, 2.0, 4.0], np.float32))
    return vd, interop.view_data(
        {f: np.asarray(getattr(vd, f)) for f in ("view", "proj", "viewproj",
                                                 "cam_pos", "near")},
        device="cpu")


def _lights(rng, n):
    t = np.zeros((n, 16), np.float32)
    t[:, 0:3] = rng.uniform(-3, 3, (n, 3))
    t[:, 3] = rng.choice([1.0, 2.0], n)
    d = rng.normal(size=(n, 3))
    t[:, 4:7] = d / np.linalg.norm(d, axis=1, keepdims=True)
    t[:, 7] = rng.uniform(1, 10, n)
    t[:, 8:11] = rng.uniform(0.2, 1, (n, 3))
    t[:, 11] = rng.uniform(1, 5, n)
    t[:, 12] = np.cos(0.3)
    t[:, 13] = np.cos(0.6)
    t[0, 3] = 0.0                         # one directional: never culled in
    return t


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    jc, pc = JConfig(**KW), PConfig(**KW)
    depth = rng.uniform(0.0, 0.9, (pc.padded_height, pc.padded_width)) \
        .astype(np.float32)
    depth[:, :40] = 0.0                   # sky columns
    lights = _lights(rng, 40)
    n = rng.normal(size=(3, 64, 256)).astype(np.float32)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    shade_in = np.concatenate([
        n, rng.uniform(0, 1, (3, 64, 256)), rng.uniform(0, 1, (1, 64, 256)),
        rng.uniform(0.05, 1, (1, 64, 256)), rng.uniform(-2, 2, (3, 64, 256)),
        (rng.uniform(0, 1, (1, 64, 256)) > 0.2)]).astype(np.float32)
    jvd, pvd = _view()
    return dict(jc=jc, pc=pc, depth=depth, lights=lights, shade_in=shade_in,
                jvd=jvd, pvd=pvd, cam=np.array([3.0, 2.0, 4.0], np.float32))


def test_tile_world_bounds_match_jax(inputs):
    i = inputs
    jmin, jmax = jl.tile_world_bounds(jnp.asarray(i["depth"]), i["jvd"], i["jc"])
    pmin, pmax = pl.tile_world_bounds(torch.as_tensor(i["depth"]), i["pvd"],
                                      i["pc"])
    np.testing.assert_allclose(pmin.numpy(), np.asarray(jmin), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(pmax.numpy(), np.asarray(jmax), rtol=1e-5,
                               atol=1e-5)


def test_cull_lights_tiles_matches_jax(inputs):
    i = inputs
    jp, jn, jo = jl.cull_lights_tiles(jnp.asarray(i["depth"]),
                                      jnp.asarray(i["lights"]), jnp.int32(40),
                                      i["jvd"], i["jc"])
    pp, pn, po = pl.cull_lights_tiles(torch.as_tensor(i["depth"]),
                                      torch.as_tensor(i["lights"]),
                                      torch.tensor(40, dtype=torch.int32),
                                      i["pvd"], i["pc"])
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    assert int(po) == int(jo)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    assert int(po) > 0 and (pn.numpy() > 0).all()


@pytest.fixture(scope="module")
def shaded(inputs):
    i = inputs
    jp, jn, _ = jl.cull_lights_tiles(jnp.asarray(i["depth"]),
                                     jnp.asarray(i["lights"]), jnp.int32(40),
                                     i["jvd"], i["jc"])
    args = (jnp.asarray(i["shade_in"]), jp, jn, jnp.asarray(i["cam"]), i["jc"])
    jk = np.asarray(jl.tiled_shade_pallas(*args, interpret=True))
    jr = np.asarray(jl.tiled_shade_ref(*args))
    pargs = (torch.as_tensor(i["shade_in"]), torch.as_tensor(np.array(jp)),
             torch.as_tensor(np.array(jn)), torch.as_tensor(i["cam"]), i["pc"])
    return jk, jr, pl.tiled_shade(*pargs).numpy(), pargs


def test_tiled_shade_plain_matches_pallas_interpret(shaded):
    jk, _, p, _ = shaded
    np.testing.assert_allclose(p, jk, rtol=1e-3, atol=1e-4)
    assert np.abs(p).max() > 0.1


def test_tiled_shade_plain_matches_ref(shaded):
    _, jr, p, _ = shaded
    np.testing.assert_allclose(p, jr, rtol=1e-3, atol=1e-4)


def test_tiled_shade_rejects_bad_inputs(shaded):
    *_, pargs = shaded
    with pytest.raises(ValueError, match="counts"):
        pl.tiled_shade(pargs[0], pargs[1], pargs[2].long(), pargs[3], pargs[4])
    with pytest.raises(ValueError, match="shade_in"):
        pl.tiled_shade(pargs[0][:11], *pargs[1:])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the tiled shade kernel is CUDA "
                    "C++ and has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_tiled_shade_matches_plain(cuda_device, shaded):
    *_, pargs = shaded
    args = tuple(x.to(cuda_device) if isinstance(x, torch.Tensor) else x
                 for x in pargs)
    before = pl.tiled_shade_cuda.launches
    k = pl.tiled_shade(*args)
    torch.cuda.synchronize()
    assert pl.tiled_shade_cuda.launches == before + 1
    torch.testing.assert_close(k, pl.tiled_shade_plain(*args), rtol=1e-3,
                               atol=1e-4)
