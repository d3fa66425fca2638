"""Port texture path vs the JAX package: the strip atlas, the block-window
sampler, its window evaluator (K4) and the bilinear upsample.

- TextureRegistry.strip_pyramid: bit-equal atlas and flags;
- K4's plain version vs _blocked_kernel_eval(interpret=True) on random
  windows and tap centres: <= 1e-3 abs on the [0, 255] scale (both sum the
  same two taps; the bound leaves room for the MXU's f32 accumulation);
- sample_pyramid_blocked_planes vs the JAX package's XLA path (the one
  its frame takes on the CPU): rtol = atol = 2e-2 on [0, 1], the
  tolerance of tests/test_textures_bc.py (that path rounds the x-reduced
  window to bf16);
- resize_bilinear vs jax.image.resize(..., "bilinear"): atol 1e-6;
- K4's `live` mask: the plain version with a mask equals the unmasked
  result where live and 0 where not, with jobs all live, all dead and
  partly dead (bool and uint8 masks alike).
The CUDA kernel's comparisons with the plain version are marked `cuda`.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from basicrenderer_tpu.models.textures import TextureRegistry as JTex
from basicrenderer_tpu.ops import textures as jt
from basicrenderer_tpu_torch.models.textures import TextureRegistry as PTex
from basicrenderer_tpu_torch.ops import textures as pt


def _registries():
    rng = np.random.default_rng(4)
    out = []
    for Tex in (JTex, PTex):
        reg = Tex(resolution=64)
        reg.checkerboard(squares=4)
        img = np.random.default_rng(5).uniform(0, 1, (64, 64, 4)).astype(
            np.float32)
        reg.add(img, srgb=True)
        reg.add((img * 255).astype(np.uint8)[..., :3], srgb=False)
        out.append(reg)
    return out, rng


@pytest.fixture(scope="module")
def atlas():
    (jreg, preg), _ = _registries()
    return jreg.strip_pyramid(), preg.strip_pyramid()


def test_strip_pyramid_matches_jax(atlas):
    (js, jf), (ps, pf) = atlas
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pf, jf)
    assert pt.strip_layout(64) == jt.strip_layout(64)
    assert pt.mip_layout(64) == jt.mip_layout(64)
    assert pt.layer_words(64) == jt.layer_words(64)


def _windows(seed, jobs=40, P=256, NR=200):
    rng = np.random.default_rng(seed)
    strips = rng.integers(0, 2 ** 32, (NR, 128), dtype=np.uint64).astype(
        np.uint32)
    rows = rng.integers(0, NR, (jobs, pt.WROWS)).astype(np.int32)
    ix0 = rng.integers(0, 128, (jobs, P))
    fx = rng.uniform(0, 1, (jobs, P))
    fx[:, :16] = 0.0                                  # nearest-style taps
    x_hat = (ix0 + fx).astype(np.float32)
    wy0 = rng.integers(0, pt.WROWS - 1, (jobs, P))
    yf = (wy0 + rng.uniform(0, 1, (jobs, P))).astype(np.float32)
    return strips, rows, x_hat, yf


def _torch_args(strips, rows, x_hat, yf, device="cpu"):
    return (torch.as_tensor(strips.view(np.int32), device=device),
            torch.as_tensor(rows, device=device),
            torch.as_tensor(x_hat, device=device),
            torch.as_tensor(yf, device=device))


@pytest.mark.parametrize("seed", [0, 1])
def test_window_eval_plain_matches_pallas_interpret(seed):
    strips, rows, x_hat, yf = _windows(seed)
    jobs, P = x_hat.shape
    j = np.asarray(jt._blocked_kernel_eval(
        jnp.asarray(strips), jnp.asarray(rows)[None], jnp.asarray(x_hat)[None],
        jnp.asarray(yf)[None], P, interpret=True))[0]
    p = pt.tex_block_eval(*_torch_args(strips, rows, x_hat, yf)).numpy()
    assert p.shape == (jobs, P, 4)
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-3)
    assert p.max() > 200


def live_mask(seed, jobs, P):
    """(jobs, P) bool: the first third of the jobs dead, the second live,
    the rest live at random pixels (about half)."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(size=(jobs, P)) < 0.5
    m[:jobs // 3] = False
    m[jobs // 3:2 * jobs // 3] = True
    return m


def test_window_eval_live_mask_zeroes_dead_pixels():
    args = _torch_args(*_windows(2))
    live = torch.as_tensor(live_mask(3, *args[2].shape))
    full = pt.tex_block_eval(*args)
    got = pt.tex_block_eval(*args, live=live)
    assert torch.equal(got, torch.where(live[..., None], full, 0.0))
    assert torch.equal(pt.tex_block_eval(*args, live=live.to(torch.uint8)),
                       got)
    assert torch.equal(pt.tex_block_eval(*args, live=torch.ones_like(live)),
                       full)
    assert (got[~live] == 0).all() and (got[live] > 0).any()
    with pytest.raises(ValueError, match="live"):
        pt.tex_block_eval(*args, live=live[:, :10].contiguous())


def _planes(seed, h=40, w=56, K=2):
    """Smooth UV planes (a gentle perspective-like warp) and layer ids with
    holes and a layer boundary."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    u = (xx / w * 1.7 + 0.1 * np.sin(yy / 7.0) + rng.uniform(0, 1)).astype(
        np.float32)
    v = (yy / h * 1.3 + 0.05 * xx / w + rng.uniform(0, 1)).astype(np.float32)
    tids = np.full((K, h, w), 1, np.int32)
    tids[0, :, w // 2:] = 2
    tids[:, :4, :6] = -1
    tids[-1, h // 2:] = 0
    return tids, u, v


@pytest.mark.parametrize("filt", ["bilinear", "nearest"])
def test_sampler_matches_jax_xla_path(atlas, filt):
    (js, jf), _ = atlas
    tids, u, v = _planes(2)
    K, h, w = tids.shape
    j = np.asarray(jt.sample_pyramid_blocked_planes(
        jnp.asarray(js), jnp.asarray(jf), jnp.asarray(tids), jnp.asarray(u),
        jnp.asarray(v), 2 * h, 2 * w, 2, filt, kernel=False, upsample=False))
    p = pt.sample_pyramid_blocked_planes(
        torch.as_tensor(js.view(np.int32)), torch.as_tensor(jf),
        torch.as_tensor(tids), torch.as_tensor(u), torch.as_tensor(v),
        2 * h, 2 * w, 2, filt, upsample=False).numpy()
    assert p.shape == j.shape == (K, h, w, 4)
    np.testing.assert_allclose(p, j, rtol=2e-2, atol=2e-2)
    assert (p[:, :4, :6] == 1.0).all()          # no texture -> white


def test_sampler_upsample_matches_jax(atlas):
    (js, jf), _ = atlas
    tids, u, v = _planes(3, K=1)
    h, w = u.shape
    j = np.asarray(jt.sample_pyramid_blocked_planes(
        jnp.asarray(js), jnp.asarray(jf), jnp.asarray(tids), jnp.asarray(u),
        jnp.asarray(v), 2 * h, 2 * w, 2, kernel=False))
    p = pt.sample_pyramid_blocked_planes(
        torch.as_tensor(js.view(np.int32)), torch.as_tensor(jf),
        torch.as_tensor(tids), torch.as_tensor(u), torch.as_tensor(v),
        2 * h, 2 * w, 2).numpy()
    assert p.shape == (1, 2 * h, 2 * w, 4)
    np.testing.assert_allclose(p, j, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("shape,out", [((1, 7, 9, 4), (14, 18)),
                                       ((5, 6), (15, 12))])
def test_resize_bilinear_matches_jax_image_resize(shape, out):
    x = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    row = 1 if len(shape) == 4 else 0
    full = list(shape)
    full[row], full[row + 1] = out
    j = np.asarray(jax.image.resize(jnp.asarray(x), full, method="bilinear"))
    p = pt.resize_bilinear(torch.as_tensor(x), *out, row_dim=row).numpy()
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-6)


@pytest.mark.parametrize("fmt", ["rgba8", "bc3"])
def test_alpha_coverage_strip_pyramids_match_jax(fmt):
    """Layers added with an alpha cutoff (alpha-MASK base colours) get
    coverage-preserving mips: the port's strip pyramid equals the JAX
    registry's in both formats, and differs from the same layers' pyramid
    without the fix."""
    rng = np.random.default_rng(21)
    regs = [JTex(resolution=64), PTex(resolution=64), PTex(resolution=64)]
    for k, cutoff in enumerate((0.5, -1.0, 0.3, 0.8)):
        alpha = (rng.random((64, 64)) < 0.25 + 0.1 * k).astype(np.float32)
        img = np.concatenate([rng.random((64, 64, 3)).astype(np.float32),
                              alpha[..., None]], -1)
        for r, c in zip(regs, (cutoff, cutoff, -1.0)):
            r.add(img, srgb=k % 2 == 0, alpha_cutoff=c)
    (js, jf), (ps, pf), (ns, _) = (r.strip_pyramid(fmt=fmt) for r in regs)
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pf, jf)
    assert not np.array_equal(ps, ns)


def test_unported_texture_modes_raise():
    # BC3 is ported (tests/test_torch_texture_channels.py); a format
    # neither package has is refused.
    with pytest.raises(ValueError, match="bc7"):
        PTex(resolution=16).strip_pyramid(fmt="bc7")
    with pytest.raises(ValueError, match="bc7"):
        pt.infer_strip_resolution(7, "bc7")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the texture window kernel is CUDA "
                    "C++ and has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_window_eval_matches_plain(cuda_device):
    args = _torch_args(*_windows(0, jobs=300), device=cuda_device)
    before = pt.tex_block_eval_cuda.launches
    k = pt.tex_block_eval(*args)
    torch.cuda.synchronize()
    assert pt.tex_block_eval_cuda.launches == before + 1
    torch.testing.assert_close(k, pt.tex_block_eval_plain(*args), rtol=0,
                               atol=1e-3)


@pytest.mark.cuda
def test_cuda_window_eval_with_live_matches_plain(cuda_device):
    """The kernel with a live mask (jobs all live, all dead, partly dead)
    vs the plain version: exact, one launch."""
    args = _torch_args(*_windows(4, jobs=300), device=cuda_device)
    live = torch.as_tensor(live_mask(5, *args[2].shape), device=cuda_device)
    before = pt.tex_block_eval_cuda.launches
    k = pt.tex_block_eval(*args, live=live)
    torch.cuda.synchronize()
    assert pt.tex_block_eval_cuda.launches == before + 1
    assert torch.equal(k, pt.tex_block_eval_plain(*args, live=live))
