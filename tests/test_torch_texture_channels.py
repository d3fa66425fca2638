"""The texture channels of the FULL config: the BC3 atlas and its window
decode (K4's BC3 mode), the full-rate sampler and normal mapping, port vs
the JAX package on the CPU.

- models/texprocess: bc1/bc4/bc3 encode byte for byte, decode equal;
- TextureRegistry.strip_pyramid(fmt="bc3"): bit-equal atlas and flags;
- bc3_decode_rows: equal to jax.jit(bc3_decode_rows) over every 565
  endpoint pair, every alpha endpoint pair and every index of both
  palettes, and to texprocess.bc3_decode on encoder output;
- K4's BC3 plain version vs _blocked_kernel_eval(interpret=True,
  decode=bc3_decode_rows) on random windows: <= 1e-3 abs on [0, 255]
  (the tolerance of tests/test_torch_textures.py's RGBA8 check);
- sample_pyramid_blocked_planes on the BC3 atlas and sample_pyramid_blocked
  at full rate (both formats) vs the JAX package's XLA path: rtol = atol =
  2e-2 on [0, 1] (that path rounds the x-reduced window to bf16, the
  tolerance of tests/test_textures_bc.py);
- _ddx / _ddy equal; apply_normal_map_sampled (derivative frame and
  explicit frame) <= 1e-5;
- the BC3 kernel's per-tap decode: each tap's texel decoded alone from its
  block's four words (the kernel's addressing and texel decode, emulated)
  equals bc3_decode_rows(window)[row, lane], for every tap of random tap
  centres; K4's BC3 plain version with a `live` mask equals the unmasked
  result where live and 0 where not.
The CUDA kernel's BC3 comparisons with its plain version are marked `cuda`.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from basicrenderer_tpu.models import texprocess as jtp
from basicrenderer_tpu.models.textures import TextureRegistry as JTex
from basicrenderer_tpu.ops import textures as jt
from basicrenderer_tpu_torch.models import texprocess as ptp
from basicrenderer_tpu_torch.models.textures import TextureRegistry as PTex
from basicrenderer_tpu_torch.ops import textures as pt

# The JAX references run compiled (eager JAX compiles op by op).
_J_PLANES = jax.jit(jt.sample_pyramid_blocked_planes,
                    static_argnums=(5, 6, 7, 8),
                    static_argnames=("kernel", "interpret", "upsample", "fmt"))
_J_FULL = jax.jit(jt.sample_pyramid_blocked, static_argnums=(4, 5),
                  static_argnames=("kernel", "fmt"))


def _atlases():
    """Both packages' registries of one 64^2 set (checker, random sRGB,
    random data), as (JAX strips, flags), (port strips, flags) per
    format."""
    out = {}
    regs = []
    for Tex in (JTex, PTex):
        reg = Tex(resolution=64)
        reg.checkerboard(squares=4)
        img = np.random.default_rng(5).uniform(0, 1, (64, 64, 4)).astype(
            np.float32)
        reg.add(img, srgb=True)
        reg.add((img * 255).astype(np.uint8)[..., :3], srgb=False)
        regs.append(reg)
    for fmt in ("rgba8", "bc3"):
        out[fmt] = (regs[0].strip_pyramid(fmt=fmt),
                    regs[1].strip_pyramid(fmt=fmt))
    return out


@pytest.fixture(scope="module")
def atlases():
    return _atlases()


def test_bc_codec_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (32, 64, 4), np.uint8)
    img[:8, :8] = 77                                  # flat block (q0 == q1)
    for enc, dec, x in ((ptp.bc1_encode, ptp.bc1_decode, img[..., :3]),
                        (ptp.bc4_encode, ptp.bc4_decode, img[..., 3]),
                        (ptp.bc3_encode, ptp.bc3_decode, img)):
        jenc, jdec = getattr(jtp, enc.__name__), getattr(jtp, dec.__name__)
        blocks = enc(x)
        np.testing.assert_array_equal(blocks, jenc(x))
        np.testing.assert_array_equal(dec(blocks, 32, 64),
                                      jdec(blocks, 32, 64))


def test_bc3_atlas_matches_jax(atlases):
    (js, jf), (ps, pf) = atlases["bc3"]
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pf, jf)
    for r in (4, 8, 64, 256, 1024):
        assert pt.strip_layout_bc(r) == jt.strip_layout_bc(r)
        rows = pt.strip_layout_bc(r)[1]
        assert pt.infer_strip_resolution(rows, "bc3") == \
            jt.infer_strip_resolution(rows, "bc3") == r
    assert ps.shape[0] * 4 <= atlases["rgba8"][1][0].shape[0]


def _exhaustive_blocks():
    """BC3 blocks whose colour endpoints cover every (g0, g1) 6-bit pair
    (and with them every 5-bit (r0, r1) and (b0, b1) pair), whose alpha
    endpoints cover every (a0, a1) byte pair, and whose indices take every
    value of both palettes in each block. (B, 4) u32."""
    g0, g1 = (x.ravel() for x in np.meshgrid(np.arange(64), np.arange(64),
                                              indexing="ij"))
    q0 = ((g0 % 32) << 11) | (g0 << 5) | ((g0 * 7 + 3) % 32)
    q1 = ((g1 % 32) << 11) | (g1 << 5) | ((g1 * 5 + 1) % 32)
    a0, a1 = (x.ravel() for x in np.meshgrid(np.arange(256), np.arange(256),
                                              indexing="ij"))
    B = a0.size                                       # 65,536
    q0, q1 = np.resize(q0, B), np.resize(q1, B)
    cbits = sum((t % 4) << (2 * t) for t in range(16))
    abits = sum((t % 8) << (3 * t) for t in range(16))
    a_lo = a0 | (a1 << 8) | ((abits & 0xFFFF) << 16)
    words = np.stack([a_lo, np.full(B, abits >> 16), q0 | (q1 << 16),
                      np.full(B, cbits)], -1)
    return words.astype(np.uint32)


def _decode_port(rows_u32):
    return pt.bc3_decode_rows(torch.as_tensor(
        rows_u32.view(np.int32))).numpy().view(np.uint32)


def test_bc3_decode_rows_matches_jax_jit_on_every_endpoint_pair():
    rows = _exhaustive_blocks().reshape(1, -1, 128)   # (1, 2048, 128)
    j = np.asarray(jax.jit(jt.bc3_decode_rows)(jnp.asarray(rows)))
    p = _decode_port(rows)
    assert p.shape == j.shape == (1, rows.shape[1] * 4, 128)
    np.testing.assert_array_equal(p, j)


def test_bc3_decode_rows_matches_texprocess():
    rng = np.random.default_rng(3)
    band = rng.integers(0, 256, (16, 128, 4), np.uint8)
    band[:4, :4, 3] = 9                               # a0 == a1 block
    blocks = ptp.bc3_encode(band)
    rows = np.ascontiguousarray(blocks).view('<u4').reshape(1, 4, 128)
    dec = _decode_port(rows)[0]                       # (16, 128)
    got = np.stack([(dec >> s) & 0xFF for s in (0, 8, 16, 24)], -1)
    np.testing.assert_array_equal(got.astype(np.uint8),
                                  jtp.bc3_decode(blocks, 16, 128))


def _bc3_windows(seed, jobs=24, P=256, NR=60):
    rng = np.random.default_rng(seed)
    band = rng.integers(0, 256, (4 * NR, 128, 4), np.uint8)
    strips = np.ascontiguousarray(ptp.bc3_encode(band)).view('<u4') \
        .reshape(NR, 128).copy()
    strips[:4] = rng.integers(0, 2 ** 32, (4, 128), dtype=np.uint64)
    rows = rng.integers(0, NR, (jobs, pt.BC_WROWS)).astype(np.int32)
    x_hat = (rng.integers(0, 128, (jobs, P))
             + rng.uniform(0, 1, (jobs, P))).astype(np.float32)
    x_hat[:, :16] = np.floor(x_hat[:, :16])           # nearest-style taps
    yf = (rng.integers(0, pt.BC_TEXEL_ROWS - 1, (jobs, P))
          + rng.uniform(0, 1, (jobs, P))).astype(np.float32)
    return strips, rows, x_hat, yf


def _torch_args(strips, rows, x_hat, yf, device="cpu"):
    return (torch.as_tensor(strips.view(np.int32), device=device),
            torch.as_tensor(rows, device=device),
            torch.as_tensor(x_hat, device=device),
            torch.as_tensor(yf, device=device))


def test_bc3_window_eval_plain_matches_pallas_interpret():
    strips, rows, x_hat, yf = _bc3_windows(0)
    jobs, P = x_hat.shape
    j = np.asarray(jax.jit(lambda *a: jt._blocked_kernel_eval(
        *a, P, interpret=True, decode=jt.bc3_decode_rows,
        wrows=pt.BC_TEXEL_ROWS))(
            jnp.asarray(strips), jnp.asarray(rows)[None],
            jnp.asarray(x_hat)[None], jnp.asarray(yf)[None]))[0]
    p = pt.tex_block_eval(*_torch_args(strips, rows, x_hat, yf), fmt="bc3")
    assert p.shape == (jobs, P, 4)
    np.testing.assert_allclose(p.numpy(), j, rtol=0, atol=1e-3)
    assert p.max() > 200


def bc3_texel(words, yy, sx):
    """One texel of a BC3 block from its four words (u32 values in i64,
    (..., 4)), row yy and column sx (0-3), spelled as csrc/tex_block.cu's
    bc3_texel: the 565 expand, the 4-colour palette weight and the 8-step
    alpha palette, each lerp in f32 rounded half to even to a byte."""
    f32 = torch.float32
    a_lo, a_hi, c_end, c_idx = words.unbind(-1)
    t = 4 * yy + sx
    q0, q1 = c_end & 0xFFFF, c_end >> 16
    k31 = torch.tensor(255.0 / 31.0, dtype=f32)
    k63 = torch.tensor(255.0 / 63.0, dtype=f32)
    ci = (c_idx >> (2 * t)) & 3
    w0 = torch.tensor([1.0, 0.0, 2.0 / 3.0, 1.0 / 3.0], dtype=f32)[ci]

    def q8(x):
        return torch.clamp(torch.round(x), 0, 255).to(torch.int64)

    def lerp8(c0, c1):
        return q8(c0 * w0 + c1 * (1.0 - w0))

    def expand(q, shift, mask, k):
        return ((q >> shift) & mask).to(f32) * k

    rr = lerp8(expand(q0, 11, 31, k31), expand(q1, 11, 31, k31))
    gg = lerp8(expand(q0, 5, 63, k63), expand(q1, 5, 63, k63))
    bb = lerp8(expand(q0, 0, 31, k31), expand(q1, 0, 31, k31))
    low = (a_lo >> 16) | ((a_hi & 0xFFFF) << 16)
    hi16 = a_hi >> 16
    bp = 3 * t
    ai = torch.where(
        bp <= 29, (low >> torch.clamp(bp, max=29)) & 7,
        torch.where(bp == 30, ((low >> 30) & 3) | ((hi16 & 1) << 2),
                    (hi16 >> torch.clamp(bp - 32, min=0)) & 7))
    a0, a1 = (a_lo & 0xFF).to(f32), ((a_lo >> 8) & 0xFF).to(f32)
    af = ai.to(f32)
    a = torch.where(ai == 0, a0, torch.where(
        ai == 1, a1, (a0 * (8.0 - af) + a1 * (af - 1.0))
        * torch.tensor(1.0 / 7.0, dtype=f32)))
    return rr | (gg << 8) | (bb << 16) | (q8(a) << 24)


def test_bc3_per_tap_decode_reads_the_decoded_window_texel():
    strips, rows, x_hat, yf = _bc3_windows(3, jobs=40)
    win = torch.as_tensor(strips.view(np.int32))[torch.as_tensor(rows).long()]
    texels = pt.bc3_decode_rows(win).long() & 0xFFFFFFFF   # (J, 28, 128)
    words = win.long() & 0xFFFFFFFF                         # (J, 7, 128)
    J, P = x_hat.shape
    jid = torch.arange(J)[:, None].expand(J, P)
    l0 = torch.floor(torch.as_tensor(x_hat)).long() & 127
    r0 = torch.floor(torch.as_tensor(yf)).long()
    taps = 0
    for r in (r0, r0 + 1):
        ok = r < pt.BC_TEXEL_ROWS
        for lane in (l0, (l0 + 1) & 127):
            j, rr, ll = jid[ok], r[ok], lane[ok]
            # The kernel's address: block row r / 4, the block's four words
            # from lane & ~3; the texel's row and column inside the block.
            base = (ll & ~3)[:, None] + torch.arange(4)
            blk = words[j[:, None], (rr // 4)[:, None], base]
            got = bc3_texel(blk, rr % 4, ll % 4)
            assert torch.equal(got, texels[j, rr, ll])
            taps += int(ok.sum())
    assert taps > 3 * J * P


def test_bc3_window_eval_live_mask_zeroes_dead_pixels():
    args = _torch_args(*_bc3_windows(4))
    rng = np.random.default_rng(6)
    live = rng.uniform(size=tuple(args[2].shape)) < 0.5
    live[:8] = False
    live[8:16] = True
    live = torch.as_tensor(live)
    full = pt.tex_block_eval(*args, fmt="bc3")
    got = pt.tex_block_eval(*args, fmt="bc3", live=live)
    assert torch.equal(got, torch.where(live[..., None], full, 0.0))
    assert torch.equal(pt.tex_block_eval(*args, fmt="bc3",
                                         live=live.to(torch.uint8)), got)
    assert (got[~live] == 0).all() and (got[live] > 0).any()


def _planes(seed, h=40, w=56, K=2, scale=1.0):
    """Smooth UV planes and layer ids with holes and a layer boundary
    (tests/test_torch_textures.py's generator, scaled)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    u = (xx / w * 1.7 + 0.1 * np.sin(yy / 7.0) + rng.uniform(0, 1)) * scale
    v = (yy / h * 1.3 + 0.05 * xx / w + rng.uniform(0, 1)) * scale
    tids = np.full((K, h, w), 1, np.int32)
    tids[0, :, w // 2:] = 2
    tids[:, :4, :6] = -1
    tids[-1, h // 2:] = 0
    return tids, u.astype(np.float32), v.astype(np.float32)


@pytest.mark.parametrize("filt", ["bilinear", "nearest"])
def test_bc3_sampler_matches_jax(atlases, filt):
    (js, jf), _ = atlases["bc3"]
    tids, u, v = _planes(2)
    K, h, w = tids.shape
    args = (jnp.asarray(js), jnp.asarray(jf), jnp.asarray(tids),
            jnp.asarray(u), jnp.asarray(v), 2 * h, 2 * w, 2, filt)
    j = np.asarray(_J_PLANES(*args, kernel=False, upsample=False, fmt="bc3"))
    p = pt.sample_pyramid_blocked_planes(
        torch.as_tensor(js.view(np.int32)), torch.as_tensor(jf),
        torch.as_tensor(tids), torch.as_tensor(u), torch.as_tensor(v),
        2 * h, 2 * w, 2, filt, upsample=False, fmt="bc3").numpy()
    assert p.shape == j.shape == (K, h, w, 4)
    np.testing.assert_allclose(p, j, rtol=2e-2, atol=2e-2)
    assert (p[:, :4, :6] == 1.0).all()                # no texture -> white


@pytest.mark.parametrize("fmt,scale", [("rgba8", 1.0), ("bc3", 1.0),
                                       ("bc3", 0.2)])
def test_full_rate_sampler_matches_jax(atlases, fmt, scale):
    """sample_pyramid_blocked at downscale 1 (and a minified UV scale that
    picks coarser mips)."""
    (js, jf), _ = atlases[fmt]
    tids, u, v = _planes(3, h=32, w=48, scale=scale)
    uv = np.stack([u, v], -1)
    jargs = (jnp.asarray(js), jnp.asarray(jf), jnp.asarray(tids),
             jnp.asarray(uv))
    j = np.asarray(_J_FULL(*jargs, 1, kernel=False, fmt=fmt))
    p = pt.sample_pyramid_blocked(
        torch.as_tensor(js.view(np.int32)), torch.as_tensor(jf),
        torch.as_tensor(tids), torch.as_tensor(uv), 1, fmt=fmt).numpy()
    assert p.shape == j.shape == (2, 32, 48, 4)
    np.testing.assert_allclose(p, j, rtol=2e-2, atol=2e-2)


def test_ddx_ddy_match_jax():
    x = np.random.default_rng(7).normal(size=(9, 11, 3)).astype(np.float32)
    for pf, jf_ in ((pt._ddx, jt._ddx), (pt._ddy, jt._ddy)):
        np.testing.assert_array_equal(pf(torch.as_tensor(x)).numpy(),
                                      np.asarray(jf_(jnp.asarray(x))))


def _normal_map_inputs(seed=8, h=24, w=32):
    """A curved surface patch: world positions, normals and uv varying
    smoothly, a sampled normal map, ids with holes and a degenerate
    (constant-uv) strip, per-pixel normal scales."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    wp = np.stack([xx * 0.05, 0.02 * np.sin(xx / 5.0) + yy * 0.01,
                   yy * 0.04], -1)
    n = np.stack([0.1 * np.sin(yy / 4.0), np.ones_like(xx),
                  0.1 * np.cos(xx / 6.0)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    uv = np.stack([xx / w * 2.0 + 0.1 * yy / h, yy / h * 1.5], -1)
    uv[:, -5:] = 0.3                                  # det = 0 columns
    smp = rng.uniform(0, 1, (h, w, 4))
    tex = np.where(rng.uniform(0, 1, (h, w)) < 0.1, -1, 2).astype(np.int32)
    scale = rng.uniform(0.5, 1.5, (h, w, 1))
    return [a.astype(np.float32) if a.dtype.kind == "f" else a
            for a in (n, wp, uv, smp, tex, scale)]


def test_apply_normal_map_sampled_matches_jax():
    n, wp, uv, smp, tex, scale = _normal_map_inputs()
    jfn = jax.jit(jt.apply_normal_map_sampled)
    j = np.asarray(jfn(*map(jnp.asarray, (n, wp, uv, smp, tex, scale))))
    p = pt.apply_normal_map_sampled(*map(torch.as_tensor,
                                         (n, wp, uv, smp, tex)),
                                    normal_scale=torch.as_tensor(scale))
    np.testing.assert_allclose(p.numpy(), j, rtol=0, atol=1e-5)
    moved = np.abs(p.numpy() - n).max(-1) > 1e-3
    assert moved.mean() > 0.5                         # the map perturbs
    assert not moved[tex < 0].any()                   # no map: geometric
    assert not moved[:, -4:].any()                    # degenerate frame


def test_apply_normal_map_explicit_frame_matches_jax():
    n, wp, uv, smp, tex, scale = _normal_map_inputs(9)
    t = np.cross(n, np.array([0, 0, 1], np.float32))
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    b = np.cross(n, t)
    j = np.asarray(jax.jit(lambda *a: jt.apply_normal_map_sampled(
        *a[:5], a[5], frame=(a[6], a[7])))(
            *map(jnp.asarray, (n, wp, uv, smp, tex, scale, t, b))))
    p = pt.apply_normal_map_sampled(
        *map(torch.as_tensor, (n, wp, uv, smp, tex)),
        normal_scale=torch.as_tensor(scale),
        frame=(torch.as_tensor(t), torch.as_tensor(b)))
    np.testing.assert_allclose(p.numpy(), j, rtol=0, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the texture window kernel is CUDA "
                    "C++ and has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_bc3_window_eval_matches_plain(cuda_device):
    args = _torch_args(*_bc3_windows(1, jobs=300), device=cuda_device)
    before = pt.tex_block_eval_bc3_cuda.launches
    k = pt.tex_block_eval(*args, fmt="bc3")
    torch.cuda.synchronize()
    assert pt.tex_block_eval_bc3_cuda.launches == before + 1
    torch.testing.assert_close(k, pt.tex_block_eval_bc3_plain(*args), rtol=0,
                               atol=1e-3)


@pytest.mark.cuda
def test_cuda_bc3_window_eval_with_live_matches_plain(cuda_device):
    """The BC3 kernel with a live mask (jobs all live, all dead, partly
    dead) vs the plain version: exact, one launch."""
    args = _torch_args(*_bc3_windows(5, jobs=300), device=cuda_device)
    rng = np.random.default_rng(7)
    live = rng.uniform(size=tuple(args[2].shape)) < 0.5
    live[:100] = False
    live[100:200] = True
    live = torch.as_tensor(live, device=cuda_device)
    before = pt.tex_block_eval_bc3_cuda.launches
    k = pt.tex_block_eval(*args, fmt="bc3", live=live)
    torch.cuda.synchronize()
    assert pt.tex_block_eval_bc3_cuda.launches == before + 1
    assert torch.equal(k, pt.tex_block_eval_bc3_plain(*args, live=live))
