"""The port's texture processing (models/texprocess.py) and alpha-coverage
mips against the JAX package's: the cases of tests/test_texprocess.py
(DDS and HDR containers, the decode dispatch, alpha-coverage mips, the
processed-texture cache), each checked against the JAX function's output
on the same inputs, not only against itself. Both packages run the same
numpy code, so every output must be equal."""

import io
import struct

import numpy as np
import pytest

from basicrenderer_tpu.models import texprocess as jtp
from basicrenderer_tpu.models.textures import TextureRegistry as JTex
from basicrenderer_tpu_torch.models import texprocess as ptp
from basicrenderer_tpu_torch.models.textures import TextureRegistry as PTex

from tests.test_texprocess import _gradient_rgba


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("fourcc", [None, "DXT1", "DXT5"])
def test_dds_roundtrip_matches_jax(tmp_path, fourcc):
    img = _gradient_rgba(16, 32)
    jp, pp = str(tmp_path / "j.dds"), str(tmp_path / "p.dds")
    jtp.save_dds(jp, img, fourcc=fourcc)
    ptp.save_dds(pp, img, fourcc=fourcc)
    assert _read(pp) == _read(jp)
    back = ptp.load_dds(_read(pp))
    np.testing.assert_array_equal(back, jtp.load_dds(_read(jp)))
    assert back.shape == (16, 32, 4)
    if fourcc is None:
        np.testing.assert_array_equal(back, img)


def test_dds_bgra_and_refusals_match_jax(tmp_path):
    """A BGRA8 file decodes swizzled in both; DX10 and a 24-bit file are
    refused by both."""
    img = _gradient_rgba(8, 8)
    p = str(tmp_path / "a.dds")
    ptp.save_dds(p, img)
    data = bytearray(_read(p))
    data[92:96] = struct.pack("<I", 0x00FF0000)          # rmask: BGRA
    np.testing.assert_array_equal(ptp.load_dds(bytes(data)),
                                  jtp.load_dds(bytes(data)))
    for patch in ((80, struct.pack("<I", 0x4)), (84, b"DX10")), \
            ((88, struct.pack("<I", 24)),):
        bad = bytearray(_read(p))
        for off, b in patch:
            bad[off:off + len(b)] = b
        for tp_ in (ptp, jtp):
            with pytest.raises(ValueError):
                tp_.load_dds(bytes(bad))


def test_dds_non_multiple_of_4_matches_jax(tmp_path):
    img = _gradient_rgba(24, 40)
    p = str(tmp_path / "full.dds")
    ptp.save_dds(p, img, fourcc="DXT5")
    data = bytearray(_read(p))
    data[12:20] = struct.pack("<II", 22, 38)
    out = ptp.load_dds(bytes(data))
    assert out.shape == (22, 38, 4)
    np.testing.assert_array_equal(out, jtp.load_dds(bytes(data)))
    np.testing.assert_array_equal(out, ptp.load_dds(_read(p))[:22, :38])


def test_hdr_roundtrip_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    img = (rng.random((16, 32, 3)) * 40.0).astype(np.float32)
    img[0, 0] = 0.0
    jp, pp = str(tmp_path / "j.hdr"), str(tmp_path / "p.hdr")
    jtp.save_hdr(jp, img)
    ptp.save_hdr(pp, img)
    assert _read(pp) == _read(jp)
    back = ptp.load_hdr(_read(pp))
    np.testing.assert_array_equal(back, jtp.load_hdr(_read(jp)))
    bound = img.max(-1, keepdims=True) / 256.0 + 1e-4
    assert np.all(np.abs(back - img) <= bound)


def test_hdr_rle_decode_matches_jax():
    w, h = 16, 2
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., 0] = 128
    rgbe[..., 3] = 129
    rgbe[1, :, 0] = np.arange(w)
    buf = b"#?RADIANCE\n\n" + f"-Y {h} +X {w}\n".encode()
    for y in range(h):
        buf += bytes([2, 2, 0, w])
        for c in range(4):
            row = rgbe[y, :, c]
            if np.all(row == row[0]):
                buf += bytes([128 + w, int(row[0])])
            else:
                buf += bytes([w]) + row.tobytes()
    out = ptp.load_hdr(buf)
    assert out.shape == (h, w, 3)
    np.testing.assert_array_equal(out, jtp.load_hdr(buf))
    expect = rgbe[..., 0].astype(np.float32) * np.ldexp(
        1.0, rgbe[..., 3].astype(np.int32) - 136)
    np.testing.assert_allclose(out[..., 0], expect, rtol=1e-6)


def test_hdr_power_of_two_exact_matches_jax(tmp_path):
    img = np.zeros((2, 4, 3), np.float32)
    img[..., 0] = [[1.0, 2.0, 0.5, 4.0], [8.0, 0.25, 1.0, 16.0]]
    p = str(tmp_path / "pow2.hdr")
    ptp.save_hdr(p, img)
    back = ptp.load_hdr(_read(p))
    np.testing.assert_array_equal(back, jtp.load_hdr(_read(p)))
    np.testing.assert_allclose(back[..., 0], img[..., 0], rtol=1e-7)


def test_decode_image_bytes_dispatch_matches_jax(tmp_path):
    from PIL import Image
    img = _gradient_rgba(16, 16)
    p = str(tmp_path / "a.dds")
    ptp.save_dds(p, img)
    p2 = str(tmp_path / "b.hdr")
    ptp.save_hdr(p2, np.ones((8, 8, 3), np.float32) * 0.25)
    png, jpg = io.BytesIO(), io.BytesIO()
    Image.fromarray(img).save(png, format="PNG")
    Image.fromarray(img[..., :3]).save(jpg, format="JPEG", quality=90)
    for data, shape in ((_read(p), (16, 16, 4)), (_read(p2), (8, 8, 4)),
                        (png.getvalue(), (16, 16, 4)),
                        (jpg.getvalue(), (16, 16, 4))):
        out = ptp.decode_image_bytes(data)
        assert out.shape == shape
        np.testing.assert_array_equal(out, jtp.decode_image_bytes(data))
    assert abs(int(ptp.decode_image_bytes(_read(p2))[0, 0, 0]) - 64) <= 2
    assert ptp.decode_image_bytes(b"not an image") is None
    assert jtp.decode_image_bytes(b"not an image") is None


@pytest.mark.parametrize("cutoff", [0.3, 0.5, 0.8])
def test_alpha_coverage_scale_matches_jax(cutoff):
    rng = np.random.default_rng(4)
    alpha = rng.random((32, 32)).astype(np.float32) ** 2
    ref = float(np.mean(rng.random((64, 64)) < 0.4))
    s = ptp.alpha_coverage_scale(alpha, cutoff, ref)
    assert s == jtp.alpha_coverage_scale(alpha, cutoff, ref)
    assert 0.25 <= s <= 8.0


def test_alpha_coverage_mips_match_jax():
    """tests/test_texprocess.py::test_alpha_coverage_mips on the port, its
    levels equal to the JAX registry's."""
    r = 64
    rng = np.random.default_rng(2)
    alpha = (rng.random((r, r)) < 0.3).astype(np.float32)
    img = np.concatenate([np.full((r, r, 3), 0.4, np.float32),
                          alpha[..., None]], -1)
    cutoff = 0.5
    regs = {}
    for name, cls in (("port", PTex), ("jax", JTex)):
        fixed, plain = cls(resolution=r), cls(resolution=r)
        fixed.add(img, srgb=False, alpha_cutoff=cutoff)
        plain.add(img, srgb=False)
        regs[name] = (fixed, plain)

    def levels(reg, n):
        out, level = [], reg.images[0]
        for _ in range(n):
            level = reg._downsample(level, level.shape[0], 0)
            out.append(level)
        return out

    for reg_p, reg_j in zip(regs["port"], regs["jax"]):
        for a, b in zip(levels(reg_p, 5), levels(reg_j, 5)):
            np.testing.assert_array_equal(a, b)
    ref = float(np.mean(alpha > cutoff))
    cov_fixed = float(np.mean(levels(regs["port"][0], 3)[-1][..., 3] > cutoff))
    cov_plain = float(np.mean(levels(regs["port"][1], 3)[-1][..., 3] > cutoff))
    assert cov_plain < ref * 0.55
    assert abs(cov_fixed - ref) < 0.12


@pytest.mark.parametrize("srgb", [True, False])
def test_process_for_registry_and_cache_hit_match_jax(tmp_path, srgb):
    from PIL import Image
    img = _gradient_rgba(64, 48)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    data = buf.getvalue()
    cache = ptp.ProcessedTextureCache(str(tmp_path / "ptc"))
    a = ptp.process_for_registry(data, srgb, 32, cache=cache)
    assert cache.misses == 1 and cache.hits == 0
    b = ptp.process_for_registry(data, srgb, 32, cache=cache)
    assert cache.hits == 1
    np.testing.assert_array_equal(a, b)
    jcache = jtp.ProcessedTextureCache(str(tmp_path / "jptc"))
    np.testing.assert_array_equal(
        a, jtp.process_for_registry(data, srgb, 32, cache=jcache))
    np.testing.assert_array_equal(
        ptp.process_for_registry(data, srgb, 32),
        jtp.process_for_registry(data, srgb, 32))
    # The JAX package reads the port's entry and the other way round.
    assert ptp.ProcessedTextureCache.key(data, srgb, 32) == \
        jtp.ProcessedTextureCache.key(data, srgb, 32)
    np.testing.assert_array_equal(
        jtp.ProcessedTextureCache(str(tmp_path / "ptc")).load(
            cache.key(data, srgb, 32)), a)


def test_processed_cache_corrupt_entry_matches_jax(tmp_path):
    img = _gradient_rgba(16, 16)
    for tp_ in (ptp, jtp):
        c = tp_.ProcessedTextureCache(str(tmp_path / tp_.__name__))
        key = c.key(b"fake-bytes", True, 16)
        stored = c.store(key, img, srgb=True)
        with open(c._path(key), "wb") as f:
            f.write(b"PK\x03\x04 truncated")
        assert c.load(key) is None and c.misses == 1
        again = c.store(key, img, srgb=True)
        assert np.array_equal(c.load(key), again)
        assert np.array_equal(again, stored)
    np.testing.assert_array_equal(
        ptp.ProcessedTextureCache(str(tmp_path / ptp.__name__)).load(key),
        jtp.ProcessedTextureCache(str(tmp_path / jtp.__name__)).load(key))


def test_registry_routes_through_the_processed_cache(tmp_path):
    """TextureRegistry(processed_cache=...) carries the cache the importer
    decodes through, as the JAX registry does."""
    cache = ptp.ProcessedTextureCache(str(tmp_path))
    reg = PTex(resolution=32, processed_cache=cache)
    assert reg.processed_cache is cache and reg.alpha_cutoffs == []
    reg.add(_gradient_rgba(32, 32), alpha_cutoff=0.25)
    assert reg.alpha_cutoffs == [0.25]
