"""The port's crate codecs (basicrenderer_tpu_torch/models/crate_codec.py)
against the JAX package's and against the plain Python LZ4 codec.

- The native LZ4 library builds into basicrenderer_tpu_torch/_build/
  (keyed by the source's hash, never into native/) and a failed g++
  raises, where the JAX package falls back to literals-only LZ4.
- On seeded random buffers (empty, one byte, text, low and high entropy,
  runs): the native block round trip equals the data, the plain decoder
  reads the native blocks and the native decoder reads the plain ones,
  and the port's native blocks equal the JAX package's byte for byte
  (its native library is required to have loaded, as the byte equality
  needs the same encoder on both sides).
- TfFastCompression framing, single- and multi-chunk, equal to the JAX
  package's.
- Usd_IntegerCompression: compress_ints / decompress_ints equal to the
  JAX package's on ints whose deltas hit every class width (the common
  value, 8/16/32-bit deltas, and 16/32/64-bit in the wide form), wrap
  around, and on empty and seeded random streams.
"""

import ctypes
import struct
import time

import numpy as np
import pytest

from basicrenderer_tpu.models import crate_codec as jcc
from basicrenderer_tpu_torch.models import crate_codec as pcc


def wait_for_jax_lz4(timeout_s: float = 120.0):
    """Load the JAX package's native LZ4 library, waiting for it to be
    whole, and return it.

    The JAX package builds native/liblz4codec.so in place with g++ at
    first use (*.so is gitignored). Under pytest-xdist several workers
    build it at once: a worker can open a half-written file (ctypes
    raises OSError) or see its g++ fail, and the package then falls back
    to literals-only LZ4, whose blocks differ from the native encoder's.
    Reset the package's handle and load again until the library loads,
    within `timeout_s`; then require a real library, so a fallback fails
    here and not as a byte mismatch."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            lib = jcc._load_native()
        except OSError:
            lib = None
        if isinstance(lib, ctypes.CDLL) or time.monotonic() > deadline:
            break
        jcc._NATIVE = None
        time.sleep(0.5)
    assert isinstance(lib, ctypes.CDLL), (
        f"the JAX package's native LZ4 library did not load within "
        f"{timeout_s} s (got {lib!r})")
    return lib


def _buffers():
    rng = np.random.default_rng(20)
    return {
        "empty": b"", "one": b"x", "text": b"hello world " * 200,
        "low_entropy": rng.integers(0, 4, 5003, np.uint8).tobytes(),
        "high_entropy": rng.integers(0, 256, 5003, np.uint8).tobytes(),
        "runs": np.repeat(rng.integers(0, 256, 300, np.uint8),
                          rng.integers(1, 400, 300)).tobytes(),
        "floats": rng.normal(size=7001).astype(np.float32).tobytes(),
    }


BUFFERS = _buffers()


def test_native_builds_into_port_build_dir():
    lib = pcc._load_native()
    assert isinstance(lib, ctypes.CDLL)
    assert pcc._NATIVE is lib
    name = lib._name.replace("\\", "/")
    assert "/basicrenderer_tpu_torch/_build/liblz4codec-" in name, name
    assert pcc._NATIVE_SRC.name == "lz4codec.cpp"


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "lz4codec.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(pcc, "_NATIVE_SRC", bad)
    monkeypatch.setattr(pcc, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(pcc, "_NATIVE", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pcc._load_native()
    assert not list((tmp_path / "_build").glob("*.so"))


@pytest.mark.parametrize("name", sorted(BUFFERS))
def test_lz4_round_trip_matches_plain_and_jax(name):
    wait_for_jax_lz4()
    data = BUFFERS[name]
    block = pcc.lz4_compress_block(data)
    assert pcc.lz4_decompress_block(block, len(data)) == data
    assert pcc._py_lz4_decompress(block, len(data)) == data
    plain = pcc._py_lz4_compress(data)
    assert plain == jcc._py_lz4_compress(data)
    assert pcc.lz4_decompress_block(plain, len(data)) == data
    assert block == jcc.lz4_compress_block(data)
    if name in ("text", "runs"):
        assert len(block) < len(data) // 4


def test_lz4_known_blocks_and_errors():
    block = bytes([0x54]) + b"abcde" + bytes([0x05, 0x00]) + bytes([0x20]) + b"!!"
    for dec in (pcc.lz4_decompress_block, pcc._py_lz4_decompress,
                jcc.lz4_decompress_block):
        assert dec(block, 64) == b"abcdeabcdeabc!!"
    lits = bytes(273)
    assert pcc.lz4_decompress_block(bytes([0xF0, 255, 3]) + lits, 300) == lits
    for bad in (bytes([0x10]), bytes([0x14]) + b"a" + bytes([9, 0, 0])):
        for dec in (pcc.lz4_decompress_block, pcc._py_lz4_decompress):
            with pytest.raises(pcc.Lz4Error):
                dec(bad, 64)


def test_tf_framing_matches_jax():
    wait_for_jax_lz4()
    data = BUFFERS["runs"]
    framed = pcc.tf_compress(data)
    assert framed[0] == 0 and framed == jcc.tf_compress(data)
    assert pcc.tf_decompress(framed, len(data)) == data
    # Two chunks, each with its int32 size prefix.
    a, b = data[:1001], data[1001:]
    ca, cb = pcc.lz4_compress_block(a), pcc.lz4_compress_block(b)
    multi = (bytes([2]) + struct.pack("<i", len(ca)) + ca
             + struct.pack("<i", len(cb)) + cb)
    assert pcc.tf_decompress(multi, len(data)) == data
    assert jcc.tf_decompress(multi, len(data)) == data
    assert pcc.tf_decompress(b"", 0) == b""


def _int_cases():
    rng = np.random.default_rng(21)
    steps = np.concatenate([np.full(50, 7), rng.integers(-100, 100, 40),
                            rng.integers(-30000, 30000, 40),
                            rng.integers(-2 ** 31, 2 ** 31 - 1, 40)])
    narrow_classes = np.cumsum(rng.permutation(steps)).astype(np.int32)
    wsteps = np.concatenate([np.full(50, 3), rng.integers(-30000, 30000, 40),
                             rng.integers(-2 ** 31, 2 ** 31 - 1, 40),
                             rng.integers(-2 ** 62, 2 ** 62, 40)])
    wide_classes = np.cumsum(rng.permutation(wsteps).astype(np.int64))
    return {
        "classes": (narrow_classes, False),
        "monotone": (np.arange(10007, dtype=np.int32), False),
        "random": (rng.integers(-2 ** 31, 2 ** 31, 777).astype(np.int32),
                   False),
        "terminators": (np.asarray([-1, -1, -1], np.int32), False),
        "empty": (np.zeros(0, np.int32), False),
        "wide_classes": (wide_classes, True),
        "wide_random": (rng.integers(-2 ** 62, 2 ** 62, 333), True),
        "wide_layout": (np.asarray([0, 100, 100 + 70000,
                                    100 + 70000 + (1 << 40)], np.int64), True),
    }


INTS = _int_cases()


@pytest.mark.parametrize("name", sorted(INTS))
def test_int_codec_matches_jax(name):
    wait_for_jax_lz4()
    vals, wide = INTS[name]
    enc = pcc.encode_ints(vals, wide)
    assert enc == jcc.encode_ints(vals, wide)
    buf = pcc.compress_ints(vals, wide)
    assert buf == jcc.compress_ints(vals, wide)
    out = pcc.decompress_ints(buf, len(vals), wide)
    np.testing.assert_array_equal(out, vals)
    np.testing.assert_array_equal(out, jcc.decompress_ints(buf, len(vals),
                                                           wide))
    assert out.dtype == (np.int64 if wide else np.int32)
    if name.endswith("classes"):
        codes = np.frombuffer(enc, np.uint8, (2 * len(vals) + 7) // 8,
                              offset=8 if wide else 4)
        seen = {int(c >> s) & 3 for c in codes for s in (0, 2, 4, 6)}
        assert seen == {0, 1, 2, 3}
