"""The port's native host library (cess_tpu_torch/native.py over
native/chaincore.cpp and native/blsmap.cpp) against the JAX package and the
pure-Python paths, on tests/test_native.py's shapes: the hash-to-G1 batch,
the indexed XMD batch (u bytes and predicate flags), the chunk points, the
over-long inputs that take the pure path, a failed build that raises, and
the chaincore wrappers against hashlib, the port's utils and gf256.
Tolerance: exact bytes."""

import hashlib

import numpy as np
import pytest

from cess_tpu.ops import bls12_381 as jbls
from cess_tpu.ops import h2c as jh2c
from cess_tpu.ops import podr2 as jpodr2
from cess_tpu.proof import fused as jfused
from cess_tpu_torch import native
from cess_tpu_torch.ops import bls12_381 as bls
from cess_tpu_torch.ops import gf256, h2c, podr2
from cess_tpu_torch.proof import fused
from cess_tpu_torch.utils import codec
from cess_tpu_torch.utils.rng import ProtocolRng

_RNG = np.random.default_rng(2026)
NAMES = [b"name-0", b"name-1", b"fragment-" + b"f" * 55]
# (name id, index) pairs: edge indices and random ones
NAME_IDS = np.array([0, 1, 2, 0, 1, 2, 0, 1], dtype=np.uint32)
INDICES = np.array([0, 1, 1023, 2**32, 2**64 - 1, *_RNG.integers(0, 2**40, 3)],
                   dtype=np.uint64)


def _u_equal(a, b):
    (ua, fa), (ub, fb) = a, b
    return ua.tobytes() == ub.tobytes() and fa.tobytes() == fb.tobytes()


def test_hash_to_g1_batch_matches_the_reference():
    msgs = [b"frag/%d" % i for i in range(6)] + [b"", b"\x00" * 64]
    got = native.hash_to_g1_batch(msgs, bls.DST_G1)
    for m, (x, y) in zip(msgs, got):
        want = jbls.hash_to_g1(m)
        assert (x, y) == (want.x, want.y)


def test_xmd_u_indexed_matches_both_pure_paths():
    got = native.xmd_u_indexed(NAMES, NAME_IDS, INDICES, podr2.H_DST, threads=8)
    assert got[0].shape == (len(NAME_IDS), 2, 48)
    assert _u_equal(got, jh2c._u_host_fallback(NAMES, NAME_IDS, INDICES, podr2.H_DST))
    assert _u_equal(got, h2c._u_host_fallback(NAMES, NAME_IDS, INDICES, podr2.H_DST))
    assert _u_equal(native.xmd_u_indexed(NAMES, NAME_IDS, INDICES, podr2.H_DST), got)


def test_xmd_u_batch_matches_the_indexed_framing():
    msgs = [NAMES[k] + b"/" + int(i).to_bytes(8, "little") for k, i in zip(NAME_IDS, INDICES)]
    assert _u_equal(native.xmd_u_batch(msgs, podr2.H_DST),
                    native.xmd_u_indexed(NAMES, NAME_IDS, INDICES, podr2.H_DST))


def test_verify_path_xmd_matches_the_jax_package():
    """fused._xmd_u and h2c.u_for_pairs: the port's native path against
    the JAX package's, byte for byte (empty batches included)."""
    assert _u_equal(fused._xmd_u(NAMES, NAME_IDS, INDICES),
                    jfused._xmd_u(NAMES, NAME_IDS, INDICES))
    empty = (np.zeros(0, np.uint32), np.zeros(0, np.uint64))
    assert _u_equal(fused._xmd_u(NAMES, *empty), jfused._xmd_u(NAMES, *empty))
    for a, b in zip(h2c.u_for_pairs(NAMES, NAME_IDS, INDICES, podr2.H_DST),
                    jh2c.u_for_pairs(NAMES, NAME_IDS, INDICES, podr2.H_DST)):
        np.testing.assert_array_equal(a, b)


def test_chunk_points_batch_matches_single():
    pairs = [(b"name-%d" % (i % 3), i * 7) for i in range(8)]
    batch = podr2.chunk_points_batch(pairs)
    assert batch == [podr2.chunk_point(n, i) for n, i in pairs]
    assert [(p.x, p.y) for p in batch] == [
        (q.x, q.y) for q in (jpodr2.chunk_point(n, i) for n, i in pairs)]


def test_over_long_inputs_take_the_pure_path():
    """A 1,001-byte name (over the native framing's 1,000) and a
    1,025-byte message go the pure-Python way at the call sites, with the
    same bytes as the JAX package; the bindings themselves refuse them."""
    long_names = [b"n" * 1001, b"short"]
    ids = np.array([0, 1, 0], dtype=np.uint32)
    idx = np.array([3, 4, 2**63], dtype=np.uint64)
    with pytest.raises(ValueError):
        native.xmd_u_indexed(long_names, ids, idx, podr2.H_DST)
    want = jh2c._u_host_fallback(long_names, ids, idx, podr2.H_DST)
    assert _u_equal(fused._xmd_u(long_names, ids, idx), want)
    assert _u_equal(h2c.xmd_u(long_names, ids, idx, podr2.H_DST), want)
    pairs = [(b"m" * 1016, 5), (b"x", 1)]  # 1,025 and 10 bytes framed
    with pytest.raises(ValueError):
        native.hash_to_g1_batch([pairs[0][0] + b"/" + (5).to_bytes(8, "little")], podr2.H_DST)
    assert podr2.chunk_points_batch(pairs) == [podr2.chunk_point(n, i) for n, i in pairs]


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that is not there fails the build, the load and every
    caller: nothing degrades to the pure path."""
    monkeypatch.setenv("CXX", str(tmp_path / "missing" / "g++"))
    monkeypatch.setenv("CESS_TORCH_BUILD_DIR", str(tmp_path / "build"))
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="not found"):
            native.build()
        calls = [
            lambda: native.load(),
            lambda: native.sha256(b"abc"),
            lambda: h2c.xmd_u(NAMES, NAME_IDS, INDICES, podr2.H_DST),
            lambda: fused._xmd_u(NAMES, NAME_IDS, INDICES),
            lambda: podr2.chunk_points_batch([(b"name", 1)]),
        ]
        for call in calls:
            with pytest.raises(RuntimeError, match="not found"):
                call()
        assert not (tmp_path / "build").exists() or not any((tmp_path / "build").glob("*.so"))
    finally:
        native.load.cache_clear()


def test_failed_compile_raises(monkeypatch, tmp_path):
    """A compiler that runs and fails raises with its output."""
    fake = tmp_path / "fake-gxx"
    fake.write_text("#!/bin/sh\necho 'no such luck' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setenv("CESS_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="exit 3(.|\n)*no such luck"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so*"))


# ------------------------------------------------- chaincore wrappers

_DATA = [b"", b"abc", b"x" * 1000, _RNG.bytes(12345)]


@pytest.mark.parametrize("data", _DATA, ids=["empty", "abc", "1000", "12345"])
def test_sha256_and_blake2b_match_hashlib(data):
    assert native.sha256(data) == hashlib.sha256(data).digest()
    assert native.blake2b(data) == hashlib.blake2b(data, digest_size=32).digest()
    assert native.blake2b(data, 64) == hashlib.blake2b(data).digest()


def test_block_boundaries():
    # SHA-256: 55/56/64-byte padding boundaries; BLAKE2b: 128/129.
    for n in (55, 56, 63, 64, 65, 127, 128, 129, 256):
        data = bytes(range(256))[:n]
        assert native.sha256(data) == hashlib.sha256(data).digest()
        assert native.blake2b(data) == hashlib.blake2b(data, digest_size=32).digest()


def test_rng_stream_matches_the_port_utils():
    for seed, dom, n in ((b"seed", 0, 100), (b"", 7, 33), (_RNG.bytes(32), 2**63, 200),
                         (b"q", 2**64 - 1, 1)):
        assert native.rng_stream(seed, dom, n) == ProtocolRng(seed, dom).take(n)


def test_compact_roundtrip_matches_the_port_utils():
    for v in (0, 1, 63, 64, 2**14 - 1, 2**14, 2**30 - 1, 2**30, 2**40, 2**64 - 1):
        enc = native.compact_encode(v)
        assert enc == codec.encode_compact(v)
        assert native.compact_decode(enc) == (v, len(enc))
    with pytest.raises(ValueError):  # 64 in 4-byte mode is non-canonical
        native.compact_decode(((64 << 2) | 0b10).to_bytes(4, "little"))


@pytest.mark.parametrize("k,m", [(2, 1), (12, 4)])
def test_rs_matches_gf256(k, m):
    data = _RNG.integers(0, 256, size=(k, 512), dtype=np.uint8)
    parity = native.rs_encode(k, m, [bytes(r) for r in data])
    assert parity == [bytes(r) for r in gf256.rs_encode_ref(data, k, m)]
    shards = [bytes(r) for r in data] + parity
    present = list(range(m, k + m))[-k:]
    assert native.rs_reconstruct(k, m, [shards[i] for i in present], present) == [
        bytes(r) for r in data]
