"""ctypes bindings for the native host core (native/chaincore.cpp and
native/blsmap.cpp), the port's copy of `cess_tpu/native.py`.

The native core carries the host-side deterministic primitives (hashing,
protocol RNG, SCALE compact codec, GF(2^8) Reed-Solomon) and the BLS
hash-to-curve front end (expand_message_xmd, hash_to_field, the full
hash-to-G1) in C++, threaded with the GIL released.  Python remains the
source of truth; every binding is tested bit-identical against the
pure-Python implementation (tests/test_torch_native.py).

Only the build and load differ from the JAX package's copy: the library
is compiled at first use with the C++ compiler (`CXX`, else `g++`) and
native/Makefile's flags into the port's build directory
(`ops/_cuda.build_dir()`), under a name keyed by a hash of the sources,
flags and compiler; `load()` raises when the compiler is missing or the
build fails.  Nothing here falls back to the pure-Python paths: a caller
that must take them (an input longer than the native framing takes)
decides so before the call.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from functools import lru_cache
from pathlib import Path

import numpy as np

from .ops._cuda import build_dir

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_SOURCES = ("chaincore.cpp", "blsmap.cpp")
# native/Makefile's CXXFLAGS, without -march: the library may be built on
# one host and loaded on another that shares the build directory.
_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
          "-fvisibility=hidden", "-shared"]

# The native framing's bounds (native/blsmap.cpp): a PoDR2 name of at most
# MAX_NAME bytes, a message of at most MAX_MSG bytes, a DST of at most
# MAX_DST bytes.  Longer inputs take the pure-Python path at the caller.
MAX_NAME = 1000
MAX_MSG = 1024
MAX_DST = 255

_init_lock = threading.Lock()


def _cxx() -> str:
    cxx = os.environ.get("CXX") or "g++"
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(
            f"C++ compiler {cxx!r} not found: the native host library "
            "cannot be built"
        )
    return path


def _lib_path(cxx: str) -> Path:
    h = hashlib.sha256()
    for src in _SOURCES:
        h.update((_NATIVE_DIR / src).read_bytes())
    h.update(" ".join(_FLAGS + [cxx]).encode())
    return build_dir() / f"libcessnative-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is missing; returns its path.  Workers
    that build at once serialise on a lock file in the build directory,
    and each writes a private temporary that `os.replace` publishes."""
    cxx = _cxx()
    path = _lib_path(cxx)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.parent / "native.lock", "wb") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return path
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [cxx, *_FLAGS, "-o", str(tmp),
               *(str(_NATIVE_DIR / s) for s in _SOURCES), "-lpthread"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"native host library build failed (exit {proc.returncode}):\n"
                f"{proc.stderr[-4000:]}"
            )
        os.replace(tmp, path)
    return path


@lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The built, loaded library with every signature declared."""
    lib = ctypes.CDLL(str(build()))
    lib.cess_sha256.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
    ]
    lib.cess_blake2b.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_uint,
    ]
    lib.cess_rng_stream.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.cess_compact_encode.argtypes = [ctypes.c_uint64, ctypes.c_char_p]
    lib.cess_compact_encode.restype = ctypes.c_size_t
    lib.cess_compact_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.cess_compact_decode.restype = ctypes.c_size_t
    lib.cess_rs_encode.argtypes = [
        ctypes.c_uint, ctypes.c_uint, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.cess_rs_encode.restype = ctypes.c_int
    lib.cess_rs_reconstruct.argtypes = [
        ctypes.c_uint, ctypes.c_uint, ctypes.c_size_t, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_char_p,
    ]
    lib.cess_rs_reconstruct.restype = ctypes.c_int
    lib.cess_abi_version.restype = ctypes.c_uint
    lib.cess_blsmap_init.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_uint64,
    ]
    lib.cess_blsmap_init.restype = ctypes.c_int
    lib.cess_blsmap_hash_g1_batch.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint64,
    ]
    lib.cess_blsmap_hash_g1_batch.restype = ctypes.c_int
    lib.cess_blsmap_xmd_u_batch.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
    ]
    lib.cess_blsmap_xmd_u_batch.restype = ctypes.c_int
    lib.cess_blsmap_xmd_u_indexed.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
    ]
    lib.cess_blsmap_xmd_u_indexed.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------- wrappers


def sha256(data: bytes) -> bytes:
    out = ctypes.create_string_buffer(32)
    load().cess_sha256(data, len(data), out)
    return out.raw


def blake2b(data: bytes, digest_size: int = 32) -> bytes:
    out = ctypes.create_string_buffer(digest_size)
    load().cess_blake2b(data, len(data), out, digest_size)
    return out.raw


def rng_stream(seed: bytes, domain: int, n: int) -> bytes:
    out = ctypes.create_string_buffer(n)
    load().cess_rng_stream(seed, len(seed), domain, out, n)
    return out.raw


def compact_encode(value: int) -> bytes:
    out = ctypes.create_string_buffer(9)
    n = load().cess_compact_encode(value, out)
    return out.raw[:n]


def compact_decode(data: bytes) -> tuple[int, int]:
    """Returns (value, consumed); raises ValueError on malformed input."""
    out = ctypes.c_uint64()
    n = load().cess_compact_decode(data, len(data), ctypes.byref(out))
    if n == 0:
        raise ValueError("malformed or non-canonical compact encoding")
    return out.value, n


def _same_length(shards: list[bytes], count: int) -> int:
    if len(shards) < count or any(len(s) != len(shards[0]) for s in shards):
        raise ValueError(f"need {count} shards of one length")
    return len(shards[0])


def rs_encode(k: int, m: int, data_shards: list[bytes]) -> list[bytes]:
    if len(data_shards) != k:
        raise ValueError(f"need exactly {k} data shards")
    shard_len = _same_length(data_shards, k)
    parity = ctypes.create_string_buffer(m * shard_len)
    rc = load().cess_rs_encode(k, m, shard_len, b"".join(data_shards), parity)
    if rc != 0:
        raise ValueError("rs_encode failed")
    return [
        parity.raw[i * shard_len : (i + 1) * shard_len] for i in range(m)
    ]


def rs_reconstruct(
    k: int, m: int, shards: list[bytes], present: list[int]
) -> list[bytes]:
    shard_len = _same_length(shards[:k], k)
    if len(present) < k:
        raise ValueError(f"need {k} survivor indices")
    arr = (ctypes.c_uint32 * k)(*present[:k])
    out = ctypes.create_string_buffer(k * shard_len)
    rc = load().cess_rs_reconstruct(
        k, m, shard_len, b"".join(shards[:k]), arr, out
    )
    if rc != 0:
        raise ValueError("rs_reconstruct failed")
    return [out.raw[i * shard_len : (i + 1) * shard_len] for i in range(k)]


# ---------------------------------------------------------------- BLS hash

_BLSMAP_READY = False


def blsmap_init() -> None:
    """Feed the derived SSWU/isogeny constants (the port's
    ops/_sswu_g1.py) and the curve parameters (ops/bls12_381.py) into the
    native hash-to-curve kernel, once a process."""
    global _BLSMAP_READY
    with _init_lock:
        if _BLSMAP_READY:
            return
        from .ops import _sswu_g1, bls12_381 as bls

        def be48(x: int) -> bytes:
            return x.to_bytes(48, "big")

        def vec(coeffs: list[int]) -> bytes:
            return b"".join(be48(c) for c in coeffs)

        rc = load().cess_blsmap_init(
            be48(bls.P), be48(_sswu_g1.A_PRIME), be48(_sswu_g1.B_PRIME),
            _sswu_g1.Z_SSWU,
            vec(_sswu_g1.X_NUM), len(_sswu_g1.X_NUM),
            vec(_sswu_g1.X_DEN), len(_sswu_g1.X_DEN),
            vec(_sswu_g1.Y_NUM), len(_sswu_g1.Y_NUM),
            vec(_sswu_g1.Y_DEN), len(_sswu_g1.Y_DEN),
            bls.H_EFF_G1,
        )
        if rc != 0:
            raise RuntimeError(f"cess_blsmap_init failed: {rc}")
        _BLSMAP_READY = True


def _blob(parts: list[bytes], limit: int, what: str):
    """Concatenated parts and their (len + 1) uint64 offsets."""
    if any(len(p) > limit for p in parts):
        raise ValueError(f"{what} longer than {limit} bytes")
    offs = (ctypes.c_uint64 * (len(parts) + 1))()
    acc = 0
    for i, p in enumerate(parts):
        offs[i] = acc
        acc += len(p)
    offs[len(parts)] = acc
    return b"".join(parts), offs


def _check_dst(dst: bytes) -> None:
    if len(dst) > MAX_DST:
        raise ValueError(f"DST longer than {MAX_DST} bytes")


def hash_to_g1_batch(
    msgs: list[bytes], dst: bytes, threads: int = 8
) -> list[tuple[int, int]]:
    """Batched hash-to-G1 (affine (x, y) ints, (0, 0) for ∞),
    bit-identical to the host reference ops/bls12_381.hash_to_g1.  Runs
    the xmd/SSWU/isogeny/cofactor pipeline in native threads with the GIL
    released."""
    blsmap_init()
    _check_dst(dst)
    blob, offs = _blob(msgs, MAX_MSG, "message")
    out = ctypes.create_string_buffer(96 * len(msgs))
    rc = load().cess_blsmap_hash_g1_batch(
        blob, offs, len(msgs), dst, len(dst), out, threads
    )
    if rc != 0:
        raise RuntimeError(f"hash_g1_batch failed: {rc}")
    res = []
    for i in range(len(msgs)):
        chunk = out.raw[96 * i : 96 * (i + 1)]
        res.append(
            (int.from_bytes(chunk[:48], "big"), int.from_bytes(chunk[48:], "big"))
        )
    return res


def xmd_u_batch(msgs: list[bytes], dst: bytes, threads: int = 1):
    """expand_message_xmd + hash_to_field only — the host front half of
    the device hash-to-curve path (ops/h2c.py).  Returns
    (u: np.uint8 (N, 2, 48) canonical big-endian field elements,
     flags: np.uint8 (N,)) with flag bits
    (sgn0(u0), sswu_exceptional(u0), sgn0(u1), sswu_exceptional(u1))
    in bits 0..3 — the predicates the device map takes as inputs."""
    blsmap_init()
    _check_dst(dst)
    blob, offs = _blob(msgs, MAX_MSG, "message")
    out_u = ctypes.create_string_buffer(96 * len(msgs))
    out_f = ctypes.create_string_buffer(len(msgs))
    rc = load().cess_blsmap_xmd_u_batch(
        blob, offs, len(msgs), dst, len(dst), out_u, out_f, threads
    )
    if rc != 0:
        raise RuntimeError(f"xmd_u_batch failed: {rc}")
    u = np.frombuffer(out_u.raw, dtype=np.uint8).reshape(len(msgs), 2, 48)
    flags = np.frombuffer(out_f.raw, dtype=np.uint8)
    return u, flags


def xmd_u_indexed(names: list[bytes], name_ids, indices, dst: bytes,
                  threads: int = 1):
    """xmd_u_batch for messages of the PoDR2 chunk-point framing
    name ‖ '/' ‖ LE64(index), assembled natively: `name_ids` (uint32) and
    `indices` (uint64) are parallel arrays selecting (names[id], index)
    per output row — Python never builds the per-pair byte strings."""
    blsmap_init()
    _check_dst(dst)
    name_ids = np.ascontiguousarray(name_ids, dtype=np.uint32)
    indices = np.ascontiguousarray(indices, dtype=np.uint64)
    n = len(name_ids)
    if len(indices) != n:
        raise ValueError("name_ids and indices differ in length")
    blob, offs = _blob(names, MAX_NAME, "name")
    out_u = ctypes.create_string_buffer(96 * n)
    out_f = ctypes.create_string_buffer(max(n, 1))
    rc = load().cess_blsmap_xmd_u_indexed(
        blob, offs, len(names),
        name_ids.ctypes.data, indices.ctypes.data, n,
        dst, len(dst), out_u, out_f, threads,
    )
    if rc != 0:
        raise RuntimeError(f"xmd_u_indexed failed: {rc}")
    u = np.frombuffer(out_u.raw, dtype=np.uint8).reshape(n, 2, 48)
    flags = np.frombuffer(out_f.raw, dtype=np.uint8)[:n]
    return u, flags
