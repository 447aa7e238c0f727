"""Build, load and launch the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` for sm_90a into its own shared library
with a plain C interface and loaded with ctypes.  The build happens at
first use, all sources at once (one `nvcc` process each, started
together), into a build directory keyed by a hash of the sources and
flags; `ptxas -v` reports (registers, spills) land beside each library.
Every library takes its constants — p and the Montgomery constants,
plus the module's own curve constants — from `_consts_*` below, computed
by the port's own Python and uploaded once into __constant__ memory.

The launch functions take int32 CUDA tensors in the JAX package's limb
layout, allocate the outputs with torch, launch on the current stream
and raise if the C entry point returns a CUDA error.  Nothing is built
or loaded until a CUDA tensor reaches a kernel wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from .bls12_381 import P

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = {
    "ladder": "ladder.cu",
    "glv": "glv.cu",
    "map": "map.cu",
    "powc1": "powc1.cu",
}
_HEADERS = ("fp381.cuh",)
# ptxas at -O1: its -O3 schedule interleaves independent products for
# more registers than the GLV kernel's 12 resident warps leave it (168),
# and spilled; at -O1 it takes 146, spills nothing and runs no slower
# (PERF.md §6).
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-Xptxas", "-O1",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

MONT_R = 1 << 384
_MASK32 = (1 << 32) - 1


def build_dir() -> Path:
    env = os.environ.get("CESS_TORCH_BUILD_DIR")
    return Path(env) if env else _CSRC.parent / "_build"


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (_SOURCES[name],) + _HEADERS:
        h.update((_CSRC / f).read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> float:
    """Compile every missing library in parallel; returns wall seconds."""
    names = list(names or _SOURCES)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = out / f"{_lib_path(n).name}.tmp"
        cmd = [nvcc, *_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
               str(_CSRC / _SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT), tmp)
    errors = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        (out / f"{n}.ptxas.txt").write_bytes(log)
        if proc.returncode != 0:
            errors.append(f"{n}: nvcc exit {proc.returncode}\n"
                          f"{log.decode(errors='replace')[-4000:]}")
        else:
            os.replace(tmp, _lib_path(n))
    dt = time.perf_counter() - t0
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return dt


# ------------------------------------------------------------ constants


def _words(x: int, n: int = 12) -> list[int]:
    return [(x >> (32 * i)) & _MASK32 for i in range(n)]


def mont(x: int) -> list[int]:
    """x → its 12 Montgomery words (x·2^384 mod p)."""
    return _words(x * MONT_R % P)


def _consts_fp() -> list[int]:
    pinv = (-pow(P, -1, 1 << 32)) % (1 << 32)
    return (_words(P) + _words(MONT_R**2 % P) + _words(MONT_R**3 % P)
            + _words(MONT_R % P) + [pinv])


def _consts_powc1() -> list[int]:
    from .h2c import _C1_DIGITS

    digits = list(_C1_DIGITS) + [0] * (127 - len(_C1_DIGITS))
    return _consts_fp() + [len(_C1_DIGITS)] + digits


def _consts_glv() -> list[int]:
    from .bls12_381 import H_EFF_G1
    from .glv import beta

    bits = [int(b) for b in bin(H_EFF_G1)[2:]]
    return _consts_fp() + mont(beta()) + [len(bits)] + bits + [0] * (64 - len(bits))


def _consts_map() -> list[int]:
    from . import _sswu_g1 as s
    from .h2c import A_PRIME, B3_PRIME, B_PRIME, C2, Z_SSWU

    out = _consts_fp()
    for v in (A_PRIME, B_PRIME, B3_PRIME, Z_SSWU, C2):
        out += mont(v)
    for row in (s.X_NUM, s.X_DEN, s.Y_NUM, s.Y_DEN):
        for c in row:
            out += mont(c)
    return out


_CONSTS = {
    "ladder": _consts_fp,
    "glv": _consts_glv,
    "map": _consts_map,
    "powc1": _consts_powc1,
}

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_INT = ctypes.c_int
_SIGS = {
    "ladder": {"cess_ladder": [_VP] * 7 + [_LL, _INT, _VP]},
    "glv": {
        "cess_glv": [_VP] * 9 + [_LL, _INT, _VP],
        "cess_glv_scratch_words": [_LL],
    },
    "map": {
        "cess_map_front": [_VP] * 4 + [_LL, _VP],
        "cess_map_back": [_VP] * 7 + [_LL, _VP],
        "cess_scratch_words": [],
    },
    "powc1": {"cess_pow_c1": [_VP] * 2 + [_LL, _VP]},
}
_RESTYPES = {"cess_glv_scratch_words": ctypes.c_longlong}


def lib(name: str) -> ctypes.CDLL:
    """The loaded, constant-initialised library for kernel `name`."""
    with _lock:
        if name in _libs:
            return _libs[name]
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available")
        build()
        torch.cuda.init()
        so = ctypes.CDLL(str(_lib_path(name)))
        for fn, args in _SIGS[name].items():
            getattr(so, fn).argtypes = args
            getattr(so, fn).restype = _RESTYPES.get(fn, ctypes.c_int)
        so.cess_init.argtypes = [_VP, _INT]
        so.cess_init.restype = ctypes.c_int
        so.cess_consts_words.restype = ctypes.c_int
        words = _CONSTS[name]()
        if len(words) != so.cess_consts_words():
            raise RuntimeError(
                f"{name}: constant block is {len(words)} words, the kernel "
                f"expects {so.cess_consts_words()}"
            )
        arr = (ctypes.c_uint32 * len(words))(*words)
        rc = so.cess_init(ctypes.cast(arr, _VP), len(words))
        if rc:
            raise RuntimeError(f"{name}: constant upload failed (CUDA error {rc})")
        _libs[name] = so
        return so


def load_all() -> None:
    for name in _SOURCES:
        lib(name)


# ------------------------------------------------------------ launches


def _check(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} kernel launch failed (CUDA error {rc})")


def _in(*ts: torch.Tensor) -> list[torch.Tensor]:
    out = []
    for t in ts:
        if not t.is_cuda or t.dtype != torch.int32:
            raise TypeError("kernel inputs must be int32 CUDA tensors")
        out.append(t.contiguous())
    return out


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _new(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device=like.device)


def ladder(X, Y, Z, s, bits: int):
    X, Y, Z, s = _in(X, Y, Z, s)
    n = X.shape[1]
    o = _new((3, 33, n), X)
    rc = lib("ladder").cess_ladder(
        X.data_ptr(), Y.data_ptr(), Z.data_ptr(), s.data_ptr(),
        o[0].data_ptr(), o[1].data_ptr(), o[2].data_ptr(), n, bits, _stream(),
    )
    _check(rc, "ladder")
    return o[0], o[1], o[2]


def glv(X, Y, Z, k1, k2, clear: bool):
    """K2; the 16-entry tables of the resident lanes live in a scratch
    buffer sized by the launcher's grid."""
    X, Y, Z, k1, k2 = _in(X, Y, Z, k1, k2)
    n = X.shape[1]
    so = lib("glv")
    o = _new((3, 33, n), X)
    scratch = _new((max(so.cess_glv_scratch_words(n), 1),), X)
    rc = so.cess_glv(
        X.data_ptr(), Y.data_ptr(), Z.data_ptr(), k1.data_ptr(), k2.data_ptr(),
        o[0].data_ptr(), o[1].data_ptr(), o[2].data_ptr(), scratch.data_ptr(),
        n, int(clear), _stream(),
    )
    _check(rc, "glv")
    return o[0], o[1], o[2]


def pow_c1(t):
    (t,) = _in(t)
    n = t.shape[1]
    o = _new((33, n), t)
    rc = lib("powc1").cess_pow_c1(t.data_ptr(), o.data_ptr(), n, _stream())
    _check(rc, "powc1")
    return o


def map_pairs(u, sgn, exc, pow_fn):
    """K1 front phase, `pow_fn` (the K4 wrapper) over the 2N chain
    inputs, K1 back phase."""
    u, sgn, exc = _in(u, sgn, exc)
    n = u.shape[2]
    so = lib("map")
    powin = _new((33, 2 * n), u)
    scratch = _new((so.cess_scratch_words(), 2 * n), u)
    _check(so.cess_map_front(u.data_ptr(), exc.data_ptr(), powin.data_ptr(),
                             scratch.data_ptr(), n, _stream()), "map_front")
    powout = pow_fn(powin).contiguous()
    o = _new((3, 33, n), u)
    _check(so.cess_map_back(u.data_ptr(), sgn.data_ptr(), powout.data_ptr(),
                            scratch.data_ptr(), o[0].data_ptr(),
                            o[1].data_ptr(), o[2].data_ptr(), n, _stream()),
           "map_back")
    return o[0], o[1], o[2]
