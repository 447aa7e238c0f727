"""Reed-Solomon erasure coding as a streamed torch data plane.

The port of `cess_tpu/ops/rs.py`.  Two GF(256) matrix products, both
plain torch and bit-identical to the JAX package's and to the numpy
reference in ops/gf256.py (tests/test_torch_rs.py pins every path):

1. **gather**: XOR of rows of `gf256.MUL_TABLE` indexed by the data
   bytes (`_matmul_gf_gather`).
2. **bitplane**: a GF(256) product is GF(2)-linear on the bit-planes of
   the data, so it is a 0/1 matrix product reduced mod 2
   (`_matmul_gf_bitplane`).

`cess_tpu` computes both in plain XLA, in no Pallas kernel, so both are
plain torch here.  Each bounds its temporaries by walking the byte axis
in steps of `TEMP_BYTES`.  Decode is encode with a host-computed k x k
inverse, cached per survivor mask.

`RSStream` moves GiB-scale host arrays through the card in fixed-size
pieces (byte-axis tiles for `run`, segment slabs for `run_batch`): the
host gathers piece t+1 into a reused pinned staging buffer while piece
t's host-to-device copy, product and device-to-host copy run on three
CUDA streams, and CUDA events guard every reuse of a staging buffer.

Left out against `cess_tpu`: the `mesh=` arguments (sharding is a later
slice), the XLA trace counters, the stage histograms (each stream still
fills its per-call `stages` dict), and the padding that bounded XLA
compiles (pow2 width buckets, padded tail tiles and slabs): eager torch
compiles nothing, and the bytes are the same without it.
"""

from __future__ import annotations

import os
import threading
import time as _time
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache

import numpy as np
import torch

from ..device import resolve_device
from . import gf256

# Byte-axis tile width of `RSStream.run` (CESS_RS_TILE overrides).
TILE = int(os.environ.get("CESS_RS_TILE", str(1 << 20)))
# Segments a `RSStream.run_batch` slab holds (CESS_RS_SLAB overrides):
# 32 RS(2,1) segments of 8 MiB fragments are 512 MiB of survivors.
SLAB = int(os.environ.get("CESS_RS_SLAB", "32"))
# Bytes of temporaries one step of a product may hold (the widened
# indices of the gather, the bit-planes of the bitplane product).
TEMP_BYTES = 1 << 28

# Host threads that split each piece's gather into staging and scatter
# out of it (numpy releases the interpreter lock while it copies; one
# thread copies and faults in fresh pages at a fraction of the host's
# memory bandwidth).
HOST_THREADS = max(1, min(8, os.cpu_count() or 1))

# ------------------------------------------------------- stage telemetry
#
# Always-on per-stage histograms of the streamed data plane, as
# cess_tpu/ops/rs.py keeps them (the RS counterpart of
# proof/torch_backend.py's proof_stage_registry): the registry is
# process-wide and merged into the node's `system_metrics` (node/rpc.py);
# CESS_STAGE_METRICS=0 switches the marks off, the same knob as the proof
# stages.  The stage names are RSStream's (see its docstring).

RS_STAGE_NAMES = ("pack", "matmul", "dispatch_wait", "unpack")
STAGE_METRICS_ENABLED = os.environ.get(
    "CESS_STAGE_METRICS", "1") not in ("0", "false", "off")

_rs_stage_lock = threading.Lock()
_rs_stage_registry = None
_rs_stage_hists: dict = {}
_rs_stage_counters: dict = {}

_RS_STAGE_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0)


def rs_stage_registry():
    """The process-wide metrics registry for the RS data plane (created
    on first use; node/metrics is imported lazily to keep the ops↔node
    package import graph acyclic)."""
    global _rs_stage_registry
    with _rs_stage_lock:
        if _rs_stage_registry is None:
            from ..node import metrics as m

            reg = m.Registry()
            for name in RS_STAGE_NAMES:
                _rs_stage_hists[name] = m.Histogram(
                    f"cess_rs_{name}_seconds",
                    f"RS stream {name} stage time",
                    buckets=_RS_STAGE_BUCKETS, registry=reg)
            _rs_stage_counters["bytes"] = m.Counter(
                "cess_rs_bytes_total",
                "payload bytes through streamed RS kernels", reg)
            _rs_stage_counters["streams"] = m.Counter(
                "cess_rs_streams_total",
                "RSStream passes executed", reg)
            _rs_stage_counters["seconds"] = m.Counter(
                "cess_rs_seconds_total",
                "wall-clock seconds spent in RS streams", reg)
            _rs_stage_registry = reg
    return _rs_stage_registry


def _observe_rs_stage(name: str, seconds: float) -> None:
    rs_stage_registry()
    _rs_stage_hists[name].observe(seconds)


# The product `default_path` picks on the card: the faster of the two in
# chip_smoke.py phase 5-rs on an H100 (PERF.md).
_CUDA_PATH = "gather"


# ------------------------------------------------- host and device constants


@lru_cache(maxsize=64)
def _code_matrices(k: int, m: int) -> tuple[np.ndarray, np.ndarray]:
    """Host (parity, generator) for RS(k, m)."""
    return gf256.cauchy_matrix(k, m), gf256.encode_matrix(k, m)


@lru_cache(maxsize=4096)
def _inv_cached(k: int, m: int, present: tuple[int, ...]) -> np.ndarray:
    """Host k x k recovery inverse for one survivor mask (O(k^3) over
    tiny k — cached because grouped recovery hits few distinct masks)."""
    gen = _code_matrices(k, m)[1]
    return gf256.mat_inv(gen[np.asarray(present)])


def _matrix(matrix_bytes: bytes, rows: int, cols: int) -> np.ndarray:
    return np.frombuffer(matrix_bytes, dtype=np.uint8).reshape(rows, cols)


@lru_cache(maxsize=256)
def _lut_dev(matrix_bytes: bytes, rows: int, cols: int, device) -> torch.Tensor:
    """(rows, cols, 256) uint8: entry [j, i] is the table of products by
    the matrix coefficient [j, i], the rows of MUL_TABLE the gather reads."""
    lut = gf256.MUL_TABLE[_matrix(matrix_bytes, rows, cols)]
    return torch.as_tensor(lut, device=device)


@lru_cache(maxsize=256)
def _bits_dev(matrix_bytes: bytes, rows: int, cols: int, device) -> torch.Tensor:
    """(8 rows, 8 cols) float16 0/1: the matrix's GF(2) expansion."""
    bits = gf256.bit_matrix(_matrix(matrix_bytes, rows, cols))
    return torch.as_tensor(bits, dtype=torch.float16, device=device)


@lru_cache(maxsize=64)
def _pack_weights(rows: int, device) -> torch.Tensor:
    """(rows, 8 rows) float16 with 2^t at [j, 8j + t]: the product that
    folds little-endian bit-planes back into bytes."""
    w = np.zeros((rows, 8 * rows), dtype=np.float16)
    for j in range(rows):
        w[j, 8 * j : 8 * j + 8] = 2.0 ** np.arange(8)
    return torch.as_tensor(w, device=device)


@lru_cache(maxsize=8)
def _shifts(device) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=device).view(8, 1)


# ------------------------------------------------------------ the products


def _matmul_gf_gather(lut: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """GF(256) matrix product by table lookups.

    lut: (r, k, 256) uint8 (`_lut_dev`), data: (b, k, n) uint8
    returns (b, r, n) uint8: out[:, j] = XOR_i lut[j, i][data[:, i]].

    The bytes are widened to int32 before they index: a uint8 index
    tensor is a boolean mask in torch, not a gather.
    """
    r, k, _ = lut.shape
    b, _, n = data.shape
    out = torch.empty((b, r, n), dtype=torch.uint8, device=data.device)
    step = max(1, TEMP_BYTES // ((5 + r) * b))
    for off in range(0, n, step):
        accs: list[torch.Tensor | None] = [None] * r
        for i in range(k):
            idx = data[:, i, off : off + step].to(torch.int32).reshape(-1)
            for j in range(r):
                term = torch.index_select(lut[j, i], 0, idx)
                accs[j] = term if accs[j] is None else accs[j].bitwise_xor_(term)
        c = min(step, n - off)
        for j in range(r):
            out[:, j, off : off + c] = accs[j].view(b, c)
    return out


def _matmul_gf_bitplane(bitmat: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """GF(256) matrix product as a 0/1 matrix product mod 2.

    bitmat: (8r, 8k) float16 0/1 (`_bits_dev`), data: (b, k, n) uint8
    returns (b, r, n) uint8.

    float16 is exact: the operands are 0 and 1, and every partial sum is
    an integer of at most 8k <= 2,040 (k + m <= 256 with m >= 1), below
    2,048, up to which float16 holds every integer, so no order or width
    of accumulation can round.  The repack's sums of distinct powers of
    two stay <= 255.  (int8 @ int8 returns int8 in torch, and CUDA has no
    integer matmul; float16 runs on the tensor cores.)
    """
    r8, k8 = bitmat.shape
    r, k = r8 // 8, k8 // 8
    b, _, n = data.shape
    shifts = _shifts(data.device)
    weights = _pack_weights(r, data.device)
    out = torch.empty((b, r, n), dtype=torch.uint8, device=data.device)
    step = max(1, TEMP_BYTES // ((3 * k8 + 4 * r8) * b))
    for off in range(0, n, step):
        x = data[:, :, off : off + step]
        c = x.shape[2]
        bits = ((x.unsqueeze(2) >> shifts) & 1).to(torch.float16).reshape(b, k8, c)
        acc = torch.matmul(bitmat, bits).remainder_(2)  # (b, 8r, c) parity
        out[:, :, off : off + c] = torch.matmul(weights, acc).to(torch.uint8)
    return out


def default_path(device) -> str:
    """gather on the CPU (no 8x bit-plane blow-up); on the card, the
    faster of the two as measured on an H100 (PERF.md)."""
    return "gather" if torch.device(device).type == "cpu" else _CUDA_PATH


# ------------------------------------------------------------- validation


def check_present(present, k: int, m: int) -> tuple[int, ...]:
    """Validate one survivor list and return the k-row prefix actually
    consumed.  Duplicate or out-of-range indices used to surface as a
    late 'singular GF(256) matrix' (or silently selected wrong rows);
    they are a caller bug and fail loudly up front."""
    idx = [int(i) for i in present]
    if len(idx) < k:
        raise ValueError(f"need {k} shards to recover, have {len(idx)}")
    idx = idx[:k]
    for i in idx:
        if not 0 <= i < k + m:
            raise ValueError(
                f"survivor index {i} out of range for RS({k},{m}) "
                f"(valid: 0..{k + m - 1})"
            )
    if len(set(idx)) != k:
        raise ValueError(f"duplicate survivor indices in {idx}")
    return tuple(idx)


def _is_per_segment(present) -> bool:
    """True when `present` is a per-segment list of survivor lists."""
    if isinstance(present, np.ndarray):
        return present.ndim == 2
    return bool(len(present)) and not np.isscalar(present[0]) and not isinstance(
        present[0], (int, np.integer)
    )


def _check_shards(a, min_rows: int, batched: bool) -> None:
    shape = getattr(a, "shape", None)
    want = 3 if batched else 2
    if shape is None or len(shape) != want:
        raise ValueError(
            f"shard array must be {want}-D "
            f"{'(B, rows, n)' if batched else '(rows, n)'}, got shape {shape}"
        )
    if 0 in shape:
        raise ValueError(f"empty shard array (shape {shape})")
    rows = shape[1] if batched else shape[0]
    if rows < min_rows:
        raise ValueError(f"need {min_rows} shard rows, have {rows}")


def _check_data_rows(rows: int, k: int) -> None:
    if rows != k:
        raise ValueError(f"encode stream needs exactly {k} data rows, got {rows}")


def _part(n: int, p: int) -> slice:
    """Part p of HOST_THREADS near-equal parts of range(n)."""
    return slice(n * p // HOST_THREADS, n * (p + 1) // HOST_THREADS)


def _host_u8(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.uint8).numpy()
    return np.asarray(a, dtype=np.uint8)


# ---------------------------------------------------------------- public API


class RSCode:
    """Systematic RS(k, m) over GF(2^8) with Cauchy parity rows.

    encode: (k, n) data shards -> (m, n) parity shards
    reconstruct: any k of the k+m shards -> original k data shards
    Batched variants take a leading segment axis; `present` on the batch
    form may be one shared survivor list or one list per segment
    (grouped per-pattern recovery).  Results are uint8 tensors on
    `device`; GiB-scale host arrays stream through RSStream.

    path: "bitplane" (0/1 float16 matmul), "gather" (table lookups), or
    "auto" (`default_path`).  Both paths are bit-identical.
    device: None means CUDA, and raises without a card.
    """

    def __init__(
        self, k: int, m: int, path: str = "bitplane",
        tile: int | None = None, device=None,
    ) -> None:
        self.device = resolve_device(device)
        if path == "auto":
            path = default_path(self.device)
        if path not in ("bitplane", "gather"):
            raise ValueError(f"unknown RS path {path!r}")
        if k < 1 or m < 1:
            raise ValueError(f"RS(k={k}, m={m}) needs k >= 1 and m >= 1")
        if k + m > gf256.FIELD:
            raise ValueError("k + m must be <= 256")
        self.k, self.m, self.path = k, m, path
        self.tile = int(tile) if tile else TILE
        self._parity = _code_matrices(k, m)[0]
        self._parity_op = self._mat_dev(self._parity)

    # -- products -------------------------------------------------------

    def _mat_dev(self, mat_host: np.ndarray) -> torch.Tensor:
        """Device operand of a host GF(256) matrix for this code's path
        (cached per device and matrix)."""
        raw = np.ascontiguousarray(mat_host, dtype=np.uint8)
        r, c = raw.shape
        if self.path == "bitplane":
            return _bits_dev(raw.tobytes(), r, c, self.device)
        return _lut_dev(raw.tobytes(), r, c, self.device)

    def _product(self, op: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
        """(b, k, n) uint8 on the device -> (b, rows of op, n) uint8."""
        if self.path == "bitplane":
            return _matmul_gf_bitplane(op, data)
        return _matmul_gf_gather(op, data)

    def _to_device(self, data) -> torch.Tensor:
        if isinstance(data, torch.Tensor):
            return data.to(self.device, torch.uint8)
        return torch.as_tensor(np.asarray(data, dtype=np.uint8), device=self.device)

    def _apply(self, mat_host: np.ndarray, data) -> torch.Tensor:
        x = self._to_device(data).unsqueeze(0)
        return self._product(self._mat_dev(mat_host), x)[0]

    def _apply_batch(self, mat_host: np.ndarray, data) -> torch.Tensor:
        return self._product(self._mat_dev(mat_host), self._to_device(data))

    # -- encode ---------------------------------------------------------

    def encode(self, data) -> torch.Tensor:
        """(k, n) uint8 -> (m, n) uint8 parity."""
        _check_shards(data, self.k, batched=False)
        _check_data_rows(data.shape[0], self.k)
        return self._apply(self._parity, data)

    def encode_batch(self, data) -> torch.Tensor:
        """(b, k, n) -> (b, m, n)."""
        _check_shards(data, self.k, batched=True)
        _check_data_rows(data.shape[1], self.k)
        return self._apply_batch(self._parity, data)

    # -- decode ---------------------------------------------------------

    def recovery_matrix(self, present) -> np.ndarray:
        """Host-side k x k inverse for the surviving shard set (indices
        validated; cached per distinct mask)."""
        return _inv_cached(
            self.k, self.m, check_present(present, self.k, self.m)
        ).copy()

    def reconstruct(self, shards, present) -> torch.Tensor:
        """shards (>=k, n) rows matching `present` global indices ->
        (k, n) data."""
        _check_shards(shards, self.k, batched=False)
        mask = check_present(present, self.k, self.m)
        inv = _inv_cached(self.k, self.m, mask)
        return self._apply(inv, shards[: self.k])

    def reconstruct_batch(self, shards, present):
        """(b, >=k, n) -> (b, k, n).

        `present` is either ONE survivor list shared by every segment (a
        device tensor comes back), or a per-segment list of survivor
        lists — segments are then grouped by survivor mask (one host
        inverse per distinct mask, one slab stream per group) and host
        uint8 comes back, assembled in segment order, bit-identical to
        per-item gf256.rs_decode_ref.
        """
        _check_shards(shards, self.k, batched=True)
        if _is_per_segment(present):
            return RSStream(self, present=present).run_batch(_host_u8(shards))
        mask = check_present(present, self.k, self.m)
        inv = _inv_cached(self.k, self.m, mask)
        return self._apply_batch(inv, shards[:, : self.k])


# ---------------------------------------------------------------- streams


class RSStream:
    """Streamed RS over GiB-scale host arrays with copy/compute overlap.

    On the card each piece (a byte-axis tile for `run`, a slab of
    segments for `run_batch`) goes: host gather into a pinned staging
    buffer → host-to-device copy on a copy stream → product on a compute
    stream → device-to-host copy into a pinned buffer on a third stream
    → host scatter into the result.  Two staging buffers a direction
    alternate, so the host packs piece t+1 and unpacks piece t−1 while
    piece t is copied and computed; an event on each host-to-device copy
    says when its input buffer may be refilled, one on each
    device-to-host copy when its output may be read.  The staging
    buffers belong to the stream and are reused by its later calls, so a
    stream runs one call at a time.

    `present=None` streams encode; a survivor list (or per-segment lists
    for `run_batch`) streams reconstruction.  With a `stages` dict, the
    host seconds of each stage accumulate there per call: `pack` (gather
    into staging), `matmul` (enqueue of copies and product),
    `dispatch_wait` (blocking on the card: the device time the host did
    not hide) and `unpack` (scatter out of staging).  Every mark is also
    observed into the process-wide cess_rs_* histograms, and each `run` or
    `run_batch` adds its bytes, one stream and its seconds to the cess_rs_*
    counters.  On the CPU the same loop runs without streams.
    """

    def __init__(
        self, code: RSCode, *, present=None,
        tile: int | None = None, slab: int | None = None,
        stages: dict | None = None,
    ) -> None:
        self.code = code
        self.tile = int(tile) if tile else code.tile
        self.slab = int(slab) if slab else SLAB
        self.stages = stages
        self.present = present
        if present is not None and not _is_per_segment(present):
            # validate the shared mask once, up front
            check_present(present, code.k, code.m)
        self._staging: dict[str, list[torch.Tensor]] = {}

    def _mark(self, name: str, t0: float) -> float:
        now = _time.perf_counter()
        if self.stages is not None:
            self.stages[name] = self.stages.get(name, 0.0) + (now - t0)
        if STAGE_METRICS_ENABLED:
            _observe_rs_stage(name, now - t0)
        return now

    def _account(self, nbytes: int, t_start: float) -> None:
        if STAGE_METRICS_ENABLED:
            rs_stage_registry()
            _rs_stage_counters["bytes"].inc(nbytes)
            _rs_stage_counters["streams"].inc()
            _rs_stage_counters["seconds"].inc(
                _time.perf_counter() - t_start
            )

    def _buffers(self, direction: str, nbytes: int) -> list[torch.Tensor]:
        """Two flat uint8 host buffers of at least `nbytes`, pinned when
        the code runs on the card; kept for the stream's later calls."""
        bufs = self._staging.get(direction)
        if bufs is None or bufs[0].numel() < nbytes:
            pin = self.code.device.type == "cuda"
            bufs = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
                    for _ in range(2)]
            self._staging[direction] = bufs
        return bufs

    def _pipeline(self, mat: np.ndarray, items, fill, drain) -> None:
        """mat @ x for each piece: items[t] = (b, w) is piece t's shape,
        fill(t, view, p) writes part p of its (b, k, w) input into a host
        view and drain(t, view, p) reads part p of its (b, rows of mat, w)
        output from one, the HOST_THREADS parts at once."""
        code = self.code
        k, r = code.k, mat.shape[0]
        op = code._mat_dev(mat)
        most = max(b * w for b, w in items)
        pins_in = self._buffers("in", most * k)
        pins_out = self._buffers("out", most * r)
        cuda = code.device.type == "cuda"
        if cuda:
            h2d, comp, d2h = streams = [torch.cuda.Stream(code.device) for _ in range(3)]
            comp.wait_stream(torch.cuda.current_stream(code.device))
            copied: list[torch.cuda.Event | None] = [None, None]

        with ThreadPoolExecutor(HOST_THREADS) as pool:

            def host(fn, t, view):
                for f in [pool.submit(fn, t, view, p) for p in range(HOST_THREADS)]:
                    f.result()

            def finish(t, host_out, done, t0):
                if done is not None:
                    done.synchronize()
                t0 = self._mark("dispatch_wait", t0)
                host(drain, t, host_out.numpy())
                return self._mark("unpack", t0)

            pending = None
            t0 = _time.perf_counter()
            try:
                for t, (b, w) in enumerate(items):
                    s = t % 2
                    if cuda and copied[s] is not None:
                        copied[s].synchronize()  # piece t-2 has left this buffer
                    t0 = self._mark("dispatch_wait", t0)
                    host_in = pins_in[s][: b * k * w].view(b, k, w)
                    host(fill, t, host_in.numpy())
                    t0 = self._mark("pack", t0)
                    done = None
                    if cuda:
                        host_out = pins_out[s][: b * r * w].view(b, r, w)
                        with torch.cuda.stream(h2d):
                            x = torch.empty((b, k, w), dtype=torch.uint8, device=code.device)
                            x.copy_(host_in, non_blocking=True)
                            copied[s] = h2d.record_event()
                        comp.wait_stream(h2d)
                        with torch.cuda.stream(comp):
                            x.record_stream(comp)
                            y = code._product(op, x)
                        d2h.wait_stream(comp)
                        with torch.cuda.stream(d2h):
                            y.record_stream(d2h)
                            host_out.copy_(y, non_blocking=True)
                            done = d2h.record_event()
                        del x, y
                    else:
                        host_out = code._product(op, host_in)
                    t0 = self._mark("matmul", t0)
                    if pending is not None:
                        t0 = finish(*pending, t0)
                    pending = (t, host_out, done)
                finish(*pending, t0)
            finally:
                if cuda:  # no copy may still touch the staging after a failure
                    for st in streams:
                        st.synchronize()

    def _op_matrix(self) -> np.ndarray:
        code = self.code
        if self.present is None:
            return code._parity
        return _inv_cached(
            code.k, code.m, check_present(self.present, code.k, code.m)
        )

    # -- byte-axis stream ----------------------------------------------

    def run(self, data) -> np.ndarray:
        """(rows, n) host uint8 stream -> (out_rows, n) host uint8.

        rows = k for encode; the first k survivor rows (matching
        `present`) for reconstruct.  The byte axis goes through in
        `tile`-wide pieces.
        """
        code = self.code
        t_start = _time.perf_counter()
        _check_shards(data, code.k, batched=False)
        if self.present is None:
            _check_data_rows(data.shape[0], code.k)
        data = _host_u8(data)[: code.k]
        mat = self._op_matrix()
        n = data.shape[1]
        res = np.empty((mat.shape[0], n), dtype=np.uint8)
        offs = range(0, n, self.tile)

        def cols(t, buf, p):  # part p of piece t's columns: (in piece, in array)
            cs = _part(buf.shape[2], p)
            return cs, slice(offs[t] + cs.start, offs[t] + cs.stop)

        def fill(t, buf, p):
            cs, ca = cols(t, buf, p)
            np.copyto(buf[0, :, cs], data[:, ca])

        def drain(t, buf, p):
            cs, ca = cols(t, buf, p)
            res[:, ca] = buf[0, :, cs]

        self._pipeline(mat, [(1, min(self.tile, n - o)) for o in offs], fill, drain)
        self._account(data.nbytes, t_start)
        return res

    # -- segment-axis stream -------------------------------------------

    def _patterns(self, b: int) -> list[tuple[int, ...]]:
        code = self.code
        if not _is_per_segment(self.present):
            mask = check_present(self.present, code.k, code.m)
            return [mask] * b
        pats = [
            check_present(p, code.k, code.m) for p in self.present
        ]
        if len(pats) != b:
            raise ValueError(
                f"{len(pats)} survivor lists for {b} segments"
            )
        return pats

    def _stream_slabs(self, mat: np.ndarray, batch: np.ndarray, out: np.ndarray,
                      idx: np.ndarray | None) -> None:
        """Stream one group's segments (`idx`, or every segment in order
        when None) in slabs, gathered from `batch` straight into staging
        and scattered into the same rows of `out`."""
        src = batch[:, : self.code.k]
        count = len(batch) if idx is None else len(idx)
        offs = range(0, count, self.slab)

        def rows(t, buf, p):  # part p of slab t's segments: (in slab, in batch)
            ss = _part(len(buf), p)
            o = offs[t]
            seg = slice(o + ss.start, o + ss.stop)
            return ss, (seg if idx is None else idx[seg])

        def fill(t, buf, p):
            ss, sb = rows(t, buf, p)
            if idx is None:
                np.copyto(buf[ss], src[sb])
            else:
                # mode="clip": with the default, numpy buffers `out`
                np.take(src, sb, axis=0, out=buf[ss], mode="clip")

        def drain(t, buf, p):
            ss, sb = rows(t, buf, p)
            out[sb] = buf[ss]

        n = batch.shape[2]
        self._pipeline(mat, [(min(self.slab, count - o), n) for o in offs], fill, drain)

    def run_batch(self, batch) -> np.ndarray:
        """(B, rows, n) host segments -> (B, out_rows, n) host uint8.

        Encode (`present=None`): rows = k, out_rows = m.  Reconstruct:
        per-segment survivor rows; segments sharing a survivor mask are
        grouped into one slab stream each (grouped per-pattern
        recovery), with one cached inverse per mask.
        """
        code = self.code
        t_start = _time.perf_counter()
        _check_shards(batch, code.k, batched=True)
        batch = _host_u8(batch)
        b, _, n = batch.shape
        if self.present is None:
            _check_data_rows(batch.shape[1], code.k)
            out = np.empty((b, code.m, n), dtype=np.uint8)
            self._stream_slabs(code._parity, batch, out, None)
            self._account(batch.nbytes, t_start)
            return out
        pats = self._patterns(b)
        out = np.empty((b, code.k, n), dtype=np.uint8)
        groups: dict[tuple[int, ...], list[int]] = {}
        for i, p in enumerate(pats):
            groups.setdefault(p, []).append(i)
        for mask, idx in groups.items():
            inv = _inv_cached(code.k, code.m, mask)
            rows = None if len(groups) == 1 else np.asarray(idx)
            self._stream_slabs(inv, batch, out, rows)
        self._account(batch.nbytes, t_start)
        return out


# Protocol geometry (reference: primitives/common/src/lib.rs:60-62 — 16 MiB
# segments, 8 MiB fragments, i.e. k=2 data + m=1 parity).
SEGMENT_K = 2
SEGMENT_M = 1


def segment_code(path: str = "auto", tile: int | None = None, device=None) -> RSCode:
    return RSCode(SEGMENT_K, SEGMENT_M, path=path, tile=tile, device=device)
