"""Chip smoke test of the PyTorch/CUDA port (cess_tpu_torch) on one GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, one line each on stdout:
  0  setup: card name and power limit, torch/CUDA versions, kernel build
  1  each hand-written kernel (K1 map, K4 pow chain, K2 GLV fold, K3
     ladder) against its plain tensor twin on the card, at the shapes and
     (for K3) the scalars the verify path gives it (`kernel_inputs`), K3
     also at prove_batch's launch, plus edge inputs and, for K2 and K3,
     the lane counts LANE_COUNTS; equal mod p per coordinate
  2  the PoDR2 verdict matrix at Podr2Params(n=8, s=4) through
     TorchBackend() against the port's CpuBackend, and prove_batch bytes
  3  protocol geometry (1024 chunks × 265 sectors, 47 challenged chunks):
     B = 3072 crafted proofs verify all True with every kernel's launch
     count read around that run; the same batch once more under
     torch.profiler for the device's busy time; a 64-proof sub-batch
     with one tampered μ isolates exactly that proof
  4  a `kernels` JSON line: launches on the B = 3072 run, time, twin
     time, bound and the check error of every kernel
  5-rs  the Reed-Solomon data plane at bench.py's `bench_rs` geometry:
     RS(2,1) segments of 8 MiB fragments, 640 of them (10 GiB of
     survivors, fewer if host memory is short) reconstructed from
     survivors [1, 2] and re-encoded by RSStream.run_batch from host
     memory, on both GF(256) products, three passes each, every output
     byte checked; pinned copy rates and the bus bound; one pass under
     torch.profiler; segments, a partial slab, per-segment masks and
     RS(12,4) against the port's gf256 reference.  The RS path has no
     hand kernel (the JAX package computes it in plain XLA), so it adds
     no `kernels` row.

The last line is {"ok": true, "device": {...}}; any failed phase exits
non-zero before it.  Imports neither jax nor cess_tpu.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA's published datasheet figures): 3.35 TB/s of
# HBM, 67 TFLOP/s float32 outside the tensor cores = 33.5 T FFMA/s.  The
# 32-bit integer multiply-add (IMAD) issues at half the FFMA rate.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 67e12 / 2 / 2
# One 12-word CIOS Montgomery product: 2·12·12 + 12 = 300 widening
# 32×32→64-bit multiply-adds.  Each costs two IMAD issues in whichever
# form ptxas picks: a low IMAD and an IMAD.HI (which issues at half the
# IMAD rate), or one IMAD.WIDE (also half rate) — tools/torch_fp_sass.py
# measures the rates on the card.  A squaring needs only 78 distinct word
# products (66 cross terms, doubled, and 12 squares) before the same
# 144 + 12 of the reduction: 234 widening multiply-adds.  The bound
# charges each product the least its kind needs, whatever the kernel
# computes it with.
IMAD_PER_FP_MUL = 600
IMAD_PER_FP_SQR = 468
# Phase 3's batch: three full 1,024-proof chunks, an odd chunk count.
BATCH = 3072
# Lane counts K2 and K3 are also held to their twins at: 1, a part of a
# K3 warp, a part of a block, the u-fold's 265, and one above 16k that is
# a multiple of no group, warp or block size.
LANE_COUNTS = (1, 5, 31, 265, 16411)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}, default=str), flush=True)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    try:
        import cess_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"cess_tpu_torch is not importable here: {e}")

    from cess_tpu_torch.ops import _cuda

    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    t0 = time.perf_counter()
    _cuda.build()
    _cuda.load_all()
    build_s = time.perf_counter() - t0
    say("0-setup", card=card, torch=torch.__version__, cuda=torch.version.cuda,
        build_seconds=round(build_s, 3),
        ptxas={n: _ptxas_summary(n) for n in _cuda._SOURCES})

    results = phase_kernels(torch, dev)
    phase_matrix(torch, dev)
    launches = phase_geometry(torch, dev, BATCH)
    rows = []
    for name in ("K1", "K4", "K2", "K3"):
        r = dict(results[name])
        r["launches"] = launches[name]
        rows.append(r)
    missing = [r["name"] for r in rows if r["launches"] == 0]
    if missing:
        fail(f"main path launched no {missing}")
    print(json.dumps({"kernels": rows}), flush=True)
    phase_rs(torch, dev, card)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


def _ptxas_summary(name: str) -> list[str]:
    from cess_tpu_torch.ops import _cuda

    path = _cuda.build_dir() / f"{name}.ptxas.txt"
    if not path.exists():
        return ["(cached build)"]
    lines = path.read_text(errors="replace").splitlines()
    # "N bytes stack frame, N bytes spill stores, …" and "Used N registers"
    return [ln.strip() for ln in lines if "registers" in ln or "spill" in ln]


# ------------------------------------------------------------ phase 1


def _time_ms(torch, fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()  # warm
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _compare(torch, got, want) -> int:
    """max |canonical limb difference| over the coordinates (0 = equal
    mod p coordinate by coordinate)."""
    from cess_tpu_torch.ops.h2c import _canon_mod_p

    err = 0
    for a, b in zip(got, want):
        d = (_canon_mod_p(a) - _canon_mod_p(b)).abs().max().item()
        err = max(err, int(d))
    return err


def _rand_fp(torch, rng, n: int, dev, loose: bool = False):
    """(33, n) random field elements: canonical (< 2^377 < p, as the
    host's u values), or, with `loose`, any limbs in [0, 4096] with a top
    limb of 0 or 1 — inside the loose bound the verify path's point sums
    carry into the kernels."""
    from cess_tpu_torch.ops.g1 import L

    if loose:
        x = torch.as_tensor(rng.integers(0, 4097, size=(L, n), dtype="int32"), device=dev)
        x[L - 1] = torch.as_tensor(rng.integers(0, 2, size=n, dtype="int32"), device=dev)
        return x
    x = torch.as_tensor(rng.integers(0, 4096, size=(L, n), dtype="int32"), device=dev)
    x[L - 1] = 0
    x[L - 2] &= 0x1F
    return x


def _points_to_dev(torch, pts, dev):
    from cess_tpu_torch.proof.fused import pack_points_limbs

    return tuple(torch.as_tensor(a, device=dev) for a in pack_points_limbs(pts))


def _edge_points():
    from cess_tpu_torch.ops import bls12_381 as bls

    rnd = random.Random(7)
    sub = [bls.G1_GENERATOR.mul(rnd.getrandbits(200)) for _ in range(6)]
    nonsub = [bls.map_to_curve_g1(rnd.getrandbits(300) % bls.P) for _ in range(6)]
    return sub, nonsub, bls.G1Point.infinity()


def _row(name, src, replaces, ms, plain_ms, muls, nbytes, err):
    """muls: (Fp products, of which squarings) counted by the twin."""
    n_mul, n_sqr = muls
    ops_ms = _ops_ms(muls)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None, "fp_muls": n_mul, "fp_squarings": n_sqr,
    }


def _twin(torch, fn):
    """Run a twin on the card once: (outputs, ms, (Fp products, of which
    squarings) counted)."""
    from cess_tpu_torch.ops import g1

    torch.cuda.synchronize()
    c0, q0 = g1.MUL_COUNT[0], g1.SQR_COUNT[0]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), (g1.MUL_COUNT[0] - c0, g1.SQR_COUNT[0] - q0)


def kernel_inputs(torch, dev) -> dict:
    """The inputs phase 1 holds each kernel to its twin on and times it
    on, from one seeded generator (tools/torch_kernel_times.py times the
    same ones):
      K1        u of one verify chunk's 48,128 pairs, the edge values first,
                with their exact sign and exceptional-case bits
      K4        the map's 2N chain inputs, loose limbs, edge values first
      K2        48,128 loose points (edge points first) and GLV halves
                (0, 1, r − 1 first)
      K3        the chunk's one launch, as fused.py builds it: points ×
                [ρ ‖ ρ ‖ r] over 3 × 1024 lanes at 255 bits, ρ < 2^128
      K3_prove  prove_batch's launch: 1,024 groups of 64 lanes, 47 points
                with 160-bit coefficients and 17 (∞, 0) pads, bits = 160
    """
    import numpy as np

    from cess_tpu_torch.ops import bls12_381 as bls
    from cess_tpu_torch.ops import g1, glv, h2c

    rng = np.random.default_rng(2024)
    P = bls.P
    n_pairs = 1024 * 47  # one verify chunk: 1024 proofs × 47 pairs
    inp = {}

    neg_inv_z = -pow(h2c.Z_SSWU, P - 2, P) % P
    edges = [0, 1, P - 1, 2, P - 2, 5, 7, 11]
    r = bls.fp_sqrt(neg_inv_z)
    if r is not None:
        edges += [r, P - r]
    u = _rand_fp(torch, rng, 2 * n_pairs, dev).reshape(g1.L, 2, n_pairs)
    for k, v in enumerate(edges):
        u[:, k % 2, k // 2] = torch.as_tensor(g1.fp_to_limbs(v), device=dev)
    # exact predicate bits (random lanes: exc = 0 with overwhelming
    # probability; sgn is the parity of the canonical value)
    sgn = (u.reshape(g1.L, -1)[0] & 1).reshape(2, n_pairs).contiguous()
    exc = torch.zeros((2, n_pairs), dtype=torch.int32, device=dev)
    host = u[:, :, : (len(edges) + 1) // 2].cpu().numpy()
    for j in range(host.shape[2]):
        for e in range(2):
            val = g1.limbs_to_fp(host[:, e, j])
            exc[e, j] = int(val == 0 or val * val % P == neg_inv_z)
    inp["K1"] = (u, sgn, exc)

    t = _rand_fp(torch, rng, 2 * n_pairs, dev, loose=True)
    t[:, :4] = torch.as_tensor(np.stack([g1.fp_to_limbs(v) for v in (0, 1, P - 1, 2)], 1), device=dev)
    inp["K4"] = t

    sub, nonsub, inf = _edge_points()
    eX, eY, eZ = _points_to_dev(torch, sub + nonsub + [inf], dev)
    ne = eX.shape[1]
    X, Y, Z = (_rand_fp(torch, rng, n_pairs, dev, loose=True) for _ in range(3))
    X[:, :ne], Y[:, :ne], Z[:, :ne] = eX, eY, eZ
    k1 = torch.as_tensor(rng.integers(0, 4096, size=(glv.K_LIMBS, n_pairs), dtype="int32"), device=dev)
    k2 = k1.flip(1).contiguous()
    k1[glv.K_LIMBS - 1] = 0
    k2[glv.K_LIMBS - 1] = 0
    d1, d2 = glv.decompose_to_limbs([0, 1, bls.R - 1])
    k1[:, :3] = torch.as_tensor(d1, device=dev)
    k2[:, :3] = torch.as_tensor(d2, device=dev)
    inp["K2"] = (X, Y, Z, k1, k2)

    n3 = 3 * 1024
    X, Y, Z = (_rand_fp(torch, rng, n3, dev, loose=True) for _ in range(3))
    X[:, :ne], Y[:, :ne], Z[:, :ne] = eX, eY, eZ
    rho = torch.as_tensor(g1.scalars_to_limbs(
        [int.from_bytes(rng.bytes(16), "little") for _ in range(1024)]).T.copy(), device=dev)
    inp["K3"] = ((X, Y, Z), torch.cat([rho, rho, glv.r_scalars(1024, dev)], dim=1))

    groups, width, live, bits = 1024, 64, 47, 160
    n = groups * width
    X, Y, Z = (_rand_fp(torch, rng, n, dev, loose=True) for _ in range(3))
    s = torch.as_tensor(rng.integers(0, 4096, size=(g1.R_LIMBS, n), dtype="int32"), device=dev)
    s[bits // 12] &= (1 << (bits % 12)) - 1
    s[bits // 12 + 1 :] = 0
    pad = (torch.arange(n, device=dev) % width) >= live
    for a, v in ((X, 0), (Y, 1), (Z, 0)):
        a[:, pad] = torch.as_tensor(g1.fp_to_limbs(v), device=dev)[:, None]
    s[:, pad] = 0
    inp["K3_prove"] = ((X, Y, Z), s, bits)
    inp["edges"] = ((eX, eY, eZ), len(sub), len(nonsub))
    return inp


def kernel_calls(inp: dict) -> dict:
    """name → a no-argument call that launches that kernel once on its
    main-path inputs."""
    from cess_tpu_torch.ops import g1, glv, h2c

    pts3, s3 = inp["K3"]
    ptsp, sp, bp = inp["K3_prove"]
    return {
        "K1": lambda: h2c._map_pairs_kernel(*inp["K1"]),
        "K4": lambda: h2c._pow_c1(inp["K4"]),
        "K2": lambda: glv.glv_fold(*inp["K2"], clear=True),
        "K3": lambda: g1.scalar_mul_ladder(pts3, s3, bits=255),
        "K3_prove": lambda: g1.scalar_mul_ladder(ptsp, sp, bits=bp),
    }


def _ops_ms(muls) -> float:
    n_mul, n_sqr = muls
    return ((n_mul - n_sqr) * IMAD_PER_FP_MUL + n_sqr * IMAD_PER_FP_SQR) / IMAD_PER_S * 1e3


def phase_kernels(torch, dev) -> dict:
    import numpy as np

    from cess_tpu_torch.ops import bls12_381 as bls
    from cess_tpu_torch.ops import g1, glv, h2c

    rng = np.random.default_rng(2025)
    inp = kernel_inputs(torch, dev)
    calls = kernel_calls(inp)
    res = {}

    # ---- K1 map (with K4 inside) on the chunk's pair count, edge u first
    u, sgn, exc = inp["K1"]
    n_pairs = u.shape[2]
    got = calls["K1"]()
    want, plain_ms, muls = _twin(torch, lambda: h2c._map_pairs_core(u, sgn, exc))
    err = _compare(torch, got, want)
    ms = _time_ms(torch, calls["K1"], 3)
    res["K1"] = _row("K1 map (SSWU pair map + E' add + isogeny, incl. its K4 launch)",
                     "cess_tpu_torch/csrc/map.cu", "cess_tpu/ops/h2c.py:542",
                     ms, plain_ms, muls, (33 * 2 + 4 + 99) * 4 * n_pairs, err)
    say("1-K1", lanes=n_pairs, max_abs_err=err, ms=ms, plain_ms=plain_ms)
    if err:
        fail("K1 map kernel disagrees with its twin")

    # ---- K4 pow chain on the map's 2N chain inputs
    t = inp["K4"]
    got = calls["K4"]()
    want, plain_ms, muls = _twin(torch, lambda: h2c._pow_c1_plain(t))
    err = _compare(torch, [got], [want])
    ms = _time_ms(torch, calls["K4"], 3)
    res["K4"] = _row("K4 pow chain t^((p-3)/4)", "cess_tpu_torch/csrc/powc1.cu",
                     "cess_tpu/ops/h2c.py:263", ms, plain_ms, muls,
                     2 * 33 * 4 * 2 * n_pairs, err)
    say("1-K4", lanes=2 * n_pairs, max_abs_err=err, ms=ms, plain_ms=plain_ms)
    if err:
        fail("K4 pow kernel disagrees with its twin")

    # ---- K2 GLV fold: clear=True on the chunk's lanes, clear=False on 265
    X, Y, Z, k1, k2 = inp["K2"]
    got = calls["K2"]()
    want, plain_ms, muls = _twin(torch, lambda: glv._glv_core(X, Y, Z, k1, k2, True))
    err = _compare(torch, got, want)
    ms = _time_ms(torch, calls["K2"], 5)
    n_u = 265
    got2 = glv.glv_fold(X[:, :n_u], Y[:, :n_u], Z[:, :n_u], k1[:, :n_u], k2[:, :n_u], clear=False)
    want2, _, _ = _twin(torch, lambda: glv._glv_core(
        X[:, :n_u], Y[:, :n_u], Z[:, :n_u], k1[:, :n_u], k2[:, :n_u], False))
    err2 = _compare(torch, got2, want2)
    # lane counts off every block and grid size (the persistent grid's
    # stride loop, a partial last block)
    lane_errs = {}
    for m in LANE_COUNTS:
        sl = [t[:, :m] for t in (X, Y, Z, k1, k2)]
        lane_errs[m] = _compare(torch, glv.glv_fold(*sl, clear=True),
                                glv._glv_core(*sl, True))
    res["K2"] = _row("K2 GLV fold (clear=True, chunk lanes)", "cess_tpu_torch/csrc/glv.cu",
                     "cess_tpu/ops/glv.py:237", ms, plain_ms, muls,
                     (3 * 33 + 2 * 12 + 3 * 33) * 4 * n_pairs,
                     max([err, err2] + list(lane_errs.values())))
    say("1-K2", lanes=n_pairs, max_abs_err=err, clear_false_lanes=n_u,
        clear_false_err=err2, lane_count_errs=lane_errs, ms=ms, plain_ms=plain_ms)
    if err or err2 or any(lane_errs.values()):
        fail("K2 GLV kernel disagrees with its twin")

    # ---- K3 ladder on the verify chunk's one launch; then prove_batch's
    # launch, random 255-bit scalars, bits 128 and 224, other lane counts
    # (both thread mappings), and the r-chain mask
    (X, Y, Z), scal = inp["K3"]
    n3 = X.shape[1]
    got = calls["K3"]()
    want, plain_ms, _ = _twin(torch, lambda: g1.batch_scalar_mul((X, Y, Z), scal, 255))
    err = _compare(torch, got, want)
    ms = _time_ms(torch, calls["K3"], 10)
    work = g1.ladder_work(scal, 255)
    errs = {}
    ptsp, sp, bp = inp["K3_prove"]
    errs["prove"] = _compare(torch, calls["K3_prove"](), g1.batch_scalar_mul(ptsp, sp, bp))
    prove_ms = _time_ms(torch, calls["K3_prove"], 5)
    prove_work = g1.ladder_work(sp, bp)
    s = torch.as_tensor(rng.integers(0, 4096, size=(g1.R_LIMBS, n3), dtype="int32"), device=dev)
    s[g1.R_LIMBS - 1] &= 0x7  # < 2^255
    s[:, :3] = torch.as_tensor(g1.scalars_to_limbs([0, 1, bls.R - 1]).T.copy(), device=dev)
    errs["random255"] = _compare(torch, g1.scalar_mul_ladder((X, Y, Z), s, bits=255),
                                 g1.batch_scalar_mul((X, Y, Z), s, 255))
    for bits in (128, 224):
        sb = s[:, :1024].clone()
        sb[bits // 12] &= (1 << (bits % 12)) - 1
        sb[bits // 12 + 1 :] = 0
        pts = (X[:, :1024], Y[:, :1024], Z[:, :1024])
        errs[f"bits{bits}"] = _compare(torch, g1.scalar_mul_ladder(pts, sb, bits=bits),
                                       g1.batch_scalar_mul(pts, sb, bits))
    big = max(LANE_COUNTS)
    bX, bY, bZ = (_rand_fp(torch, rng, big, dev, loose=True) for _ in range(3))
    bs = torch.as_tensor(rng.integers(0, 4096, size=(g1.R_LIMBS, big), dtype="int32"), device=dev)
    bs[g1.R_LIMBS - 1] &= 0x7
    for m in LANE_COUNTS:
        pts = (bX[:, :m], bY[:, :m], bZ[:, :m])
        errs[f"lanes{m}"] = _compare(torch, g1.scalar_mul_ladder(pts, bs[:, :m], bits=255),
                                     g1.batch_scalar_mul(pts, bs[:, :m], 255))
    (eX, eY, eZ), n_sub, n_nonsub = inp["edges"]
    mask = glv.subgroup_mask(eX, eY, eZ).tolist()
    want_mask = [1] * n_sub + [0] * n_nonsub + [1]
    res["K3"] = _row("K3 double-and-add ladder (3072 lanes: rho < 2^128, r)",
                     "cess_tpu_torch/csrc/ladder.cu", "cess_tpu/ops/g1.py:476",
                     ms, plain_ms, work, (3 * 33 + 22 + 3 * 33) * 4 * n3,
                     max([err] + list(errs.values())))
    say("1-K3", lanes=n3, max_abs_err=err, check_errs=errs, subgroup_mask=mask,
        ms=ms, plain_ms=plain_ms, fp_products_needed=work[0], squarings_needed=work[1],
        prove_lanes=sp.shape[1], prove_bits=bp, prove_ms=prove_ms,
        prove_bound_ms=_ops_ms(prove_work), prove_fp_products_needed=prove_work[0])
    if err or any(errs.values()):
        fail("K3 ladder kernel disagrees with its twin")
    if mask != want_mask:
        fail(f"subgroup mask {mask} != {want_mask}")
    return res


# ------------------------------------------------------------ phase 2


def phase_matrix(torch, dev) -> None:
    from cess_tpu_torch.ops import bls12_381 as bls
    from cess_tpu_torch.ops import podr2
    from cess_tpu_torch.ops.bls12_381 import R
    from cess_tpu_torch.ops.podr2 import Challenge, Podr2Params, keygen, tag_fragment
    from cess_tpu_torch.proof import CpuBackend, TorchBackend, fused
    from cess_tpu_torch.proof.backend import ProveRequest

    t_start = time.perf_counter()
    params = Podr2Params(n=8, s=4)
    sk, pk = keygen(b"fused-tee")

    def challenge(indices, seed=b"f"):
        return Challenge(tuple(indices), tuple(
            (seed + i.to_bytes(2, "little")).ljust(20, b"\x5a") for i in indices))

    ch = challenge([0, 2, 5])
    names, datas, tags = [], [], []
    for k in range(3):
        names.append(f"fused-frag-{k}".encode())
        datas.append(bytes([(k * 31 + i) % 256 for i in range(params.fragment_bytes)]))
        tags.append(tag_fragment(sk, names[-1], datas[-1], params))
    req = ProveRequest(names, tags, datas, ch, params)
    gpu = TorchBackend()
    cpu = CpuBackend()
    proofs = gpu.prove_batch(req)
    if [p.encode() for p in proofs] != [p.encode() for p in cpu.prove_batch(req)]:
        fail("prove_batch proofs differ from CpuBackend's")
    honest = [(n, ch, p) for n, p in zip(names, proofs)]

    def with_proof(i, proof):
        out = list(honest)
        out[i] = (honest[i][0], ch, proof)
        return out

    p1 = honest[1][2]
    bad_mu = podr2.Podr2Proof(p1.sigma, [(p1.mu[0] + 1) % R] + p1.mu[1:])
    rnd = random.Random(11)
    q = bls.map_to_curve_g1(rnd.getrandbits(300) % bls.P)
    raw = bytearray(q.x.to_bytes(48, "big"))
    raw[0] |= 0x80
    if q.y > bls.P - q.y:
        raw[0] |= 0x20
    ch_a = challenge([0, 3])
    ch_b = Challenge((1, 4, 6), (b"r1".ljust(20, b"\x01"), b"r2".ljust(20, b"\x02")))
    ragged = []
    for k, c in ((0, ch_a), (1, ch_b)):
        nm = f"ragged-{k}".encode()
        data = bytes([(k * 7 + i) % 256 for i in range(params.fragment_bytes)])
        ragged.append((nm, c, podr2.prove(tag_fragment(sk, nm, data, params), data, c, params)))
    cases = {
        "honest": (honest, b"round"),
        "bad_mu": (with_proof(1, bad_mu), b"round"),
        "bad_sigma_encoding": (with_proof(0, podr2.Podr2Proof(b"\x00" * 48, list(honest[0][2].mu))), b"round"),
        "non_subgroup_sigma": (with_proof(2, podr2.Podr2Proof(bytes(raw), list(honest[2][2].mu))), b"round"),
        "mu_out_of_range": (with_proof(0, podr2.Podr2Proof(honest[0][2].sigma, [R] + honest[0][2].mu[1:])), b"round"),
        "ragged": (ragged, b"rag"),
        "single": (honest[:1], b"one"),
    }
    verdicts = {}
    for name, (items, seed) in cases.items():
        g = gpu.verify_batch(pk, items, seed, params)
        c = cpu.verify_batch(pk, items, seed, params)
        if g != c:
            fail(f"verdict matrix case {name}: torch {g} != cpu {c}")
        verdicts[name] = g
    # three chunks (CHUNK shrunk to 1): the odd chunk-count accumulation
    saved = fused.CHUNK
    fused.CHUNK = 1
    try:
        g3 = gpu.verify_batch(pk, honest, b"r3", params)
    finally:
        fused.CHUNK = saved
    if g3 != [True] * 3:
        fail(f"3-chunk batch {g3}")
    say("2-matrix", verdicts=verdicts, three_chunks=g3, prove_bytes_equal=True,
        seconds=round(time.perf_counter() - t_start, 3))


# ------------------------------------------------------------ phase 3


def _device_rows(torch, fn):
    """fn() under torch.profiler → (its result, [(device entry, ms)],
    wall ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side entries only: a CPU op's entry repeats its kernels' time
    rows = [(e.key.split("(")[0], e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return out, rows, wall_ms


def _device_busy(torch, fn):
    """fn() under torch.profiler → (its result, device busy ms, wall ms,
    the largest device entries).  Busy is None where the trace holds no
    device time (the profiler could not reach the card)."""
    out, rows, wall_ms = _device_rows(torch, fn)
    busy = sum(ms for _, ms in rows)
    top = {k: round(ms, 3) for k, ms in sorted(rows, key=lambda r: -r[1])[:8]}
    return out, (busy or None), wall_ms, top


def phase_geometry(torch, dev, batch: int) -> dict:
    from cess_tpu_torch.ops import g1, glv, h2c, podr2
    from cess_tpu_torch.ops.bls12_381 import R
    from cess_tpu_torch.ops.podr2 import Challenge, Podr2Params
    from cess_tpu_torch.proof import TorchBackend, fused

    params = Podr2Params()  # protocol geometry: 1024 chunks × 265 sectors
    sk, pk = podr2.keygen(b"bench-tee")
    rnd = random.Random(0xBE7C)
    indices = tuple(sorted(rnd.sample(range(params.n), 47)))
    ch = Challenge(indices, tuple(rnd.randbytes(20) for _ in indices))
    coeffs = ch.coefficients()
    names = [b"bench-frag-%08d" % i for i in range(batch)]
    t0 = time.perf_counter()
    sigmas = fused.craft_sigmas(names, ch, [sk * v % R for v in coeffs], device="cuda")
    craft_s = time.perf_counter() - t0
    items = [(nm, ch, podr2.Podr2Proof(s.to_bytes(), [0] * params.s))
             for nm, s in zip(names, sigmas)]
    podr2.u_generators(params.s)  # host-side generator hashing, cached

    backend = TorchBackend()
    counters = {"K1": h2c._map_pairs_kernel, "K4": h2c._pow_c1,
                "K2": glv.glv_fold, "K3": g1.scalar_mul_ladder}
    for f in counters.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    verdicts = backend.verify_batch(pk, items, b"bench-seed", params)
    torch.cuda.synchronize()
    verify_s = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    if verdicts != [True] * batch:
        fail(f"protocol batch: {verdicts.count(False)} of {batch} proofs rejected")
    say("3-geometry", batch=batch, chunks=-(-batch // fused.CHUNK),
        verify_seconds=round(verify_s, 3), proofs_per_s=round(batch / verify_s, 3),
        craft_seconds=round(craft_s, 3),
        stage_seconds={k: round(v, 3) for k, v in backend.stage_seconds.items()},
        launches=launches, all_true=True)

    verdicts, busy_ms, wall_ms, top = _device_busy(torch, lambda: backend.verify_batch(
        pk, items, b"bench-seed", params))
    if verdicts != [True] * batch:
        fail("protocol batch under the profiler: not all True")
    say("3-trace", batch=batch, wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_idle_share=None if busy_ms is None else 1 - busy_ms / wall_ms,
        top_device_ms=top)

    sub = list(items[:64])
    nm, c, p = sub[17]
    sub[17] = (nm, c, podr2.Podr2Proof(p.sigma, [1] + p.mu[1:]))
    t0 = time.perf_counter()
    v = backend.verify_batch(pk, sub, b"bench-seed-2", params)
    want = [True] * 64
    want[17] = False
    if v != want:
        fail(f"tampered sub-batch verdicts {v}")
    say("3-tampered", batch=64, false_at=[i for i, x in enumerate(v) if not x],
        seconds=round(time.perf_counter() - t0, 3))
    return launches


# ------------------------------------------------------------ phase 5-rs

# bench.py's bench_rs: RS(2,1) with 8 MiB fragments, 640 segments = 10 GiB
# of survivors streamed from host memory, recovered from [1, 2].
RS_FRAG = 8 << 20
RS_SEGMENTS = 640
RS_PRESENT = [1, 2]
RS_PASSES = 3
RS_PATHS = ("gather", "bitplane")


def _host_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    fail("no MemAvailable in /proc/meminfo")


def _first_mismatch(a, b, step: int):
    """Index of the first segment where a and b differ, or None (compared
    a slab at a time: no array-sized temporary)."""
    import numpy as np

    for o in range(0, len(a), step):
        if not np.array_equal(a[o : o + step], b[o : o + step]):
            return o + next(i for i in range(step) if not np.array_equal(a[o + i], b[o + i]))
    return None


def _copy_rates(torch, dev, nbytes: int, card: str) -> dict:
    """Pinned host ↔ card copy rates on one slab's bytes, GB/s: each
    direction alone (CUDA events, mean of 3), then both at once on two
    streams (host clock around 3 rounds)."""
    pin = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=True) for _ in range(2)]
    d = [torch.empty(nbytes, dtype=torch.uint8, device=dev) for _ in range(2)]
    h2d_ms = _time_ms(torch, lambda: d[0].copy_(pin[0], non_blocking=True), 3)
    d2h_ms = _time_ms(torch, lambda: pin[1].copy_(d[1], non_blocking=True), 3)
    sa, sb = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        with torch.cuda.stream(sa):
            d[0].copy_(pin[0], non_blocking=True)
        with torch.cuda.stream(sb):
            pin[1].copy_(d[1], non_blocking=True)
    torch.cuda.synchronize()
    both_ms = (time.perf_counter() - t0) / 3 * 1e3
    rates = {"slab_bytes": nbytes, "h2d_GBps": nbytes / h2d_ms / 1e6,
             "d2h_GBps": nbytes / d2h_ms / 1e6,
             "both_at_once_GBps": 2 * nbytes / both_ms / 1e6}
    say("5-rs-bus", card=card, **rates)
    return rates


def _host_rates(nbytes: int, card: str) -> dict:
    """Host memory rates with RSStream's copy threads, GB/s: a copy into
    pages touched before, and the same copy into a fresh array, whose
    pages fault in as it is written (as a stream's result does)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from cess_tpu_torch.ops import rs

    src = np.full(nbytes, 7, dtype=np.uint8)

    def copy_into(dst) -> float:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(rs.HOST_THREADS) as pool:
            parts = [rs._part(nbytes, p) for p in range(rs.HOST_THREADS)]
            list(pool.map(lambda sl: np.copyto(dst[sl], src[sl]), parts))
        return nbytes / (time.perf_counter() - t0) / 1e9

    dst = np.empty(nbytes, dtype=np.uint8)
    fresh = copy_into(dst)
    rates = {"host_copy_GBps": copy_into(dst), "host_copy_fresh_pages_GBps": fresh}
    try:
        with open("/sys/kernel/mm/transparent_hugepage/enabled") as f:
            thp = f.read().strip()
    except OSError:
        thp = None
    say("5-rs-host", card=card, bytes=nbytes, threads=rs.HOST_THREADS,
        transparent_hugepages=thp, **rates)
    return rates


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def phase_rs(torch, dev, card: str) -> None:
    import numpy as np

    from cess_tpu_torch.ops import gf256, rs

    t_start = time.perf_counter()
    slab = rs.SLAB
    seg = 2 * RS_FRAG
    # survivors in, recovered data out and the re-encoded parity out
    # (2 + 2 + 1 fragments a segment); four pinned staging slabs a stream
    # pair; a fifth of what is free left over
    avail = _host_available_bytes()
    fit = int((avail * 0.8 - 8 * slab * seg) // (5 * RS_FRAG)) // slab * slab
    segs = min(RS_SEGMENTS, fit)
    if segs < slab:
        fail(f"host memory too small for one RS slab ({avail} bytes free)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    survivors = np.empty((segs, 2, RS_FRAG), dtype=np.uint8)
    for o in range(0, segs, slab):
        part = torch.randint(0, 256, (min(slab, segs - o), 2, RS_FRAG),
                             dtype=torch.uint8, device=dev, generator=gen)
        torch.from_numpy(survivors[o : o + len(part)]).copy_(part)
    gib_in = survivors.nbytes / (1 << 30)
    say("5-rs-setup", card=card, segments=segs, cut_from=RS_SEGMENTS if segs < RS_SEGMENTS else None,
        host_available_bytes=avail, survivor_gib=gib_in, slab=slab,
        host_threads=rs.HOST_THREADS, data_seconds=time.perf_counter() - t_start)

    rates = _copy_rates(torch, dev, slab * seg, card)
    _host_rates(2 * slab * seg, card)
    nbytes_in, nbytes_out = survivors.nbytes, survivors.nbytes
    bound_s = nbytes_in / (rates["h2d_GBps"] * 1e9) + nbytes_out / (rates["d2h_GBps"] * 1e9)
    bound_both_s = (nbytes_in + nbytes_out) / (rates["both_at_once_GBps"] * 1e9)

    # ---- both products, three passes each, every output byte checked:
    # recovered row 1 is survivor row 0; the parity of the recovered data
    # is survivor row 1 (so recovered row 0 is right too)
    # one slab's product on the card, against its HBM bound (read the
    # slab once, write it once)
    x = torch.from_numpy(survivors[:slab]).to(dev)
    slab_bound_ms = 2 * x.numel() / HBM_BYTES_PER_S * 1e3
    inv = rs._inv_cached(2, 1, tuple(RS_PRESENT))
    paths = {}
    for path in RS_PATHS:
        code = rs.segment_code(path=path)
        op = code._mat_dev(inv)
        paths[path] = {"product_slab_ms": _time_ms(torch, lambda: code._product(op, x), 3),
                       "product_slab_bound_ms": slab_bound_ms}
    x = None
    for path in RS_PATHS:
        code = rs.segment_code(path=path)
        st_rec, st_enc = {}, {}
        rec_stream = rs.RSStream(code, present=RS_PRESENT, stages=st_rec)
        enc_stream = rs.RSStream(code, stages=st_enc)
        # warm one slab each: pinned staging, allocator, cuBLAS handle
        enc_stream.run_batch(rec_stream.run_batch(survivors[:slab]))
        st_rec.clear()
        st_enc.clear()
        rec_s, enc_s = [], []
        for _ in range(RS_PASSES):
            rec = par = None
            t0 = time.perf_counter()
            rec = rec_stream.run_batch(survivors)
            rec_s.append(time.perf_counter() - t0)
            bad = _first_mismatch(rec[:, 1], survivors[:, 0], slab)
            if bad is not None:
                fail(f"RS {path} reconstruct: segment {bad} row 1 differs from survivor row 0")
            t0 = time.perf_counter()
            par = enc_stream.run_batch(rec)
            enc_s.append(time.perf_counter() - t0)
            bad = _first_mismatch(par[:, 0], survivors[:, 1], slab)
            if bad is not None:
                fail(f"RS {path} re-encode: segment {bad} parity differs from survivor row 1")
        want = [gf256.rs_decode_ref(survivors[i], RS_PRESENT, 2, 1) for i in range(4)]
        if any(not np.array_equal(rec[i], w) for i, w in enumerate(want)):
            fail(f"RS {path} reconstruct: segments 0-3 differ from gf256.rs_decode_ref")
        rec = par = None
        r_med, e_med = _median(rec_s), _median(enc_s)
        paths[path] |= {
            "reconstruct_GiBps": gib_in / r_med, "reconstruct_seconds": rec_s,
            "encode_GiBps": gib_in / e_med, "encode_seconds": enc_s,
            "reconstruct_stage_seconds_per_pass": {k: v / RS_PASSES for k, v in st_rec.items()},
            "encode_stage_seconds_per_pass": {k: v / RS_PASSES for k, v in st_enc.items()},
            "reconstruct_share_of_bus_bound": bound_s / r_med,
        }
        say("5-rs-" + path, card=card, segments=segs, survivor_gib=gib_in, **paths[path])
    faster = max(RS_PATHS, key=lambda p: paths[p]["reconstruct_GiBps"])

    # ---- one reconstruct pass of the default product under the profiler
    code = rs.segment_code()
    stream = rs.RSStream(code, present=RS_PRESENT)
    stream.run_batch(survivors[:slab])
    rec, rows, wall_ms = _device_rows(torch, lambda: stream.run_batch(survivors))
    if _first_mismatch(rec[:, 1], survivors[:, 0], slab) is not None:
        fail("RS reconstruct under the profiler differs from survivor row 0")
    rec = None
    h2d = sum(ms for k, ms in rows if k.startswith("Memcpy HtoD"))
    d2h = sum(ms for k, ms in rows if k.startswith("Memcpy DtoH"))
    compute = sum(ms for k, ms in rows if not k.startswith("Memcpy"))
    top = {k: round(ms, 3) for k, ms in sorted(rows, key=lambda r: -r[1])[:8]}
    say("5-rs-trace", card=card, path=code.path, faster_path=faster, wall_ms=wall_ms,
        device_compute_ms=compute, h2d_copy_ms=h2d, d2h_copy_ms=d2h,
        compute_idle_share=1 - compute / wall_ms, top_device_ms=top,
        bus_bound_ms=bound_s * 1e3, bus_bound_both_at_once_ms=bound_both_s * 1e3,
        share_of_bus_bound=bound_s * 1e3 / wall_ms)
    survivors = None
    phase_rs_checks(torch, dev, card)
    say("5-rs-done", card=card, seconds=time.perf_counter() - t_start)


def phase_rs_checks(torch, dev, card: str) -> None:
    """The stream's edges against the port's gf256 reference, both
    products: a partial last slab, per-segment masks, RS(12,4)."""
    import numpy as np

    from cess_tpu_torch.ops import gf256, rs

    rng = np.random.default_rng(5)
    slab = rs.SLAB
    n = RS_FRAG
    # one full slab and a partial one of 5 segments
    surv = rng.integers(0, 256, size=(slab + 5, 2, n), dtype=np.uint8)
    last = range(slab, slab + 5)
    want_last = {i: gf256.rs_decode_ref(surv[i], RS_PRESENT, 2, 1) for i in last}
    # per-segment masks: every RS(2,1) survivor set four times, shuffled
    data = rng.integers(0, 256, size=(12, 2, n), dtype=np.uint8)
    allsh = np.stack([np.concatenate([d, gf256.rs_encode_ref(d, 2, 1)]) for d in data])
    pats = [[0, 1], [0, 2], [1, 2]] * 4
    rng.shuffle(pats)
    grouped = np.stack([allsh[i, p] for i, p in enumerate(pats)])
    want_grouped = np.stack([gf256.rs_decode_ref(grouped[i], p, 2, 1) for i, p in enumerate(pats)])
    # RS(12,4) at 3 MiB, several byte-axis tiles and an odd tail
    d12 = rng.integers(0, 256, size=(12, (1 << 18) + 13), dtype=np.uint8)
    p12 = gf256.rs_encode_ref(d12, 12, 4)
    all12 = np.concatenate([d12, p12])
    pres12 = sorted(rng.choice(16, size=12, replace=False).tolist())
    checks = {}
    for path in RS_PATHS:
        code = rs.segment_code(path=path)
        got = rs.RSStream(code, present=RS_PRESENT).run_batch(surv)
        checks[f"{path}_partial_slab"] = all(np.array_equal(got[i], want_last[i]) for i in last)
        got = rs.RSStream(code, present=pats).run_batch(grouped)
        checks[f"{path}_per_segment_masks"] = bool(
            np.array_equal(got, want_grouped) and np.array_equal(got, data))
        c12 = rs.RSCode(12, 4, path=path, tile=1 << 16)
        checks[f"{path}_rs124"] = bool(
            np.array_equal(c12.encode(d12).cpu().numpy(), p12)
            and np.array_equal(rs.RSStream(c12).run(d12), p12)
            and np.array_equal(c12.reconstruct(all12[pres12], pres12).cpu().numpy(), d12)
            and np.array_equal(rs.RSStream(c12, present=pres12).run(all12[pres12]), d12))
    say("5-rs-checks", card=card, present_rs124=pres12, **checks)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"RS checks against gf256 failed: {bad}")


if __name__ == "__main__":
    main()
