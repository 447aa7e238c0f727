"""Chip smoke test of the PyTorch/CUDA port (cess_tpu_torch) on one GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, one line each on stdout:
  0  setup: card name and power limit, torch/CUDA versions, kernel build
     and the native host library's build (g++, beside the nvcc builds)
  1  each hand-written kernel (K1 map, K4 pow chain, K2 GLV fold, K3
     ladder) against its plain tensor twin on the card, at the shapes and
     (for K3) the scalars the verify path gives it (`kernel_inputs`), K3
     also at prove_batch's launch, plus edge inputs and, for K2 and K3,
     the lane counts LANE_COUNTS; equal mod p per coordinate
  2  the PoDR2 verdict matrix at Podr2Params(n=8, s=4) through
     TorchBackend() against the port's CpuBackend, and prove_batch bytes
  3  protocol geometry (1024 chunks × 265 sectors, 47 challenged chunks):
     B = 3072 crafted proofs verify all True with every kernel's launch
     count read around that run; a 64-proof sub-batch
     with one tampered μ isolates exactly that proof; which XMD path
     hashed the chunk points (`xmd`: native or pure) and the stage split;
     3-host times the check's host steps alone (pk and σ decompression,
     encoding, transcript, one chunk's native XMD)
  3-staged  the same batch through TorchBackend(fused=False), the JAX
     package's staged route (the σ gate, one K3 fold per MSM, the chunk
     points hashed on the card by K1 with K4): all True, as on the fused
     route, with the kernels' launches counted around it (exactly one
     combined check: K1 1, K4 1, K2 0, K3 5), proofs/s and the stage
     split; the combined check called alone holds the batch and refuses
     the 64-proof tampered sub-batch, whose bisection isolates its proof;
     the device H fold at the batch's launch shapes (K1 on 144,384
     pairs, K3's wide ladder on 196,608 lanes × 224 bits) equals the host
     fold Π_c H(name‖i_c)^{v_c} on every 12th item
  3-profile  tools/torch_profile_verify.py on phase 3's batch: the staged
     check's steps timed one at a time (ρ, the μ combination, the σ gate,
     the σ MSM, the host XMD, the lanes' upload, the SSWU map, the
     grouped H fold, the ρ fold, the u fold, the pairing), then the fused and the staged route
     once warm and once under torch.profiler — all True with exactly
     PROFILE_LAUNCHES (fused K1 3, K4 3, K2 4, K3 3; staged as 3-staged),
     wall ms, the device busy ms as the union of the trace's device
     intervals beside the per-name sum, the idle share in [0, 1], the
     eight largest device entries, the stage seconds — and the proof
     stage histograms' totals and host/device overlap fraction; the
     fused route's profiled run also gives the `3-trace` line (wall ms,
     device busy ms, idle share, the largest device entries)
  3-frontend  tools/torch_bench_frontend.py at B = 3,072: σ
     decompression, transcript and ρ, μ packing on the host, then the
     deferred σ subgroup gate on the card (one K3 [r]-chain), True
  3-msm  g1.msm_wide, the flat Pippenger MSM (plain torch), against
     g1.msm (K3 and the tree) on the batch's σ fold (3,072 lanes × 128
     bits) and on BASELINE config 5's (100,000 lanes × 128 bits), against
     the host fold on 256 lanes and with raw 224-bit scalars v·h_eff on
     uncleared hash points: seconds, the Fp products the plain code
     computed, the bound of the bucket method and peak memory
  4  a `kernels` JSON line (printed after phase 9-epoch): launches on the
     B = 3072 run, on the staged run (`launches_staged`) and on 3-profile's
     two profiled runs (`launches_profile`, by route), time, twin time,
     bound and the check error of every kernel
  5-rs  the Reed-Solomon data plane at bench.py's `bench_rs` geometry:
     RS(2,1) segments of 8 MiB fragments, 640 of them (10 GiB of
     survivors, fewer if host memory is short) reconstructed from
     survivors [1, 2] and re-encoded by RSStream.run_batch from host
     memory, on both GF(256) products, three passes each, every output
     byte checked; pinned copy rates and the bus bound; one pass under
     torch.profiler (the per-name sums of compute and copies, and the
     union of the device intervals across its streams); segments, a
     partial slab, per-segment masks and RS(12,4) against the port's gf256 reference.  The RS path has no
     hand kernel (the JAX package computes it in plain XLA), so it adds
     no `kernels` row.
  6  the signature and attestation verifiers.  6-bls: BASELINE config 4
     (50,000 BLS signatures) cut to 2,048 under 16 keys end to end —
     bls_agg.batch_verify_signatures once (signatures/s, seconds
     in parse, hash, folds and pairing), a tampered signature (that
     check under torch.profiler: device busy and idle share), the Δ/−Δ
     malleation and a 64-signature bisection; 6-bls-k3: K3 against its
     twin at that fold's launch (2,048 lanes × 128 bits) and at the full
     width (65,536 lanes, 50,000 live), and both folds timed at the full
     width.  6-vrf: 600 claims (one hour of 6 s slots) from 8
     validators through vrf.batch_verify, a forged proof, verify_claims
     on 64.  6-rsa: 1,024 RSA-2048 PKCS#1 v1.5 SHA-256 signatures
     through rsa.verify_batch against host rsa.verify, the modexp's
     values against pow and its limbs against the CPU's, its device ms
     and bound.  6-ias: 64 attestation reports under a 2048-bit fixture
     authority, batch against single verdicts.  The kernels line gives
     K3's launches in one BLS batch check.
  7-sim  the chain and its multi-role simulator: NodeSim on the card
     through tests/test_node_sim.py's scenario (sim_steps): fillers,
     an RS upload, an honest audit round, a round after one miner's
     service fragments are corrupted, recover_file; the state hash after
     each step against tests/test_torch_chain.py's, the verdicts, each
     step's seconds and K1-K4's launches in the two rounds
     (`launches_sim` in the kernels line).
  8-node  the node layer: tests/test_zz_sync_testnet.py's scenario on the
     port — three `python -m cess_tpu_torch run` validators on the card
     (no --device) and a keyless `--replica`; from this process the port's
     TEE, stash and miner clients register the TEE through the IAS check
     (its receipt ok on every validator), create 2 fillers at PoDR2 8 x 4,
     answer the OCW-committed challenge and verify it with TorchBackend()
     on the card ({"miner-0": (True, True)}), a reward lands, every
     validator finalizes >= 4 with one state hash and one block signature
     there, and the port's LightClient reads a key from the replica
     against its own verified anchor.  Prints each step's seconds, K1-K4's
     launches around the prove and the verify (`launches_node` in the
     kernels line) and the cess_proof_checks and cess_rs_streams_total
     this process observed in phases 3 and 5-rs.  Then the port's
     operator tools on that network: tools/torch_telemetry_report.py's
     FleetCollector samples the validators and the replica (3 samples or
     more across 2 new blocks) and reports with this process's proof
     stage registry merged (`8-node-fleet`: no node unreachable, blocks/s
     above 0, the pairings of the round's own verify in the proof family,
     read around that verify as `round_proof_plane`), and
     tools/torch_read_loadgen.py's run_load drives 2 verifying light
     clients x 10 proof-batch reads on the replica (`8-node-load`: 20
     reads, no error).
  9-mesh  the device mesh (cess_tpu_torch/parallel) on a one-rank mesh
     from make_mesh() and a four-rank mesh on the one card (four shards
     of every meshed batch: the sharding logic, not a multi-card
     measurement): phase 3's batch through TorchBackend(mesh=…), the
     staged route with the μ combination sharded — all True in exactly
     one combined check (K1 1, K4 1, K2 0, K3 5; `launches_mesh` in the
     kernels line, the four-rank run), the combined check True and False
     alone, the tampered sub-batch isolated — proofs/s and the stage
     split; combine_mu_sharded over 3,071 rows against fr.combine_mu;
     msm_sharded against K3's msm at 3,072 lanes (one and four ranks)
     and at config 5's 100,000 × 128 bits (four); on four ranks the BLS
     batch check at 256 signatures (True, and False with one tampered),
     verify_signatures isolating the tampered one among 64 and
     vrf.verify_claims isolating a forged claim among 64; RS on one slab
     of 8 MiB fragments and a byte-axis run over an odd width, both
     products, one and four ranks, bytes equal to the unmeshed path's.
  9-epoch  parallel.run_epoch(make_mesh(), check=True) at BASELINE config
     5's 100,000 proofs, the rest cut (EPOCH_CUTS): every stage flag True,
     each stage's seconds and K1-K4's launches (`launches_epoch`).

The last line is {"ok": true, "device": {...}}; any failed phase exits
non-zero before it.  Imports neither jax nor cess_tpu.
"""

from __future__ import annotations

import contextlib
import json
import random
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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

    from cess_tpu_torch import native
    from cess_tpu_torch.ops import _cuda

    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host_build = pool.submit(_timed, native.load)
        _cuda.build()
        _cuda.load_all()
        build_s = time.perf_counter() - t0
        native_s = host_build.result()
    say("0-setup", card=card, torch=torch.__version__, cuda=torch.version.cuda,
        build_seconds=round(build_s, 3), native_build_seconds=round(native_s, 3),
        ptxas={n: _ptxas_summary(n) for n in _cuda._SOURCES})

    results = phase_kernels(torch, dev)
    phase_matrix(torch, dev)
    launches, batch = phase_geometry(torch, dev, BATCH)
    staged_launches = phase_staged(torch, card, *batch)
    profile_launches = phase_profile(torch, card, *batch)
    phase_frontend(card)
    config5 = phase_msm(torch, dev, card, *batch)
    rows = []
    for name in ("K1", "K4", "K2", "K3"):
        r = dict(results[name])
        r["launches"] = launches[name]
        r["launches_staged"] = staged_launches[name]
        r["launches_profile"] = profile_launches[name]
        rows.append(r)
    missing = [r["name"] for r in rows if r["launches"] == 0]
    if missing:
        fail(f"main path launched no {missing}")
    phase_rs(torch, dev, card)
    k3 = next(r for r in rows if r["name"].startswith("K3"))
    k3["launches_bls_check"] = phase_signatures(torch, dev, card)
    sim_launches = phase_sim(torch, dev, card)
    node_launches = phase_node(torch, card)
    mesh_launches = phase_mesh(torch, card, *batch, config5)
    batch = config5 = None
    epoch_launches = phase_epoch(torch, card)
    for name, r in zip(("K1", "K4", "K2", "K3"), rows):
        r["launches_sim"] = sim_launches[name]
        r["launches_node"] = node_launches[name]
        r["launches_mesh"] = mesh_launches[name]
        r["launches_epoch"] = epoch_launches[name]
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


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
    pts, s = _loose_points_and_scalars(torch, rng, groups * width, live, bits, dev, group=width)
    inp["K3_prove"] = (pts, s, bits)
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
    want_prove, prove_twin_ms, _ = _twin(torch, lambda: g1.batch_scalar_mul(ptsp, sp, bp))
    errs["prove"] = _compare(torch, calls["K3_prove"](), want_prove)
    want_prove = None
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
        prove_lanes=sp.shape[1], prove_bits=bp, prove_ms=prove_ms, prove_twin_ms=prove_twin_ms,
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


def _device_busy(torch, fn):
    """fn() under torch.profiler → (its result, device busy ms, wall ms,
    the largest device entries), through tools/torch_profile_verify.py's
    runner: busy is the union of the trace's device intervals (what
    overlaps on several streams counts once), and a trace that holds no
    device time raises."""
    from tools.torch_profile_verify import run_traced

    out, wall_ms, trace, _ = run_traced(fn)
    top = {k: round(ms, 3) for k, ms in trace["top_device_ms"].items()}
    return out, trace["device_busy_ms"], wall_ms, top


@contextlib.contextmanager
def _counting(module, name: str, counts: dict, key: str):
    """Count the calls of module.name into counts[key] while inside."""
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        counts[key] += 1
        return fn(*args, **kwargs)

    setattr(module, name, counted)
    try:
        yield
    finally:
        setattr(module, name, fn)


def phase_geometry(torch, dev, batch: int) -> tuple:
    """Phase 3; returns the launches on the main path and the batch
    (pk, items, params) for phases 3-staged and 3-msm."""
    from cess_tpu_torch import native
    from cess_tpu_torch.ops import h2c, podr2
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
    counters = _kernel_counters()
    for f in counters.values():
        f.launches = 0
    xmd_calls = {"native": 0, "pure": 0}
    with _counting(native, "xmd_u_indexed", xmd_calls, "native"), \
            _counting(h2c, "_u_host_fallback", xmd_calls, "pure"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        verdicts = backend.verify_batch(pk, items, b"bench-seed", params)
        torch.cuda.synchronize()
        verify_s = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    xmd = "native" if xmd_calls["native"] and not xmd_calls["pure"] else "pure"
    if verdicts != [True] * batch:
        fail(f"protocol batch: {verdicts.count(False)} of {batch} proofs rejected")
    if xmd != "native":
        fail(f"protocol batch: the chunk points were hashed {xmd_calls}")
    say("3-geometry", batch=batch, chunks=-(-batch // fused.CHUNK),
        verify_seconds=round(verify_s, 3), proofs_per_s=round(batch / verify_s, 3),
        craft_seconds=round(craft_s, 3), xmd=xmd, xmd_calls=xmd_calls,
        stage_seconds={k: round(v, 3) for k, v in backend.stage_seconds.items()},
        launches=launches, all_true=True)

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
    phase_host_split(items, params)
    return launches, (pk, items, params)


def phase_host_split(items, params) -> None:
    """3-host: the host steps of one combined check on phase 3's batch,
    each timed alone: the front end before the first chunk
    (combined_check_fused's order) and the native XMD of every pair."""
    import numpy as np

    from cess_tpu_torch.ops import podr2
    from cess_tpu_torch.ops.bls12_381 import G2Point
    from cess_tpu_torch.proof import frontend, fused

    pk = podr2.keygen(b"bench-tee")[1]
    secs = {}
    t0 = time.perf_counter()
    G2Point.from_bytes(pk)
    secs["pk_decompress"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    frontend.decompress_sigmas(items)
    secs["sigma_decompress"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    encs = frontend.encode_proofs(items)
    frontend.mu_in_range(frontend.mu_words(encs, params.s))
    secs["encode_mu"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch_items = [podr2.BatchItem(n, c, p) for n, c, p in items]
    podr2.batch_rho(podr2.batch_transcript(b"bench-seed", batch_items, encodings=encs), len(items))
    secs["transcript_rho"] = time.perf_counter() - t0
    ch = items[0][1]
    chunk = items[: fused.CHUNK]
    ids = np.repeat(np.arange(len(chunk), dtype=np.uint32), len(ch.indices))
    idx = np.tile(np.asarray(ch.indices, dtype=np.uint64), len(chunk))
    t0 = time.perf_counter()
    fused._xmd_u([n for n, _, _ in chunk], ids, idx)
    secs["xmd_native_one_chunk"] = time.perf_counter() - t0
    say("3-host", batch=len(items), pairs_a_chunk=len(ids), seconds=secs)


# ------------------------------------------------------------ phase 3-staged


def _kernel_counters():
    from tools.torch_profile_verify import kernel_counters

    return kernel_counters()


# The staged route's launches on one combined check that passes: the σ
# gate, the σ fold, the H fold, its ρ fold and the u fold on K3; the H
# fold's hashing on K1 (with K4).  Any bisection would launch more.
STAGED_LAUNCHES = {"K1": 1, "K4": 1, "K2": 0, "K3": 5}
# Items of the batch whose device H fold is held to the host fold.
H_FOLD_STRIDE = 12


def _host_h_fold(lanes):
    """Σ_c [v_c]H_c on the host for one item: lanes [(x, y, v)] of
    cleared chunk points → (x, y)."""
    from cess_tpu_torch.ops import bls12_381 as bls

    acc = bls.G1Point.infinity()
    for x, y, v in lanes:
        acc = acc + bls.G1Point(x, y).mul(v)
    return acc.x, acc.y


def phase_staged(torch, card: str, pk, items, params) -> dict:
    """3-staged: phase 3's batch through TorchBackend(fused=False) — the
    σ gate, one K3 fold per MSM, the chunk points hashed on the card (K1
    with K4) — all True as on the fused route, in exactly one combined
    check (STAGED_LAUNCHES); the combined check alone, True on the batch
    and False on the 64-proof sub-batch with one tampered μ, whose
    bisection isolates that proof; then the device H fold held to the
    host fold.  Returns the launches."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from cess_tpu_torch.ops import podr2
    from cess_tpu_torch.proof import TorchBackend

    batch = len(items)
    backend = TorchBackend(fused=False)
    counters = _kernel_counters()
    for f in counters.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    verdicts = backend.verify_batch(pk, items, b"bench-seed", params)
    torch.cuda.synchronize()
    verify_s = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    stages = dict(backend.stage_seconds)
    if verdicts != [True] * batch:
        fail(f"3-staged: {verdicts.count(False)} of {batch} proofs rejected (fused: all True)")
    if launches != STAGED_LAUNCHES:
        fail(f"3-staged: launches {launches}, one passing combined check gives {STAGED_LAUNCHES}")

    if backend._combined_check(pk, items, b"bench-seed", params) is not True:
        fail("3-staged: the combined check refused the honest batch")
    sub = list(items[:64])
    nm, c, p = sub[17]
    sub[17] = (nm, c, podr2.Podr2Proof(p.sigma, [1] + p.mu[1:]))
    if backend._combined_check(pk, sub, b"bench-seed-2", params) is not False:
        fail("3-staged: the combined check passed the tampered sub-batch")
    t0 = time.perf_counter()
    v = backend.verify_batch(pk, sub, b"bench-seed-2", params)
    tampered_s = time.perf_counter() - t0
    if [i for i, x in enumerate(v) if not x] != [17]:
        fail(f"3-staged: tampered sub-batch verdicts {v}")

    # the device H fold at the batch's launch shapes, against the host
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = backend._h_inner_fold_device(items)
    fold_s = time.perf_counter() - t0
    held = list(range(0, batch, H_FOLD_STRIDE))
    ch = items[0][1]
    if any(c is not ch for _, c, _ in items):
        fail("3-staged: the batch's items do not share one challenge")
    pts = podr2.chunk_points_batch([(items[b][0], i) for b in held for i in ch.indices])
    coeffs = ch.coefficients()
    k = len(ch.indices)
    jobs = [[(q.x, q.y, v) for q, v in zip(pts[j * k:(j + 1) * k], coeffs)] for j in range(len(held))]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(8, mp_context=multiprocessing.get_context("spawn")) as pool:
        want = list(pool.map(_host_h_fold, jobs, chunksize=8))
    host_s = time.perf_counter() - t0
    bad = [b for b, w in zip(held, want) if (got[b].x, got[b].y) != w]
    if bad:
        fail(f"3-staged: the device H fold differs from the host fold at items {bad[:8]}")
    say("3-staged", card=card, batch=batch, verify_seconds=verify_s,
        proofs_per_s=batch / verify_s, all_true=True, equal_to_fused=True,
        stage_seconds=stages,
        launches=launches, k2_expected=0, combined_check={"batch": True, "tampered": False},
        tampered_false_at=[17], tampered_seconds=tampered_s,
        h_fold={"items": batch, "pairs": batch * k, "lanes": batch * (1 << (k - 1).bit_length()),
                "bits": 224, "seconds": fold_s, "held_items": len(held),
                "host_seconds": host_s, "equal": True})
    return launches


# ------------------------------------------------------------ phase 3-profile

# One passing combined check a route on phase 3's batch: the fused route's
# three 1,024-proof chunks (K1 with K4 and K2 a chunk, K3's σ ladder a
# chunk) and its u fold (K2), the staged route's STAGED_LAUNCHES.
PROFILE_LAUNCHES = {"fused": {"K1": 3, "K4": 3, "K2": 4, "K3": 3},
                    "staged": STAGED_LAUNCHES}
def phase_profile(torch, card: str, pk, items, params) -> dict:
    """3-profile: tools/torch_profile_verify.py on phase 3's batch — the
    staged check's steps timed one at a time, then each route once warm
    and once under torch.profiler: all True, exactly PROFILE_LAUNCHES,
    the device busy time as the union of the trace's device intervals
    beside the per-name sum, the idle share in [0, 1]; the stage
    histograms.  Returns {kernel: {route: launches}}."""
    from tools.torch_profile_verify import profile_verify

    t0 = time.perf_counter()
    out = profile_verify(pk, items, params)
    seconds = time.perf_counter() - t0
    say("3-profile", card=card, seconds=seconds, **out)
    fused = out["routes"]["fused"]
    say("3-trace", batch=len(items), wall_ms=fused["wall_ms"],
        device_busy_ms=fused["device_busy_ms"], device_idle_share=fused["device_idle_share"],
        top_device_ms={k: round(ms, 3) for k, ms in fused["top_device_ms"].items()})
    if not out["components_pairing_true"]:
        fail("3-profile: the staged check's steps, one at a time, refused the batch")
    for route, r in out["routes"].items():
        if not r["all_true"]:
            fail(f"3-profile: the {route} route refused the batch")
        if r["launches"] != PROFILE_LAUNCHES[route]:
            fail(f"3-profile: {route} launches {r['launches']}, one passing combined "
                 f"check gives {PROFILE_LAUNCHES[route]}")
        if not 0 <= r["device_idle_share"] <= 1:
            fail(f"3-profile: {route} idle share {r['device_idle_share']}")
    return {name: {route: r["launches"][name] for route, r in out["routes"].items()}
            for name in PROFILE_LAUNCHES["fused"]}


def phase_frontend(card: str) -> None:
    """3-frontend: tools/torch_bench_frontend.py at B = 3,072 — the host
    front end's steps and the deferred σ gate on the card, which must
    take the device chain (one K3 launch) and pass."""
    from tools.torch_bench_frontend import bench_frontend

    out, outputs = bench_frontend(BATCH)
    say("3-frontend", card=card, gate_launches=outputs["gate_launches"], **out)
    if outputs["subgroup_ok"] is not True:
        fail("3-frontend: the deferred subgroup gate refused the crafted σ points")
    if out["subgroup_route"] != "device-chain" or outputs["gate_launches"] != 1:
        fail(f"3-frontend: the gate took {out['subgroup_route']} with "
             f"{outputs['gate_launches']} K3 launches, not one device chain")


# ------------------------------------------------------------ phase 3-msm

# BASELINE config 5's σ fold: 100,000 proofs, ρ of 128 bits
# (cess_tpu/parallel/epoch_sim.py:172).
MSM_CONFIG5 = 100_000


def _msm_timed(torch, fn):
    """fn() on the card: (result, seconds, (Fp products, squarings) the
    plain tensor code computed)."""
    from cess_tpu_torch.ops import g1

    torch.cuda.synchronize()
    c0, q0 = g1.MUL_COUNT[0], g1.SQR_COUNT[0]
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, (g1.MUL_COUNT[0] - c0, g1.SQR_COUNT[0] - q0)


def _bucket_work(scalars, bits: int) -> tuple[int, int]:
    """(Fp products, of which squarings) the bucket method needs for
    Σ [s_i]P_i on these scalars, in 12-bit windows: one addition a
    nonzero digit into its bucket, 2 · 4,096 a window for the running
    sums Σ_d d·B_d, then 12 doublings and one addition a window to join
    the windows; 12 products a complete addition, 8 (2 of them
    squarings) a doubling."""
    import numpy as np

    from cess_tpu_torch.ops import g1

    windows = -(-bits // g1.LIMB_BITS)
    nonzero = int(np.count_nonzero(g1.scalars_to_digits(scalars, windows)))
    adds = nonzero + 2 * g1.BASE * windows + windows - 1
    dbls = g1.LIMB_BITS * (windows - 1)
    return 12 * adds + 8 * dbls, 2 * dbls


def phase_msm(torch, dev, card: str, pk, items, params) -> tuple:
    """3-msm: g1.msm_wide (the flat Pippenger MSM, plain torch) on the
    card against g1.msm (K3 plus the tree) on phase 3's σ fold (3,072
    lanes × 128 bits) and on config 5's (100,000 lanes × 128 bits), then
    against host folds on 256 lanes and with raw 224-bit scalars v·h_eff
    on uncleared hash points.  Any difference fails the phase.  Returns
    config 5's points and scalars for phase 9-mesh."""
    import numpy as np

    from cess_tpu_torch.ops import bls12_381 as bls
    from cess_tpu_torch.ops import g1, h2c, podr2
    from cess_tpu_torch.proof import frontend

    out = {}
    sigmas = frontend.decompress_sigmas(items)
    encs = frontend.encode_proofs(items)
    rhos = podr2.batch_rho(podr2.batch_transcript(
        b"bench-seed", [podr2.BatchItem(n, c, p) for n, c, p in items], encodings=encs), len(items))

    def against_msm(tag, pts, scalars):
        g1.msm_wide(pts[:64], scalars[:64], bits=128, device=dev)  # warm
        torch.cuda.reset_peak_memory_stats()
        got, wide_s, work = _msm_timed(torch, lambda: g1.msm_wide(pts, scalars, bits=128, device=dev))
        peak = torch.cuda.max_memory_allocated()
        want, msm_s, _ = _msm_timed(torch, lambda: g1.msm(pts, scalars, bits=128, device=dev))
        need = _bucket_work(scalars, 128)
        out[tag] = {"lanes": len(pts), "bits": 128, "equal": got == want, "msm_wide_s": wide_s,
                    "k3_msm_s": msm_s, "code_fp_products": work[0], "code_fp_squarings": work[1],
                    "bound_fp_products": need[0], "bound_fp_squarings": need[1],
                    "bound_ms": _ops_ms(need), "peak_gib": peak / 2**30}
        if got != want:
            fail(f"3-msm: msm_wide differs from msm at {tag}")

    against_msm("sigma_fold_3072", sigmas, rhos)

    # config 5: 100,000 subgroup points [k]G crafted by one K3 launch
    rng = np.random.default_rng(5)
    ks = [int.from_bytes(rng.bytes(32), "little") % bls.R for _ in range(MSM_CONFIG5)]
    gX, gY, gZ = (torch.as_tensor(a, device=dev).expand(-1, MSM_CONFIG5).contiguous()
                  for a in _points_to_dev(torch, [bls.G1_GENERATOR], "cpu"))
    s = torch.as_tensor(g1.scalars_to_limbs(ks).T.copy(), device=dev)
    t0 = time.perf_counter()
    pts = g1.projective_to_points(*(a.T for a in g1.scalar_mul_ladder((gX, gY, gZ), s)))
    craft_s = time.perf_counter() - t0
    scalars5 = [int.from_bytes(rng.bytes(16), "little") for _ in pts]
    against_msm("config5_100000", pts, scalars5)
    out["config5_100000"]["craft_s"] = craft_s

    # 256 lanes against the host fold Σ [ρ_i]σ_i
    want = bls.G1Point.infinity()
    for p, r in zip(sigmas[:256], rhos[:256]):
        want = want + p.mul(r)
    got, secs, _ = _msm_timed(torch, lambda: g1.msm_wide(sigmas[:256], rhos[:256], bits=128, device=dev))
    out["host_256"] = {"equal": got == want, "msm_wide_s": secs}
    if got != want:
        fail("3-msm: msm_wide differs from the host fold on 256 lanes")

    # raw 224-bit v·h_eff on uncleared hash points, as the staged H fold
    name, ch, _ = items[0]
    names = [nm for nm, _, _ in items[:6]]
    ids = np.repeat(np.arange(6, dtype=np.uint32), len(ch.indices))
    idx = np.tile(np.asarray(ch.indices, dtype=np.uint64), 6)
    (X, Y, Z), n = h2c.hash_pairs_device(names, ids, idx, podr2.H_DST, device=dev)
    unclear = g1.projective_to_points(X.T[:n], Y.T[:n], Z.T[:n])
    scal = [v * h2c.H_EFF for v in ch.coefficients()] * 6
    want = bls.G1Point.infinity()
    for p, v in zip(unclear, scal):
        want = want + p._mul_raw(v)
    got, secs, _ = _msm_timed(torch, lambda: g1.msm_wide(unclear, scal, bits=224, device=dev))
    out["raw_224_uncleared"] = {"lanes": n, "in_subgroup": sum(p.in_subgroup() for p in unclear[:8]),
                                "equal": got == want, "msm_wide_s": secs}
    if got != want:
        fail("3-msm: msm_wide differs from the host fold on raw 224-bit scalars")
    say("3-msm", card=card, checks=out, flat_chunk_window_lanes=g1._FLAT_CHUNK)
    return pts, scalars5


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
    from tools.torch_profile_verify import run_traced

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
    rec, wall_ms, trace, rows = run_traced(lambda: stream.run_batch(survivors))
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
        device_busy_ms=trace["device_busy_ms"], device_sum_ms=trace["device_sum_ms"],
        device_idle_share=1 - trace["device_busy_ms"] / wall_ms,
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


# ------------------------------------------------------------ phase 6

# BASELINE config 4 verifies 50,000 miner signatures.  End to end the
# batch is cut to 2,048 under 16 keys: the host hashes every message and
# decompresses every signature in pure Python (about 14 ms a signature,
# in the JAX package as in the port).  The two device folds also run at
# the full width, on tensors made on the card.
BLS_FULL = 50_000
BLS_SIGS = 2048
BLS_KEYS = 16
BLS_RUNS = 1
BLS_BITS = 128  # bls_agg._RHO_BITS
# One epoch of one hour at 6 s slots (BASELINE.md), from 8 validators.
VRF_CLAIMS = 600
VRF_VALIDATORS = 8
# RSA-2048 PKCS#1 v1.5 SHA-256, the IAS report-signing key's shape.
RSA_BITS = 2048
RSA_SIGS = 1024
IAS_REPORTS = 64


def _loose_points_and_scalars(torch, rng, n: int, live: int, bits: int, dev, group: int | None = None):
    """(33, n) random loose points and (22, n) random `bits`-bit scalars
    on the card; lanes past `live` (in each group of `group` lanes, if
    given) are the (∞, 0) pads the folds add."""
    from cess_tpu_torch.ops import g1

    X, Y, Z = (_rand_fp(torch, rng, n, dev, loose=True) for _ in range(3))
    s = torch.as_tensor(rng.integers(0, 4096, size=(g1.R_LIMBS, n), dtype="int32"), device=dev)
    s[bits // 12] &= (1 << (bits % 12)) - 1
    s[bits // 12 + 1 :] = 0
    lane = torch.arange(n, device=dev)
    pad = (lane % group if group else lane) >= live
    for a, v in ((X, 0), (Y, 1), (Z, 0)):
        a[:, pad] = torch.as_tensor(g1.fp_to_limbs(v), device=dev)[:, None]
    s[:, pad] = 0
    return (X, Y, Z), s


def phase_bls(torch, dev, card: str) -> int:
    """6-bls: config 4's weighted batch check end to end (cut), its K3
    launch against the twin, and both folds at the full width.  Returns
    the K3 launches of one batch check."""
    import numpy as np

    from cess_tpu_torch.ops import bls12_381 as bls
    from cess_tpu_torch.ops import bls_agg, g1
    from cess_tpu_torch.ops.bls12_381 import G1Point

    t_start = time.perf_counter()
    keys = [bls.keygen(b"smoke-bls-key-%d" % k) for k in range(BLS_KEYS)]
    pks = [bls.sk_to_pk(sk) for sk in keys]
    msgs = [b"smoke-bls-msg-%06d" % i for i in range(BLS_SIGS)]
    hashed = [bls.hash_to_g1(m) for m in msgs]
    sig_pts = g1.scalar_mul_batch(hashed, [keys[i % BLS_KEYS] for i in range(BLS_SIGS)], device=dev)
    triples = [(pks[i % BLS_KEYS], m, p.to_bytes()) for i, (m, p) in enumerate(zip(msgs, sig_pts))]
    if triples[1][2] != bls.sign(keys[1], msgs[1]):
        fail("6-bls: a signature crafted on the card differs from bls.sign")
    craft_s = time.perf_counter() - t_start

    # the main path: BLS_RUNS timed runs, K3's count read around the first
    runs, stages = [], []
    for run in range(BLS_RUNS):
        st = {}
        if run == 0:
            g1.scalar_mul_ladder.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = bls_agg.batch_verify_signatures(triples, b"smoke-seed", stages=st)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        stages.append(st)
        if run == 0:
            k3_launches = g1.scalar_mul_ladder.launches
        if ok is not True:
            fail(f"6-bls: the honest batch of {BLS_SIGS} verified {ok}")
    if k3_launches == 0:
        fail("6-bls: the batch check launched no K3")

    # one tampered signature, the batch check under the profiler: the
    # same work as an honest check (every stage runs), a False verdict
    checks = {"honest": True}
    tampered = list(triples)
    at = BLS_SIGS // 2 + 1
    pk, msg, _ = tampered[at]
    tampered[at] = (pk, msg, triples[at + 1][2])
    ok, busy_ms, wall_ms, top = _device_busy(
        torch, lambda: bls_agg.batch_verify_signatures(tampered, b"smoke-seed"))
    checks["tampered_refused"] = ok is False
    trace = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
             "device_idle_share": 1 - busy_ms / wall_ms,
             "top_device_ms": top}
    # tests/test_bls_agg.py:90-112: shift one signature by Δ and one by −Δ
    (pk, m0, s0), (_, m1, s1) = triples[0], triples[BLS_KEYS]
    delta = bls.G1_GENERATOR.mul(12345)
    shifted = [(pk, m0, (G1Point.from_bytes(s0) + delta).to_bytes()),
               (pk, m1, (G1Point.from_bytes(s1) + (-delta)).to_bytes())]
    agg = bls_agg.aggregate_signatures([s for _, _, s in shifted])
    checks["malleation_plain_aggregate_accepts"] = bls_agg.verify_aggregate([pk, pk], [m0, m1], agg)
    checks["malleation_refused"] = not bls_agg.batch_verify_signatures(shifted, b"smoke-seed")
    sub = list(triples[:64])
    pk, msg, _ = sub[17]
    sub[17] = (pk, msg, triples[18][2])
    verdicts = bls_agg.verify_signatures(sub, b"smoke-seed")
    checks["bisection_false_at"] = [i for i, v in enumerate(verdicts) if not v]
    if not all(v for k, v in checks.items() if k != "bisection_false_at") or \
            checks["bisection_false_at"] != [17]:
        fail(f"6-bls checks: {checks}")

    per_run = {k: [st[k] for st in stages] for k in stages[0]}
    say("6-bls", card=card, signatures=BLS_SIGS, keys=BLS_KEYS,
        cut=f"{BLS_FULL} -> {BLS_SIGS} signatures: the host hashes and decompresses "
            "each in pure Python (so does the JAX package); the folds run at full width below",
        craft_seconds=craft_s, verify_seconds=runs,
        signatures_per_s=BLS_SIGS / _median(runs), stage_seconds=per_run,
        k3_launches_per_check=k3_launches, checks=checks, profiled_check=trace)

    # ---- K3 at this fold's launch (2,048 lanes × 128 bits) against its
    # twin, then both folds at config 4's full width
    rhos = bls_agg.batch_weights(bls_agg.agg_transcript(b"smoke-seed", triples), BLS_SIGS)
    X, Y, Z, s, _ = g1._prepare([G1Point.from_bytes(t[2]) for t in triples], rhos, BLS_BITS, dev)
    got = g1.scalar_mul_ladder((X, Y, Z), s, bits=BLS_BITS)
    want, twin_ms, _ = _twin(torch, lambda: g1.batch_scalar_mul((X, Y, Z), s, BLS_BITS))
    err = _compare(torch, got, want)
    fold_ms = _time_ms(torch, lambda: g1.scalar_mul_ladder((X, Y, Z), s, bits=BLS_BITS), 10)
    rng = np.random.default_rng(2026)
    full = 1 << (BLS_FULL - 1).bit_length()
    pts, sc = _loose_points_and_scalars(torch, rng, full, BLS_FULL, BLS_BITS, dev)
    got = g1.scalar_mul_ladder(pts, sc, bits=BLS_BITS)
    want, full_twin_ms, _ = _twin(torch, lambda: g1.batch_scalar_mul(pts, sc, BLS_BITS))
    wide_err = _compare(torch, got, want)
    got = want = None
    width = 1 << (-(-BLS_FULL // BLS_KEYS) - 1).bit_length()
    gpts, gsc = _loose_points_and_scalars(torch, rng, BLS_KEYS * width, -(-BLS_FULL // BLS_KEYS),
                                          BLS_BITS, dev, group=width)
    flat_ms = _time_ms(torch, lambda: g1._msm_kernel(*pts, sc, bits=BLS_BITS), 3)
    grouped_ms = _time_ms(torch, lambda: g1._msm_kernel(*gpts, gsc, bits=BLS_BITS, group=width), 3)
    ladder_ms = _time_ms(torch, lambda: g1.scalar_mul_ladder(pts, sc, bits=BLS_BITS), 3)
    say("6-bls-k3", card=card, fold_lanes=X.shape[1], bits=BLS_BITS, max_abs_err=err,
        fold_ladder_ms=fold_ms, fold_twin_ms=twin_ms,
        fold_bound_ms=_ops_ms(g1.ladder_work(s, BLS_BITS)),
        full_lanes=full, full_live=BLS_FULL, full_max_abs_err=wide_err,
        full_ladder_ms=ladder_ms, full_twin_ms=full_twin_ms,
        full_bound_ms=_ops_ms(g1.ladder_work(sc, BLS_BITS)),
        full_flat_fold_ms=flat_ms, full_grouped_fold_ms=grouped_ms,
        grouped_shape=[BLS_KEYS, width])
    if err or wide_err:
        fail("6-bls: K3 disagrees with its twin at 128 bits")
    return k3_launches


def phase_vrf(torch, dev, card: str) -> None:
    """6-vrf: one epoch's claims through vrf.batch_verify on the card."""
    from cess_tpu_torch.consensus import vrf
    from cess_tpu_torch.ops import bls12_381 as bls
    from cess_tpu_torch.ops import g1

    t_start = time.perf_counter()
    keys = [bls.keygen(b"smoke-vrf-val-%d" % v) for v in range(VRF_VALIDATORS)]
    pks = [bls.sk_to_pk(sk) for sk in keys]
    msgs = [vrf.vrf_input("cess-smoke", 1, b"\x11" * 32, slot) for slot in range(VRF_CLAIMS)]
    proofs = [p.to_bytes() for p in g1.scalar_mul_batch(
        [bls.hash_to_g1(m) for m in msgs],
        [keys[i % VRF_VALIDATORS] for i in range(VRF_CLAIMS)], device=dev)]
    claims = [(pks[i % VRF_VALIDATORS], m, vrf.proof_to_output(p), p)
              for i, (m, p) in enumerate(zip(msgs, proofs))]
    if vrf.prove(keys[3 % VRF_VALIDATORS], msgs[3]) != (claims[3][2], claims[3][3]):
        fail("6-vrf: a proof crafted on the card differs from vrf.prove")
    craft_s = time.perf_counter() - t_start

    g1.scalar_mul_ladder.launches = 0
    t0 = time.perf_counter()
    ok = vrf.batch_verify(claims, b"smoke-epoch")
    verify_s = time.perf_counter() - t0
    launches = g1.scalar_mul_ladder.launches
    at = VRF_CLAIMS // 2
    out, proof = vrf.prove(bls.keygen(b"smoke-vrf-thief"), msgs[at])
    bad = list(claims)
    bad[at] = (pks[at % VRF_VALIDATORS], msgs[at], out, proof)
    forged_refused = not vrf.batch_verify(bad, b"smoke-epoch")
    sub = list(claims[:64])
    sub[10] = (sub[10][0], sub[10][1], out, proof)
    sub[40] = (sub[40][0], sub[40][1], claims[41][2], sub[40][3])
    verdicts = vrf.verify_claims(sub, b"smoke-epoch")
    false_at = [i for i, v in enumerate(verdicts) if not v]
    say("6-vrf", card=card, claims=VRF_CLAIMS, validators=VRF_VALIDATORS,
        craft_seconds=craft_s, verify_seconds=verify_s, claims_per_s=VRF_CLAIMS / verify_s,
        k3_launches=launches, honest=ok, forged_refused=forged_refused,
        verify_claims_false_at=false_at)
    if ok is not True or not forged_refused or false_at != [10, 40] or launches == 0:
        fail("6-vrf: a verdict is wrong or the batch launched no K3")


def _rsa_key(rng):
    """rsa.keygen's search, keeping p and q for CRT signing."""
    from cess_tpu_torch.ops import rsa

    while True:
        p = rsa._random_prime(RSA_BITS // 2, rng)
        q = rsa._random_prime(RSA_BITS // 2, rng)
        n = p * q
        if p != q and n.bit_length() == RSA_BITS:
            d = pow(rsa.F4, -1, (p - 1) * (q - 1))
            return rsa.RsaPrivateKey(n=n, e=rsa.F4, d=d), p, q


def _crt_signer(key, p: int, q: int):
    """PKCS#1 v1.5 SHA-256 signing by CRT: rsa.sign's bytes, 4x faster."""
    import hashlib

    from cess_tpu_torch.ops import rsa

    dp, dq, qinv = key.d % (p - 1), key.d % (q - 1), pow(q, -1, p)
    size = (key.n.bit_length() + 7) // 8

    def sign(message: bytes) -> bytes:
        em = rsa.emsa_pkcs1_v15(hashlib.sha256(message).digest(), size)
        m = int.from_bytes(em, "big")
        sp, sq = pow(m, dp, p), pow(m, dq, q)
        return (sq + q * (qinv * (sp - sq) % p)).to_bytes(size, "big")

    return sign


def phase_rsa(torch, dev, card: str) -> None:
    """6-rsa: batched RSA-2048 verification and IAS attestation."""
    import base64

    import numpy as np

    from cess_tpu_torch.ops import bigmod, rsa
    from cess_tpu_torch.proof import ias

    t_start = time.perf_counter()
    key, p, q = _rsa_key(random.Random(0x1A5))
    pub = key.public()
    sign = _crt_signer(key, p, q)
    if sign(b"probe") != rsa.sign(key, b"probe"):
        fail("6-rsa: CRT signing differs from rsa.sign")
    msgs = [b"smoke-ias-report-%04d" % i for i in range(RSA_SIGS)]
    pairs = [(m, sign(m)) for m in msgs]
    m, sig = pairs[5]
    pairs[5] = (m, sig[:-1] + bytes([sig[-1] ^ 1]))  # tampered
    pairs[6] = (pairs[6][0], pairs[6][1][:-1])  # wrong length
    pairs[7] = (pairs[7][0], (pub.n + 5).to_bytes(pub.size_bytes, "big"))  # s ≥ n
    setup_s = time.perf_counter() - t_start

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = rsa.verify_batch(pub, pairs)
    verify_s = time.perf_counter() - t0
    want = [rsa.verify(pub, m, s) for m, s in pairs]
    if got != want or got.count(False) != 3:
        fail(f"6-rsa: batch verdicts differ from rsa.verify at "
             f"{[i for i, (a, b) in enumerate(zip(got, want)) if a != b]}")

    # the modexp alone: every value against pow, the card's limbs against
    # the plain tensor path's on the CPU for 64 lanes, device time
    ctx = bigmod.ModContext.create(pub.n)
    sigs = [int.from_bytes(s, "big") for _, s in pairs]
    sigs[6], sigs[7] = 0, pub.n - 1
    limbs = torch.as_tensor(ctx.to_device_limbs(sigs), device=dev)
    modexp = bigmod.make_modexp_65537(ctx)
    out = modexp(limbs)
    if ctx.from_device_limbs(out) != [pow(s, rsa.F4, pub.n) for s in sigs]:
        fail("6-rsa: modexp values differ from pow(s, 65537, n)")
    cpu_limbs = modexp(limbs[:64].cpu()).numpy()
    if not np.array_equal(out[:64].cpu().numpy(), cpu_limbs):
        fail("6-rsa: modexp limbs on the card differ from the CPU's")
    modexp_ms = _time_ms(torch, lambda: modexp(limbs), 3)
    nl = ctx.nlimbs
    # 17 products, each (nl+2)² limb products and four folds: one of the
    # nl + 8 high limbs, three of 2, each high limb nl multiply-adds
    imads = RSA_SIGS * 17 * ((nl + 2) ** 2 + nl * (nl + 8) + 3 * 2 * nl)
    say("6-rsa", card=card, key_bits=RSA_BITS, signatures=RSA_SIGS, setup_seconds=setup_s,
        verify_seconds=verify_s, verifies_per_s=RSA_SIGS / verify_s,
        false_at=[i for i, v in enumerate(got) if not v], verdicts_equal_host=True,
        modexp_values_equal_pow=True, modexp_limbs_equal_cpu_lanes=64,
        modexp_ms=modexp_ms, modexp_bound_ms=imads / IMAD_PER_S * 1e3,
        modexp_bound_by="operations", modexp_imads=imads, limbs=nl,
        pieces=-(-RSA_SIGS // max(1, bigmod.TEMP_BYTES // bigmod.lane_temp_bytes(nl))))

    # ---- IAS: reports signed by this key under a certificate from a
    # 2048-bit fixture authority, a bad signature, an untrusted issuer
    # and an expired certificate among them
    t0 = time.perf_counter()
    root_der, root_priv = ias.fixture_authority(random.Random(0x5EED), bits=RSA_BITS)
    roots = ias.RootStore.from_der([root_der])
    t = ias.FIXED_VERIFY_TIME

    def cert(issuer_cn, issuer_priv, not_after):
        return base64.b64encode(ias.build_certificate(
            "CESS Sim Report Signer", issuer_cn, pub, issuer_priv,
            not_before=t - 86400, not_after=not_after, serial=7))

    good = cert("CESS Sim Attestation Root", root_priv, t + 86400 * 365)
    rogue = rsa.keygen(1024, random.Random(0xBAD))
    untrusted = cert("Rogue Attestation Root", rogue, t + 86400 * 365)
    expired = cert("CESS Sim Attestation Root", root_priv, t - 1)
    reports = []
    for i in range(IAS_REPORTS):
        body = b'{"isvEnclaveQuoteStatus":"OK","id":%d}' % i
        reports.append((base64.b64encode(sign(body)), good, body))
    reports[3] = (base64.b64encode(bytes(b ^ 0xFF for b in base64.b64decode(reports[3][0]))),
                  good, reports[3][2])
    reports[9] = (reports[9][0], untrusted, reports[9][2])
    reports[20] = (reports[20][0], expired, reports[20][2])
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = ias.verify_attestation_batch(reports, roots)
    batch_s = time.perf_counter() - t0
    singles = [ias.verify_attestation(*r, roots) for r in reports]
    false_at = [i for i, v in enumerate(batch) if not v]
    say("6-ias", card=card, reports=IAS_REPORTS, authority_bits=RSA_BITS, setup_seconds=setup_s,
        batch_seconds=batch_s, reports_per_s=IAS_REPORTS / batch_s, false_at=false_at,
        batch_equals_singles=batch == singles)
    if batch != singles or false_at != [3, 9, 20]:
        fail("6-ias: batch verdicts differ from verify_attestation or from [3, 9, 20]")


def phase_signatures(torch, dev, card: str) -> int:
    """Phase 6: BLS, VRF, RSA and IAS.  Returns K3's launches in one BLS
    batch check."""
    t0 = time.perf_counter()
    launches = phase_bls(torch, dev, card)
    phase_vrf(torch, dev, card)
    phase_rsa(torch, dev, card)
    say("6-done", card=card, seconds=time.perf_counter() - t0)
    return launches


# ------------------------------------------------------------ phase 7-sim

# tests/test_node_sim.py's scenario (:17-33 and its corruption loop):
# 5 miners, 3 validators, PoDR2 at 8 chunks × 4 sectors.  The chain
# accounts fillers at protocol scale (8 MiB), so alice's 1 GiB purchase
# needs 128 of them: 26 a miner is the fewest even split.  The cut is the
# PoDR2 geometry (not 1,024 × 265): tagging is pure-Python host work in
# both packages, about 30 ms a chunk, and would take hours at protocol
# geometry; phase 3 verifies at that geometry.
SIM_MINERS = 5
SIM_VALIDATORS = 3
SIM_FILLERS = 26
SIM_CHUNKS = 8
SIM_SECTORS = 4
# The state hash after each step of sim_steps, as cess_tpu's NodeSim
# reaches it on the CPU: the test holds both packages to these.
SIM_HASHES_FILE = "tests/test_torch_chain.py"


def sim_steps(sim):
    """The scenario on a NodeSim of either package.  Yields (step, info)
    after each step: genesis; setup (fillers, alice's purchase); upload
    (info: file hash and content, two segments); honest_round (info: the
    round's {miner: (idle_ok, service_ok)}); corrupt_round (info: the
    corrupted miner and the results of the first round that challenges
    it, its service fragments flipped bit for bit)."""
    yield "genesis", None
    for m in sim.miners:
        sim.miner_add_fillers(m, SIM_FILLERS)
    sim.add_user("alice")
    yield "setup", None
    content = bytes((i * 31 + 7) % 256 for i in range(sim.segment_bytes + 100))
    yield "upload", (sim.user_upload("alice", "holiday-pics", content), content)
    sim.rt.staking.end_era()  # fund the reward pool
    yield "honest_round", sim.run_audit_round()
    corrupted = next(m for m in sim.miners if sim.store[m].fragments)
    for frag in sim.store[corrupted].fragments.values():
        frag.data = bytes(b ^ 0xFF for b in frag.data)
    results = {}
    for _ in range(10):
        sim.rt.audit.challenge_snap_shot = None
        sim.rt.audit.challenge_duration = 0
        sim.rt.audit.verify_duration = 0
        sim.rt.next_block()
        results = sim.run_audit_round()
        if corrupted in results:
            break
    yield "corrupt_round", (corrupted, results)


def sim_hashes() -> dict:
    """STATE_HASHES of SIM_HASHES_FILE, read without importing it (the
    test imports the JAX package)."""
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).resolve().parent / SIM_HASHES_FILE).read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "STATE_HASHES" for t in node.targets):
            return ast.literal_eval(node.value)
    fail(f"no STATE_HASHES in {SIM_HASHES_FILE}")


def phase_sim(torch, dev, card: str) -> dict:
    """7-sim: NodeSim on the card through sim_steps.  Returns each
    kernel's launches in the two audit rounds."""
    from cess_tpu_torch.chain import checkpoint
    from cess_tpu_torch.chain.node import NodeSim
    from cess_tpu_torch.ops.podr2 import Podr2Params

    want = sim_hashes()
    counters = _kernel_counters()
    t_start = t0 = time.perf_counter()
    sim = NodeSim(SIM_MINERS, SIM_VALIDATORS,
                  params=Podr2Params(n=SIM_CHUNKS, s=SIM_SECTORS))
    if sim.backend.name != "torch" or sim.device.type != "cuda":
        fail(f"7-sim: NodeSim runs {sim.backend.name} on {sim.device}")
    seconds, hashes, results = {"init": time.perf_counter() - t0}, {}, {}
    steps = sim_steps(sim)
    recovered = None
    t0 = time.perf_counter()
    for step, info in steps:
        seconds[step] = time.perf_counter() - t0
        hashes[step] = checkpoint.state_hash(sim.rt)
        if step == "upload":
            file_hash, content = info
            recovered = sim.recover_file(file_hash) == content
            # the rounds come next: count their launches
            torch.cuda.synchronize()
            for f in counters.values():
                f.launches = 0
        elif step == "honest_round":
            results[step] = info
        elif step == "corrupt_round":
            torch.cuda.synchronize()
            launches = {k: f.launches for k, f in counters.items()}
            results[step] = {"corrupted": info[0], "results": info[1]}
        t0 = time.perf_counter()
    equal = {k: hashes[k] == want.get(k) for k in hashes}
    say("7-sim", card=card, miners=SIM_MINERS, validators=SIM_VALIDATORS,
        fillers_a_miner=SIM_FILLERS, params=[SIM_CHUNKS, SIM_SECTORS],
        cut="PoDR2 geometry 1024 x 265 -> 8 x 4: pure-Python tagging, in both packages",
        step_seconds=seconds, seconds=time.perf_counter() - t_start,
        verify_stage_seconds=sim.backend.stage_seconds, state_hashes=hashes,
        hashes_equal_cpu=equal, results=results, recover_equal=recovered,
        launches_in_rounds=launches)
    honest = results["honest_round"]
    corrupted = results["corrupt_round"]
    if not honest or any(v != (True, True) for v in honest.values()):
        fail(f"7-sim: honest round {honest}")
    if corrupted["results"].get(corrupted["corrupted"]) != (True, False):
        fail(f"7-sim: corrupted round {corrupted}")
    if not recovered:
        fail("7-sim: recover_file differs from the upload")
    if not all(equal.values()):
        fail(f"7-sim: state hashes differ from {SIM_HASHES_FILE}: {equal}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"7-sim: the audit rounds launched no {missing}")
    return launches


# ------------------------------------------------------------ phase 8-node

# tests/test_zz_sync_testnet.py's scenario on the port: its spec
# (build_spec_file), three validator processes and the roles played over
# RPC from this process.  A fourth process runs as a keyless `--replica`,
# which the light client reads from: a validator serves proofs at its
# head, which has moved past any finalized anchor.
NODE_VALIDATORS = ("alice", "bob", "charlie")
NODE_BLOCK_MS = 500
NODE_CHUNKS = 8
NODE_SECTORS = 4
NODE_HOST = "127.0.0.1"
# The fleet report after the light read: samples, and new blocks across
# them; then the read load on the replica, clients x proof-batch reads.
FLEET_SAMPLES = 3
FLEET_BLOCKS = 2
LOAD_CLIENTS = 2
LOAD_READS = 10


def _node_spec_file(path) -> str:
    from cess_tpu_torch.node.chain_spec import _spec

    spec = _spec("e2e", "CESS-TPU Sync E2E",
                 accounts=[*NODE_VALIDATORS, "miner-0", "tee-stash", "tee-ctrl"],
                 validators=list(NODE_VALIDATORS), block_time_ms=NODE_BLOCK_MS)
    spec.finality_period = 4
    spec.genesis = {"one_day_block": 20, "podr2_chunk_count": NODE_CHUNKS,
                    "era_duration_blocks": 4}
    out = path / "e2e-spec.json"
    out.write_text(spec.to_json())
    return str(out)


def _free_ports(n: int) -> list[int]:
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind((NODE_HOST, 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _wait_for(pred, timeout: float, what: str, poll: float = 0.4):
    """pred()'s first truthy value; fails the phase after `timeout` s.
    A node that is down or busy answers with an error: that counts as
    not yet."""
    from cess_tpu_torch.node.rpc import RpcError

    t0 = time.monotonic()
    while True:
        try:
            value = pred()
        except (OSError, RpcError):
            value = None
        if value:
            return value
        if time.monotonic() - t0 > timeout:
            fail(f"8-node: timed out after {timeout:.0f} s waiting for {what}")
        time.sleep(poll)


def phase_node(torch, card: str) -> dict:
    """8-node: three `python -m cess_tpu_torch run` validators (no --device,
    so on the card) and a replica; the TEE, its stash and a miner from the
    port play the audit round over RPC with TorchBackend() on the card.
    Returns each kernel's launches around the prove and the verify."""
    import tempfile
    from pathlib import Path

    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_node_", dir=root) as tmp:
        tmp = Path(tmp)
        spec_path = _node_spec_file(tmp)
        ports = _free_ports(len(NODE_VALIDATORS) + 1)
        procs: dict[str, subprocess.Popen] = {}
        logs: dict[str, Path] = {}
        try:
            for i, name in enumerate([*NODE_VALIDATORS, "replica"]):
                peers = ",".join(f"{NODE_HOST}:{p}" for p in ports[:3] if p != ports[i])
                role = ["--replica"] if name == "replica" else ["--authority", name]
                logs[name] = tmp / f"{name}.log"
                with open(logs[name], "w") as log:
                    procs[name] = subprocess.Popen(
                        [sys.executable, "-m", "cess_tpu_torch", "run", "--chain", spec_path,
                         "--rpc-port", str(ports[i]), "--peers", peers,
                         "--checkpoint-gap", "3", *role],
                        stdout=log, stderr=subprocess.STDOUT, cwd=root,
                    )
            return _node_run(torch, card, spec_path, ports, procs)
        except BaseException:
            for name, path in logs.items():
                tail = path.read_text(errors="replace").splitlines()[-15:] if path.exists() else []
                proc = procs.get(name)
                print(f"8-node log {name} (exit {proc and proc.poll()}):", *tail, sep="\n  ",
                      flush=True)
            raise
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
            for proc in procs.values():
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    pass


def _node_run(torch, card: str, spec_path: str, ports: list[int], procs: dict) -> dict:
    from cess_tpu_torch.chain.types import TOKEN
    from cess_tpu_torch.light import LightClient
    from cess_tpu_torch.node.chain_spec import load_spec
    from cess_tpu_torch.node.client import MinerClient, TeeClient
    from cess_tpu_torch.node.metrics import parse_exposition
    from cess_tpu_torch.node.rpc import rpc_call
    from cess_tpu_torch.ops import rs
    from cess_tpu_torch.ops.podr2 import Podr2Params
    from cess_tpu_torch.proof import TorchBackend, torch_backend

    params = Podr2Params(n=NODE_CHUNKS, s=NODE_SECTORS)
    vports, rport = ports[:3], ports[3]
    port0 = vports[0]

    def call(port, method, *params_):
        return rpc_call(NODE_HOST, port, method, list(params_), timeout=10.0)

    def status(port):
        return call(port, "sync_status")

    seconds = {}
    t_start = t0 = time.perf_counter()

    def step(name):
        nonlocal t0
        now = time.perf_counter()
        seconds[name] = round(now - t0, 3)
        t0 = now

    _wait_for(lambda: all(call(p, "system_name") for p in ports), 180, "every node's RPC")
    dead = [n for n, p in procs.items() if p.poll() is not None]
    if dead:
        fail(f"8-node: {dead} exited")
    step("nodes_up")
    _wait_for(lambda: min(status(p)["number"] for p in vports) >= 2, 120,
              "every validator past block 2")
    step("past_block_2")

    tee = TeeClient("tee-ctrl", chain_id="e2e", port=port0, timeout=60.0)
    stash = TeeClient("tee-stash", chain_id="e2e", port=port0, timeout=60.0)
    miner = MinerClient("miner-0", chain_id="e2e", port=port0, timeout=60.0)
    stash.submit("staking", "bond", "tee-ctrl", 100_000 * TOKEN)
    reg_hash = tee.register("tee-stash")

    def registration_receipt(port):
        head = status(port)["number"]
        for n in range(head, 0, -1):
            for r in call(port, "chain_getBlock", n)["receipts"]:
                if r["hash"] == reg_hash:
                    return r
        return None

    # the key lands with the registration's block; a fork that retracts
    # that block takes it out again until the extrinsic is re-included
    want_key = {"hex": tee.podr2_pk.hex()}
    _wait_for(lambda: all(call(p, "teeWorker_podr2Key") == want_key for p in vports), 90,
              "the TEE's PoDR2 key on every validator")
    receipts = {v: _wait_for(lambda p=p: registration_receipt(p), 30,
                             f"the TEE registration in a block on {v}")
                for v, p in zip(NODE_VALIDATORS, vports)}
    if not all(r["ok"] for r in receipts.values()):
        fail(f"8-node: TEE registration receipts {receipts}")
    step("tee_registration")

    miner.register("miner-0-ben", b"peer", 8000 * TOKEN)
    miner.create_fillers(tee, 2, params)
    _wait_for(lambda: miner.info()["idle_space"] > 0, 90, "the filler report on chain")
    step("fillers")

    def challenged():
        snap = miner.call("audit_challengeSnapshot")
        return snap is not None and any(
            s["miner"] == "miner-0" for s in snap["miner_snapshot_list"])

    _wait_for(challenged, 150, "the OCW-committed challenge")
    step("challenge")

    backend = TorchBackend()
    if backend.device.type != "cuda":
        fail(f"8-node: TorchBackend runs on {backend.device}")
    counters = _kernel_counters()
    torch.cuda.synchronize()
    for f in counters.values():
        f.launches = 0
    items = miner.answer_challenge(backend, params)
    if items is None:
        fail("8-node: the miner found no challenge to answer")
    torch.cuda.synchronize()
    step("prove")
    plane0 = _proof_plane()
    results = _wait_for(lambda: tee.verify_missions(backend, params, {"miner-0": items}),
                        120, "the verify mission")
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    plane1 = _proof_plane()
    # the round's own share of the process-wide proof plane, which phases
    # 3 to 3-profile filled before it
    round_plane = {k: plane1[k] - plane0[k] for k in plane1}
    round_plane["per_proof_ms"] = (round_plane["seconds"] / round_plane["proofs"] * 1e3
                                   if round_plane["proofs"] else None)
    step("verify")
    if results != {"miner-0": (True, True)}:
        fail(f"8-node: verdicts {results}")
    reward = _wait_for(
        lambda: (miner.call("sminer_rewardInfo", "miner-0") or {}).get(
            "currently_available_reward", 0), 90, "the audit reward")
    step("reward")

    def finalized_blocks():
        """(the lowest finalized head, every validator's block there) once
        it is >= 4 and every validator holds that block: a validator that
        warp-synced past it holds blocks from its anchor on only."""
        fin = min(status(p)["finalized"]["number"] for p in vports)
        return fin >= 4 and (fin, [call(p, "sync_block", fin) for p in vports])

    fin, blocks = _wait_for(finalized_blocks, 120, "a finalized head >= 4 on every validator")
    state_hashes = {b["block"]["stateHash"] for b in blocks}
    sigs = {b["block"]["sig"] for b in blocks}
    if len(state_hashes) != 1 or len(sigs) != 1:
        for v, p, b in zip(NODE_VALIDATORS, vports, blocks):
            fams = parse_exposition(call(p, "system_metrics"))
            say("8-node-split", node=v, status=status(p),
                block={k: b["block"].get(k) for k in ("number", "slot", "author", "parent",
                                                       "stateHash")},
                justification_signers=(b["justification"] or {}).get("signers"),
                reorgs=fams["cess_reorgs"].value(), warps=fams["cess_catchup_runs"].value())
        fail(f"8-node: at finalized height {fin}: {len(state_hashes)} state hashes, "
             f"{len(sigs)} block signatures (a finality split: see the 8-node-split lines)")
    step("finality")

    _wait_for(lambda: status(rport)["finalized"]["number"] >= fin, 120,
              "the replica's finalized head")
    lc = LightClient.from_spec(load_spec(spec_path), NODE_HOST, rport, timeout=15.0)
    anchor = lc.sync()
    present, account = lc.read("state", "balances.accounts", "miner-0")
    if anchor["number"] < fin or not present or lc.justifications_verified < 1:
        fail(f"8-node: light client anchor {anchor}, read {present} {account}")
    step("light_read")
    fleet, load = _fleet_and_load(spec_path, ports)
    step("fleet_report_and_load")
    for client in (miner, tee, stash):
        client.close()
    forks = {}
    for v, p in zip(NODE_VALIDATORS, vports):
        fams = parse_exposition(call(p, "system_metrics"))
        forks[v] = {"reorgs": fams["cess_reorgs"].value(),
                    "warps": fams["cess_catchup_runs"].value()}

    observed = {
        "cess_proof_checks": parse_exposition(
            torch_backend.proof_stage_registry().render())["cess_proof_checks"].value(),
        "cess_rs_streams_total": parse_exposition(
            rs.rs_stage_registry().render())["cess_rs_streams_total"].value(),
    }
    say("8-node", card=card, validators=list(NODE_VALIDATORS),
        block_ms=NODE_BLOCK_MS, params=[NODE_CHUNKS, NODE_SECTORS],
        step_seconds=seconds, seconds=round(time.perf_counter() - t_start, 3),
        registration_ok={v: r["ok"] for v, r in receipts.items()}, results=results,
        reward=reward, finalized=fin, state_hash=state_hashes.pop(), forks=forks,
        light_anchor=anchor["number"], light_read_present=present,
        verify_stage_seconds=backend.stage_seconds, launches_around_prove_verify=launches,
        observed_in_this_process=observed)
    say("8-node-fleet", card=card, round_proof_plane=round_plane, **fleet)
    say("8-node-load", card=card, **load)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"8-node: the prove and verify launched no {missing}")
    if not all(v > 0 for v in observed.values()):
        fail(f"8-node: this process observed no stage histograms: {observed}")
    if round_plane["checks"] < 1 or round_plane["pairings"] < 1:
        fail(f"8-node: the round's verify reached no combined check: {round_plane}")
    pairings = fleet["proof"].get("stages", {}).get("pairing", {}).get("count", 0)
    if fleet["unreachable_nodes"] or not fleet["fleet"]["blocks_per_s"] > 0 \
            or pairings < plane1["pairings"]:
        fail(f"8-node: fleet report: {fleet['unreachable_nodes']} unreachable, "
             f"{fleet['fleet']['blocks_per_s']} blocks/s, {pairings} pairings where this "
             f"process holds {plane1['pairings']} with the round's {round_plane['pairings']}")
    if load["errors"] or load["reads"] != LOAD_CLIENTS * LOAD_READS:
        fail(f"8-node: read load {load}")
    return launches


def _proof_plane() -> dict:
    """This process's proof data plane: the combined checks, the proofs
    they covered, their seconds and the pairing stage's count."""
    from cess_tpu_torch.node.metrics import parse_exposition
    from cess_tpu_torch.proof import torch_backend

    fams = parse_exposition(torch_backend.proof_stage_registry().render())
    return {"checks": fams["cess_proof_checks"].value(),
            "proofs": fams["cess_proofs_verified"].value(),
            "seconds": fams["cess_proof_verify_seconds_total"].value(),
            "pairings": fams["cess_proof_stage_pairing_seconds"].histogram()["count"]}


def _fleet_and_load(spec_path: str, ports: list[int]) -> tuple[dict, dict]:
    """The port's operator tools on the network: FleetCollector over the
    validators and the replica, sampled FLEET_SAMPLES times or more across
    FLEET_BLOCKS new blocks, with run_load's verifying light clients on
    the replica inside the window; the report merges this process's proof
    stage registry (the round's verify ran here).  Returns (the report,
    each node's entry cut to its samples and head, and the load)."""
    from cess_tpu_torch.node.chain_spec import load_spec
    from cess_tpu_torch.proof import torch_backend
    from tools.torch_read_loadgen import run_load
    from tools.torch_telemetry_report import FleetCollector

    collector = FleetCollector([(NODE_HOST, p) for p in ports], timeout=10.0)
    collector.sample()
    load = run_load([(NODE_HOST, ports[3])], load_spec(spec_path),
                    clients=LOAD_CLIENTS, reads=LOAD_READS, timeout=15.0)

    def moved():
        collector.sample()
        series = collector.samples.values()
        if not all(len(s) >= FLEET_SAMPLES for s in series):
            return False
        first = max(s[0]["health"].get("bestBlock", 0) for s in series)
        last = max(s[-1]["health"].get("bestBlock", 0) for s in series)
        return last - first >= FLEET_BLOCKS

    _wait_for(moved, 60, f"{FLEET_BLOCKS} new blocks in the fleet report's samples")
    report = collector.report(extra_registries=(torch_backend.proof_stage_registry(),))
    report["per_node"] = {label: {k: e[k] for k in ("unreachable", "samples", "bestBlock")}
                          for label, e in report["per_node"].items()}
    return report, load



# ------------------------------------------------------------ phase 9

# The mesh's ranks on the one card: four shards of every meshed batch,
# the sharding logic and not a multi-card measurement.
MESH_RANKS = 4
# Lanes of phase 9-mesh's signature checks (phase 6's cut is 2,048: the
# host hashes and decompresses in pure Python).
MESH_SIGS = 256
MESH_SUB = 64
# Phase 9-epoch: BASELINE config 5 at its 100,000 proofs, the rest cut.
EPOCH = {"n_proofs": 100_000, "n_segments": 64, "fragment_bytes": RS_FRAG,
         "n_signatures": 256, "n_headers": 600, "n_offences": 64}
EPOCH_CUTS = {"n_segments": "64 RS segments of 8 MiB fragments (1 GiB), from 1M",
              "n_signatures": "256 signatures (pure-Python signing and hashing)",
              "n_headers": "600 headers, one hour of 6 s slots, as 6-vrf",
              "n_offences": "64 offences"}


def _meshes(torch):
    from cess_tpu_torch.parallel import Mesh, make_mesh

    return {"1": make_mesh(), str(MESH_RANKS): Mesh((torch.device("cuda", 0),) * MESH_RANKS)}


def _count(counters) -> dict:
    return {k: f.launches for k, f in counters.items()}


def phase_mesh(torch, card: str, pk, items, params, config5) -> dict:
    """9-mesh: the meshed calls on a one-rank mesh from make_mesh() and a
    four-rank mesh on the one card — the staged verify with the μ
    combination sharded (all True, exactly one combined check, the
    combined check True and False alone, the tampered sub-batch
    isolated), combine_mu_sharded over an odd batch, msm_sharded against
    K3's msm, the signature verifiers (batch checks on four ranks, the
    bisections on one), and RS.  Returns the launches of
    the four-rank verify."""
    import numpy as np

    from cess_tpu_torch.consensus import vrf
    from cess_tpu_torch.ops import bls12_381 as bls
    from cess_tpu_torch.ops import bls_agg, fr, g1, podr2, rs
    from cess_tpu_torch.parallel import combine_mu_sharded, msm_sharded, pad_batch_rows
    from cess_tpu_torch.proof import TorchBackend, frontend

    t_start = time.perf_counter()
    meshes = _meshes(torch)
    counters = _kernel_counters()
    batch = len(items)
    sub = list(items[:64])
    nm, c, p = sub[17]
    sub[17] = (nm, c, podr2.Podr2Proof(p.sigma, [1] + p.mu[1:]))
    verify, launches = {}, {}
    for tag, mesh in meshes.items():
        backend = TorchBackend(mesh=mesh)
        for f in counters.values():
            f.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        verdicts = backend.verify_batch(pk, items, b"bench-seed", params)
        torch.cuda.synchronize()
        verify_s = time.perf_counter() - t0
        launches[tag] = _count(counters)
        stages = dict(backend.stage_seconds)
        if verdicts != [True] * batch:
            fail(f"9-mesh {tag} ranks: {verdicts.count(False)} of {batch} proofs rejected")
        if launches[tag] != STAGED_LAUNCHES:
            fail(f"9-mesh {tag} ranks: launches {launches[tag]}, one combined check gives "
                 f"{STAGED_LAUNCHES}")
        if backend._combined_check(pk, items, b"bench-seed", params) is not True:
            fail(f"9-mesh {tag} ranks: the combined check refused the honest batch")
        if backend._combined_check(pk, sub, b"bench-seed-2", params) is not False:
            fail(f"9-mesh {tag} ranks: the combined check passed the tampered sub-batch")
        t0 = time.perf_counter()
        v = backend.verify_batch(pk, sub, b"bench-seed-2", params)
        tampered_s = time.perf_counter() - t0
        if [i for i, x in enumerate(v) if not x] != [17]:
            fail(f"9-mesh {tag} ranks: tampered sub-batch verdicts {v}")
        verify[tag] = {"ranks": mesh.size, "verify_seconds": verify_s,
                       "proofs_per_s": batch / verify_s, "stage_seconds": stages,
                       "launches": launches[tag], "tampered_seconds": tampered_s}

    # the sharded μ combination over an odd batch, padded, against the
    # unmeshed contraction on random canonical limbs
    rng = np.random.default_rng(9)
    rows = batch - 1
    words = rng.integers(0, 1 << 32, size=(rows, params.s, 8), dtype=np.uint64).astype(np.uint32)
    words[..., 7] &= (1 << 26) - 1  # < 2^250 < r
    mu_limbs = fr.words_to_limbs(words, fr.LIMB_BITS, fr.NLIMBS)
    rhos = [int.from_bytes(rng.bytes(16), "little") | 1 for _ in range(rows)]
    four = meshes[str(MESH_RANKS)]
    want = fr.combine_mu(rhos, mu_limbs, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = combine_mu_sharded(four, pad_batch_rows(frontend.rho_limbs7(rhos), four.size),
                             pad_batch_rows(mu_limbs, four.size))
    combine_s = time.perf_counter() - t0
    if not np.array_equal(got, want):
        fail("9-mesh: combine_mu_sharded differs from fr.combine_mu")
    combine = {"rows": rows, "sectors": params.s, "ranks": four.size, "equal": True,
               "seconds": combine_s}

    # msm_sharded against K3's msm on the σ fold and config 5's
    sigmas = frontend.decompress_sigmas(items)
    encs = frontend.encode_proofs(items)
    srhos = podr2.batch_rho(podr2.batch_transcript(
        b"bench-seed", [podr2.BatchItem(n, c, p) for n, c, p in items], encodings=encs), batch)
    msm = {}
    for tag, mesh, pts, scs in [("sigma_fold_3072_1", meshes["1"], sigmas, srhos),
                                (f"sigma_fold_3072_{MESH_RANKS}", four, sigmas, srhos),
                                (f"config5_100000_{MESH_RANKS}", four, *config5)]:
        got, secs, _ = _msm_timed(torch, lambda: msm_sharded(mesh, pts, scs, bits=128))
        want, k3_s, _ = _msm_timed(torch, lambda: g1.msm(pts, scs, bits=128, device="cuda"))
        msm[tag] = {"lanes": len(pts), "ranks": mesh.size, "equal": got == want,
                    "msm_sharded_s": secs, "k3_msm_s": k3_s}
        if got != want:
            fail(f"9-mesh: msm_sharded differs from msm at {tag}")

    # the signature verifiers on the four-rank mesh
    keys = [bls.keygen(b"smoke-mesh-key-%d" % k) for k in range(BLS_KEYS)]
    pks = [bls.sk_to_pk(sk) for sk in keys]
    msgs = [b"smoke-mesh-msg-%06d" % i for i in range(MESH_SIGS)]
    sig_pts = g1.scalar_mul_batch([bls.hash_to_g1(m) for m in msgs],
                                  [keys[i % BLS_KEYS] for i in range(MESH_SIGS)], device="cuda")
    triples = [(pks[i % BLS_KEYS], m, q.to_bytes()) for i, (m, q) in enumerate(zip(msgs, sig_pts))]
    tampered = list(triples)
    at = MESH_SUB + MESH_SUB * 37 // 64  # inside the second sub-batch
    pk_, msg_, _ = tampered[at]
    tampered[at] = (pk_, msg_, triples[at + 1][2])
    sigs = {}
    t0 = time.perf_counter()
    sigs["honest"] = bls_agg.batch_verify_signatures(triples, b"smoke-mesh", mesh=four)
    sigs["honest_seconds"] = time.perf_counter() - t0
    sigs["tampered_refused"] = not bls_agg.batch_verify_signatures(tampered, b"smoke-mesh", mesh=four)
    # the bisections isolate on the one-rank mesh: each of their 13 checks
    # pays the plain-torch flat MSM once a rank
    one = meshes["1"]
    t0 = time.perf_counter()
    verdicts = bls_agg.verify_signatures(tampered[MESH_SUB:2 * MESH_SUB], b"smoke-mesh", mesh=one)
    sigs["bisection_seconds"] = time.perf_counter() - t0
    sigs["bisection_false_at"] = [i for i, v in enumerate(verdicts) if not v]
    vkeys = keys[:VRF_VALIDATORS]
    vmsgs = [vrf.vrf_input("cess-smoke-mesh", 1, b"\x22" * 32, slot) for slot in range(MESH_SUB)]
    claims = []
    for i, m in enumerate(vmsgs):
        out, proof = vrf.prove(vkeys[i % VRF_VALIDATORS], m)
        claims.append((pks[i % VRF_VALIDATORS], m, out, proof))
    vat = MESH_SUB * 23 // 64
    honest_claims = list(claims)
    claims[vat] = claims[vat][:2] + vrf.prove(bls.keygen(b"smoke-mesh-thief"), vmsgs[vat])
    t0 = time.perf_counter()
    sigs["vrf_honest"] = vrf.batch_verify(honest_claims, b"smoke-mesh", mesh=four)
    sigs["vrf_forged_refused"] = not vrf.batch_verify(claims, b"smoke-mesh", mesh=four)
    sigs["vrf_batch_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    verdicts = vrf.verify_claims(claims, b"smoke-mesh", mesh=one)
    sigs["vrf_seconds"] = time.perf_counter() - t0
    sigs["vrf_false_at"] = [i for i, v in enumerate(verdicts) if not v]
    if not (sigs["honest"] is True and sigs["tampered_refused"]
            and sigs["vrf_honest"] is True and sigs["vrf_forged_refused"]
            and sigs["bisection_false_at"] == [at - MESH_SUB] and sigs["vrf_false_at"] == [vat]):
        fail(f"9-mesh signature checks: {sigs}")

    # RS: one slab of 8 MiB fragments, both products, and a byte-axis run
    # over a width that is not a multiple of the ranks
    slab = rs.SLAB
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    data = torch.randint(0, 256, (slab, 2, RS_FRAG), dtype=torch.uint8, device="cuda",
                         generator=gen).cpu().numpy()
    wide = torch.randint(0, 256, (2, RS_FRAG + 3), dtype=torch.uint8, device="cuda",
                         generator=gen).cpu().numpy()
    code = rs.segment_code()
    parity = rs.RSStream(code).run_batch(data)
    surv = np.concatenate([data[:, 1:2], parity], axis=1)
    rec_plain = rs.RSStream(code, present=[1, 2]).run_batch(surv)
    wide_par = rs.RSStream(code).run(wide)
    wide_surv = np.concatenate([wide[:1], wide_par])
    rs_out = {"segments": slab, "fragment_bytes": RS_FRAG, "run_width": wide.shape[1],
              "path": code.path, "plain_reconstruct_equal_data": bool(np.array_equal(rec_plain, data))}
    for tag, mesh in meshes.items():
        t0 = time.perf_counter()
        checks = {
            "run_batch_encode": np.array_equal(rs.RSStream(code, mesh=mesh).run_batch(data), parity),
            "run_batch_reconstruct": np.array_equal(
                rs.RSStream(code, present=[1, 2], mesh=mesh).run_batch(surv), rec_plain),
            "reconstruct_batch": np.array_equal(
                code.reconstruct_batch(surv, [1, 2], mesh=mesh).cpu().numpy(), rec_plain),
            "run_encode": np.array_equal(rs.RSStream(code, mesh=mesh).run(wide), wide_par),
            "run_reconstruct": np.array_equal(
                rs.RSStream(code, present=[0, 2], mesh=mesh).run(wide_surv), wide),
        }
        rs_out[tag] = {k: bool(v) for k, v in checks.items()} | {
            "seconds": time.perf_counter() - t0}
        if not all(checks.values()):
            fail(f"9-mesh RS {tag} ranks: {checks}")
    if not rs_out["plain_reconstruct_equal_data"]:
        fail("9-mesh RS: the unmeshed reconstruction differs from the data")
    say("9-mesh", card=card, ranks={t: m.size for t, m in meshes.items()},
        note="the ranks share one card: a check of the sharding, not a multi-card measurement",
        verify=verify, combine_mu_sharded=combine, msm_sharded=msm, signatures=sigs,
        rs=rs_out, seconds=time.perf_counter() - t_start)
    return launches[str(MESH_RANKS)]


def phase_epoch(torch, card: str) -> dict:
    """9-epoch: run_epoch over make_mesh() at config 5's 100,000 proofs,
    every stage checked on the host; the rest cut (EPOCH_CUTS).  Returns
    the launches of the run."""
    from cess_tpu_torch.parallel import make_mesh, run_epoch

    mesh = make_mesh()
    counters = _kernel_counters()
    for f in counters.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = run_epoch(mesh, check=True, **EPOCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _count(counters)
    flags = {k: getattr(report, k) for k in
             ("rs_ok", "combine_ok", "sigma_ok", "bls_ok", "vrf_ok", "offences_ok")}
    say("9-epoch", card=card, ranks=mesh.size, ok=report.ok, flags=flags,
        proofs=report.proofs, segments=report.segments, rs_bytes=report.rs_bytes,
        signatures=report.signatures, headers=report.headers, offences=report.offences,
        n_challenged=5, n_sectors=3, cuts=EPOCH_CUTS, stage_seconds=report.seconds,
        wall_seconds=wall, launches=launches)
    if not report.ok or not all(flags.values()):
        fail(f"9-epoch: {flags}")
    return launches


if __name__ == "__main__":
    main()
