"""Profile of the PyTorch port's batch verify at protocol geometry.

The port's counterpart of tools/profile_verify.py, redesigned for the
card.  Three parts, one JSON line:

1. Component times.  Each step of the staged combined check
   (`proof/torch_backend.py::TorchBackend._combined_check` with
   fused=False) runs alone on that route's inputs, each ending in
   `torch.cuda.synchronize()` on the card:

     rho            batch_transcript + batch_rho   (JAX: batch_rho; the
                    proof encodings are made before the timer)
     mu_combine     fr.combine_mu                  (mu combine (fr))
     sigma_gate     _subgroup_ok, one K3 [r]-chain (no JAX component: the
                    deferred σ subgroup test)
     sigma_msm      g1.msm(σ, ρ, 128 bits)         (sigma MSM (flat B))
     host_xmd       h2c.u_for_pairs, native XMD    (host XMD (native))
     lanes_h2d      the XMD's lanes padded to a power of two and copied
                    to the card (no JAX component: the input side of
                    the device SSWU map)
     sswu_map       h2c._map_pairs_kernel, K1 with its K4 launch, on
                    those lanes                    (device SSWU map)
     grouped_h_msm  torch_backend.h_fold_grouped: v·h_eff digits, one K3
                    fold at 224 bits, its tree   (grouped H-MSM)
     rho_fold       g1.msm(H folds, ρ, 128 bits)   (rho fold MSM (flat B))
     u_msm          g1.msm(u_j, Σ_b ρ_b μ_bj)      (u-side MSM (s=265))
     pairing        bls.pairing_check              (pairing check)

   and the pairing's verdict (True on an honest batch).

2. The routes under torch.profiler.  `TorchBackend(device).verify_batch`
   (fused) and `TorchBackend(device, fused=False).verify_batch` (staged)
   run once warm, then once each under the profiler with the CPU and
   CUDA activities (on the CPU once more without it).  Each reports
   its wall ms, verdicts, K1-K4 launches
   (the kernel wrappers' own counts, read before and after the run) and
   stage seconds; on the card also the device busy ms as the UNION of
   the trace's device intervals (kernels, copies, fills: what overlaps
   on several streams counts once), the per-name sum of the same trace
   (chip_smoke.py's older method, which counts overlap twice), the idle
   share 1 - busy/wall and the eight largest device entries by name.
   The profiler must see device time on the card, or this raises.

3. The process-wide stage histograms (`proof_stage_registry`): each
   stage's count and sum, and the host_prep / (host_prep +
   dispatch_wait) overlap fraction, from the fused run's stage seconds
   and from the histograms.

    python3 tools/torch_profile_verify.py [--proofs B] [--device cpu]

B defaults to 3,072 proofs at `Podr2Params()` (1,024 chunks x 265
sectors, 47 challenged), chip_smoke.py's phase 3 batch, crafted as
tools/profile_verify.py crafts it.  `profile_verify` takes a ready batch:
chip_smoke.py's phase 3-profile passes phase 3's.  Runs on the card
unless `--device cpu` is given (the plain tensor path: no trace keys),
and raises without one.  Exits 1 unless every verdict is True.  Imports
neither jax nor cess_tpu.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

DEFAULT_PROOFS = 3072
SEED = b"bench-seed"
TOP_ENTRIES = 8


def craft_batch(b: int = DEFAULT_PROOFS, params=None, device=None) -> tuple:
    """tools/profile_verify.py's batch: B zero-μ proofs under one
    47-chunk challenge, σ_b = (Π_c H(name_b‖i_c)^{v_c})^sk.  Returns
    (pk, items, params)."""
    from cess_tpu_torch.device import resolve_device
    from cess_tpu_torch.ops import g1, podr2
    from cess_tpu_torch.ops.podr2 import Challenge, Podr2Params

    dev = resolve_device(device)
    params = params or Podr2Params()
    sk, pk = podr2.keygen(b"bench-tee")
    rnd = random.Random(0xBE7C)
    indices = tuple(sorted(rnd.sample(range(params.n), min(47, params.n))))
    challenge = Challenge(indices=indices, randoms=tuple(rnd.randbytes(20) for _ in indices))
    coeffs = challenge.coefficients()
    names = [b"bench-frag-%08d" % i for i in range(b)]
    k = len(indices)
    flat = podr2.chunk_points_batch([(nm, i) for nm in names for i in indices])
    inner = g1.msm_grouped([flat[j * k:(j + 1) * k] for j in range(b)], [coeffs] * b,
                           bits=160, device=dev)
    sigmas = g1.scalar_mul_batch(inner, [sk] * b, device=dev)
    items = [(nm, challenge, podr2.Podr2Proof(s.to_bytes(), [0] * params.s))
             for nm, s in zip(names, sigmas)]
    return pk, items, params


def interval_union(intervals) -> float:
    """Total length covered by (start, end) intervals, overlaps once."""
    total = 0.0
    end = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def kernel_counters() -> dict:
    """K1-K4's wrappers, each with its `launches` count."""
    from cess_tpu_torch.ops import g1, glv, h2c

    return {"K1": h2c._map_pairs_kernel, "K4": h2c._pow_c1,
            "K2": glv.glv_fold, "K3": g1.scalar_mul_ladder}


def component_times(pk, items, params, device, seed: bytes = SEED) -> tuple[dict, bool]:
    """The staged check's steps one at a time on `device`: ({step: ms},
    the pairing's verdict)."""
    import numpy as np
    import torch

    from cess_tpu_torch.ops import bls12_381 as bls
    from cess_tpu_torch.ops import fr, g1, h2c, podr2
    from cess_tpu_torch.ops.bls12_381 import G2Point
    from cess_tpu_torch.proof import frontend, torch_backend

    dev = torch.device(device)
    ms: dict[str, float] = {}

    def timed(name, fn):
        _sync(torch, dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(torch, dev)
        ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    B = len(items)
    pk_point = G2Point.from_bytes(pk)
    sigmas = frontend.decompress_sigmas(items)
    encs = frontend.encode_proofs(items)
    if sigmas is None or encs is None:
        raise ValueError("the batch does not decode")
    mu_limbs = frontend.mu_limbs(frontend.mu_words(encs, params.s))
    batch_items = [podr2.BatchItem(n, c, p) for n, c, p in items]

    rhos = timed("rho", lambda: podr2.batch_rho(
        podr2.batch_transcript(seed, batch_items, encodings=encs), B))
    exps = fr.limbs_to_ints(timed("mu_combine", lambda: fr.combine_mu(rhos, mu_limbs, dev)))
    gate = timed("sigma_gate", lambda: torch_backend._subgroup_ok(sigmas, dev))
    lhs = timed("sigma_msm", lambda: g1.msm(sigmas, rhos, bits=128, device=dev))

    names, name_ids, indices, counts = torch_backend.h_fold_pairs(items)
    u_limbs, sgn, exc = timed("host_xmd", lambda: h2c.u_for_pairs(
        names, name_ids, indices, podr2.H_DST))
    n = len(name_ids)
    m = 1 << max(0, (n - 1).bit_length())
    lanes = timed("lanes_h2d", lambda: [
        torch.as_tensor(np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, m - n)]), device=dev)
        for a in (u_limbs, sgn, exc)])
    hashed = timed("sswu_map", lambda: h2c._map_pairs_kernel(*lanes))
    inner = timed("grouped_h_msm", lambda: torch_backend.h_fold_grouped(items, counts, hashed))
    rhs = timed("rho_fold", lambda: g1.msm(inner, rhos, bits=128, device=dev))
    us = list(podr2.u_generators(params.s))
    rhs = rhs + timed("u_msm", lambda: g1.msm(us, exps, device=dev))
    verdict = timed("pairing", lambda: bls.pairing_check(
        [(lhs, -bls.G2_GENERATOR), (rhs, pk_point)]))
    return ms, bool(gate and verdict)


def _trace(torch, prof) -> tuple[dict, list]:
    """({device busy ms (the union of the device intervals), the per-name
    sum of the same trace, its largest entries}, [(device entry, ms)])."""
    from torch.autograd import DeviceType

    spans = [(e.time_range.start, e.time_range.end)
             for e in prof.events() if e.device_type == DeviceType.CUDA]
    rows = [(e.key.split("(")[0], e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not spans or not sum(t for _, t in rows):
        raise RuntimeError("the profiler recorded no device time on the card")
    return {
        "device_busy_ms": interval_union(spans) / 1e3,
        "device_sum_ms": sum(t for _, t in rows),
        "top_device_ms": dict(sorted(rows, key=lambda r: -r[1])[:TOP_ENTRIES]),
    }, rows


def run_traced(fn) -> tuple:
    """fn() on the card under torch.profiler (CPU and CUDA activities),
    ending in a synchronize: (its result, wall ms, `_trace`'s dict, the
    trace's per-name device rows)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return (out, wall_ms, *_trace(torch, prof))


def profile_route(backend, pk, items, params, seed: bytes = SEED) -> dict:
    """One warm verify_batch, then one more: under torch.profiler on the
    card, plainly on the CPU (where the plain tensor path's thousands of
    small ops would make a trace slow, and no device time is read).
    Returns the second run's wall ms, verdicts, launches and stage
    seconds, and on the card its trace and idle share."""
    import torch

    dev = backend.device

    def verify():
        return backend.verify_batch(pk, items, seed, params)

    _sync(torch, dev)
    t0 = time.perf_counter()
    warm = verify()
    _sync(torch, dev)
    warm_ms = (time.perf_counter() - t0) * 1e3

    backend.stage_seconds.clear()
    counters = kernel_counters()
    before = {k: f.launches for k, f in counters.items()}
    trace = {}
    if dev.type == "cuda":
        verdicts, wall_ms, trace, _ = run_traced(verify)
        trace["device_idle_share"] = 1 - trace["device_busy_ms"] / wall_ms
    else:
        t0 = time.perf_counter()
        verdicts = verify()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return {
        "all_true": all(warm) and all(verdicts),
        "warm_wall_ms": warm_ms,
        "wall_ms": wall_ms,
        "launches": {k: f.launches - before[k] for k, f in counters.items()},
        "stage_seconds": dict(backend.stage_seconds),
        **trace,
    }


def profile_verify(pk, items, params, device=None, seed: bytes = SEED) -> dict:
    """Component times, both routes under the profiler, and the stage
    histograms for one batch on `device` (None: the card)."""
    import torch

    from cess_tpu_torch.device import resolve_device
    from cess_tpu_torch.proof import TorchBackend, torch_backend

    dev = resolve_device(device)
    with torch.inference_mode():
        components, pairing_true = component_times(pk, items, params, dev, seed)
    routes = {
        "fused": profile_route(TorchBackend(device=dev), pk, items, params, seed),
        "staged": profile_route(TorchBackend(device=dev, fused=False), pk, items, params, seed),
    }
    torch_backend.proof_stage_registry()
    hists = {name: {"n": h.n, "sum_s": h.total}
             for name, h in sorted(torch_backend._stage_hists.items())}
    fused = routes["fused"]["stage_seconds"]
    # host_prep / (host_prep + dispatch_wait): the share of the fused
    # route's critical path that is host work; omitted where both are 0
    overlap = {
        key: host / (host + wait)
        for key, host, wait in (
            ("fused_run", fused.get("host_prep", 0.0), fused.get("dispatch_wait", 0.0)),
            ("histograms", hists["host_prep"]["sum_s"], hists["dispatch_wait"]["sum_s"]),
        )
        if host + wait
    }
    total = sum(components.values())
    return {
        "device": dev.type,
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "b": len(items),
        "params": [params.n, params.s],
        "components_ms": components,
        "components_sum_ms": total,
        "components_per_proof_ms": total / len(items),
        "components_pairing_true": pairing_true,
        "routes": routes,
        "stage_histograms": hists,
        "overlap_fraction": overlap,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--proofs", type=int, default=DEFAULT_PROOFS)
    ap.add_argument("--device", default=None,
                    help="cpu for the plain path (default: the card)")
    args = ap.parse_args(argv)
    pk, items, params = craft_batch(args.proofs, device=args.device)
    out = profile_verify(pk, items, params, device=args.device)
    if out["device"] == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    print(json.dumps(out), flush=True)
    ok = out["components_pairing_true"] and all(r["all_true"] for r in out["routes"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
