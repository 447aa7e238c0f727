"""Micro-benchmark of the PyTorch port's verify host front end at a batch size.

The port's counterpart of tools/bench_frontend.py: the same items from
the same seed (distinct valid σ points drawn from 64 multiples of the
generator, random 248-bit μ vectors at `Podr2Params()`, s = 265), timed
through the port's vectorised front end (`proof/frontend.py`):

  * decompress_s      frontend.decompress_sigmas (subgroup test deferred)
  * transcript_rho_s  encode_proofs, then podr2.batch_transcript and
                      batch_rho
  * mu_pack_s         mu_words, mu_in_range and mu_limbs

host_total_s is their sum.  The deferred subgroup gate,
`proof/torch_backend.py::_subgroup_ok(points, device)`, is timed warm and
apart from the host total: on the card it is one K3 [r]-chain over the
batch ("device-chain"), on the CPU the host ladder a point
("host-ladder").  The route is read from what the gate did (whether K3
launched), never chosen here.

    python3 tools/torch_bench_frontend.py [--proofs N] [--device cpu]

Runs on the card unless `--device cpu` is given, and raises without one.
Prints one JSON line with tools/bench_frontend.py's keys; exits 1 when
the gate refuses the batch.  chip_smoke.py's phase 3-frontend calls
`bench_frontend` at B = 3,072.  Imports neither jax nor cess_tpu.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

DEFAULT_PROOFS = 1024
SEED = b"fe-seed"


def craft_items(b: int, params=None) -> list:
    """tools/bench_frontend.py's B items: (name, challenge, proof) with 47
    challenged chunks, σ cycling over 64 subgroup points, random μ."""
    from cess_tpu_torch.ops import bls12_381 as bls
    from cess_tpu_torch.ops import podr2
    from cess_tpu_torch.ops.podr2 import Challenge, Podr2Params

    params = params or Podr2Params()
    rnd = random.Random(0xF0E)
    indices = tuple(sorted(rnd.sample(range(params.n), 47)))
    challenge = Challenge(
        indices=indices, randoms=tuple(rnd.randbytes(20) for _ in indices)
    )
    sigma_pool = [
        bls.G1_GENERATOR.mul(1000 + 7 * i).to_bytes() for i in range(min(b, 64))
    ]
    items = []
    for i in range(b):
        mu = [rnd.getrandbits(248) for _ in range(params.s)]
        proof = podr2.Podr2Proof(sigma_pool[i % len(sigma_pool)], mu)
        items.append((b"fe-frag-%06d" % i, challenge, proof))
    return items


def bench_frontend(b: int = DEFAULT_PROOFS, device=None) -> tuple[dict, dict]:
    """Time the front end on `b` crafted proofs and the deferred gate on
    `device` (None: the card).  Returns (the JSON line's dict, the
    outputs: items, rhos, mu_limbs, the gate's verdict and its K3
    launches)."""
    from cess_tpu_torch.device import resolve_device
    from cess_tpu_torch.ops import g1, podr2
    from cess_tpu_torch.ops.podr2 import Podr2Params
    from cess_tpu_torch.proof import frontend
    from cess_tpu_torch.proof.torch_backend import _subgroup_ok

    dev = resolve_device(device)
    params = Podr2Params()
    items = craft_items(b, params)

    t0 = time.perf_counter()
    pts = frontend.decompress_sigmas(items)
    t_dec = time.perf_counter() - t0
    if pts is None:
        raise ValueError("a crafted σ failed to decompress")

    batch_items = [podr2.BatchItem(n, c, p) for n, c, p in items]
    t0 = time.perf_counter()
    encs = frontend.encode_proofs(items)
    rhos = podr2.batch_rho(
        podr2.batch_transcript(SEED, batch_items, encodings=encs), b
    )
    t_tr = time.perf_counter() - t0

    t0 = time.perf_counter()
    words = frontend.mu_words(encs, params.s)
    in_range = frontend.mu_in_range(words)
    mu_limbs = frontend.mu_limbs(words)
    t_mu = time.perf_counter() - t0
    if not in_range:
        raise ValueError("a crafted μ is out of range")

    total = t_dec + t_tr + t_mu
    out = {
        "b": b,
        "vectorized": True,
        "decompress_s": t_dec,
        "transcript_rho_s": t_tr,
        "mu_pack_s": t_mu,
        "host_total_s": total,
        "host_per_proof_ms": total / b * 1000,
    }

    _subgroup_ok(pts[:8], dev)  # warm at the floor shape
    _subgroup_ok(pts, dev)      # warm at the batch shape
    launches0 = g1.scalar_mul_ladder.launches
    t0 = time.perf_counter()
    ok = _subgroup_ok(pts, dev)  # a bool: the card has finished
    out["deferred_subgroup_s"] = time.perf_counter() - t0
    launches = g1.scalar_mul_ladder.launches - launches0
    out["subgroup_route"] = "device-chain" if launches else "host-ladder"
    return out, {"items": items, "rhos": rhos, "mu_limbs": mu_limbs,
                 "subgroup_ok": ok, "gate_launches": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--proofs", type=int, default=DEFAULT_PROOFS)
    ap.add_argument("--device", default=None,
                    help="cpu for the plain path (default: the card)")
    args = ap.parse_args(argv)
    out, outputs = bench_frontend(args.proofs, args.device)
    print(json.dumps(out), flush=True)
    return 0 if outputs["subgroup_ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
