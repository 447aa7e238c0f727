"""Read-plane load generator of the PyTorch port: verifying light clients.

The port's counterpart of tools/read_loadgen.py, bound to
`cess_tpu_torch.light.LightClient`, `cess_tpu_torch.node.chain_spec` and
`cess_tpu_torch.node.rpc`.  Every worker is a real light client: it
anchors on a verified justification first, then issues proof-batch reads
that it verifies against its own justified root, so the measured rate is
the rate of *verified* reads, not of blind RPC round trips.  Workers are
spread round-robin across the given endpoints.  Host code only: no
device is touched, and the replicas may be the port's or the JAX
package's (the wire forms are the same).

    python tools/torch_read_loadgen.py --replicas 127.0.0.1:19944,... \
        --chain local --clients 8 --reads 200

Also a library (`run_load`): chip_smoke.py's phase 8-node drives the
replica of its network with it.  Exits 1 when any read failed.  Imports
neither jax nor cess_tpu.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cess_tpu_torch.light import LightClient, LightClientError  # noqa: E402
from cess_tpu_torch.node.chain_spec import load_spec  # noqa: E402
from cess_tpu_torch.node.rpc import RpcError  # noqa: E402

# one proof-batch worth of reads per round trip: the whole-leaf
# surfaces every chain serves, present or provably absent
DEFAULT_READS = [
    ["staking", "validators", None],
    ["session", "keys", None],
    ["staking", "active_era", None],
    ["state", "balances.accounts", "alice"],
]


def run_load(
    endpoints: list[tuple[str, int]],
    spec,
    clients: int = 4,
    reads: int = 100,
    batch: list | None = None,
    timeout: float = 10.0,
) -> dict:
    """Run `clients` verifying light clients, `reads` proof-batch round
    trips each, spread round-robin over `endpoints`.  Returns
    {"endpoints", "clients", "reads", "verified_leaves", "errors",
    "seconds", "rps"}; rps counts only round trips whose every proof
    verified."""
    batch = batch if batch is not None else DEFAULT_READS
    norm = [(p, a, k) for p, a, k in batch]
    done = [0] * clients
    leaves = [0] * clients
    errors = [0] * clients

    def worker(idx: int) -> None:
        host, port = endpoints[idx % len(endpoints)]
        try:
            lc = LightClient.from_spec(spec, host, port, timeout=timeout)
            lc.sync()
        except (LightClientError, RpcError, OSError):
            errors[idx] = reads
            return
        for _ in range(reads):
            try:
                got = lc.read_batch(norm)
                done[idx] += 1
                leaves[idx] += len(got)
            except (LightClientError, RpcError, OSError):
                errors[idx] += 1

    threads = [
        threading.Thread(target=worker, args=(i,), daemon=True)
        for i in range(clients)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = max(1e-9, time.perf_counter() - t0)
    total = sum(done)
    return {
        "endpoints": [f"{h}:{p}" for h, p in endpoints],
        "clients": clients,
        "reads": total,
        "verified_leaves": sum(leaves),
        "errors": sum(errors),
        "seconds": round(elapsed, 4),
        "rps": round(total / elapsed, 2),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replicas", required=True,
                    help="comma-separated host:port replica endpoints")
    ap.add_argument("--chain", default="dev",
                    help="chain spec for the clients' trust anchors")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--reads", type=int, default=100,
                    help="proof-batch round trips per client")
    args = ap.parse_args(argv)

    endpoints = []
    for part in filter(None,
                       (p.strip() for p in args.replicas.split(","))):
        host, _, port = part.rpartition(":")
        endpoints.append((host or "127.0.0.1", int(port)))
    out = run_load(endpoints, load_spec(args.chain),
                   clients=args.clients, reads=args.reads)
    print(json.dumps(out, indent=2, sort_keys=True))
    return 0 if out["errors"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
