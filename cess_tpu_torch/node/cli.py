"""CLI — `python -m cess_tpu_torch <command>` (L6).

Role match: the reference's CLI (reference: node/src/cli.rs:1-70,
command.rs:55-90 — run, build-spec, export-state, import-blocks,
purge-chain) mapped onto this framework's service:

  run           start a node (chain spec, RPC port, optional block cap)
  build-spec    print a preset chain spec as JSON
  export-state  write the chain state checkpoint blob
  import-state  start from a checkpoint and print the state hash
  rpc           one-shot JSON-RPC call against a running node
  metrics       fetch a node's Prometheus metrics
  trace         render a stitched span trace (block #N or trace id),
                merging spans from several nodes (node/tracing.py)
  events        fetch one block's deposited events (chain_getEvents)
  proof         fetch + verify a Merkle state read proof (stateless:
                the only thing trusted is the root hash)

The port's copy of `cess_tpu/node/cli.py`.  `run`, `export-state` and
`import-state` take `--device` (default `cuda`: the node's TEE
registration checks IAS reports on the card; `cpu` is the plain tensor
path), and a node started without a card exits non-zero.  The JAX CLI's
`bench` command, which runs that package's bench.py, has no counterpart
here yet.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _parse_peers(arg: str) -> list[tuple[str, int]]:
    """--peers host:port,host:port → [(host, port), …]."""
    peers = []
    for part in filter(None, (p.strip() for p in arg.split(","))):
        host, _, port = part.rpartition(":")
        peers.append((host or "127.0.0.1", int(port)))
    return peers


def _cmd_run(args) -> int:
    from .chain_spec import load_spec
    from .rpc import RpcServer
    from .service import NodeService
    from .sync import SyncManager

    spec = load_spec(args.chain)
    if args.block_time_ms:
        spec.block_time_ms = args.block_time_ms
    if args.finality_period is not None:
        spec.finality_period = args.finality_period
    if args.replica:
        from ..light import ReplicaService

        if args.authority:
            print("--replica is keyless; ignoring --authority "
                  f"{args.authority}", file=sys.stderr)
        service = ReplicaService(
            spec,
            device=args.device,
            pool_max_count=args.pool_max_count,
            pool_max_bytes=args.pool_max_bytes,
            import_batch_max=args.import_batch_max,
        )
    else:
        service = NodeService(
            spec, authority=args.authority,
            device=args.device,
            pool_max_count=args.pool_max_count,
            pool_max_bytes=args.pool_max_bytes,
            import_batch_max=args.import_batch_max,
        )
    service.chaos_mute = bool(args.chaos_mute)
    faults = None
    spam = None
    if args.chaos_seed is not None:
        from .faults import PROFILES, FaultInjector, SpamDriver

        faults = FaultInjector(args.chaos_seed, args.chaos_profile)
        profile = PROFILES[args.chaos_profile]
        if profile.flood_accounts > 0:
            spam = SpamDriver(service, profile, seed=args.chaos_seed)
    store = None
    if args.data_dir:
        from .store import BlockStore

        # recovery ladder BEFORE any network plane exists: checkpoint
        # restore + journal replay need no peers; whatever is still
        # missing falls to catch-up/warp once the sync loop starts
        store = BlockStore(args.data_dir, registry=service.registry,
                           faults=faults)
        recovered = store.recover(service)
        print(f"store: data-dir={args.data_dir} "
              f"rung={recovered['rung']} "
              f"replayed={recovered['replayed']} "
              f"deduped={recovered['deduped']} "
              f"truncated={recovered['truncated']} "
              f"head=#{recovered['head']}", flush=True)
    if args.import_state:
        with open(args.import_state, "rb") as fh:
            service.import_state(fh.read())
    if args.peers:
        SyncManager(
            service, _parse_peers(args.peers),
            checkpoint_gap=args.checkpoint_gap,
            faults=faults,
        )
    server = RpcServer(service, host=args.rpc_host, port=args.rpc_port)
    server.start()
    chaos = (
        f" chaos={args.chaos_profile}/{args.chaos_seed}"
        if args.chaos_seed is not None else ""
    )
    print(
        f"cess-tpu-node: chain={spec.chain_id} rpc={server.host}:{server.port}"
        f" block_time={spec.block_time_ms}ms"
        f" peers={len(service.sync.peers) if service.sync else 0}"
        f"{' REPLICA (keyless read plane)' if args.replica else ''}"
        f"{chaos}{' MUTED' if args.chaos_mute else ''}",
        flush=True,
    )
    service.start()
    if spam is not None:
        spam.start()
        print(f"spam-driver: {len(spam.accounts)} accounts @ "
              f"{spam.profile.flood_rate}/s", flush=True)
    try:
        if args.blocks:
            while service.rt.state.block_number < args.blocks:
                time.sleep(0.05)
        else:
            while True:
                time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        if spam is not None:
            spam.stop()
        service.stop()
        if service.sync is not None:
            service.sync.stop()
        server.stop()
        if store is not None:
            store.close()
    print(
        f"stopped at block {service.rt.state.block_number} "
        f"finalized={service.finalized_number} "
        f"state={service.state_hash()[:16]}…",
        flush=True,
    )
    return 0


def _cmd_build_spec(args) -> int:
    from .chain_spec import load_spec

    print(load_spec(args.chain).to_json())
    return 0


def _cmd_export_state(args) -> int:
    from .chain_spec import load_spec
    from .service import NodeService

    service = NodeService(load_spec(args.chain), device=args.device)
    for _ in range(args.blocks):
        service.produce_block()
    blob = service.export_state()
    with open(args.output, "wb") as fh:
        fh.write(blob)
    print(f"exported {len(blob)} bytes at block "
          f"{service.rt.state.block_number}; state={service.state_hash()}")
    return 0


def _cmd_import_state(args) -> int:
    from .chain_spec import load_spec
    from .service import NodeService

    service = NodeService(load_spec(args.chain), device=args.device)
    with open(args.input, "rb") as fh:
        service.import_state(fh.read())
    print(f"imported: block={service.rt.state.block_number} "
          f"state={service.state_hash()}")
    return 0


def _cmd_rpc(args) -> int:
    from .rpc import rpc_call

    params = [json.loads(p) for p in args.params]
    result = rpc_call(args.host, args.port, args.method, params)
    print(json.dumps(result, indent=2, sort_keys=True))
    return 0


def _cmd_metrics(args) -> int:
    from .rpc import rpc_call

    sys.stdout.write(rpc_call(args.host, args.port, "system_metrics"))
    return 0


def _cmd_trace(args) -> int:
    from .rpc import RpcError, rpc_call
    from .tracing import render_trace

    ports = [int(p) for p in str(args.ports).split(",") if p]
    if args.target is None:
        # no target: list recent traces from the first REACHABLE node
        # (a node mid-restart must not crash the listing)
        for port in ports:
            try:
                summary = rpc_call(args.host, port, "system_traces", [])
            except (OSError, RpcError):
                continue
            for t in summary["traces"]:
                print(
                    f"{t['traceId']}  {t['root']:<18} "
                    f"spans={t['spans']:<4} "
                    f"{t['durationMs']:9.2f}ms  {t['tags']}"
                )
            return 0
        print("no reachable node", file=sys.stderr)
        return 1
    # resolve + merge: ask every node for its spans of the trace (a
    # block number resolves through each node's block→trace map; the
    # author and importers hold different spans of the SAME trace).
    # Nodes may resolve a block number to DIFFERENT ids (an envelope
    # dropped under chaos leaves an importer with a locally minted
    # id), so spans are grouped per id and the richest trace renders
    # — mixing two ids under one tree would hide exactly that
    # divergence.
    by_tid: dict[str, dict[tuple, dict]] = {}
    for port in ports:
        try:
            got = rpc_call(args.host, port, "system_traces",
                           [str(args.target)])
        except (OSError, RpcError):
            continue
        for s in got.get("spans", []):
            by_tid.setdefault(got["traceId"], {})[
                (s["node"], s["spanId"])] = s
    if by_tid:
        # nodes that resolved a block number already returned spans;
        # every node gets a second chance by each raw id (the author-
        # minted id is known to importers that adopted it)
        for trace_id in list(by_tid):
            for port in ports:
                try:
                    got = rpc_call(args.host, port, "system_traces",
                                   [trace_id])
                except (OSError, RpcError):
                    continue
                for s in got.get("spans", []):
                    by_tid[trace_id].setdefault(
                        (s["node"], s["spanId"]), s)
        best = max(by_tid, key=lambda t: len(by_tid[t]))
        print(render_trace(list(by_tid[best].values())))
        others = sorted(set(by_tid) - {best})
        if others:
            print(
                f"note: {len(others)} node(s) hold this block under "
                f"different trace id(s) {others} — the propagated "
                "envelope was lost on that path"
            )
    else:
        print(render_trace([]))
    return 0


def _cmd_events(args) -> int:
    from .rpc import rpc_call

    ref = args.block
    got = rpc_call(args.host, args.port, "chain_getEvents",
                   [int(ref) if str(ref).isdigit() else ref])
    print(json.dumps(got, indent=2, sort_keys=True))
    return 0


def _cmd_proof(args) -> int:
    """Stateless read verification: fetch a proof over RPC and check it
    against a state root with chain/checkpoint.py verify_read — no
    local chain state.  The root comes from --root (e.g. a justified
    header obtained out of band) or, for a connectivity smoke test
    only, from the node itself (state_getRoot) — the latter trusts the
    node, the former does not."""
    from ..chain.checkpoint import verify_read
    from ..chain.smt import ProofError
    from .rpc import RpcError, rpc_call

    key = json.loads(args.key) if args.key is not None else None
    host, port = args.host, args.port
    if args.rpc:
        h, _, p = args.rpc.rpartition(":")
        host, port = (h or "127.0.0.1"), int(p)
    if args.light:
        # fully stateless trust path: anchor on a verified justification
        # pulled from the replica, then verify the read against the
        # client's OWN justified root (light/client.py) — nothing the
        # server claims is believed
        from ..light import LightClient, LightClientError
        from .chain_spec import load_spec

        lc = LightClient.from_spec(load_spec(args.chain), host, port)
        try:
            anchor = lc.sync()
            present, value = lc.read(args.pallet, args.attr, key=key)
        except (LightClientError, RpcError, OSError) as e:
            print(f"INVALID: {e}", file=sys.stderr)
            return 1
        print(json.dumps({
            "root": anchor["root"],
            "rootSource": "justified (light client)",
            "anchor": {"number": anchor["number"],
                       "hash": anchor["hash"]},
            "justificationsVerified": lc.justifications_verified,
            "pallet": args.pallet,
            "attr": args.attr,
            "key": key,
            "present": present,
            "value": repr(value) if present else None,
        }, indent=2, sort_keys=True))
        return 0
    got = rpc_call(host, port, "state_getProof",
                   [args.pallet, args.attr, key])
    root = args.root if args.root else rpc_call(
        host, port, "state_getRoot")
    try:
        present, value = verify_read(
            root, args.pallet, args.attr, got["proof"], key=key)
    except ProofError as e:
        print(f"INVALID: {e}", file=sys.stderr)
        return 1
    print(json.dumps({
        "root": root,
        "rootSource": "argument" if args.root else "node (UNVERIFIED)",
        "pallet": args.pallet,
        "attr": args.attr,
        "key": key,
        "present": present,
        "value": repr(value) if present else None,
    }, indent=2, sort_keys=True))
    return 0


def _device_arg(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="where the node's device work runs: cuda "
                             "(the default; no card is an error) or cpu "
                             "(the plain tensor path)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cess_tpu_torch", description="CESS-TPU node CLI (PyTorch port)"
    )
    sub = p.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="run a node")
    run.add_argument("--chain", default="dev",
                     help="preset (dev/local) or spec JSON path")
    _device_arg(run)
    run.add_argument("--rpc-host", default="127.0.0.1")
    run.add_argument("--rpc-port", type=int, default=9944)
    run.add_argument("--authority", default=None,
                     help="author only this validator's slots")
    run.add_argument("--replica", action="store_true",
                     help="run a KEYLESS read replica (light/replica.py):"
                          " follows finality via batched justification "
                          "verification and serves read proofs against "
                          "the finalized root — never signs anything")
    run.add_argument("--blocks", type=int, default=0,
                     help="stop after N blocks (0 = run forever)")
    run.add_argument("--block-time-ms", type=int, default=0)
    run.add_argument("--import-state", default=None,
                     help="checkpoint blob to resume from")
    run.add_argument("--data-dir", default=None,
                     help="durable on-disk store (node/store.py): "
                          "write-ahead block journal + atomic "
                          "checkpoints; on restart the node recovers "
                          "from disk before touching the network")
    run.add_argument("--peers", default="",
                     help="comma-separated host:port RPC endpoints of "
                          "peer nodes (enables sync + finality gossip)")
    run.add_argument("--finality-period", type=int, default=None,
                     help="vote cadence in blocks (overrides spec)")
    run.add_argument("--checkpoint-gap", type=int, default=64,
                     help="catch-up gap above which a node bootstraps "
                          "from a peer checkpoint instead of replaying")
    run.add_argument("--chaos-seed", type=int, default=None,
                     help="enable deterministic fault injection on this "
                          "node's outbound gossip + catch-up RPC "
                          "(node/faults.py); same seed, same schedule")
    run.add_argument("--chaos-profile", default="mild",
                     choices=["off", "light", "mild", "hostile", "flood",
                              "baddisk"],
                     help="fault-probability profile for --chaos-seed "
                          "(flood adds synthetic spam-account load; "
                          "baddisk injects storage faults into "
                          "--data-dir writes)")
    run.add_argument("--import-batch-max", type=int, default=None,
                     help="most blocks folded into one weighted import "
                          "batch pairing (gossip drain, catch-up, "
                          "journal replay; default 64)")
    run.add_argument("--pool-max-count", type=int, default=None,
                     help="hard tx-pool transaction bound (default 2048)")
    run.add_argument("--pool-max-bytes", type=int, default=None,
                     help="hard tx-pool wire-byte bound (default 1 MiB)")
    run.add_argument("--chaos-mute", action="store_true",
                     help="skip im-online heartbeats (a deliberately "
                          "silent validator for liveness drills — it "
                          "gets chilled by the offences sweep)")
    run.set_defaults(fn=_cmd_run)

    bs = sub.add_parser("build-spec", help="print a chain spec")
    bs.add_argument("--chain", default="dev")
    bs.set_defaults(fn=_cmd_build_spec)

    ex = sub.add_parser("export-state", help="checkpoint the chain state")
    ex.add_argument("--chain", default="dev")
    ex.add_argument("--blocks", type=int, default=10)
    _device_arg(ex)
    ex.add_argument("output")
    ex.set_defaults(fn=_cmd_export_state)

    im = sub.add_parser("import-state", help="restore from a checkpoint")
    im.add_argument("--chain", default="dev")
    _device_arg(im)
    im.add_argument("input")
    im.set_defaults(fn=_cmd_import_state)

    rpc = sub.add_parser("rpc", help="one-shot RPC call")
    rpc.add_argument("--host", default="127.0.0.1")
    rpc.add_argument("--port", type=int, default=9944)
    rpc.add_argument("method")
    rpc.add_argument("params", nargs="*",
                     help="JSON-encoded positional params")
    rpc.set_defaults(fn=_cmd_rpc)

    met = sub.add_parser("metrics", help="fetch node metrics")
    met.add_argument("--host", default="127.0.0.1")
    met.add_argument("--port", type=int, default=9944)
    met.set_defaults(fn=_cmd_metrics)

    tr = sub.add_parser(
        "trace", help="render a stitched span trace across nodes")
    tr.add_argument("--host", default="127.0.0.1")
    tr.add_argument("--ports", default="9944",
                    help="comma-separated RPC ports to merge spans from")
    tr.add_argument("target", nargs="?", default=None,
                    help="trace id, block number, or block hash "
                         "(omit to list recent traces)")
    tr.set_defaults(fn=_cmd_trace)

    ev = sub.add_parser(
        "events", help="fetch one block's deposited events")
    ev.add_argument("--host", default="127.0.0.1")
    ev.add_argument("--port", type=int, default=9944)
    ev.add_argument("block", help="block number or hash")
    ev.set_defaults(fn=_cmd_events)

    pr = sub.add_parser(
        "proof", help="fetch + statelessly verify a state read proof")
    pr.add_argument("--host", default="127.0.0.1")
    pr.add_argument("--port", type=int, default=9944)
    pr.add_argument("--root", default=None,
                    help="hex state root to verify against (e.g. the "
                         "state_hash of a finalized header); omitted, "
                         "the node's own head root is used — which "
                         "trusts the node and only smoke-tests the "
                         "proof plumbing")
    pr.add_argument("--light", action="store_true",
                    help="verify as a stateless light client: anchor on "
                         "a justification verified against the spec's "
                         "validator keyset, then check the proof "
                         "against that justified root (trusts only "
                         "--chain genesis + keys, never the server)")
    pr.add_argument("--chain", default="dev",
                    help="chain spec for --light trust anchors "
                         "(genesis hash + initial validator keys)")
    pr.add_argument("--rpc", default=None,
                    help="host:port of the replica to query "
                         "(overrides --host/--port)")
    pr.add_argument("pallet", help='pallet name, e.g. "state"')
    pr.add_argument("attr",
                    help='attribute path, e.g. "balances.accounts"')
    pr.add_argument("key", nargs="?", default=None,
                    help="JSON-encoded map key (keyed surfaces only), "
                         'e.g. \'"alice"\'')
    pr.set_defaults(fn=_cmd_proof)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
