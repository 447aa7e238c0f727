"""The port's operator tools (tools/torch_*.py) against the JAX package's.

- The fleet reporter: tools/telemetry_report.py and the port's
  tools/torch_telemetry_report.py sample the same two in-process port
  nodes at the same points and build equal reports and markdown, apart
  from the clock keys named in CLOCK_KEYS; a dead node is marked, as
  tests/test_telemetry.py's case has it.
- The read load generator: tools/read_loadgen.py and the port's verify
  the same reads from the port's ReplicaService.
- The front-end bench: the port's ρ and μ limbs on the JAX tool's items
  equal cess_tpu's, under the JAX tool's JSON keys.
- The verify profile on the CPU at PoDR2 8 x 4: both routes all True,
  every stage name covered, no kernel launched (the plain tensor path).
- Without a card both device tools raise.

Everything runs on the CPU (`device="cpu"`); the JAX side is host code
and numpy, with no JAX compile."""

import os
import socket
import sys

import pytest
import torch

from cess_tpu.node import chain_spec as jspec
from cess_tpu.node.rpc import RpcServer as JRpcServer
from cess_tpu.node.service import NodeService as JNodeService
from cess_tpu_torch.light import ReplicaService
from cess_tpu_torch.node import service as pservice
from cess_tpu_torch.node.chain_spec import ChainSpec, dev_sk, local_spec
from cess_tpu_torch.node.metrics import scoped_registry
from cess_tpu_torch.node.rpc import RpcServer
from cess_tpu_torch.node.sync import Block, Justification

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools import read_loadgen as jloadgen  # noqa: E402
from tools import telemetry_report as jreport  # noqa: E402
from tools import torch_bench_frontend, torch_profile_verify  # noqa: E402
from tools import torch_read_loadgen as ploadgen  # noqa: E402
from tools import torch_telemetry_report as preport  # noqa: E402

# Host code and tiny tensors: intra-op threads only cost wake-ups beside
# the other test workers.
torch.set_num_threads(1)

# Report keys computed from the reader's clock: the moment the report was
# built.  (window_s is the caller's elapsed_s here, and every other number
# is read from the nodes, which both collectors scrape unchanged.)
CLOCK_KEYS = ("generated_at",)

# tools/bench_frontend.py's JSON keys.
FRONTEND_KEYS = {"b", "vectorized", "decompress_s", "transcript_rho_s", "mu_pack_s",
                 "host_total_s", "host_per_proof_ms", "deferred_subgroup_s",
                 "subgroup_route"}


# ------------------------------------------------------------ fleet reporter


def _port_node(spec, authority):
    return pservice.NodeService(spec, authority=authority, registry=scoped_registry(),
                                device="cpu")


def _author_block_with_extrinsic(spec, a):
    """tests/test_telemetry.py's author_block_with_extrinsic on a port node."""
    sk = dev_sk("alice", spec.chain_id)
    ext = pservice.Extrinsic(signer="alice", module="sminer", call="faucet_top_up",
                             args=[1000], nonce=a.nonces.get("alice", 0))
    ext.sign(sk, a.genesis)
    a.submit_extrinsic(ext)
    rec, slot = None, a.slot
    while rec is None:
        slot += 1
        rec = a.produce_block(slot=slot)
    return rec


def _without_clock(report: dict) -> dict:
    return {k: v for k, v in report.items() if k not in CLOCK_KEYS}


def test_fleet_reports_equal_the_jax_tools():
    spec = local_spec()
    a, b = _port_node(spec, spec.validators[0]), _port_node(spec, spec.validators[1])
    servers = [RpcServer(a, port=0), RpcServer(b, port=0)]
    for srv in servers:
        srv.start()
    try:
        nodes = [("127.0.0.1", srv.port) for srv in servers]
        collectors = [jreport.FleetCollector(nodes), preport.FleetCollector(nodes)]
        for c in collectors:
            c.sample()
        for _ in range(3):
            _author_block_with_extrinsic(spec, a)
            b.handle_announce(a.block_store[a.head_hash].to_json(),
                              trace=a.block_traces[a.head_hash])
            for c in collectors:
                c.sample()
        want, got = (c.report(elapsed_s=10.0) for c in collectors)
    finally:
        for srv in servers:
            srv.stop()
    assert _without_clock(got) == _without_clock(want)
    assert got["fleet"]["blocks_per_s"] > 0 and got["fleet"]["extrinsics_per_s"] > 0
    assert got["fleet"]["stitched_traces"] >= 1
    importer = got["per_node"][f"127.0.0.1:{servers[1].port}"]
    assert importer["importStages"]["execute"]["count"] >= 3
    stamp = {key: want[key] for key in CLOCK_KEYS}
    assert preport.to_markdown({**got, **stamp}) == jreport.to_markdown(want)


def test_fleet_report_survives_a_dead_node():
    """tests/test_telemetry.py::test_report_survives_dead_node on the port:
    the report builds, marks the dead node and keeps the survivor's
    totals."""
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    dead_port = probe.getsockname()[1]
    probe.close()
    spec = local_spec()
    a = _port_node(spec, spec.validators[0])
    srv = RpcServer(a, port=0)
    srv.start()
    try:
        collector = preport.FleetCollector(
            [("127.0.0.1", srv.port), ("127.0.0.1", dead_port)], timeout=1.0)
        collector.sample()
        _author_block_with_extrinsic(spec, a)
        collector.sample()
        report = collector.report(elapsed_s=5.0)
    finally:
        srv.stop()
    assert report["unreachable_nodes"] == 1
    live = report["per_node"][f"127.0.0.1:{srv.port}"]
    dead = report["per_node"][f"127.0.0.1:{dead_port}"]
    assert not live["unreachable"] and dead["unreachable"]
    assert dead["samples"] == 0
    assert live["blocksProduced"] >= 1
    assert report["fleet"]["blocks_per_s"] >= 0
    md = preport.to_markdown(report)
    assert "UNREACHABLE" in md and "survivors" in md


# ------------------------------------------------------------ read load


@pytest.fixture(scope="module")
def replica():
    """(cess_tpu spec, port spec, (host, port)): the port's keyless
    ReplicaService fed a cess_tpu dev chain of 6 blocks, finalized every
    second one (tests/test_torch_light.py's servers)."""
    spec = jspec.dev_spec()
    spec.finality_period = 2
    auth = JNodeService(spec)
    for _ in range(6):
        auth.produce_block()
        auth._finality_tick()
    pspec = ChainSpec.from_json(spec.to_json())
    rep = ReplicaService(pspec, device="cpu")
    rep.import_batch([Block.from_json(auth.block_by_number[n].to_json())
                      for n in range(1, auth.rt.state.block_number + 1)])
    rep.handle_justifications([Justification.from_json(auth.justifications[n].to_json())
                               for n in sorted(auth.justifications)])
    assert rep.finalized_number == 6
    srv = RpcServer(rep, port=0)
    srv.start()
    yield spec, pspec, (srv.host, srv.port)
    srv.stop()


def test_read_load_verifies_the_same_reads_as_the_jax_tool(replica):
    spec, pspec, endpoint = replica
    want = jloadgen.run_load([endpoint], spec, clients=2, reads=3)
    got = ploadgen.run_load([endpoint], pspec, clients=2, reads=3)
    for out in (want, got):
        assert out["errors"] == 0 and out["reads"] == 6
    assert got["verified_leaves"] == want["verified_leaves"] == 6 * len(ploadgen.DEFAULT_READS)
    assert ploadgen.DEFAULT_READS == jloadgen.DEFAULT_READS
    assert set(got) == set(want)


# ------------------------------------------------------------ front end


def test_front_end_bench_matches_cess_tpu():
    import random

    from cess_tpu.ops import bls12_381 as jbls
    from cess_tpu.ops import podr2 as jpodr2
    from cess_tpu.proof import frontend as jfrontend

    out, outputs = torch_bench_frontend.bench_frontend(8, device="cpu")
    assert set(out) == FRONTEND_KEYS
    assert out["b"] == 8 and out["subgroup_route"] == "host-ladder"
    assert outputs["subgroup_ok"] is True and outputs["gate_launches"] == 0

    # tools/bench_frontend.py's items (:44-58), built by cess_tpu
    params = jpodr2.Podr2Params()
    rnd = random.Random(0xF0E)
    indices = tuple(sorted(rnd.sample(range(params.n), 47)))
    challenge = jpodr2.Challenge(indices=indices,
                                 randoms=tuple(rnd.randbytes(20) for _ in indices))
    pool = [jbls.G1_GENERATOR.mul(1000 + 7 * i).to_bytes() for i in range(8)]
    items = [(b"fe-frag-%06d" % i, challenge,
              jpodr2.Podr2Proof(pool[i], [rnd.getrandbits(248) for _ in range(params.s)]))
             for i in range(8)]
    assert [(n, c.indices, c.randoms, p.encode()) for n, c, p in outputs["items"]] == \
        [(n, c.indices, c.randoms, p.encode()) for n, c, p in items]

    encs = jfrontend.encode_proofs(items)
    batch = [jpodr2.BatchItem(n, c, p) for n, c, p in items]
    want_rhos = jpodr2.batch_rho(jpodr2.batch_transcript(b"fe-seed", batch, encodings=encs), 8)
    assert outputs["rhos"] == want_rhos
    want_limbs = jfrontend.mu_limbs(jfrontend.mu_words(encs, params.s))
    assert outputs["mu_limbs"].dtype == want_limbs.dtype
    assert (outputs["mu_limbs"] == want_limbs).all()


# ------------------------------------------------------------ verify profile


@pytest.fixture(scope="module")
def profile():
    """torch_profile_verify on the CPU: B = 4 at PoDR2 8 x 4, the fused
    route in one chunk of 4 (a chunk pads to CHUNK proofs)."""
    from cess_tpu_torch.ops.podr2 import Podr2Params
    from cess_tpu_torch.proof import fused

    saved, fused.CHUNK = fused.CHUNK, 4
    try:
        pk, items, params = torch_profile_verify.craft_batch(4, Podr2Params(n=8, s=4),
                                                             device="cpu")
        return torch_profile_verify.profile_verify(pk, items, params, device="cpu")
    finally:
        fused.CHUNK = saved


def test_profile_routes_and_components_accept_the_batch(profile):
    assert profile["device"] == "cpu" and profile["b"] == 4
    assert profile["components_pairing_true"] is True
    assert set(profile["routes"]) == {"fused", "staged"}
    for r in profile["routes"].values():
        assert r["all_true"] is True
        # the plain tensor path launches no kernel, and no trace is read
        assert r["launches"] == {"K1": 0, "K4": 0, "K2": 0, "K3": 0}
        assert "device_busy_ms" not in r and "device_idle_share" not in r
    assert set(profile["components_ms"]) == {
        "rho", "mu_combine", "sigma_gate", "sigma_msm", "host_xmd", "lanes_h2d", "sswu_map",
        "grouped_h_msm", "rho_fold", "u_msm", "pairing"}


def test_profile_stages_cover_the_stage_names(profile):
    from cess_tpu.proof.xla_backend import STAGE_NAMES as JAX_STAGE_NAMES
    from cess_tpu_torch.proof.torch_backend import STAGE_NAMES

    assert STAGE_NAMES == JAX_STAGE_NAMES
    seen = set()
    for r in profile["routes"].values():
        seen |= set(r["stage_seconds"])
    assert seen == set(STAGE_NAMES)
    assert set(profile["stage_histograms"]) == set(STAGE_NAMES)
    assert all(h["n"] >= 1 for h in profile["stage_histograms"].values())
    assert 0 <= profile["overlap_fraction"]["fused_run"] <= 1


@pytest.mark.parametrize("spans, want", [
    ([], 0.0),
    ([(0.0, 2.0), (5.0, 6.0)], 3.0),
    ([(0.0, 4.0), (1.0, 2.0), (3.0, 6.0)], 6.0),   # nested and overlapping
    ([(3.0, 6.0), (0.0, 4.0), (6.0, 7.0)], 7.0),   # unsorted, touching
], ids=["empty", "disjoint", "overlap", "unsorted"])
def test_busy_time_is_the_union_of_device_intervals(spans, want):
    """Kernels that overlap on several streams count once, where the
    per-name sum counts them twice."""
    assert torch_profile_verify.interval_union(spans) == want
    assert torch_profile_verify.interval_union(spans) <= sum(b - a for a, b in spans)


# ------------------------------------------------------------ no card


@pytest.mark.parametrize("call", [
    lambda: torch_bench_frontend.bench_frontend(8),
    lambda: torch_profile_verify.craft_batch(4),
    lambda: torch_profile_verify.profile_verify(b"", [], None),
], ids=["bench_frontend", "craft_batch", "profile_verify"])
def test_device_tools_refuse_without_cuda(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
