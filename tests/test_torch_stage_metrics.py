"""The stage histograms of the port against the JAX package: the port's
process-wide `cess_proof_stage_*` / `cess_proof*` registry
(proof/torch_backend.py) and `cess_rs_*` registry (ops/rs.py) list the
same families as cess_tpu's, with the same help strings, types and
buckets; a combined check through TorchBackend(device="cpu") and an
RSStream pass on the CPU move the port's registries (and not the JAX
package's, which this process imports too); and a port node's
`system_metrics` over RPC carries both."""

import numpy as np
import pytest
import torch

from cess_tpu.ops import rs as jrs
from cess_tpu.proof import xla_backend as jxla
from cess_tpu_torch.node import RpcServer, dev_spec
from cess_tpu_torch.node.metrics import parse_exposition, scoped_registry
from cess_tpu_torch.node.rpc import rpc_call
from cess_tpu_torch.node.service import NodeService
from cess_tpu_torch.ops import podr2, rs
from cess_tpu_torch.proof import TorchBackend, fused, torch_backend

# The twins run thousands of tiny ops: with several test workers on one
# host, intra-op threads cost more in wake-ups than they save.
torch.set_num_threads(1)

PARAMS = podr2.Podr2Params(n=8, s=4)
PROOF_FAMILIES = [f"cess_proof_stage_{s}_seconds" for s in torch_backend.STAGE_NAMES] + [
    "cess_proofs_verified", "cess_proof_checks", "cess_proof_verify_seconds_total"]
RS_FAMILIES = [f"cess_rs_{s}_seconds" for s in rs.RS_STAGE_NAMES] + [
    "cess_rs_bytes_total", "cess_rs_streams_total", "cess_rs_seconds_total"]
# The marks a one-chunk fused check makes, as in cess_tpu/proof/fused.py:
# chunk_program once a chunk and once for the reduction of the chunk
# partials; sigma_fold belongs to the JAX package's staged path and stays
# at count 0 in both packages' fused checks.
FUSED_MARKS = {"host_prep": 1, "chunk_program": 2, "dispatch_wait": 1, "u_fold": 1,
               "pairing": 1, "sigma_fold": 0}


def families(registry) -> dict:
    return parse_exposition(registry.render())


def shape(fam) -> tuple:
    """A family's name, help, type and bucket bounds: everything but its
    values."""
    les = [s[1]["le"] for s in fam.samples if s[0].endswith("_bucket")]
    return fam.name, fam.help, fam.kind, les


def count(fams: dict, name: str) -> float:
    fam = fams[name]
    return fam.histogram()["count"] if fam.kind == "histogram" else fam.value()


@pytest.mark.parametrize("which", ["proof", "rs"])
def test_families_equal_the_jax_package(which):
    mine, ref = {
        "proof": (torch_backend.proof_stage_registry, jxla.proof_stage_registry),
        "rs": (rs.rs_stage_registry, jrs.rs_stage_registry),
    }[which]
    got, want = families(mine()), families(ref())
    assert list(got) == list(want) == (PROOF_FAMILIES if which == "proof" else RS_FAMILIES)
    for name in want:
        assert shape(got[name]) == shape(want[name])
    assert mine() is not ref()


@pytest.fixture(scope="module")
def proved():
    sk, pk = podr2.keygen(b"stage-tee")
    ch = podr2.Challenge((1, 6), (b"\x11" * 20, b"\x22" * 20))
    data = bytes(i % 251 for i in range(PARAMS.fragment_bytes))
    tags = podr2.tag_fragment(sk, b"stage-frag", data, PARAMS)
    return pk, [(b"stage-frag", ch, podr2.prove(tags, data, ch, PARAMS))]


def test_combined_check_moves_the_proof_stages(monkeypatch, proved):
    monkeypatch.setattr(fused, "CHUNK", 1)
    pk, items = proved
    before, ref_before = families(torch_backend.proof_stage_registry()), \
        families(jxla.proof_stage_registry())
    assert TorchBackend(device="cpu").verify_batch(pk, items, b"stage", PARAMS) == [True]
    after = families(torch_backend.proof_stage_registry())
    for stage, marks in FUSED_MARKS.items():
        name = f"cess_proof_stage_{stage}_seconds"
        assert count(after, name) == count(before, name) + marks, stage
    assert count(after, "cess_proof_checks") == count(before, "cess_proof_checks") + 1
    assert count(after, "cess_proofs_verified") == count(before, "cess_proofs_verified") + 1
    assert count(after, "cess_proof_verify_seconds_total") > \
        count(before, "cess_proof_verify_seconds_total")
    # the JAX package's registry is its own
    ref_after = families(jxla.proof_stage_registry())
    assert count(ref_after, "cess_proof_checks") == count(ref_before, "cess_proof_checks")


def test_rs_stream_moves_the_rs_stages():
    batch = np.random.default_rng(7).integers(0, 256, (3, 2, 4096), dtype=np.uint8)
    before = families(rs.rs_stage_registry())
    stream = rs.RSStream(rs.RSCode(2, 1, device="cpu"), slab=2)
    parity = stream.run_batch(batch)
    assert parity.shape == (3, 1, 4096)
    after = families(rs.rs_stage_registry())
    for stage in rs.RS_STAGE_NAMES:
        assert count(after, f"cess_rs_{stage}_seconds") > count(before, f"cess_rs_{stage}_seconds")
    assert count(after, "cess_rs_streams_total") == count(before, "cess_rs_streams_total") + 1
    assert count(after, "cess_rs_bytes_total") == count(before, "cess_rs_bytes_total") + batch.nbytes
    assert count(after, "cess_rs_seconds_total") > count(before, "cess_rs_seconds_total")


def test_system_metrics_over_rpc_carries_both_registries():
    service = NodeService(dev_spec(), registry=scoped_registry(), device="cpu")
    server = RpcServer(service, port=0)
    server.start()
    try:
        got = parse_exposition(rpc_call(server.host, server.port, "system_metrics", []))
    finally:
        server.stop()
    assert "cess_blocks_produced" in got
    for registry, names in ((torch_backend.proof_stage_registry(), PROOF_FAMILIES),
                            (rs.rs_stage_registry(), RS_FAMILIES)):
        mine = families(registry)
        for name in names:
            assert shape(got[name]) == shape(mine[name])
            assert count(got, name) == count(mine, name)
