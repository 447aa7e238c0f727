"""The node layer of the port against the JAX package: a lockstep network
of two cess_tpu validators and one port validator agrees on every block,
state hash, receipt, finalized head and checkpoint blob, with blocks,
votes and justifications crossing packages in their JSON wire forms; the
chain specs are the same documents; a port node catches up from a
cess_tpu node over a real socket and restores a store a cess_tpu node
wrote; and the port's role clients drive a port node over RPC.  The
port's CLI (export and import with --device cpu, and its refusal to start
without a card) is tested in tests/test_torch_isolation.py.

Every port node runs on `device="cpu"` (the IAS check of a TEE
registration on the plain tensor path); the JAX package's nodes are host
code (tests/conftest.py keeps JAX on the CPU)."""

import pytest
import torch

from cess_tpu.node import chain_spec as jspec
from cess_tpu.node import service as jservice
from cess_tpu.node import sync as jsync
from cess_tpu.node.metrics import scoped_registry as jregistry
from cess_tpu.node.rpc import RpcServer as JRpcServer
from cess_tpu.node.store import BlockStore as JBlockStore
from cess_tpu_torch.chain.types import TOKEN
from cess_tpu_torch.node import (
    MinerClient,
    RpcServer,
    SyncManager,
    TeeClient,
    UserClient,
    chain_spec,
    dev_spec,
)
from cess_tpu_torch.node import service as pservice
from cess_tpu_torch.node import sync as psync
from cess_tpu_torch.node.chain_spec import dev_sk
from cess_tpu_torch.node.client import make_dev_attestation
from cess_tpu_torch.node.metrics import scoped_registry
from cess_tpu_torch.node.rpc import RpcError
from cess_tpu_torch.node.store import BlockStore
from cess_tpu_torch.ops import bls12_381 as bls
from cess_tpu_torch.ops import podr2

# Host code and tiny tensors: intra-op threads only cost wake-ups beside
# the other test workers.
torch.set_num_threads(1)

# One package per validator: the port's node authors and imports beside
# two of the JAX package's.
PACKAGES = {"alice": "jax", "bob": "jax", "charlie": "port"}
_MODS = {"jax": (jservice, jsync), "port": (pservice, psync)}


def make_spec(pkg: str):
    """local_spec at 50 ms blocks and a finality period of 4 (test_zz_sync's
    make_spec), in `pkg`'s own ChainSpec class."""
    spec = (jspec if pkg == "jax" else chain_spec).local_spec()
    spec.block_time_ms = 50
    spec.finality_period = 4
    return spec


def make_node(pkg: str, spec, authority):
    if pkg == "jax":
        return jservice.NodeService(spec, authority=authority, registry=jregistry())
    return pservice.NodeService(spec, authority=authority, registry=scoped_registry(),
                                device="cpu")


def cross(obj, pkg: str, kind: str):
    """`obj` (a Block, Vote or Justification of either package) as `pkg`'s
    class, through its JSON wire form."""
    return getattr(_MODS[pkg][1], kind).from_json(obj.to_json())


def signed_json(genesis: str, nonces: dict, account: str, module: str, call: str,
                *args) -> dict:
    """A port-signed extrinsic's wire form (either package's pool takes it)."""
    nonce = nonces.get(account, 0)
    nonces[account] = nonce + 1
    ext = pservice.Extrinsic(signer=account, module=module, call=call,
                             args=list(args), nonce=nonce)
    return ext.sign(dev_sk(account, "local"), genesis).to_json()


class MixedLockstep:
    """test_zz_sync.py's Lockstep across packages: for each slot its owner
    authors and the two others import the block's JSON form."""

    def __init__(self):
        self.nodes = {v: make_node(pkg, make_spec(pkg), v) for v, pkg in PACKAGES.items()}
        self.slot = 0
        self.pending: list[dict] = []

    def step(self):
        self.slot += 1
        author = self.nodes["charlie"]._slot_author(self.slot)
        node = self.nodes[author]
        mod = _MODS[PACKAGES[author]][0]
        for ext in self.pending:
            node.submit_extrinsic(mod.Extrinsic.from_json(ext), gossip=False)
        self.pending = []
        rec = node.produce_block(slot=self.slot)
        assert rec is not None
        block = node.block_store[rec.hash]
        for name, other in self.nodes.items():
            if name != author:
                other.import_block(cross(block, PACKAGES[name], "Block"))

    def relay_finality(self):
        votes = [n._finality_tick() for n in self.nodes.values()]
        for v in filter(None, votes):
            for name, n in self.nodes.items():
                n.add_vote(cross(v, PACKAGES[name], "Vote"))
        best = max(self.nodes.values(), key=lambda n: n.finalized_number)
        just = best.justifications.get(best.finalized_number)
        assert just is not None
        for name, n in self.nodes.items():
            n.handle_justification(cross(just, PACKAGES[name], "Justification"))


@pytest.fixture(scope="module")
def mixed_net():
    net = MixedLockstep()
    genesis = net.nodes["charlie"].genesis
    nonces: dict = {}
    _, pbk = podr2.keygen(b"mixed-tee")
    node_key = bls.sk_to_pk(bls.keygen(b"mixed-tee-node"))
    net.pending = [
        signed_json(genesis, nonces, "tee-stash", "staking", "bond", "tee-ctrl",
                    100_000 * TOKEN),
        signed_json(genesis, nonces, "miner-0", "sminer", "regnstk", "miner-0-ben",
                    {"hex": b"peer".hex()}, 8000 * TOKEN),
    ]
    net.step()
    net.pending = [
        signed_json(genesis, nonces, "tee-ctrl", "tee_worker", "register", "tee-stash",
                    {"hex": node_key.hex()}, {"hex": b"tee-peer".hex()},
                    {"hex": pbk.hex()}, make_dev_attestation(pbk, "local")),
        signed_json(genesis, nonces, "alice", "oss", "register", {"hex": b"http://gw".hex()}),
    ]
    net.step()
    for _ in range(6):
        net.step()
    net.relay_finality()
    return net, pbk


def test_mixed_lockstep_agrees_on_every_block(mixed_net):
    net, _ = mixed_net
    nodes = list(net.nodes.values())
    assert all(n.rt.state.block_number == 8 for n in nodes)
    assert len({n.head_hash for n in nodes}) == 1
    assert len({n.state_hash() for n in nodes}) == 1


def test_mixed_lockstep_finalizes_across_packages(mixed_net):
    net, _ = mixed_net
    fins = {n.finalized_number for n in net.nodes.values()}
    assert len(fins) == 1 and fins.pop() >= 4
    for name, n in net.nodes.items():
        just = n.justifications[n.finalized_number]
        assert _MODS[PACKAGES[name]][1].verify_justification(
            just, n.genesis, list(n.spec.validators), n.keys)


def test_mixed_lockstep_receipts_match_and_registration_ran(mixed_net):
    net, pbk = mixed_net
    receipts = {name: [r.receipts for r in n.blocks] for name, n in net.nodes.items()}
    assert receipts["charlie"] == receipts["alice"] == receipts["bob"]
    flat = [r for block in receipts["charlie"] for r in block]
    assert len(flat) == 4 and all(r["ok"] for r in flat), flat
    # the TEE registration's IAS check ran on the port's node too
    assert net.nodes["charlie"].rt.tee_worker.tee_podr2_pk == pbk


def test_mixed_lockstep_export_state_is_byte_identical(mixed_net):
    net, _ = mixed_net
    blobs = {n.export_state() for n in net.nodes.values()}
    assert len(blobs) == 1


@pytest.mark.parametrize("preset", ["dev", "local"])
def test_chain_spec_json_equals_the_jax_package(preset):
    mine = chain_spec.PRESETS[preset]()
    ref = jspec.PRESETS[preset]()
    assert mine.to_json() == ref.to_json()
    assert mine.genesis_hash() == ref.genesis_hash()
    assert chain_spec.dev_ias_authority(preset)[0] == jspec.dev_ias_authority(preset)[0]


def _single_validator_chain(blocks: int):
    """test_zz_sync.py TestCatchUp.seed_chain: a cess_tpu chain whose only
    validator, alice, authors every slot it owns."""
    spec = make_spec("jax")
    spec.validators = ["alice"]
    head = make_node("jax", spec, "alice")
    slot = 0
    while head.rt.state.block_number < blocks:
        slot += 1
        if head._slot_author(slot) == "alice":
            head.produce_block(slot=slot)
    return spec, head


def test_port_node_catches_up_from_a_jax_node_over_rpc():
    spec, head = _single_validator_chain(6)
    server = JRpcServer(head, port=0)
    server.start()
    try:
        follower = make_node("port", chain_spec.ChainSpec.from_json(spec.to_json()), "bob")
        sync = SyncManager(follower, [(server.host, server.port)], checkpoint_gap=50)
        assert sync.catch_up() == 6
        assert follower.head_hash == head.head_hash
        assert follower.state_hash() == head.state_hash()
        assert follower.m_catchup.value == 0  # replay, no warp
    finally:
        server.stop()


def test_store_written_by_a_jax_node_restores_in_the_port(tmp_path):
    spec = make_spec("jax")
    writer = make_node("jax", spec, "alice")
    st = JBlockStore(str(tmp_path), registry=writer.registry, checkpoint_every=4)
    assert st.recover(writer)["rung"] == "cold"
    target = 6
    for _ in range(target * 8):
        if writer.head_number() >= target:
            break
        writer.produce_block()
    head, shash = writer.head_number(), writer.state_hash()
    assert head == target
    st.close()

    reader = make_node("port", make_spec("port"), "alice")
    st2 = BlockStore(str(tmp_path), registry=reader.registry, checkpoint_every=4)
    summary = st2.recover(reader)
    assert summary["rung"] in ("checkpoint", "checkpoint+replay")
    assert summary["head"] == head
    assert reader.state_hash() == shash
    assert reader.head_hash == writer.head_hash
    st2.close()


class TestRoleClientsOverRpc:
    """tests/test_node_service.py TestRpcAndClients against a port node."""

    @pytest.fixture()
    def node(self):
        service = pservice.NodeService(dev_spec(), registry=scoped_registry(), device="cpu")
        server = RpcServer(service, port=0)
        server.start()
        yield service, server
        server.stop()

    def test_registration_over_socket(self, node):
        service, server = node
        miner = MinerClient("miner-0", port=server.port)
        assert len(miner.register("miner-0-ben", b"peer-id", 8000 * TOKEN)) == 64
        service.produce_block()
        assert miner.info()["beneficiary"] == "miner-0-ben"
        assert miner.call("sminer_allMiners") == ["miner-0"]
        with pytest.raises(RpcError):
            miner.call("sminer_minerInfo", "nobody")
        assert "cess_blocks_produced 1" in miner.call("system_metrics")
        miner.close()

    def test_tee_registration_runs_the_ias_check(self, node):
        service, server = node
        tee = TeeClient("tee-ctrl", port=server.port)
        stash = TeeClient("tee-stash", port=server.port)
        stash.submit("staking", "bond", "tee-ctrl", 100_000 * TOKEN)
        service.produce_block()
        _, pbk = podr2.keygen(b"svc-tee")
        node_key = bls.sk_to_pk(bls.keygen(b"svc-tee-node"))
        tee.register("tee-stash", node_key, b"tee-peer", pbk, make_dev_attestation(pbk))
        rec = service.produce_block()
        assert rec.receipts[0]["ok"], rec.receipts
        assert service.rt.tee_worker.tee_podr2_pk == pbk
        assert tee.call("teeWorker_podr2Key") == {"hex": pbk.hex()}
        tee.close()
        stash.close()

    def test_user_flow_and_events(self, node):
        service, server = node
        user = UserClient("alice", port=server.port)
        user.submit("oss", "register", {"hex": b"http://gw".hex()})
        service.produce_block()
        events = user.call("state_getEvents", 5)
        assert any(e.get("name") == "OssRegister" for e in events)
        user.close()

