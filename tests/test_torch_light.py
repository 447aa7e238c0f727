"""The port's light client and read replica against the JAX package: a
cess_tpu validator authors a finalizing chain; the port's keyless
ReplicaService follows it from the blocks' and justifications' JSON wire
forms, and the port's LightClient anchors on a verified justification and
reads provable state from that replica and from the cess_tpu node's own
RPC, and refuses a forged justification from either.

The replica runs on `device="cpu"`; tests/test_light.py is the JAX
package's own suite of the same surfaces."""

import pytest
import torch

from cess_tpu.node import chain_spec as jspec
from cess_tpu.node.rpc import RpcServer as JRpcServer
from cess_tpu.node.service import NodeService as JNodeService
from cess_tpu_torch.light import LightClient, LightClientError, ReplicaService
from cess_tpu_torch.node.chain_spec import ChainSpec
from cess_tpu_torch.node.rpc import RpcServer, rpc_call
from cess_tpu_torch.node.sync import Block, Justification

# Host code and tiny tensors: intra-op threads only cost wake-ups beside
# the other test workers.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def chain():
    """tests/test_light.py make_chain in cess_tpu: the dev spec's single
    validator authors 6 blocks and finalizes every second one."""
    spec = jspec.dev_spec()
    spec.finality_period = 2
    auth = JNodeService(spec)
    for _ in range(6):
        auth.produce_block()
        auth._finality_tick()
    assert auth.finalized_number == 6
    return ChainSpec.from_json(spec.to_json()), auth


@pytest.fixture(scope="module")
def servers(chain):
    """{"port-replica": (host, port), "jax-node": (host, port)}: a port
    ReplicaService fed the cess_tpu chain, and the cess_tpu author itself."""
    spec, auth = chain
    rep = ReplicaService(spec, device="cpu")
    blocks = [Block.from_json(auth.block_by_number[n].to_json())
              for n in range(1, auth.rt.state.block_number + 1)]
    assert [k for k, _ in rep.import_batch(blocks)] == ["imported"] * len(blocks)
    rep.handle_justifications([Justification.from_json(auth.justifications[n].to_json())
                               for n in sorted(auth.justifications)])
    assert rep.finalized_number == auth.finalized_number
    assert rep.read_plane.root_hex() == auth.block_by_number[6].state_hash
    running = [RpcServer(rep, port=0), JRpcServer(auth, port=0)]
    for srv in running:
        srv.start()
    yield {name: (srv.host, srv.port) for name, srv in zip(("port-replica", "jax-node"), running)}
    for srv in running:
        srv.stop()


@pytest.mark.parametrize("server", ["port-replica", "jax-node"])
def test_light_client_verifies_reads(chain, servers, server):
    spec, auth = chain
    host, port = servers[server]
    lc = LightClient.from_spec(spec, host=host, port=port)
    anchor = lc.sync()
    assert anchor["number"] == auth.finalized_number
    assert anchor["root"] == auth.block_by_number[anchor["number"]].state_hash
    assert lc.justifications_verified == 1
    present, validators = lc.read("staking", "validators")
    assert present and validators == spec.validators
    got = lc.read_batch([
        ("state", "balances.accounts", "alice"),
        ("state", "balances.accounts", "nobody-ever"),
    ])
    assert got[0][0] is True and got[1] == (False, None)


@pytest.mark.parametrize("server", ["port-replica", "jax-node"])
def test_light_client_refuses_a_forged_justification(chain, servers, server):
    spec, _ = chain
    host, port = servers[server]
    real = rpc_call(host, port, "chain_getJustification", [None])
    other = rpc_call(host, port, "chain_getJustification", [2])
    lc = LightClient.from_spec(spec, host=host, port=port)
    served = lc._call

    def forged(method, *params):
        if method == "chain_getJustification":
            return dict(real, agg=other["agg"])
        return served(method, *params)

    lc._call = forged
    with pytest.raises(LightClientError, match="refused"):
        lc.sync()
    assert lc.anchor is None and lc.justifications_verified == 0
