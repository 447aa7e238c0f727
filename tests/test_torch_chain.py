"""The chain and its multi-role simulator in the port against the JAX
package: one seeded scenario (chip_smoke.sim_steps, tests/test_node_sim.py's
own) runs in cess_tpu's NodeSim(backend="cpu") and in the port's
NodeSim(backend="torch", device="cpu"), and both reach the same state hash
after every step, the same per-miner verdicts, and the port restores a
cess_tpu snapshot to the same hash.

Size: 5 miners, 3 validators, PoDR2 at 8 chunks × 4 sectors, 26 fillers a
miner (130 × 8 MiB: the fewest even split that covers alice's 1 GiB, which
needs 128), one two-segment upload, two audit rounds.  Tagging is pure
Python, ~30 ms a chunk, 1,088 chunks in all, and the rounds read the tags
of the challenged miners only: each fragment's tags are computed by
cess_tpu's tag_fragment when a sim first reads them, once for both sims,
and the port's own tag_fragment is held to them on one filler and one
service fragment.  The port's verify runs the plain tensor twins of K1–K4
with fused.CHUNK at 26, so a miner's fillers are one chunk (the twins'
cost grows with the lanes a chunk pads to)."""

import copy
from collections.abc import Sequence

import pytest
import torch

import chip_smoke
from cess_tpu.chain import checkpoint as jcheckpoint
from cess_tpu.chain import node as jnode
from cess_tpu.ops import podr2 as jpodr2
from cess_tpu_torch.chain import checkpoint
from cess_tpu_torch.chain import node
from cess_tpu_torch.chain.runtime import Runtime
from cess_tpu_torch.ops import podr2
from cess_tpu_torch.proof import fused

# The twins run many tiny ops: with several test workers on one host,
# intra-op threads cost more in wake-ups than they save.
torch.set_num_threads(1)

# The state hash after each step of chip_smoke.sim_steps, as cess_tpu's
# NodeSim reaches it on the CPU.  chip_smoke.py phase 7-sim holds the
# port's run on the card to these.
STATE_HASHES = {
    "genesis": "4d35a6d302d147fbb33f5341b4c1bc08fe1f34092ec03a9eb156a9b1a12a26e9",
    "setup": "c6e67e3e997acbf9774a77e181ad6410111c834e1c66ea9ef99ffbdcba78829e",
    "upload": "fcf51dc8f23fb84de4473fbc8b6efba67fbeba2e07302a4e4765b49eef9a94be",
    "honest_round": "954317439cdbcbd5419a915b4dcad0a8a7d7702f5ec95eec9fd28bbb4d44e164",
    "corrupt_round": "895d2527bdb486351003c251ab4c26e58e6cb549b8484cc936d2b7d13da1bc39",
}


def _run(sim, state_hash, at_upload=None):
    """{step: (state hash, info)} over the scenario; `at_upload(sim,
    info)` runs between the upload and the first round."""
    out = {}
    for step, info in chip_smoke.sim_steps(sim):
        out[step] = (state_hash(sim.rt), info)
        if step == "upload" and at_upload is not None:
            at_upload(sim, info)
    return out


class _SharedTags(Sequence):
    """One fragment's tags from cess_tpu's tag_fragment, computed at the
    first read."""

    tag_fragment = staticmethod(jpodr2.tag_fragment)

    def __init__(self, *args):
        self._args, self._tags = args, None

    def _list(self) -> list[bytes]:
        if self._tags is None:
            self._tags = self.tag_fragment(*self._args)
        return self._tags

    def __getitem__(self, i):
        return self._list()[i]

    def __len__(self):
        return len(self._list())


@pytest.fixture(scope="module")
def runs():
    tags = {}

    def tag_and_keep(sk, name, data, params):
        tags[(name, data)] = _SharedTags(sk, name, data, params)
        return tags[(name, data)]

    recovered = {}

    def recover(sim, info):
        file_hash, content = info
        recovered["equal"] = sim.recover_file(file_hash) == content

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnode.podr2, "tag_fragment", tag_and_keep)
        jsim = jnode.NodeSim(
            chip_smoke.SIM_MINERS, chip_smoke.SIM_VALIDATORS, backend="cpu",
            params=jpodr2.Podr2Params(n=chip_smoke.SIM_CHUNKS, s=chip_smoke.SIM_SECTORS),
        )
        jax_run = _run(jsim, jcheckpoint.state_hash)

        mp.setattr(node.podr2, "tag_fragment",
                   lambda sk, name, data, params: tags[(name, data)])
        mp.setattr(fused, "CHUNK", chip_smoke.SIM_FILLERS)
        sim = node.NodeSim(
            chip_smoke.SIM_MINERS, chip_smoke.SIM_VALIDATORS, backend="torch",
            params=podr2.Podr2Params(n=chip_smoke.SIM_CHUNKS, s=chip_smoke.SIM_SECTORS),
            device="cpu",
        )
        port_run = _run(sim, checkpoint.state_hash, recover)
    return {"jax": jax_run, "port": port_run, "jsim": jsim, "sim": sim,
            "recovered": recovered}


@pytest.mark.parametrize("step", list(STATE_HASHES))
def test_state_hash_equal_after_each_step(runs, step):
    assert runs["jax"][step][0] == STATE_HASHES[step]
    assert runs["port"][step][0] == STATE_HASHES[step]


def test_chip_smoke_reads_these_hashes():
    """chip_smoke's phase reads its constants from this module."""
    assert chip_smoke.sim_hashes() == STATE_HASHES


def test_per_miner_results_equal(runs):
    honest = runs["port"]["honest_round"][1]
    assert honest == runs["jax"]["honest_round"][1]
    assert honest and all(v == (True, True) for v in honest.values())
    corrupted, results = runs["port"]["corrupt_round"][1]
    assert (corrupted, results) == runs["jax"]["corrupt_round"][1]
    assert results[corrupted] == (True, False)


def test_port_ran_the_fused_verify(runs):
    sim = runs["sim"]
    assert sim.backend.name == "torch" and sim.device.type == "cpu"
    assert sim._rs.device.type == "cpu"
    assert sim.backend.stage_seconds.get("chunk_program", 0) > 0


def test_honest_miners_rewarded_alike(runs):
    jrt, rt = runs["jsim"].rt, runs["sim"].rt
    for m in runs["port"]["honest_round"][1]:
        got = rt.sminer.reward_map[m].total_reward
        assert got == jrt.sminer.reward_map[m].total_reward > 0
        assert rt.state.balances.free(m) == jrt.state.balances.free(m)


def test_recover_file_after_upload(runs):
    assert runs["recovered"] == {"equal": True}


def test_port_tags_equal_the_reference(runs):
    """The port's own tag_fragment on one filler and one service fragment
    (of a miner left uncorrupted) gives the bytes the shared tags hold."""
    sim = runs["sim"]
    corrupted = runs["port"]["corrupt_round"][1][0]
    miner = next(m for m in sim.miners if sim.store[m].fragments and m != corrupted)
    store = sim.store[miner]
    for f in (next(iter(store.fillers.values())), next(iter(store.fragments.values()))):
        assert podr2.tag_fragment(sim.tee_sk, f.name, f.data, sim.params) == list(f.tags)


def test_restore_cess_tpu_snapshot(runs):
    """A cess_tpu snapshot blob restores into a fresh port Runtime to the
    same state hash (the function that carries state across)."""
    jrt = runs["jsim"].rt
    blob = jcheckpoint.snapshot(jrt)
    fresh = Runtime(copy.copy(runs["sim"].rt.config), device="cpu")
    checkpoint.restore(fresh, blob)
    assert checkpoint.state_hash(fresh) == jcheckpoint.state_hash(jrt)
    assert checkpoint.state_hash(fresh) == STATE_HASHES["corrupt_round"]
    assert checkpoint.snapshot(fresh) == blob
