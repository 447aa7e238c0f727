"""The port's fused verify path (proof/fused.py through TorchBackend on
the CPU, where every kernel wrapper runs its plain twin) against the JAX
package's CpuBackend and its fused program, XlaBackend(fused=True), on
the verdict matrix of tests/test_fused.py and on a 3-chunk batch, plus
prove_batch bytes and the host front-end.

The fused XLA program runs with CHUNK = 1 and its tiles shrunk to 8
lanes, as tests/test_zz_fused_multichunk.py runs it: every call is then
a run of one-proof chunk programs of one lane shape (3 challenged pairs).
Its first trace takes about three minutes on one CPU core and every
later call of the module a few seconds, so the module keeps all of its
XLA calls in one process.  The ragged case alone (2 pairs per proof)
would need a second trace of almost two minutes; it is held against
CpuBackend here, and tests/test_fused.py holds XlaBackend(fused=True)
equal to CpuBackend on it."""

import random

import numpy as np
import pytest
import torch

from cess_tpu.ops import glv as jglv
from cess_tpu.ops import h2c as jh2c
from cess_tpu.ops import podr2 as jpodr2
from cess_tpu.proof import CpuBackend as JaxCpuBackend
from cess_tpu.proof import fused as jfused
from cess_tpu.proof.xla_backend import XlaBackend
from cess_tpu.proof.backend import ProveRequest as JaxProveRequest
from cess_tpu.proof import frontend as jfrontend
from cess_tpu_torch.ops import bls12_381 as bls
from cess_tpu_torch.ops import podr2
from cess_tpu_torch.ops.bls12_381 import R
from cess_tpu_torch.proof import CpuBackend, TorchBackend, fused, frontend
from cess_tpu_torch.proof.backend import ProveRequest

# The twins run thousands of tiny ops: with several test workers on one
# host, intra-op threads cost more in wake-ups than they save.
torch.set_num_threads(1)

PARAMS = podr2.Podr2Params(n=8, s=4)
SK, PK = podr2.keygen(b"fused-tee")


def challenge(mod, indices, seed=b"f"):
    randoms = tuple((seed + i.to_bytes(2, "little")).ljust(20, b"\x5a") for i in indices)
    return mod.Challenge(indices=tuple(indices), randoms=randoms)


def as_jax(items):
    """The same items built from the JAX package's host types."""
    return [
        (name, jpodr2.Challenge(ch.indices, ch.randoms),
         jpodr2.Podr2Proof(p.sigma, list(p.mu)))
        for name, ch, p in items
    ]


@pytest.fixture(scope="module")
def request3():
    ch = challenge(podr2, [0, 2, 5])
    names, datas, tags = [], [], []
    for k in range(3):
        names.append(f"fused-frag-{k}".encode())
        datas.append(bytes([(k * 31 + i) % 256 for i in range(PARAMS.fragment_bytes)]))
        tags.append(podr2.tag_fragment(SK, names[-1], datas[-1], PARAMS))
    return ProveRequest(names, tags, datas, ch, PARAMS)


@pytest.fixture(scope="module")
def proved(request3):
    proofs = [
        podr2.prove(t, d, request3.challenge, PARAMS)
        for t, d in zip(request3.tags, request3.data)
    ]
    return [(n, request3.challenge, p) for n, p in zip(request3.names, proofs)]


@pytest.fixture(autouse=True)
def small_chunk(monkeypatch):
    monkeypatch.setattr(fused, "CHUNK", 4)


def xla_fused_verdicts(items, seed):
    """XlaBackend(fused=True) on the same items, in one-proof chunks."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfused, "CHUNK", 1)
        mp.setattr(jh2c, "_MAP_TILE", 8)
        mp.setattr(jglv, "_GLV_TILE", 8)
        return XlaBackend(fused=True).verify_batch(PK, as_jax(items), seed, PARAMS)


def _with(items, i, proof):
    out = list(items)
    out[i] = (items[i][0], items[i][1], proof)
    return out


def _non_subgroup_sigma() -> bytes:
    p = bls.map_to_curve_g1(random.Random(11).getrandbits(300) % bls.P)
    assert not p.in_subgroup()
    raw = bytearray(p.x.to_bytes(48, "big"))
    raw[0] |= 0x80
    if p.y > bls.P - p.y:
        raw[0] |= 0x20
    return bytes(raw)


def _ragged():
    ch_a = challenge(podr2, [0, 3])
    ch_b = podr2.Challenge((1, 4, 6), (b"r1".ljust(20, b"\x01"), b"r2".ljust(20, b"\x02")))
    items = []
    for k, ch in ((0, ch_a), (1, ch_b)):
        name = f"ragged-{k}".encode()
        data = bytes([(k * 7 + i) % 256 for i in range(PARAMS.fragment_bytes)])
        tags = podr2.tag_fragment(SK, name, data, PARAMS)
        items.append((name, ch, podr2.prove(tags, data, ch, PARAMS)))
    return items


CASES = {
    "all_honest": (lambda it: it, b"round", [True] * 3),
    "one_bad_mu": (
        lambda it: _with(it, 1, podr2.Podr2Proof(it[1][2].sigma, [(it[1][2].mu[0] + 1) % R] + it[1][2].mu[1:])),
        b"round", [True, False, True]),
    "bad_sigma_encoding": (
        lambda it: _with(it, 0, podr2.Podr2Proof(b"\x00" * 48, list(it[0][2].mu))),
        b"round", [False, True, True]),
    "non_subgroup_sigma": (
        lambda it: _with(it, 2, podr2.Podr2Proof(_non_subgroup_sigma(), list(it[2][2].mu))),
        b"round", [True, True, False]),
    "mu_out_of_range": (
        lambda it: _with(it, 0, podr2.Podr2Proof(it[0][2].sigma, [R] + it[0][2].mu[1:])),
        b"round", [False, True, True]),
    "ragged_challenges": (lambda it: _ragged(), b"rag", [True, True]),
    "single_item": (lambda it: it[:1], b"one", [True]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_verdict_matrix_matches_jax_cpu_backend(proved, case):
    make, seed, want = CASES[case]
    items = make(proved)
    backend = TorchBackend(device="cpu")
    got = backend.verify_batch(PK, items, seed, PARAMS)
    ref = JaxCpuBackend().verify_batch(PK, as_jax(items), seed, PARAMS)
    assert got == ref == want
    if case != "ragged_challenges":
        assert xla_fused_verdicts(items, seed) == want
    stages = {"host_prep", "chunk_program", "dispatch_wait", "u_fold", "pairing"}
    assert set(backend.stage_seconds) <= stages
    if case == "all_honest":
        assert set(backend.stage_seconds) == stages


def test_three_one_proof_chunks_match_xla_fused(proved, monkeypatch):
    """The honest batch as three one-proof chunks in the port too: an odd
    chunk count, whose partials are padded to a power of two before the
    pairwise tree."""
    monkeypatch.setattr(fused, "CHUNK", 1)
    backend = TorchBackend(device="cpu")
    assert backend.verify_batch(PK, proved, b"round", PARAMS) == \
        xla_fused_verdicts(proved, b"round") == [True] * 3
    assert backend.stage_seconds["chunk_program"] > 0


def test_prove_batch_bytes_match_jax_cpu_backend(request3, proved):
    got = [p.encode() for p in TorchBackend(device="cpu").prove_batch(request3)]
    ref = JaxCpuBackend().prove_batch(JaxProveRequest(
        request3.names, request3.tags, request3.data,
        jpodr2.Challenge(request3.challenge.indices, request3.challenge.randoms),
        jpodr2.Podr2Params(n=PARAMS.n, s=PARAMS.s),
    ))
    assert got == [p.encode() for p in ref] == [p.encode() for _, _, p in proved]
    assert [p.encode() for p in CpuBackend().prove_batch(request3)] == got


def test_frontend_matches_jax(proved):
    items = proved
    jitems = as_jax(items)
    got = frontend.decompress_sigmas(items)
    want = jfrontend.decompress_sigmas(jitems)
    assert [(p.x, p.y) for p in got] == [(p.x, p.y) for p in want]
    encs = frontend.encode_proofs(items)
    assert encs == jfrontend.encode_proofs(jitems)
    np.testing.assert_array_equal(frontend.mu_words(encs, PARAMS.s), jfrontend.mu_words(encs, PARAMS.s))
    rhos = podr2.batch_rho(
        podr2.batch_transcript(b"round", [podr2.BatchItem(*it) for it in items], encodings=encs), 3
    )
    assert rhos == jpodr2.batch_rho(
        jpodr2.batch_transcript(b"round", [jpodr2.BatchItem(*it) for it in jitems], encodings=encs), 3
    )
    np.testing.assert_array_equal(frontend.rho_digits(rhos), jfrontend.rho_digits(rhos))
    np.testing.assert_array_equal(frontend.rho_limbs7(rhos), jfrontend.rho_limbs7(rhos))
