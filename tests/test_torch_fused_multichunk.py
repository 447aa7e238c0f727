"""Multi-chunk fused verification in the port: with CHUNK shrunk to one
proof, a 3-proof batch runs as three chunk programs — an odd chunk count,
so the chunk partials must be padded to a power of two before the
pairwise tree (a 3-chunk batch once dropped its third chunk).  Verdicts
equal the JAX package's CpuBackend.  Also the device σ crafting used by
the chip smoke, against the host."""

import pytest
import torch

from cess_tpu.ops import podr2 as jpodr2
from cess_tpu.proof import CpuBackend as JaxCpuBackend
from cess_tpu_torch.ops import g1, podr2
from cess_tpu_torch.ops.bls12_381 import G1_GENERATOR, R, G1Point
from cess_tpu_torch.proof import TorchBackend, fused

# The twins run thousands of tiny ops: with several test workers on one
# host, intra-op threads cost more in wake-ups than they save.
torch.set_num_threads(1)

PARAMS = podr2.Podr2Params(n=8, s=4)
SK, PK = podr2.keygen(b"multichunk-tee")


def make_challenge(indices, seed=b"mc"):
    randoms = tuple((seed + i.to_bytes(2, "little")).ljust(20, b"\x5a") for i in indices)
    return podr2.Challenge(indices=tuple(indices), randoms=randoms)


def as_jax(items):
    return [
        (n, jpodr2.Challenge(c.indices, c.randoms), jpodr2.Podr2Proof(p.sigma, list(p.mu)))
        for n, c, p in items
    ]


@pytest.fixture(scope="module")
def proved3():
    ch = make_challenge([0, 2, 5])
    items = []
    for k in range(3):
        name = f"mc-frag-{k}".encode()
        data = bytes([(k * 37 + i) % 256 for i in range(PARAMS.fragment_bytes)])
        tags = podr2.tag_fragment(SK, name, data, PARAMS)
        items.append((name, ch, podr2.prove(tags, data, ch, PARAMS)))
    return items


@pytest.fixture(autouse=True)
def one_proof_chunks(monkeypatch):
    monkeypatch.setattr(fused, "CHUNK", 1)


def test_three_chunks_all_honest(proved3):
    """The batch and seed on which tests/test_zz_fused_multichunk.py
    holds XlaBackend(fused=True) to [True] * 3."""
    backend = TorchBackend(device="cpu")
    assert backend.verify_batch(PK, proved3, b"r3", PARAMS) == \
        JaxCpuBackend().verify_batch(PK, as_jax(proved3), b"r3", PARAMS) == [True] * 3
    assert backend.stage_seconds["chunk_program"] > 0


def test_three_chunks_bad_proof_in_the_third_chunk(proved3):
    """The tampered proof sits in the chunk a power-of-two tree without
    padding would drop: the combined check must fail, as the JAX
    package's host reference says."""
    bad = list(proved3)
    name, ch, proof = bad[2]
    bad[2] = (name, ch, podr2.Podr2Proof(proof.sigma, proof.mu[:-1] + [(proof.mu[-1] + 1) % R]))
    assert not fused.combined_check_fused(PK, bad, b"rc", PARAMS, device="cpu")
    assert JaxCpuBackend().verify_batch(PK, as_jax(bad), b"rc", PARAMS) == [True, True, False]


@pytest.mark.parametrize("n", [3, 5])
def test_tree_reduce_last_pads_odd_lengths(n):
    pts = [G1_GENERATOR.mul(k + 2) for k in range(n - 1)] + [G1Point.infinity()]
    X, Y, Z = (torch.as_tensor(a) for a in fused.pack_points_limbs(pts))
    got = fused._tree_reduce_last(tuple(a[:, None, :] for a in (X, Y, Z)))
    acc = G1Point.infinity()
    for p in pts:
        acc = acc + p
    assert g1.projective_to_points(*(a.reshape(1, -1) for a in got)) == [acc]


def test_craft_sigmas_match_host():
    ch = make_challenge([1, 4])
    names = [b"craft-a", b"craft-b", b"craft-c"]
    scalars = [SK * v % R for v in ch.coefficients()]
    got = fused.craft_sigmas(names, ch, scalars, device="cpu")
    for name, sigma in zip(names, got):
        want = G1Point.infinity()
        for i, s in zip(ch.indices, scalars):
            want = want + podr2.chunk_point(name, i).mul(s)
        assert sigma == want
