"""ops/bls_agg.py and consensus/vrf.py of the port against the JAX
package's, on device="cpu" (the folds through the plain tensor twin of
kernel K3): batch verdicts equal cess_tpu.ops.bls_agg's device route on
an honest and a bad batch and its host route (`verify_batch_host`, no
JAX compile) everywhere else; the weighted folds equal a host fold; the
Δ/−Δ malleation that a plain aggregate accepts is refused; VRF batch
verdicts, per-claim bitmaps and claim triples equal the JAX package's
host route.  Batches have tests/test_bls_agg.py's `_make_batch` shapes;
the tolerance is zero (exact verdicts and points)."""

import functools

import torch

from cess_tpu.consensus import vrf as jvrf
from cess_tpu.ops import bls_agg as jbls_agg
from cess_tpu_torch.consensus import vrf
from cess_tpu_torch.ops import bls12_381 as bls
from cess_tpu_torch.ops import bls_agg
from cess_tpu_torch.ops.bls12_381 import G1Point

# The twins run thousands of tiny ops: with several test workers on one
# host, intra-op threads cost more in wake-ups than they save.
torch.set_num_threads(1)

CPU = "cpu"


@functools.cache
def _make_batch(n: int, n_keys: int, tag: bytes = b""):
    """tests/test_bls_agg.py's batch: n signatures, key i % n_keys."""
    keys = [bls.keygen(b"agg-key-%d" % k + tag) for k in range(n_keys)]
    pks = [bls.sk_to_pk(sk) for sk in keys]
    triples = []
    for i in range(n):
        k = i % n_keys
        msg = b"agg-msg-%d" % i + tag
        triples.append((pks[k], msg, bls.sign(keys[k], msg)))
    return tuple(triples)


def _forged(n: int, n_keys: int, at: int):
    triples = list(_make_batch(n, n_keys))
    pk, msg, _ = triples[at]
    triples[at] = (pk, msg, bls.sign(bls.keygen(b"wrong-key"), msg))
    return triples


# ------------------------------------------------------------------ bls_agg


def test_batch_verdicts_equal_the_jax_device_route():
    """The same shapes twice (6 signatures under 3 keys): the JAX side
    compiles its two folds once."""
    honest = list(_make_batch(6, 3))
    bad = _forged(6, 3, 3)
    assert bls_agg.batch_verify_signatures(honest, b"seed", device=CPU) is True
    assert jbls_agg.batch_verify_signatures(honest, b"seed") is True
    assert bls_agg.batch_verify_signatures(bad, b"seed", device=CPU) is False
    assert jbls_agg.batch_verify_signatures(bad, b"seed") is False


def test_folds_equal_a_host_fold():
    triples = list(_make_batch(6, 3))
    sig_pts = [G1Point.from_bytes(s) for _, _, s in triples]
    rhos = bls_agg.batch_weights(bls_agg.agg_transcript(b"seed", triples), 6)
    groups = {}
    for (pk, msg, _), r in zip(triples, rhos):
        pts, rs = groups.setdefault(pk, ([], []))
        pts.append(bls.hash_to_g1(msg))
        rs.append(r)
    lhs, folds = bls_agg._batch_folds(sig_pts, rhos, groups, torch.device(CPU))
    host_lhs, host_folds = bls_agg._batch_folds(sig_pts, rhos, groups, None)
    assert lhs == host_lhs and not lhs.is_infinity()
    assert folds == host_folds and len(folds) == 3


def test_bisection_isolates_like_the_host_route():
    """Each signature valid for the OTHER message: both are refused, and
    the weighted batch does not let them cancel."""
    (pk, m0, s0), (_, m1, s1) = _make_batch(2, 1)
    swapped = [(pk, m0, s1), (pk, m1, s0)]
    want = [jbls_agg.verify_batch_host([t], b"seed") for t in swapped]
    assert bls_agg.verify_signatures(swapped, b"seed", device=CPU) == want == [False, False]
    assert bls_agg.verify_batch_host(swapped, b"seed") is False


def test_aggregate_malleation_refused():
    """Shift one signature by Δ and the other by −Δ: the plain aggregate
    still verifies, the weighted batch must not (both routes).  The
    device route also fills its stage seconds."""
    (pk, m0, s0), (_, m1, s1) = _make_batch(2, 1, tag=b"mall")
    delta = bls.G1_GENERATOR.mul(12345)
    shifted = [
        (pk, m0, (G1Point.from_bytes(s0) + delta).to_bytes()),
        (pk, m1, (G1Point.from_bytes(s1) + (-delta)).to_bytes()),
    ]
    agg = bls_agg.aggregate_signatures([s for _, _, s in shifted])
    assert agg == jbls_agg.aggregate_signatures([s for _, _, s in shifted])
    assert bls_agg.verify_aggregate([pk, pk], [m0, m1], agg) is True
    assert jbls_agg.verify_batch_host(shifted, b"seed") is False
    assert bls_agg.verify_batch_host(shifted, b"seed") is False
    stages = {}
    assert bls_agg.batch_verify_signatures(shifted, b"seed", device=CPU, stages=stages) is False
    assert set(stages) == {"parse", "hash", "folds", "pairing"}
    assert all(v >= 0 for v in stages.values())


def test_malformed_and_empty_batches():
    (pk, msg, sig), = _make_batch(1, 1)
    for triples in ([(pk, msg, b"\x00" * 48)], [(b"\x00" * 96, msg, sig)]):
        assert bls_agg.batch_verify_signatures(triples, b"seed", device=CPU) is False
        assert jbls_agg.verify_batch_host(triples, b"seed") is False
    assert bls_agg.batch_verify_signatures([], b"seed", device=CPU) is True
    assert bls_agg.verify_signatures([], b"seed", device=CPU) == []
    assert bls_agg.verify_batch_host([], b"seed") is True


def test_seed_binds_the_weights_as_in_the_jax_package():
    batch = list(_make_batch(2, 1))
    t1 = bls_agg.agg_transcript(b"a", batch)
    assert t1 == jbls_agg.agg_transcript(b"a", batch)
    assert t1 != bls_agg.agg_transcript(b"b", batch)
    w = bls_agg.batch_weights(t1, 3)
    assert w == jbls_agg.batch_weights(t1, 3)
    assert len(set(w)) == 3 and all(x & 1 for x in w)


def test_aggregate_helpers_equal_the_jax_package():
    triples = _make_batch(3, 2)
    pks = [pk for pk, _, _ in triples]
    msgs = [m for _, m, _ in triples]
    agg = bls_agg.aggregate_signatures([s for _, _, s in triples])
    assert agg == jbls_agg.aggregate_signatures([s for _, _, s in triples])
    assert bls_agg.aggregate_pubkeys(pks) == jbls_agg.aggregate_pubkeys(pks)
    assert bls_agg.verify_aggregate(pks, msgs, agg) is True
    assert bls_agg.verify_aggregate(pks, msgs[:2] + [b"tampered"], agg) is False


# ------------------------------------------------------------------ vrf


@functools.cache
def _claims():
    """Three honest claims from two validators; a forged proof (another
    key's, with its own output, so only the pairing can catch it); an
    honest proof under a mismatched output."""
    keys = [bls.keygen(b"vrf-val-%d" % v) for v in range(2)]
    pks = [bls.sk_to_pk(sk) for sk in keys]
    claims = []
    for slot in range(3):
        msg = vrf.vrf_input("gen", 1, b"\x07" * 32, slot)
        out, proof = vrf.prove(keys[slot % 2], msg)
        claims.append((pks[slot % 2], msg, out, proof))
    msg = vrf.vrf_input("gen", 1, b"\x07" * 32, 3)
    out, proof = vrf.prove(bls.keygen(b"vrf-thief"), msg)
    forged = (pks[0], msg, out, proof)
    pk, msg, _, proof = claims[1]
    mismatched = (pk, msg, vrf.proof_to_output(claims[0][3]), proof)
    return claims, forged, mismatched


def test_vrf_host_pieces_equal_the_jax_package():
    claims, forged, _ = _claims()
    pk, msg, out, proof = claims[0]
    assert msg == jvrf.vrf_input("gen", 1, b"\x07" * 32, 0)
    assert out == jvrf.proof_to_output(proof)
    assert vrf.verify(pk, msg, out, proof) is jvrf.verify(pk, msg, out, proof) is True
    assert vrf.verify(*forged) is jvrf.verify(*forged) is False
    t = vrf.threshold(3, 10, 1, 4)
    assert t == jvrf.threshold(3, 10, 1, 4)
    assert vrf.output_wins(out, t) == jvrf.output_wins(out, t)


def test_vrf_batch_verify_equals_the_jax_host_route():
    claims, forged, mismatched = _claims()
    for batch, want in ((claims, True), (claims + [forged], False),
                        ([mismatched] + claims, False), ([], True)):
        assert jvrf.batch_verify(batch, b"seed", device=False) is want
        assert vrf.batch_verify(batch, b"seed", device=CPU) is want


def test_vrf_verify_claims_isolates_each_bad_claim_in_place():
    claims, forged, mismatched = _claims()
    batch = [claims[0], mismatched, forged]
    want = jvrf.verify_claims(batch, b"seed", device=False)
    assert vrf.verify_claims(batch, b"seed", device=CPU) == want == [True, False, False]


def test_vrf_claim_triples_equal_the_jax_package():
    claims, forged, mismatched = _claims()
    for batch in (claims, claims[:2] + [mismatched] + claims[2:], [forged] + claims, []):
        assert vrf.batch_claim_triples(batch) == jvrf.batch_claim_triples(batch)
    triples, n = vrf.batch_claim_triples(claims[:2] + [mismatched, claims[2]])
    assert n == 2 and len(triples) == 2
