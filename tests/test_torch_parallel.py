"""The port's device mesh (cess_tpu_torch/parallel and the `mesh=`
arguments of TorchBackend, bls_agg, vrf and RS) against the JAX package.

A mesh here is eight ranks on the one CPU device, as tests/conftest.py
gives JAX eight virtual host devices.  The limbs of combine_mu_sharded
and audit_data_plane_step are held to cess_tpu.parallel's on an
eight-device JAX mesh at tests/test_parallel.py's shapes; every other
meshed result is held to cess_tpu's host references (CpuBackend's
verdicts, bls_agg.verify_batch_host, host G1 folds, gf256's RS
references) and to the port's unmeshed path, because cess_tpu's meshed
verify route and its run_epoch compile for minutes on the CPU.  Every
comparison is exact: verdicts, limbs, points and bytes.

Each meshed fold runs the plain tensor twins once per rank, seconds on
the CPU whatever its lanes, so the signature cases and the epoch use a
two-rank mesh and the bisection a one-rank one; a staged check costs
seconds of ladder twins, so the meshed backend runs two of them (the
honest proofs, and the corrupted one with its leaf) and chip_smoke.py's
phase 9-mesh runs the whole bisection on the card.
"""

import random

import numpy as np
import pytest
import torch

from cess_tpu import parallel as jpar
from cess_tpu.ops import bls12_381 as jbls
from cess_tpu.ops import bls_agg as jbls_agg
from cess_tpu.ops import fr as jfr
from cess_tpu.ops import gf256
from cess_tpu.ops import podr2 as jpodr2
from cess_tpu.proof import CpuBackend as JaxCpuBackend
from cess_tpu_torch.consensus import vrf
from cess_tpu_torch.node import tracing
from cess_tpu_torch.ops import bls12_381 as bls
from cess_tpu_torch.ops import bls_agg, fr, g1, podr2, rs
from cess_tpu_torch.parallel import (
    Mesh,
    audit_data_plane_step,
    combine_mu_sharded,
    make_mesh,
    msm_sharded,
    pad_batch_rows,
    run_epoch,
)
from cess_tpu_torch.proof import TorchBackend, torch_backend

# The twins run thousands of tiny ops: with several test workers on one
# host, intra-op threads cost more in wake-ups than they save.
torch.set_num_threads(1)

R = fr.R
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def jmesh():
    return jpar.make_mesh(8)


@pytest.fixture
def fake_card(monkeypatch):
    """torch believes a card is there: a CUDA mesh can be built, and
    nothing is ever run on it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    return Mesh((torch.device("cuda", 0),))


# ------------------------------------------------------------ the mesh


def test_make_mesh_on_the_cpu():
    assert make_mesh(device="cpu").devices == (CPU,)
    m = make_mesh(8, device="cpu")
    assert m.size == 8 and m.devices == (CPU,) * 8
    assert Mesh(("cpu", "cpu")).devices == (CPU, CPU)
    assert m.shards(16)[3] == slice(6, 8)
    for bad in (lambda: make_mesh(0, device="cpu"), lambda: Mesh(())):
        with pytest.raises(ValueError):
            bad()


def test_cuda_mesh_gives_every_card_and_no_more(fake_card, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert make_mesh(1).size == 1
    with pytest.raises(ValueError):
        make_mesh(3)
    with pytest.raises(ValueError, match="one device type"):
        Mesh((CPU, torch.device("cuda", 0)))


# ------------------------------------------------------------ verify.py


def _mus(rng, b: int, s: int):
    return [[rng.randrange(R) for _ in range(s)] for _ in range(b)]


@pytest.mark.parametrize("ranks", [1, 8])
def test_combine_mu_sharded_equals_cess_tpu(ranks, jmesh):
    """tests/test_parallel.py's case (B = 16, S = 5) on 1 and 8 ranks."""
    rng = random.Random(1234 + ranks)
    mus = _mus(rng, 16, 5)
    rhos = [rng.getrandbits(128) | 1 for _ in range(16)]
    mu_limbs = np.stack([fr.fr_to_limbs(m) for m in mus]).astype(np.int8)
    rho_limbs = fr.ints_to_limbs(rhos, 19)
    got = combine_mu_sharded(make_mesh(ranks, device="cpu"), rho_limbs, mu_limbs)
    want = np.asarray(jpar.combine_mu_sharded(jmesh, rho_limbs, mu_limbs))
    assert got.dtype == np.int32 and got.shape == (5, fr.NLIMBS)
    assert np.array_equal(got, want)
    assert np.array_equal(got, fr.combine_mu(rhos, mu_limbs, "cpu"))
    assert fr.limbs_to_ints(got) == [
        sum(r * mus[b][j] for b, r in enumerate(rhos)) % R for j in range(5)
    ]


def test_combine_mu_sharded_padded_rows_and_undivided_batch(mesh):
    rng = random.Random(7)
    mus = _mus(rng, 5, 4)
    rhos = [rng.getrandbits(64) | 1 for _ in range(5)]
    mu_limbs = np.stack([fr.fr_to_limbs(m) for m in mus]).astype(np.int8)
    rho_limbs = fr.ints_to_limbs(rhos, 19)
    with pytest.raises(ValueError, match="does not divide"):
        combine_mu_sharded(mesh, rho_limbs, mu_limbs)
    got = combine_mu_sharded(mesh, pad_batch_rows(rho_limbs, 8), pad_batch_rows(mu_limbs, 8))
    assert pad_batch_rows(rho_limbs, 8).shape == (8, 19)
    assert np.array_equal(got, fr.combine_mu(rhos, mu_limbs, "cpu"))
    assert np.array_equal(got, jfr.combine_mu(rhos, mu_limbs))


def test_audit_data_plane_step_equals_cess_tpu(mesh, jmesh):
    """tests/test_parallel.py's step (B = 8, C = 5, S = 3): μ per proof
    and the combination, against cess_tpu's step and host integers."""
    rng = random.Random(99)
    B, C, S = 8, 5, 3
    coeffs = [rng.getrandbits(160) for _ in range(C)]
    sectors = [[[rng.getrandbits(248) for _ in range(S)] for _ in range(C)] for _ in range(B)]
    rhos = [rng.getrandbits(128) | 1 for _ in range(B)]
    v_limbs = fr.ints_to_limbs(coeffs, 23)
    sector_limbs = np.stack([fr.sectors_to_limbs(rows) for rows in sectors])
    rho_limbs = fr.ints_to_limbs(rhos, 19)

    mu, combined = audit_data_plane_step(mesh)(v_limbs, sector_limbs, rho_limbs)
    jmu, jcombined = jpar.audit_data_plane_step(jmesh)(v_limbs, sector_limbs, rho_limbs)
    assert mu.shape == (B, S, fr.NLIMBS) and combined.shape == (S, fr.NLIMBS)
    assert np.array_equal(mu, np.asarray(jmu))
    assert np.array_equal(combined, np.asarray(jcombined))
    mus = [[sum(w * sectors[b][c][j] for c, w in enumerate(coeffs)) % R for j in range(S)]
           for b in range(B)]
    assert [fr.limbs_to_ints(mu[b]) for b in range(B)] == mus
    assert fr.limbs_to_ints(combined) == [
        sum(r * mus[b][j] for b, r in enumerate(rhos)) % R for j in range(S)
    ]
    with pytest.raises(ValueError, match="does not divide"):
        audit_data_plane_step(mesh)(v_limbs, sector_limbs[:5], rho_limbs[:5])


# ------------------------------------------------------------ msm.py


def test_msm_sharded_equals_host_fold_and_msm_wide(mesh):
    """tests/test_epoch_sim.py::TestMsmSharded's 11 lanes (two a rank
    after ∞ padding) against cess_tpu's host fold and the port's
    unsharded flat MSM."""
    rnd = random.Random(3)
    ks = [rnd.getrandbits(200) for _ in range(11)]
    scs = [rnd.getrandbits(128) for _ in range(11)]
    pts = [bls.G1_GENERATOR.mul(k) for k in ks]
    got = msm_sharded(mesh, pts, scs, bits=128)
    want = jbls.G1_GENERATOR.mul(sum(k * s for k, s in zip(ks, scs)) % jbls.R)
    assert (got.x, got.y) == (want.x, want.y)
    assert got == g1.msm_wide(pts, scs, bits=128, device="cpu")


def test_msm_sharded_empty_infinity_and_mismatch(mesh):
    assert msm_sharded(mesh, [], [], bits=128).is_infinity()
    pts = [bls.G1_GENERATOR, bls.G1Point.infinity()]
    got = msm_sharded(mesh, pts, [5, 7], bits=16)
    want = jbls.G1_GENERATOR.mul(5)
    assert (got.x, got.y) == (want.x, want.y)
    with pytest.raises(ValueError):
        msm_sharded(mesh, [bls.G1_GENERATOR], [1, 2])


# ------------------------------------------------------------ TorchBackend

PARAMS = podr2.Podr2Params(n=8, s=4)
JPARAMS = jpodr2.Podr2Params(n=8, s=4)


@pytest.fixture(scope="module")
def sharded_items():
    """tests/test_parallel.py's batch: 5 proofs (not a multiple of 8),
    proof 3's μ_0 moved by one.  (pk, cess_tpu's items, the port's)"""
    sk, pk = jpodr2.keygen(b"sharded-tee")
    ch = jpodr2.Challenge(indices=(0, 3, 5), randoms=tuple(bytes([i]) * 20 for i in range(3)))
    items = []
    for k in range(5):
        name = f"frag-{k}".encode()
        data = bytes([(k * 31 + i) % 256 for i in range(JPARAMS.fragment_bytes)])
        tags = jpodr2.tag_fragment(sk, name, data, JPARAMS)
        proof = jpodr2.prove(tags, data, ch, JPARAMS)
        if k == 3:
            proof.mu[0] = (proof.mu[0] + 1) % jpodr2.R
        items.append((name, ch, proof))
    port = [(n, podr2.Challenge(c.indices, c.randoms), podr2.Podr2Proof(p.sigma, list(p.mu)))
            for n, c, p in items]
    return pk, items, port


def test_meshed_backend_verdicts_equal_cpu_backend(mesh, sharded_items):
    """The meshed staged route, with the μ combination on eight ranks
    (four and one proofs padded to eight rows): its combined check
    passes the four honest proofs and, through verify_batch, refuses
    proof 3 alone, whose leaf then fails too.  Together they give
    CpuBackend's bitmap of the whole batch."""
    pk, items, port = sharded_items
    backend = TorchBackend(device="cpu", mesh=mesh)
    assert backend.fused is None and backend.mesh is mesh
    honest = [0, 1, 2, 4]
    seed = b"seed" + (0).to_bytes(2, "little")
    passed = backend._combined_check(pk, [port[i] for i in honest], seed, PARAMS)
    leaf = backend.verify_batch(pk, [port[3]], b"seed", PARAMS)
    got = [passed if i in honest else leaf[0] for i in range(5)]
    want = JaxCpuBackend().verify_batch(pk, items, b"seed", JPARAMS)
    assert got == want == [True, True, True, False, True]
    # the staged route's marks (the fused route never marks sigma_fold)
    assert set(backend.stage_seconds) == {
        "host_prep", "sigma_fold", "u_fold", "chunk_program", "pairing"}


@pytest.mark.parametrize("fused, meshed, route", [
    (None, False, "fused"), (True, False, "fused"), (False, False, "staged"),
    (None, True, "staged"), (False, True, "staged"), (True, True, "raises"),
])
def test_fused_option_picks_the_route(fused, meshed, route, mesh, sharded_items, monkeypatch):
    """XlaBackend's rule (xla_backend.py:207-211, :313-317): None is the
    fused route without a mesh and the staged one with it, True refuses
    a mesh.  The fused route is stubbed; the staged one returns at its
    pk parse, before any fold."""
    m = mesh if meshed else None
    if route == "raises":
        with pytest.raises(ValueError, match="single-device"):
            TorchBackend(device="cpu", fused=fused, mesh=m)
        return
    calls = []
    monkeypatch.setattr(torch_backend, "combined_check_fused",
                        lambda *a, **k: calls.append(a) or True)
    backend = TorchBackend(device="cpu", fused=fused, mesh=m)
    verdict = backend._combined_check(b"\x00" * 96, sharded_items[2], b"s", PARAMS)
    assert (verdict, len(calls)) == ((True, 1) if route == "fused" else (False, 0))


def test_mesh_of_another_device_type_raises(fake_card):
    with pytest.raises(ValueError, match="cuda mesh"):
        TorchBackend(device="cpu", mesh=fake_card)
    with pytest.raises(ValueError, match="cuda mesh"):
        bls_agg.batch_verify_signatures([], device="cpu", mesh=fake_card)
    with pytest.raises(ValueError, match="cuda mesh"):
        vrf.verify_claims([], device="cpu", mesh=fake_card)
    code = rs.RSCode(2, 1, path="gather", device="cpu")
    with pytest.raises(ValueError, match="cuda mesh"):
        code.encode(np.zeros((2, 8), np.uint8), mesh=fake_card)
    with pytest.raises(ValueError, match="cuda mesh"):
        rs.RSStream(code, mesh=fake_card)


# ------------------------------------------------------------ bls_agg, vrf


def _triples(n: int, n_keys: int, bad_at: int | None = None):
    keys = [bls.keygen(b"par-key-%d" % k) for k in range(n_keys)]
    pks = [bls.sk_to_pk(sk) for sk in keys]
    out = []
    for i in range(n):
        msg = b"par-msg-%d" % i
        sk = bls.keygen(b"wrong-key") if i == bad_at else keys[i % n_keys]
        out.append((pks[i % n_keys], msg, bls.sign(sk, msg)))
    return out


@pytest.fixture(scope="module")
def mesh2():
    return make_mesh(2, device="cpu")


def test_meshed_bls_verdicts_and_bitmap_equal_the_host_route(mesh2, monkeypatch):
    """Eight signatures, the sixth under the wrong key: the two-rank
    batch check refuses them, as cess_tpu's host route does (the epoch
    below passes honest batches on two ranks).  The fifth and the sixth go through the
    bisection on a one-rank mesh: each of its three checks folds the
    signatures through msm_sharded, and the bitmap isolates the bad
    one, as the host route decides the same sets."""
    bad = _triples(8, 2, bad_at=5)
    assert bls_agg.batch_verify_signatures(bad, b"s", device="cpu", mesh=mesh2) is False
    assert jbls_agg.verify_batch_host(bad, b"s") is False

    from cess_tpu_torch.parallel import msm as pmsm

    ranks = []
    real = pmsm.msm_sharded
    monkeypatch.setattr(pmsm, "msm_sharded",
                        lambda m, *a, **k: ranks.append(m.size) or real(m, *a, **k))
    pair = bad[4:6]
    got = bls_agg.verify_signatures(pair, b"s", device="cpu", mesh=make_mesh(1, device="cpu"))
    assert got == [True, False] and ranks == [1] * 3
    assert jbls_agg.verify_batch_host(pair[:1], b"s") is True
    assert jbls_agg.verify_batch_host(pair[1:], b"s") is False


def test_meshed_vrf_verdicts_and_bitmap_equal_the_host_route(mesh2):
    """Eight claims; a proof under the wrong key with its output
    re-derived (only the pairing can refuse it), and a claim whose
    output does not match its proof (refused before any fold)."""
    keys = [bls.keygen(b"par-author-%d" % k) for k in range(2)]
    pks = [bls.sk_to_pk(sk) for sk in keys]
    claims = []
    for slot in range(8):
        msg = vrf.vrf_input("par", 1, b"%032d" % 3, slot)
        out, proof = vrf.prove(keys[slot % 2], msg)
        claims.append((pks[slot % 2], msg, out, proof))
    forged = list(claims)
    pk, msg, _, _ = forged[2]
    forged[2] = (pk, msg) + vrf.prove(bls.keygen(b"wrong-author"), msg)
    assert vrf.batch_verify(forged, b"s", device="cpu", mesh=mesh2) is False
    triples = [(p, m, pr) for p, m, _, pr in forged]
    assert jbls_agg.verify_batch_host(triples, b"s") is False
    mismatch = list(claims)
    p, m, out, pr = mismatch[6]
    mismatch[6] = (p, m, bytes(32), pr)
    got = vrf.verify_claims(mismatch, b"s", device="cpu", mesh=mesh2)
    assert got == [i != 6 for i in range(8)]
    live = [(p, m, pr) for i, (p, m, o, pr) in enumerate(mismatch) if i != 6]
    assert jbls_agg.verify_batch_host(live, b"s") is True
    assert vrf.proof_to_output(mismatch[6][3]) != mismatch[6][2]


# ------------------------------------------------------------ RS

PATHS = ("gather", "bitplane")


def _roundtrip(k: int, m: int, n: int, seed: int):
    data = np.random.default_rng(seed).integers(0, 256, size=(k, n), dtype=np.uint8)
    return data, np.concatenate([data, gf256.rs_encode_ref(data, k, m)], axis=0)


@pytest.mark.parametrize("path", PATHS)
def test_rs_cols_sharded_encode_reconstruct(path, mesh):
    """Width 1,000 (not a multiple of 8: padded) over eight ranks."""
    data, allsh = _roundtrip(2, 1, 1000, seed=2)
    code = rs.RSCode(2, 1, path=path, device="cpu")
    par = code.encode(data, mesh=mesh).numpy()
    assert np.array_equal(par, gf256.rs_encode_ref(data, 2, 1))
    assert np.array_equal(par, code.encode(data).numpy())
    got = code.reconstruct(allsh[[0, 2]], [0, 2], mesh=mesh).numpy()
    assert np.array_equal(got, data)
    assert np.array_equal(got, code.reconstruct(allsh[[0, 2]], [0, 2]).numpy())


@pytest.mark.parametrize("path", PATHS)
def test_rs_batch_sharded_shared_pattern(path, mesh):
    data = np.random.default_rng(21).integers(0, 256, size=(16, 2, 257), dtype=np.uint8)
    code = rs.RSCode(2, 1, path=path, device="cpu")
    par = code.encode_batch(data, mesh=mesh).numpy()
    assert np.array_equal(par, code.encode_batch(data).numpy())
    surv = np.concatenate([data[:, 1:2], par], axis=1)
    got = code.reconstruct_batch(surv, [1, 2], mesh=mesh).numpy()
    assert np.array_equal(got, data)
    assert np.array_equal(par[:3], np.stack([gf256.rs_encode_ref(d, 2, 1) for d in data[:3]]))


def test_rs_mesh_stream_matches_host_stream(mesh):
    """RSStream.run over width 20,000 in tiles of 4,096 (the tail tile
    is not a multiple of 8), and run_batch over 13 segments in slabs
    rounded up to 8."""
    data, allsh = _roundtrip(2, 1, 20_000, seed=30)
    code = rs.RSCode(2, 1, path="gather", tile=4096, device="cpu")
    plain = rs.RSStream(code, present=[1, 2]).run(allsh[[1, 2]])
    stream = rs.RSStream(code, present=[1, 2], mesh=mesh)
    assert stream.tile == 4096 and rs.RSStream(code, mesh=mesh, slab=3).slab == 8
    assert np.array_equal(stream.run(allsh[[1, 2]]), plain)
    assert np.array_equal(plain, data)
    batch = np.random.default_rng(31).integers(0, 256, size=(13, 2, 96), dtype=np.uint8)
    enc = rs.RSStream(code, mesh=mesh, slab=3).run_batch(batch)
    assert np.array_equal(enc, rs.RSStream(code, slab=3).run_batch(batch))
    assert np.array_equal(enc[7], gf256.rs_encode_ref(batch[7], 2, 1))


@pytest.mark.parametrize("path", PATHS)
def test_rs_mesh_grouped_matches_host(path, mesh):
    """tests/test_rs_hotpath.py's mixed batch: 13 segments of 333 bytes,
    segment i losing shard i % 3, grouped by survivor mask."""
    rng = np.random.default_rng(42)
    data = rng.integers(0, 256, size=(13, 2, 333), dtype=np.uint8)
    allsh = np.stack([np.concatenate([d, gf256.rs_encode_ref(d, 2, 1)]) for d in data])
    pats = [sorted({0, 1, 2} - {i % 3}) for i in range(13)]
    surv = np.stack([allsh[i, pats[i]] for i in range(13)])
    code = rs.RSCode(2, 1, path=path, device="cpu")
    got = code.reconstruct_batch(surv, pats, mesh=mesh)
    assert np.array_equal(got, code.reconstruct_batch(surv, pats))
    assert np.array_equal(got, data)
    assert np.array_equal(got[4], gf256.rs_decode_ref(surv[4], pats[4], 2, 1))


# ------------------------------------------------------------ epoch_sim


def test_tiny_epoch_all_stages_check(mesh2):
    """tests/test_epoch_sim.py's tiny geometry on two CPU ranks (each
    rank's flat MSM costs its plain-tensor fold on the CPU, whatever its
    lanes; the eight-rank sharding is held above)."""
    tracer = tracing.Tracer(node="epoch-test")
    report = run_epoch(
        mesh2, n_segments=16, fragment_bytes=512, n_proofs=16, n_challenged=4,
        n_sectors=3, n_signatures=8, n_keys=2, n_headers=8, n_validators=2,
        seed=11, tracer=tracer,
    )
    assert (report.rs_ok, report.combine_ok, report.sigma_ok, report.bls_ok,
            report.vrf_ok, report.offences_ok) == (True,) * 6
    assert report.ok and report.n_devices == 2
    assert (report.segments, report.proofs, report.signatures, report.headers) == (16, 16, 8, 8)
    assert report.rs_bytes == 16 * 2 * 512 and report.offences == 8
    assert set(report.seconds) == {
        "rs", "audit_combine", "sigma_fold", "bls_aggregate", "vrf_headers", "offence_sweep"}
    spans = tracer.spans()
    roots = [s for s in spans if s.name == "epoch.run"]
    assert len(roots) == 1
    assert roots[0].duration == pytest.approx(sum(report.seconds.values()))
    assert {s.name for s in spans if s.name != "epoch.run"} == {
        f"epoch.{k}" for k in report.seconds}
    assert all(s.trace_id == roots[0].trace_id for s in spans)
