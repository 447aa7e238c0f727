"""Full-epoch simulation over a mesh of torch devices (BASELINE config 5).

The port of `cess_tpu/parallel/epoch_sim.py`.  One storage-network
epoch's device workload — "1M segments RS-recover + 100k proofs + BLS
aggregate" — run end to end over one `Mesh` (parallel/verify.py):

  stage RS      every lost segment of the epoch is rebuilt from its
                surviving fragments: the GF(256) product (ops/rs.py)
                with each slab's segments split over the ranks (no
                reduction; the restoral-order market's math, reference:
                c-pallets/file-bank/src/lib.rs:936-1125);

  stage AUDIT   the audit round's μ aggregation + ρ-weighted combination
                over the proof batch (parallel/verify.py: per-rank
                contractions and the partial sum, reference seam:
                c-pallets/audit/src/lib.rs:484) plus the σ-side fold
                Π σ_b^{ρ_b} as a lane-sharded Pippenger MSM
                (parallel/msm.py);

  stage BLS     the epoch's TEE verdict signatures checked as ONE
                weighted batch (ops/bls_agg.py) with the signature-side
                fold sharded over the mesh (reference per-signature
                loop: utils/verify-bls-signatures/src/lib.rs:85-100);

  stage VRF     the epoch's header slot claims (consensus/vrf.py:
                BLS-VRF proofs over (epoch randomness, slot)) verified
                as one batched pairing product — 1 + #authors pairings
                instead of 2 per block.

  stage OFFENCE the epoch's accumulated equivocation evidence
                (chain/offences.py OffenceReport: two signatures over
                conflicting consensus payloads per report) swept in
                ONE weighted signature batch, plus the host-side
                structural conflict checks.

Every stage is checked against host arithmetic when `check=True` (the
default).  The σ points come from one K3 ladder on the mesh's first
device; the BLS message folds run there too (K3).  The host limb codecs
of the audit inputs go through words (fr.ints_to_words), the same limbs
as fr.sectors_to_limbs and fr.ints_to_limbs at config 5's 100,000
proofs.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

import numpy as np

from ..ops import bls12_381 as bls
from ..ops import bls_agg, fr, g1, rs
from .msm import msm_sharded
from .verify import Mesh, audit_data_plane_step, make_mesh


@dataclass
class EpochReport:
    n_devices: int
    segments: int
    rs_bytes: int
    rs_ok: bool
    proofs: int
    combine_ok: bool
    sigma_ok: bool
    signatures: int
    bls_ok: bool
    headers: int = 0
    vrf_ok: bool = True
    offences: int = 0
    offences_ok: bool = True
    seconds: dict[str, float] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return (self.rs_ok and self.combine_ok and self.sigma_ok
                and self.bls_ok and self.vrf_ok and self.offences_ok)


def _limbs(values: list[int], nbytes: int, nlimbs: int) -> np.ndarray:
    """(len, nlimbs) int8 base-128 limbs of values < 2^(8·nbytes)."""
    return fr.words_to_limbs(fr.ints_to_words(values, nbytes), fr.LIMB_BITS, nlimbs)


# ------------------------------------------------------------ epoch


def run_epoch(
    mesh: Mesh | None = None,
    *,
    n_segments: int = 64,
    fragment_bytes: int = 4096,
    n_proofs: int = 32,
    n_challenged: int = 5,
    n_sectors: int = 3,
    n_signatures: int = 8,
    n_keys: int = 2,
    n_headers: int = 64,
    n_validators: int = 3,
    n_offences: int = 8,
    seed: int = 7,
    check: bool = True,
    tracer=None,
) -> EpochReport:
    """Run one epoch's device workload over `mesh` (None: make_mesh(),
    every card; raises without one).  All batch sizes are rounded up to
    multiples of the mesh size.  `tracer` (node/tracing.py Tracer)
    records one `epoch.run` trace with a span per stage."""
    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.size
    dev = mesh.devices[0]
    rnd = random.Random(seed)
    nprng = np.random.default_rng(seed)
    seconds: dict[str, float] = {}

    def r(n: int) -> int:
        return -(-n // n_dev) * n_dev

    n_segments, n_proofs = r(n_segments), r(n_proofs)
    n_signatures, n_headers = r(n_signatures), r(n_headers)

    # ---------------- stage RS: recover every segment from its survivors.
    # Segment i loses fragment i % 3 — MIXED per-segment erasure patterns,
    # grouped by survivor mask inside rs.RSStream (each slab's segments
    # split over the ranks).
    code = rs.RSCode(2, 1, path="auto", device=dev)
    data = nprng.integers(
        0, 256, size=(n_segments, 2, fragment_bytes), dtype=np.uint8
    )
    parity = code.encode_batch(data).cpu().numpy()
    allsh = np.concatenate([data, parity], axis=1)  # (B, 3, n)
    del parity
    patterns = [sorted({0, 1, 2} - {i % 3}) for i in range(n_segments)]
    survivors = np.stack(
        [allsh[i, patterns[i]] for i in range(n_segments)]
    )
    del allsh
    slab = min(rs.SLAB, n_segments)
    rs.RSStream(  # warm-up: same (slab, k, n) geometry as the timed run
        code, present=patterns[:n_dev], mesh=mesh, slab=slab
    ).run_batch(survivors[:n_dev])
    t0 = time.perf_counter()
    recovered = rs.RSStream(
        code, present=patterns, mesh=mesh, slab=slab
    ).run_batch(survivors)
    seconds["rs"] = time.perf_counter() - t0
    rs_ok = bool(np.array_equal(recovered, data)) if check else True
    del data, survivors, recovered

    # ---------------- stage AUDIT: μ + combine (partial sum) + σ fold (sharded MSM)
    coeffs = [rnd.getrandbits(160) for _ in range(n_challenged)]
    sectors = [
        [
            [rnd.getrandbits(248) for _ in range(n_sectors)]
            for _ in range(n_challenged)
        ]
        for _ in range(n_proofs)
    ]
    rhos = [rnd.getrandbits(128) | 1 for _ in range(n_proofs)]
    step = audit_data_plane_step(mesh)
    v_limbs = fr.ints_to_limbs(coeffs, 23)
    flat = [m for rows in sectors for row in rows for m in row]
    sector_limbs = _limbs(flat, 32, 36).reshape(n_proofs, n_challenged, n_sectors, 36)
    rho_limbs = _limbs(rhos, 20, 19)
    step(v_limbs, sector_limbs[:n_dev], rho_limbs[:n_dev])  # warm-up
    t0 = time.perf_counter()
    _, combined = step(v_limbs, sector_limbs, rho_limbs)
    combined_ints = fr.limbs_to_ints(combined)
    seconds["audit_combine"] = time.perf_counter() - t0

    # σ points: distinct pseudorandom subgroup points (σ = [t]G — the
    # shape of real proof σ values; derivation cost is host-side setup,
    # not part of the timed device work)
    sigma_scalars = [rnd.getrandbits(250) for _ in range(n_proofs)]
    sigmas = g1.scalar_mul_batch(
        [bls.G1_GENERATOR] * n_proofs, sigma_scalars, device=dev
    )
    t0 = time.perf_counter()
    sigma_fold = msm_sharded(mesh, sigmas, rhos, bits=128)
    seconds["sigma_fold"] = time.perf_counter() - t0

    combine_ok = sigma_ok = True
    if check:
        mus = [
            [
                sum(w * sectors[b][c][j] for c, w in enumerate(coeffs)) % fr.R
                for j in range(n_sectors)
            ]
            for b in range(n_proofs)
        ]
        want = [
            sum(rho * mus[b][j] for b, rho in enumerate(rhos)) % fr.R
            for j in range(n_sectors)
        ]
        combine_ok = combined_ints == want
        # host σ fold through the subgroup: Σ ρ_b·t_b mod r applied to G
        t_total = sum(rho * t for rho, t in zip(rhos, sigma_scalars)) % g1.R
        sigma_ok = sigma_fold == bls.G1_GENERATOR.mul(t_total)

    # ---------------- stage BLS: the epoch's verdict signatures, one batch
    keys = [bls.keygen(b"epoch-key-%d" % k) for k in range(n_keys)]
    pks = [bls.sk_to_pk(sk) for sk in keys]
    triples = []
    for i in range(n_signatures):
        k = i % n_keys
        msg = b"epoch-verdict-%d-%d" % (seed, i)
        triples.append((pks[k], msg, bls.sign(keys[k], msg)))
    t0 = time.perf_counter()
    bls_ok = bls_agg.batch_verify_signatures(
        triples, b"epoch-%d" % seed, device=dev, mesh=mesh
    )
    seconds["bls_aggregate"] = time.perf_counter() - t0

    # ------------- stage VRF: the epoch's header slot claims, one batch
    from ..consensus import vrf as _vrf

    vkeys = [bls.keygen(b"epoch-author-%d" % k) for k in range(n_validators)]
    vpks = [bls.sk_to_pk(sk) for sk in vkeys]
    epoch_rand = b"%032d" % seed
    claims = []
    for slot in range(n_headers):
        k = slot % n_validators
        msg = _vrf.vrf_input("epoch-sim", 1, epoch_rand, slot)
        out, proof = _vrf.prove(vkeys[k], msg)
        claims.append((vpks[k], msg, out, proof))
    t0 = time.perf_counter()
    vrf_ok = _vrf.batch_verify(claims, b"epoch-%d" % seed, device=dev, mesh=mesh)
    seconds["vrf_headers"] = time.perf_counter() - t0
    if check:
        vrf_ok = vrf_ok and all(
            _vrf.verify(*claims[i]) for i in (0, n_headers - 1)
        )

    # ---------- stage OFFENCE: the era's equivocation evidence, one batch
    from ..chain import offences as _off

    n_offences = r(n_offences)
    off_triples = []
    offences_ok = True
    for i in range(n_offences):
        k = i % n_validators
        sk, pk = vkeys[k], vpks[k]
        # two conflicting finality payloads (same height, different
        # hash) signed by the same offender — the OffenceReport shape
        p1 = b'["epoch-sim","finality",%d,"aa%02x"]' % (i, i & 0xFF)
        p2 = b'["epoch-sim","finality",%d,"bb%02x"]' % (i, i & 0xFF)
        offences_ok = offences_ok and p1 != p2  # structural conflict
        off_triples.append((pk, p1, bls.sign(sk, p1)))
        off_triples.append((pk, p2, bls.sign(sk, p2)))
    t0 = time.perf_counter()
    if off_triples:
        offences_ok = offences_ok and bls_agg.batch_verify_signatures(
            off_triples, b"offences-%d" % seed, device=dev, mesh=mesh
        )
    seconds["offence_sweep"] = time.perf_counter() - t0
    if check and n_offences:
        # one report must also survive the pallet's full structural
        # verifier (host path) — the batch and the per-report gate
        # must agree
        rep = _off.OffenceReport(
            kind=_off.KIND_VOTE_EQUIV, offender="v0", session=0,
            evidence=[
                [off_triples[0][1].hex(), off_triples[0][2].hex()],
                [off_triples[1][1].hex(), off_triples[1][2].hex()],
            ],
        )
        offences_ok = offences_ok and _off.verify_report(
            rep, "epoch-sim", {"v0": vpks[0]}.get
        )

    if tracer is not None:
        with tracer.span(
            "epoch.run", tags={"devices": n_dev, "proofs": n_proofs}
        ) as root:
            for stage, dur in seconds.items():
                tracer.event(f"epoch.{stage}", duration=dur)
        # the stages ran before the span opened: back-date the root's
        # duration to the measured epoch wall-clock (the ring holds
        # the same Span object, so post-exit mutation is visible)
        root.duration = sum(seconds.values())

    return EpochReport(
        n_devices=n_dev,
        segments=n_segments,
        rs_bytes=n_segments * 2 * fragment_bytes,
        rs_ok=rs_ok,
        proofs=n_proofs,
        combine_ok=combine_ok,
        sigma_ok=sigma_ok,
        signatures=n_signatures,
        bls_ok=bls_ok,
        headers=n_headers,
        vrf_ok=vrf_ok,
        offences=n_offences,
        offences_ok=offences_ok,
        seconds=seconds,
    )
