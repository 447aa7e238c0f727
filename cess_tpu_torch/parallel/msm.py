"""Flat G1 MSM sharded over a mesh of torch devices.

The port of `cess_tpu/parallel/msm.py`.  Σ_i [s_i]P_i is a bag of
independent bucket accumulations plus one final fold, so the mesh layout
is pure lane sharding: every rank runs the flat Pippenger MSM
(ops/g1.py `_msm_flat_kernel`, plain torch) over its contiguous lane
shard on its device, and the ranks' partial sums — one projective point
each — come back for a host fold in rank order (point addition is not a
sum of limbs, and folding a few partials on the host is O(1)).

This is the multi-rank shape of the batch-verification folds: the σ-side
Π σ_b^{ρ_b} of the epoch's audit stage (parallel/epoch_sim.py) and the
signature-side fold of the aggregate BLS check (ops/bls_agg.py).
"""

from __future__ import annotations

import torch

from ..ops import g1
from ..ops.bls12_381 import G1Point
from .verify import Mesh


@torch.inference_mode()
def msm_sharded(
    mesh: Mesh,
    points: list[G1Point],
    scalars: list[int],
    bits: int = g1.SCALAR_BITS,
) -> G1Point:
    """Σ [s_i]P_i with the lane axis sharded over the mesh.  Scalars are
    raw integers up to `bits` wide (flat-MSM semantics: no reduction mod
    r — the cofactor-folding contract of ops/h2c.py)."""
    if len(points) != len(scalars):
        raise ValueError("points/scalars length mismatch")
    if not points:
        return G1Point.infinity()
    n_windows = -(-bits // g1.LIMB_BITS)

    # pad the lane axis so every rank holds the same number of lanes
    # (∞ with scalar 0 contributes nothing)
    pad = (-len(points)) % mesh.size
    pts = list(points) + [G1Point.infinity()] * pad
    scs = [int(s) for s in scalars] + [0] * pad

    X, Y, Z = g1.points_to_projective(pts)  # (N, 33) each
    d = g1.scalars_to_digits(scs, n_windows)  # (n_windows, N)
    partials = []
    for dev, sl in zip(mesh.devices, mesh.shards(len(pts))):
        coords = tuple(g1.limbs_from_numpy(a[sl].T, dev) for a in (X, Y, Z))
        part = g1._msm_flat_kernel(*coords, g1.limbs_from_numpy(d[:, sl], dev), n_windows)
        partials.append([c.cpu() for c in part])
    rX, rY, rZ = (torch.stack(c) for c in zip(*partials))  # (ranks, 33)
    total = G1Point.infinity()
    for p in g1.projective_to_points(rX, rY, rZ):
        total = total + p
    return total
