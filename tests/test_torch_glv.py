"""ops/glv.py of the port against the JAX package's: the twin of kernel
K2 gives `glv.glv_fold`'s projective outputs mod p, one coordinate at a
time, with and without the cofactor clear, and the subgroup mask (run as
kernel K3 at bits = 255 with the scalar r) gives `glv.subgroup_mask`'s."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cess_tpu.ops import glv as jglv
from cess_tpu_torch.ops import bls12_381 as bls
from cess_tpu_torch.ops import g1 as tg1
from cess_tpu_torch.ops import glv as tglv
from cess_tpu_torch.ops.bls12_381 import G1_GENERATOR, H_EFF_G1, P, R, G1Point

# The twins run thousands of tiny ops: with several test workers on one
# host, intra-op threads cost more in wake-ups than they save.
torch.set_num_threads(1)

T = torch.as_tensor


def _modp(a) -> list[int]:
    a = np.asarray(a)
    return [tg1.limbs_to_fp(a[:, j]) % P for j in range(a.shape[1])]


def _case(seed: int, subgroup_only: bool):
    rnd = random.Random(seed)
    pts = [G1_GENERATOR.mul(rnd.getrandbits(200)) for _ in range(3)]
    if not subgroup_only:
        pts += [bls.map_to_curve_g1(rnd.getrandbits(300) % P) for _ in range(4)]
    pts.append(G1Point.infinity())
    pts += [G1_GENERATOR.mul(rnd.getrandbits(64)) for _ in range(8 - len(pts))]
    scalars = [0, 1, R - 1] + [rnd.getrandbits(160) for _ in range(5)]
    return pts, scalars


@pytest.mark.parametrize("clear", [True, False])
def test_glv_twin_matches_jax(clear):
    pts, scalars = _case(9 if clear else 10, subgroup_only=not clear)
    X, Y, Z = (a.T.copy() for a in tg1.points_to_projective(pts))
    k1, k2 = tglv.decompose_to_limbs(scalars)
    got = tglv.glv_fold(T(X), T(Y), T(Z), T(k1), T(k2), clear=clear)
    want = jglv.glv_fold(*(jnp.asarray(a) for a in (X, Y, Z, k1, k2)), clear=clear)
    for g, w in zip(got, want):
        assert _modp(g) == _modp(w)
    host = tg1.projective_to_points(*(g.T for g in got))
    h = H_EFF_G1 if clear else 1
    assert host == [p._mul_raw(h)._mul_raw(s % R) for p, s in zip(pts, scalars)]


def test_subgroup_mask_matches_jax():
    rnd = random.Random(5)
    sub = [G1_GENERATOR.mul(rnd.getrandbits(200)) for _ in range(3)]
    nonsub = [bls.map_to_curve_g1(rnd.getrandbits(300) % P) for _ in range(3)]
    sub.append(G1Point.infinity())
    nonsub.append(G1_GENERATOR.mul(7))
    X, Y, Z = (a.T.copy() for a in tg1.points_to_projective(sub + nonsub))
    got = tglv.subgroup_mask(T(X), T(Y), T(Z))
    want = np.asarray(jglv.subgroup_mask(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Z)))
    assert got.dtype == torch.int32
    assert got.tolist() == want.tolist() == [1, 1, 1, 1, 0, 0, 0, 1]


def test_r_scalars_are_the_bits_of_r():
    s = tglv.r_scalars(3, "cpu")
    assert s.shape == (tg1.R_LIMBS, 3)
    assert all(tg1.limbs_to_fp(s[:, j].numpy()) == R for j in range(3))
    assert len(bin(R)) - 2 == tg1.SCALAR_BITS


def test_decompose_identity_and_phi():
    rnd = random.Random(3)
    for _ in range(50):
        k = rnd.getrandbits(rnd.choice([64, 128, 160, 255])) % R
        k1, k2 = tglv.decompose(k)
        assert k1 + k2 * tglv.LAMBDA == k
        assert 0 <= k1 < 1 << 128 and 0 <= k2 < 1 << 128
    p = G1_GENERATOR.mul(12345)
    assert G1Point(p.x * tglv.beta() % P, p.y) == p.mul(tglv.LAMBDA)
