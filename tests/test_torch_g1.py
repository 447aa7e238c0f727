"""ops/g1.py of the port against the JAX package's: the Fp limb ops and
the complete point formulas give the same limbs, and the ladder twin of
kernel K3 gives the JAX ladder's projective coordinates mod p, one
coordinate at a time, at bits 128, 224 and 255."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cess_tpu.ops import g1 as jg1
from cess_tpu_torch.ops import g1 as tg1
from cess_tpu_torch.ops.bls12_381 import G1_GENERATOR, P, R, G1Point, map_to_curve_g1

# The twins run thousands of tiny ops: with several test workers on one
# host, intra-op threads cost more in wake-ups than they save.
torch.set_num_threads(1)

T = torch.as_tensor


def _loose(rng, shape):
    """Random loose limbs: each in [0, 4096], value inside the loose bound."""
    x = rng.integers(0, 4097, size=(33,) + shape, dtype=np.int32)
    x[32] = rng.integers(0, 2, size=shape)
    return x


def _modp(a) -> list[int]:
    a = np.asarray(a)
    return [tg1.limbs_to_fp(a[:, j]) % P for j in range(a.shape[1])]


def _xy(points) -> list:
    """Host points of either package as comparable tuples."""
    return [(p.is_infinity(), p.x, p.y) for p in points]


def assert_same_mod_p(got, want):
    for g, w in zip(got, want):
        assert _modp(g) == _modp(w)


def _points(rng):
    sub = [G1_GENERATOR.mul(rng.randrange(1, R)) for _ in range(2)]
    nonsub = map_to_curve_g1(rng.randrange(P))
    assert not nonsub.in_subgroup()
    return sub + [nonsub, G1Point.infinity()]


@pytest.mark.parametrize("op", ["mulm", "addm", "subm"])
def test_field_ops_give_the_jax_limbs(op):
    rng = np.random.default_rng(1)
    a, b = _loose(rng, (8,)), _loose(rng, (8,))
    b[:, 0] = 0
    a[:, 1] = 0
    want = np.asarray(getattr(jg1, op)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(tg1, op)(T(a), T(b))
    np.testing.assert_array_equal(got.numpy(), want)


def test_smallmul_gives_the_jax_limbs():
    a = _loose(np.random.default_rng(2), (8,))
    for c in (11, 12):
        np.testing.assert_array_equal(
            tg1.smallmul(T(a), c).numpy(), np.asarray(jg1.smallmul(jnp.asarray(a), c))
        )


def test_point_formulas_give_the_jax_limbs():
    rng = np.random.default_rng(3)
    p = tuple(_loose(rng, (6,)) for _ in range(3))
    q = tuple(_loose(rng, (6,)) for _ in range(3))
    jp = tuple(map(jnp.asarray, p))
    jq = tuple(map(jnp.asarray, q))
    for got, want in (
        (tg1.pt_add(tuple(map(T, p)), tuple(map(T, q))), jg1.pt_add(jp, jq)),
        (tg1.pt_double(tuple(map(T, p))), jg1.pt_double(jp)),
    ):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("bits", [128, 224, 255])
def test_ladder_twin_matches_jax_ladder(bits):
    """K3's twin against the JAX ladder on subgroup, non-subgroup and ∞
    points, with scalars 0, 1, the largest the width allows, and r − 1."""
    rng = random.Random(bits)
    pts = _points(rng)
    top = min((1 << bits) - 1, R - 1)
    scalars = [0, 1, top, rng.getrandbits(bits) % R]
    if bits == 255:
        scalars[2] = R - 1
    X, Y, Z = (a.T.copy() for a in tg1.points_to_projective(pts))
    s = tg1.scalars_to_limbs(scalars).T.copy()
    want = jg1._scalar_mul_kernel(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Z), jnp.asarray(s), bits=bits
    )
    got = tg1.scalar_mul_ladder((T(X), T(Y), T(Z)), T(s), bits=bits)
    assert_same_mod_p(got, want)
    host = tg1.projective_to_points(*(g.T for g in got))
    assert host == [p.mul(k) for p, k in zip(pts, scalars)]


def test_ladder_work_counts_what_the_inputs_need():
    """One doubling (8 products, 2 squarings) per bit below a lane's top
    set bit, one addition (12 products) per set bit, bits < `bits` only."""
    rng = random.Random(9)
    r128 = rng.getrandbits(128) | 1 << 127
    cases = [0, 1, R, (1 << 127) + 1, r128]
    s = np.stack([tg1.fp_to_limbs(v, tg1.R_LIMBS) for v in cases], 1)
    hand = [(0, 0), (0, 1), (254, bin(R).count("1")), (127, 2), (127, bin(r128).count("1"))]
    for (d, a), col in zip(hand, range(len(cases))):
        assert tg1.ladder_work(s[:, col : col + 1], 255) == (8 * d + 12 * a, 2 * d)
    d, a = map(sum, zip(*hand))
    assert tg1.ladder_work(T(s), 255) == (8 * d + 12 * a, 2 * d)
    # bits cuts the scalar: r mod 2^128 keeps its low 128 bits only
    low = R & ((1 << 128) - 1)
    assert tg1.ladder_work(s[:, 2:3], 128) == (
        8 * (low.bit_length() - 1) + 12 * bin(low).count("1"), 2 * (low.bit_length() - 1))


def test_pt_double_counts_its_two_squarings():
    rng = np.random.default_rng(11)
    p = tuple(T(_loose(rng, (3,))) for _ in range(3))
    m0, s0 = tg1.MUL_COUNT[0], tg1.SQR_COUNT[0]
    tg1.pt_double(p)
    assert (tg1.MUL_COUNT[0] - m0, tg1.SQR_COUNT[0] - s0) == (8 * 3, 2 * 3)
    m0, s0 = tg1.MUL_COUNT[0], tg1.SQR_COUNT[0]
    tg1.pt_add(p, p)
    assert (tg1.MUL_COUNT[0] - m0, tg1.SQR_COUNT[0] - s0) == (12 * 3, 0)


def test_ladder_skip_premise_on_the_twin():
    """What kernel K3 skips changes no coordinate: on 128-bit scalars the
    255-bit ladder (127 leading steps from (0 : 1 : 0)) equals the
    128-bit ladder limb for limb once canonical."""
    from cess_tpu_torch.ops.h2c import _canon_mod_p

    rng = random.Random(12)
    pts = _points(rng)
    scalars = [0, 1, (1 << 128) - 1, rng.getrandbits(128)]
    X, Y, Z = (T(a.T.copy()) for a in tg1.points_to_projective(pts))
    s = T(tg1.scalars_to_limbs(scalars).T.copy())
    full = tg1.batch_scalar_mul((X, Y, Z), s, 255)
    short = tg1.batch_scalar_mul((X, Y, Z), s, 128)
    for a, b in zip(full, short):
        assert torch.equal(_canon_mod_p(a), _canon_mod_p(b))


def test_scalar_mul_batch_and_msm_match_host():
    rng = random.Random(8)
    pts = _points(rng)[:3]
    ks = [rng.randrange(R), 1, R - 1]
    assert tg1.scalar_mul_batch(pts, ks, device="cpu") == [p.mul(k) for p, k in zip(pts, ks)]
    acc = G1Point.infinity()
    for p, k in zip(pts, ks):
        acc = acc + p.mul(k)
    assert tg1.msm(pts, ks, device="cpu") == acc
    assert tg1.msm([], [], device="cpu") == G1Point.infinity()
    with pytest.raises(ValueError):
        tg1.msm(pts, [1 << 130] * 3, bits=128, device="cpu")


def test_msm_grouped_matches_jax():
    """Ragged groups with an empty one and an ∞ member (the JAX test's
    shape, so the JAX side reuses its compiled program)."""
    rng = random.Random(22)
    groups = [3, 1, 0, 4]
    pts = [[G1_GENERATOR.mul(rng.randrange(1, R)) for _ in range(n)] for n in groups]
    ks = [[rng.randrange(R) for _ in range(n)] for n in groups]
    pts[3][2] = G1Point.infinity()
    assert _xy(tg1.msm_grouped(pts, ks, device="cpu")) == _xy(jg1.msm_grouped(pts, ks))


def test_tree_reduce_sums_and_pad_matches_jax():
    rng = random.Random(6)
    pts = _points(rng) + [G1_GENERATOR.mul(rng.randrange(1, R)) for _ in range(4)]
    X, Y, Z = (T(a.T.copy()) for a in tg1.points_to_projective(pts))
    (sX, sY, sZ), n = tg1._pad_pow2([a.T.numpy() for a in (X, Y, Z)], len(pts))
    got = tg1.tree_reduce(tuple(T(a.T.copy())[:, None, :] for a in (sX, sY, sZ)), n)
    acc = G1Point.infinity()
    for p in pts:
        acc = acc + p
    assert tg1.projective_to_points(*(g.reshape(1, -1) for g in got)) == [acc]
    nrng = np.random.default_rng(4)
    arrs = [nrng.integers(0, 9, size=(5, 33), dtype=np.int32) for _ in range(4)]
    (ta, tm), (ja, jm) = tg1._pad_pow2(arrs, 5), jg1._pad_pow2(arrs, 5)
    assert tm == jm == 8
    for a, b in zip(ta, ja):
        np.testing.assert_array_equal(a, b)


def test_host_codecs_match_jax():
    rng = random.Random(5)
    pts = _points(rng)
    for a, b in zip(tg1.points_to_projective(pts), jg1.points_to_projective(pts)):
        np.testing.assert_array_equal(a, b)
    X, Y, Z = tg1.points_to_projective(pts)
    assert tg1.projective_to_points(T(X), T(Y), T(Z)) == pts
    assert _xy(jg1.projective_to_points(X, Y, Z)) == _xy(pts)
    ks = [0, 1, R - 1, rng.randrange(R)]
    np.testing.assert_array_equal(tg1.scalars_to_limbs(ks), jg1.scalars_to_limbs(ks))
    be = np.frombuffer(rng.randbytes(4 * 48), dtype=np.uint8).reshape(2, 2, 48)
    np.testing.assert_array_equal(tg1.be48_to_limb_rows(be), jg1.be48_to_limb_rows(be))
    x = rng.randrange(P)
    np.testing.assert_array_equal(tg1.fp_to_limbs(x), jg1.fp_to_limbs(x))
    t = tg1.limbs_from_numpy(np.stack([tg1.fp_to_limbs(x)] * 2, 1), device="cpu")
    assert tg1.limbs_to_fp(tg1.limbs_to_numpy(t)[:, 1]) == x
