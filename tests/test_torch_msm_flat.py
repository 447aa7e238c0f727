"""The port's flat Pippenger MSM (ops/g1.py msm_wide) and its exact-digit
scalar machinery against the JAX package: exact_digits,
limb_product_digits (with its width guard) and scalars_to_digits against
cess_tpu.ops.g1's on the inputs of tests/test_msm_flat.py, so the JAX
side runs only the eager ops that file already runs; msm_wide on the CPU
against cess_tpu's host fold Σ [s_i]P_i, with raw 224-bit scalars v·h_eff
(never reduced mod r) on uncleared hash points, ∞ lanes, runs of equal
digits and several lane chunks.  The JAX package's own msm_wide test is
marked slow for its compile, so the port is held to the host fold."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cess_tpu.ops import bls12_381 as jbls
from cess_tpu.ops import g1 as jg1
from cess_tpu_torch.ops import g1
from cess_tpu_torch.ops.bls12_381 import G1Point, R

# The twins run thousands of tiny ops: with several test workers on one
# host, intra-op threads cost more in wake-ups than they save.
torch.set_num_threads(1)


def port_point(p):
    return G1Point.infinity() if p.is_infinity() else G1Point(p.x, p.y)


def host_fold(points, scalars):
    """cess_tpu's host reference: Σ [s_i]P_i with unreduced scalars."""
    acc = jbls.G1Point.infinity()
    for p, s in zip(points, scalars):
        acc = acc + p._mul_raw(s)
    return acc


def same(got, want) -> bool:
    return (got.is_infinity(), got.x, got.y) == (want.is_infinity(), want.x, want.y)


def test_limb_product_digits_match_jax():
    rng = random.Random(1)
    a_vals = [rng.randrange(0, 1 << 128) for _ in range(4)]
    b_vals = [rng.randrange(0, 1 << 160) for _ in range(4)]
    a = g1.scalars_to_digits(a_vals, 11)
    b = g1.scalars_to_digits(b_vals, 14)
    got = g1.limb_product_digits(torch.as_tensor(a), torch.as_tensor(b), 25).numpy()
    want = np.asarray(jg1.limb_product_digits(jnp.asarray(a), jnp.asarray(b), 25))
    np.testing.assert_array_equal(got, want)
    assert [g1.limbs_to_fp(got[:, j]) for j in range(4)] == [x * y for x, y in zip(a_vals, b_vals)]


def test_exact_digits_match_jax():
    """At the shape limb_product_digits hands it above, so the JAX side's
    eager ops are already compiled."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 27, size=(25, 4), dtype=np.int32)
    x[-2:] = 0  # the value must fit the digit width (caller contract)
    got = g1.exact_digits(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jg1.exact_digits(jnp.asarray(x))))
    for j in range(4):
        assert g1.limbs_to_fp(got[:, j]) == sum(int(x[i, j]) << (12 * i) for i in range(25))


def test_limb_product_width_guard():
    a = torch.zeros((17, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="too wide"):
        g1.limb_product_digits(a, a, 40)
    with pytest.raises(ValueError, match="too wide"):
        jg1.limb_product_digits(jnp.zeros((17, 2), jnp.int32), jnp.zeros((17, 2), jnp.int32), 40)


@pytest.mark.parametrize("bad, match", [([-1], "negative"), ([1 << 360], "width")])
def test_scalars_to_digits_match_jax(bad, match):
    vals = [0, 1, R, (1 << 352) - 1, 12345678901234567890]
    got = g1.scalars_to_digits(vals, 30)
    np.testing.assert_array_equal(got, jg1.scalars_to_digits(vals, 30))
    assert [g1.limbs_to_fp(got[:, j]) for j in range(len(vals))] == vals
    for fn in (g1.scalars_to_digits, jg1.scalars_to_digits):
        with pytest.raises(ValueError, match=match):
            fn(vals + bad, 30)


def test_msm_wide_raw_scalars_on_uncleared_points():
    """The cofactor-folding shape of the staged H fold: uncleared map
    outputs (order h·r) with v·h_eff scalars of 224 bits, beside
    subgroup and ∞ lanes, and scalars at and above r (which must not be
    reduced: [r]P ≠ ∞ off the subgroup) up to 2^300 − 1."""
    rnd = random.Random(224)
    unclear = [jbls.map_to_curve_g1(rnd.randrange(jbls.P)) for _ in range(10)]
    assert not any(p.in_subgroup() for p in unclear)
    pts = unclear + [jbls.G1_GENERATOR.mul(rnd.randrange(1, R)) for _ in range(3)]
    pts += [jbls.G1Point.infinity()] * 2 + [unclear[0]]
    scalars = [rnd.getrandbits(160) * jbls.H_EFF_G1 for _ in range(11)] + [0, 1, R, R + 1, (1 << 300) - 1]
    got = g1.msm_wide([port_point(p) for p in pts], scalars, bits=300, device="cpu")
    assert same(got, host_fold(pts, scalars))


@pytest.mark.parametrize("n, chunk", [(1, None), (3, None), (7, 4), (12, 16)])
def test_msm_wide_runs_of_equal_digits(monkeypatch, n, chunk):
    """Few distinct digits a window, digit-0 runs, odd lane counts and,
    with the chunk shrunk to `chunk` window-lanes, several lane chunks
    whose window sums add (24-bit scalars: two windows)."""
    if chunk is not None:
        monkeypatch.setattr(g1, "_FLAT_CHUNK", chunk)
    rnd = random.Random(n)
    pts = [jbls.map_to_curve_g1(rnd.randrange(jbls.P)) for _ in range(n)]
    scalars = [rnd.choice([0, 1, 4095, 4096, 4097, 0xFFF001, (1 << 24) - 1]) for _ in range(n)]
    got = g1.msm_wide([port_point(p) for p in pts], scalars, bits=24, device="cpu")
    assert same(got, host_fold(pts, scalars))


def test_msm_wide_refuses_bad_input():
    assert g1.msm_wide([], [], bits=224, device="cpu").is_infinity()
    p = port_point(jbls.G1_GENERATOR)
    with pytest.raises(ValueError, match="mismatch"):
        g1.msm_wide([p, p], [1], bits=224, device="cpu")
    with pytest.raises(ValueError, match="width"):
        g1.msm_wide([p], [1 << 240], bits=224, device="cpu")
    X, Y, Z = (torch.as_tensor(a.T.copy()) for a in g1.points_to_projective([p]))
    with pytest.raises(ValueError, match="windows"):
        g1.msm_flat_device((X, Y, Z), torch.zeros((18, 1), dtype=torch.int32), bits=224)
