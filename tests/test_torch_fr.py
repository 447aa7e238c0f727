"""ops/fr.py of the port against the JAX package's: the Fr limb
contraction (`weighted_sum_kernel`), its reductions and codecs give the
same canonical limbs, and μ aggregation matches Python mod-r sums."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cess_tpu.ops import fr as jfr
from cess_tpu_torch.ops import fr as tfr

# The twins run thousands of tiny ops: with several test workers on one
# host, intra-op threads cost more in wake-ups than they save.
torch.set_num_threads(1)

R = tfr.R


def _limbs(ints, n):
    return np.stack([tfr.int_to_limbs(int(x), n) for x in ints])


@pytest.mark.parametrize("shape", [(4, 19, 4, 37), (47, 21, 5, 36)])
def test_weighted_sum_kernel_matches_jax(shape):
    """Same int8 limbs in, the same canonical int32 limbs out — including
    all-127 worst-case limbs (values above r, reduced by the kernel)."""
    k, lw, s, lv = shape
    rng = np.random.default_rng(k)
    w = rng.integers(0, 128, size=(k, lw), dtype=np.int8)
    v = rng.integers(0, 128, size=(s, k, lv), dtype=np.int8)
    w[0] = 127
    v[0, :, :] = 127
    want = np.asarray(jfr.weighted_sum_kernel(jnp.asarray(w), jnp.asarray(v)))
    got = tfr.weighted_sum_kernel(torch.as_tensor(w), torch.as_tensor(v))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    ws = [tfr.limbs_to_int(r) for r in w]
    for j in range(s):
        exact = sum(a * tfr.limbs_to_int(v[j, i]) for i, a in enumerate(ws)) % R
        assert tfr.limbs_to_int(got[j].numpy()) == exact


def test_fold_to_canonical_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 129, size=(6, 45), dtype=np.int32)
    want = np.asarray(jfr._fold_to_canonical(jnp.asarray(x)))
    got = tfr._fold_to_canonical(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), want)
    x2 = rng.integers(0, 1 << 20, size=(3, 40), dtype=np.int32)
    np.testing.assert_array_equal(
        tfr._normalize(torch.as_tensor(x2)).numpy(),
        np.asarray(jfr._normalize(jnp.asarray(x2))),
    )


def test_mu_aggregate_and_combine_match_python():
    rnd = random.Random(99)
    K, J = 47, 5
    weights = [rnd.getrandbits(160) for _ in range(K)]
    values = [[rnd.getrandbits(248) for _ in range(J)] for _ in range(K)]
    out = tfr.mu_aggregate(weights, tfr.sectors_to_limbs(values)[None], "cpu")
    assert tfr.limbs_to_ints(out) == [
        sum(w * values[k][j] for k, w in enumerate(weights)) % R for j in range(J)
    ]
    B, S = 16, 7
    mus = [[rnd.randrange(R) for _ in range(S)] for _ in range(B)]
    rhos = [rnd.getrandbits(128) | 1 for _ in range(B)]
    out = tfr.combine_mu(rhos, np.stack([tfr.fr_to_limbs(m) for m in mus]), "cpu")
    assert tfr.limbs_to_ints(out) == [
        sum(r * mus[b][j] for b, r in enumerate(rhos)) % R for j in range(S)
    ]


def test_large_contraction_is_split_and_exact():
    B = tfr.SAFE_CONTRACTION + 77
    mus = [[tfr.limbs_to_int([127] * 37) % R] for _ in range(B)]
    rhos = [(1 << 128) - 1] * B
    out = tfr.combine_mu(rhos, np.stack([tfr.fr_to_limbs(m) for m in mus]), "cpu")
    assert tfr.limbs_to_ints(out) == [sum(r * m[0] for r, m in zip(rhos, mus)) % R]


def test_codecs_match_jax():
    rnd = random.Random(3)
    xs = [0, 1, R - 1, (1 << 255) - 1] + [rnd.getrandbits(250) for _ in range(6)]
    np.testing.assert_array_equal(tfr.ints_to_words(xs, 32), jfr.ints_to_words(xs, 32))
    words = tfr.ints_to_words(xs, 32)
    for bits, n in ((7, 37), (12, 22)):
        np.testing.assert_array_equal(
            tfr.words_to_limbs(words, bits, n, np.int32),
            jfr.words_to_limbs(words, bits, n, np.int32),
        )
    np.testing.assert_array_equal(tfr.ints_to_limbs(xs, 37), jfr.ints_to_limbs(xs, 37))
    limbs = _limbs(xs, 37)
    assert tfr.limbs_to_ints(torch.as_tensor(limbs)) == jfr.limbs_to_ints(limbs) == xs
