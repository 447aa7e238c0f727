"""ops/h2c.py of the port against the JAX package's: the canonical
predicates give the same digits, and the twins of kernel K1 (the pair
map) and kernel K4 (the t^((p−3)/4) chain) give the JAX functions'
projective outputs mod p, one coordinate at a time — the SSWU-exceptional
inputs and the extremes u ∈ {0, 1, p−1, 2, p−2} included."""

import jax.numpy as jnp
import numpy as np
import torch

from cess_tpu.ops import h2c as jh2c
from cess_tpu_torch.ops import bls12_381 as bls
from cess_tpu_torch.ops import g1 as tg1
from cess_tpu_torch.ops import h2c as th2c

# The twins run thousands of tiny ops: with several test workers on one
# host, intra-op threads cost more in wake-ups than they save.
torch.set_num_threads(1)

DST = b"cess/podr2/h/v1"
P = bls.P
T = torch.as_tensor
NEG_INV_Z = -pow(th2c.Z_SSWU, P - 2, P) % P


def _modp(a) -> list[int]:
    a = np.asarray(a)
    return [tg1.limbs_to_fp(a[:, j]) % P for j in range(a.shape[1])]


def _map_inputs(us):
    """u values (2n of them, pair j = us[2j], us[2j+1]) → (u, sgn, exc)."""
    n = len(us) // 2
    u = np.zeros((33, 2, n), np.int32)
    sgn = np.zeros((2, n), np.int32)
    exc = np.zeros((2, n), np.int32)
    for j in range(n):
        for e in range(2):
            uu = us[2 * j + e]
            u[:, e, j] = tg1.fp_to_limbs(uu)
            sgn[e, j] = uu & 1
            exc[e, j] = int(uu == 0 or uu * uu % P == NEG_INV_Z)
    return u, sgn, exc


def test_canonical_predicates_match_jax():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4097, size=(33, 8), dtype=np.int32)
    x[32] = rng.integers(0, 2, size=8)
    x[:, 0] = tg1.fp_to_limbs(P)  # ≡ 0
    x[:, 1] = tg1.fp_to_limbs(P - 1)
    np.testing.assert_array_equal(
        th2c._canon_mod_p(T(x)).numpy(), np.asarray(jh2c._canon_mod_p(jnp.asarray(x)))
    )
    assert th2c._parity_mod_p(T(x)).tolist() == np.asarray(
        jh2c._parity_mod_p(jnp.asarray(x))).tolist()
    zero = th2c._is_zero_mod_p(T(x))
    assert zero.tolist() == np.asarray(jh2c._is_zero_mod_p(jnp.asarray(x))).tolist()
    assert zero.tolist() == [True] + [False] * 7
    y = x.copy()
    y[:, 2] = tg1.fp_to_limbs(tg1.limbs_to_fp(x[:, 2]) % P)
    assert th2c._eq_mod_p(T(x), T(y)).tolist()[2]


def test_pow_chain_twin_matches_jax():
    """K4's twin against the JAX chain, values 0, 1, p−1 and 2 included."""
    rng = np.random.default_rng(7)
    t = rng.integers(0, 4096, size=(33, 8), dtype=np.int32)
    t[31:] = 0
    for j, v in enumerate((0, 1, P - 1, 2)):
        t[:, j] = tg1.fp_to_limbs(v)
    got = th2c._pow_c1(T(t))
    want = jh2c._pow_c1(jnp.asarray(t))
    assert _modp(got) == _modp(want)
    c1 = (P - 3) // 4
    assert _modp(got) == [pow(tg1.limbs_to_fp(t[:, j]), c1, P) for j in range(8)]


def test_map_twin_matches_jax_on_edge_u():
    """The pair map (K1's twin) on the exceptional and extreme inputs of
    the JAX package's own edge test, then on random field elements at
    the same shape, against the JAX map and the host reference."""
    cand = [0, 1, P - 1, 2, P - 2, 5, 7, 11]
    rng = np.random.default_rng(11)
    rand = [int.from_bytes(rng.bytes(48), "big") % P for _ in range(8)]
    for us in (cand, rand):
        u, sgn, exc = _map_inputs(us)
        got = th2c._map_pairs_kernel(T(u), T(sgn), T(exc))
        want = jh2c._map_pairs_kernel(jnp.asarray(u), jnp.asarray(sgn), jnp.asarray(exc))
        for g, w in zip(got, want):
            assert _modp(g) == _modp(w)
        host = tg1.projective_to_points(*(g.T for g in got))
        for j, p in enumerate(host):
            assert p == bls.map_to_curve_g1(us[2 * j]) + bls.map_to_curve_g1(us[2 * j + 1])


def test_map_twin_on_the_exceptional_square_root():
    """u² ≡ −1/Z: the CMOV branch of SSWU (tv2 = 0)."""
    r = bls.fp_sqrt(NEG_INV_Z)
    if r is None:  # −1/Z is a non-square for this p: no such u exists
        assert pow(NEG_INV_Z, (P - 1) // 2, P) == P - 1
        return
    u, sgn, exc = _map_inputs([r, P - r])
    assert exc.tolist() == [[1], [1]]
    got = th2c._map_pairs_kernel(T(u), T(sgn), T(exc))
    host = tg1.projective_to_points(*(g.T for g in got))
    assert host == [bls.map_to_curve_g1(r) + bls.map_to_curve_g1(P - r)]


def test_host_xmd_matches_jax_and_hash_matches_host():
    names = [b"h2c-%d" % i for i in range(4)]
    ids = np.repeat(np.arange(4, dtype=np.uint32), 2)
    idxs = np.tile(np.array([3, 99], dtype=np.uint64), 4)
    for a, b in zip(th2c.u_for_pairs(names, ids, idxs, DST),
                    jh2c.u_for_pairs(names, ids, idxs, DST)):
        np.testing.assert_array_equal(a, b)
    pts = th2c.hash_pairs_host_points(names, ids, idxs, DST, device="cpu")
    for p, (k, idx) in zip(pts, zip(ids, idxs)):
        msg = names[int(k)] + b"/" + int(idx).to_bytes(8, "little")
        assert p == bls.hash_to_g1(msg, DST)


def test_u_codec_matches_jax():
    rng = np.random.default_rng(1)
    u = rng.integers(0, 256, size=(5, 2, 48), dtype=np.uint8)
    np.testing.assert_array_equal(th2c.u_bytes_to_limbs(u), jh2c.u_bytes_to_limbs(u))
