"""Every constant table the port derives for itself equals the JAX
package's, byte for byte — and the constant blocks the CUDA kernels
receive in __constant__ memory decode to the same values."""

import numpy as np
import pytest

from cess_tpu.ops import bls12_381 as jbls
from cess_tpu.ops import fr as jfr
from cess_tpu.ops import g1 as jg1
from cess_tpu.ops import glv as jglv
from cess_tpu.ops import h2c as jh2c
from cess_tpu.ops import podr2 as jpodr2
from cess_tpu_torch.ops import _cuda, _sswu_g1
from cess_tpu_torch.ops import bls12_381 as tbls
from cess_tpu_torch.ops import fr as tfr
from cess_tpu_torch.ops import g1 as tg1
from cess_tpu_torch.ops import glv as tglv
from cess_tpu_torch.ops import h2c as th2c
from cess_tpu_torch.ops import podr2 as tpodr2

P = tbls.P
MONT = 1 << 384
FP_WORDS = 4 * 12 + 1  # p, R², R³, R mod p (12 words each) and −p⁻¹ mod 2³²


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _int(words) -> int:
    return sum(int(w) << (32 * i) for i, w in enumerate(words))


def _unmont(words) -> int:
    return _int(words) * pow(MONT, -1, P) % P


def test_curve_parameters():
    assert (tbls.P, tbls.R, tbls.BLS_X, tbls.H_EFF_G1) == (
        jbls.P, jbls.R, jbls.BLS_X, jbls.H_EFF_G1
    )
    assert tfr.R == jfr.R == tbls.R


@pytest.mark.parametrize("high", jg1._FOLD_HIGHS)
def test_g1_pow_table(high):
    _same(tg1._pow_table(tg1.NP_LIMBS, high), jg1._pow_table(jg1.NP_LIMBS, high))


def test_g1_sub_pad():
    _same(tg1._sub_pad(), jg1._sub_pad())


def test_h2c_tables():
    _same(th2c._kp_digits(), jh2c._kp_digits())
    assert th2c._C1_DIGITS == jh2c._C1_DIGITS
    assert (th2c.A_PRIME, th2c.B_PRIME, th2c.B3_PRIME, th2c.Z_SSWU, th2c.C2) == (
        jh2c.A_PRIME, jh2c.B_PRIME, jh2c.B3_PRIME, jh2c.Z_SSWU, jh2c.C2
    )
    for name in ("X_NUM", "X_DEN", "Y_NUM", "Y_DEN"):
        assert getattr(_sswu_g1, name) == getattr(jh2c._sswu_g1, name)


def test_h2c_const_registry():
    """The registered SSWU/isogeny constants: same value set, and each
    value's limb row in `_const_table` is the same on both sides (the
    registration order depends on which functions ran first)."""
    nt = th2c._ensure_const_registry()
    nj = jh2c._ensure_const_registry()
    assert set(th2c._CONST_VALUES) == set(jh2c._CONST_VALUES)
    tt, jt = th2c._const_table(nt), jh2c._const_table(nj)
    for v in th2c._CONST_VALUES:
        _same(tt[th2c._CONST_INDEX[v]], jt[jh2c._CONST_INDEX[v]])


def test_glv_constants():
    assert tglv.beta() == jglv.beta()
    assert tglv.LAMBDA == jglv.LAMBDA
    assert (tglv.K_LIMBS, tglv.N_WINDOWS) == (jglv.K_LIMBS, jglv.N_WINDOWS)
    _same(tglv._r_bits_msb(), jglv._r_bits_msb())
    scalars = [0, 1, 2, tbls.R - 1, tglv.LAMBDA, tglv.LAMBDA - 1, 1 << 200]
    for a, b in zip(tglv.decompose_to_limbs(scalars), jglv.decompose_to_limbs(scalars)):
        _same(a, b)


def test_fr_tables():
    _same(tfr._pow_table(tfr.NLIMBS, 40), jfr._pow_table(jfr.NLIMBS, 40))
    _same(tfr._fold_matrix(37, 19), jfr._fold_matrix(37, 19))


def test_podr2_keys_generators_and_chunk_points():
    for seed in (b"fused-tee", b"bench-tee"):
        assert tpodr2.keygen(seed) == jpodr2.keygen(seed)
    for s in (4, 8):
        got = tpodr2.u_generators(s)
        want = jpodr2.u_generators(s)
        assert [(p.x, p.y) for p in got] == [(p.x, p.y) for p in want]
    tp, jp = tpodr2.Podr2Params(), jpodr2.Podr2Params()
    assert (tp.n, tp.s, tp.fragment_bytes) == (jp.n, jp.s, jp.fragment_bytes)
    assert (tpodr2.H_DST, tpodr2.U_DST, tpodr2.RHO_DST) == (
        jpodr2.H_DST, jpodr2.U_DST, jpodr2.RHO_DST
    )
    for idx in (0, 7, 1023):
        a = tpodr2.chunk_point(b"frag", idx)
        b = jpodr2.chunk_point(b"frag", idx)
        assert (a.x, a.y) == (b.x, b.y)


def test_cuda_field_block():
    w = _cuda._consts_fp()
    assert len(w) == FP_WORDS
    assert _int(w[0:12]) == P
    assert _int(w[12:24]) == MONT * MONT % P
    assert _int(w[24:36]) == MONT ** 3 % P
    assert _int(w[36:48]) == MONT % P
    assert (w[48] * P) % (1 << 32) == (1 << 32) - 1  # −p⁻¹ mod 2³²
    assert _unmont(_cuda.mont(12345)) == 12345


def test_cuda_constant_blocks_decode():
    assert _cuda._CONSTS["ladder"]() == _cuda._consts_fp()

    pw = _cuda._consts_powc1()[FP_WORDS:]
    assert len(pw) == 128  # struct PowConsts: ndigits + digits[127]
    assert pw[0] == len(th2c._C1_DIGITS)
    assert tuple(pw[1 : 1 + pw[0]]) == jh2c._C1_DIGITS

    gl = _cuda._consts_glv()[FP_WORDS:]
    assert len(gl) == 12 + 1 + 64  # struct GlvConsts
    assert _unmont(gl[:12]) == jglv.beta()
    nbits = gl[12]
    assert "".join(map(str, gl[13 : 13 + nbits])) == bin(jbls.H_EFF_G1)[2:]

    mp = _cuda._consts_map()[FP_WORDS:]
    rows = [mp[12 * i : 12 * i + 12] for i in range(len(mp) // 12)]
    assert len(mp) == 12 * (5 + 55)  # struct MapConsts
    assert [_unmont(r) for r in rows[:5]] == [
        jh2c.A_PRIME, jh2c.B_PRIME, jh2c.B3_PRIME, jh2c.Z_SSWU, jh2c.C2
    ]
    iso = [_unmont(r) for r in rows[5:]]
    want = [c % P for name in ("X_NUM", "X_DEN", "Y_NUM", "Y_DEN")
            for c in getattr(jh2c._sswu_g1, name)]
    assert iso == want
