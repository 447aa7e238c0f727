"""ops/bigmod.py, ops/rsa.py and proof/ias.py of the port against the JAX
package's, on device="cpu": the modmul and s^65537 limbs equal the JAX
functions' output arrays exactly, and the RSA and IAS verdicts, batched
and single, equal cess_tpu's item for item.  The moduli, keys and
fixtures are those of tests/test_bigmod.py, test_rsa.py and test_ias.py
(512- and 1024-bit), so the JAX side compiles few modexp shapes.  The
tolerance is zero: exact limbs and verdicts."""

import base64
import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cess_tpu.ops import bigmod as jbigmod
from cess_tpu.ops import rsa as jrsa
from cess_tpu.proof import ias as jias
from cess_tpu_torch.ops import bigmod, rsa
from cess_tpu_torch.proof import ias

# The port runs many tiny ops: with several test workers on one host,
# intra-op threads cost more in wake-ups than they save.
torch.set_num_threads(1)

_RNG = random.Random(7)
MOD = _RNG.getrandbits(512) | (1 << 511) | 1  # tests/test_bigmod.py:14
XS = [_RNG.randrange(MOD) for _ in range(6)] + [0, MOD - 1]
YS = [_RNG.randrange(MOD) for _ in range(6)] + [MOD - 1, MOD - 1]
SIGS = [_RNG.randrange(MOD) for _ in range(5)] + [0, 1, MOD - 1]


# ------------------------------------------------------------------ bigmod


def test_context_tables_equal_the_jax_package():
    ctx, jctx = bigmod.ModContext.create(MOD), jbigmod.ModContext.create(MOD)
    assert ctx.nlimbs == jctx.nlimbs
    for name in ("mod_limbs", "fold_table", "mod_shifts"):
        np.testing.assert_array_equal(getattr(ctx, name), getattr(jctx, name))
    for x in XS:
        limbs = bigmod.int_to_limbs(x, ctx.nlimbs)
        np.testing.assert_array_equal(limbs, jbigmod.int_to_limbs(x, ctx.nlimbs))
        assert bigmod.limbs_to_int(limbs) == x


def test_modmul_limbs_equal_the_jax_output():
    ctx = bigmod.ModContext.create(MOD)
    a, b = ctx.to_device_limbs(XS), ctx.to_device_limbs(YS)
    want = np.asarray(jbigmod.make_modmul(jbigmod.ModContext.create(MOD))(
        jnp.asarray(a), jnp.asarray(b)))
    got = bigmod.make_modmul(ctx)(torch.as_tensor(a), torch.as_tensor(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert ctx.from_device_limbs(got) == [x * y % MOD for x, y in zip(XS, YS)]


def test_modexp_limbs_equal_the_jax_output():
    """Edge values 0, 1 and n−1 included; the JAX side is the jitted
    function its modexp_65537_batch calls."""
    ctx = bigmod.ModContext.create(MOD)
    limbs = ctx.to_device_limbs(SIGS)
    want = np.asarray(jbigmod._cached_modexp(MOD)(jnp.asarray(limbs)))
    got = bigmod.make_modexp_65537(ctx)(torch.as_tensor(limbs))
    np.testing.assert_array_equal(got.numpy(), want)
    expect = [pow(s, 65537, MOD) for s in SIGS]
    assert bigmod.modexp_65537_batch(SIGS, MOD, device="cpu") == expect
    assert jbigmod.modexp_65537_batch(SIGS, MOD) == expect


def test_modexp_batch_walk_in_pieces(monkeypatch):
    """A temporary budget smaller than the batch walks it in pieces of
    three lanes; the values do not change."""
    monkeypatch.setattr(bigmod, "TEMP_BYTES", 3 * bigmod.lane_temp_bytes(74))
    assert bigmod.modexp_65537_batch(SIGS, MOD, device="cpu") == [
        pow(s, 65537, MOD) for s in SIGS]
    assert bigmod.modexp_65537_batch([], MOD, device="cpu") == []


def test_cond_sub_prefix_scan_equals_the_sequential_scan():
    """The prefix-scan borrows against the JAX package's lax.scan, on
    unnormalized limbs (up to 130) around the modulus: equal limbs."""
    ctx = bigmod.ModContext.create(MOD)
    rng = np.random.default_rng(3)
    m = ctx.mod_shifts[-1]
    x = rng.integers(0, 131, size=(16, m.shape[0]), dtype=np.int32)
    x[0] = m  # x = n exactly
    x[1] = m
    x[1, 0] -= 1  # x = n − 1
    x[2] = m
    x[2, 5] += 1  # x = n + 2^35
    x[3, :] = 0
    want = np.asarray(jbigmod._cond_sub(jnp.asarray(x), jnp.asarray(m)))
    got = bigmod._cond_sub(torch.as_tensor(x), torch.as_tensor(m))
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------------ rsa
# Keys and fixtures are made once per module, when a test first asks
# (not at import: every test worker imports every test file).


@functools.cache
def _key():
    return rsa.keygen(1024, random.Random(0x52))  # tests/test_rsa.py:10


def _rsa_pairs(key):
    """Honest, tampered, mismatched message, short, long and s ≥ n."""
    pub = key.public()
    pairs = []
    for i in range(6):
        m = f"report-{i}".encode()
        sig = rsa.sign(key, m)
        if i == 2:
            sig = sig[:-1] + bytes([sig[-1] ^ 0xFF])
        if i == 4:
            m = b"swapped"
        pairs.append((m, sig))
    sig = rsa.sign(key, b"edge")
    pairs += [
        (b"edge", sig[:-1]),
        (b"edge", sig + b"\x00"),
        (b"edge", (pub.n + 1).to_bytes(pub.size_bytes, "big")),
        (b"edge", sig),
    ]
    return pairs


def test_rsa_keygen_and_sign_equal_the_jax_package():
    key = _key()
    jkey = jrsa.keygen(1024, random.Random(0x52))
    assert (jkey.n, jkey.e, jkey.d) == (key.n, key.e, key.d)
    assert rsa.sign(key, b"m") == jrsa.sign(jkey, b"m")
    assert rsa.SHA256_DIGEST_INFO == jrsa.SHA256_DIGEST_INFO


def test_rsa_verify_batch_equals_the_jax_package():
    key = _key()
    pub = key.public()
    pairs = _rsa_pairs(key)
    want = jrsa.verify_batch(jrsa.RsaPublicKey(pub.n, pub.e), pairs)
    got = rsa.verify_batch(pub, pairs, device="cpu")
    assert got == want == [rsa.verify(pub, m, s) for m, s in pairs]
    assert got == [True, True, False, True, False, True, False, False, False, True]
    assert rsa.verify_batch(pub, [], device="cpu") == []


def test_rsa_non_f4_exponent_falls_back_to_host_verify():
    n = _key().n
    pub = rsa.RsaPublicKey(n, 3)
    sig = b"\x01" * pub.size_bytes
    want = jrsa.verify_batch(jrsa.RsaPublicKey(n, 3), [(b"m", sig)])
    assert rsa.verify_batch(pub, [(b"m", sig)], device="cpu") == want == [
        rsa.verify(pub, b"m", sig)]


# ------------------------------------------------------------------ ias

REPORT = b'{"isvEnclaveQuoteStatus":"OK","body":"fixture"}'


@functools.cache
def _fixtures():
    """The root of tests/test_ias.py:15, then reports from two honest
    signers, a bad signature, a tampered report, an untrusted issuer, a
    forged certificate signature and garbage."""
    rng = random.Random(0x1A5)
    root_der, root_priv = ias.fixture_authority(rng, bits=1024)
    good = ias.fixture_report(root_priv, REPORT, rng, bits=1024)
    other = ias.fixture_report(root_priv, REPORT + b"2", rng, bits=1024)
    bad_sig = (base64.b64encode(bytes(b ^ 0xFF for b in base64.b64decode(good[0]))),
               good[1], REPORT)
    tampered = (good[0], good[1], REPORT + b" ")
    rogue_rng = random.Random(0xBAD)
    _, rogue_priv = ias.fixture_authority(rogue_rng, bits=1024)
    untrusted = ias.fixture_report(rogue_priv, REPORT, rogue_rng, bits=1024)
    forged = ias.fixture_report(rogue_priv, REPORT, rogue_rng, bits=1024,
                                issuer_cn="CESS Sim Attestation Root")
    garbage = (b"!!!", b"???", REPORT)
    return root_der, root_priv, [good, bad_sig, other, tampered, untrusted, forged, garbage]


def test_ias_fixtures_and_parse_equal_the_jax_package():
    root_der, root_priv, reports = _fixtures()
    jder, jpriv = jias.fixture_authority(random.Random(0x1A5), bits=1024)
    assert jder == root_der and jpriv.n == root_priv.n
    for der in [root_der, base64.b64decode(reports[0][1])]:
        cert, jcert = ias.parse_certificate(der), jias.parse_certificate(der)
        for name in ("tbs_raw", "issuer", "subject", "not_before", "not_after",
                     "sig_alg_oid", "signature"):
            assert getattr(cert, name) == getattr(jcert, name), name
        assert (cert.public_key.n, cert.public_key.e) == (
            jcert.public_key.n, jcert.public_key.e)
    with pytest.raises(ias.DerError):
        ias.parse_certificate(b"\x30\x05ab")
    with pytest.raises(jias.DerError):
        jias.parse_certificate(b"\x30\x05ab")


def test_ias_batch_and_singles_equal_the_jax_package():
    root_der, _, reports = _fixtures()
    roots = ias.RootStore.from_der([root_der])
    jroots = jias.RootStore.from_der([root_der])
    want = jias.verify_attestation_batch(reports, jroots)
    got = ias.verify_attestation_batch(reports, roots, device="cpu")
    singles = [ias.verify_attestation(*r, roots, device="cpu") for r in reports]
    jsingles = [jias.verify_attestation(*r, jroots) for r in reports]
    assert got == want == singles == jsingles
    assert got == [True, False, True, False, False, False, False]
    late = ias.parse_certificate(base64.b64decode(reports[0][1])).not_after + 1
    assert ias.verify_attestation(*reports[0], roots, at_time=late, device="cpu") is False
    assert jias.verify_attestation(*reports[0], jroots, at_time=late) is False


def test_ias_report_binding_equals_the_jax_package():
    report = b'{"podr2_pbk":"' + (b"ab" * 4) + b'"}'
    for body, key in [(report, bytes.fromhex("ab" * 4)), (report, bytes.fromhex("cd" * 4)),
                      (b"not json", b"ab"), (b'{"other":1}', b"ab")]:
        assert ias.report_binds_key(body, key) == jias.report_binds_key(body, key)
