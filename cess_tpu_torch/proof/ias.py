"""IAS attestation-report verification — the enclave-verify equivalent.

Re-expresses the capability of the reference's `verify_miner_cert`
(reference: primitives/enclave-verify/src/lib.rs:135-219): base64-decode
the attached signing certificate, validate it against a pinned root set
at a FIXED verification time, then check the RSA-PKCS1-SHA256 signature
of the raw report JSON with the certificate's public key.  The X.509/DER
work (the vendored-webpki role, reference: utils/webpki/src/
{cert,verify_cert,signed_data}.rs) is host-side Python here — certificate
parsing is control-plane work; the report-signature modexps are the data
plane and run batched on the card (ops/rsa.verify_batch → ops/bigmod).

Scope matches the reference's actual checks: end-entity certificate
chained directly to a pinned root (the IAS report-signing cert is issued
straight from Intel's attestation root; `intermediate_report` is empty at
lib.rs:150), validity window containing the pinned time, and the report
signature.  The root store is injectable: production pins Intel's root
DER; the node simulator pins a fixture CA and fabricates reports, the
same strategy as the reference's round-trip test
(enclave-verify/src/lib.rs:242-255).

Only RSA keys and sha256WithRSAEncryption signatures are supported — the
algorithms the IAS chain actually uses (webpki call at lib.rs:165-169
pins RSA_PKCS1_2048_8192_SHA256).

A copy of `cess_tpu/proof/ias.py` bound to the port's `rsa`; the two
attestation entry points run their modexps on the card unless
`device="cpu"` is passed.
"""

from __future__ import annotations

import base64
import binascii
from dataclasses import dataclass

from ..device import resolve_device
from ..ops import rsa

# Reference pins 2022-12-09 00:00:00 UTC (enclave-verify/src/lib.rs:151).
FIXED_VERIFY_TIME = 1670515200

# DER OIDs (encoded, without tag/length)
_OID_SHA256_RSA = bytes.fromhex("2a864886f70d01010b")  # 1.2.840.113549.1.1.11
_OID_RSA_ENC = bytes.fromhex("2a864886f70d010101")  # 1.2.840.113549.1.1.1
_OID_CN = bytes.fromhex("550403")  # 2.5.4.3


class DerError(ValueError):
    pass


# ---------------------------------------------------------------- DER read


def _read_tlv(data: bytes, off: int) -> tuple[int, bytes, int]:
    """One TLV: returns (tag, content, offset past the element)."""
    if off + 2 > len(data):
        raise DerError("truncated TLV header")
    tag = data[off]
    length = data[off + 1]
    off += 2
    if length & 0x80:
        nbytes = length & 0x7F
        if nbytes == 0 or nbytes > 4 or off + nbytes > len(data):
            raise DerError("bad long-form length")
        length = int.from_bytes(data[off : off + nbytes], "big")
        off += nbytes
    if off + length > len(data):
        raise DerError("content overruns buffer")
    return tag, data[off : off + length], off + length


def _expect(data: bytes, off: int, want_tag: int) -> tuple[bytes, int]:
    tag, content, nxt = _read_tlv(data, off)
    if tag != want_tag:
        raise DerError(f"expected tag {want_tag:#x}, got {tag:#x}")
    return content, nxt


def _der_int(content: bytes) -> int:
    if not content:
        raise DerError("empty INTEGER")
    return int.from_bytes(content, "big")


def _parse_time(tag: int, content: bytes) -> int:
    """UTCTime/GeneralizedTime → unix seconds (UTC, 'Z' suffix only).
    Every malformed-bytes failure maps to DerError so crafted
    certificates cannot crash the verifier."""
    try:
        s = content.decode("ascii")
    except UnicodeDecodeError as e:
        raise DerError("non-ASCII time") from e
    if not s.endswith("Z"):
        raise DerError("non-UTC time")
    s = s[:-1]
    try:
        if tag == 0x17:  # UTCTime YYMMDDHHMMSS
            year = int(s[0:2])
            year += 2000 if year < 50 else 1900
            rest = s[2:]
        elif tag == 0x18:  # GeneralizedTime YYYYMMDDHHMMSS
            year = int(s[0:4])
            rest = s[4:]
        else:
            raise DerError("unknown time tag")
        month, day = int(rest[0:2]), int(rest[2:4])
        hour, minute = int(rest[4:6]), int(rest[6:8])
        sec = int(rest[8:10]) if len(rest) >= 10 else 0
    except ValueError as e:
        raise DerError("malformed time digits") from e
    # days since epoch (proleptic Gregorian, no tz)
    y, m = year, month
    if m <= 2:
        y, m = y - 1, m + 12
    era = y // 400
    yoe = y - era * 400
    doy = (153 * (m - 3) + 2) // 5 + day - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    days = era * 146097 + doe - 719468
    return ((days * 24 + hour) * 60 + minute) * 60 + sec


@dataclass(frozen=True)
class Certificate:
    """The fields `verify_cert`-style validation needs (the webpki
    EndEntityCert role, reference: utils/webpki/src/cert.rs)."""

    tbs_raw: bytes  # the signed bytes (full TBSCertificate TLV)
    issuer: bytes  # raw Name DER (byte-compared, as webpki does)
    subject: bytes
    not_before: int
    not_after: int
    public_key: rsa.RsaPublicKey
    sig_alg_oid: bytes
    signature: bytes


def parse_certificate(der: bytes) -> Certificate:
    cert_body, end = _expect(der, 0, 0x30)
    if end != len(der):
        raise DerError("trailing bytes after certificate")
    # re-read inside the outer SEQUENCE
    base = der[: end]
    inner_off = end - len(cert_body)
    # tbsCertificate: keep the RAW TLV (it is what the CA signed)
    tbs_tag, tbs_content, tbs_end = _read_tlv(base, inner_off)
    if tbs_tag != 0x30:
        raise DerError("bad tbsCertificate")
    tbs_raw = base[inner_off:tbs_end]
    # signatureAlgorithm
    alg_content, alg_end = _expect(base, tbs_end, 0x30)
    alg_oid, _ = _expect(alg_content, 0, 0x06)
    # signatureValue
    sig_tag, sig_content, sig_end = _read_tlv(base, alg_end)
    if sig_tag != 0x03 or not sig_content or sig_content[0] != 0:
        raise DerError("bad signature BIT STRING")
    signature = sig_content[1:]
    if sig_end != end:
        raise DerError("trailing bytes in certificate body")

    # --- walk the TBS fields
    off = 0
    tag, _, nxt = _read_tlv(tbs_content, off)
    if tag == 0xA0:  # [0] EXPLICIT version
        off = nxt
        tag, _, nxt = _read_tlv(tbs_content, off)
    if tag != 0x02:
        raise DerError("missing serialNumber")
    off = nxt  # past serialNumber
    _, off = _expect(tbs_content, off, 0x30)  # signature AlgorithmIdentifier
    iss_tag, iss_content, iss_end = _read_tlv(tbs_content, off)
    if iss_tag != 0x30:
        raise DerError("bad issuer Name")
    issuer = tbs_content[off:iss_end]
    validity, off = _expect(tbs_content, iss_end, 0x30)
    t1_tag, t1, t1_end = _read_tlv(validity, 0)
    t2_tag, t2, _ = _read_tlv(validity, t1_end)
    not_before = _parse_time(t1_tag, t1)
    not_after = _parse_time(t2_tag, t2)
    subj_tag, subj_content, subj_end = _read_tlv(tbs_content, off)
    if subj_tag != 0x30:
        raise DerError("bad subject Name")
    subject = tbs_content[off:subj_end]
    spki, _ = _expect(tbs_content, subj_end, 0x30)
    spki_alg, spki_off = _expect(spki, 0, 0x30)
    key_oid, _ = _expect(spki_alg, 0, 0x06)
    if key_oid != _OID_RSA_ENC:
        raise DerError("unsupported key algorithm")
    bit_tag, bit_content, _ = _read_tlv(spki, spki_off)
    if bit_tag != 0x03 or not bit_content or bit_content[0] != 0:
        raise DerError("bad subjectPublicKey")
    rsakey, _ = _expect(bit_content[1:], 0, 0x30)
    n_content, n_end = _expect(rsakey, 0, 0x02)
    e_content, _ = _expect(rsakey, n_end, 0x02)
    return Certificate(
        tbs_raw=tbs_raw,
        issuer=issuer,
        subject=subject,
        not_before=not_before,
        not_after=not_after,
        public_key=rsa.RsaPublicKey(_der_int(n_content), _der_int(e_content)),
        sig_alg_oid=alg_oid,
        signature=signature,
    )


# ---------------------------------------------------------------- chain


@dataclass(frozen=True)
class RootStore:
    """Pinned trust anchors (the IAS_SERVER_ROOTS role, reference:
    enclave-verify/src/lib.rs:46-93): subject Name DER → RSA key."""

    roots: tuple[Certificate, ...]

    @classmethod
    def from_der(cls, ders: list[bytes]) -> "RootStore":
        return cls(tuple(parse_certificate(d) for d in ders))

    def key_for_issuer(self, issuer: bytes) -> rsa.RsaPublicKey | None:
        for root in self.roots:
            if root.subject == issuer:
                return root.public_key
        return None


def verify_cert(
    cert: Certificate, roots: RootStore, at_time: int = FIXED_VERIFY_TIME
) -> bool:
    """End-entity validation against the pinned roots at a fixed time —
    the webpki verify_is_valid_tls_server_cert role as the reference uses
    it (no intermediates, fixed clock; enclave-verify/src/lib.rs:148-158).
    """
    if cert.sig_alg_oid != _OID_SHA256_RSA:
        return False
    if not cert.not_before <= at_time <= cert.not_after:
        return False
    issuer_key = roots.key_for_issuer(cert.issuer)
    if issuer_key is None:
        return False
    return rsa.verify(issuer_key, cert.tbs_raw, cert.signature)


# ---------------------------------------------------------------- reports


def _b64(data: bytes) -> bytes | None:
    try:
        return base64.b64decode(data, validate=True)
    except (binascii.Error, ValueError):
        return None


def verify_attestation(
    sign: bytes,
    cert_der_b64: bytes,
    report_json_raw: bytes,
    roots: RootStore,
    at_time: int = FIXED_VERIFY_TIME,
    device=None,
) -> bool:
    """Single-report path, mirroring verify_miner_cert's order of checks
    (reference: enclave-verify/src/lib.rs:135-219): decode cert → chain
    check → decode signature → report-signature check."""
    out = verify_attestation_batch(
        [(sign, cert_der_b64, report_json_raw)], roots, at_time, device
    )
    return out[0]


def verify_attestation_batch(
    reports: list[tuple[bytes, bytes, bytes]],
    roots: RootStore,
    at_time: int = FIXED_VERIFY_TIME,
    device=None,
) -> list[bool]:
    """Batched attestation verification: the certificate chain checks are
    host-side; the report signatures are grouped per signing key and run
    through the batched device modexp (ops/rsa.verify_batch).  Verdicts
    are bit-identical to the single path.  device: None = the card."""
    device = resolve_device(device)
    parsed: list[tuple[int, rsa.RsaPublicKey, bytes, bytes] | None] = []
    for idx, (sign, cert_der_b64, report_json) in enumerate(reports):
        cert_der = _b64(cert_der_b64)
        sig = _b64(sign)
        if cert_der is None or sig is None:
            parsed.append(None)
            continue
        try:
            cert = parse_certificate(cert_der)
        except DerError:
            parsed.append(None)
            continue
        if not verify_cert(cert, roots, at_time):
            parsed.append(None)
            continue
        parsed.append((idx, cert.public_key, report_json, sig))

    verdicts = [False] * len(reports)
    by_key: dict[rsa.RsaPublicKey, list[tuple[int, bytes, bytes]]] = {}
    for entry in parsed:
        if entry is None:
            continue
        idx, key, msg, sig = entry
        by_key.setdefault(key, []).append((idx, msg, sig))
    for key, items in by_key.items():
        results = rsa.verify_batch(key, [(m, s) for _, m, s in items], device)
        for (idx, _, _), ok in zip(items, results):
            verdicts[idx] = ok
    return verdicts


# ---------------------------------------------------------------- fixtures
# Minimal DER writer for test/simulator certificates — the counterpart of
# the reference's round-trip fixtures (enclave-verify/src/lib.rs:242-255).


def _tlv(tag: int, content: bytes) -> bytes:
    n = len(content)
    if n < 0x80:
        return bytes([tag, n]) + content
    blen = (n.bit_length() + 7) // 8
    return bytes([tag, 0x80 | blen]) + n.to_bytes(blen, "big") + content


def _der_int_enc(x: int) -> bytes:
    raw = x.to_bytes((x.bit_length() + 7) // 8 or 1, "big")
    if raw[0] & 0x80:
        raw = b"\x00" + raw
    return _tlv(0x02, raw)


def _name(cn: str) -> bytes:
    atv = _tlv(
        0x30,
        _tlv(0x06, _OID_CN) + _tlv(0x0C, cn.encode()),
    )
    return _tlv(0x30, _tlv(0x31, atv))


def _utc(ts: int) -> bytes:
    days = ts // 86400
    rem = ts % 86400
    # inverse of the civil-from-days conversion above
    z = days + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + 3 if mp < 10 else mp - 9
    if m <= 2:
        y += 1
    s = f"{y % 100:02d}{m:02d}{d:02d}{rem // 3600:02d}{(rem % 3600) // 60:02d}{rem % 60:02d}Z"
    return _tlv(0x17, s.encode())


def build_certificate(
    subject_cn: str,
    issuer_cn: str,
    subject_key: rsa.RsaPublicKey,
    issuer_priv: rsa.RsaPrivateKey,
    not_before: int,
    not_after: int,
    serial: int = 1,
) -> bytes:
    """DER X.509 v3 certificate signed sha256WithRSAEncryption."""
    sig_alg = _tlv(0x30, _tlv(0x06, _OID_SHA256_RSA) + _tlv(0x05, b""))
    spki = _tlv(
        0x30,
        _tlv(0x30, _tlv(0x06, _OID_RSA_ENC) + _tlv(0x05, b""))
        + _tlv(
            0x03,
            b"\x00"
            + _tlv(
                0x30,
                _der_int_enc(subject_key.n) + _der_int_enc(subject_key.e),
            ),
        ),
    )
    tbs = _tlv(
        0x30,
        _tlv(0xA0, _der_int_enc(2))  # version v3
        + _der_int_enc(serial)
        + sig_alg
        + _name(issuer_cn)
        + _tlv(0x30, _utc(not_before) + _utc(not_after))
        + _name(subject_cn)
        + spki,
    )
    signature = rsa.sign(issuer_priv, tbs)
    return _tlv(0x30, tbs + sig_alg + _tlv(0x03, b"\x00" + signature))


def fixture_authority(rng=None, bits: int = 2048):
    """A self-signed fixture root + its key (simulator genesis)."""
    priv = rsa.keygen(bits, rng)
    der = build_certificate(
        "CESS Sim Attestation Root",
        "CESS Sim Attestation Root",
        priv.public(),
        priv,
        not_before=FIXED_VERIFY_TIME - 86400 * 365,
        not_after=FIXED_VERIFY_TIME + 86400 * 3650,
    )
    return der, priv


def fixture_report(
    issuer_priv: rsa.RsaPrivateKey,
    report_json: bytes,
    rng=None,
    bits: int = 2048,
    issuer_cn: str = "CESS Sim Attestation Root",
):
    """(sign, cert_der_b64, report_json) as a registering TEE submits."""
    signer = rsa.keygen(bits, rng)
    cert = build_certificate(
        "CESS Sim Report Signer",
        issuer_cn,
        signer.public(),
        issuer_priv,
        not_before=FIXED_VERIFY_TIME - 86400,
        not_after=FIXED_VERIFY_TIME + 86400 * 365,
        serial=7,
    )
    sig = rsa.sign(signer, report_json)
    return base64.b64encode(sig), base64.b64encode(cert), report_json


# ---------------------------------------------------------------- binding


def report_binds_key(report_json_raw: bytes, podr2_pbk: bytes) -> bool:
    """The attested report must bind the PoDR2 public key the worker is
    registering — otherwise any valid attestation triple could be
    replayed to register an arbitrary key.  (The reference extracts the
    worker key FROM the verified quote body rather than trusting the
    extrinsic's copy: enclave-verify/src/lib.rs:176-219.)  The report is
    JSON with a `podr2_pbk` hex field; parse failures bind nothing."""
    import json

    try:
        body = json.loads(report_json_raw)
    except (ValueError, UnicodeDecodeError):
        return False
    field = body.get("podr2_pbk")
    return isinstance(field, str) and field == podr2_pbk.hex()
