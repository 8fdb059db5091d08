"""DER and PEM for the TLS transport's key material, written without the
`cryptography` package (used only by comm/tls.generate_tls_material).

The reference writes its certificates and keys through `cryptography`'s
x509 builder and serializers (tpubft/comm/tls.py:148-194); the machine
with the card has no such package, so the port writes the same
structures itself:

  * a v3 self-signed certificate (RFC 5280 §4.1): CN tpubft-node-<id> as
    a UTF8String, a positive random serial of at most 20 octets, validity
    as UTCTime (both dates fall before 2050), SubjectPublicKeyInfo
    id-ecPublicKey / prime256v1 with the uncompressed point, signed
    ecdsa-with-SHA256 (no parameters) by the node's own key through
    crypto/scalar.ecdsa_sign, the signature an Ecdsa-Sig-Value;
  * the private key as an unencrypted PKCS#8 PrivateKeyInfo (RFC 5208)
    wrapping ECPrivateKey version 1 (RFC 5915) with the 32-byte key and
    the public key in [1];
  * with a password, EncryptedPrivateKeyInfo under PBES2 (RFC 8018):
    PBKDF2 with hmacWithSHA256 (NULL parameters), a 16-byte salt and
    2,048 iterations, then aes256-CBC with its IV as an OCTET STRING,
    over PKCS#7 padding, through the port's native/aescbc.cpp. These are
    the parameters `cryptography`'s BestAvailableEncryption writes (the
    OpenSSL default PKCS5_DEFAULT_ITER), so OpenSSL loads either.
"""
from __future__ import annotations

import base64
import datetime
import hashlib
import os
from typing import Tuple

from tpubft_torch.crypto import scalar

# object identifiers, as their DER content octets' dotted forms
OID_EC_PUBLIC_KEY = "1.2.840.10045.2.1"
OID_PRIME256V1 = "1.2.840.10045.3.1.7"
OID_ECDSA_SHA256 = "1.2.840.10045.4.3.2"
OID_COMMON_NAME = "2.5.4.3"
OID_PBES2 = "1.2.840.113549.1.5.13"
OID_PBKDF2 = "1.2.840.113549.1.5.12"
OID_HMAC_SHA256 = "1.2.840.113549.2.9"
OID_AES256_CBC = "2.16.840.1.101.3.4.1.42"

PBKDF2_ITERATIONS = 2048
CURVE = "secp256r1"


# ---- encoders ----

def _tlv(tag: int, content: bytes) -> bytes:
    n = len(content)
    if n < 0x80:
        length = bytes([n])
    else:
        raw = n.to_bytes((n.bit_length() + 7) // 8, "big")
        length = bytes([0x80 | len(raw)]) + raw
    return bytes([tag]) + length + content


def integer(v: int) -> bytes:
    """A non-negative INTEGER: minimal big-endian octets, with a leading
    zero octet where the high bit would otherwise read as a sign."""
    if v < 0:
        raise ValueError("only non-negative integers are written")
    raw = v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big")
    if raw[0] & 0x80:
        raw = b"\x00" + raw
    return _tlv(0x02, raw)


def sequence(*items: bytes) -> bytes:
    return _tlv(0x30, b"".join(items))


def set_of(*items: bytes) -> bytes:
    return _tlv(0x31, b"".join(sorted(items)))


def octet_string(b: bytes) -> bytes:
    return _tlv(0x04, b)


def bit_string(b: bytes) -> bytes:
    return _tlv(0x03, b"\x00" + b)        # no unused bits


def null() -> bytes:
    return b"\x05\x00"


def utf8_string(s: str) -> bytes:
    return _tlv(0x0C, s.encode())


def utc_time(t: datetime.datetime) -> bytes:
    if not 1950 <= t.year < 2050:
        raise ValueError("UTCTime covers 1950-2049 only")
    return _tlv(0x17, t.astimezone(datetime.timezone.utc)
                .strftime("%y%m%d%H%M%SZ").encode())


def explicit(n: int, inner: bytes) -> bytes:
    """[n] EXPLICIT (context-specific, constructed)."""
    return _tlv(0xA0 | n, inner)


def oid(dotted: str) -> bytes:
    arcs = [int(a) for a in dotted.split(".")]
    body = bytearray([40 * arcs[0] + arcs[1]])
    for arc in arcs[2:]:
        chunk = [arc & 0x7F]
        arc >>= 7
        while arc:
            chunk.append(0x80 | (arc & 0x7F))
            arc >>= 7
        body += bytes(reversed(chunk))
    return _tlv(0x06, bytes(body))


def pem(label: str, der: bytes) -> bytes:
    b64 = base64.b64encode(der).decode()
    lines = [b64[i:i + 64] for i in range(0, len(b64), 64)]
    return (f"-----BEGIN {label}-----\n" + "\n".join(lines)
            + f"\n-----END {label}-----\n").encode()


# ---- the structures ----

def _ec_algorithm() -> bytes:
    return sequence(oid(OID_EC_PUBLIC_KEY), oid(OID_PRIME256V1))


def subject_public_key_info(public_point: bytes) -> bytes:
    """SubjectPublicKeyInfo of a P-256 key (`public_point`: 0x04||x||y)."""
    return sequence(_ec_algorithm(), bit_string(public_point))


def _name(common_name: str) -> bytes:
    return sequence(set_of(sequence(oid(OID_COMMON_NAME),
                                    utf8_string(common_name))))


def ecdsa_sig_value(raw: bytes) -> bytes:
    """scalar.ecdsa_sign's r||s (32 bytes each) -> Ecdsa-Sig-Value."""
    return sequence(integer(int.from_bytes(raw[:32], "big")),
                    integer(int.from_bytes(raw[32:], "big")))


def random_serial() -> int:
    """A positive serial of at most 159 bits (20 octets with the sign
    octet), as x509.random_serial_number draws it."""
    while True:
        v = int.from_bytes(os.urandom(20), "big") >> 1
        if v:
            return v


def self_signed_certificate(d: int, common_name: str,
                            not_before: datetime.datetime,
                            not_after: datetime.datetime,
                            serial: int) -> bytes:
    """DER of a v3 certificate for private value `d` on P-256, issued by
    and to `common_name`, signed by `d` itself."""
    pub = scalar.ecdsa_public_key(d, CURVE)
    alg = sequence(oid(OID_ECDSA_SHA256))
    name = _name(common_name)
    tbs = sequence(explicit(0, integer(2)), integer(serial), alg, name,
                   sequence(utc_time(not_before), utc_time(not_after)),
                   name, subject_public_key_info(pub))
    sig = ecdsa_sig_value(scalar.ecdsa_sign(d, tbs, CURVE))
    return sequence(tbs, alg, bit_string(sig))


def private_key_info(d: int) -> bytes:
    """PKCS#8 PrivateKeyInfo wrapping ECPrivateKey (version 1, the
    32-byte key, the public key in [1]; the curve is in the algorithm
    identifier, so [0] is left out, as OpenSSL writes it)."""
    pub = scalar.ecdsa_public_key(d, CURVE)
    ec_key = sequence(integer(1), octet_string(d.to_bytes(32, "big")),
                      explicit(1, bit_string(pub)))
    return sequence(integer(0), _ec_algorithm(), octet_string(ec_key))


def encrypted_private_key_info(d: int, password: bytes,
                               salt: bytes = None, iv: bytes = None,
                               iterations: int = PBKDF2_ITERATIONS) -> bytes:
    """EncryptedPrivateKeyInfo: PBES2 (PBKDF2-HMAC-SHA256, AES-256-CBC)
    over private_key_info(d)."""
    from tpubft_torch.secrets.manager import _pad, aes256_cbc
    salt = os.urandom(16) if salt is None else salt
    iv = os.urandom(16) if iv is None else iv
    key = hashlib.pbkdf2_hmac("sha256", password, salt, iterations,
                              dklen=32)
    body = aes256_cbc(key, iv, _pad(private_key_info(d)))
    kdf = sequence(oid(OID_PBKDF2),
                   sequence(octet_string(salt), integer(iterations),
                            sequence(oid(OID_HMAC_SHA256), null())))
    enc = sequence(oid(OID_AES256_CBC), octet_string(iv))
    return sequence(sequence(oid(OID_PBES2), sequence(kdf, enc)),
                    octet_string(body))


def tls_material(d: int, common_name: str,
                 password: str = None) -> Tuple[bytes, bytes]:
    """-> (key PEM, certificate PEM) for one node: valid from five
    minutes ago for 3650 days, as the reference's builder sets them."""
    now = datetime.datetime.now(datetime.timezone.utc).replace(microsecond=0)
    cert = self_signed_certificate(
        d, common_name, now - datetime.timedelta(minutes=5),
        now + datetime.timedelta(days=3650), random_serial())
    if password:
        key = pem("ENCRYPTED PRIVATE KEY",
                  encrypted_private_key_info(d, password.encode()))
    else:
        key = pem("PRIVATE KEY", private_key_info(d))
    return key, pem("CERTIFICATE", cert)
