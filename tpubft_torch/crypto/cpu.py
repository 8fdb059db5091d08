"""Host signer/verifier backends (port of tpubft/crypto/cpu.py): Ed25519
and ECDSA over secp256k1 / P-256 (secp256r1).

The implementation underneath is the port's own pure-Python engine
(crypto/scalar.py), so the port works with numpy, torch and the stdlib
alone. The reference may route host signing and verifying through
OpenSSL when the `cryptography` package is present (cpu.py:33-58); the
port leaves that accelerator out. Ed25519 signatures are byte-identical
either way (RFC 8032 is deterministic); ECDSA signs by RFC 6979 here,
where the reference's OpenSSL branch draws a random nonce: both verify
identically, and here they are reproducible.

Backend order for a verify:
  1. the batched CUDA kernels — SigManager.verify_batch / BatchVerifier
     (Ed25519 verify, ECDSA's RLC fold);
  2. the scalar engine — always available; the degraded tier
     (`EcdsaVerifier.verify_batch` rides its batched walk).

All signatures use fixed-length raw encodings (64-byte r||s for ECDSA,
65-byte SEC1 uncompressed public keys).
"""
from __future__ import annotations

import os
from typing import Optional

from tpubft_torch.crypto import scalar
from tpubft_torch.crypto.interfaces import ISigner, IVerifier

ED25519_SIG_LEN = 64
ED25519_PK_LEN = 32
ECDSA_SIG_LEN = 64  # raw r||s, 32B each


class Ed25519Signer(ISigner):
    def __init__(self, private_key_bytes: bytes):
        if len(private_key_bytes) != 32:
            raise ValueError("ed25519 private key must be 32 bytes")
        self.private_bytes = private_key_bytes
        self._pub: Optional[bytes] = None

    @classmethod
    def generate(cls, seed: Optional[bytes] = None) -> "Ed25519Signer":
        if seed is not None:
            return cls(scalar.ed25519_seed_to_private(seed))
        return cls(os.urandom(32))

    def sign(self, data: bytes) -> bytes:
        return scalar.ed25519_sign(self.private_bytes, data,
                                   pk=self.public_bytes())

    def sign_batch(self, datas) -> list:
        """Batch signing seam (SigManager.sign_batch): the engine
        amortizes the per-signature field inversion across the batch."""
        return scalar.ed25519_sign_batch(self.private_bytes, datas,
                                         pk=self.public_bytes())

    @property
    def signature_length(self) -> int:
        return ED25519_SIG_LEN

    def public_bytes(self) -> bytes:
        if self._pub is None:
            self._pub = scalar.ed25519_public_key(self.private_bytes)
        return self._pub


class Ed25519Verifier(IVerifier):
    def __init__(self, public_key_bytes: bytes):
        if len(public_key_bytes) != ED25519_PK_LEN:
            raise ValueError("ed25519 public key must be 32 bytes")
        self.public_key_bytes = public_key_bytes

    def verify(self, data: bytes, sig: bytes) -> bool:
        if len(sig) != ED25519_SIG_LEN:
            return False
        return scalar.ed25519_verify(self.public_key_bytes, data, sig)

    @property
    def signature_length(self) -> int:
        return ED25519_SIG_LEN


# ---------------- ECDSA (secp256k1 / P-256), raw r||s signatures ----------------
# The reference's classes (cpu.py:147-247) on the scalar engine alone:
# its OpenSSL branches (`_sk`, `_pk`) are left out.

class EcdsaSigner(ISigner):
    def __init__(self, private_value: int, curve: str = "secp256k1"):
        if curve not in scalar.CURVES:
            raise ValueError(f"unknown curve {curve}")
        if not 1 <= private_value < scalar.CURVES[curve]["n"]:
            # invalid keys must not fail late
            raise ValueError("ECDSA private value out of range [1, n-1]")
        self.curve_name = curve
        self.private_value = private_value
        self._pub: Optional[bytes] = None

    @classmethod
    def generate(cls, curve: str = "secp256k1",
                 seed: Optional[bytes] = None) -> "EcdsaSigner":
        if seed is not None:
            return cls(scalar.ecdsa_seed_to_private(seed, curve), curve)
        return cls(scalar.ecdsa_random_private(curve), curve)

    def sign(self, data: bytes) -> bytes:
        return scalar.ecdsa_sign(self.private_value, data, self.curve_name)

    @property
    def signature_length(self) -> int:
        return ECDSA_SIG_LEN

    def public_bytes(self) -> bytes:
        """Uncompressed SEC1 point (0x04 || x || y), 65 bytes."""
        if self._pub is None:
            self._pub = scalar.ecdsa_public_key(self.private_value,
                                                self.curve_name)
        return self._pub


class EcdsaVerifier(IVerifier):
    def __init__(self, public_key_bytes: bytes, curve: str = "secp256k1"):
        if curve not in scalar.CURVES:
            raise ValueError(f"unknown curve {curve}")
        self.curve_name = curve
        self.public_key_bytes = public_key_bytes
        if (len(public_key_bytes) != 65 or public_key_bytes[0] != 0x04
                or not scalar.ecdsa_on_curve(
                    int.from_bytes(public_key_bytes[1:33], "big"),
                    int.from_bytes(public_key_bytes[33:], "big"),
                    curve)):
            raise ValueError("invalid SEC1 uncompressed public key")

    def verify(self, data: bytes, sig: bytes) -> bool:
        if len(sig) != ECDSA_SIG_LEN:
            return False
        return scalar.ecdsa_verify(self.public_key_bytes, data, sig,
                                   self.curve_name)

    @property
    def uses_scalar_engine(self) -> bool:
        """Always True here: verifies run on the in-repo scalar engine,
        whose batches ride ecdsa_verify_batch."""
        return True

    def verify_batch(self, items) -> list:
        """Batch verification through the Montgomery/comb engine
        (scalar.ecdsa_verify_batch): what keeps degraded mode (breaker
        OPEN, no device) at thousands of verifies/sec instead of the
        per-item ladder's tens."""
        if len(items) > 1:
            return scalar.ecdsa_verify_batch(
                [(self.public_key_bytes, d, s) for d, s in items],
                self.curve_name)
        return [self.verify(d, s) for d, s in items]

    @property
    def signature_length(self) -> int:
        return ECDSA_SIG_LEN


# the ECDSA scheme names and their curves
ECDSA_CURVES = {"ecdsa-secp256k1": "secp256k1", "secp256k1": "secp256k1",
                "ecdsa-secp256r1": "secp256r1", "secp256r1": "secp256r1",
                "ecdsa-p256": "secp256r1"}


def make_signer(scheme: str, seed: Optional[bytes] = None) -> ISigner:
    if scheme == "ed25519":
        return Ed25519Signer.generate(seed=seed)
    if scheme in ECDSA_CURVES:
        return EcdsaSigner.generate(ECDSA_CURVES[scheme], seed=seed)
    raise ValueError(f"unknown signature scheme {scheme}")


def make_verifier(scheme: str, public_key_bytes: bytes) -> IVerifier:
    if scheme == "ed25519":
        return Ed25519Verifier(public_key_bytes)
    if scheme in ECDSA_CURVES:
        return EcdsaVerifier(public_key_bytes, ECDSA_CURVES[scheme])
    raise ValueError(f"unknown signature scheme {scheme}")
