"""Host signer/verifier backends (port of the Ed25519 half of
tpubft/crypto/cpu.py).

The implementation underneath is the port's own pure-Python engine
(crypto/scalar.py), so the port works with numpy, torch and the stdlib
alone. The reference may route host signing through OpenSSL when the
`cryptography` package is present; the signatures are byte-identical
either way (RFC 8032 is deterministic), so the port leaves that
accelerator out.

Backend order for a verify:
  1. the batched CUDA kernel — SigManager.verify_batch / BatchVerifier;
  2. the scalar engine — always available; the degraded tier.

ECDSA signers and verifiers wait for their slice and raise
NotImplementedError here.
"""
from __future__ import annotations

import os
from typing import Optional

from tpubft_torch.crypto import scalar
from tpubft_torch.crypto.interfaces import ISigner, IVerifier

ED25519_SIG_LEN = 64
ED25519_PK_LEN = 32

_ECDSA_SCHEMES = ("ecdsa-secp256k1", "secp256k1", "ecdsa-secp256r1",
                  "secp256r1", "ecdsa-p256")


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


def make_signer(scheme: str, seed: Optional[bytes] = None) -> ISigner:
    if scheme == "ed25519":
        return Ed25519Signer.generate(seed=seed)
    if scheme in _ECDSA_SCHEMES:
        raise NotImplementedError(f"{scheme} signing is not ported yet")
    raise ValueError(f"unknown signature scheme {scheme}")


def make_verifier(scheme: str, public_key_bytes: bytes) -> IVerifier:
    if scheme == "ed25519":
        return Ed25519Verifier(public_key_bytes)
    if scheme in _ECDSA_SCHEMES:
        raise NotImplementedError(f"{scheme} verification is not ported yet")
    raise ValueError(f"unknown signature scheme {scheme}")
