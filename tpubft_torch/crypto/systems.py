"""Threshold cryptosystem backends (port of tpubft/crypto/systems.py).

Ported: the "multisig-ed25519" scheme — k-of-n multisig whose combined
signature is the sorted list of (signer_id, ed25519_sig) pairs — with
its signer, accumulator, verifier and factory, the one certificate
serializer `pack_multisig_vector`, and the configure-time resolution of
the "adaptive" scheme. The accumulator defers share verification
(accumulate first, verify the combined result, and only on failure
identify bad shares), concord-bft's SignaturesProcessingJob strategy.

The BLS schemes ("threshold-bls", "multisig-bls") wait for the BLS
slice: `register_builtin` raises NotImplementedError for them.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence

from tpubft_torch.crypto.cpu import Ed25519Signer, Ed25519Verifier
from tpubft_torch.crypto.interfaces import (Cryptosystem,
                                            IThresholdAccumulator,
                                            IThresholdFactory,
                                            IThresholdSigner,
                                            IThresholdVerifier)


# ---------------- multisig-ed25519 ----------------

def pack_multisig_vector(ids: Sequence[int],
                         shares: Dict[int, bytes]) -> bytes:
    """THE multisig-vector certificate encoding: <H count, then per
    signer <H id + 64-byte ed25519 sig, ids in the given order. The one
    serializer for both the accumulator and the fused combine paths —
    their byte-identity is a pinned correctness invariant."""
    out = bytearray(struct.pack("<H", len(ids)))
    for i in ids:
        out += struct.pack("<H", i)
        out += shares[i]
    return bytes(out)


class MultisigEd25519Signer(IThresholdSigner):
    def __init__(self, signer_id: int, seed_or_sk: bytes):
        self._signer = Ed25519Signer(seed_or_sk)
        self._id = signer_id

    def sign_share(self, data: bytes) -> bytes:
        return self._signer.sign(data)

    @property
    def signer_id(self) -> int:
        return self._id


class MultisigEd25519Accumulator(IThresholdAccumulator):
    def __init__(self, verifier: "MultisigEd25519Verifier", share_verification: bool):
        self._verifier = verifier
        self._share_verification = share_verification
        self._digest: Optional[bytes] = None
        self._shares: Dict[int, bytes] = {}

    def set_expected_digest(self, digest: bytes) -> None:
        self._digest = digest

    def add(self, share_id: int, share: bytes) -> int:
        if self._share_verification and self._digest is not None:
            if not self._verifier.verify_share(share_id, self._digest, share):
                return len(self._shares)
        self._shares[share_id] = share
        return len(self._shares)

    def has_threshold(self) -> bool:
        return len(self._shares) >= self._verifier.threshold

    def get_full_signed_data(self) -> bytes:
        ids = sorted(self._shares)[: self._verifier.threshold]
        return pack_multisig_vector(ids, self._shares)

    def identify_bad_shares(self) -> List[int]:
        assert self._digest is not None
        return [i for i, s in self._shares.items()
                if not self._verifier.verify_share(i, self._digest, s)]


class MultisigEd25519Verifier(IThresholdVerifier):
    def __init__(self, threshold: int, total: int, share_public_keys: Sequence[bytes]):
        self._threshold = threshold
        self._total = total
        self._share_verifiers = [Ed25519Verifier(pk) for pk in share_public_keys]

    def new_accumulator(self, with_share_verification: bool) -> MultisigEd25519Accumulator:
        return MultisigEd25519Accumulator(self, with_share_verification)

    def verify_share(self, share_id: int, data: bytes, share: bytes) -> bool:
        if not 1 <= share_id <= self._total:
            return False
        return self._share_verifiers[share_id - 1].verify(data, share)

    def verify(self, data: bytes, sig: bytes) -> bool:
        try:
            (k,) = struct.unpack_from("<H", sig, 0)
            if k < self._threshold:
                return False
            off = 2
            seen = set()
            for _ in range(k):
                (i,) = struct.unpack_from("<H", sig, off)
                off += 2
                share = sig[off:off + 64]
                off += 64
                if i in seen or not self.verify_share(i, data, share):
                    return False
                seen.add(i)
            return off == len(sig)
        except (struct.error, IndexError):
            return False

    @property
    def threshold(self) -> int:
        return self._threshold

    @property
    def total_signers(self) -> int:
        return self._total


class MultisigEd25519Factory(IThresholdFactory):
    def new_signer(self, signer_id: int, secret_share: bytes) -> MultisigEd25519Signer:
        return MultisigEd25519Signer(signer_id, secret_share)

    def new_verifier(self, threshold, total, public_key, share_public_keys):
        return MultisigEd25519Verifier(threshold, total, share_public_keys)

    def keygen(self, threshold: int, total: int, seed: Optional[bytes] = None):
        import hashlib
        sks, pks = [], []
        for i in range(total):
            s = (hashlib.sha256(b"ms-ed" + seed + i.to_bytes(4, "big")).digest()
                 if seed is not None else None)
            signer = Ed25519Signer.generate(seed=s)
            sks.append(signer.private_bytes)
            pks.append(signer.public_bytes())
        # no single master public key for multisig; use the pk list
        return pks, pks, sks

_BLS_TYPES = ("threshold-bls", "multisig-bls")


def register_builtin(type_name: str) -> None:
    if type_name == "multisig-ed25519":
        Cryptosystem.register_type(type_name, MultisigEd25519Factory())
    elif type_name in _BLS_TYPES:
        raise NotImplementedError(
            f"cryptosystem {type_name!r} is not ported yet (BLS slice)")
    else:
        raise ValueError(f"unknown cryptosystem type {type_name}"
                         + (" ('adaptive' must be resolved by "
                            "resolve_threshold_scheme before key "
                            "generation)" if type_name == "adaptive"
                            else ""))


# Default n-crossover for the "adaptive" certificate scheme. Below it a
# cluster certifies with the Ed25519 multisig vector (k constant-time
# EdDSA verifies, batch-friendly, zero G1 ladder math); at or above it
# with compact BLS threshold certificates (48 bytes on the wire and in
# every carried proof, vs 66·k for the vector). The EdDSA-vs-BLS
# committee measurements (arXiv 2302.00418) put per-share threshold math
# far above EdDSA cost at committee sizes this small; the default is
# picked by `python -m benchmarks.bench_combine --crossover`
# (benchmarks/RESULTS.md) and overridable per cluster via
# ReplicaConfig.threshold_scheme_crossover_n.
ADAPTIVE_SCHEME_CROSSOVER_N = 16


def resolve_threshold_scheme(scheme: str, n: int,
                             crossover_n: int = 0,
                             aggregation: str = "off") -> str:
    """Configure-time resolution of the certificate scheme: "adaptive"
    becomes a concrete cryptosystem type from the cluster size, anything
    else passes through. Every replica must resolve identically (same n,
    same crossover, same aggregation mode) — the scheme is part of the
    cluster's key material, so it is resolved once at keygen, never
    re-negotiated on the wire.

    When share aggregation is on, "adaptive" resolves to "multisig-bls"
    regardless of n: interior overlay nodes must produce partial
    aggregates, which Shamir threshold shares cannot (the Lagrange
    weights depend on the final contributor set) and the Ed25519 vector
    only can by concatenation (no bandwidth win). BLS multisig partials
    are a constant 56 bytes at every tree level, which is the whole
    point of aggregating (arXiv 1911.04698)."""
    if scheme != "adaptive":
        return scheme
    if aggregation and aggregation != "off":
        return "multisig-bls"
    cx = crossover_n or ADAPTIVE_SCHEME_CROSSOVER_N
    return "multisig-ed25519" if n < cx else "threshold-bls"
