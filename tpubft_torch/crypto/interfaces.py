"""Crypto plugin interfaces — the boundary the TPU backend slots into.

Mirrors the reference's scheme-agnostic API:
  ISigner/IVerifier           — util/include/crypto_utils.hpp:41-55
  IThresholdSigner            — threshsign/include/threshsign/IThresholdSigner.h:19
  IThresholdVerifier          — threshsign/include/threshsign/IThresholdVerifier.h:23
  IThresholdAccumulator       — threshsign/include/threshsign/IThresholdAccumulator.h:22
  Cryptosystem                — threshsign/include/threshsign/ThresholdSignaturesTypes.h:41

Design deltas from the reference (TPU-first):
  * verifiers additionally expose `verify_batch` so backends can vectorize;
    the CPU backends loop, the TPU backend vmaps.
  * accumulators expose `get_pending_batch`/`absorb_batch_result` so share
    verification can be deferred to a batched TPU dispatch instead of being
    verified share-by-share inline.
"""
from __future__ import annotations

import abc
from typing import Dict, List, Optional, Sequence, Tuple


class ISigner(abc.ABC):
    @abc.abstractmethod
    def sign(self, data: bytes) -> bytes: ...

    @property
    @abc.abstractmethod
    def signature_length(self) -> int: ...


class IVerifier(abc.ABC):
    @abc.abstractmethod
    def verify(self, data: bytes, sig: bytes) -> bool: ...

    def verify_batch(self, items: Sequence[Tuple[bytes, bytes]]) -> List[bool]:
        """Default: sequential. TPU backend overrides with a vmapped kernel."""
        return [self.verify(d, s) for d, s in items]

    @property
    @abc.abstractmethod
    def signature_length(self) -> int: ...


class IThresholdSigner(abc.ABC):
    """Signs a share of a threshold signature with this replica's key share."""

    @abc.abstractmethod
    def sign_share(self, data: bytes) -> bytes: ...

    @property
    @abc.abstractmethod
    def signer_id(self) -> int: ...


class IThresholdAccumulator(abc.ABC):
    """Collects shares for one (digest) instance until threshold is reached.

    Reference semantics (IThresholdAccumulator.h): add shares (optionally with
    share verification), set the expected digest, extract the combined
    signature once >= threshold valid shares are present.
    """

    @abc.abstractmethod
    def set_expected_digest(self, digest: bytes) -> None: ...

    @abc.abstractmethod
    def add(self, share_id: int, share: bytes) -> int:
        """Add a share; returns number of shares accumulated."""

    @abc.abstractmethod
    def has_threshold(self) -> bool: ...

    @abc.abstractmethod
    def get_full_signed_data(self) -> bytes:
        """Combine shares into the threshold signature (Lagrange + MSM)."""

    @abc.abstractmethod
    def identify_bad_shares(self) -> List[int]:
        """Verify shares individually, return ids of invalid shares
        (reference: re-accumulation with share verification,
        CollectorOfThresholdSignatures.hpp:363-401)."""

    def add_partial(self, partial: bytes) -> int:
        """Absorb a PARTIAL AGGREGATE produced by an interior node of the
        share-aggregation overlay: a self-describing blob carrying the
        contributor bitmap plus the aggregated share, so the root can
        fold whole subtrees in at once while keeping per-contributor
        accounting (a forged partial bisects to the guilty subtree via
        its bitmap). Only schemes whose shares sum meaningfully without
        per-signer weighting support this — Shamir threshold shares do
        NOT (Lagrange coefficients depend on the final contributor set),
        which is why aggregation mode requires a multisig scheme."""
        raise NotImplementedError(
            "scheme does not support partial aggregation")


class IThresholdVerifier(abc.ABC):
    @abc.abstractmethod
    def new_accumulator(self, with_share_verification: bool) -> IThresholdAccumulator: ...

    @abc.abstractmethod
    def verify(self, data: bytes, sig: bytes) -> bool:
        """Verify a combined threshold signature."""

    def verify_batch_certs(self, items) -> list:
        """[(data, sig)] -> verdicts. Backends with an aggregated check
        (BLS random-linear-combination: ONE pairing check for the whole
        batch) override this; the default is the per-cert loop."""
        return [self.verify(d, s) for d, s in items]

    def combine_batch(self, jobs: Sequence[Tuple[bytes, Dict[int, bytes]]]
                      ) -> List[Tuple[bool, bytes, List[int]]]:
        """Fused cross-slot combine: jobs of (digest, {share_id: share})
        -> one (ok, combined_sig, bad_share_ids) per job. The default is
        the reference SignaturesProcessingJob strategy per job —
        accumulate WITHOUT share verification, combine, verify the
        combined signature, and only on failure identify bad shares.
        Batch-capable backends override this to fold every job's
        combine into one device call and every job's combined-signature
        check into one aggregated verification; overrides MUST return
        verdicts identical to this loop (a bad share fails only its own
        job), which the fused-combine equivalence tests pin down."""
        out: List[Tuple[bool, bytes, List[int]]] = []
        for digest, shares in jobs:
            acc = self.new_accumulator(with_share_verification=False)
            acc.set_expected_digest(digest)
            for sid, share in shares.items():
                acc.add(sid, share)
            combined = acc.get_full_signed_data()
            if self.verify(digest, combined):
                out.append((True, combined, []))
            else:
                out.append((False, b"", acc.identify_bad_shares()))
        return out

    @property
    def supports_partial_aggregation(self) -> bool:
        """True when this scheme's accumulators implement `add_partial`
        (the share-aggregation overlay requires it)."""
        return False

    def share_weight(self, share: bytes) -> int:
        """How many contributors one entry in a share dict represents.
        1 for a raw share; partial-aggregation schemes override this to
        return the contributor-bitmap popcount so quorum accounting
        counts signers, not datagrams."""
        return 1

    @property
    @abc.abstractmethod
    def threshold(self) -> int: ...

    @property
    @abc.abstractmethod
    def total_signers(self) -> int: ...


class IThresholdFactory(abc.ABC):
    @abc.abstractmethod
    def new_signer(self, signer_id: int, secret_share) -> IThresholdSigner: ...

    @abc.abstractmethod
    def new_verifier(self, threshold: int, total: int, public_key,
                     share_public_keys) -> IThresholdVerifier: ...

    @abc.abstractmethod
    def keygen(self, threshold: int, total: int, seed: Optional[bytes] = None): ...


class Cryptosystem:
    """Named registry of threshold schemes (ThresholdSignaturesTypes.h:30-41).

    Holds key material for one "era" and builds signers/verifiers for the
    three commit-path quorums (CryptoManager.hpp:109-111). Types:
      "multisig-ed25519"  — n independent Ed25519 sigs, concatenated multisig
      "threshold-bls"     — BLS12-381 threshold signatures (k-of-n, Shamir)
      "multisig-bls"      — BLS12-381 multisig (aggregate of identified shares)
    """

    _FACTORIES: Dict[str, "IThresholdFactory"] = {}

    @classmethod
    def register_type(cls, type_name: str, factory: IThresholdFactory) -> None:
        cls._FACTORIES[type_name] = factory

    @classmethod
    def factory(cls, type_name: str) -> IThresholdFactory:
        if type_name not in cls._FACTORIES:
            # Lazy registration of built-ins.
            from tpubft_torch.crypto import systems
            systems.register_builtin(type_name)
        return cls._FACTORIES[type_name]

    def __init__(self, type_name: str, threshold: int, num_signers: int,
                 seed: Optional[bytes] = None):
        self.type_name = type_name
        self.threshold_ = threshold
        self.num_signers = num_signers
        fac = self.factory(type_name)
        keys = fac.keygen(threshold, num_signers, seed=seed)
        self.public_key, self.share_public_keys, self.secret_shares = keys
        self._factory = fac

    def create_threshold_signer(self, signer_id: int) -> IThresholdSigner:
        """signer_id is 1-based, as in the reference."""
        return self._factory.new_signer(signer_id, self.secret_shares[signer_id - 1])

    def create_threshold_verifier(self, threshold: Optional[int] = None) -> IThresholdVerifier:
        return self._factory.new_verifier(
            threshold or self.threshold_, self.num_signers,
            self.public_key, self.share_public_keys)
