"""Threshold cryptosystem backends (port of tpubft/crypto/systems.py).

Rebuild of concord-bft's scheme registry + BLS backend
(threshsign/src/ThresholdSignaturesTypes.cpp:183-200 createThresholdVerifier/
Signer; threshsign/src/bls/relic/ BlsThresholdSigner/Verifier/Accumulator):

  "multisig-ed25519" — k-of-n multisig: the combined signature is the sorted
      list of (signer_id, ed25519_sig) pairs, with the one certificate
      serializer `pack_multisig_vector`;
  "threshold-bls"    — BLS12-381 k-of-n Shamir threshold: shares are G1
      points; accumulate = Lagrange + MSM; verify = pairing check;
  "multisig-bls"     — n independent BLS keys: the certificate is the sum
      of the contributors' shares plus a contributor bitmap
      (`pack_agg_cert`), the scheme share aggregation needs;

and the configure-time resolution of the "adaptive" scheme. The
accumulators defer share verification (accumulate first, verify the
combined result, and only on failure identify bad shares), concord-bft's
SignaturesProcessingJob strategy (CollectorOfThresholdSignatures.hpp:
291-407). The host BLS engine is tpubft_torch.crypto.bls12381.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

from tpubft_torch.crypto import bls12381 as bls
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


# ---------------- threshold-bls (BLS12-381) ----------------

class BlsThresholdSigner(IThresholdSigner):
    def __init__(self, signer_id: int, secret_share: int):
        self._id = signer_id
        self._sk = secret_share

    def sign_share(self, data: bytes) -> bytes:
        return bls.g1_compress(bls.sign(self._sk, data))

    @property
    def signer_id(self) -> int:
        return self._id


class BlsThresholdAccumulator(IThresholdAccumulator):
    """Accumulate G1 shares; combine = Lagrange + MSM (the device op)."""

    def __init__(self, verifier: "BlsThresholdVerifier", share_verification: bool):
        self._verifier = verifier
        self._share_verification = share_verification
        self._digest: Optional[bytes] = None
        self._shares: Dict[int, object] = {}

    def set_expected_digest(self, digest: bytes) -> None:
        self._digest = digest

    def add(self, share_id: int, share: bytes) -> int:
        if not 1 <= share_id <= self._verifier.total_signers:
            return len(self._shares)
        try:
            pt = bls.g1_decompress(share)
        except ValueError:
            return len(self._shares)
        if pt is None:
            return len(self._shares)
        if self._share_verification and self._digest is not None:
            if not self._verifier.verify_share(share_id, self._digest, share):
                return len(self._shares)
        self._shares[share_id] = pt
        return len(self._shares)

    def has_threshold(self) -> bool:
        return len(self._shares) >= self._verifier.threshold

    def get_full_signed_data(self) -> bytes:
        ids = sorted(self._shares)[: self._verifier.threshold]
        combined = bls.combine_shares(ids, [self._shares[i] for i in ids])
        return bls.g1_compress(combined)

    def identify_bad_shares(self) -> List[int]:
        """Aggregation-tree isolation: O(b·log n) pairing checks for b bad
        shares (reference BlsBatchVerifier.cpp:44,84) instead of the naive
        O(n) one-pairing-per-share sweep. One implementation shared with
        the fused path (verifier._identify_bad) so per-slot and fused
        bad-share verdicts can never diverge."""
        assert self._digest is not None
        return self._verifier._identify_bad(self._digest, self._shares)


class BlsThresholdVerifier(IThresholdVerifier):
    def __init__(self, threshold: int, total: int, master_pk, share_pks):
        self._threshold = threshold
        self._total = total
        self._master_pk = master_pk
        self._share_pks = share_pks

    def new_accumulator(self, with_share_verification: bool) -> BlsThresholdAccumulator:
        return BlsThresholdAccumulator(self, with_share_verification)

    def share_pk(self, share_id: int):
        if not 1 <= share_id <= self._total:
            raise ValueError(f"share id {share_id} out of range 1..{self._total}")
        return self._share_pks[share_id - 1]

    def verify_share(self, share_id: int, data: bytes, share: bytes) -> bool:
        if not 1 <= share_id <= self._total:
            return False
        try:
            pt = bls.g1_decompress(share)
        except ValueError:
            return False
        return bls.verify(self.share_pk(share_id), data, pt)

    def verify(self, data: bytes, sig: bytes) -> bool:
        try:
            pt = bls.g1_decompress(sig)
        except ValueError:
            return False
        return bls.verify(self._master_pk, data, pt)

    def verify_batch_certs(self, items) -> List[bool]:
        """Aggregated combined-cert verification: ONE pairing check for
        the whole batch via random linear combination —
        e(Σ z_i·sig_i, -g2) · e(Σ z_i·H(d_i), pk) == 1. The same
        soundness argument as batch_verify_shares (forged certs survive
        with probability 2^-128); on aggregate failure the rare path
        verifies per cert. Replaces k sequential ~2-pairing verifies with
        2 pairings + two k-point G1 MSMs."""
        out = [False] * len(items)
        pts, hs, idxs = [], [], []
        for i, (d, s) in enumerate(items):
            try:
                pt = bls.g1_decompress(s)
            except ValueError:
                continue
            if pt is None:
                continue
            pts.append(pt)
            hs.append(bls.hash_to_g1(d))
            idxs.append(i)
        if not pts:
            return out
        if len(pts) == 1:
            ok = bls.pairing_check([(pts[0], bls.g2_neg(bls.G2_GEN)),
                                    (hs[0], self._master_pk)])
            out[idxs[0]] = ok
            return out
        # the RLC transcript binds the FULL statement (master pk, each
        # digest, each signature) so coefficients are fixed only after
        # the adversary committed to every input, not just the sigs
        ctx = (b"certs" + bls.g2_compress(self._master_pk)
               + b"".join(items[i][0] + bls.g1_compress(p)
                          for i, p in zip(idxs, pts)))
        zs = bls._rlc_scalars(len(pts), ctx)
        agg_sig = bls.g1_msm(pts, zs)
        agg_h = bls.g1_msm(hs, zs)
        if bls.pairing_check([(agg_sig, bls.g2_neg(bls.G2_GEN)),
                              (agg_h, self._master_pk)]):
            for i in idxs:
                out[i] = True
            return out
        # aggregate failed (byzantine input in the batch): isolate
        for pt, h, i in zip(pts, hs, idxs):
            out[i] = bls.pairing_check([(pt, bls.g2_neg(bls.G2_GEN)),
                                        (h, self._master_pk)])
        return out

    # ---- fused cross-slot combine (the per-slot combine tax killer) ----

    def _decode_job_shares(self, shares: Dict[int, bytes]) -> Dict[int, object]:
        """Accumulator `add` semantics over a raw share dict: out-of-range
        ids and undecodable/infinity points are silently dropped — the
        job combines over what remains, exactly as the per-slot path."""
        pts: Dict[int, object] = {}
        for sid, share in shares.items():
            if not 1 <= sid <= self._total:
                continue
            try:
                pt = bls.g1_decompress(share)
            except ValueError:
                continue
            if pt is None:
                continue
            pts[sid] = pt
        return pts

    def _combine_segments(self, segments, digests=None) -> List:
        """[(ids, [share points])] -> one combined G1 point per segment.
        Host path: per-segment Lagrange + MSM; the CUDA subclass folds
        every segment into ONE segmented multi-MSM device launch (and,
        with the offload tier active, leases the launch to a verified
        helper first). `digests` carries the per-segment slot digests —
        unused here, but the offload soundness check needs them to bind
        each returned point to its statement."""
        return [bls.combine_shares(ids, pts) if ids else None
                for ids, pts in segments]

    def combine_batch(self, jobs) -> List[Tuple[bool, bytes, List[int]]]:
        """Fused combine across slots: all jobs' Lagrange+MSM combines in
        one pass (one device launch on the CUDA subclass), then ONE
        RLC-aggregated pairing check for every combined signature of the
        flush (`verify_batch_certs`). On aggregate failure the batcher
        isolates per job, and only failing jobs pay bad-share
        identification — one slot's byzantine share fails only its own
        job, sibling slots in the same flush still land. Verdicts are
        identical to the per-job default (interfaces.combine_batch)."""
        decoded = [(digest, self._decode_job_shares(shares))
                   for digest, shares in jobs]
        segments = []
        for _digest, pts in decoded:
            ids = sorted(pts)[: self._threshold]
            segments.append((ids, [pts[i] for i in ids]))
        combined = self._combine_segments(
            segments, digests=[digest for digest, _ in decoded])
        sigs = [bls.g1_compress(pt) for pt in combined]
        verdicts = self.verify_batch_certs(
            [(digest, sig) for (digest, _), sig in zip(decoded, sigs)])
        out: List[Tuple[bool, bytes, List[int]]] = []
        for (digest, pts), sig, ok in zip(decoded, sigs, verdicts):
            if ok:
                out.append((True, sig, []))
                continue
            out.append((False, b"", self._identify_bad(digest, pts)))
        return out

    def _identify_bad(self, digest: bytes, pts: Dict[int, object]
                      ) -> List[int]:
        """Aggregation-tree isolation over one failing job's decoded
        shares — the same BlsBatchVerifier walk the accumulator path
        runs (O(b·log n) pairing checks for b bad shares)."""
        h = bls.hash_to_g1(digest)
        ids = sorted(pts)
        tree = bls.BlsBatchVerifier([self.share_pk(i) for i in ids], h)
        verdicts = tree.batch_verify([pts[i] for i in ids])
        return [i for i, good in zip(ids, verdicts) if not good]

    @property
    def threshold(self) -> int:
        return self._threshold

    @property
    def total_signers(self) -> int:
        return self._total


class BlsThresholdFactory(IThresholdFactory):
    def new_signer(self, signer_id: int, secret_share: int) -> BlsThresholdSigner:
        return BlsThresholdSigner(signer_id, secret_share)

    def new_verifier(self, threshold, total, public_key, share_public_keys):
        return BlsThresholdVerifier(threshold, total, public_key, share_public_keys)

    def keygen(self, threshold: int, total: int, seed: Optional[bytes] = None):
        master_pk, share_pks, shares = bls.threshold_keygen(threshold, total, seed=seed)
        return master_pk, share_pks, shares


# ---------------- multisig-bls (BLS12-381, aggregation-friendly) ----------------
#
# n INDEPENDENT BLS keys (like multisig-ed25519, not Shamir): the combined
# certificate is an unweighted sum of identified G1 shares plus a
# contributor bitmap, verified against the sum of the contributors' G2
# public keys. Unlike Shamir threshold shares, any SUBSET of these shares
# sums to a meaningful partial aggregate — which is exactly what the
# share-aggregation overlay needs interior nodes to produce — so this is
# the scheme `share_aggregation` mode requires (the reference's
# "multisig-bls" role, threshsign BlsMultisigKeygen).

AGG_BITMAP_LEN = 8          # u64 LE contributor bitmap: 1-based id i -> bit i-1
AGG_CERT_LEN = AGG_BITMAP_LEN + 48   # bitmap + compressed G1 point


def pack_contributors(ids: Sequence[int]) -> int:
    bm = 0
    for i in ids:
        bm |= 1 << (i - 1)
    return bm


def unpack_contributors(bm: int) -> List[int]:
    return [i + 1 for i in range(bm.bit_length()) if bm >> i & 1]


def pack_agg_cert(ids: Sequence[int], pt) -> bytes:
    """THE multisig-bls certificate/partial encoding: u64 LE contributor
    bitmap + 48-byte compressed aggregate. One serializer for the
    accumulator, fused-combine, and interior-partial paths — byte-identity
    between a raw-share feed and a partial-aggregate feed of the same
    contributor set is a pinned invariant."""
    return struct.pack("<Q", pack_contributors(ids)) + bls.g1_compress(pt)


def unpack_agg_cert(blob: bytes) -> Optional[Tuple[List[int], object]]:
    """-> (sorted contributor ids, G1 point) or None if malformed."""
    if len(blob) != AGG_CERT_LEN:
        return None
    (bm,) = struct.unpack_from("<Q", blob, 0)
    if bm == 0:
        return None
    try:
        pt = bls.g1_decompress(blob[AGG_BITMAP_LEN:])
    except ValueError:
        return None
    if pt is None:
        return None
    return unpack_contributors(bm), pt


class BlsMultisigSigner(BlsThresholdSigner):
    """Same share shape as the threshold signer (H(m)^sk, compressed);
    only the key material differs (independent sk, not a Shamir share)."""


class BlsMultisigAccumulator(IThresholdAccumulator):
    """Accumulates raw shares AND interior-node partial aggregates.

    `add` accepts either form (48-byte raw share keyed by signer id, or a
    self-describing 56-byte bitmap+point partial) so the fused
    combine_batch default loop and the ShareCollector snapshot path feed
    it without caring which kind each entry is. Contributor sets must be
    disjoint — an overlapping add is rejected (first-come wins), which
    keeps the final sum a plain union and the cert deterministic."""

    def __init__(self, verifier: "BlsMultisigVerifier", share_verification: bool):
        self._verifier = verifier
        self._share_verification = share_verification
        self._digest: Optional[bytes] = None
        # entry key (signer id for raw, arbitrary for partial) ->
        # (contributor-id tuple, G1 point)
        self._entries: Dict[int, Tuple[Tuple[int, ...], object]] = {}
        self._contrib: set = set()

    def set_expected_digest(self, digest: bytes) -> None:
        self._digest = digest

    def _count(self) -> int:
        return len(self._contrib)

    def add(self, share_id: int, share: bytes) -> int:
        if len(share) == AGG_CERT_LEN:
            return self._add_partial_entry(share_id, share)
        if not 1 <= share_id <= self._verifier.total_signers:
            return self._count()
        if share_id in self._contrib:
            return self._count()
        try:
            pt = bls.g1_decompress(share)
        except ValueError:
            return self._count()
        if pt is None:
            return self._count()
        if self._share_verification and self._digest is not None:
            if not self._verifier.verify_share(share_id, self._digest, share):
                return self._count()
        self._entries[share_id] = ((share_id,), pt)
        self._contrib.add(share_id)
        return self._count()

    def add_partial(self, partial: bytes) -> int:
        """Absorb an interior node's partial aggregate; entry key is the
        smallest contributor id (stable + collision-free given the
        disjointness rule)."""
        dec = unpack_agg_cert(partial)
        if dec is None:
            return self._count()
        return self._add_partial_entry(dec[0][0], partial)

    def _add_partial_entry(self, key: int, partial: bytes) -> int:
        dec = unpack_agg_cert(partial)
        if dec is None:
            return self._count()
        ids, pt = dec
        if any(i > self._verifier.total_signers for i in ids):
            return self._count()
        if self._contrib.intersection(ids):
            return self._count()          # overlap: first-come wins
        if self._share_verification and self._digest is not None:
            if not bls.verify(self._verifier.agg_pk(ids), self._digest, pt):
                return self._count()
        self._entries[key] = (tuple(ids), pt)
        self._contrib.update(ids)
        return self._count()

    def has_threshold(self) -> bool:
        return self._count() >= self._verifier.threshold

    def contributor_ids(self) -> List[int]:
        return sorted(self._contrib)

    def points(self) -> List[object]:
        """Entry points in sorted-entry-key order (summation input)."""
        return [self._entries[k][1] for k in sorted(self._entries)]

    def get_full_signed_data(self) -> bytes:
        """ALL accumulated contributors, never threshold-truncated: the
        cert bytes depend only on the contributor SET, so a raw-share
        feed and a partial-aggregate feed of the same signers produce
        identical certificates."""
        acc = None
        for pt in self.points():
            acc = bls.g1_add(acc, pt)
        return pack_agg_cert(self.contributor_ids(), acc)

    def partial_signed_data(self) -> bytes:
        """Current partial aggregate (what an interior node flushes up).
        Same encoding as the certificate — a partial IS a cert over a
        sub-threshold contributor set."""
        return self.get_full_signed_data()

    def identify_bad_shares(self) -> List[int]:
        assert self._digest is not None
        return self._verifier._identify_bad_entries(self._digest, self._entries)


class BlsMultisigVerifier(IThresholdVerifier):
    def __init__(self, threshold: int, total: int, share_pks):
        self._threshold = threshold
        self._total = total
        self._share_pks = share_pks
        self._apk_cache: Dict[int, object] = {}

    def new_accumulator(self, with_share_verification: bool) -> BlsMultisigAccumulator:
        return BlsMultisigAccumulator(self, with_share_verification)

    @property
    def supports_partial_aggregation(self) -> bool:
        return True

    def share_weight(self, share: bytes) -> int:
        if len(share) == AGG_CERT_LEN:
            (bm,) = struct.unpack_from("<Q", share, 0)
            return max(bin(bm).count("1"), 1)
        return 1

    def share_pk(self, share_id: int):
        if not 1 <= share_id <= self._total:
            raise ValueError(f"share id {share_id} out of range 1..{self._total}")
        return self._share_pks[share_id - 1]

    def agg_pk(self, ids: Sequence[int]):
        """Sum of the contributors' G2 public keys (cached by bitmap —
        overlay subtrees recur across slots, so hit rates are high)."""
        bm = pack_contributors(ids)
        apk = self._apk_cache.get(bm)
        if apk is None:
            apk = None
            for i in ids:
                apk = bls.g2_add(apk, self.share_pk(i)) if apk is not None \
                    else self.share_pk(i)
            if len(self._apk_cache) > 4096:
                self._apk_cache.clear()
            self._apk_cache[bm] = apk
        return apk

    def verify_share(self, share_id: int, data: bytes, share: bytes) -> bool:
        if not 1 <= share_id <= self._total:
            return False
        try:
            pt = bls.g1_decompress(share)
        except ValueError:
            return False
        return bls.verify(self.share_pk(share_id), data, pt)

    def verify(self, data: bytes, sig: bytes) -> bool:
        dec = unpack_agg_cert(sig)
        if dec is None:
            return False
        ids, pt = dec
        if len(ids) < self._threshold or ids[-1] > self._total:
            return False
        return bls.verify(self.agg_pk(ids), data, pt)

    def verify_batch_certs(self, items) -> List[bool]:
        """Aggregated verification with PER-CERT aggregate public keys:
        e(Σ z_i·sig_i, -g2) · Π e(z_i·H(d_i), apk_i) == 1 — one Miller
        batch of m+1 pairings instead of 2m (each apk differs, so the
        H-side cannot fold to a single pairing the way the master-pk
        threshold scheme's can). Per-cert loop on aggregate failure."""
        out = [False] * len(items)
        decoded = []
        for i, (d, s) in enumerate(items):
            dec = unpack_agg_cert(s)
            if dec is None:
                continue
            ids, pt = dec
            if len(ids) < self._threshold or ids[-1] > self._total:
                continue
            decoded.append((i, d, ids, pt))
        if not decoded:
            return out
        if len(decoded) == 1:
            i, d, ids, pt = decoded[0]
            out[i] = bls.verify(self.agg_pk(ids), d, pt)
            return out
        ctx = b"agg-certs" + b"".join(
            d + struct.pack("<Q", pack_contributors(ids)) + bls.g1_compress(pt)
            for _, d, ids, pt in decoded)
        zs = bls._rlc_scalars(len(decoded), ctx)
        agg_sig = bls.g1_msm([pt for _, _, _, pt in decoded], zs)
        pairs = [(agg_sig, bls.g2_neg(bls.G2_GEN))]
        for z, (_, d, ids, _) in zip(zs, decoded):
            pairs.append((bls.g1_mul(bls.hash_to_g1(d), z), self.agg_pk(ids)))
        if bls.pairing_check(pairs):
            for i, _, _, _ in decoded:
                out[i] = True
            return out
        for i, d, ids, pt in decoded:
            out[i] = bls.verify(self.agg_pk(ids), d, pt)
        return out

    # ---- fused cross-slot combine (CombineBatcher protocol) ----

    def _decode_job_entries(self, shares: Dict[int, bytes]
                            ) -> Dict[int, Tuple[Tuple[int, ...], object]]:
        """Snapshot-dict decode with accumulator `add` semantics: raw
        48-byte shares keyed by signer id, 56-byte partials keyed by the
        forwarding child; malformed/out-of-range/overlapping entries
        silently dropped. Entries are visited heaviest-first (contributor
        popcount, key as the deterministic tie-break) so a duplicate —
        e.g. a parent-timeout fallback raw whose signer already rides a
        subtree partial — is the entry dropped, never the partial: the
        surviving contributor union stays maximal, keeping the combined
        cert at or above threshold."""
        entries: Dict[int, Tuple[Tuple[int, ...], object]] = {}
        taken: set = set()
        for key in sorted(shares,
                          key=lambda k: (-self.share_weight(shares[k]), k)):
            blob = shares[key]
            if len(blob) == AGG_CERT_LEN:
                dec = unpack_agg_cert(blob)
                if dec is None:
                    continue
                ids, pt = dec
                if ids[-1] > self._total or taken.intersection(ids):
                    continue
                entries[key] = (tuple(ids), pt)
                taken.update(ids)
            else:
                if not 1 <= key <= self._total or key in taken:
                    continue
                try:
                    pt = bls.g1_decompress(blob)
                except ValueError:
                    continue
                if pt is None:
                    continue
                entries[key] = ((key,), pt)
                taken.add(key)
        return entries

    def _sum_segments(self, segments: List[List[object]],
                      meta=None) -> List[object]:
        """[[points]] -> one unweighted G1 sum per segment. Host path:
        sequential adds; the CUDA subclass folds every segment into ONE
        all-ones-scalar segmented multi-MSM launch (the MSM kernel,
        new call shape). `meta` = per-segment (digest, contributor ids)
        or None — only the offload tier consumes it (the soundness
        check verifies each leased sum against its contributors'
        aggregate pk); `aggregate_partials` passes none, so interior
        overlay sums never offload (no digest to bind them to)."""
        out = []
        for pts in segments:
            acc = None
            for pt in pts:
                acc = bls.g1_add(acc, pt)
            out.append(acc)
        return out

    def aggregate_partials(self, jobs: List[Tuple[List[int], List[object]]]
                           ) -> List[bytes]:
        """Interior-node flush: [(contributor ids, entry points)] -> one
        packed partial per job, all sums in one `_sum_segments` pass (one
        device launch on the CUDA subclass)."""
        sums = self._sum_segments([pts for _, pts in jobs])
        return [pack_agg_cert(ids, pt) for (ids, _), pt in zip(jobs, sums)]

    def combine_batch(self, jobs) -> List[Tuple[bool, bytes, List[int]]]:
        decoded = [(digest, self._decode_job_entries(shares))
                   for digest, shares in jobs]
        # contributor ids are known BEFORE the sums (they come from the
        # entry bitmaps, not the arithmetic) — computing them first
        # hands the offload tier the metadata its soundness check binds
        # each leased sum to
        ids_list = [tuple(sorted(i for ids, _ in entries.values()
                                 for i in ids))
                    for _, entries in decoded]
        sums = self._sum_segments(
            [[pt for _, pt in entries.values()] for _, entries in decoded],
            meta=[(digest, ids) if ids else None
                  for (digest, _), ids in zip(decoded, ids_list)])
        certs = [pack_agg_cert(list(ids), pt) if ids else b""
                 for ids, pt in zip(ids_list, sums)]
        verdicts = self.verify_batch_certs(
            [(digest, cert) for (digest, _), cert in zip(decoded, certs)])
        out: List[Tuple[bool, bytes, List[int]]] = []
        for (digest, entries), cert, ok in zip(decoded, certs, verdicts):
            if ok:
                out.append((True, cert, []))
            else:
                out.append((False, b"",
                            self._identify_bad_entries(digest, entries)))
        return out

    def _identify_bad_entries(self, digest: bytes,
                              entries: Dict[int, Tuple[Tuple[int, ...], object]]
                              ) -> List[int]:
        """Contributor-bitmap bisection: each entry (raw share OR subtree
        partial) verifies against its bitmap's aggregate pk, walked with
        the O(b·log n) aggregation tree — a forged partial indicts
        exactly its subtree's entry key, so the collector drops that
        subtree and the direct-send fallback refills it."""
        keys = sorted(entries)
        if not keys:
            return []
        h = bls.hash_to_g1(digest)
        tree = bls.BlsBatchVerifier(
            [self.agg_pk(entries[k][0]) for k in keys], h)
        verdicts = tree.batch_verify([entries[k][1] for k in keys])
        return [k for k, good in zip(keys, verdicts) if not good]

    @property
    def threshold(self) -> int:
        return self._threshold

    @property
    def total_signers(self) -> int:
        return self._total


class BlsMultisigFactory(IThresholdFactory):
    def new_signer(self, signer_id: int, secret_share: int) -> BlsMultisigSigner:
        return BlsMultisigSigner(signer_id, secret_share)

    def new_verifier(self, threshold, total, public_key, share_public_keys):
        return BlsMultisigVerifier(threshold, total, share_public_keys)

    def keygen(self, threshold: int, total: int, seed: Optional[bytes] = None):
        import hashlib
        sks, pks = [], []
        for i in range(total):
            s = (hashlib.sha256(b"ms-bls" + seed + i.to_bytes(4, "big")).digest()
                 if seed is not None else None)
            sk, pk = bls.keygen(seed=s)
            sks.append(sk)
            pks.append(pk)
        # no single master public key for multisig; use the pk list
        return pks, pks, sks


def register_builtin(type_name: str) -> None:
    if type_name == "multisig-ed25519":
        Cryptosystem.register_type(type_name, MultisigEd25519Factory())
    elif type_name == "multisig-bls":
        Cryptosystem.register_type(type_name, BlsMultisigFactory())
    elif type_name == "threshold-bls":
        Cryptosystem.register_type(type_name, BlsThresholdFactory())
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
