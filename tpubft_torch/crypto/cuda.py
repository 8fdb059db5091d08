"""CUDA-backed crypto plugin implementations (port of the Ed25519 half of
tpubft/crypto/tpu.py).

The reference verifies every signature behind its plugin boundaries
(`IVerifier`, `IThresholdVerifier`); here the same boundaries run on the
batched Ed25519 kernel (ops/ed25519.py → ops/ed25519_cuda.py):

  * verify_batch_items          — cross-principal one-launch batch, used by
                                  SigManager.verify_batch and the multisig
                                  share paths;
  * verify_batch_mixed          — SigManager's (scheme, pk, data, sig) entry;
  * CudaEd25519Verifier         — per-principal IVerifier;
  * CudaMultisigEd25519Verifier — combined-multisig verification, bad-share
                                  identification and the fused cross-slot
                                  combine as ONE device batch.

A device failure (or an OPEN breaker) degrades to the host scalar engine
at the same places as the reference; the breaker recorded the failure at
the kernel seam, and the verifier counts the batch in its `degraded`
counter, so a run can tell a fallback from a device answer. The BLS classes and the ECDSA device routing wait for
their slices.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

from tpubft_torch.crypto.interfaces import IVerifier
from tpubft_torch.crypto.systems import (MultisigEd25519Verifier,
                                         pack_multisig_vector)

_ECDSA_SCHEMES = ("ecdsa-secp256k1", "secp256k1", "ecdsa-secp256r1",
                  "secp256r1", "ecdsa-p256")


def verify_batch_items(items: Sequence[Tuple[bytes, bytes, bytes]]
                       ) -> List[bool]:
    """One kernel launch over ed25519 (pubkey, data, sig) triples —
    principals may all differ."""
    from tpubft_torch.ops import ed25519 as ops
    return [bool(x) for x in
            ops.verify_batch([(d, s, pk) for pk, d, s in items])]


def verify_batch_mixed(items: Sequence[Tuple[str, bytes, bytes, bytes]]
                       ) -> List[bool]:
    """SigManager's cross-principal batch entry: (scheme, pubkey, data,
    sig) tuples, one device launch per scheme present. Ed25519 rides the
    CUDA kernel; an unknown scheme verifies on the host; ECDSA raises
    NotImplementedError until its slice."""
    groups: Dict[str, List[int]] = {}
    for i, (scheme, _pk, _data, _sig) in enumerate(items):
        groups.setdefault(scheme, []).append(i)
    out = [False] * len(items)
    for scheme, idxs in groups.items():
        sub = [items[i] for i in idxs]
        if scheme == "ed25519":
            verdicts = verify_batch_items([(pk, d, s)
                                           for _, pk, d, s in sub])
        elif scheme in _ECDSA_SCHEMES:
            raise NotImplementedError(
                f"{scheme} batch verification is not ported yet")
        else:                       # unknown scheme: host verifiers
            from tpubft_torch.crypto.cpu import make_verifier
            verdicts = []
            for _, pk, d, s in sub:
                try:
                    verdicts.append(make_verifier(scheme, pk).verify(d, s))
                except Exception:  # noqa: BLE001 — a bad key or scheme
                    verdicts.append(False)      # is a failed verify
        for i, ok in zip(idxs, verdicts):
            out[i] = ok
    return out


class CudaEd25519Verifier(IVerifier):
    """IVerifier bound to one public key, batch-first. A single verify()
    is a batch of one (one launch — hot-path callers go through
    SigManager.verify_batch / BatchVerifier instead)."""

    def __init__(self, public_key_bytes: bytes):
        self.public_key_bytes = public_key_bytes
        self.degraded = 0          # device batches answered by the host

    def verify(self, data: bytes, sig: bytes) -> bool:
        return self.verify_batch([(data, sig)])[0]

    def verify_batch(self, items: Sequence[Tuple[bytes, bytes]]
                     ) -> List[bool]:
        try:
            from tpubft_torch.ops import ed25519 as ops
            return [bool(x) for x in ops.verify_batch(
                [(d, s, self.public_key_bytes) for d, s in items])]
        except Exception:  # noqa: BLE001 — device loss (or an OPEN
            # breaker fast-fail) degrades to the host verifier; the
            # breaker recorded the failure at the kernel seam
            self.degraded += 1
            from tpubft_torch.crypto.cpu import make_verifier
            v = make_verifier("ed25519", self.public_key_bytes)
            return [v.verify(d, s) for d, s in items]

    @property
    def signature_length(self) -> int:
        return 64


class CudaMultisigEd25519Verifier(MultisigEd25519Verifier):
    """Multisig verifier whose combined-signature check and bad-share
    identification run as one device batch (k shares -> one launch).
    Below `min_device_batch` shares the check stays on the host
    verifiers: a k=3 certificate is latency-critical and too small to
    amortize a launch."""

    def __init__(self, threshold: int, total: int,
                 share_public_keys: Sequence[bytes],
                 min_device_batch: int = 1):
        super().__init__(threshold, total, share_public_keys)
        self._share_pk_bytes = list(share_public_keys)
        self.min_device_batch = min_device_batch
        self.degraded = 0          # device batches answered by the host

    def verify(self, data: bytes, sig: bytes) -> bool:
        if self.threshold < self.min_device_batch:
            return super().verify(data, sig)
        entries = self._parse_vector(data, sig)
        if entries is None:
            return False
        try:
            return all(verify_batch_items(entries))
        except Exception:  # noqa: BLE001 — device loss: the host
            # multisig check is byte-identical, just serial
            self.degraded += 1
            return super().verify(data, sig)

    def verify_share_batch(self, items: Sequence[Tuple[int, bytes, bytes]]
                           ) -> List[bool]:
        """[(share_id, data, share)] -> verdicts, one device launch."""
        if len(items) < self.min_device_batch:
            return [self.verify_share(i, d, s) for i, d, s in items]
        entries = []
        ok_shape = []
        for share_id, data, share in items:
            if 1 <= share_id <= self.total_signers:
                entries.append((self._share_pk_bytes[share_id - 1], data,
                                share))
                ok_shape.append(True)
            else:
                ok_shape.append(False)
        try:
            verdicts = iter(verify_batch_items(entries))
        except Exception:  # noqa: BLE001 — degrade to per-share host
            self.degraded += 1
            return [self.verify_share(i, d, s) for i, d, s in items]
        return [next(verdicts) if shaped else False for shaped in ok_shape]

    def verify_batch_certs(self, items) -> List[bool]:
        """Cross-cert batching for the multisig vector: every cert's
        share signatures across the whole flush verify in ONE ed25519
        device batch (k_1+...+k_m sigs, one launch) instead of m
        sequential k-verify loops."""
        parsed: List[Optional[List[Tuple[bytes, bytes, bytes]]]] = []
        entries: List[Tuple[bytes, bytes, bytes]] = []
        for data, sig in items:
            one = self._parse_vector(data, sig)
            parsed.append(one)
            if one is not None:
                entries.extend(one)
        if not entries:
            return [False] * len(items)
        if len(entries) < self.min_device_batch:
            # a near-empty flush is latency-critical and too small to
            # amortize a launch: host loop (same doctrine as verify)
            return [self.verify(d, s) for d, s in items]
        try:
            verdicts = iter(verify_batch_items(entries))
        except Exception:  # noqa: BLE001 — device loss: serial host check
            self.degraded += 1
            return [self.verify(d, s) for d, s in items]
        out = []
        for one in parsed:
            if one is None:
                out.append(False)
            else:
                # materialize BEFORE all(): a short-circuit would leave
                # this cert's unconsumed verdicts on the shared iterator
                # and misattribute them to every later cert in the flush
                vs = [next(verdicts) for _ in one]
                out.append(all(vs))
        return out

    def _parse_vector(self, data: bytes, sig: bytes
                      ) -> Optional[List[Tuple[bytes, bytes, bytes]]]:
        """Structural multisig-vector checks (threshold met, unique
        in-range signers, exact length) -> (pk, data, share) entries,
        or None when the vector can't be valid. Mirrors
        MultisigEd25519Verifier.verify's parse exactly."""
        try:
            (k,) = struct.unpack_from("<H", sig, 0)
            if k < self.threshold:
                return None
            off = 2
            entries = []
            seen = set()
            for _ in range(k):
                (i,) = struct.unpack_from("<H", sig, off)
                off += 2
                share = sig[off:off + 64]
                off += 64
                if i in seen or not 1 <= i <= self.total_signers:
                    return None
                seen.add(i)
                entries.append((self._share_pk_bytes[i - 1], data, share))
            if off != len(sig):
                return None
            return entries
        except (struct.error, IndexError):
            return None

    def combine_batch(self, jobs) -> List[Tuple[bool, bytes, List[int]]]:
        """Fused cross-slot combine for the multisig vector: combining
        is concatenation (host, trivial) — the cost is verification, so
        every job's shares across the flush ride ONE ed25519 device
        batch. Verdicts (including bad-share identification and its
        dict-order listing) are identical to the per-job loop."""
        entries = []
        index = []                     # (job, sid) per entry
        for j, (digest, shares) in enumerate(jobs):
            for sid in shares:         # dict order, like the accumulator
                if 1 <= sid <= self.total_signers:
                    entries.append((self._share_pk_bytes[sid - 1], digest,
                                    shares[sid]))
                    index.append((j, sid))
        if len(entries) < self.min_device_batch:
            return super().combine_batch(jobs)   # host loop (see verify)
        try:
            flat = verify_batch_items(entries) if entries else []
        except Exception:  # noqa: BLE001 — device loss: per-job host loop
            self.degraded += 1
            return super().combine_batch(jobs)
        ok_by_job: List[Dict[int, bool]] = [{} for _ in jobs]
        for (j, sid), good in zip(index, flat):
            ok_by_job[j][sid] = bool(good)
        out: List[Tuple[bool, bytes, List[int]]] = []
        for j, (digest, shares) in enumerate(jobs):
            verdicts = ok_by_job[j]
            chosen = sorted(shares)[: self.threshold]
            ok = (len(chosen) >= self.threshold
                  and all(verdicts.get(sid, False) for sid in chosen))
            if ok:
                out.append((True, pack_multisig_vector(chosen, shares),
                            []))
            else:
                out.append((False, b"", [sid for sid in shares
                                         if not verdicts.get(sid, False)]))
        return out


def make_threshold_verifier(type_name: str, threshold: int, total: int,
                            public_key, share_public_keys,
                            min_device_batch: int = 1):
    """CUDA-flavoured counterpart of Cryptosystem.create_threshold_verifier:
    same key material, device-backed verification."""
    del public_key                     # multisig has no master key
    if type_name == "multisig-ed25519":
        return CudaMultisigEd25519Verifier(threshold, total,
                                           share_public_keys,
                                           min_device_batch)
    if type_name in ("threshold-bls", "multisig-bls"):
        raise NotImplementedError(
            f"no CUDA backend for {type_name!r} yet (BLS slice)")
    raise ValueError(f"no CUDA backend for cryptosystem {type_name!r}")
