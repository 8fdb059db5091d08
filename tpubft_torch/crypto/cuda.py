"""CUDA-backed crypto plugin implementations (port of
tpubft/crypto/tpu.py).

The reference verifies every signature behind its plugin boundaries
(`IVerifier`, `IThresholdVerifier`); here the same boundaries run on the
batched Ed25519 kernel (ops/ed25519.py → ops/ed25519_cuda.py) and the
ECDSA RLC kernel (ops/ecdsa.py → ops/ecdsa_cuda.py):

  * verify_batch_items          — cross-principal one-launch batch, used by
                                  SigManager.verify_batch and the multisig
                                  share paths;
  * verify_batch_mixed          — SigManager's (scheme, pk, data, sig) entry:
                                  Ed25519 on the verify kernel, each ECDSA
                                  curve's group at or above
                                  `ecdsa_crossover()` on the RLC kernel
                                  (below it the batched host engine);
  * CudaEd25519Verifier         — per-principal IVerifier;
  * CudaMultisigEd25519Verifier — combined-multisig verification, bad-share
                                  identification and the fused cross-slot
                                  combine as ONE device batch;
  * CudaBlsThresholdAccumulator / CudaBlsThresholdVerifier /
    CudaBlsMultisigVerifier     — BLS combines whose Lagrange-weighted
                                  MSMs (or unweighted sums) run on the G1
                                  MSM kernel (ops/bls12_381.py ->
                                  ops/bls12_381_cuda.py), the counterpart
                                  of fastMultExp (FastMultExp.cpp:27).

Each of the three heavy launches is offered to the verified offload tier
first, as in the reference (offload/pool.py: `ecdsa_via_offload`,
`combine_via_offload`, `sum_via_offload`); with no active pool, or no
lease, the local path runs unchanged, and a helper's answer reaches a
verdict only after the on-replica soundness check.

A device failure (a RuntimeError from the launch, or an OPEN breaker's
BreakerOpen) degrades to the host scalar engine at the same places as
the reference; the breaker recorded the failure at the kernel seam, and
the verifier counts the batch in its `degraded` counter, so a run can
tell a fallback from a device answer. A missing card
(`device.NoDevice`), a kernel that does not build (`BuildError`), a
wrapper refusing its inputs (`ValueError`) and every other error raise.
The BLS classes have no host fallback at all: a failed device combine
raises (below).
"""
from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

from tpubft_torch.crypto import bls12381 as bls
from tpubft_torch.crypto.cpu import ECDSA_CURVES
from tpubft_torch.crypto.interfaces import IVerifier
from tpubft_torch.crypto.systems import (BlsMultisigVerifier,
                                         BlsThresholdAccumulator,
                                         BlsThresholdVerifier,
                                         MultisigEd25519Verifier,
                                         pack_multisig_vector)
from tpubft_torch.device import NoDevice


def verify_batch_items(items: Sequence[Tuple[bytes, bytes, bytes]]
                       ) -> List[bool]:
    """One kernel launch over ed25519 (pubkey, data, sig) triples —
    principals may all differ."""
    from tpubft_torch.ops import ed25519 as ops
    return [bool(x) for x in
            ops.verify_batch([(d, s, pk) for pk, d, s in items])]


# The ECDSA device/host crossover on a card, measured where users meet
# it: config 3's n=31 cluster ran 8.68 requests/s at 2, 7.53 at 12, 4.49
# at 24 and 4.50 with every group on the host engine on an H100 (`python
# -m tpubft_torch.tools.ecdsa_probe --cluster`; PERF.md §6). Alone, one
# call against one call, the device route first wins at 32 lanes
# (`--crossover`); in a cluster the host engine holds the interpreter
# lock for its whole batch, while the device route releases it for the
# launch and its read-back.
CARD_ECDSA_CROSSOVER = 2

# runtime override of the ECDSA device/host crossover — the autotuner's
# actuator (tuning/wiring.py drives it from measured `ecdsa` kernel
# batch stats vs the batched-host timing counters). Process-wide like
# the device itself: all replicas of one process share one card, so the
# last-configured value wins. None = fall through to the env knob and
# the device default below.
_crossover_override: Optional[int] = None


def set_ecdsa_crossover(b: Optional[int]) -> None:
    """Set (or with None, clear) the runtime ECDSA device/host
    crossover. Takes precedence over TPUBFT_ECDSA_CROSSOVER_B."""
    global _crossover_override
    _crossover_override = None if b is None else max(1, int(b))


def ecdsa_crossover() -> int:
    """Minimum ECDSA group (one curve's items of a batch) that rides the
    RLC kernel; smaller groups verify on the batched host engine
    (crypto/scalar.ecdsa_verify_batch). The runtime override
    (set_ecdsa_crossover, the autotuner's actuator) wins, then
    TPUBFT_ECDSA_CROSSOVER_B (read on every call: tests flip it at
    runtime), then CARD_ECDSA_CROSSOVER where the port's default device
    is a card and 1 << 30 where it is the CPU, on which the plain fold
    runs op by op. A missing card raises device.NoDevice. The reference
    asks jax.devices() once (tpu.py:51-60) and divides the static tiers
    by the healthy mesh width (tpu.py:83-92); the port has one device
    and no mesh (ROADMAP A.7), so nothing is divided."""
    if _crossover_override is not None:
        return _crossover_override
    v = os.environ.get("TPUBFT_ECDSA_CROSSOVER_B")
    if v is not None:
        try:
            return int(v)
        except ValueError:
            # a malformed knob must not poison every verify batch
            import logging
            logging.getLogger("tpubft.crypto").warning(
                "ignoring non-integer TPUBFT_ECDSA_CROSSOVER_B=%r", v)
    from tpubft_torch import device
    return (CARD_ECDSA_CROSSOVER if device.default_device().type == "cuda"
            else 1 << 30)


def verify_batch_mixed(items: Sequence[Tuple[str, bytes, bytes, bytes]]
                       ) -> List[bool]:
    """SigManager's cross-principal batch entry: (scheme, pubkey, data,
    sig) tuples, one device dispatch per scheme present. This is how the
    secp256k1/P-256 client-auth mix of BASELINE configs 3/5 rides the
    card: EdDSA through the verify kernel, ECDSA through the RLC batch
    kernel (ops/ecdsa.rlc_verify_batch — one launch a clean group,
    bisection on a forged one). An ECDSA group at or above the crossover
    is offered to the offload tier first (tpu.py:143-160): a helper's
    verdicts cost one re-fold launch of the RLC kernel over the accepted
    subset instead of the bisection. Groups below the crossover verify
    on the batched host engine; an unknown scheme verifies on the host."""
    groups: Dict[str, List[int]] = {}
    for i, (scheme, _pk, _data, _sig) in enumerate(items):
        groups.setdefault(scheme, []).append(i)
    out = [False] * len(items)
    for scheme, idxs in groups.items():
        sub = [items[i] for i in idxs]
        if scheme == "ed25519":
            verdicts = verify_batch_items([(pk, d, s)
                                           for _, pk, d, s in sub])
        elif scheme in ECDSA_CURVES:
            curve = ECDSA_CURVES[scheme]
            if len(sub) >= ecdsa_crossover():
                from tpubft_torch.ops import ecdsa as ops_ecdsa
                rlc_items = [(d, s, pk) for _, pk, d, s in sub]

                def _local_rlc(items=rlc_items, curve=curve):
                    return [bool(x) for x in
                            ops_ecdsa.rlc_verify_batch(curve, items)]
                # offload tier first; None = no lease (pool inactive, at
                # capacity or helpers down) -> the local path unchanged
                from tpubft_torch.offload import pool as offload
                verdicts = offload.ecdsa_via_offload(curve, rlc_items,
                                                     _local_rlc)
                if verdicts is None:
                    verdicts = _local_rlc()
            else:
                from tpubft_torch.crypto import scalar as _scalar
                verdicts = _scalar.ecdsa_verify_batch(
                    [(pk, d, s) for _, pk, d, s in sub], curve)
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
        except NoDevice:
            raise
        except RuntimeError:  # device loss (or an OPEN breaker
            # fast-fail) degrades to the host verifier; the breaker
            # recorded the failure at the kernel seam
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
        except NoDevice:
            raise
        except RuntimeError:  # device loss: the host multisig check is
            # byte-identical, just serial
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
        except NoDevice:
            raise
        except RuntimeError:  # device loss: per-share host check
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
        except NoDevice:
            raise
        except RuntimeError:  # device loss: serial host check
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
        except NoDevice:
            raise
        except RuntimeError:  # device loss: per-job host loop
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


def msm_crossover_k() -> int:
    """TPUBFT_MSM_CROSSOVER_K: below it the host combines. The default,
    128, is the reference's TPU value (tpu.py:368), kept as it is; where
    the device route overtakes the host on a given card and host is
    measured by `python -m tpubft_torch.tools.msm_crossover`, per kind of
    combine (PERF.md)."""
    return int(os.environ.get("TPUBFT_MSM_CROSSOVER_K", "128"))


class CudaBlsThresholdAccumulator(BlsThresholdAccumulator):
    """BLS accumulator combining on the card: Lagrange coefficients on the
    host (tiny), the [L_i] share_i MSM on the G1 kernel
    (ops/bls12_381.combine_shares) — the role of fastMultExp in
    BlsThresholdAccumulator.cpp:42-56. Below TPUBFT_MSM_CROSSOVER_K the
    host Pippenger MSM combines, as in the reference.

    Port divergence (reference tpu.py:378): no host fallback. A device
    combine that fails raises; it never comes back as a host answer."""

    def get_full_signed_data(self) -> bytes:
        k = self._verifier.threshold
        crossover = msm_crossover_k()
        if len(self._shares) < crossover and k < crossover:
            self._verifier.host_combines += 1
            return super().get_full_signed_data()
        from tpubft_torch.ops import bls12_381 as dev
        ids = sorted(self._shares)[:k]
        combined = dev.combine_shares(ids, [self._shares[i] for i in ids])
        self._verifier.device_combines += 1
        return bls.g1_compress(combined)


class CudaBlsThresholdVerifier(BlsThresholdVerifier):
    """Threshold-BLS verifier whose fused combine folds every slot's
    Lagrange-weighted MSM into ONE segmented launch of the G1 MSM kernel.
    `device_combines` / `host_combines` count the combines (fused flushes
    and accumulator combines) on each side of the crossover."""

    def __init__(self, threshold: int, total: int, master_pk, share_pks):
        super().__init__(threshold, total, master_pk, share_pks)
        self.device_combines = 0
        self.host_combines = 0

    def new_accumulator(self, with_share_verification: bool
                        ) -> CudaBlsThresholdAccumulator:
        return CudaBlsThresholdAccumulator(self, with_share_verification)

    def _combine_segments(self, segments, digests=None) -> List:
        """Fused combine with backend tiering: offload (leased to a
        verified helper) -> device -> host (reference tpu.py:389-403). A
        lease only happens when the pool is active AND the caller
        supplied the slot digests the soundness check binds to; a failed
        or evicted lease re-runs the local path inside this same call,
        so the returned points are byte-identical with offload on or
        off."""
        if digests is not None:
            from tpubft_torch.offload import pool as offload
            leased = offload.combine_via_offload(
                segments, digests, self._master_pk,
                lambda: self._combine_segments_local(segments))
            if leased is not None:
                return leased
        return self._combine_segments_local(segments)

    def _combine_segments_local(self, segments) -> List:
        """Every slot's Lagrange-weighted MSM in ONE segmented
        `bls_msm` launch. Below the crossover the host Pippenger path
        combines; a fused flush clears the crossover on the SUM of shares
        (the reference's tpu.py:405-424).

        Port divergence: no host fallback (reference :422): a failed
        device combine raises, here and as an offload lease's local
        re-run."""
        total = sum(len(ids) for ids, _ in segments)
        if total < msm_crossover_k() or not any(ids for ids, _ in segments):
            self.host_combines += 1
            return super()._combine_segments(segments)
        from tpubft_torch.ops import bls12_381 as dev
        out = dev.combine_shares_batch([(ids, pts) for ids, pts in segments])
        self.device_combines += 1
        return out


class CudaBlsMultisigVerifier(BlsMultisigVerifier):
    """Multisig-BLS with the unweighted sums on the card: every segment's
    sum of shares rides the same segmented MSM kernel the threshold
    scheme's Lagrange combine uses, with all-ones scalars — a new call
    shape, not a new kernel. Serves both the fused `combine_batch` flush
    and `aggregate_partials`. Counters as CudaBlsThresholdVerifier's."""

    def __init__(self, threshold: int, total: int, share_pks):
        super().__init__(threshold, total, share_pks)
        self.device_combines = 0
        self.host_combines = 0

    def _sum_segments(self, segments, meta=None) -> List:
        """Offload first when the caller supplied each segment's
        (digest, contributor ids) (reference tpu.py:436-444); a failed
        or evicted lease re-runs the local sums."""
        if meta is not None and any(m is not None for m in meta):
            from tpubft_torch.offload import pool as offload
            leased = offload.sum_via_offload(
                segments, meta, self,
                lambda: self._sum_segments_local(segments))
            if leased is not None:
                return leased
        return self._sum_segments_local(segments)

    def _sum_segments_local(self, segments) -> List:
        """Port divergence: no host fallback (reference tpu.py:446-462): a
        failed device sum raises."""
        total = sum(len(pts) for pts in segments)
        # fused flush: clear the crossover on the SUM across segments
        if total < msm_crossover_k() or not any(segments):
            self.host_combines += 1
            return super()._sum_segments(segments)
        from tpubft_torch.ops import bls12_381 as dev
        live = [i for i, pts in enumerate(segments) if pts]
        sums = dev.msm_batch([(segments[i], [1] * len(segments[i]))
                              for i in live])
        out = [None] * len(segments)
        for i, pt in zip(live, sums):
            out[i] = pt
        self.device_combines += 1
        return out


def make_threshold_verifier(type_name: str, threshold: int, total: int,
                            public_key, share_public_keys,
                            min_device_batch: int = 1):
    """CUDA-flavoured counterpart of Cryptosystem.create_threshold_verifier
    (ThresholdSignaturesTypes.cpp:183): same key material, device-backed
    verification."""
    if type_name == "multisig-ed25519":
        return CudaMultisigEd25519Verifier(threshold, total,
                                           share_public_keys,
                                           min_device_batch)
    if type_name == "threshold-bls":
        return CudaBlsThresholdVerifier(threshold, total, public_key,
                                        share_public_keys)
    if type_name == "multisig-bls":
        return CudaBlsMultisigVerifier(threshold, total, share_public_keys)
    raise ValueError(f"no CUDA backend for cryptosystem {type_name!r}")
