"""Threshold-signature share collection — the consensus hot path.

Rebuild of the reference's CollectorOfThresholdSignatures
(concord-bft bftengine/src/bftengine/CollectorOfThresholdSignatures.hpp:38):
shares for one (view, seq, kind) accumulate until the quorum is reached;
combine + verify runs as a background job (SignaturesProcessingJob :291-407)
on a worker pool; the verdict re-enters the dispatcher as an internal msg.
On combined-verification failure the job re-verifies share-by-share to
identify bad shares (:363-401 strategy: optimistic accumulate first).

Device-first delta — the fused combine plane: the reference launches one
combine job per slot, so a pipelined replica pays one Lagrange+MSM
device dispatch per seqnum ("The Latency Price of Threshold
Cryptosystems", arXiv 2407.12172, is exactly this tax). Here due
collectors drain through a `FlushBatcher` (the same discipline as
CertBatchVerifier) into ONE `IThresholdVerifier.combine_batch` call per
verifier per flush — with the BLS backend that is one segmented
multi-MSM kernel launch for every slot's combine plus one RLC'd pairing
check for every combined signature of the flush; with the Ed25519
multisig vector it is one batched verify kernel call. One slot's bad
share fails only its own CombineResult; sibling slots in the same flush
still land.

Thread discipline (tpulint static-race pass, sig_combine/batcher roles):
ShareCollector state is SINGLE-WRITER from the dispatcher. `maybe_launch`
snapshots the share set dispatcher-side; combine workers and the flush
batcher only read their snapshot and post a CombineResult carrying the
collector; the dispatcher applies the verdict's state flip
(`ShareCollector.on_result`) when the internal msg re-enters.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from tpubft_torch.crypto.interfaces import IThresholdVerifier
from tpubft_torch.utils import flight


@dataclass
class CombineResult:
    view: int
    seq_num: int
    kind: str                      # "prepare" | "commit" | "fast"
    ok: bool
    combined_sig: bytes = b""
    bad_shares: List[int] = field(default_factory=list)
    # the collector this verdict belongs to: the dispatcher flips its
    # job_launched/combined state on re-entry (workers must not — the
    # dispatcher reads those fields in ready_for_job)
    collector: Optional["ShareCollector"] = field(default=None,
                                                 compare=False, repr=False)


class ShareCollector:
    """Accumulates shares for one (view, seq, kind, digest) instance."""

    def __init__(self, view: int, seq_num: int, kind: str, digest: bytes,
                 verifier: IThresholdVerifier):
        self.view = view
        self.seq_num = seq_num
        self.kind = kind
        self.digest = digest
        self.verifier = verifier
        self.shares: Dict[int, bytes] = {}     # signer id (1-based) -> share
        self.combined: Optional[bytes] = None
        self.job_launched = False
        self.last_attempt: Optional[frozenset] = None

    def add_share(self, signer_id: int, share: bytes) -> bool:
        """Store a share (0-based replica id). Returns True if new.

        Under share aggregation the root feeds subtree PARTIALS through
        this same path, keyed by the forwarding child (the entry is
        self-describing — crypto/systems.AGG_CERT_LEN blobs carry their
        contributor bitmap), so the whole verdict machinery downstream
        (snapshot, fused combine, bad-share pop) is unchanged. A
        strictly HEAVIER blob under an existing key replaces it: interior
        flushes are cumulative, so a child's later superset partial must
        supersede its earlier thin one or those contributors are lost
        until the parent-timeout fallback."""
        sid = signer_id + 1                    # threshold signers are 1-based
        if self.combined is not None:
            return False
        cur = self.shares.get(sid)
        if cur is not None and (cur == share or
                                self.verifier.share_weight(share)
                                <= self.verifier.share_weight(cur)):
            return False
        self.shares[sid] = share
        return True

    def has_quorum(self) -> bool:
        # every entry weighs >= 1, so the cheap len check short-circuits
        # the common all-raw case; with partial aggregates in the dict
        # quorum counts CONTRIBUTORS (bitmap popcount), not datagrams
        if len(self.shares) >= self.verifier.threshold:
            return True
        return sum(self.verifier.share_weight(s)
                   for s in self.shares.values()) >= self.verifier.threshold

    def ready_for_job(self) -> bool:
        """Quorum reached, no job in flight, not combined yet, and the
        share set changed since the last (failed) attempt — identical
        inputs would fail identically."""
        return (self.has_quorum() and not self.job_launched
                and self.combined is None
                # items, not keys: a superseded partial under an
                # unchanged key must still retrigger the combine
                and frozenset(self.shares.items()) != self.last_attempt)

    def on_result(self, res: CombineResult) -> None:
        """Dispatcher-side verdict application: the ONLY place collector
        state flips after launch (the combine ran on a worker/batcher
        thread over a snapshot; writing here keeps every field
        single-writer from the dispatcher)."""
        self.job_launched = False
        if res.ok:
            self.combined = res.combined_sig

    def combine_and_verify(self, shares: Dict[int, bytes]) -> CombineResult:
        """The background job body (reference SignaturesProcessingJob
        ::execute) over a SNAPSHOT of the shares (the dispatcher thread
        keeps mutating self.shares): accumulate WITHOUT share
        verification, combine, verify the combined signature; on failure
        verify shares individually. Delegates to the verifier's
        combine_batch so the per-slot and fused paths share one
        verdict-producing code path."""
        ((ok, combined, bad),) = self.verifier.combine_batch(
            [(self.digest, shares)])
        if ok:
            return CombineResult(self.view, self.seq_num, self.kind, True,
                                 combined, collector=self)
        return CombineResult(self.view, self.seq_num, self.kind, False,
                             bad_shares=bad, collector=self)


class CertBatchVerifier:
    """Cross-seqnum combined-certificate verification batcher.

    The reference verifies each received full certificate in its own
    CombinedSigVerificationJob (CollectorOfThresholdSignatures.hpp:409) —
    one ~2-pairing check per cert. Here certs arriving within the flush
    window are verified TOGETHER per verifier through
    IThresholdVerifier.verify_batch_certs (BLS: one random-linear-
    combination pairing check + two MSMs for the whole batch), so a busy
    replica pays O(1) pairing checks per flush instead of O(certs)."""

    def __init__(self, post: Callable[[object, bool], None],
                 flush_us: int = 500, max_batch: int = 64):
        from tpubft_torch.utils.batcher import FlushBatcher
        self._post = post              # (cookie, ok) -> None
        self._batcher = FlushBatcher(
            self._drain, batch_size=max_batch, flush_us=flush_us,
            on_drop=lambda item: self._post(item[3], False),
            name="cert-batch-verify")

    def submit(self, verifier, digest: bytes, sig: bytes,
               cookie) -> None:
        self._batcher.submit((verifier, digest, sig, cookie))

    def reconfigure(self, max_batch: int = None,
                    flush_us: int = None) -> None:
        """Autotuner actuator: retune the cert-batch flush live."""
        self._batcher.reconfigure(batch_size=max_batch,
                                  flush_us=flush_us)

    def _drain(self, batch) -> None:
        # keyed by the verifier OBJECT, not id(): the dict key holds the
        # verifier alive for the drain, so a GC'd-and-recycled id can
        # never co-mingle two verifiers' certs in one aggregated check
        by_verifier: Dict[object, List[int]] = {}
        for i, (v, _, _, _) in enumerate(batch):
            by_verifier.setdefault(v, []).append(i)
        for verifier, idxs in by_verifier.items():
            items = [(batch[i][1], batch[i][2]) for i in idxs]
            try:
                verdicts = verifier.verify_batch_certs(items)
            except Exception:  # noqa: BLE001 — failure = reject batch
                from tpubft_torch.utils.logging import get_logger
                get_logger("collectors").exception(
                    "cert batch verify raised")
                verdicts = [False] * len(items)
            for i, ok in zip(idxs, verdicts):
                try:
                    self._post(batch[i][3], bool(ok))
                except Exception:  # noqa: BLE001 — one failed post (e.g.
                    # shutdown) must not make the batcher re-resolve the
                    # rest as failures; but a consumer bug must be visible
                    from tpubft_torch.utils.logging import get_logger
                    get_logger("collectors").exception(
                        "cert verdict post failed")

    def stop(self) -> None:
        self._batcher.stop()


class CombineBatcher:
    """Cross-slot fused combine plane: due collectors from ALL seqnums
    and kinds flush together, one `combine_batch` call per verifier per
    flush (BLS: one segmented multi-MSM launch + one RLC pairing check
    for the whole batch). Same FlushBatcher wake discipline as
    CertBatchVerifier, so pipelined slots arriving within the flush
    window amortize the device dispatch instead of paying it per slot."""

    def __init__(self, post: Callable[[CombineResult], None],
                 flush_us: int = 300, max_batch: int = 64,
                 on_flush: Optional[Callable[[int], None]] = None,
                 rid: int = -1):
        from tpubft_torch.utils.batcher import FlushBatcher
        self._post = post              # CombineResult -> None
        self._on_flush = on_flush      # batch-size metrics sink
        self._rid = rid                # flight attribution (multi-replica
        self._rid_seeded = False       # processes share one recorder)
        self._batcher = FlushBatcher(
            self._drain, batch_size=max_batch, flush_us=flush_us,
            on_drop=self._drop, name="combine-batch")

    def submit(self, collector: ShareCollector,
               snapshot: Dict[int, bytes]) -> None:
        """Dispatcher-side: `snapshot` was taken under the dispatcher's
        ownership of collector.shares; the drain only reads it."""
        self._batcher.submit((collector, snapshot))

    def reconfigure(self, max_batch: int = None,
                    flush_us: int = None) -> None:
        """Autotuner actuator: retune the fused-combine flush live
        (combine_flush_us / combine_batch_max move through the knob
        registry after startup, not the frozen ReplicaConfig field)."""
        self._batcher.reconfigure(batch_size=max_batch,
                                  flush_us=flush_us)

    def _drop(self, item: Tuple[ShareCollector, Dict[int, bytes]]) -> None:
        # stopped batcher: resolve as a combine failure so the
        # dispatcher-side state flip still happens and no collector is
        # wedged with job_launched forever
        c, _ = item
        self._post(CombineResult(c.view, c.seq_num, c.kind, False,
                                 collector=c))

    def _drain(self, batch) -> None:
        if not self._rid_seeded:
            # the drain owns its FlushBatcher thread: seed the replica id
            # once so combine_flush events attribute correctly (same
            # convention as the dispatcher/exec/admission loop entries)
            flight.set_thread_rid(self._rid)
            self._rid_seeded = True
        flight.record(flight.EV_COMBINE_FLUSH, arg=len(batch))
        # group by verifier object (stable identity — see
        # CertBatchVerifier._drain): slow-path prepare/commit share one
        # verifier, fast paths their own, so one flush usually makes
        # 1-2 combine_batch calls
        by_verifier: Dict[object, List[int]] = {}
        for i, (c, _snap) in enumerate(batch):
            by_verifier.setdefault(c.verifier, []).append(i)
        for verifier, idxs in by_verifier.items():
            jobs = [(batch[i][0].digest, batch[i][1]) for i in idxs]
            try:
                results = verifier.combine_batch(jobs)
                if len(results) != len(jobs):
                    # contract violation must fail LOUD into the per-job
                    # failure path — a silently zip-truncated tail would
                    # leave collectors with job_launched wedged True
                    raise ValueError(
                        f"combine_batch returned {len(results)} results "
                        f"for {len(jobs)} jobs")
            except Exception:  # noqa: BLE001 — whole-group failure =
                # per-job combine failure (no bad-share knowledge)
                from tpubft_torch.utils.logging import get_logger
                get_logger("collectors").exception(
                    "fused combine raised (%d jobs)", len(jobs))
                results = [(False, b"", [])] * len(jobs)
            for i, (ok, sig, bad) in zip(idxs, results):
                c = batch[i][0]
                self._post(CombineResult(c.view, c.seq_num, c.kind,
                                         bool(ok), sig if ok else b"",
                                         list(bad), collector=c))
        if self._on_flush is not None:
            try:
                self._on_flush(len(batch))
            except Exception:  # noqa: BLE001 — metrics must not kill
                pass           # the combine plane

    def stop(self) -> None:
        self._batcher.stop()


class CollectorPool:
    """Owns the combine plane; launches combine work and posts results
    back via `post_result` (the replica wires this to push_internal).
    The reference's SimpleThreadPool + internal-msg round trip, with the
    per-slot jobs replaced by the fused CombineBatcher (fused=False
    keeps the one-job-per-collector control path for A/B runs)."""

    def __init__(self, post_result: Callable[[CombineResult], None],
                 workers: int = 2, fused: bool = True,
                 flush_us: int = 300, max_batch: int = 64,
                 on_flush: Optional[Callable[[int], None]] = None,
                 rid: int = -1):
        self._post = post_result
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="sig-combine")
        self._closed = False
        self._combiner = (CombineBatcher(post_result, flush_us=flush_us,
                                         max_batch=max_batch,
                                         on_flush=on_flush, rid=rid)
                          if fused else None)

    def submit(self, fn: Callable[[], None]) -> bool:
        """Run an arbitrary background verification job on the pool (the
        reference's RequestThreadPool / CombinedSigVerificationJob role —
        the job itself posts its verdict back as an internal msg)."""
        if self._closed:
            return False
        self._pool.submit(fn)
        return True

    def reconfigure(self, max_batch: int = None,
                    flush_us: int = None) -> None:
        """Autotuner actuator (no-op on the per-collector control
        path, which has no flush to tune)."""
        if self._combiner is not None:
            self._combiner.reconfigure(max_batch=max_batch,
                                       flush_us=flush_us)

    def maybe_launch(self, collector: ShareCollector) -> bool:
        """Called on the dispatcher thread only; snapshots the share set
        so the job never races dispatcher-side mutations. The result's
        state flip happens dispatcher-side in ShareCollector.on_result
        when the verdict re-enters as an internal msg."""
        if self._closed or not collector.ready_for_job():
            return False
        collector.job_launched = True
        snapshot = dict(collector.shares)
        collector.last_attempt = frozenset(snapshot.items())
        if self._combiner is not None:
            self._combiner.submit(collector, snapshot)
        else:
            self._pool.submit(self._run, collector, snapshot)
        return True

    def _run(self, collector: ShareCollector, shares) -> None:
        try:
            result = collector.combine_and_verify(shares)
        except Exception:  # noqa: BLE001 — job failure = combine failure
            from tpubft_torch.utils.logging import get_logger
            get_logger("collectors").exception(
                "combine job raised (kind=%s seq=%d)", collector.kind,
                collector.seq_num)
            result = CombineResult(collector.view, collector.seq_num,
                                   collector.kind, False,
                                   collector=collector)
        self._post(result)

    def shutdown(self) -> None:
        self._closed = True
        if self._combiner is not None:
            self._combiner.stop()
        self._pool.shutdown(wait=False)


class ByzTelemetry:
    """Per-origin Byzantine-evidence counters.

    The combine plane already IDENTIFIES misbehaving share origins
    (`CombineResult.bad_shares`, the deferred-cert poison path) but the
    evidence was consumed anonymously — one aggregate counter, no way
    to tell "replica 3 keeps sending garbage" from background noise.
    This rolls it up per ORIGIN replica id so `status get health` and
    flight dumps answer *who*:

      * bad_shares[origin]             — threshold shares that failed
        share-level identification after a combine-verify miss
        (replica._on_combine_result pops them; origin = signer_id - 1)
      * deferred_cert_failures[origin] — async cert verifications that
        failed AFTER structural acceptance, keyed by the cert's sender
        (the optimistic plane's poison trigger)

    Counters only — classification/eviction stays with the callers.
    Thread-safe: the dispatcher and verify workers both report."""

    def __init__(self) -> None:
        import threading
        self._mu = threading.Lock()
        self.bad_shares: Dict[int, int] = {}
        self.deferred_cert_failures: Dict[int, int] = {}

    def bad_share(self, origin: int) -> None:
        with self._mu:
            self.bad_shares[origin] = self.bad_shares.get(origin, 0) + 1

    def deferred_cert_failure(self, origin: int) -> None:
        with self._mu:
            self.deferred_cert_failures[origin] = \
                self.deferred_cert_failures.get(origin, 0) + 1

    def snapshot(self) -> Dict[str, Dict[int, int]]:
        with self._mu:
            return {"bad_shares": dict(self.bad_shares),
                    "deferred_cert_failures":
                        dict(self.deferred_cert_failures)}
