"""Admission plane: off-dispatcher parse + verify between the
transports and the consensus dispatcher.

The single dispatcher thread used to pay `m.unpack()` plus per-message
signature checks for every datagram (the reference keeps this loop lean
in C++ — IncomingMsgsStorageImp.hpp:32 pops pre-allocated message
objects; verification rides RequestThreadPool). Here a small pool of
admission workers does all *stateless* per-message work:

  1. header peek — msg code / view / seq from the fixed wire prefix,
     dropping garbage, dead-view/stale-seq traffic and within-drain
     duplicates before paying a full unpack;
  2. full parse (`m.unpack`), plus stateless gates the dispatcher would
     apply anyway (dead-era epoch, sender spoofing vs the transport
     sender, client-principal topology checks);
  3. signature verification for every SigManager-signed message type
     (ClientRequest / ClientBatch elements / PrePrepare incl. its
     embedded client requests / Checkpoint / TimeOpinion / the
     view-change family / RestartReady), coalesced into ONE
     `SigManager.verify_batch` call per drain cycle — one device
     dispatch behind `ops.dispatch.device_dispatch` on the CUDA backend.
     Threshold SHARES carry no SigManager signature (they are verified
     at combine time by the collector plane), so they pass through
     parse-only.

Survivors enter the dispatcher's external queue as `AdmittedMsg`
objects with the verdict attached (`msg._adm_verified`); handlers
consult the verdict instead of re-verifying and re-check only the
cheap *stateful* gates (current epoch/view/window, spoofing, client
state) that admission cannot freeze. A forged signature poisons only
the guilty message, never its drain batch. One deliberate asymmetry:
a verify-failed PrePrepare is admitted WITH its failed verdict
(`_adm_verified = False`) instead of dropped — a view-change entry
parked on missing restriction bodies consumes fetched old-view
PrePrepares authenticated by digest alone (replica._try_resolve_body),
including bodies signed under since-rotated keys; the handler rejects
the failed verdict for live proposals.

Gated by `ReplicaConfig.admission_workers` (0 = legacy inline path:
raw bytes to the dispatcher, parse/verify in the handlers).

Overload backpressure: ingest classifies each datagram by its 2-byte
code peek. Protocol-critical traffic (view-change family, checkpoints,
state transfer, restart votes — `_CRITICAL_CODES`) rides a dedicated
priority queue with its own headroom that workers drain FIRST and that
watermark shedding never touches. Everything else shares the main
buffer: when its depth crosses `admission_high_watermark` the plane
enters shed mode and drops fresh client datagrams at ingest (counted
in `adm_shed_overload`, one counter per shed) until depth falls to
`admission_low_watermark`. Blind tail-drop at the hard bound still
exists (`adm_dropped_ingress`) but watermark shedding fires first, so
an overloaded replica degrades by shedding client goodput — never its
liveness machinery.
"""
from __future__ import annotations

import struct
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from tpubft_torch.consensus import messages as m
from tpubft_torch.consensus.incoming import MAX_EXTERNAL_PENDING
from tpubft_torch.utils import flight
from tpubft_torch.utils.logging import get_logger
from tpubft_torch.utils.metrics import Aggregator, Component

log = get_logger("admission")


@dataclass
class AdmittedMsg:
    """A pre-parsed, pre-verified external message, ready for the
    dispatcher. `msg` carries `_adm_verified = True` when the admission
    plane checked a SigManager signature for its type (absent when the
    type has none to check; False for the PrePrepare digest-fetch
    passage), and `_adm_inners` with the surviving parsed elements for
    ClientBatchRequestMsg. The raw datagram is deliberately NOT carried:
    under backpressure the external queue holds up to 20k entries, and
    pinning every admitted datagram's bytes next to its parsed form
    would retain ~max_message_size per entry for nothing (no dispatcher
    consumer reads it; the batch relay re-packs)."""
    sender: int
    msg: object


# fixed wire prefix offsets (messages.py SPECs; serialize.py packs
# fixed-width ints little-endian back-to-back):
#   u16 code | u32 sender_id | ...
_CODE = struct.Struct("<H")
# codes whose prefix continues | u64 view @6 | u64 seq @14 | and whose
# handlers only ever accept current-view, in-window traffic.
# PrePrepare is deliberately NOT here despite sharing the layout: an
# old-view (or just-stabilized) PrePrepare body is exactly what a
# view-change entry parked on missing restriction bodies is fetching
# (replica._try_resolve_body / _on_req_view_pp) — peek-dropping it
# would stall view entry forever. Old-view PrePrepares pay full
# parse+verify off-dispatcher and are then judged by the dispatcher's
# stateful gates, like any relay-safe message.
_VIEW_SEQ_CODES = frozenset(int(c) for c in (
    m.MsgCode.StartSlowCommit,
    m.MsgCode.PreparePartial, m.MsgCode.PrepareFull,
    m.MsgCode.CommitPartial, m.MsgCode.CommitFull,
    m.MsgCode.PartialCommitProof, m.MsgCode.FullCommitProof,
    m.MsgCode.AggregateShare))
_VIEW_SEQ = struct.Struct("<QQ")        # at offset 6
# Checkpoint: | u64 seq @6 |
_CKPT_CODE = int(m.MsgCode.Checkpoint)
_SEQ = struct.Struct("<Q")              # at offset 6
# view-change family: | u64 view-or-new_view @6 |. Handlers drop
# view < current (complaints) / new_view <= current (VC, NewView)
# pre-verify; fronting the same monotone gates here keeps dead-view
# floods from buying signature work in the drain batch.
_COMPLAINT_CODE = int(m.MsgCode.ReplicaAsksToLeaveView)
_VC_CODES = frozenset((int(m.MsgCode.ViewChange), int(m.MsgCode.NewView)))

# ---- overload backpressure classes (ingest-time, code peek only) ----
# protocol-critical traffic rides a dedicated priority queue that
# watermark shedding never touches and workers drain first: view-change
# family (liveness), checkpoints (stability/GC), state transfer
# (recovery), restart votes/proofs (operator control). An overloaded
# replica sheds client goodput, never its ability to stay in the
# protocol.
_CRITICAL_CODES = frozenset(int(c) for c in (
    m.MsgCode.ReplicaAsksToLeaveView, m.MsgCode.ViewChange,
    m.MsgCode.NewView, m.MsgCode.Checkpoint, m.MsgCode.AskForCheckpoint,
    m.MsgCode.StateTransfer, m.MsgCode.ReplicaRestartReady,
    m.MsgCode.RestartProof))
# fresh client load — the sheddable class under overload
_CLIENT_CODES = frozenset((int(m.MsgCode.ClientRequest),
                           int(m.MsgCode.ClientBatchRequest)))
# client principal for shard routing: u32 sender_id at wire offset 2
# (the same fixed prefix every peek uses)
_SENDER = struct.Struct("<I")


def shard_of(sender_id: int, shards: int) -> int:
    """Stable shard for a client principal: Knuth multiplicative hash of
    the wire sender_id. Deterministic across drains/restarts (the whole
    point — each worker's SigManager verify batches, memo and comb
    caches see a disjoint, STABLE slice of the key population, so
    per-principal key material stays hot per shard instead of being
    diluted across every worker), and mixing keeps adjacent principal
    ids from landing in lockstep with any client-side id striping."""
    return ((sender_id * 2654435761) & 0xFFFFFFFF) % shards


class AdmissionPipeline:
    """Bounded ingest queue + worker pool. Thread-safe producers
    (transport receive threads) call `submit`/`submit_burst`; workers
    drain bursts and hand `AdmittedMsg`s to `sink` (the dispatcher's
    external queue) in drain order."""

    def __init__(self, sig, info, sink: Callable[[AdmittedMsg], bool],
                 epoch_fn: Callable[[], int],
                 view_fn: Callable[[], int],
                 stable_fn: Callable[[], int],
                 workers: int = 1, drain_max: int = 256,
                 max_pending: int = MAX_EXTERNAL_PENDING,
                 aggregator: Optional[Aggregator] = None,
                 name: str = "admission", ckpt_window: int = 0,
                 high_watermark: int = 0, low_watermark: int = 0,
                 beat_fn: Optional[Callable[[], None]] = None,
                 rid: int = -1, shard_by_key: bool = True):
        self._sig = sig
        self._info = info
        self._sink = sink
        # replica id for flight-recorder attribution (multi-replica
        # processes: the in-process test cluster)
        self._rid = rid
        self._epoch_fn = epoch_fn
        self._view_fn = view_fn
        self._stable_fn = stable_fn
        self._drain_max = max(1, drain_max)
        self._n_workers = max(1, workers)
        self._name = name
        # checkpoint-window size for the peek-stage multiple check
        # (0 = disabled; the dispatcher gate still applies)
        self._ckpt_window = ckpt_window
        # ingest buffer: deque + Condition instead of queue.Queue so a
        # whole transport burst (the recvmmsg drain) enters under ONE
        # lock round (extend + one wake), not a lock cycle per datagram
        self._buf: "deque[Tuple[int, bytes]]" = deque()
        # key-sharded client routing (million-principal client plane):
        # with >1 workers, CLIENT datagrams route to a per-worker shard
        # buffer by a stable hash of the wire principal, so each
        # worker's verify batches / memo / comb caches see a disjoint,
        # stable key population. Critical + other traffic stays on the
        # shared queues (any worker drains it — liveness machinery must
        # never wait behind one shard's backlog). Empty list = routing
        # off (single worker, or shard_by_key=False for the A/B).
        self._shards: List["deque[Tuple[int, bytes]]"] = (
            [deque() for _ in range(self._n_workers)]
            if shard_by_key and self._n_workers > 1 else [])
        # protocol-critical priority queue (see _CRITICAL_CODES): its
        # own headroom up to max_pending — a client flood filling _buf
        # can never push a view-change or checkpoint out
        self._crit: "deque[Tuple[int, bytes]]" = deque()
        self._max_pending = max_pending
        # overload watermarks (0 = shedding disabled): depth >= high
        # enters shed mode (fresh client datagrams dropped at ingest,
        # each counted in adm_shed_overload), depth <= low leaves it.
        # Both clamp under max_pending so a small hard bound degrades
        # the hysteresis gap instead of inverting it (low above high
        # would flap shed mode on every other datagram).
        self._high = min(high_watermark, max_pending) if high_watermark \
            else 0
        self._low = min(low_watermark, self._high - 1) if self._high \
            else low_watermark
        self._shedding = False
        self._beat = beat_fn          # health-plane liveness hook
        # per-worker liveness stamps (re-seeded in start()); the probe
        # beat tracks the OLDEST stamp so one wedged worker is visible
        self._worker_beats: List[float] = [time.monotonic()] \
            * self._n_workers
        # ingest handoff Condition: CheckedLock-backed under
        # TPUBFT_THREADCHECK (racecheck.make_condition) so the
        # transport->worker handoff feeds the runtime lock-order
        # graph like every make_lock site
        from tpubft_torch.utils.racecheck import make_condition, make_lock
        self._cv = make_condition(f"{name}.cv")
        self._threads: List[threading.Thread] = []
        self._running = False
        self._processed = 0
        # client-principal topology is static: capture it once so the
        # worker-side gates never touch replica state. Production
        # topologies hand us a contiguous `range` (O(1) membership, O(1)
        # memory at 1M principals); anything else is frozen to a set.
        ids = info.all_client_ids()
        self._clients = ids if isinstance(ids, range) else frozenset(ids)
        # instrumented under TPUBFT_THREADCHECK: admission worker ⇄
        # dispatcher lock ordering rides the global order graph
        self._stats_mu = make_lock(f"{name}.stats")

        self.metrics = Component("admission", aggregator)
        # ingest backpressure drops (queue full at the transport edge)
        self.adm_dropped_ingress = self.metrics.register_counter(
            "adm_dropped_ingress")
        # header-peek / parse-stage drops: garbage, unknown code,
        # dead-view / stale-seq prefix, within-drain duplicates,
        # unparseable bytes
        self.adm_drops_pre_parse = self.metrics.register_counter(
            "adm_drops_pre_parse")
        # post-parse stateless-gate drops: dead-era epoch, sender
        # spoofing, client-topology violations
        self.adm_drops_stateless = self.metrics.register_counter(
            "adm_drops_stateless")
        # signatures verified through the per-drain coalesced batch
        self.adm_batched_verifies = self.metrics.register_counter(
            "adm_batched_verifies")
        # messages dropped for a failed signature (the guilty message
        # only — the rest of its drain batch is unaffected)
        self.adm_verify_fail = self.metrics.register_counter(
            "adm_verify_fail")
        self.adm_queue_depth = self.metrics.register_gauge(
            "adm_queue_depth")
        # client datagrams shed at ingest while in overload shed mode —
        # with adm_dropped_ingress (hard bound) these are the only two
        # ingest-time dispositions besides admission to the buffer, so
        # submitted == buffered + shed + dropped_ingress always holds
        self.adm_shed_overload = self.metrics.register_counter(
            "adm_shed_overload")
        self.adm_shedding = self.metrics.register_gauge("adm_shedding")
        self.adm_drains = self.metrics.register_counter("adm_drains")
        # messages handed to the dispatcher queue; admitted + the four
        # drop counters above account for every ingested message, which
        # benches/tests use as a drain marker
        self.adm_admitted = self.metrics.register_counter("adm_admitted")

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._running:
            return
        self._running = True
        now = time.monotonic()
        self._worker_beats = [now] * self._n_workers
        for i in range(self._n_workers):
            t = threading.Thread(target=self._run, args=(i,), daemon=True,
                                 name=f"{self._name}-{i}")
            self._threads.append(t)
            t.start()

    def stop(self) -> None:
        self._running = False
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []

    # ------------------------------------------------------------------
    # ingest (transport threads)
    # ------------------------------------------------------------------
    def _class_of(self, raw: bytes) -> Tuple[str, int]:
        """Ingest class from the 2-byte code peek: 'crit' (protected
        priority queue), 'client' (sheddable under overload), 'other'
        (consensus shares etc. — bounded but never watermark-shed).
        Second element is the client's shard route (worker index) when
        key-sharded routing is on, else -1 (shared buffer)."""
        if len(raw) >= 2:
            (code,) = _CODE.unpack_from(raw)
            if code in _CRITICAL_CODES:
                return "crit", -1
            if code in _CLIENT_CODES:
                if self._shards and len(raw) >= 6:
                    (principal,) = _SENDER.unpack_from(raw, 2)
                    return "client", shard_of(principal, self._n_workers)
                return "client", -1
        return "other", -1

    def _client_depth(self) -> int:
        """Queued client+other datagrams (caller holds self._cv)."""
        return len(self._buf) + sum(map(len, self._shards))

    def _ingest_locked(self, sender: int, raw: bytes,
                       cls: Tuple[str, int]) -> str:
        """One datagram's ingest disposition under self._cv (`cls`
        precomputed by the caller OUTSIDE the lock — classification is
        stateless and must not extend the critical section):
        'ok' (buffered), 'shed' (overload watermark), 'full' (hard
        bound). Exactly one counter fires per disposition — the
        accounting invariant tests and benches rely on. Watermarks and
        the hard bound are computed over the TOTAL queued depth, so the
        sharded router keeps byte-identical shed/drop accounting with
        the shared-buffer path."""
        kind, route = cls
        if kind == "crit":
            if len(self._crit) >= self._max_pending:
                return "full"
            self._crit.append((sender, raw))
            return "ok"
        depth = self._client_depth() + len(self._crit)
        if self._high:
            if not self._shedding and depth >= self._high:
                self._shedding = True
                self.adm_shedding.set(1)
            elif self._shedding and depth <= self._low:
                self._shedding = False
                self.adm_shedding.set(0)
        if self._shedding and kind == "client":
            return "shed"
        if self._client_depth() >= self._max_pending:
            return "full"
        if route >= 0:
            self._shards[route].append((sender, raw))
        else:
            self._buf.append((sender, raw))
        return "ok"

    def set_watermarks(self, high_watermark: int,
                       low_watermark: int) -> None:
        """Autotuner actuator: retune the overload watermarks live.
        Same clamping as construction (both bounded by max_pending, low
        strictly under high so the hysteresis gap never inverts); a
        shed mode now outside the new band clears on the next ingest's
        watermark pass."""
        with self._cv:
            self._high = min(high_watermark, self._max_pending) \
                if high_watermark else 0
            self._low = min(low_watermark, self._high - 1) if self._high \
                else low_watermark
            if not self._high and self._shedding:
                # shedding disabled mid-episode: nothing will ever
                # cross the (gone) low watermark to clear the flag
                self._shedding = False
                self.adm_shedding.set(0)

    @property
    def high_watermark(self) -> int:
        return self._high

    def submit(self, sender: int, raw: bytes) -> bool:
        flight.record(flight.EV_ADM_INGEST, arg=1)
        cls = self._class_of(raw)
        with self._cv:
            d = self._ingest_locked(sender, raw, cls)
            if d == "ok":
                if self._shards:
                    # one shared Condition across sharded workers: a
                    # single notify could land on a worker whose shard
                    # stayed empty while the routed worker sleeps out
                    # its 0.1s wait — wake everyone, the non-owners
                    # re-sleep immediately
                    self._cv.notify_all()
                else:
                    self._cv.notify()
        if d == "full":
            self.adm_dropped_ingress.inc()
        elif d == "shed":
            self.adm_shed_overload.inc()
        return d == "ok"

    def submit_burst(self, msgs: Iterable[Tuple[int, bytes]]) -> None:
        """Whole-burst ingest: one Condition acquire for the burst, one
        wake (all workers when the burst spans several drains) — the
        handoff half of the recvmmsg amortization."""
        # classify OUTSIDE the lock: the whole burst's unpack_from peeks
        # happen before workers are blocked on _cv, preserving the
        # one-lock-round handoff recvmmsg bought
        classed = [(sender, raw, self._class_of(raw))
                   for sender, raw in msgs]
        flight.record(flight.EV_ADM_INGEST, arg=len(classed))
        taken = shed = full = 0
        with self._cv:
            for sender, raw, cls in classed:
                d = self._ingest_locked(sender, raw, cls)
                if d == "ok":
                    taken += 1
                elif d == "shed":
                    shed += 1
                else:
                    full += 1
            if taken:
                if self._shards or taken > self._drain_max:
                    self._cv.notify_all()
                else:
                    self._cv.notify()
        if full:
            self.adm_dropped_ingress.inc(full)
        if shed:
            self.adm_shed_overload.inc(shed)

    @property
    def depth(self) -> int:
        # racy read is fine for a gauge
        return (len(self._buf) + len(self._crit)
                + sum(map(len, self._shards)))

    @property
    def shedding(self) -> bool:
        """Overload shed mode (degraded-state input to the health
        plane)."""
        return self._shedding

    @property
    def processed(self) -> int:
        """Messages fully through the plane (admitted or dropped) —
        `processed == submitted-minus-ingress-drops` is the benches' and
        tests' drain marker."""
        return self._processed

    # ------------------------------------------------------------------
    # worker loop
    # ------------------------------------------------------------------
    def _next_batch(self, idx: int = 0) -> List[Tuple[int, bytes]]:
        with self._cv:
            mine = self._shards[idx] if self._shards else None
            if not self._buf and not self._crit \
                    and not (mine and len(mine)):
                self._cv.wait(0.1)
            out: List[Tuple[int, bytes]] = []
            # protocol-critical first: under overload the liveness
            # machinery is parsed/verified ahead of queued client load
            while self._crit and len(out) < self._drain_max:
                out.append(self._crit.popleft())
            # own shard next (key-sharded routing: this worker's stable
            # slice of the client principal population), then the shared
            # buffer — so non-client traffic and unrouted clients never
            # starve behind one shard's backlog
            if mine is not None:
                while mine and len(out) < self._drain_max:
                    out.append(mine.popleft())
            while self._buf and len(out) < self._drain_max:
                out.append(self._buf.popleft())
            if self._shedding \
                    and self._client_depth() + len(self._crit) \
                    <= self._low:
                self._shedding = False
                self.adm_shedding.set(0)
            return out

    def _stamp_beat(self, idx: int) -> None:
        """Per-worker liveness stamp; the external health beat fires
        only when the STALEST worker's stamp advances. One wedged
        worker (and the drained batch it holds) therefore freezes the
        probe age even while sibling workers keep looping — with a
        shared beat, any surviving worker would mask the stall."""
        if self._beat is None:
            return
        now = time.monotonic()
        with self._cv:
            beats = self._worker_beats
            was_oldest = beats[idx] <= min(beats)
            beats[idx] = now
        if was_oldest:
            try:
                self._beat()
            except Exception:  # noqa: BLE001 — the health hook must not
                pass           # kill a worker

    def _run(self, idx: int = 0) -> None:
        flight.set_thread_rid(self._rid)
        while self._running:
            self._stamp_beat(idx)     # health probe: a worker wedged
            # inside _drain stops stamping; once it is the stalest, the
            # probe age grows while depth does — that IS the stall
            batch = self._next_batch(idx)
            if not batch:
                continue
            try:
                self._drain(batch)
            except Exception:  # noqa: BLE001 — a bad drain must not kill
                log.exception("admission drain raised (%d msgs dropped)",
                              len(batch))
                with self._stats_mu:
                    self._processed += len(batch)

    # ------------------------------------------------------------------
    # one drain cycle
    # ------------------------------------------------------------------
    def _peek_ok(self, raw: bytes, view: int, stable: int) -> bool:
        """Fixed-prefix drop decisions that need no parse. Conservative
        by construction: `view`/`stable` only ever advance, so a stale
        read under-drops and the dispatcher's stateful gates still
        apply; nothing a current-state dispatcher would accept is
        dropped here."""
        if len(raw) < 2:
            return False
        (code,) = _CODE.unpack_from(raw)
        if not m.known_code(code):
            return False
        if code in _VIEW_SEQ_CODES:
            if len(raw) < 22:
                return False                    # shorter than its prefix
            mview, mseq = _VIEW_SEQ.unpack_from(raw, 6)
            if mview < view or mseq <= stable:
                return False                    # dead view / GC'd seqnum
        elif code == _CKPT_CODE:
            if len(raw) < 14:
                return False
            (mseq,) = _SEQ.unpack_from(raw, 6)
            if mseq <= stable:
                return False
            # only checkpoint-window multiples are real checkpoints
            # (config-static; the handler applies the same rule
            # pre-verify) — a garbage-seq flood must not buy verifies
            if self._ckpt_window and mseq % self._ckpt_window:
                return False
        elif code == _COMPLAINT_CODE:
            if len(raw) < 14:
                return False
            (mview,) = _SEQ.unpack_from(raw, 6)
            if mview < view:
                return False                    # complaint about a dead view
        elif code in _VC_CODES:
            if len(raw) < 14:
                return False
            (mview,) = _SEQ.unpack_from(raw, 6)
            if mview <= view:
                return False                    # new_view already entered
        return True

    def _stateless_ok(self, sender: int, msg, epoch: int) -> bool:
        """Post-parse gates that depend only on the message, the
        transport sender, and monotone replica state. The dispatcher
        re-checks the stateful versions (current epoch/view, client
        state) — admission cannot freeze those."""
        # dead-era drop: strictly-lower epochs only (epoch is monotone,
        # so a stale read under-drops; higher-epoch traffic passes —
        # the dispatcher keeps the higher-epoch Checkpoint exception)
        msg_epoch = getattr(msg, "epoch", None)
        if msg_epoch is not None and msg_epoch < epoch:
            return False
        if isinstance(msg, (m.ClientRequestMsg, m.ClientBatchRequestMsg)):
            # accepted from the client itself OR forwarded by a replica
            if msg.sender_id != sender and not self._info.is_replica(sender):
                return False
            if msg.sender_id not in self._clients:
                return False
            if isinstance(msg, m.ClientRequestMsg):
                return self._client_req_ok(msg)
            return True
        if not isinstance(msg, m.RELAY_SAFE) \
                and getattr(msg, "sender_id", sender) != sender:
            return False                        # sender spoofing
        return True

    def _client_req_ok(self, req: m.ClientRequestMsg) -> bool:
        """Topology-static request gates, THE SAME predicate the
        dispatcher applies (messages.client_request_admissible) — forged
        floods never reach the verify batch, and the two paths can never
        disagree about what is admissible."""
        return m.client_request_admissible(req, self._info)

    def _collect_jobs(self, msg, jobs: List[tuple]) -> Optional[List[int]]:
        """Append this message's signature-verification items to `jobs`
        as (principal, data, sig, seq, view_scoped); returns the list of
        job indices backing the message's verdict, or None when the type
        carries nothing for SigManager (shares, status, acks, ST, …)."""
        idxs: List[int] = []

        def add(principal, data, sig, seq=None, view_scoped=False):
            idxs.append(len(jobs))
            jobs.append((principal, data, sig, seq, view_scoped))

        REPLICA_SIGNED = (m.PrePrepareMsg, m.CheckpointMsg,
                          m.TimeOpinionMsg, m.ReplicaAsksToLeaveViewMsg,
                          m.ViewChangeMsg, m.NewViewMsg,
                          m.ReplicaRestartReadyMsg)
        if isinstance(msg, REPLICA_SIGNED) \
                and not self._info.is_replica(msg.sender_id):
            # junk principals must not buy signature work (the handlers'
            # is_replica gates, fronted); NOT applied to pass-through
            # types — StateTransfer/AskForCheckpoint legitimately come
            # from read-only replicas
            return []
        if isinstance(msg, m.ClientRequestMsg):
            add(msg.sender_id, msg.signed_payload(), msg.signature)
        elif isinstance(msg, m.PrePrepareMsg):
            add(msg.sender_id, msg.signed_payload(), msg.signature,
                seq=msg.seq_num)
            # embedded client requests: parsed once here (memoized on the
            # message), verified in the same coalesced batch — a
            # byzantine primary's forged element fails the whole proposal
            # exactly as the dispatcher's batch check would
            for r in msg.client_requests():
                if not r.flags & m.RequestFlag.HAS_PRE_PROCESSED:
                    add(r.sender_id, r.signed_payload(), r.signature,
                        seq=msg.seq_num)
        elif isinstance(msg, m.CheckpointMsg):
            add(msg.sender_id, msg.signed_payload(), msg.signature,
                seq=msg.seq_num)
        elif isinstance(msg, m.TimeOpinionMsg):
            add(msg.sender_id, msg.signed_payload(), msg.signature)
        elif isinstance(msg, (m.ReplicaAsksToLeaveViewMsg, m.ViewChangeMsg,
                              m.NewViewMsg)):
            add(msg.sender_id, msg.signed_payload(), msg.signature,
                view_scoped=True)
        elif isinstance(msg, m.ReplicaRestartReadyMsg):
            add(msg.sender_id, msg.signed_payload(), msg.signature,
                seq=msg.seq_num)
        else:
            return None
        return idxs

    def _verify_jobs(self, jobs: List[tuple]) -> List[bool]:
        """ONE coalesced SigManager.verify_batch for the whole drain —
        at most one device dispatch per scheme on the CUDA backend, taken
        behind the process-wide `ops.dispatch.device_dispatch` gate
        INSIDE the kernel (ops/ed25519.py, ops/ecdsa.py), so the gate is
        held exactly for the device call and never across the memo pass
        or a scalar-fallback residue. Items that fail under the current
        key and carry protocol context retry in small per-context groups
        so the post-rotation grace path stays correct."""
        if not jobs:
            return []
        flat = [(p, d, s) for p, d, s, _, _ in jobs]
        verdicts = self._sig.verify_batch(flat)
        self.adm_batched_verifies.inc(len(flat))
        retries: Dict[Tuple, List[int]] = {}
        for i, ok in enumerate(verdicts):
            _, _, _, seq, vs = jobs[i]
            if not ok and (seq is not None or vs):
                retries.setdefault((seq, vs), []).append(i)
        for (seq, vs), idxs in retries.items():
            sub = self._sig.verify_batch([flat[i] for i in idxs],
                                         seq=seq, view_scoped=vs)
            for i, ok in zip(idxs, sub):
                verdicts[i] = ok
        return verdicts

    def _drain(self, batch: List[Tuple[int, bytes]]) -> None:
        from tpubft_torch.utils.tracing import get_tracer
        flight.record(flight.EV_ADM_DRAIN, arg=len(batch))
        view, stable, epoch = (self._view_fn(), self._stable_fn(),
                               self._epoch_fn())
        with get_tracer().start_span("adm_drain") as span:
            pre_drops = stateless_drops = verify_fails = 0
            seen: set = set()
            parsed: List[Tuple[int, bytes, object]] = []
            for sender, raw in batch:
                # per-message isolation: ANY failure (not just the
                # anticipated MsgError) poisons only this message, never
                # its drain batch — the documented guarantee holds for
                # exception-class poisoning too
                try:
                    if not self._peek_ok(raw, view, stable):
                        pre_drops += 1
                        continue
                    key = (sender, raw)
                    if key in seen:
                        # within-drain duplicate (flood retransmit
                        # burst): collapse — a real retransmission
                        # arrives in a later drain and still earns its
                        # receipt ack
                        pre_drops += 1
                        continue
                    seen.add(key)
                    msg = m.unpack(raw)
                    if not self._stateless_ok(sender, msg, epoch):
                        stateless_drops += 1
                        continue
                except m.MsgError:
                    pre_drops += 1
                    continue
                except Exception:  # noqa: BLE001 — hostile bytes must
                    log.debug("admission parse stage raised",  # not kill
                              exc_info=True)
                    pre_drops += 1
                    continue
                parsed.append((sender, raw, msg))

            # per-message verification jobs, coalesced across the drain
            jobs: List[tuple] = []
            backing: List[Optional[List[int]]] = []
            inner_sets: List[Optional[List]] = []
            for sender, raw, msg in parsed:
                n_jobs_before = len(jobs)
                try:
                    if isinstance(msg, m.ClientBatchRequestMsg):
                        inners = m.parse_batch_elements(msg)
                        if inners is None:
                            backing.append([])  # malformed: drop batch
                            inner_sets.append(None)  # (counted below)
                            continue
                        # topology-static element gates BEFORE the
                        # verify batch (like wire ClientRequestMsgs):
                        # flag-violating elements must not buy signature
                        # work, and they are stateless drops, not forged
                        # signatures
                        kept = [r for r in inners
                                if self._client_req_ok(r)]
                        stateless_drops += len(inners) - len(kept)
                        per_inner = []
                        for inner in kept:
                            idx = len(jobs)
                            jobs.append((inner.sender_id,
                                         inner.signed_payload(),
                                         inner.signature, None, False))
                            per_inner.append(idx)
                        backing.append(per_inner)
                        inner_sets.append(kept)
                    else:
                        backing.append(self._collect_jobs(msg, jobs))
                        inner_sets.append(None)
                except Exception:  # noqa: BLE001 — per-message isolation
                    del jobs[n_jobs_before:]    # its half-added jobs too
                    backing.append([])          # (counted below)
                    inner_sets.append(None)

            try:
                verdicts = self._verify_jobs(jobs)
            except Exception:  # noqa: BLE001 — an engine failure must
                # not discard the drain's no-signature traffic; items
                # that needed a verdict fail closed
                log.exception("coalesced verify raised (%d items)",
                              len(jobs))
                verdicts = [False] * len(jobs)

            admitted = 0
            for (sender, raw, msg), idxs, inners in zip(parsed, backing,
                                                        inner_sets):
                if inners is not None:
                    # per-element verdicts: only guilty elements drop
                    survivors = []
                    for inner, i in zip(inners, idxs):
                        if verdicts[i]:
                            inner._adm_verified = True
                            survivors.append(inner)
                        else:
                            verify_fails += 1
                    if not survivors:
                        continue
                    msg._adm_inners = survivors
                elif idxs is not None:
                    if not idxs:
                        # structurally rejected (junk principal on a
                        # replica-signed type, malformed batch/embedded
                        # content, or a per-message exception above) —
                        # the ONE counting site for []-backed drops, so
                        # the drop counters account for every message
                        stateless_drops += 1
                        continue
                    if not all(verdicts[i] for i in idxs):
                        verify_fails += sum(1 for i in idxs
                                            if not verdicts[i])
                        if not isinstance(msg, m.PrePrepareMsg):
                            continue            # guilty message dropped
                        # a verify-FAILED PrePrepare is still admitted,
                        # carrying an explicit failed verdict: a parked
                        # view-change entry consumes fetched old-view
                        # bodies authenticated by DIGEST only
                        # (_try_resolve_body) — a body signed under a
                        # since-rotated key must not be shed here or
                        # view entry stalls. _on_pre_prepare rejects the
                        # failed verdict for live proposals.
                        msg._adm_verified = False
                    else:
                        msg._adm_verified = True
                        if isinstance(msg, m.PrePrepareMsg):
                            # the embedded requests passed the same
                            # batch: mark them so the PP handler (and
                            # any future per-request consumer) can
                            # trust the verdict
                            for r in msg.client_requests():
                                if not r.flags \
                                        & m.RequestFlag.HAS_PRE_PROCESSED:
                                    r._adm_verified = True
                if isinstance(msg, m.PrePrepareMsg):
                    # slot-lifecycle anchor: the adm_wait stage runs
                    # from here to the dispatcher's PP handler entry
                    flight.record(flight.EV_ADM_ADMIT, seq=msg.seq_num,
                                  view=msg.view)
                self._sink(AdmittedMsg(sender, msg))
                admitted += 1

            # stats under the (racecheck-instrumented) admission lock:
            # held briefly, never across verification or the sink
            with self._stats_mu:
                self._processed += len(batch)
                self.adm_drains.inc()
                if admitted:
                    self.adm_admitted.inc(admitted)
                if pre_drops:
                    self.adm_drops_pre_parse.inc(pre_drops)
                if stateless_drops:
                    self.adm_drops_stateless.inc(stateless_drops)
                if verify_fails:
                    self.adm_verify_fail.inc(verify_fails)
                self.adm_queue_depth.set(self.depth)
            span.set_tag("msgs", len(batch)).set_tag("admitted", admitted) \
                .set_tag("verifies", len(jobs)) \
                .set_tag("pre_drops", pre_drops) \
                .set_tag("verify_fails", verify_fails)
