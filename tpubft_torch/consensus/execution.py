"""Execution lane — committed-slot execution off the dispatcher thread.

The reference separates ordering from post-execution (concord-bft's
post-execution separation + block accumulation: PostExecJob queues and
the accumulated-block commit in kv_blockchain): the dispatcher thread
marks slots committed and hands them over; a single executor thread
drains *runs* of consecutive committed slots in seqnum order and applies
each run as ONE coalesced commit:

  * one ledger commit per run — the handler's add_block calls stage into
    a shared WriteBatch via KeyValueBlockchain.begin/end_accumulation
    (read-your-writes overlay, the ledger's _StagedReadView), so N blocks cost
    one DB write instead of N;
  * one reserved-pages batch per run for the reply ring / at-most-once
    markers (folded into the ledger batch when pages share its DB —
    apply is then atomic across ledger and reply state);
  * replies are handed back to the dispatcher, whose send loop already
    rides the transport batcher.

SPECULATIVE runs (ReplicaConfig.speculative_execution): the dispatcher
hands a slot over at prepare-quorum (slow path) or PrePrepare
acceptance (fast paths) — before its commit certificate exists. The
lane executes it inside an OPEN speculative accumulation (staged
WriteBatch + staged reply pages, nothing durable, overlay visible only
to this thread) and then parks, overlapping execution with the
threshold combine that used to serialize ahead of it. When the
dispatcher confirms every slot's commit with the SAME digest the run
speculated on, the lane SEALS it — one end_accumulation, the normal
durable-apply tail — and only then do replies and `last_executed`
advance (strictly post-commit, exactly as before). On an abort request
(view change, barrier batch, state-transfer adoption, digest
surprise), the lane discards the overlay via abort_accumulation; the
slots re-execute later from their committed PrePrepares through the
normal path. A crash mid-speculation leaves NO trace (the overlay was
never durable); a crash at the seal seam (`exec.spec_seal`) replays
the committed suffix exactly once.

Safety rules enforced here and in the replica wiring:

  * `last_executed` advances on the DISPATCHER, only after the run's
    durable apply (the completed-run handoff) — a crash between commit
    and apply replays the committed suffix, deduplicated by the
    reserved-pages at-most-once state;
  * runs never cross a checkpoint-window boundary, and the boundary
    run's state/pages digests are snapshotted HERE, before the next run
    can mutate state — checkpoint certificates stay comparable
    cluster-wide;
  * batches carrying INTERNAL/RECONFIG requests never reach the lane:
    the dispatcher drains it and executes them inline (they mutate
    dispatcher-owned subsystems: key exchange, cron, wedge control) —
    and never speculate;
  * view change, wedge announcement, and state-transfer completion all
    abort any open speculation and drain the lane first
    (Replica._drain_exec_lane).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from tpubft_torch.storage.interfaces import WriteBatch
from tpubft_torch.testing.crashpoints import crashpoint
from tpubft_torch.utils import flight
from tpubft_torch.utils.logging import get_logger, mdc_scope
from tpubft_torch.utils.racecheck import get_watchdog, make_lock

log = get_logger("execlane")


@dataclass
class CompletedRun:
    """A durably-applied run, ready for the dispatcher to integrate."""
    first: int
    last: int
    n_requests: int                       # executed (non-dedup) requests
    replies: List[Tuple[int, bytes]] = field(default_factory=list)
    reply_keys: List[Tuple[int, int]] = field(default_factory=list)
    # optimistic-reply mode with the durability pipeline: replies built
    # UNSIGNED during execution; the io thread signs the whole sealed
    # group in one batched sign at the group boundary and appends the
    # packed wire bytes to `replies` before the group burst
    unsigned: List[Tuple[int, object]] = field(default_factory=list)
    # set by the durability pipeline when it already pushed `replies`
    # as part of the group-boundary send burst — the dispatcher's
    # integration pass must not send them a second time
    replies_sent: bool = False
    # (seq, state_digest, pages_digest, block_id) when `last` is a
    # checkpoint boundary — snapshotted at the boundary, before the
    # next run ran. block_id is the ledger height the state digest
    # binds (None for non-ledger handlers) — the thin-replica anchor
    # needs it to resolve a certified digest to a block row.
    checkpoint: Optional[Tuple[int, bytes, bytes, Optional[int]]] = None


@dataclass
class _SpecRun:
    """An OPEN speculative run: already executed into a never-durable
    accumulation, parked until every slot's commit is confirmed (seal)
    or an abort is requested. All mutation happens under the lane's
    condition; the accumulation bracket itself is touched only by the
    lane thread (begin at staging, end at seal, abort on request)."""
    first: int
    last: int
    pps: Dict[int, object]                # seq -> PrePrepare speculated
    digests: Dict[int, bytes]             # seq -> its digest at submit
    result: CompletedRun
    pages_wb: WriteBatch
    executed_now: List[Tuple[int, int, object]]
    t_open: float                         # monotonic: staging began
    seen: set = field(default_factory=set)
    confirmed: set = field(default_factory=set)
    t_confirmed: float = 0.0              # monotonic: last commit in
    abort: bool = False
    acc: bool = False                     # accumulation bracket open
    span: Optional[object] = None
    # checkpoint-boundary digests PRECOMPUTED at staging:
    # (seq, state_digest, head) — the lane parks between staging and
    # seal, so the handler state cannot move; riding them on the
    # speculation overlaps the expensive state digest with the combine
    # window instead of paying it synchronously at the seal
    ckpt_pre: Optional[Tuple[int, bytes, Optional[int]]] = None


class ExecutionLane:
    """Single executor thread + the dispatcher↔executor handoff.

    Dispatcher-side API: submit / confirm / abort_speculation / drain /
    pop_completed / depth. All protocol state stays dispatcher-owned;
    the lane touches only thread-safe surfaces (handler execution,
    ClientsManager, reserved pages, the blockchain's accumulation
    bracket)."""

    RETRY_DELAY_S = 0.5                   # backoff after a failed run

    def __init__(self, replica, max_accumulation: int,
                 checkpoint_window: int) -> None:
        self._r = replica
        self._max_acc = max(1, max_accumulation)
        self._ckpt_window = checkpoint_window
        self._mu = make_lock("exec_lane")
        self._cond = threading.Condition(self._mu)
        # entries are (seq, pre_prepare, speculative)
        self._pending: "deque[Tuple[int, object, bool]]" = deque()
        self._completed: "deque[CompletedRun]" = deque()
        self._busy = False
        self._held = False                # test hook: freeze execution
        self._retry_at = 0.0
        # durability-pipeline dedup bridge: (client, req_seq) -> reply
        # for requests executed in SEALED runs whose group fsync has
        # not landed yet. The at-most-once ClientsManager state only
        # becomes visible post-fsync (a retransmit must never be
        # answered from a run that could still be lost), but the LANE
        # must still dedup across back-to-back runs — the same request
        # re-proposed into a later slot (view change after an
        # equivocation, primary retry) would otherwise execute twice
        # before the first run's group lands: duplicate block,
        # permanent divergence. Written by the lane thread at seal,
        # erased by the io thread at completion (strictly AFTER
        # on_request_executed makes the ClientsManager entry visible,
        # so there is no uncovered window).
        self._inflight: Dict[Tuple[int, int], object] = {}
        self._spec: Optional[_SpecRun] = None
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._name = f"exec-{replica.id}"

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=self._name)
        self._thread.start()

    def stop(self) -> None:
        """Stop WITHOUT draining: pending slots are committed state that
        recovery replays — stop is crash-equivalent by design. An open
        speculation is aborted (never made durable) on the way out."""
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        get_watchdog().unregister(self._name)

    def set_max_accumulation(self, n: int) -> None:
        """Autotuner actuator: retune the run-coalescing cap live. The
        lane thread reads it once per run pop (under the condition), so
        the new cap applies from the next run."""
        with self._cond:
            self._max_acc = max(1, int(n))

    @property
    def max_accumulation(self) -> int:
        return self._max_acc

    # ------------------------------------------------------------------
    # dispatcher-side API
    # ------------------------------------------------------------------
    def submit(self, seq: int, pre_prepare,
               speculative: bool = False) -> None:
        """Hand a slot to the lane. The dispatcher submits in strictly
        increasing consecutive seq order; `speculative` slots arrive at
        prepare-quorum / acceptance, before their commit certificate."""
        with self._cond:
            if self._pending and seq != self._pending[-1][0] + 1:
                raise RuntimeError(
                    f"non-consecutive lane submit: {seq} after "
                    f"{self._pending[-1][0]}")
            self._pending.append((seq, pre_prepare, speculative))
            self._cond.notify_all()
        self._r.m_exec_lane_depth.set(self.depth)

    def confirm(self, seq: int, digest: bytes) -> bool:
        """Dispatcher: slot `seq`'s commit certificate landed over
        `digest`. Returns True when the lane's speculation for it
        matches (a still-pending speculative entry simply becomes a
        normal committed slot; a slot of the open run counts toward the
        seal). False = mismatch, abort in flight, or the lane does not
        know the slot — the dispatcher must abort speculation and
        resubmit through the normal committed path."""
        with self._cond:
            sp = self._spec
            if sp is not None and sp.first <= seq <= sp.last:
                if sp.abort or sp.digests.get(seq) != digest:
                    return False
                sp.confirmed.add(seq)
                if len(sp.confirmed) == sp.last - sp.first + 1 \
                        and not sp.t_confirmed:
                    sp.t_confirmed = time.monotonic()
                    self._cond.notify_all()
                return True
            for i in range(len(self._pending)):
                s, pp, spec = self._pending[i]
                if s != seq:
                    continue
                if not spec:
                    return True           # already a committed entry
                if pp.digest() != digest:
                    return False
                self._pending[i] = (s, pp, False)
                self._cond.notify_all()
                return True
            return False

    def abort_speculation(self, wait: float = 5.0) -> List[int]:
        """Dispatcher: discard ALL speculation — the open run's overlay
        (aborted on the lane thread; this call waits up to `wait` for
        the accumulation to actually roll back) and every pending entry
        from the first speculative one onward (later entries depend on
        the speculated prefix's execution order). Returns the removed
        seqs so the caller can roll back its submission bookkeeping and
        resubmit the committed ones through the normal path."""
        removed: List[int] = []
        with self._cond:
            sp = self._spec
            if sp is not None:
                sp.abort = True
                removed.extend(range(sp.first, sp.last + 1))
                # everything still pending sits AFTER the open run
                removed.extend(s for s, _pp, _f in self._pending)
                self._pending.clear()
            else:
                idx = next((i for i, e in enumerate(self._pending)
                            if e[2]), None)
                if idx is not None:
                    kept = deque()
                    for i, e in enumerate(self._pending):
                        if i < idx:
                            kept.append(e)
                        else:
                            removed.append(e[0])
                    self._pending = kept
            if not removed:
                return []
            self._cond.notify_all()
            deadline = time.monotonic() + wait
            while self._spec is not None and self._running \
                    and time.monotonic() < deadline:
                self._cond.wait(0.2)
        self._r.m_exec_lane_depth.set(self.depth)
        return sorted(set(removed))

    @property
    def speculating(self) -> bool:
        with self._cond:
            return self._spec is not None \
                or any(spec for _s, _pp, spec in self._pending)

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every submitted slot has been applied (pending
        empty, no run in flight, no open speculation). Returns False on
        timeout — the caller decides whether proceeding is safe. A
        speculative run cannot drain (it waits on commits only the
        dispatcher can confirm): callers abort speculation first
        (Replica._drain_exec_lane does). The executor never waits on
        the dispatcher, so this cannot deadlock."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._pending or self._busy or self._spec is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(remaining, 0.2))
        return True

    def complete_durable(self, run: CompletedRun) -> None:
        """Durability-pipeline completion hop (io thread): the run's
        group fsync landed — only now does it reach the dispatcher's
        integration queue (replies, `last_executed`, checkpoint votes).
        The caller (the pipeline) made the ClientsManager at-most-once
        entries visible FIRST, so dropping the in-flight dedup entries
        here leaves no uncovered window. On the legacy path _apply_run
        appends directly."""
        with self._cond:
            for key in run.reply_keys:
                self._inflight.pop(key, None)
            self._completed.append(run)
            self._cond.notify_all()

    def pop_completed(self) -> List[CompletedRun]:
        out = []
        with self._cond:
            while self._completed:
                out.append(self._completed.popleft())
        return out

    @property
    def depth(self) -> int:
        return len(self._pending)

    def idle(self) -> bool:
        with self._cond:
            return not self._pending and not self._busy \
                and self._spec is None

    # test hooks: freeze/unfreeze the lane so crash-window tests can
    # create "committed persisted, not yet applied" states determinately
    def hold(self) -> None:
        with self._cond:
            self._held = True

    def release(self) -> None:
        with self._cond:
            self._held = False
            self._cond.notify_all()

    # ------------------------------------------------------------------
    # executor thread
    # ------------------------------------------------------------------
    def _next_action_locked(self) -> Optional[str]:
        sp = self._spec
        if sp is not None and sp.abort:
            return "abort"                # even while held: stop-clean
        if self._held:
            return None
        if sp is not None:
            if len(sp.confirmed) == sp.last - sp.first + 1:
                return "seal"
            return None
        if self._pending and time.monotonic() >= self._retry_at:
            return "run"
        return None

    def _loop(self) -> None:
        watchdog = get_watchdog()
        # health-probe semantics are PROGRESS, not thread liveness: the
        # beat fires when the lane is idle (fresh age when work arrives)
        # and after each durable apply — depth > 0 with no apply for
        # execution_drain_timeout_ms reads as a stall (a wedged handler,
        # a run stuck behind a dead DB, or a held lane), even while this
        # thread is alive and waiting. An OPEN speculation counts as
        # busy: it resolves within a commit round trip or a view-change
        # abort, both far under the stall threshold.
        health = getattr(self._r, "health", None)
        flight.set_thread_rid(self._r.id)
        with mdc_scope(r=self._r.id):
            while True:
                watchdog.beat(self._name)
                action = None
                run: List[Tuple[int, object, bool]] = []
                sp: Optional[_SpecRun] = None
                with self._cond:
                    while self._running:
                        action = self._next_action_locked()
                        if action is not None:
                            break
                        if health is not None and not self._pending \
                                and self._spec is None:
                            health.beat("exec_lane")
                        self._cond.wait(0.2)
                        watchdog.beat(self._name)
                    if not self._running:
                        sp = self._spec
                        if sp is None:
                            return
                        sp.abort = True
                        action = "abort"
                    if action == "abort":
                        sp = self._spec
                    elif action == "seal":
                        sp, self._spec = self._spec, None
                        self._busy = True
                    else:                          # "run"
                        run = self._take_run_locked()
                        if run and run[0][2]:
                            # publish the speculation UNDER THIS LOCK
                            # HOLD: from the moment the entry left
                            # _pending, confirm() must be able to find
                            # it — a commit landing between pop and a
                            # later publication would read as
                            # unknown-slot, spuriously abort on the
                            # dispatcher, and leave an untracked open
                            # speculation wedging the lane
                            sp = self._publish_spec_locked(run)
                        else:
                            self._busy = True
                # ---- outside the condition ----
                if action == "abort":
                    self._abort_spec(sp, "stop" if not self._running
                                     else "request")
                    if not self._running:
                        return
                    continue
                if action == "seal":
                    try:
                        self._seal_spec_run(sp)
                        if health is not None:
                            health.beat("exec_lane")   # durable apply
                    except Exception:  # noqa: BLE001 — pre-durability
                        # seal failed before anything became durable
                        # (end_accumulation rolled the head back): the
                        # slots ARE committed — requeue them as normal
                        # entries and retry through the standard path
                        log.exception("spec seal [%d..%d] failed; "
                                      "requeueing as committed run",
                                      sp.first, sp.last)
                        with self._cond:
                            self._pending.extendleft(reversed(
                                [(s, sp.pps[s], False)
                                 for s in range(sp.first, sp.last + 1)]))
                            self._retry_at = (time.monotonic()
                                              + self.RETRY_DELAY_S)
                    finally:
                        with self._cond:
                            self._busy = False
                            self._cond.notify_all()
                    self._r.m_exec_lane_depth.set(self.depth)
                    continue
                if run and run[0][2]:
                    self._stage_into_spec(sp, [(s, pp)
                                               for s, pp, _f in run])
                    self._r.m_exec_lane_depth.set(self.depth)
                    continue
                plain = [(s, pp) for s, pp, _f in run]
                try:
                    self._execute_run(plain)
                    if health is not None:
                        health.beat("exec_lane")      # durable apply
                except Exception:  # noqa: BLE001 — retry, as inline did
                    log.exception("run [%d..%d] failed; will retry",
                                  plain[0][0], plain[-1][0])
                    with self._cond:
                        self._pending.extendleft(reversed(run))
                        self._retry_at = (time.monotonic()
                                          + self.RETRY_DELAY_S)
                finally:
                    with self._cond:
                        self._busy = False
                        self._cond.notify_all()
                self._r.m_exec_lane_depth.set(self.depth)

    def _take_run_locked(self) -> List[Tuple[int, object, bool]]:
        """Pop the next run. Committed runs coalesce: consecutive
        pending slots, capped at execution_max_accumulation, always
        breaking AFTER a checkpoint boundary so digests are computed at
        cluster-agreed points. SPECULATIVE runs are single-slot by
        design: a multi-slot speculation could only seal when its LAST
        slot commits, coupling the first slot's reply to later slots'
        combines — exactly the serialization speculation exists to
        remove. (Throughput coalescing is preserved anyway: under load
        commits land before the lane reaches pending speculative
        entries, flipping them into normal coalesced runs.)"""
        run: List[Tuple[int, object, bool]] = []
        while self._pending and len(run) < self._max_acc:
            seq, pp, spec = self._pending[0]
            if spec and not run:
                return [self._pending.popleft()]
            if run and (seq != run[-1][0] + 1 or spec):
                break                      # gap or speculation boundary
            run.append(self._pending.popleft())
            if seq % self._ckpt_window == 0:
                break
        return run

    # ------------------------------------------------------------------
    # speculative run machinery (lane thread)
    # ------------------------------------------------------------------
    def _publish_spec_locked(self,
                             run: List[Tuple[int, object, bool]]
                             ) -> _SpecRun:
        """Create + publish the _SpecRun for a just-popped speculative
        run. Caller holds the condition: the publication is atomic with
        the pop, so confirm() can never observe the slot in neither
        place (the window that wedged the lane on a racing commit)."""
        result = CompletedRun(first=run[0][0], last=run[-1][0],
                              n_requests=0)
        sp = _SpecRun(first=run[0][0], last=run[-1][0],
                      pps={s: pp for s, pp, _f in run},
                      digests={s: pp.digest() for s, pp, _f in run},
                      result=result, pages_wb=WriteBatch(),
                      executed_now=[], t_open=time.monotonic())
        self._spec = sp
        return sp

    def _stage_into_spec(self, sp: _SpecRun,
                         slots: List[Tuple[int, object]]) -> None:
        """Execute `slots` into the open speculative accumulation
        (opened here on the first batch). Nothing becomes durable; a
        failure aborts the whole speculation and requeues its slots."""
        from tpubft_torch.utils.tracing import get_tracer
        r = self._r
        blockchain = getattr(r.handler, "blockchain", None)
        if sp.span is None:
            sp.span = get_tracer().start_span("execute")
            sp.span.set_tag("r", r.id).set_tag("first", sp.first) \
                .set_tag("spec", True)
        self._run_seen = sp.seen          # one logical run across extends
        try:
            if not sp.acc:
                blockchain.begin_accumulation(speculative=True)
                sp.acc = True
            for seq, pp in slots:
                self._execute_slot(seq, pp, sp.pages_wb, sp.result,
                                   sp.executed_now)
                sp.result.last = seq
            if sp.result.last % self._ckpt_window == 0:
                # checkpoint boundary: precompute the state digest NOW,
                # inside the combine window, instead of at the seal.
                # Read-your-writes: the owner thread sees the overlay's
                # state and speculative head, which the seal commits
                # unchanged (the lane parks in between). res_pages
                # digest stays at the seal — pages_wb is not applied yet
                sp.ckpt_pre = (sp.result.last, r.handler.state_digest(),
                               getattr(blockchain, "last_block_id", None))
        except BaseException:  # noqa: BLE001 — discard + retry
            log.exception("speculative staging [%d..%d] failed; "
                          "overlay discarded", sp.first, sp.last)
            self._spec_failure(sp)

    def _spec_failure(self, sp: _SpecRun) -> None:
        """Staging raised: roll the accumulation back and requeue the
        run's slots — already-confirmed ones as committed entries (their
        commit certificates will not be re-announced), the rest still
        speculative (the dispatcher keeps confirming them)."""
        blockchain = getattr(self._r.handler, "blockchain", None)
        if sp.acc:
            try:
                blockchain.abort_accumulation()
            except Exception:  # noqa: BLE001 — already failing
                log.exception("abort_accumulation after staging failure")
        if sp.span is not None:
            sp.span.set_tag("error", True)
            sp.span.finish()
        with self._cond:
            if self._spec is sp:
                self._spec = None
            if not sp.abort:
                self._pending.extendleft(reversed(
                    [(s, sp.pps[s], s not in sp.confirmed)
                     for s in range(sp.first, sp.last + 1)]))
                self._retry_at = time.monotonic() + self.RETRY_DELAY_S
            self._cond.notify_all()

    def _abort_spec(self, sp: _SpecRun, cause: str) -> None:
        """Abort request honored (lane thread): discard the overlay.
        The dispatcher already rolled back its submission bookkeeping —
        the slots re-execute from their committed PrePrepares through
        the normal path once their certificates land."""
        blockchain = getattr(self._r.handler, "blockchain", None)
        if sp.acc:
            try:
                blockchain.abort_accumulation()
            except Exception:  # noqa: BLE001 — abort must not wedge stop
                log.exception("spec abort_accumulation failed")
        if sp.span is not None:
            sp.span.set_tag("aborted", cause)
            sp.span.finish()
        log.info("speculative run [%d..%d] aborted (%s): overlay "
                 "discarded, slots re-execute post-commit",
                 sp.first, sp.last, cause)
        with self._cond:
            if self._spec is sp:
                self._spec = None
            self._cond.notify_all()

    def _seal_spec_run(self, sp: _SpecRun) -> None:
        """Every slot's commit confirmed over the speculated digest:
        make the run durable. From here the path is byte-identical to a
        normal run's apply tail — replies and watermark advancement
        stay strictly post-commit."""
        overlap_ms = max(0.0, (sp.t_confirmed - sp.t_open) * 1e3)
        if sp.span is not None:
            sp.span.set_tag("run_len", sp.last - sp.first + 1)
        blockchain = getattr(self._r.handler, "blockchain", None)
        self._apply_run(sp.last - sp.first + 1, sp.result, sp.pages_wb,
                        sp.executed_now, blockchain, sp.acc, sp.span,
                        spec_overlap_ms=overlap_ms, ckpt_pre=sp.ckpt_pre)

    # ------------------------------------------------------------------
    # normal (committed) run execution
    # ------------------------------------------------------------------
    def _execute_run(self, run: List[Tuple[int, object]]) -> None:
        r = self._r
        from tpubft_torch.utils.tracing import get_tracer
        blockchain = getattr(r.handler, "blockchain", None)
        can_accumulate = (blockchain is not None
                          and hasattr(blockchain, "begin_accumulation"))
        pages_wb = WriteBatch()
        result = CompletedRun(first=run[0][0], last=run[-1][0],
                              n_requests=0)
        # ClientsManager updates deferred to AFTER the durable commit:
        # an aborted run retries, and the at-most-once state must not
        # claim requests whose staged effects were discarded. _run_seen
        # is the run-local dedup (a byzantine primary re-batching one
        # request into two of the run's slots).
        executed_now: List[Tuple[int, int, object]] = []
        self._run_seen = set()
        span = get_tracer().start_span("execute")
        span.set_tag("r", r.id).set_tag("first", result.first) \
            .set_tag("run_len", len(run))
        acc = False
        if can_accumulate:
            blockchain.begin_accumulation()
            acc = True
        try:
            for seq, pp in run:
                self._execute_slot(seq, pp, pages_wb, result,
                                   executed_now)
        except BaseException:
            if acc:
                blockchain.abort_accumulation()
            span.set_tag("error", True)
            span.finish()
            raise
        self._apply_run(len(run), result, pages_wb, executed_now,
                        blockchain, acc, span)

    def _apply_run(self, run_len: int, result: CompletedRun,
                   pages_wb: WriteBatch, executed_now, blockchain,
                   acc: bool, span,
                   spec_overlap_ms: Optional[float] = None,
                   ckpt_pre: Optional[Tuple[int, bytes,
                                            Optional[int]]] = None) -> None:
        """Coalesced apply: ONE ledger commit + ONE pages batch per run
        (a single atomic batch when they share a DB). Everything up to
        and including the LEDGER commit point is retriable
        (end_accumulation rolls the head back on failure); everything
        AFTER it is the point of no return — a post-commit exception
        must never requeue the run, or the retry would re-execute
        requests whose blocks are already committed (duplicate blocks,
        permanent state divergence).

        With the durability pipeline (ReplicaConfig.durability_pipeline,
        the default) the run's batch is SEALED, not written: the
        overlay moves into the pending store (still readable by every
        thread), the io thread group-commits it across runs with one
        fsync per group, and only then do replies, `last_executed` and
        the at-most-once cache advance — this thread never touches the
        disk and moves straight to the next run. Without the pipeline
        the legacy per-run write + immediate completion path runs
        byte-identically to before."""
        r = self._r
        pipe = getattr(r, "durability", None)
        if spec_overlap_ms is not None:
            # the speculative seal seam: a SIGKILL here — run fully
            # commit-confirmed, nothing yet durable — must replay the
            # committed suffix exactly once on recovery
            crashpoint("exec.spec_seal", rid=r.id)
        crashpoint("exec.pre_apply", rid=r.id)
        t0 = time.perf_counter()
        folded = False
        deferred = None                   # (run_no, batch, raw base db)
        if acc:
            folded = (pages_wb.ops
                      and r.res_pages.shares_db(
                          getattr(blockchain, "_base_db", None)))
            # deferral requires the WHOLE run to ride one deferred
            # batch: with reply pages in a SEPARATE store (not folded)
            # the pages write would land at seal while the ledger batch
            # waited in memory — a crash in that window persists
            # "request executed" without its block, and replay would
            # skip it forever. Fall back to the immediate apply there
            # (ledger first, pages second, same thread — the legacy
            # order); the seal below still groups the fsyncs.
            defer = (pipe is not None
                     and getattr(blockchain, "durability_attached", False)
                     and (folded or not pages_wb.ops))
            blockchain.end_accumulation(
                extra=pages_wb if folded else None, defer=defer)
            if defer:
                deferred = blockchain.take_deferred()
        try:
            if not folded:
                # without accumulation the handler's effects applied
                # irreversibly during execution, and with it the ledger
                # just committed — either way a pages failure here is
                # logged, never retried (in-memory at-most-once still
                # dedups; the at-risk window is a crash before the next
                # run persists the ring)
                try:
                    r.res_pages.write_batch(pages_wb)
                except Exception:  # noqa: BLE001
                    log.exception("run [%d..%d]: reply-pages batch "
                                  "failed post point-of-no-return",
                                  result.first, result.last)
            crashpoint("exec.post_apply", rid=r.id)
            commit_ms = (time.perf_counter() - t0) * 1e3
            # durable-apply flight events, one per slot (the `exec`
            # stage's end anchor; `reply` runs from here to the
            # dispatcher's integration). Sealed speculations also mark
            # each slot so the tracker folds its spec_overlap stage.
            for seq in range(result.first, result.last + 1):
                flight.record(flight.EV_EXEC_APPLY, seq=seq, arg=run_len)
                if spec_overlap_ms is not None:
                    flight.record(flight.EV_SPEC_SEAL, seq=seq,
                                  arg=run_len)
            # LEGACY path: the run is durable — NOW the at-most-once/
            # reply-cache records become visible (crash before this
            # point replays the suffix; the persisted ring deduplicates
            # it). With the pipeline that visibility moves to the io
            # thread, strictly AFTER the group's fsync.
            if pipe is None:
                for client, req_seq, reply in executed_now:
                    r.clients.on_request_executed(client, req_seq, reply)
            # checkpoint-boundary snapshot: digests taken now, before
            # the next run mutates state
            if result.last % self._ckpt_window == 0:
                try:
                    if ckpt_pre is not None and ckpt_pre[0] == result.last:
                        # digests rode the speculation (precomputed at
                        # staging while the combine was still in flight):
                        # the boundary no longer forces a synchronous
                        # state walk at the seal
                        _, state_digest, head = ckpt_pre
                    else:
                        state_digest = r.handler.state_digest()
                        # ledger height snapshotted WITH the digest
                        # (same thread, same boundary): resolves the
                        # certified digest to a block for the
                        # thin-replica anchor
                        head = getattr(blockchain, "last_block_id", None)
                    if r.state_transfer is not None:
                        r.state_transfer.on_checkpoint_created(
                            result.last, state_digest)
                    result.checkpoint = (result.last, state_digest,
                                         r.res_pages.digest(), head)
                except Exception:  # noqa: BLE001 — skip OUR checkpoint
                    # vote for this boundary; peers' quorum can still
                    # certify it, and re-executing the run would be
                    # strictly worse (duplicate blocks)
                    log.exception("checkpoint snapshot failed at %d",
                                  result.last)
            span.set_tag("commit_ms", round(commit_ms, 3))
            span.finish()
            r.record_exec_run(run_len, commit_ms)
            if spec_overlap_ms is not None:
                r.record_spec_seal(run_len, spec_overlap_ms)
        except Exception:  # noqa: BLE001 — the run is durable: a
            # post-commit bookkeeping failure must be SWALLOWED, never
            # reach _loop's requeue path (re-executing a committed run
            # appends duplicate blocks — permanent divergence)
            log.exception("post-commit bookkeeping failed for run "
                          "[%d..%d] (run still completes)",
                          result.first, result.last)
        finally:
            # the run IS committed no matter what the post-commit
            # bookkeeping did — hand it over: to the durability
            # pipeline (completion follows its group fsync) or, on the
            # legacy path, straight to the dispatcher
            if pipe is not None:
                from tpubft_torch.durability import SealedRun
                from tpubft_torch.kvbc.blockchain import raw_base
                sync_dbs = []
                if deferred is None and blockchain is not None:
                    # nothing deferred (empty batch, or a ledger
                    # without the accumulation bracket whose writes
                    # applied directly): the base still holds unsynced
                    # buffers the group fsync must land
                    db = raw_base(getattr(blockchain, "_db", None))
                    if db is not None:
                        sync_dbs.append(db)
                if not folded and pages_wb.ops:
                    pdb = raw_base(r.res_pages.db)
                    if not any(pdb is d for d in sync_dbs):
                        sync_dbs.append(pdb)
                run_no, batch, target = (deferred if deferred is not None
                                         else (None, None, None))
                # publish the in-flight dedup entries BEFORE the seal:
                # from the moment the pipeline owns the run, the next
                # run may execute — it must already see these
                with self._cond:
                    for client, req_seq, reply in executed_now:
                        self._inflight[(client, req_seq)] = reply
                pipe.seal(SealedRun(
                    run=result, executed_now=list(executed_now),
                    batch=batch, run_no=run_no, db=target,
                    sync_dbs=tuple(sync_dbs)))
            else:
                with self._cond:
                    self._completed.append(result)
                r.incoming.push_internal_once("exec_done")

    def _execute_slot(self, seq: int, pp, pages_wb: WriteBatch,
                      result: CompletedRun,
                      executed_now: List[Tuple[int, int, object]]) -> None:
        """One slot's requests, in order. Only plain / pre-processed
        client requests reach the lane (barrier batches run inline on
        the dispatcher)."""
        r = self._r
        seen = self._run_seen
        # batched reply signing (optimistic replies + durability
        # pipeline): per-reply scalar signs during execution serialize
        # ~100µs of comb math behind every request — defer them to the
        # io thread, which signs the sealed GROUP in one batch at its
        # fsync boundary (the reply cannot leave before that boundary
        # anyway, so the deferral adds zero client-visible latency)
        defer = getattr(r, "_opt_replies", False) \
            and getattr(r, "durability", None) is not None
        for req in pp.client_requests():
            client = req.sender_id
            key = (client, req.req_seq_num)
            # sealed-but-not-durable dedup (pipeline mode): the request
            # already executed in a run awaiting its group fsync — the
            # ClientsManager entry is deliberately not visible yet, but
            # executing again would append a duplicate block. Re-issue
            # the stashed reply with THIS run (it rides this run's own
            # durability gate). READ ORDER MATTERS: the io thread
            # publishes the ClientsManager entry BEFORE popping the
            # in-flight entry, so checking _inflight FIRST and the
            # manager second can never observe the uncovered
            # none-visible-yet window (checking the manager first
            # could: miss there, completion lands, miss here too).
            # GIL-atomic read; see _inflight.
            stashed = self._inflight.get(key)
            if stashed is not None:
                if defer and not stashed.signature:
                    # the stashed reply's own group has not signed it
                    # yet — route the re-issue through THIS run's batch
                    # sign instead of packing unsigned bytes (ed25519
                    # signing is deterministic, so a double sign from
                    # both groups lands identical bytes)
                    result.unsigned.append((client, stashed))
                else:
                    result.replies.append((client, stashed.pack()))
                continue
            if key in seen or r.clients.was_executed(client,
                                                     req.req_seq_num):
                cached = r.clients.cached_reply(client, req.req_seq_num)
                if cached is not None:
                    result.replies.append((client, cached.pack()))
                continue
            if r._slowdown.enabled:
                from tpubft_torch.testing.slowdown import PHASE_EXECUTE
                r._slowdown.delay(PHASE_EXECUTE)
            payload = r._execute_request(req, seq)
            result.n_requests += 1
            reply, wire = r._build_reply(client, req.req_seq_num,
                                         payload, pages_wb,
                                         defer_sign=defer)
            executed_now.append((client, req.req_seq_num, reply))
            seen.add(key)
            result.reply_keys.append(key)
            if wire is not None:
                result.replies.append((client, wire))
            elif defer and not r.info.is_internal_client(client):
                result.unsigned.append((client, reply))
        if r.cfg.time_service_enabled and pp.time:
            # agreed-time page writes must stay seq-ordered with the
            # reply pages for checkpoint digest determinism
            r.time_service.on_executed(pp.time)
