"""DurabilityPipeline — group-commit fsync off the execution lane (a copy
of tpubft/durability/pipeline.py).

Every `bench_e2e` round since the execution lane landed records the
shared disk's nonstationary fsync (2-21ms probed) as the dominant
run-to-run variance source, and each coalesced run still paid one full
durable apply on the write path. This module decouples durability from
execution the way group-commit databases do:

  * the execution lane finishes a run's staging, hands the sealed
    WriteBatch (ledger + folded reply pages) plus the run's completion
    record to `seal()`, and moves straight on to the next run — it
    never touches the disk again;
  * sealed-but-not-yet-applied writes stay readable through the
    `PendingStore` overlay the blockchain's read path consults
    (point gets AND merged range scans), so execution, proofs, digests
    and read-only queries observe the logical head, not the disk's;
  * a dedicated io thread drains the seal queue and group-commits
    ACROSS runs: up to `group_max` runs (or whatever sealed inside
    `window_us` of the group's first run) apply as ONE concatenated
    group write (`IDBClient.write_group` — one engine record on
    NativeDB) followed by ONE `sync()` per distinct DB;
  * after the group's fsync the pipeline publishes a monotone
    **durability watermark** and only then makes each run visible to
    the dispatcher (reply send, `last_executed` advance) and the
    at-most-once reply cache — a reply can never precede its group's
    fsync.

The consensus-metadata family carve-out (`CONSENSUS_META_FAMILIES`,
`sync_families` in storage/native.py) is untouched: those batches stay
synchronous on the dispatcher — losing a vote is a safety hazard,
losing a tail of re-derivable blocks is not. Checkpoint-stable, view
change, ST adoption and wedge paths drain the pipeline first
(`Replica._drain_exec_lane` extends the lane's own barrier), and the
`dur.group_fsync` crashpoint sits between the group's apply and its
fsync — the widest crash window the exactly-once replay drills must
cover (group maybe-applied, never acknowledged).

`group_max=1` degenerates to the per-run durable apply (one batch, one
fsync per run) — the A/B control `bench_e2e --durability-off` pairs
against.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from tpubft_torch.storage.interfaces import WriteBatch
from tpubft_torch.testing.crashpoints import crashpoint
from tpubft_torch.utils import flight
from tpubft_torch.utils.logging import get_logger
from tpubft_torch.utils.metrics import Component
from tpubft_torch.utils.racecheck import get_watchdog, make_lock

log = get_logger("durability")


class PendingStore:
    """Sealed-but-not-yet-applied write overlay.

    Physical key -> (run_no, value-or-None) for every op of every
    sealed batch the io thread has not applied yet. The blockchain's
    permanently-installed `_PendingView` consults it on every point get
    and merges it into every range scan, so readers on ANY thread see
    sealed state exactly as if the batch had been applied — the only
    thing deferred is the disk.

    Mutations: `stage` (execution lane, inside the accumulation
    bracket) and `mark_applied` (io thread, or the lane's barrier
    paths) — both under the store lock. `lookup`/`snapshot_range` are
    safe from any thread.
    """

    def __init__(self, name: str = "dur") -> None:
        self._mu = make_lock(f"{name}.pending")
        self._cond = threading.Condition(self._mu)
        self._d: Dict[bytes, Tuple[int, Optional[bytes]]] = {}
        self._staged_no = 0

    # ---- staging (execution lane) ----
    def stage(self, overlay: Dict[bytes, Optional[bytes]]) -> int:
        """Adopt one sealed run's overlay (physical key -> value-or-
        None); returns the run's pending ticket number. Later runs
        overwrite earlier runs' entries for the same key — last writer
        wins, exactly like the applies they stand in for."""
        with self._cond:
            self._staged_no += 1
            no = self._staged_no
            for k, v in overlay.items():
                self._d[k] = (no, v)
            return no

    # ---- application (io thread / barrier paths) ----
    def mark_applied(self, run_no: int, batch: WriteBatch) -> None:
        """The batch for ticket `run_no` reached the base DB: drop its
        keys from the overlay UNLESS a later run overwrote them (the
        later value must stay visible until ITS apply lands)."""
        with self._cond:
            for k, _v in batch.ops:
                ent = self._d.get(k)
                if ent is not None and ent[0] <= run_no:
                    del self._d[k]
            self._cond.notify_all()

    def wait_empty(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._d:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(remaining, 0.2))
        return True

    @property
    def empty(self) -> bool:
        return not self._d

    @property
    def depth(self) -> int:
        return len(self._d)

    # ---- read side (any thread) ----
    def lookup(self, physical_key: bytes
               ) -> Optional[Tuple[int, Optional[bytes]]]:
        """(run_no, value-or-None) or None when the key is not pending.
        Lock-free: a dict point read is GIL-atomic and the value tuple
        is immutable — a racy miss just falls through to the base,
        which is where the key is headed anyway."""
        return self._d.get(physical_key)

    def snapshot_range(self, lo: bytes, hi: Optional[bytes]
                       ) -> List[Tuple[bytes, Optional[bytes]]]:
        """Sorted (physical_key, value-or-None) snapshot of the pending
        keys in [lo, hi) — merged into `_PendingView.range_iter` so
        range readers (versioned reads, pages digests, ST summaries)
        see sealed state too. The overlay is bounded by the seal
        queue, so the scan is small."""
        with self._cond:
            items = [(k, v[1]) for k, v in self._d.items()
                     if k >= lo and (hi is None or k < hi)]
        items.sort()
        return items


@dataclass
class SealedRun:
    """One durably-pending execution run, exactly as the lane sealed it.

    `batch`/`run_no` carry the deferred ledger(+folded pages) write
    (None when the handler applied irreversibly during execution — the
    run is then a sync-only ticket). `sync_dbs` are the stores whose
    dirty buffers the group fsync must land; `executed_now` is the
    at-most-once visibility the dispatcher's reply cache gains only
    after the fsync."""
    run: object                              # execution.CompletedRun
    executed_now: List[Tuple[int, int, object]]
    batch: Optional[WriteBatch] = None
    run_no: Optional[int] = None
    db: Optional[object] = None              # target of `batch`
    sync_dbs: Tuple = ()
    sealed_mono: float = field(default_factory=time.monotonic)


class DurabilityPipeline:
    """The io thread + the lane->dispatcher durability handoff.

    Lane-side API: seal / watermark / drain / flush / hold / release.
    The io thread owns every disk touch: group apply (write_group),
    group fsync (sync), watermark publication, and the post-durability
    completion (reply-cache visibility + the lane's completed queue +
    the dispatcher wakeup)."""

    RETRY_DELAY_S = 0.5                      # backoff after a failed group

    def __init__(self, replica, group_max: int = 8,
                 window_us: int = 1000) -> None:
        self._r = replica
        self._mu = make_lock("dur.pipeline")
        self._cond = threading.Condition(self._mu)
        self._queue: List[SealedRun] = []
        self._queue_max = max(8, int(group_max) * 4)
        self._group_max = max(1, int(group_max))
        self._window_us = max(0, int(window_us))
        self._busy = False                   # a group is mid-apply/fsync
        self._held = False                   # test hook: freeze the io lane
        self._flush = False                  # cut the window now
        self._retry_at = 0.0
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._name = f"dur-{replica.id}"
        self.pending = PendingStore(self._name)
        # monotone durability watermark: highest seq whose group fsync
        # landed. Reads are lock-free (int attribute); the io thread is
        # the only writer.
        self.watermark = int(getattr(replica, "last_executed", 0))
        self._sealed_head = self.watermark   # highest seq sealed so far

        agg = getattr(replica, "aggregator", None)
        self.metrics = Component("durability", agg)
        self.m_groups = self.metrics.register_counter("dur_groups")
        self.m_runs = self.metrics.register_counter("dur_runs")
        self.m_fsyncs = self.metrics.register_counter("dur_fsyncs")
        self.m_fsync_us = self.metrics.register_counter("dur_fsync_us")
        self.m_wm = self.metrics.register_gauge("dur_wm")
        self.m_wm_lag = self.metrics.register_gauge("dur_wm_lag")
        self.m_retries = self.metrics.register_counter("dur_retries")
        # replies signed through the group-boundary batched sign
        # (optimistic replies: execution defers per-reply signatures to
        # one sign_batch per committed group)
        self.m_signed = self.metrics.register_counter(
            "dur_replies_signed")
        from tpubft_torch.diagnostics import get_registrar
        diag = get_registrar()
        self._h_group_len = diag.histogram(
            f"replica{replica.id}.dur_group_len", unit="runs")
        self._h_fsync_ms = diag.histogram(
            f"replica{replica.id}.dur_fsync_ms")

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
        """Clean stop flushes: the io thread drains whatever is sealed
        (apply + fsync + complete) before exiting — a clean shutdown
        should leave the disk at the logical head. A wedged disk bounds
        the wait at the join timeout; whatever did not land is exactly
        the crash case recovery already replays."""
        with self._cond:
            self._running = False
            self._flush = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        get_watchdog().unregister(self._name)

    # ------------------------------------------------------------------
    # autotuner actuators
    # ------------------------------------------------------------------
    def set_group_max(self, n: int) -> None:
        with self._cond:
            self._group_max = max(1, int(n))
            self._queue_max = max(8, self._group_max * 4)
            self._cond.notify_all()

    def set_window_us(self, us: int) -> None:
        with self._cond:
            self._window_us = max(0, int(us))
            self._cond.notify_all()

    @property
    def group_max(self) -> int:
        return self._group_max

    @property
    def window_us(self) -> int:
        return self._window_us

    # ------------------------------------------------------------------
    # lane-side API
    # ------------------------------------------------------------------
    def seal(self, sealed: SealedRun) -> None:
        """Hand one finished run to the io thread (execution lane). A
        full queue blocks the lane — natural backpressure: execution
        must not outrun durability without bound. Stop-racing seals
        enqueue anyway (crash-equivalent: they simply never fsync)."""
        with self._cond:
            while self._running and len(self._queue) >= self._queue_max:
                self._cond.wait(0.2)
            self._queue.append(sealed)
            if sealed.run.last > self._sealed_head:
                self._sealed_head = sealed.run.last
            self._cond.notify_all()
        self.m_wm_lag.set(max(0, self._sealed_head - self.watermark))

    def flush(self) -> None:
        """Cut the group window now — the next group forms from
        whatever is sealed, without waiting out `window_us`."""
        with self._cond:
            self._flush = True
            self._cond.notify_all()

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until everything sealed so far is durable (queue empty,
        no group in flight) — the barrier checkpoint-stable, view
        change, ST adoption and wedge paths take after draining the
        lane. Returns False on timeout."""
        deadline = time.monotonic() + timeout
        with self._cond:
            self._flush = True
            self._cond.notify_all()
            while self._queue or self._busy:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(remaining, 0.2))
            # drained: clear the flush request — a stale flag would
            # make the NEXT sealed run commit as an unamortized group
            # of one, silently discarding the window once per barrier
            self._flush = False
        return True

    def idle(self) -> bool:
        with self._cond:
            return not self._queue and not self._busy

    @property
    def lag(self) -> int:
        """Sealed-but-not-yet-durable runs (the health probe's busy
        signal and the `dur_wm_lag` sensor's queue form)."""
        with self._cond:
            return len(self._queue) + (1 if self._busy else 0)

    # test hooks: freeze the io thread BEFORE it forms the next group,
    # so reply-gating tests can hold runs executed-but-not-durable
    def hold(self) -> None:
        with self._cond:
            self._held = True

    def release(self) -> None:
        with self._cond:
            self._held = False
            self._cond.notify_all()

    # ------------------------------------------------------------------
    # io thread
    # ------------------------------------------------------------------
    def _take_group_locked(self) -> List[SealedRun]:
        return [self._queue.pop(0)
                for _ in range(min(self._group_max, len(self._queue)))]

    def _lane_quiet(self) -> bool:
        """True when no further seal can be in flight (the lane is
        idle): holding a partial group open would only delay its
        replies — cut the window early. A missing/opaque lane reads as
        busy, preserving the window semantics."""
        lane = getattr(self._r, "exec_lane", None)
        idle = getattr(lane, "idle", None)
        if not callable(idle):
            return False
        try:
            return bool(idle())
        except Exception:  # noqa: BLE001 — window semantics win
            return False

    def _loop(self) -> None:
        watchdog = get_watchdog()
        flight.set_thread_rid(self._r.id)
        health = getattr(self._r, "health", None)
        while True:
            watchdog.beat(self._name)
            group: List[SealedRun] = []
            with self._cond:
                while True:
                    now = time.monotonic()
                    if self._queue and not self._held \
                            and now >= self._retry_at:
                        deadline = (self._queue[0].sealed_mono
                                    + self._window_us / 1e6)
                        if (len(self._queue) >= self._group_max
                                or now >= deadline or self._flush
                                or not self._running
                                or self._lane_quiet()):
                            self._flush = False
                            group = self._take_group_locked()
                            self._busy = True
                            break
                        wait = min(deadline - now, 0.2)
                    elif not self._running and (not self._queue
                                                or self._held):
                        # stop: a held pipeline exits without touching
                        # the disk (the crash analog the drills park)
                        return
                    else:
                        wait = 0.2
                        if health is not None and not self._queue:
                            health.beat("durability")
                    self._cond.wait(wait)
                    watchdog.beat(self._name)
            try:
                self._commit_group(group)
                if health is not None:
                    health.beat("durability")
            except Exception:  # noqa: BLE001 — the runs are committed
                # state: durability MUST eventually land (or the health
                # plane reports the stall); requeue the whole group at
                # the head and retry — never drop, never complete
                log.exception("group commit failed (%d runs); retrying",
                              len(group))
                self.m_retries.inc()
                with self._cond:
                    self._queue[:0] = group
                    self._retry_at = time.monotonic() + self.RETRY_DELAY_S
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()
            if not self._running:
                with self._cond:
                    if not self._queue:
                        return

    def _sign_group_replies(self, group: List[SealedRun]) -> None:
        """Optimistic-reply signatures, one batched sign per committed
        group: execution built the group's external replies UNSIGNED
        (CompletedRun.unsigned) — here the io thread signs them all in ONE SigManager.sign_batch
        (the self-hosted engine amortizes the per-signature field
        inversion across the batch; scalar.ed25519_sign_batch), stamps
        the signatures, and appends the packed wire bytes to each run's
        reply list so the group burst below carries them. Runs behind
        the group fsync the reply send already waits on, so the
        deferral costs zero client-visible latency. `device_section`
        brackets the sign so the kernel profiler grows an
        `ed25519.sign` row the RESULTS profile and future autotuner
        policies can read. A sign failure is swallowed per group —
        replies are best-effort (the client retries; the durable state
        is untouched) — and never reaches the _loop retry, which would
        re-apply committed batches."""
        r = self._r
        pending: List[Tuple[object, int, object]] = []
        for s in group:
            unsigned = getattr(s.run, "unsigned", None)
            if unsigned:
                pending.extend((s.run, client, reply)
                               for client, reply in unsigned)
                s.run.unsigned = []
        if not pending:
            return
        try:
            from tpubft_torch.ops.dispatch import device_section
            with device_section("ed25519.sign", batch=len(pending)):
                sigs = r.sig.sign_batch(
                    [reply.signed_payload() for _, _, reply in pending])
            for (run, client, reply), sig in zip(pending, sigs):
                reply.signature = sig
                run.replies.append((client, reply.pack()))
            self.m_signed.inc(len(pending))
        except Exception:  # noqa: BLE001 — see docstring
            log.exception("group reply signing failed (%d replies "
                          "dropped from the burst)", len(pending))

    def _commit_group(self, group: List[SealedRun]) -> None:
        """ONE group: concatenated apply per target DB, the
        `dur.group_fsync` seam, one fsync per distinct DB, watermark
        publication, then per-run completion."""
        r = self._r
        # 1. apply deferred batches, in seal order, one write_group per
        # distinct DB (one concatenated engine record on NativeDB)
        per_db: List[Tuple[object, List[SealedRun]]] = []
        for s in group:
            if s.batch is None or s.db is None or not s.batch.ops:
                continue
            if per_db and per_db[-1][0] is s.db:
                per_db[-1][1].append(s)
            else:
                per_db.append((s.db, [s]))
        for db, seals in per_db:
            db.write_group([s.batch for s in seals])
            for s in seals:
                self.pending.mark_applied(s.run_no, s.batch)
        # 2. the crash seam: group applied (maybe durable, maybe not —
        # the OS owns the buffers), watermark NOT yet published, no
        # reply sent. A kill here must replay the suffix exactly once.
        crashpoint("dur.group_fsync", rid=r.id)
        # 3. one fsync per distinct store
        t0 = time.perf_counter()
        synced = []
        n_syncs = 0
        for s in group:
            for db in (s.db,) + tuple(s.sync_dbs):
                if db is None or any(db is d for d in synced):
                    continue
                # sync_writes-mode stores fsynced the group apply
                # already — one boundary per group, never two
                if not getattr(db, "syncs_on_write", False):
                    db.sync()
                    n_syncs += 1
                synced.append(db)
        fsync_ms = (time.perf_counter() - t0) * 1e3
        # 4. publish: watermark first (monotone, single-writer), then
        # the per-run completions the dispatcher integrates
        wm = max((s.run.last for s in group), default=self.watermark)
        if wm > self.watermark:
            self.watermark = wm
        flight.record(flight.EV_DUR_GROUP, seq=wm, arg=len(group))
        self.m_groups.inc()
        self.m_runs.inc(len(group))
        self.m_fsyncs.inc(n_syncs)
        self.m_fsync_us.inc(int(fsync_ms * 1000))
        self.m_wm.set(self.watermark)
        self.m_wm_lag.set(max(0, self._sealed_head - self.watermark))
        self._h_group_len.record(len(group))
        self._h_fsync_ms.record(fsync_ms)
        # 5. completion — the group IS durable from here: a bookkeeping
        # failure must be swallowed per run, never reach the _loop retry
        # (requeueing a completed run would re-apply its batch and hand
        # it to the dispatcher twice — duplicate replies, double
        # checkpoint votes). Same discipline as the lane's post-commit
        # swallow.
        lane = getattr(r, "exec_lane", None)
        # batched reply signing: the whole group's deferred
        # reply signatures in ONE sign_batch, BEFORE the reply cache
        # publishes the reply objects (a retransmit answered from the
        # cache must never see an unsigned reply)
        self._sign_group_replies(group)
        burst: List[Tuple[int, bytes]] = []
        for s in group:
            try:
                # at-most-once/reply-cache visibility strictly AFTER
                # the fsync: a retransmit must never be answered from a
                # cache entry whose run could still be lost
                for client, req_seq, reply in s.executed_now:
                    r.clients.on_request_executed(client, req_seq, reply)
            except Exception:  # noqa: BLE001 — see above
                log.exception("post-durability reply-cache publish "
                              "failed for run [%d..%d]",
                              s.run.first, s.run.last)
            # group reply release: collect the whole
            # committed group's replies into ONE transport burst —
            # per-run sends from the dispatcher paid a syscall per
            # datagram per run even when a group committed many runs at
            # one fsync boundary. The flag must be set BEFORE
            # complete_durable hands the run over (the lane's lock gives
            # the happens-before), or the dispatcher double-sends.
            burst.extend(getattr(s.run, "replies", ()))
            s.run.replies_sent = True
        comm = getattr(r, "comm", None)
        if burst and comm is not None:
            try:
                comm.send_burst(burst)
            except Exception:  # noqa: BLE001 — replies are best-effort;
                log.exception("group reply burst failed "  # retransmits
                              "(%d replies)", len(burst))  # recover
        for s in group:
            if lane is not None:
                try:
                    lane.complete_durable(s.run)
                except Exception:  # noqa: BLE001 — see above
                    log.exception("completion handoff failed for run "
                                  "[%d..%d]", s.run.first, s.run.last)
        try:
            r.incoming.push_internal_once("exec_done")
        except Exception:  # noqa: BLE001 — the dispatcher's timers
            log.exception("exec_done wakeup failed")  # re-pump anyway

    # ------------------------------------------------------------------
    # telemetry surfaces
    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """Monotone counters for the autotuner's per-interval deltas."""
        return {"dur_groups": self.m_groups.value,
                "dur_runs": self.m_runs.value,
                "dur_fsync_us": self.m_fsync_us.value}

    def state(self) -> Dict:
        with self._cond:
            depth = len(self._queue)
            busy = self._busy
            held = self._held
        return {"watermark": self.watermark,
                "sealed_head": self._sealed_head,
                "queue_depth": depth, "in_flight": busy, "held": held,
                "group_max": self._group_max,
                "window_us": self._window_us,
                "groups": self.m_groups.value,
                "runs": self.m_runs.value,
                "fsyncs": self.m_fsyncs.value,
                "fsync_us_total": self.m_fsync_us.value,
                "retries": self.m_retries.value,
                "pending_keys": self.pending.depth}

    def render(self) -> str:
        """`status get durability` payload."""
        return json.dumps(self.state(), sort_keys=True)
