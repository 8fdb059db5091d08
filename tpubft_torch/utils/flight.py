"""Consensus flight recorder — always-on, low-overhead slot telemetry.

The reference ships per-stage histograms (diagnostics.h /
performance_handler.h) and span contexts riding every message; our
spans can say *that* a slot was slow but not *where*. This module is
the missing substrate: every hot seam emits a fixed-size event

    (monotonic_ns, event_code, seq, view, arg)

into a bounded ring owned by the EMITTING thread — the ring write
itself takes no lock, no formatting, no allocation beyond one tuple —
so the recorder can stay on in production and its tail is always
available when something goes wrong (an aircraft flight recorder, not
a profiler you remember to attach after the crash). The ~8
slot-lifecycle events per consensus SLOT (not per message) additionally
fold through the shared SlotTracker under its lock: contention there is
bounded by slot rate, which is orders of magnitude below message rate.

Three consumers fold the rings:

  * ``SlotTracker`` — folds slot-stage events into per-seq timings
    (adm_wait / dispatch / prepare / commit / exec / reply), feeding
    the diagnostics histograms (``slot.<stage>``) and
    ``status get slots``;
  * ``KernelProfiler`` — per-kernel call count, batch-size stats, wall
    time and the first-call compile-warmup split, recorded by
    ``ops.dispatch.device_section`` and served as
    ``status get kernels``;
  * the dump plane — ``status get flight`` on demand, plus
    ``dump(reason)`` JSON artifacts (rings + kernel profile + slot
    summary + lock hold stats) written automatically on every
    stalled/degraded health transition (consensus/health.py) and on
    chaos-campaign red verdicts (testing/campaign.py); offline,
    ``tools/tpuprof.py`` merges per-replica dumps into a slot timeline.

Knobs (environment — read once at import, like TPUBFT_THREADCHECK):

  * ``TPUBFT_FLIGHT=0``      compiles the recorder out: ``record``
    becomes a bound no-op, every seam pays one global lookup + call;
  * ``TPUBFT_FLIGHT_RING``   events kept per thread (default 4096);
  * ``TPUBFT_FLIGHT_DIR``    dump-artifact directory (default
    ``<tmp>/tpubft-flight``).

Thread identity: rings carry the emitting thread's name as its role
plus a replica id seeded by ``set_thread_rid`` (the dispatcher,
execution lane, and admission workers seed theirs at loop entry), so
multi-replica processes (the in-process test cluster) stay separable.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Tuple

from tpubft_torch.utils.racecheck import make_lock

# ---------------------------------------------------------------------
# event catalog (docs/OPERATIONS.md "Telemetry, flight recorder &
# profiling" mirrors this table — update both)
# ---------------------------------------------------------------------
EV_ADM_INGEST = 1       # admission ingest (transport thread; arg=burst)
EV_ADM_DRAIN = 2        # admission drain cycle begins (arg=batch size)
EV_ADM_ADMIT = 3        # PrePrepare admitted to the dispatcher queue
EV_DISPATCH = 4         # dispatcher handler entry (arg=msg code)
EV_CLIENT_REQ = 5       # client request reached the dispatcher
EV_PP_DISPATCH = 6      # PrePrepare handler entry (dispatcher)
EV_PP_ACCEPT = 7        # PrePrepare accepted into the window
EV_PREPARED = 8         # prepare quorum (PrepareFull accepted)
EV_COMMITTED = 9        # commit quorum (arg: 0=slow, 1=fast)
EV_EXEC_ENQ = 10        # committed slot handed to the execution lane
EV_EXEC_APPLY = 11      # durable apply (lane thread; arg=run length)
EV_REPLY = 12           # slot integrated + replies sent (dispatcher)
EV_DEV_ENTER = 13       # device_section entry (view=kind id, arg=batch)
EV_DEV_EXIT = 14        # device_section exit (view=kind id, arg=us)
EV_HEALTH = 15          # health verdict transition (arg=verdict id)
EV_SPEC_ENQ = 16        # slot handed to the lane SPECULATIVELY
EV_SPEC_SEAL = 17       # speculative run sealed at commit (arg=run len)
EV_SPEC_ABORT = 18      # speculation aborted; slot re-executes committed
EV_COMBINE_FLUSH = 19   # fused combine flush (batcher; arg=slots drained)
# thin-replica read tier (serving-plane events; seq carries a BLOCK id,
# not a consensus seqnum — the read path has no slot)
EV_TRS_SUBSCRIBE = 20   # subscription accepted (seq=start block)
EV_TRS_PUSH = 21        # sealed run published to subscribers
#                         (seq=last block of the run; arg=blocks in run)
EV_TRS_PROOF = 22       # merkle proof served (seq=block; arg=category id)
# pre-execution plane (seq carries the client req_seq_num)
EV_PREEXEC_LAUNCH = 23  # speculative execution launched (arg=retry id)
EV_PREEXEC_AGREE = 24   # f+1 digest agreement reached (arg=votes)
EV_PREEXEC_CONFLICT = 25  # read-set conflict at commit; fell back to
#                           normal ordering (seq=consensus slot)
EV_TUNE = 26            # autotuner knob change (seq=knob id,
#                         view=old value, arg=new value; the knob-id →
#                         name table rides every dump via the tuning
#                         dump provider)
EV_DUR_GROUP = 27       # durability group committed (io thread;
#                         seq=new watermark, arg=runs in the group —
#                         one event per group fsync)
EV_AGG_FORWARD = 28     # aggregation overlay: interior node flushed a
#                         partial aggregate to its parent (dispatcher;
#                         seq/view=slot, arg=contributor count)
EV_AGG_ROOT = 29        # aggregation overlay: root absorbed a partial
#                         into the slot's ShareCollector (dispatcher;
#                         arg=contributor count)
EV_AGG_FALLBACK = 30    # aggregation overlay: parent timeout fired —
#                         share re-sent DIRECT to the collector
#                         (dispatcher; arg=share kind 0=prep/1=commit)
# optimistic reply plane (ReplicaConfig.optimistic_replies)
EV_OPT_REPLY = 31       # slot released to the reply pipeline on a
#                         structurally-bound commit cert BEFORE its
#                         pairing check (dispatcher; arg=0 slow/1 fast)
EV_CERT_ASYNC_DONE = 32  # deferred combined-cert check landed for an
#                          optimistically-released slot (dispatcher)
EV_CERT_ASYNC_LAG = 33  # lag sample for the deferred combine tail:
#                         optimistic release -> verified cert
#                         (dispatcher; arg=lag in µs — feeds the
#                         slot.cert_lag overlay stage)
# verified crypto-offload tier (tpubft/offload/ — helpers are
# non-voting and never trusted; every event rides the leasing thread)
EV_OFF_LEASE = 34       # lease issued to a helper (arg=items in the
#                         lease, view=kind id)
EV_OFF_VERIFIED = 35    # helper result passed the on-replica 2G2T
#                         soundness check (arg=soundness-check µs)
EV_OFF_REJECTED = 36    # helper result FAILED the soundness check or
#                         arrived malformed/stale — the lease re-ran
#                         locally (arg=helper ordinal)
EV_OFF_EVICT = 37       # helper evicted (arg: 0=sick/timeout,
#                         1=byzantine quarantine — no auto re-admission)

EV_NAMES = {
    EV_ADM_INGEST: "adm_ingest", EV_ADM_DRAIN: "adm_drain",
    EV_ADM_ADMIT: "adm_admit", EV_DISPATCH: "dispatch",
    EV_CLIENT_REQ: "client_req", EV_PP_DISPATCH: "pp_dispatch",
    EV_PP_ACCEPT: "pp_accept", EV_PREPARED: "prepared",
    EV_COMMITTED: "committed", EV_EXEC_ENQ: "exec_enq",
    EV_EXEC_APPLY: "exec_apply", EV_REPLY: "reply",
    EV_DEV_ENTER: "dev_enter", EV_DEV_EXIT: "dev_exit",
    EV_HEALTH: "health", EV_SPEC_ENQ: "spec_enqueue",
    EV_SPEC_SEAL: "spec_seal", EV_SPEC_ABORT: "spec_abort",
    EV_COMBINE_FLUSH: "combine_flush",
    EV_TRS_SUBSCRIBE: "trs_subscribe", EV_TRS_PUSH: "trs_push",
    EV_TRS_PROOF: "trs_proof", EV_PREEXEC_LAUNCH: "preexec_launch",
    EV_PREEXEC_AGREE: "preexec_agree",
    EV_PREEXEC_CONFLICT: "preexec_conflict", EV_TUNE: "tune",
    EV_DUR_GROUP: "dur_group", EV_AGG_FORWARD: "agg_forward",
    EV_AGG_ROOT: "agg_root", EV_AGG_FALLBACK: "agg_fallback",
    EV_OPT_REPLY: "opt_reply", EV_CERT_ASYNC_DONE: "cert_async_done",
    EV_CERT_ASYNC_LAG: "cert_async_lag",
    EV_OFF_LEASE: "lease_issued", EV_OFF_VERIFIED: "lease_verified",
    EV_OFF_REJECTED: "lease_rejected", EV_OFF_EVICT: "helper_evicted",
}

# events the slot tracker folds inline (everything else is ring-only)
_SLOT_CODES = frozenset((EV_ADM_ADMIT, EV_PP_DISPATCH, EV_PP_ACCEPT,
                         EV_PREPARED, EV_COMMITTED, EV_EXEC_ENQ,
                         EV_EXEC_APPLY, EV_REPLY, EV_SPEC_ENQ,
                         EV_SPEC_SEAL, EV_SPEC_ABORT,
                         EV_CERT_ASYNC_LAG))

# the six PIPELINE stages partition a slot's lifetime (they sum to the
# slot total); spec_overlap is an OVERLAY — the slice of the commit
# window reclaimed by speculative execution — and is excluded from the
# total (it runs concurrently with `commit`, > 0 only on slots whose
# speculative run actually sealed). cert_lag is the second overlay:
# optimistic release -> verified certificate, the deferred-combine tail
# that runs AFTER the client already has its reply (> 0 only under
# ReplicaConfig.optimistic_replies; fed by EV_CERT_ASYNC_LAG samples,
# which usually land after the slot finalized on EV_REPLY — so it is
# tracked as a sample stream, never part of a slot's total)
PIPELINE_STAGES = ("adm_wait", "dispatch", "prepare", "commit", "exec",
                   "reply")
STAGES = PIPELINE_STAGES + ("spec_overlap", "cert_lag")

RING_SIZE = max(64, int(os.environ.get("TPUBFT_FLIGHT_RING", "4096")
                        or 4096))


def _default_dump_dir() -> str:
    return os.environ.get(
        "TPUBFT_FLIGHT_DIR",
        os.path.join(tempfile.gettempdir(), "tpubft-flight"))


_dump_dir = _default_dump_dir()
_dump_counter = 0
_dump_mu = make_lock("flight.dump")


# ---------------------------------------------------------------------
# per-thread rings
# ---------------------------------------------------------------------
class _Ring:
    """Bounded event ring owned by exactly one thread: writes are
    lock-free (the registry lock is taken once, at creation). Readers
    (snapshot/dump) take a racy copy — a torn read costs at most one
    half-written slot of telemetry, never correctness."""

    __slots__ = ("buf", "idx", "role", "rid", "thread_ref")

    def __init__(self, role: str, rid: int) -> None:
        self.buf: List[Optional[Tuple]] = [None] * RING_SIZE
        self.idx = 0
        self.role = role
        self.rid = rid
        # weakref, not ident: thread idents are recycled, so an
        # ident-based liveness check would keep dead rings looking
        # alive forever under thread churn
        self.thread_ref = weakref.ref(threading.current_thread())

    def owner_alive(self) -> bool:
        t = self.thread_ref()
        return t is not None and t.is_alive()

    def events(self) -> List[Tuple]:
        """Oldest-to-newest copy (racy; see class docstring)."""
        i = self.idx
        out = [e for e in self.buf[i:] + self.buf[:i] if e is not None]
        return out


_tl = threading.local()
_rings_mu = make_lock("flight.rings")
_rings: List[_Ring] = []

# dead-thread rings are RETAINED (their tail is exactly the evidence a
# post-mortem dump wants) but bounded: beyond this many, the oldest
# dead rings are dropped at the next ring registration, so
# thread-churning processes (test clusters, chaos campaigns) don't
# accumulate one ring per thread that ever lived
DEAD_RING_KEEP = 32


def _prune_dead_locked() -> None:
    dead = [r for r in _rings if not r.owner_alive()]
    for r in dead[:max(0, len(dead) - DEAD_RING_KEEP)]:
        _rings.remove(r)


def set_thread_rid(rid: int) -> None:
    """Seed the calling thread's replica id (dispatcher / exec lane /
    admission loops call this at entry) so multi-replica processes
    attribute events correctly."""
    _tl.rid = rid
    ring = getattr(_tl, "ring", None)
    if ring is not None:
        ring.rid = rid


def _ring() -> _Ring:
    ring = getattr(_tl, "ring", None)
    if ring is None:
        ring = _Ring(threading.current_thread().name,
                     getattr(_tl, "rid", -1))
        _tl.ring = ring
        with _rings_mu:
            _rings.append(ring)
            _prune_dead_locked()      # rare path: once per new thread
    return ring


def _record(code: int, seq: int = 0, view: int = 0, arg: int = 0) -> None:
    ring = _ring()
    t = time.monotonic_ns()
    ring.buf[ring.idx] = (t, code, seq, view, arg)
    ring.idx = (ring.idx + 1) % RING_SIZE
    if code in _SLOT_CODES:
        _tracker.on_event(ring.rid, code, seq, view, arg, t)


def _record_off(code: int, seq: int = 0, view: int = 0,
                arg: int = 0) -> None:
    return None


ENABLED = os.environ.get("TPUBFT_FLIGHT", "1") not in ("", "0")
# the ONE hot-path entry point: callers use `flight.record(...)` (a
# module-attribute lookup) so enable/disable swaps take effect
record = _record if ENABLED else _record_off


def enabled() -> bool:
    return record is _record


def _set_enabled(on: bool) -> None:
    """Test hook (the production compile-out is TPUBFT_FLIGHT=0 at
    process start)."""
    global record
    record = _record if on else _record_off


def configure(dump_dir: Optional[str] = None) -> None:
    global _dump_dir
    if dump_dir is not None:
        _dump_dir = dump_dir


# ---------------------------------------------------------------------
# slot lifecycle tracker
# ---------------------------------------------------------------------
class SlotTracker:
    """Folds slot-stage events into per-(replica, seq) stage timings.

    Stage boundaries (ns timestamps, all monotonic):

        adm_wait  admission admit -> PrePrepare handler entry
                  (external-queue wait; 0 for the primary's own PP)
        dispatch  handler entry -> accept (validation, incl. the async
                  client-sig round trip; 0 for the primary self-accept)
        prepare   accept -> prepare quorum (0 on the fast path)
        commit    prepare quorum (or accept) -> commit quorum
        exec      commit -> durable apply (lane thread)
        reply     durable apply -> slot integrated + replies sent

    Plus one OVERLAY stage that runs concurrently with ``commit`` and
    is excluded from the slot total:

        spec_overlap  speculative enqueue -> commit quorum: the slice
                  of the combine window the execution lane reclaimed
                  by running the slot ahead of its commit certificate
                  (> 0 only when the speculative run sealed; aborted
                  speculations fold to 0)

    A slot finalizes on EV_REPLY (the dispatcher records it for every
    integrated slot, replies or not): its stage durations feed the
    process-wide ``slot.<stage>`` diagnostics histograms and a bounded
    deque of recent completed slots behind ``status get slots``."""

    MAX_LIVE = 4096
    KEEP = 512

    def __init__(self) -> None:
        self._mu = make_lock("flight.slots")
        self._live: Dict[Tuple[int, int], Dict] = {}
        self._done: "deque[Dict]" = deque(maxlen=self.KEEP)
        self._hists: Dict[str, object] = {}
        self._finalized = 0
        # cert_lag overlay samples, (rid, lag_ms): EV_CERT_ASYNC_LAG
        # usually arrives AFTER its slot finalized on EV_REPLY (that is
        # the whole point of the optimistic reply plane), so the
        # deferred-combine tail is tracked as its own bounded sample
        # stream instead of a per-slot field
        self._cert_lag: "deque[Tuple[int, float]]" = deque(maxlen=self.KEEP)
        # recently-finalized slot keys: with optimistic replies the
        # verified-commit event (EV_COMMITTED) lands AFTER the slot
        # already finalized on EV_REPLY — without this guard the late
        # event would resurrect the slot as a live entry that never
        # finalizes and eventually evicts genuinely-live slots
        self._folded: "deque[Tuple[int, int]]" = deque()
        self._folded_set: set = set()
        # per-replica finalized counts: an rid-filtered summary must
        # report ITS replica's progress (the autotuner's fresh-signal
        # gate), not the process total — in a multi-replica process a
        # stalled replica's controller must not mistake its siblings'
        # slots for fresh local signal
        self._finalized_by_rid: Dict[int, int] = {}

    def _hist(self, stage: str):
        h = self._hists.get(stage)
        if h is None:
            from tpubft_torch.diagnostics import get_registrar
            h = self._hists[stage] = get_registrar().histogram(
                f"slot.{stage}")
        return h

    _FIELD = {EV_ADM_ADMIT: "admit", EV_PP_DISPATCH: "handler",
              EV_PP_ACCEPT: "accept", EV_PREPARED: "prepared",
              EV_COMMITTED: "committed", EV_EXEC_ENQ: "enqueued",
              EV_EXEC_APPLY: "applied", EV_REPLY: "replied",
              EV_SPEC_ENQ: "spec_enq", EV_SPEC_SEAL: "spec_seal"}

    def on_event(self, rid: int, code: int, seq: int, view: int,
                 arg: int, t_ns: int) -> None:
        if code == EV_CERT_ASYNC_LAG:
            # overlay sample (arg = lag in µs): folded independently of
            # the slot record, which is typically already finalized
            lag_ms = arg / 1e3
            with self._mu:
                self._cert_lag.append((rid, lag_ms))
            self._hist("cert_lag").record(arg)      # histograms in µs
            return
        key = (rid, seq)
        with self._mu:
            slot = self._live.get(key)
            if slot is None:
                if (code in (EV_REPLY, EV_SPEC_ABORT)
                        or key in self._folded_set):
                    return              # replay / late event on a
                    #                     slot that already folded
                if len(self._live) >= self.MAX_LIVE:
                    # bounded: evict the oldest live entry (a wedged or
                    # view-changed-away slot must not pin memory)
                    self._live.pop(next(iter(self._live)))
                slot = self._live[key] = {"rid": rid, "seq": seq,
                                          "view": view}
            if code == EV_SPEC_ABORT:
                # the speculation was discarded: this slot re-executes
                # from its committed body, so no combine window was
                # reclaimed — spec_overlap must fold to 0
                slot.pop("spec_enq", None)
                slot.pop("spec_seal", None)
                return
            field = self._FIELD[code]
            slot.setdefault(field, t_ns)
            if code == EV_COMMITTED:
                slot.setdefault("path", "fast" if arg else "slow")
            if code != EV_REPLY:
                return
            del self._live[key]
            self._folded_set.add(key)
            self._folded.append(key)
            if len(self._folded) > self.MAX_LIVE:
                self._folded_set.discard(self._folded.popleft())
        self._finalize(slot)

    @staticmethod
    def fold(slot: Dict) -> Dict[str, float]:
        """Stage durations in milliseconds from a slot's raw
        timestamps — pure, shared with tools/tpuprof.py."""
        def ms(a: Optional[int], b: Optional[int]) -> float:
            if a is None or b is None or b < a:
                return 0.0
            return (b - a) / 1e6
        accept = slot.get("accept")
        prepared = slot.get("prepared")
        return {
            "adm_wait": ms(slot.get("admit"), slot.get("handler")),
            "dispatch": ms(slot.get("handler"), accept),
            "prepare": ms(accept, prepared),
            "commit": ms(prepared if prepared is not None else accept,
                         slot.get("committed")),
            "exec": ms(slot.get("committed"), slot.get("applied")),
            "reply": ms(slot.get("applied"), slot.get("replied")),
            # combine-window slice reclaimed by speculation: counted
            # only when the speculative run actually SEALED (an aborted
            # or commit-first speculation reclaimed nothing)
            "spec_overlap": (ms(slot.get("spec_enq"),
                                slot.get("committed"))
                             if slot.get("spec_seal") is not None
                             else 0.0),
            # per-slot placeholder: the deferred-combine tail lands
            # AFTER the slot finalizes, so cert_lag is folded from the
            # EV_CERT_ASYNC_LAG sample stream (see summary()), never
            # from a slot's own timestamps
            "cert_lag": 0.0,
        }

    def _finalize(self, slot: Dict) -> None:
        stages = self.fold(slot)
        rec = {"rid": slot["rid"], "seq": slot["seq"],
               "view": slot.get("view", 0),
               "path": slot.get("path", "?"),
               "spec": slot.get("spec_seal") is not None,
               "total_ms": round(sum(stages[s]
                                     for s in PIPELINE_STAGES), 3),
               "stages_ms": {k: round(v, 3) for k, v in stages.items()}}
        for stage, v_ms in stages.items():
            self._hist(stage).record(v_ms * 1e3)      # histograms in us
        with self._mu:
            self._finalized += 1
            self._finalized_by_rid[rec["rid"]] = \
                self._finalized_by_rid.get(rec["rid"], 0) + 1
            self._done.append(rec)

    def summary(self, rid: Optional[int] = None) -> Dict:
        """Per-stage breakdown over the retained completed slots:
        count/avg/p50/p95/max in ms (the bench --profile artifact and
        ``status get slots`` payload)."""
        with self._mu:
            done = [d for d in self._done
                    if rid is None or d["rid"] == rid]
            live = len(self._live)
            finalized = (self._finalized if rid is None
                         else self._finalized_by_rid.get(rid, 0))
            lag_samples = [ms for r, ms in self._cert_lag
                           if rid is None or r == rid]
        stages: Dict[str, Dict] = {}
        for stage in STAGES:
            if stage == "cert_lag":
                vals = sorted(lag_samples)
            else:
                vals = sorted(d["stages_ms"][stage] for d in done)
            n = len(vals)
            stages[stage] = {
                "count": n,
                "avg_ms": round(sum(vals) / n, 3) if n else 0.0,
                "p50_ms": vals[n // 2] if n else 0.0,
                "p95_ms": vals[min(n - 1, int(n * 0.95))] if n else 0.0,
                "max_ms": vals[-1] if n else 0.0,
            }
        return {"completed": len(done), "finalized_total": finalized,
                "live": live, "stages": stages}

    def recent(self, limit: int = 50,
               rid: Optional[int] = None) -> List[Dict]:
        with self._mu:
            done = [d for d in self._done
                    if rid is None or d["rid"] == rid]
        return done[-limit:]

    def reset(self) -> None:
        with self._mu:
            self._live.clear()
            self._done.clear()
            self._finalized = 0
            self._finalized_by_rid.clear()
            self._cert_lag.clear()
            self._folded.clear()
            self._folded_set.clear()


_tracker = SlotTracker()


def slot_tracker() -> SlotTracker:
    return _tracker


def stage_summary(rid: Optional[int] = None) -> Dict:
    return _tracker.summary(rid=rid)


# ---------------------------------------------------------------------
# kernel profiler (fed by ops/dispatch.device_section)
# ---------------------------------------------------------------------
class KernelProfiler:
    """Per-kernel-kind device profile. The first call is split out —
    it pays the XLA compile, and folding it into the mean makes every
    warm-path number a lie."""

    def __init__(self) -> None:
        self._mu = make_lock("flight.kernels")
        self._stats: Dict[str, Dict] = {}
        self._kind_ids: Dict[str, int] = {}

    def kind_id(self, kind: str) -> int:
        with self._mu:
            kid = self._kind_ids.get(kind)
            if kid is None:
                kid = self._kind_ids[kind] = len(self._kind_ids) + 1
            return kid

    def record(self, kind: str, batch: int, elapsed_ns: int,
               breaker_state: str) -> None:
        us = elapsed_ns / 1e3
        with self._mu:
            st = self._stats.get(kind)
            if st is None:
                st = self._stats[kind] = {
                    "calls": 0, "first_call_us": us, "total_us": 0.0,
                    "warm_us": 0.0, "max_us": 0.0,
                    "batch_sum": 0, "batch_max": 0,
                    "batch_min": batch, "breaker": {}}
            st["calls"] += 1
            st["total_us"] += us
            if st["calls"] > 1:
                st["warm_us"] += us
            st["max_us"] = max(st["max_us"], us)
            st["batch_sum"] += batch
            st["batch_max"] = max(st["batch_max"], batch)
            st["batch_min"] = min(st["batch_min"], batch)
            st["breaker"][breaker_state] = \
                st["breaker"].get(breaker_state, 0) + 1

    def snapshot(self) -> Dict:
        with self._mu:
            out = {}
            for kind, st in self._stats.items():
                calls = st["calls"]
                warm = calls - 1
                out[kind] = {
                    "calls": calls,
                    "first_call_ms": round(st["first_call_us"] / 1e3, 3),
                    "warm_avg_ms": round(
                        st["warm_us"] / warm / 1e3, 3) if warm else 0.0,
                    "total_ms": round(st["total_us"] / 1e3, 3),
                    "max_ms": round(st["max_us"] / 1e3, 3),
                    "batch_avg": round(st["batch_sum"] / calls, 1),
                    "batch_min": st["batch_min"],
                    "batch_max": st["batch_max"],
                    "breaker_states": dict(st["breaker"]),
                }
            return out

    def kind_table(self) -> Dict[int, str]:
        with self._mu:
            return {v: k for k, v in self._kind_ids.items()}

    def reset(self) -> None:
        with self._mu:
            self._stats.clear()


_profiler = KernelProfiler()


def kernel_profiler() -> KernelProfiler:
    return _profiler


# ---------------------------------------------------------------------
# dump plane
# ---------------------------------------------------------------------
# registered subsystem-state providers: each dump/snapshot calls every
# provider and attaches its payload under "providers" — the autotuner
# rides this (knob values + decision log join EV_TUNE events to names),
# and any future subsystem can without touching the recorder
_providers_mu = make_lock("flight.providers")
_providers: Dict[str, object] = {}


def register_dump_provider(name: str, fn) -> None:
    """Attach `fn()`'s JSON-able payload to every snapshot/dump under
    ``providers[name]`` (idempotent by name: last registration wins)."""
    with _providers_mu:
        _providers[name] = fn


def unregister_dump_provider(name: str) -> None:
    with _providers_mu:
        _providers.pop(name, None)


def _provider_payloads() -> Dict:
    with _providers_mu:
        items = list(_providers.items())
    out = {}
    for name, fn in items:
        try:
            out[name] = fn()
        except Exception:  # noqa: BLE001 — a broken provider must not
            out[name] = "<provider error>"   # take down the dump plane
    return out


def snapshot(max_events_per_ring: Optional[int] = None) -> Dict:
    """Full recorder state as one JSON-able dict. ``ts_epoch`` /
    ``mono_ns`` anchor the monotonic event clock to wall time so
    tools/tpuprof.py can align dumps from different replicas."""
    with _rings_mu:
        # retention pass here too (registration is the other site):
        # a snapshot-heavy process with no NEW threads must still shed
        # dead rings beyond the cap
        _prune_dead_locked()
        rings = list(_rings)
    ring_dumps = []
    for r in rings:
        evs = r.events()
        if max_events_per_ring is not None:
            evs = evs[-max_events_per_ring:]
        ring_dumps.append({"thread": r.role, "rid": r.rid,
                           "events": [list(e) for e in evs]})
    from tpubft_torch.utils.racecheck import hold_stats
    from tpubft_torch.utils.tracing import get_tracer
    spans = [{"name": s.name, "trace_id": s.context.trace_id,
              "span_id": s.context.span_id, "epoch": s.epoch,
              "start": s.start, "end": s.end, "tags": dict(s.tags)}
             for s in get_tracer().finished_spans()[-256:]]
    return {
        "ts_epoch": time.time(),
        "mono_ns": time.monotonic_ns(),
        "pid": os.getpid(),
        "enabled": enabled(),
        "ring_size": RING_SIZE,
        "event_names": {str(k): v for k, v in EV_NAMES.items()},
        "kernel_kinds": {str(k): v for k, v in
                         _profiler.kind_table().items()},
        "rings": ring_dumps,
        "kernels": _profiler.snapshot(),
        "slots": {"summary": _tracker.summary(),
                  "recent": _tracker.recent(limit=SlotTracker.KEEP)},
        "lock_hold_s": hold_stats(),
        "spans": spans,
        "providers": _provider_payloads(),
    }


# dump retention: this process keeps at most this many artifacts in
# the dump dir (oldest pruned at each write) — a flapping verdict or a
# long chaos campaign must degrade to rotating evidence, never to a
# filled filesystem
MAX_DUMPS = max(2, int(os.environ.get("TPUBFT_FLIGHT_MAX_DUMPS", "64")
                       or 64))


def _prune_dumps_locked() -> None:
    prefix = f"flight-{os.getpid()}-"
    try:
        mine = sorted(f for f in os.listdir(_dump_dir)
                      if f.startswith(prefix) and f.endswith(".json"))
        for f in mine[:max(0, len(mine) - MAX_DUMPS)]:
            os.unlink(os.path.join(_dump_dir, f))
    except OSError:
        pass


def dump(reason: str, extra: Optional[Dict] = None,
         path: Optional[str] = None) -> Optional[str]:
    """Write a flight-dump JSON artifact; returns its path (None on
    I/O failure — the dump plane must never take down its host)."""
    global _dump_counter
    try:
        snap = snapshot()
        snap["reason"] = reason
        if extra is not None:
            snap["extra"] = extra
        if path is None:
            os.makedirs(_dump_dir, exist_ok=True)
            safe = "".join(ch if ch.isalnum() or ch in "-_." else "_"
                           for ch in reason)[:80]
            with _dump_mu:
                _dump_counter += 1
                n = _dump_counter
                path = os.path.join(
                    _dump_dir,
                    f"flight-{os.getpid()}-{n:06d}-{safe}.json")
                _prune_dumps_locked()
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(snap, fh)
        return path
    except Exception:  # noqa: BLE001 — diagnostics must not crash host
        return None


def reset() -> None:
    """Drop all recorded state (bench/test isolation). Rings stay
    registered (threads keep their identity); their contents clear."""
    with _rings_mu:
        for r in _rings:
            r.buf = [None] * RING_SIZE
            r.idx = 0
    _tracker.reset()
    _profiler.reset()


# ---------------------------------------------------------------------
# diagnostics wiring (`status get flight|slots|kernels`)
# ---------------------------------------------------------------------
def install_diagnostics(registrar=None) -> None:
    """Idempotent registration of the recorder's status handlers on the
    (given or global) diagnostics registrar."""
    if registrar is None:
        from tpubft_torch.diagnostics import get_registrar
        registrar = get_registrar()
    registrar.register_status("flight", lambda: json.dumps(
        snapshot(max_events_per_ring=256)))
    registrar.register_status("slots", lambda: json.dumps(
        {"summary": _tracker.summary(),
         "recent": _tracker.recent(limit=50)}, sort_keys=True))
    registrar.register_status("kernels", lambda: json.dumps(
        _profiler.snapshot(), sort_keys=True))
