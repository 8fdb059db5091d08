"""Incoming message pipeline: bounded queues + THE dispatcher thread.

Rebuild of the reference's IncomingMsgsStorageImp
(concord-bft bftengine/src/bftengine/IncomingMsgsStorageImp.hpp:32,
maxNumberOfPendingExternalMsgs_=20000 :64) + MsgHandlersRegistrator
(MsgHandlersRegistrator.hpp:48) + MsgsCommunicator (MsgsCommunicator.cpp:41).

All protocol state is mutated only on the single dispatcher thread;
transports and crypto workers communicate with it exclusively through
these queues. Internal messages (collector results, timer ticks) bypass
the external bound and have priority, as in the reference.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from tpubft_torch.utils.logging import get_logger, set_mdc
from tpubft_torch.utils.racecheck import make_condition

log = get_logger("dispatch")

MAX_EXTERNAL_PENDING = 20000


@dataclass
class ExternalMsg:
    sender: int
    raw: bytes


@dataclass
class InternalMsg:
    """Result of background work re-entering the main loop (reference
    CombinedSigSucceeded/Failed internal msgs)."""
    kind: str
    payload: Any


class IncomingMsgsStorage:
    """Bounded external + unbounded internal deques under ONE
    racecheck-registered Condition (`incoming.cv`): every producer —
    transport receive threads, admission workers, the execution lane's
    completed-run wakeups — and the dispatcher's pop ride the same lock,
    so under TPUBFT_THREADCHECK the queue's ordering edges and hold
    times are visible to the runtime lock-order graph (queue.Queue's
    internal Conditions never were)."""

    def __init__(self, max_external: int = MAX_EXTERNAL_PENDING):
        self._cv = make_condition("incoming.cv")
        self._external: "deque[ExternalMsg]" = deque()
        self._internal: "deque[InternalMsg]" = deque()
        self._max_external = max_external
        self._dropped_external = 0
        # level-triggered wakeup kinds currently enqueued (see
        # push_internal_once)
        self._once_pending: set = set()

    def push_external(self, sender: int, raw: bytes) -> bool:
        return self.push_external_obj(ExternalMsg(sender, raw))

    def push_external_obj(self, obj) -> bool:
        """Bounded external-queue entry shared by the raw path and the
        admission plane (already-parsed, already-verified AdmittedMsgs
        ride the same queue and the same drop accounting)."""
        with self._cv:
            if len(self._external) >= self._max_external:
                self._dropped_external += 1
                return False
            self._external.append(obj)
            self._cv.notify()
        return True

    def push_internal(self, kind: str, payload: Any = None) -> None:
        with self._cv:
            self._internal.append(InternalMsg(kind, payload))
            self._cv.notify()

    def push_internal_once(self, kind: str) -> None:
        """Level-triggered wakeup: enqueue `kind` (payload None) unless an
        identical wakeup is already pending. Background producers whose
        results live in their own handoff structure (e.g. the execution
        lane's completed-run queue) signal with this so a fast producer
        can't flood the internal queue with redundant wakeups."""
        with self._cv:
            if kind in self._once_pending:
                return
            self._once_pending.add(kind)
            self._internal.append(InternalMsg(kind, None))
            self._cv.notify()

    def pop(self, timeout: float):
        """Internal msgs first (they unblock consensus progress), then
        external; returns ExternalMsg | InternalMsg | None on timeout.
        Single consumer (the dispatcher); a spurious wakeup reads as a
        timeout, which the dispatch loop already tolerates."""
        with self._cv:
            if not self._internal and not self._external:
                self._cv.wait(timeout)
            if self._internal:
                item = self._internal.popleft()
                self._once_pending.discard(item.kind)
                return item
            if self._external:
                return self._external.popleft()
            return None

    @property
    def external_depth(self) -> int:
        return len(self._external)        # racy read is fine for a gauge

    @property
    def internal_depth(self) -> int:
        return len(self._internal)

    @property
    def dropped_external(self) -> int:
        return self._dropped_external


class Dispatcher:
    """The single consensus thread: pops queues, dispatches to registered
    handlers, fires periodic timers between messages."""

    def __init__(self, storage: IncomingMsgsStorage, name: str = "dispatch",
                 thread_mdc: Optional[Dict[str, Any]] = None):
        self._storage = storage
        self._external_handler: Optional[Callable[[int, bytes], None]] = None
        self._admitted_handler: Optional[Callable[[Any], None]] = None
        self._internal_handlers: Dict[str, Callable[[Any], None]] = {}
        self._timers = []  # (period_s, callback, next_due)
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._name = name
        # sticky MDC pinned on the dispatcher thread (e.g. replica id) so
        # every log line from protocol handlers is attributable
        self._thread_mdc = thread_mdc or {}
        # runs at the end of every loop iteration (message + due timers):
        # the transport's batched-send flush point
        self._post_hook: Optional[Callable[[], None]] = None
        # external-path items handled (raw + admitted), read by benches
        # and tests as a drain marker — dispatcher-thread writes only
        self.handled_external = 0

    def set_post_hook(self, fn: Callable[[], None]) -> None:
        self._post_hook = fn

    def set_external_handler(self, fn: Callable[[int, bytes], None]) -> None:
        self._external_handler = fn

    def set_admitted_handler(self, fn: Callable[[Any], None]) -> None:
        """Handler for AdmittedMsg objects (pre-parsed, pre-verified by
        the admission plane); anything on the external queue that is not
        a raw ExternalMsg routes here."""
        self._admitted_handler = fn

    def register_internal(self, kind: str, fn: Callable[[Any], None]) -> None:
        self._internal_handlers[kind] = fn

    def add_timer(self, period_s: float, fn: Callable[[], None]) -> None:
        self._timers.append([period_s, fn, time.monotonic() + period_s])

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=self._name)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        from tpubft_torch.utils.racecheck import get_watchdog
        get_watchdog().unregister(self._name)

    def _loop(self) -> None:
        import os
        prof_dir = os.environ.get("TPUBFT_PROFILE_DIR")
        if prof_dir:
            # saturation profiling of THE consensus thread (where all
            # protocol state mutates): dump pstats when the loop exits —
            # pair with the SIGTERM handler in apps that enables a clean
            # stop (see skvbc_replica.main)
            import cProfile
            prof = cProfile.Profile()
            try:
                prof.runcall(self._loop_body)
            finally:
                prof.dump_stats(os.path.join(
                    prof_dir, f"{self._name}-{os.getpid()}.pstats"))
        else:
            self._loop_body()

    def _loop_body(self) -> None:
        set_mdc(**self._thread_mdc)
        # flight-recorder attribution: this thread's events carry the
        # replica id (from the same MDC that labels its log lines)
        from tpubft_torch.utils import flight
        try:
            flight.set_thread_rid(int(self._thread_mdc.get("r", -1)))
        except (TypeError, ValueError):
            pass
        # liveness heartbeat: a wedged dispatcher (deadlock, hung handler)
        # gets a full-process stack dump from the watchdog (§5.2 role)
        from tpubft_torch.utils.racecheck import get_watchdog
        watchdog = get_watchdog()
        while self._running:
            watchdog.beat(self._name)
            now = time.monotonic()
            next_due = min((t[2] for t in self._timers), default=now + 0.05)
            timeout = max(0.0, min(next_due - now, 0.05))
            item = self._storage.pop(timeout)
            if item is not None:
                try:
                    if isinstance(item, ExternalMsg):
                        self.handled_external += 1
                        if self._external_handler is not None:
                            self._external_handler(item.sender, item.raw)
                    elif isinstance(item, InternalMsg):
                        fn = self._internal_handlers.get(item.kind)
                        if fn is not None:
                            fn(item.payload)
                    else:
                        # AdmittedMsg from the admission plane: already
                        # parsed + verified, the handler only mutates
                        # protocol state
                        self.handled_external += 1
                        if self._admitted_handler is not None:
                            self._admitted_handler(item)
                except Exception:  # noqa: BLE001 — a bad msg must not kill
                    log.exception("handler raised (msg dropped)")
            now = time.monotonic()
            for t in self._timers:
                if now >= t[2]:
                    t[2] = now + t[0]
                    try:
                        t[1]()
                    except Exception:  # noqa: BLE001
                        log.exception("timer callback raised")
            if self._post_hook is not None:
                try:
                    self._post_hook()
                except Exception:  # noqa: BLE001
                    log.exception("post hook raised")
