"""Race / deadlock detection — the runtime counterpart of the
reference's sanitizer build modes.

The reference gates TSan/ASan/UBSan at build time
(concord-bft CMakeLists.txt:30-32 `THREADCHECK`/`LEAKCHECK`/
`UNDEFINED_BEHAVIOR_CHECK`). Python has no compile modes, so the
equivalent here is runtime instrumentation, enabled the same way the
reference enables TSan — as a test-infrastructure switch
(`TPUBFT_THREADCHECK=1`):

* ``CheckedLock`` / ``LockOrderChecker`` — a lock wrapper that records the
  global lock-acquisition ORDER graph across threads; a cycle in that
  graph is a potential deadlock (the classic TSan lock-order-inversion
  report), raised immediately at the acquisition that closes the cycle.
* ``StallWatchdog`` — heartbeat monitor for the framework's critical
  threads (dispatcher, collector pool): a thread that stops beating past
  the threshold gets every Python thread's stack dumped to the log — the
  liveness side of race debugging (deadlocks manifest as stalls).
"""
from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Dict, Optional, Set, Tuple

from tpubft_torch.utils.logging import get_logger

log = get_logger("racecheck")


def enabled() -> bool:
    return os.environ.get("TPUBFT_THREADCHECK", "") not in ("", "0")


class LockOrderViolation(RuntimeError):
    """A lock acquisition closed a cycle in the global lock-order graph."""


class LockOrderChecker:
    """Global acquisition-order graph over named locks. Edge A→B is
    recorded when B is acquired while A is held; a path B⇝A existing at
    that moment means two threads can deadlock — report at the exact
    acquisition site that introduces the inversion."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._edges: Dict[str, Set[str]] = {}
        self._edge_sites: Dict[Tuple[str, str], str] = {}
        self._held = threading.local()

    def _held_set(self):
        if not hasattr(self._held, "names"):
            self._held.names = []
        return self._held.names

    def _reaches(self, src: str, dst: str) -> bool:
        seen = set()
        stack = [src]
        while stack:
            cur = stack.pop()
            if cur == dst:
                return True
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(self._edges.get(cur, ()))
        return False

    def on_acquire(self, name: str) -> str:
        """Record the acquisition; returns the formatted site so the
        caller (CheckedLock) can reuse it for hold-time reports without
        a second stack capture."""
        held = self._held_set()
        site = "".join(traceback.format_stack(limit=4)[:-1])
        with self._mu:
            for h in held:
                if h == name:
                    continue
                if name not in self._edges.get(h, set()):
                    # adding h→name; inversion iff name⇝h already exists
                    if self._reaches(name, h):
                        first = self._edge_sites.get(
                            (name, h)) or "(recorded earlier)"
                        raise LockOrderViolation(
                            f"lock-order inversion: acquiring {name!r} "
                            f"while holding {h!r}, but the opposite order "
                            f"exists elsewhere.\nThis acquisition:\n{site}"
                            f"\nOpposite-order site:\n{first}")
                    self._edges.setdefault(h, set()).add(name)
                    self._edge_sites[(h, name)] = site
        held.append(name)
        return site

    def on_release(self, name: str) -> None:
        held = self._held_set()
        if name in held:
            held.remove(name)


_checker = LockOrderChecker()


def get_checker() -> LockOrderChecker:
    return _checker


# ---- held-too-long accounting -----------------------------------------
# Per-lock max-hold-time under TPUBFT_THREADCHECK: a "dispatcher briefly
# stalled" report becomes named-lock evidence — which lock, held from
# which acquisition site, for how long. Holders exceeding the threshold
# (TPUBFT_LOCK_HOLD_MS, default 100ms) are logged with the site.
_HOLD_ENV = "TPUBFT_LOCK_HOLD_MS"
_hold_mu = threading.Lock()
_hold_max: Dict[str, float] = {}          # lock name -> max hold (s)
_hold_reports = 0


def hold_threshold_s() -> float:
    try:
        return float(os.environ.get(_HOLD_ENV, "100")) / 1000.0
    except ValueError:
        return 0.1


def hold_stats() -> Dict[str, float]:
    """Snapshot of per-lock max hold time (seconds) recorded so far."""
    with _hold_mu:
        return dict(_hold_max)


def hold_report_count() -> int:
    with _hold_mu:
        return _hold_reports


def reset_hold_stats() -> None:
    global _hold_reports
    with _hold_mu:
        _hold_max.clear()
        _hold_reports = 0


class CheckedLock:
    """Drop-in threading.Lock/RLock wrapper feeding the order checker
    and the per-lock hold-time accounting. Zero-cost import path:
    construct via `make_lock(name)` which returns a plain lock when the
    check is disabled."""

    def __init__(self, name: str, reentrant: bool = False) -> None:
        self._name = name
        self._lock = threading.RLock() if reentrant else threading.Lock()
        # holder-only state: written while the underlying lock is held
        self._depth = 0
        self._acquired_at = 0.0
        self._site = ""

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            try:
                site = _checker.on_acquire(self._name)
            except LockOrderViolation:
                # report the POTENTIAL deadlock without creating a real
                # one: the underlying lock must not stay held by a thread
                # that unwound past its release
                self._lock.release()
                raise
            self._depth += 1
            if self._depth == 1:              # outermost acquisition
                self._acquired_at = time.monotonic()
                self._site = site
        return ok

    def release(self) -> None:
        global _hold_reports
        self._depth -= 1
        if self._depth == 0:
            held_s = time.monotonic() - self._acquired_at
            site = self._site
            over = held_s > hold_threshold_s()
            with _hold_mu:
                if held_s > _hold_max.get(self._name, 0.0):
                    _hold_max[self._name] = held_s
                if over:
                    _hold_reports += 1
            if over:
                log.warning(
                    "lock %r held %.1fms (> %.0fms threshold); "
                    "acquired at:\n%s", self._name, held_s * 1e3,
                    hold_threshold_s() * 1e3, site)
        _checker.on_release(self._name)
        self._lock.release()

    def __enter__(self) -> "CheckedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def make_lock(name: str, reentrant: bool = False):
    """Project-wide lock constructor: instrumented under
    TPUBFT_THREADCHECK, plain otherwise."""
    if enabled():
        return CheckedLock(name, reentrant)
    return threading.RLock() if reentrant else threading.Lock()


def make_condition(name: str) -> threading.Condition:
    """Project-wide Condition constructor: a `threading.Condition` over
    a `CheckedLock` under TPUBFT_THREADCHECK (every acquire/release —
    including wait()'s release/re-acquire cycle — feeds the lock-order
    graph and the hold-time accounting, like any make_lock site), a
    plain Condition otherwise. Condition's ownership probe
    (`acquire(False)` try/release) composes with CheckedLock: a failed
    probe records nothing."""
    if enabled():
        return threading.Condition(CheckedLock(name))
    return threading.Condition()


class StallWatchdog:
    """Heartbeat-monitored liveness: critical loops call `beat(name)`;
    a beat older than `threshold_s` triggers one full-process stack dump
    (throttled) so deadlocks/stalls are diagnosable post-hoc."""

    def __init__(self, threshold_s: float = 30.0,
                 poll_s: float = 5.0) -> None:
        self.threshold_s = threshold_s
        self.poll_s = poll_s
        self._beats: Dict[str, float] = {}
        self._mu = make_lock("racecheck.watchdog")
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._reported: Set[str] = set()
        self.stall_reports = 0

    def beat(self, name: str) -> None:
        if not self._running:
            self.start()              # first heartbeat arms the monitor
        with self._mu:
            self._beats[name] = time.monotonic()
            self._reported.discard(name)

    def unregister(self, name: str) -> None:
        with self._mu:
            self._beats.pop(name, None)
            self._reported.discard(name)

    def start(self) -> None:
        with self._mu:
            if self._running:
                return
            self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="stall-watchdog")
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _run(self) -> None:
        while self._running:
            time.sleep(self.poll_s)
            now = time.monotonic()
            with self._mu:
                stalled = [n for n, t in self._beats.items()
                           if now - t > self.threshold_s
                           and n not in self._reported]
                for n in stalled:
                    self._reported.add(n)
            if stalled:
                self.stall_reports += len(stalled)
                self._dump(stalled)

    def _dump(self, stalled) -> None:
        lines = [f"STALL: no heartbeat from {stalled} for "
                 f">{self.threshold_s}s; all thread stacks follow"]
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in frames.items():
            lines.append(f"--- thread {names.get(ident, ident)} ---")
            lines.append("".join(traceback.format_stack(frame)))
        log.error("%s", "\n".join(lines))


_watchdog = StallWatchdog()


def get_watchdog() -> StallWatchdog:
    return _watchdog
