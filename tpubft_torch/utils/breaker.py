"""Circuit breaker for the device-kernel seams — degradation as a
first-class runtime state.

Port of tpubft/utils/breaker.py. The signature plane's device seams
(SigManager's cross-principal verify ride, the multisig certificate
checks) have host fallbacks; without a breaker a device failure
mid-run either crashes the call or wedges the thread behind a hung
launch. This module makes the fallbacks reachable at RUNTIME: every
device seam runs inside a `CircuitBreaker.attempt()` section that

  * classifies failures — a device exception OR a latency-SLO breach
    both count against the failure budget (a wedged accelerator
    transport usually manifests as multi-second dispatches long before
    it raises);
  * trips OPEN after `failure_threshold` CONSECUTIVE failures: further
    attempts fast-fail with `BreakerOpen` before touching the device,
    so callers fall through to their scalar/host paths immediately
    instead of queueing behind a dead transport;
  * re-admits the device via HALF-OPEN probes: once `cooldown_s`
    elapses, a single in-flight attempt is allowed through as a probe
    batch — success closes the breaker (cooldown resets), failure
    re-opens it with exponential cooldown escalation up to
    `max_cooldown_s` (concord-bft's controller treats its slow path the
    same way: a protocol state you enter and leave on evidence, not an
    outage).

The process-wide breaker registry is what the health plane reads once
it is ported (tpubft/consensus/health.py), so a degraded run is
visible, not silent.

Nesting: a guarded seam may call another guarded seam (SigManager's
verify ride dispatches through ops/ed25519's guarded kernel call). Only
the OUTERMOST attempt on a thread records an outcome — inner sections
are pass-through, so one device failure is one failure, not two.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, Optional

from tpubft_torch.utils.racecheck import make_lock

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class BreakerOpen(RuntimeError):
    """Fast-fail: the breaker is OPEN (or the half-open probe slot is
    taken) — the caller must use its scalar/host fallback."""


class CircuitBreaker:
    def __init__(self, name: str,
                 failure_threshold: int = 3,
                 cooldown_s: float = 2.0,
                 latency_slo_s: float = 0.0,
                 max_cooldown_s: float = 30.0,
                 probe_max: int = 1,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.name = name
        self.failure_threshold = max(1, failure_threshold)
        self.base_cooldown_s = cooldown_s
        # 0 disables the SLO classifier (first-dispatch XLA compiles can
        # legitimately take seconds — enable only after warmup or with a
        # budget that clears the compile)
        self.latency_slo_s = latency_slo_s
        self.max_cooldown_s = max_cooldown_s
        self.probe_max = max(1, probe_max)
        self._clock = clock
        self._mu = make_lock(f"breaker.{name}")
        self._tl = threading.local()      # nesting depth + probe flag
        self._state = CLOSED
        self._consecutive = 0
        self._cooldown_s = cooldown_s
        self._open_until = 0.0
        self._probe_inflight = 0
        # counters (plain ints under _mu; surfaced by the health plane)
        self.successes = 0
        self.failures = 0
        self.slo_breaches = 0
        self.trips = 0                    # CLOSED/HALF_OPEN -> OPEN
        self.recoveries = 0               # HALF_OPEN -> CLOSED
        self.fast_fails = 0               # attempts rejected while OPEN
        self.failures_by_kind: Dict[str, int] = {}
        _register(self)

    # ------------------------------------------------------------------
    # configuration (replica wiring pushes ReplicaConfig knobs here; the
    # breaker is process-wide, so the last-configured values win — all
    # replicas of one process share one device)
    # ------------------------------------------------------------------
    def configure(self, failure_threshold: Optional[int] = None,
                  cooldown_s: Optional[float] = None,
                  latency_slo_s: Optional[float] = None,
                  max_cooldown_s: Optional[float] = None) -> None:
        with self._mu:
            if failure_threshold is not None:
                self.failure_threshold = max(1, failure_threshold)
            if cooldown_s is not None:
                self.base_cooldown_s = cooldown_s
                self._cooldown_s = min(self._cooldown_s, max(
                    cooldown_s, 0.001)) if self._state != CLOSED else cooldown_s
            if latency_slo_s is not None:
                self.latency_slo_s = latency_slo_s
            if max_cooldown_s is not None:
                self.max_cooldown_s = max_cooldown_s

    def reset(self) -> None:
        """Back to CLOSED with a fresh failure budget (test isolation;
        counters are preserved — they are cumulative telemetry)."""
        with self._mu:
            self._state = CLOSED
            self._consecutive = 0
            self._cooldown_s = self.base_cooldown_s
            self._probe_inflight = 0

    # ------------------------------------------------------------------
    # state machine
    # ------------------------------------------------------------------
    @property
    def state(self) -> str:
        with self._mu:
            return self._state_locked()

    def _state_locked(self) -> str:
        # OPEN with an expired cooldown reads as HALF_OPEN: the next
        # attempt becomes the probe
        if self._state == OPEN and self._clock() >= self._open_until:
            return HALF_OPEN
        return self._state

    def allow(self) -> bool:
        """Non-mutating admission preview (hot paths that want to skip
        building the device batch entirely when degraded)."""
        with self._mu:
            s = self._state_locked()
            return s == CLOSED or (s == HALF_OPEN
                                   and self._probe_inflight < self.probe_max)

    def _admit(self) -> bool:
        """Admission decision; returns probe-ness. Raises BreakerOpen."""
        with self._mu:
            now = self._clock()
            if self._state == OPEN and now >= self._open_until:
                self._state = HALF_OPEN
                self._probe_inflight = 0
            if self._state == CLOSED:
                return False
            if self._state == HALF_OPEN \
                    and self._probe_inflight < self.probe_max:
                self._probe_inflight += 1
                return True
            self.fast_fails += 1
        raise BreakerOpen(
            f"breaker {self.name!r} open ({self._cooldown_s:.1f}s cooldown)")

    def record_success(self, probe: bool = False) -> None:
        with self._mu:
            self.successes += 1
            self._consecutive = 0
            if probe:
                self._probe_inflight = max(0, self._probe_inflight - 1)
            # only a PROBE verdict may close the breaker: a non-probe
            # success seeing HALF_OPEN is a stale call admitted back
            # when the breaker was CLOSED (e.g. a dispatch that wedged
            # for the whole failure burst and finally returned) — its
            # evidence predates the trip and must not re-admit the
            # device while the real probe is still in flight
            if probe and self._state == HALF_OPEN:
                self._state = CLOSED
                self._cooldown_s = self.base_cooldown_s
                self.recoveries += 1

    def record_failure(self, kind: str = "", cause: str = "error",
                       probe: bool = False) -> None:
        with self._mu:
            self.failures += 1
            if cause == "slow":
                self.slo_breaches += 1
            if kind:
                self.failures_by_kind[kind] = \
                    self.failures_by_kind.get(kind, 0) + 1
            self._consecutive += 1
            if probe:
                self._probe_inflight = max(0, self._probe_inflight - 1)
            if self._state == HALF_OPEN:
                # the probe failed: re-open with escalated cooldown
                self._trip_locked(escalate=True)
            elif self._state == CLOSED \
                    and self._consecutive >= self.failure_threshold:
                self._trip_locked(escalate=False)

    def trip(self, cooldown_s: Optional[float] = None,
             cause: str = "forced") -> None:
        """Force OPEN from outside the attempt/verdict flow — the
        quarantine primitive (a Byzantine crypto-offload
        helper is evicted with an effectively-infinite cooldown; only
        an operator `reset()` re-admits it). Unlike failures, a forced
        trip carries no probe semantics: with a large enough cooldown
        the HALF_OPEN window simply never arrives."""
        with self._mu:
            if cooldown_s is not None:
                self._cooldown_s = cooldown_s
            if cause:
                self.failures_by_kind[cause] = \
                    self.failures_by_kind.get(cause, 0) + 1
            self._state = OPEN
            self._open_until = self._clock() + self._cooldown_s
            self.trips += 1

    def _trip_locked(self, escalate: bool) -> None:
        if escalate:
            self._cooldown_s = min(self._cooldown_s * 2, self.max_cooldown_s)
        self._state = OPEN
        self._open_until = self._clock() + self._cooldown_s
        self.trips += 1

    def exclude_wait(self, dt: float) -> None:
        """Credit host-side queueing against the latency-SLO clock of
        this thread's in-flight attempt. The device gate serializes
        producers (admission workers, exec-lane hashing, ST digests):
        time spent waiting behind another HEALTHY thread's batch is
        contention, not device slowness, and must not count toward the
        failure budget — or peak load alone trips the breaker."""
        if dt > 0 and getattr(self._tl, "depth", 0):
            self._tl.exclude = getattr(self._tl, "exclude", 0.0) + dt

    def _abandon(self, probe: bool) -> None:
        """Neither success nor failure (BaseException unwinding through
        the section): release the probe slot without a verdict."""
        if not probe:
            return
        with self._mu:
            self._probe_inflight = max(0, self._probe_inflight - 1)

    # ------------------------------------------------------------------
    # the guarded section
    # ------------------------------------------------------------------
    @contextmanager
    def attempt(self, kind: str = ""):
        """Run one device interaction under the breaker. Raises
        BreakerOpen (without running the body) when the device is
        disallowed; classifies body exceptions as failures and re-raises
        them; classifies an over-SLO success as a failure but still
        returns normally (the result is valid — the DEVICE is slow)."""
        depth = getattr(self._tl, "depth", 0)
        if depth:
            # nested seam: the outermost attempt owns the verdict
            self._tl.depth = depth + 1
            try:
                yield
            finally:
                self._tl.depth = depth
            return
        probe = self._admit()
        self._tl.depth = 1
        self._tl.exclude = 0.0
        t0 = self._clock()
        try:
            yield
        except Exception:
            self.record_failure(kind, "error", probe)
            raise
        except BaseException:
            self._abandon(probe)
            raise
        else:
            elapsed = self._clock() - t0 - getattr(self._tl, "exclude", 0.0)
            if self.latency_slo_s and elapsed > self.latency_slo_s:
                self.record_failure(kind, "slow", probe)
            else:
                self.record_success(probe)
        finally:
            self._tl.depth = 0

    def snapshot(self) -> Dict:
        with self._mu:
            now = self._clock()
            return {
                "state": self._state_locked(),
                "consecutive_failures": self._consecutive,
                "failure_threshold": self.failure_threshold,
                "cooldown_s": round(self._cooldown_s, 3),
                "open_for_s": round(max(0.0, self._open_until - now), 3)
                if self._state == OPEN else 0.0,
                "successes": self.successes,
                "failures": self.failures,
                "slo_breaches": self.slo_breaches,
                "trips": self.trips,
                "recoveries": self.recoveries,
                "fast_fails": self.fast_fails,
                "failures_by_kind": dict(self.failures_by_kind),
            }


# ---------------------------------------------------------------------
# process-wide registry (the health plane enumerates it)
# ---------------------------------------------------------------------
_registry: Dict[str, CircuitBreaker] = {}
# RLock: get_breaker constructs under the lock and CircuitBreaker's
# constructor re-enters it via _register
_registry_mu = threading.RLock()


def _register(b: CircuitBreaker) -> None:
    with _registry_mu:
        _registry[b.name] = b


def get_breaker(name: str, **kwargs) -> CircuitBreaker:
    """Get-or-create a named breaker (kwargs only apply on creation).
    The whole get-or-create runs under the registry lock: two racing
    first callers must share ONE instance, or one of them records
    failures on a breaker the health plane (and configure()) never
    sees."""
    with _registry_mu:
        b = _registry.get(name)
        if b is None:
            b = CircuitBreaker(name, **kwargs)
        return b


def all_breakers() -> Dict[str, CircuitBreaker]:
    with _registry_mu:
        return dict(_registry)


def prefixed(prefix: str) -> Dict[str, CircuitBreaker]:
    """Registry slice by name prefix — how the health plane (and tests)
    enumerate a breaker FAMILY, e.g. the per-chip mesh children
    `device.chip<N>` without knowing the chip inventory."""
    with _registry_mu:
        return {n: b for n, b in _registry.items()
                if n.startswith(prefix)}


def snapshot_all() -> Dict[str, Dict]:
    return {name: b.snapshot() for name, b in all_breakers().items()}


def any_degraded() -> bool:
    """True when any breaker is not fully CLOSED — the health plane's
    'degraded' input."""
    return any(b.state != CLOSED for b in all_breakers().values())
