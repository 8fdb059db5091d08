"""Device dispatch gate — one execution stream to the card, guarded by
the device circuit breaker (port of tpubft/ops/dispatch.py:1-131).

Concurrent host threads (the BatchVerifier worker, combine flushes,
certificate batches) each launch kernels and then wait for their
verdicts. A process-wide lock around launch→read-back keeps their
batches from interleaving on the card and keeps the breaker's latency
clock about the device, not about other threads.

Hold the gate for launch→read-back of one batch; never while doing
host-side crypto or holding protocol locks.

Every kernel call site enters through `device_section(kind)`, which
wraps the gate in the process-wide device breaker (utils/breaker.py):
device exceptions and latency-SLO breaches count against the failure
budget, a tripped breaker fast-fails callers into their host fallbacks
with `BreakerOpen` instead of queueing work behind a dead card, and
half-open probe batches re-admit the device once it recovers. The mesh
and offload tiers of the reference wait for their slices.
"""
from __future__ import annotations

import threading
import time

from tpubft_torch.utils import flight
from tpubft_torch.utils.breaker import BreakerOpen, get_breaker  # noqa: F401
# re-exported: callers catching the fast-fail import it from here so the
# ops layer stays the only crypto↔breaker coupling point

# RLock: a gated section may call another gated helper
_gate = threading.RLock()

# ONE breaker for the whole device: the card is a single shared
# resource. Per-seam attribution rides the `kind` tag.
_breaker = get_breaker("device")


def device_breaker():
    """The process-wide device circuit breaker."""
    return _breaker


class _Section:
    """`with device_section(kind, batch):` — breaker admission and
    classification around the serialized device gate, plus flight
    recorder / kernel-profiler annotation (kind, batch size, wall time,
    breaker state). Raises BreakerOpen without touching the device when
    tripped."""

    __slots__ = ("_attempt", "_kind", "_batch", "_kid", "_t0", "_rec")

    def __init__(self, kind: str, batch: int) -> None:
        self._attempt = _breaker.attempt(kind)
        self._kind = kind
        self._batch = batch
        # TPUBFT_FLIGHT=0 covers the kernel profiler too (decided once
        # per section — consistent even if the test hook flips mid-call)
        self._rec = flight.enabled()
        self._kid = flight.kernel_profiler().kind_id(kind) \
            if self._rec else 0
        self._t0 = 0

    def __enter__(self):
        self._attempt.__enter__()
        # breaker admission happens BEFORE the gate (a tripped breaker
        # must fast-fail without queueing behind a wedged launch that
        # still holds the gate), so the gate wait lands inside the
        # attempt's clock — credit it back: queueing behind other
        # healthy threads' batches is contention, not device slowness
        t = time.monotonic()
        _gate.acquire()
        _breaker.exclude_wait(time.monotonic() - t)
        if self._rec:
            flight.record(flight.EV_DEV_ENTER, view=self._kid,
                          arg=self._batch)
            self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> bool:
        elapsed_ns = (time.monotonic_ns() - self._t0) if self._rec else 0
        _gate.release()
        suppressed = bool(self._attempt.__exit__(*exc))
        if self._rec:
            # profile AFTER the breaker's verdict so the recorded state
            # is the post-call one
            flight.record(flight.EV_DEV_EXIT, view=self._kid,
                          arg=int(elapsed_ns // 1000))
            flight.kernel_profiler().record(self._kind, self._batch,
                                            elapsed_ns, _breaker.state)
        return suppressed


def device_section(kind: str, batch: int = 0) -> _Section:
    """Guarded device seam. `batch` annotates the kernel profile and the
    flight ring with the call's batch size (0 = not reported)."""
    return _Section(kind, batch)
