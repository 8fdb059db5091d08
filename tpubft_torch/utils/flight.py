"""Flight recorder and kernel profiler (port of tpubft/utils/flight.py).

Every hot seam emits a fixed-size event

    (monotonic_ns, event_code, seq, view, arg)

into a bounded ring owned by the emitting thread; the write takes no
lock. The `KernelProfiler` keeps per-kernel call counts, batch-size
stats and wall time, recorded by `ops.dispatch.device_section`.

Ported for the signature plane: the device-section events, the rings
and the kernel profiler. The slot tracker, the dump plane and the
remaining event codes wait for the replica core.

Knobs (environment, read once at import):

  * ``TPUBFT_FLIGHT=0``     turns the recorder off: ``record`` becomes a
    no-op and ``device_section`` skips the profiler;
  * ``TPUBFT_FLIGHT_RING``  events kept per thread (default 4096).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from tpubft_torch.utils.racecheck import make_lock

EV_DEV_ENTER = 13       # device_section entry (view=kind id, arg=batch)
EV_DEV_EXIT = 14        # device_section exit (view=kind id, arg=us)

RING_SIZE = max(64, int(os.environ.get("TPUBFT_FLIGHT_RING", "4096")
                        or 4096))


class _Ring:
    """Bounded event ring owned by exactly one thread: writes are
    lock-free (the registry lock is taken once, at creation)."""

    __slots__ = ("buf", "idx", "role")

    def __init__(self, role: str) -> None:
        self.buf: List[Optional[Tuple]] = [None] * RING_SIZE
        self.idx = 0
        self.role = role


_tl = threading.local()
_rings_mu = make_lock("flight.rings")
_rings: List[_Ring] = []


def _ring() -> _Ring:
    ring = getattr(_tl, "ring", None)
    if ring is None:
        ring = _tl.ring = _Ring(threading.current_thread().name)
        with _rings_mu:
            _rings.append(ring)
    return ring


def _record(code: int, seq: int = 0, view: int = 0, arg: int = 0) -> None:
    ring = _ring()
    ring.buf[ring.idx] = (time.monotonic_ns(), code, seq, view, arg)
    ring.idx = (ring.idx + 1) % RING_SIZE


def _record_off(code: int, seq: int = 0, view: int = 0,
                arg: int = 0) -> None:
    return None


ENABLED = os.environ.get("TPUBFT_FLIGHT", "1") not in ("", "0")
# the ONE hot-path entry point: callers use `flight.record(...)` (a
# module-attribute lookup) so enable/disable swaps take effect
record = _record if ENABLED else _record_off


def enabled() -> bool:
    return record is _record


class KernelProfiler:
    """Per-kernel-kind device profile. The first call is split out: it
    pays the kernel build, and folding it into the mean makes every
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

    def reset(self) -> None:
        with self._mu:
            self._stats.clear()


_profiler = KernelProfiler()


def kernel_profiler() -> KernelProfiler:
    return _profiler
