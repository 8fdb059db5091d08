"""Status handlers + latency histograms (reference diagnostics.h:25-32,
performance_handler.h)."""
from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Callable, Dict, List, Optional


class PerfHistogram:
    """Log-bucketed latency histogram (the HDR-histogram role of the
    reference's recorders): sub-microsecond to minutes, ~5% bucket
    resolution, constant memory, lock-free-enough recording."""

    _BUCKETS_PER_DECADE = 48
    _MIN_US = 0.1

    def __init__(self, name: str, unit: str = "us") -> None:
        self.name = name
        self.unit = unit
        self._counts: Dict[int, int] = {}
        self._total = 0
        self._sum = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    def record(self, value_us: float) -> None:
        if value_us <= 0:
            value_us = self._MIN_US
        b = int(math.log10(value_us / self._MIN_US)
                * self._BUCKETS_PER_DECADE)
        with self._lock:
            self._counts[b] = self._counts.get(b, 0) + 1
            self._total += 1
            self._sum += value_us
            self._max = max(self._max, value_us)

    def _bucket_value(self, b: int) -> float:
        return self._MIN_US * 10 ** ((b + 0.5) / self._BUCKETS_PER_DECADE)

    def percentile(self, p: float) -> float:
        with self._lock:
            if not self._total:
                return 0.0
            target = self._total * p / 100.0
            acc = 0
            for b in sorted(self._counts):
                acc += self._counts[b]
                if acc >= target:
                    return self._bucket_value(b)
            return self._max

    def snapshot(self) -> Dict:
        with self._lock:
            total, s, mx = self._total, self._sum, self._max
        return {"count": total, "avg": (s / total if total else 0.0),
                "max": mx, "p50": self.percentile(50),
                "p95": self.percentile(95), "p99": self.percentile(99),
                "unit": self.unit}


class TimeRecorder:
    """`with TimeRecorder(hist): ...` — records elapsed microseconds
    (reference TimeRecorder, e.g. ReplicaImp.cpp:5367)."""

    def __init__(self, hist: Optional[PerfHistogram]) -> None:
        self._hist = hist
        self._t0 = 0.0

    def __enter__(self) -> "TimeRecorder":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self._hist is not None:
            self._hist.record((time.perf_counter() - self._t0) * 1e6)


class Registrar:
    """Process-wide registry of status handlers + histograms
    (reference concord::diagnostics::Registrar)."""

    def __init__(self) -> None:
        self._status: Dict[str, Callable[[], str]] = {}
        self._hists: Dict[str, PerfHistogram] = {}
        self._lock = threading.Lock()

    # status handlers
    def register_status(self, name: str, fn: Callable[[], str]) -> None:
        with self._lock:
            self._status[name] = fn

    def status_keys(self) -> List[str]:
        with self._lock:
            return sorted(self._status)

    def get_status(self, name: str) -> str:
        with self._lock:
            fn = self._status.get(name)
        if fn is None:
            return f"unknown status handler: {name}"
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — diag must not crash host
            return f"<status handler error: {e}>"

    # histograms
    def histogram(self, name: str, unit: str = "us") -> PerfHistogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = PerfHistogram(name, unit)
            return h

    def histogram_keys(self) -> List[str]:
        with self._lock:
            return sorted(self._hists)

    def histogram_snapshot(self, name: str) -> Optional[Dict]:
        with self._lock:
            h = self._hists.get(name)
        return h.snapshot() if h else None


_global = Registrar()


def get_registrar() -> Registrar:
    return _global
