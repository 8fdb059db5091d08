"""Metrics components: counters / gauges / statuses with aggregation.

Port of tpubft/utils/metrics.py (concordMetrics,
util/include/Metrics.hpp): named Components own counters, gauges, and
statuses; an Aggregator snapshots all components to JSON. A
lightweight UDP metrics server (reference util/include/MetricsServer.hpp:46)
serves snapshots to test harnesses (testing/network.MetricsClient polls
it). The Prometheus endpoint is ROADMAP A.9.5.
"""
from __future__ import annotations

import json
import socket
import threading
import time
from collections import deque
from typing import Dict, Optional

from tpubft_torch.utils.racecheck import make_lock


class Meter:
    """Trailing-window rate estimator behind throughput gauges
    (st_blocks_per_sec / st_bytes_per_sec): mark(n) on the hot path,
    rate() -> events per second over the last `window_s` seconds. Marked
    from the dispatcher thread, read by metric scrapers — locked like
    Counter."""

    __slots__ = ("_window", "_events", "_lock")

    def __init__(self, window_s: float = 5.0) -> None:
        self._window = window_s
        self._events: deque = deque()        # (monotonic ts, n)
        # make_lock (not a raw threading.Lock) so the tpulint
        # static-race pass and the runtime lock-order graph both see
        # it; a leaf lock — nothing is acquired while it is held
        self._lock = make_lock("metrics.meter")

    def _trim(self, now: float) -> None:
        horizon = now - self._window
        while self._events and self._events[0][0] < horizon:
            self._events.popleft()

    def mark(self, n: int = 1) -> None:
        now = time.monotonic()
        with self._lock:
            self._events.append((now, n))
            self._trim(now)

    def rate(self) -> float:
        now = time.monotonic()
        with self._lock:
            self._trim(now)
            if not self._events:
                return 0.0
            total = sum(n for _, n in self._events)
            span = max(now - self._events[0][0], 0.05)
            return total / span


class Counter:
    """Incremented from the dispatcher AND crypto worker threads (async
    verification), so the read-modify-write takes a lock."""
    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value = 0
        self._lock = make_lock("metrics.counter")   # leaf lock (see Meter)

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self, v: int = 0) -> None:
        self.value = v

    def set(self, v: int) -> None:
        self.value = v


class Status:
    __slots__ = ("value",)

    def __init__(self, v: str = "") -> None:
        self.value = v

    def set(self, v: str) -> None:
        self.value = v


class Component:
    """A named bundle of metrics, registered with an Aggregator."""

    def __init__(self, name: str, aggregator: Optional["Aggregator"] = None):
        self.name = name
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.statuses: Dict[str, Status] = {}
        if aggregator is not None:
            aggregator.register(self)

    def register_counter(self, name: str) -> Counter:
        return self.counters.setdefault(name, Counter())

    def register_gauge(self, name: str, v: int = 0) -> Gauge:
        return self.gauges.setdefault(name, Gauge(v))

    def register_status(self, name: str, v: str = "") -> Status:
        return self.statuses.setdefault(name, Status(v))

    def snapshot(self) -> Dict:
        return {
            "counters": {k: c.value for k, c in self.counters.items()},
            "gauges": {k: g.value for k, g in self.gauges.items()},
            "statuses": {k: s.value for k, s in self.statuses.items()},
        }


class Aggregator:
    def __init__(self) -> None:
        self._components: Dict[str, Component] = {}
        self._lock = threading.Lock()

    def register(self, c: Component) -> None:
        with self._lock:
            self._components[c.name] = c

    def get(self, component: str, kind: str, name: str):
        with self._lock:
            c = self._components[component]
        return c.snapshot()[kind][name]

    def snapshot(self) -> Dict:
        with self._lock:
            return {name: c.snapshot() for name, c in self._components.items()}

    def to_json(self) -> str:
        return json.dumps({"ts": time.time(), "components": self.snapshot()})


class UdpMetricsServer:
    """Serves aggregator JSON snapshots over UDP — any datagram gets a
    reply ("metrics" by the harness's poll, "ping" by a readiness gate).

    Mirrors the reference's UDP metrics server that the Apollo harness
    polls (util/include/MetricsServer.hpp:46, tests/apollo/util/
    bft_metrics.py); the same reply bytes as tpubft/utils/metrics.py:144-182.
    """

    def __init__(self, aggregator: Aggregator, port: int = 0,
                 host: str = "127.0.0.1"):
        self._agg = aggregator
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host, port))
        self._sock.settimeout(0.2)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                _, addr = self._sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                self._sock.sendto(self._agg.to_json().encode(), addr)
            except OSError:
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        self._sock.close()
