"""Metrics components: counters / gauges / statuses with aggregation.

Port of tpubft/utils/metrics.py: named Components own counters, gauges
and statuses; an Aggregator snapshots all components to JSON. The UDP
metrics server and the Prometheus endpoint are not ported yet.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, Optional

from tpubft_torch.utils.racecheck import make_lock


class Counter:
    """Incremented from the dispatcher AND crypto worker threads (async
    verification), so the read-modify-write takes a lock."""
    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value = 0
        self._lock = make_lock("metrics.counter")   # leaf lock

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
