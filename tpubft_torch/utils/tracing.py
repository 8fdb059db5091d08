"""Tracing — span propagation across the protocol pipeline.

Rebuild of the reference's OpenTracing integration
(concord-bft util/include/OpenTracing.hpp; span context embedded in
messages via MessageBase::spanContext<T>(), child spans per protocol
stage — ReplicaImp.cpp:409-413,1070): spans carry (trace_id, span_id,
parent) plus timing; contexts serialize to a compact string that rides
the ClientRequestMsg `cid` field, so one client request is joinable
across every replica's logs and span exports. The exporter is pluggable
(in-memory ring for tests, log line by default — Jaeger's role).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from tpubft_torch.utils.racecheck import make_lock


@dataclass
class SpanContext:
    trace_id: str
    span_id: str

    def serialize(self) -> str:
        return f"{self.trace_id}:{self.span_id}"

    @classmethod
    def parse(cls, s: str) -> Optional["SpanContext"]:
        parts = s.split(":")
        if len(parts) != 2 or not all(parts):
            return None
        return cls(trace_id=parts[0], span_id=parts[1])


@dataclass
class Span:
    name: str
    context: SpanContext
    parent_span_id: Optional[str]
    # durations are timed on the MONOTONIC clock: a wall-clock step
    # (NTP slew, operator date set) must never yield negative/garbage
    # span durations. `epoch` is the one wall-clock tag per span, taken
    # at start, for cross-replica alignment of exported traces.
    start: float = field(default_factory=time.monotonic)
    end: Optional[float] = None
    epoch: float = field(default_factory=time.time)
    tags: Dict[str, str] = field(default_factory=dict)
    _tracer: Optional["Tracer"] = field(default=None, repr=False,
                                        compare=False)

    def set_tag(self, k: str, v) -> "Span":
        self.tags[k] = str(v)
        return self

    @property
    def duration_s(self) -> Optional[float]:
        return None if self.end is None else self.end - self.start

    def finish(self) -> None:
        self.end = time.monotonic()
        if self._tracer is not None:
            self._tracer._export(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()


class Tracer:
    """Process tracer with a bounded in-memory export ring (exporters can
    be attached; the ring is what tests and the diagnostics server read)."""

    RING = 2048

    def __init__(self) -> None:
        self._lock = make_lock("tracer")
        self._ring: List[Span] = []
        self._exporters: List[Callable[[Span], None]] = []
        self._counter = 0

    def _next_id(self) -> str:
        with self._lock:
            self._counter += 1
            return f"{os.getpid():x}-{self._counter:x}"

    def start_span(self, name: str,
                   parent: Optional[SpanContext] = None,
                   trace_id: Optional[str] = None,
                   tags: Optional[Dict[str, object]] = None) -> Span:
        tid = (parent.trace_id if parent
               else trace_id if trace_id else self._next_id())
        ctx = SpanContext(trace_id=tid, span_id=self._next_id())
        span = Span(name=name, context=ctx,
                    parent_span_id=parent.span_id if parent else None,
                    _tracer=self)
        for k, v in (tags or {}).items():
            span.set_tag(k, v)
        return span

    def add_exporter(self, fn: Callable[[Span], None]) -> None:
        with self._lock:
            self._exporters.append(fn)

    def _export(self, span: Span) -> None:
        # exporters snapshotted under the same lock that add_exporter
        # appends under: a concurrent registration must never race the
        # list while a finishing span iterates it
        with self._lock:
            self._ring.append(span)
            if len(self._ring) > self.RING:
                del self._ring[:len(self._ring) - self.RING]
            exporters = list(self._exporters)
        for fn in exporters:
            try:
                fn(span)
            except Exception:  # noqa: BLE001 — exporters must not crash
                pass

    def finished_spans(self, trace_id: Optional[str] = None) -> List[Span]:
        with self._lock:
            spans = list(self._ring)
        if trace_id is not None:
            spans = [s for s in spans if s.context.trace_id == trace_id]
        return spans


_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer
