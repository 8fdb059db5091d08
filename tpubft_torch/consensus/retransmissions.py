"""Ack-tracked retransmission with dynamic per-destination timeouts.

Rebuild of the reference's RetransmissionsManager
(concord-bft bftengine/src/bftengine/RetransmissionsManager.cpp,
consumed via sendRetransmittableMsgToReplica, ReplicaImp.cpp:2531) and
its DynamicUpperLimitWithSimpleFilter RTT model: protocol messages whose
loss stalls consensus (shares to the collector, the primary's
PrePrepares, the collector's combined certificates) are tracked per
(destination, msg code, seqnum); the receiver acks with SimpleAckMsg;
unacked entries are re-sent with exponentially backed-off timeouts
derived from a per-destination RTT estimate, and dropped once the seqnum
stabilizes, the view changes, or attempts run out (at which point the
status-beacon gap resend and view-change liveness take over).

Acks are unauthenticated (as in the reference): a spoofed ack can only
suppress a retransmission — the same power a packet-dropping network
attacker already has; safety never depends on retransmission.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Tuple

from tpubft_torch.utils.logging import get_logger

log = get_logger("retransmissions")


class RttEstimator:
    """EWMA of observed ack round-trips with a clamped dynamic timeout
    (the DynamicUpperLimitWithSimpleFilter role)."""

    def __init__(self, min_timeout_s: float, max_timeout_s: float):
        self._min = min_timeout_s
        self._max = max_timeout_s
        self._ewma: float = 0.0
        self._have = False

    def observe(self, rtt_s: float) -> None:
        if not self._have:
            self._ewma, self._have = rtt_s, True
        else:
            self._ewma = 0.8 * self._ewma + 0.2 * rtt_s

    def timeout_s(self) -> float:
        if not self._have:
            return self._max / 4
        return min(self._max, max(self._min, 3.0 * self._ewma))


@dataclass
class _Entry:
    raw: bytes
    view: int
    first_sent: float
    next_due: float
    attempts: int = 0


class RetransmissionsManager:
    MAX_ATTEMPTS = 10
    MAX_TRACKED = 5000                 # memory bound (reference PARM)

    def __init__(self, comm, min_timeout_ms: int = 20,
                 max_timeout_ms: int = 1000):
        self._comm = comm
        self._min_s = min_timeout_ms / 1e3
        self._max_s = max_timeout_ms / 1e3
        # (dest, msg_code, seq) -> entry; mutated on the dispatcher thread
        self._entries: Dict[Tuple[int, int, int], _Entry] = {}
        self._rtt: Dict[int, RttEstimator] = {}
        self._lock = threading.Lock()
        self.total_retransmitted = 0

    def _est(self, dest: int) -> RttEstimator:
        est = self._rtt.get(dest)
        if est is None:
            est = self._rtt[dest] = RttEstimator(self._min_s, self._max_s)
        return est

    def track(self, dest: int, code: int, seq: int, view: int,
              raw: bytes, now: float) -> None:
        """Register a just-sent retransmittable message."""
        with self._lock:
            if len(self._entries) >= self.MAX_TRACKED:
                return
            self._entries[(dest, code, seq)] = _Entry(
                raw=raw, view=view, first_sent=now,
                next_due=now + self._est(dest).timeout_s())

    def on_ack(self, dest: int, code: int, seq: int, now: float) -> None:
        with self._lock:
            e = self._entries.pop((dest, code, seq), None)
            if e is not None and e.attempts == 0:
                # only un-retransmitted messages give a clean RTT sample
                self._est(dest).observe(now - e.first_sent)

    def tick(self, now: float) -> None:
        """Resend overdue entries (exponential backoff per attempt)."""
        due = []
        with self._lock:
            for key, e in self._entries.items():
                if now >= e.next_due:
                    e.attempts += 1
                    if e.attempts > self.MAX_ATTEMPTS:
                        due.append((key, None))
                        continue
                    backoff = self._est(key[0]).timeout_s() * (2 ** e.attempts)
                    e.next_due = now + min(backoff, self._max_s)
                    due.append((key, e.raw))
            for key, raw in due:
                if raw is None:
                    del self._entries[key]
        for (dest, code, seq), raw in due:
            if raw is not None:
                self.total_retransmitted += 1
                self._comm.send(dest, raw)

    def gc_stable(self, stable_seq: int) -> None:
        """A stabilized seqnum no longer needs its messages delivered."""
        with self._lock:
            for key in [k for k in self._entries if k[2] <= stable_seq]:
                del self._entries[key]

    def clear_view(self, view: int) -> None:
        """View changed: in-flight ordering messages of older views are
        dead letters."""
        with self._lock:
            for key in [k for k, e in self._entries.items()
                        if e.view < view]:
                del self._entries[key]

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._entries)

    def is_pending(self, dest: int, code: int, seq: int) -> bool:
        """True while a tracked send has not been acked — the aggregation
        fallback uses this as dead-parent evidence: a parent that acked
        the share is alive (the slot is just slow) and must not be
        routed around."""
        with self._lock:
            return (dest, code, seq) in self._entries
