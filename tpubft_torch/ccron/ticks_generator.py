"""TicksGenerator — the pacemaker submitting TickOps through consensus
(reference ccron/ticks_generator.cpp). Only the current primary submits,
to avoid n duplicate ticks per period; duplicates are harmless anyway
(CronTable deduplicates by tick_seq)."""
from __future__ import annotations

import time
from typing import Dict

from tpubft_torch.consensus.internal import TickOp, pack_op
from tpubft_torch.consensus.messages import RequestFlag


class TicksGenerator:
    def __init__(self, replica, cron_table) -> None:
        self._replica = replica
        self._table = cron_table
        self._periods: Dict[str, float] = {}
        self._last_sent: Dict[str, float] = {}

    def schedule(self, component: str, period_s: float) -> None:
        self._periods[component] = period_s

    def poll(self) -> None:
        """Dispatcher timer callback."""
        if not self._replica.is_primary:
            return
        now = time.monotonic()
        for component, period in self._periods.items():
            if now - self._last_sent.get(component, 0.0) < period:
                continue
            self._last_sent[component] = now
            op = TickOp(component=component,
                        tick_seq=self._table.last_tick(component) + 1)
            self._replica.internal_client.submit(
                pack_op(op), flags=int(RequestFlag.TICK))
