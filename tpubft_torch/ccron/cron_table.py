"""CronTable — per-component ordered actions fired on consensus ticks
(reference ccron/cron_table.cpp + periodic_action.cpp)."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from tpubft_torch.consensus.internal import TickOp
from tpubft_torch.consensus.reserved_pages import ReservedPagesClient

Action = Callable[[int], None]  # receives the tick sequence number


class CronTable:
    CATEGORY = "cron"

    def __init__(self, pages: Optional[ReservedPagesClient] = None) -> None:
        self._actions: Dict[str, List[Action]] = {}
        self._pages = pages
        self._last_tick: Dict[str, int] = {}

    def register(self, component: str, action: Action) -> None:
        self._actions.setdefault(component, []).append(action)

    def components(self) -> List[str]:
        return sorted(self._actions)

    def last_tick(self, component: str) -> int:
        if component in self._last_tick:
            return self._last_tick[component]
        if self._pages is not None:
            raw = self._pages.load(index=self._page_index(component))
            if raw:
                self._last_tick[component] = int.from_bytes(raw, "big")
                return self._last_tick[component]
        return 0

    def reload(self) -> None:
        """Drop the in-memory tick cache so reads fall through to the
        (possibly state-transfer-installed) reserved page."""
        self._last_tick.clear()

    def _page_index(self, component: str) -> int:
        # stable index per component, registration-order agnostic; 32-bit
        # hash space makes accidental collisions negligible
        import hashlib
        return int.from_bytes(
            hashlib.sha256(component.encode()).digest()[:4], "big")

    def on_tick(self, op: TickOp) -> None:
        """Executed on EVERY replica at the same consensus position."""
        if op.tick_seq <= self.last_tick(op.component):
            return  # duplicate/old tick (retransmission): exactly-once
        self._last_tick[op.component] = op.tick_seq
        if self._pages is not None:
            self._pages.save(op.tick_seq.to_bytes(8, "big"),
                             index=self._page_index(op.component))
        for action in self._actions.get(op.component, []):
            action(op.tick_seq)
