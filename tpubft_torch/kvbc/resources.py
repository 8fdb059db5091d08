"""Resources manager — adaptive pruning rate from resource utilization
(a copy of tpubft/kvbc/resources.py).

Rebuild of the reference's resources-manager
(concord-bft kvbc/src/resources-manager/: IResourceManager's
``getPruneBlocksPerSecond`` driven by measured resource utilization): the
ledger must not grow without bound, but pruning competes with consensus
for I/O — so the recommended prune rate adapts to how busy the replica
is. Utilization sources are pluggable; the default tracks the add-block
rate (a busy chain prunes gently) and the ledger's block backlog
relative to a configured retention target (a deep backlog prunes
harder).

The consensus-coordinated prune decision stays where it is (the operator
PruneRequest / pruning handler); this component answers "how fast", the
role split the reference has between ResourceManager and the pruning
reserved-pages client.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional


@dataclass
class ResourceConfig:
    # desired retained history depth, in blocks
    retention_blocks: int = 10_000
    # prune-rate bounds (blocks/sec recommended to the operator/cron)
    min_prune_rate: float = 0.0
    max_prune_rate: float = 1000.0
    # consensus write rate (blocks/sec) considered "fully busy" — at or
    # above this, pruning backs off to min_prune_rate
    busy_add_rate: float = 200.0
    # sliding measurement window
    window_s: float = 10.0


class ResourceManager:
    """Thread-safe utilization tracker + prune-rate recommendation."""

    def __init__(self, config: Optional[ResourceConfig] = None) -> None:
        self.cfg = config or ResourceConfig()
        self._lock = threading.Lock()
        self._adds = []                # monotonic timestamps of add-block
        self._pruned = 0

    # ---- signals ----
    def on_block_added(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._adds.append(now)
            horizon = now - self.cfg.window_s
            while self._adds and self._adds[0] < horizon:
                self._adds.pop(0)

    def add_rate(self, now: Optional[float] = None) -> float:
        """Blocks/sec over the sliding window."""
        now = time.monotonic() if now is None else now
        with self._lock:
            horizon = now - self.cfg.window_s
            recent = [t for t in self._adds if t >= horizon]
            return len(recent) / self.cfg.window_s

    # ---- recommendation (IResourceManager::getPruneBlocksPerSecond) ----
    def prune_blocks_per_second(self, genesis_id: int, last_id: int,
                                now: Optional[float] = None) -> float:
        """Backlog pressure scaled down by write-path business."""
        backlog = max(0, (last_id - genesis_id) - self.cfg.retention_blocks)
        if backlog == 0:
            return self.cfg.min_prune_rate
        # pressure: how far past retention we are, saturating at 2x
        pressure = min(1.0, backlog / max(1, self.cfg.retention_blocks))
        # business: 0 (idle) .. 1 (fully busy)
        busy = min(1.0, self.add_rate(now) / self.cfg.busy_add_rate)
        rate = (self.cfg.min_prune_rate
                + (self.cfg.max_prune_rate - self.cfg.min_prune_rate)
                * pressure * (1.0 - busy))
        return max(self.cfg.min_prune_rate,
                   min(self.cfg.max_prune_rate, rate))

    def recommended_prune_until(self, genesis_id: int, last_id: int,
                                interval_s: float,
                                now: Optional[float] = None) -> int:
        """Prune target for one cron interval: genesis + rate*interval,
        clamped so retention is honored."""
        rate = self.prune_blocks_per_second(genesis_id, last_id, now)
        budget = int(rate * interval_s)
        ceiling = max(genesis_id, last_id - self.cfg.retention_blocks)
        return min(genesis_id + budget, ceiling)


def attach(blockchain, config: Optional[ResourceConfig] = None
           ) -> ResourceManager:
    """Wire a ResourceManager to a blockchain's commit stream."""
    rm = ResourceManager(config)
    blockchain.add_listener(lambda _bid, _updates: rm.on_block_added())
    return rm
