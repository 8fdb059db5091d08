"""ControlStateManager — wedge/stop coordination for upgrades & reconfig.

Rebuild of the reference's ControlStateManager / EpochManager
(concord-bft bftengine/include/bftengine/EpochManager.hpp,
IControlHandler Replica.hpp:68): an ordered wedge command sets a stop
sequence; once execution reaches it the replica refuses to order beyond,
holding the whole cluster at an agreed point so operators can upgrade or
re-scale. The wedge point rides a reserved page, surviving crashes and
state transfer.
"""
from __future__ import annotations

from typing import Optional

from tpubft_torch.consensus.reserved_pages import ReservedPagesClient


class ControlStateManager:
    CATEGORY = "control"

    def __init__(self, pages: ReservedPagesClient) -> None:
        self._pages = pages
        self.wedge_point: Optional[int] = None
        self.restart_ready = False
        # 2f+c+1 replicas announced ReplicaRestartReadyMsg at the wedge
        # point — the operator's wrapper may safely restart the cluster
        self.restart_proof = False
        self.reload()

    def reload(self) -> None:
        raw = self._pages.load()
        self.wedge_point = (int.from_bytes(raw, "big")
                            if raw else None)

    def set_wedge_point(self, seq: int) -> None:
        self.wedge_point = seq
        self._pages.save(seq.to_bytes(8, "big"))

    def unwedge(self) -> None:
        self.wedge_point = None
        self.restart_ready = False
        self.restart_proof = False
        self._pages.delete()

    def blocks_ordering(self, seq: int) -> bool:
        """True if ordering `seq` would cross the wedge point."""
        return self.wedge_point is not None and seq > self.wedge_point

    def is_wedged(self, last_executed: int) -> bool:
        return self.wedge_point is not None \
            and last_executed >= self.wedge_point

    def mark_restart_ready(self) -> None:
        self.restart_ready = True

    def status(self) -> str:
        return (f"wedge_point={self.wedge_point} "
                f"restart_ready={self.restart_ready} "
                f"restart_proof={self.restart_proof}")
