"""Cluster topology arithmetic.

Rebuild of the reference's ReplicasInfo
(concord-bft bftengine/src/bftengine/ReplicasInfo.hpp): replica/client
id ranges, primary-of-view, and collector selection for threshold shares.
"""
from __future__ import annotations

from dataclasses import dataclass

from tpubft_torch.utils.config import ReplicaConfig


@dataclass(frozen=True)
class ReplicasInfo:
    n: int
    f: int
    c: int
    num_ro: int = 0
    num_clients: int = 16

    @classmethod
    def from_config(cls, cfg: ReplicaConfig) -> "ReplicasInfo":
        return cls(n=cfg.n_val, f=cfg.f_val, c=cfg.c_val,
                   num_ro=cfg.num_ro_replicas,
                   num_clients=cfg.num_of_client_proxies)

    # ---- id ranges (reference convention: replicas, then RO, then clients)
    @property
    def replica_ids(self) -> range:
        return range(self.n)

    @property
    def first_client_id(self) -> int:
        return self.n + self.num_ro

    def is_replica(self, node: int) -> bool:
        return 0 <= node < self.n

    @property
    def ro_replica_ids(self) -> range:
        """Read-only replicas (reference ReadOnlyReplica): ST-only nodes
        squeezed between the voting set and the clients."""
        return range(self.n, self.n + self.num_ro)

    def is_ro_replica(self, node: int) -> bool:
        return self.n <= node < self.n + self.num_ro

    def is_client(self, node: int) -> bool:
        return node >= self.first_client_id

    # ---- internal clients (reference InternalBFTClient principals) ----
    @property
    def first_internal_client_id(self) -> int:
        return self.first_client_id + self.num_clients

    def internal_client_of(self, replica_id: int) -> int:
        return self.first_internal_client_id + replica_id

    def is_internal_client(self, node: int) -> bool:
        return (self.first_internal_client_id <= node
                < self.first_internal_client_id + self.n)

    def owner_of_internal_client(self, node: int) -> int:
        return node - self.first_internal_client_id

    @property
    def operator_id(self) -> int:
        """The operator principal (reconfiguration commands must carry its
        signature — reference: operator key validation in
        reconfiguration/src/reconfiguration_handler.cpp)."""
        return self.first_internal_client_id + self.n

    def all_client_ids(self) -> range:
        """External clients + one internal client per replica + operator.
        The id space is contiguous by construction (externals, then one
        internal per replica, then the operator), so the universe is a
        `range` — O(1) membership with O(1) memory, which is what keeps
        million-principal topologies from materializing million-entry
        sets in every consumer (ClientsManager, admission gates)."""
        return range(self.first_client_id, self.operator_id + 1)

    def other_replicas(self, me: int) -> list:
        return [r for r in self.replica_ids if r != me]

    # ---- roles ----
    def primary_of_view(self, view: int) -> int:
        return view % self.n

    def collector_for(self, view: int, seq_num: int) -> int:
        """Collector of threshold shares for (view, seq). The reference
        supports rotating collectors (getCollectorsForPartialProofs); the
        primary is the default collector."""
        return self.primary_of_view(view)

    # ---- quorums ----
    @property
    def slow_quorum(self) -> int:
        return 2 * self.f + self.c + 1

    @property
    def fast_threshold_quorum(self) -> int:
        return 3 * self.f + self.c + 1

    @property
    def optimistic_quorum(self) -> int:
        return self.n

    @property
    def checkpoint_quorum(self) -> int:
        """2f + c + 1 matching signed CheckpointMsgs make a checkpoint
        STABLE (reference CheckpointInfo.hpp MsgsCertificate): with at most
        f Byzantine confirmers, stability implies f+1 honest replicas hold
        the state, so the window can be GC'd safely. f+1 matching digests
        (st_anchor_quorum) are enough only as a state-transfer trust
        anchor — at least one honest signer vouches for the digest."""
        return 2 * self.f + self.c + 1

    @property
    def st_anchor_quorum(self) -> int:
        return self.f + 1

    @property
    def view_change_quorum(self) -> int:
        """2f + 2c + 1 ViewChangeMsgs form a new-view certificate
        (reference ViewsManager)."""
        return 2 * self.f + 2 * self.c + 1

    @property
    def complaint_quorum(self) -> int:
        """f + 1 ReplicaAsksToLeaveView complaints trigger a view change."""
        return self.f + 1
