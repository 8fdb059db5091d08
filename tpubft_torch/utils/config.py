"""Replica configuration (port of tpubft/utils/config.py).

Ported: the topology fields, the quorum arithmetic (n = 3f + 2c + 1)
and the fields that `ClusterKeys` and the signature plane read. Field
names and defaults are the reference's, so a config serialised by one
package loads in the other as far as these fields go. The protocol
windows, state transfer, execution, durability, admission, offload,
tuning and read-tier fields wait for the replica core.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass
class ReplicaConfig:
    # identity / topology
    replica_id: int = 0
    f_val: int = 1                  # max byzantine replicas tolerated
    c_val: int = 0                  # max slow/crashed replicas for fast path
    num_of_client_proxies: int = 1
    num_ro_replicas: int = 0

    # requests per PrePrepare (RequestsBatchingLogic)
    max_num_of_requests_in_batch: int = 100

    # crypto: "cuda" runs the batched verifies on the card, "cpu" keeps
    # every verify on the host engines
    crypto_backend: str = "cuda"
    replica_sig_scheme: str = "ed25519"  # per-message replica signatures
    client_sig_scheme: str = "ed25519"
    # certificate (threshold) scheme: "multisig-ed25519" or "adaptive",
    # resolved once at key generation by cluster size
    # (crypto/systems.resolve_threshold_scheme)
    threshold_scheme: str = "adaptive"
    # n-crossover for "adaptive" (0 = the built-in default)
    threshold_scheme_crossover_n: int = 0
    share_aggregation: str = "off"      # "off" | "tree" | "gossip"

    # crypto batch dispatch (the device seam)
    verify_batch_size: int = 256
    verify_batch_flush_us: int = 200
    # max slots per fused combine flush
    combine_flush_us: int = 300
    combine_batch_max: int = 64
    # below this many signatures a batch verifies on the host verifiers
    # instead of paying a device launch (latency-critical singletons)
    device_min_verify_batch: int = 32

    # device circuit breaker (utils/breaker.py)
    breaker_failure_threshold: int = 3
    breaker_cooldown_ms: int = 2000
    breaker_latency_slo_ms: int = 0

    extra: Dict[str, Any] = field(default_factory=dict)

    # ---- derived quorum arithmetic ----
    @property
    def n_val(self) -> int:
        return 3 * self.f_val + 2 * self.c_val + 1

    @property
    def num_replicas(self) -> int:
        return self.n_val

    @property
    def slow_path_quorum(self) -> int:
        """2f + c + 1 matching prepare/commit shares (PBFT-style)."""
        return 2 * self.f_val + self.c_val + 1

    @property
    def fast_path_threshold_quorum(self) -> int:
        """3f + c + 1 shares for FAST_WITH_THRESHOLD."""
        return 3 * self.f_val + self.c_val + 1

    @property
    def optimistic_fast_quorum(self) -> int:
        """all n shares for OPTIMISTIC_FAST."""
        return self.n_val

    def validate(self) -> None:
        if self.replica_id >= self.n_val + self.num_ro_replicas:
            raise ValueError(
                f"replica_id {self.replica_id} out of range for "
                f"n={self.n_val} (+{self.num_ro_replicas} RO)")
        if self.f_val < 1:
            raise ValueError("f_val must be >= 1")
        if self.crypto_backend not in ("cuda", "cpu"):
            raise ValueError("crypto_backend must be cuda|cpu")
        if self.breaker_failure_threshold < 1:
            raise ValueError("breaker_failure_threshold must be >= 1")
        if self.threshold_scheme_crossover_n < 0:
            raise ValueError("threshold_scheme_crossover_n must be >= 0")
        if self.combine_batch_max < 1 or self.combine_flush_us < 0:
            raise ValueError("combine_batch_max must be >= 1 and "
                             "combine_flush_us >= 0")
        if self.share_aggregation not in ("off", "tree", "gossip"):
            raise ValueError("share_aggregation must be off|tree|gossip")

    # ---- serialization ----
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ReplicaConfig":
        return cls(**json.loads(s))
