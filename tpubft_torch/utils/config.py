"""Replica configuration registry.

Rebuild of the reference's ReplicaConfig
(concord-bft bftengine/include/bftengine/ReplicaConfig.hpp:28-89): a
declarative parameter registry with defaults, descriptions, serialization,
and derived quorum arithmetic (n = 3f + 2c + 1).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


# identity/topology fields have dedicated CLI flags on every binary and
# feed key generation + endpoint tables from argv — overriding them
# through the generic escape hatch would silently desync those
_TOPOLOGY_FIELDS = frozenset({
    "replica_id", "f_val", "c_val", "num_ro_replicas",
    "num_of_client_proxies", "is_read_only"})


def parse_config_overrides(pairs) -> Dict[str, Any]:
    """--config-override key=value (repeatable): any non-topology
    ReplicaConfig field, coerced to the field's declared type. The
    generic escape hatch so new tunables never need a dedicated flag to
    reach replica processes."""
    types = {f.name: f.type for f in dataclasses.fields(ReplicaConfig)}
    out: Dict[str, Any] = {}
    for pair in pairs or []:
        key, sep, val = pair.partition("=")
        if not sep or key not in types:
            raise SystemExit(f"--config-override: unknown or malformed "
                             f"'{pair}' (want <ReplicaConfig field>=<value>)")
        if key in _TOPOLOGY_FIELDS:
            raise SystemExit(f"--config-override: '{key}' is a topology "
                             f"field — use its dedicated flag (keys and "
                             f"endpoint tables are derived from argv)")
        t = types[key]
        if t in ("int", int):
            out[key] = int(val)
        elif t in ("float", float):
            out[key] = float(val)
        elif t in ("bool", bool):
            out[key] = val.lower() in ("1", "true", "yes", "on")
        elif t in ("str", str):
            out[key] = val
        else:
            # an unrecognized declared type must fail at parse time, not
            # surface as a str/type mismatch deep inside the replica
            raise SystemExit(f"--config-override: field '{key}' has "
                             f"unsupported type {t!r}")
    return out


@dataclass
class ReplicaConfig:
    """All tunables for one replica. Field docs mirror the reference params."""

    # identity / topology
    replica_id: int = 0
    f_val: int = 1                  # max byzantine replicas tolerated
    c_val: int = 0                  # max slow/crashed replicas for fast path
    num_of_client_proxies: int = 1
    num_ro_replicas: int = 0
    is_read_only: bool = False

    # batching (RequestsBatchingLogic equivalents)
    max_num_of_requests_in_batch: int = 100
    max_batch_size_bytes: int = 33_554_432
    batch_flush_period_ms: int = 7

    # protocol windows/timers
    # max consensus slots proposed-but-not-executed (the PrePrepare
    # pipeline gate; under load this is also what forms request batches).
    # Reference: ReplicaConfig.hpp concurrencyLevel, SKVBC tester
    # replica default 3 (tests/simpleKVBC/TesterReplica/setup.cpp:72)
    concurrency_level: int = 3
    view_change_timer_ms: int = 4000
    status_report_timer_ms: int = 1000
    checkpoint_window_size: int = 150   # seqnums between protocol checkpoints
    work_window_size: int = 300         # in-flight seqnum window (2 checkpoints)
    max_reply_size_bytes: int = 1_048_576

    # state transfer
    st_stall_timeout_ms: int = 5000     # certified checkpoint ahead + no
                                        # execution progress -> fetch state

    # commit paths
    fast_path_timeout_ms: int = 300     # demote in-flight seq to slow path
    auto_primary_rotation_enabled: bool = False
    view_change_protocol_enabled: bool = True
    pre_execution_enabled: bool = False
    # backup-side pre-execution reply cache (preprocessor/preprocessor.py
    # _reply_cache): bounded LRU of packed PreProcessReplyMsg so a
    # primary's rebroadcast is answered from cache instead of
    # re-executing the handler. Sized like the SigManager verify memo:
    # big enough to cover in-flight sessions x retries, small enough
    # that real client traffic cannot grow it without bound.
    preexec_reply_cache_max: int = 512
    # pre-execution worker pool width (backup + primary speculative
    # executions run here, off the dispatcher)
    preexec_threads: int = 4

    # thin-replica read tier (thinreplica/server.py): serve state reads,
    # merkle proofs, and live update subscriptions off the consensus
    # path, fed once per sealed execution run from the ledger's
    # durable-apply seam. Requires a blockchain-backed handler —
    # silently inactive otherwise.
    thin_replica_enabled: bool = False
    # TCP port for the thin-replica listener (0 = ephemeral; in-process
    # clusters discover the bound port via replica.thin_replica.port)
    thin_replica_port: int = 0
    # per-subscriber live-update buffer (runs, not blocks): a subscriber
    # lagging more than this many sealed runs is dropped (it
    # re-subscribes and catches up from history) — see
    # trs_dropped_subscribers / trs_overflows
    thin_replica_sub_buffer: int = 1024
    time_service_enabled: bool = False
    time_max_skew_ms: int = 1000
    key_exchange_on_start: bool = False

    # crypto
    # Port divergence (reference config.py:125-127): "cuda" (the
    # default) runs the batched verifies on the card, "cpu" keeps every
    # verify on the host engines, and "auto" means "cuda" — no probe and
    # no CPU fallback (crypto/backend.py)
    crypto_backend: str = "cuda"        # "cuda" | "cpu" | "auto"
    kvbc_version: str = "categorized"   # ledger engine: "categorized" | "v4"
    # fsync every DB write batch. Default matches the reference's RocksDB
    # WriteOptions (sync=false): process-crash consistency comes from the
    # OS page cache + record CRCs (torn-tail recovery); a host power loss
    # may lose the newest suffix. Profiling: True costs ~7 fsyncs (~8ms)
    # per consensus op per replica.
    db_sync_writes: bool = False
    # even with db_sync_writes=False, batches touching the CONSENSUS
    # METADATA families (view/prepared/checkpoint descriptors) still
    # fsync: losing a prepare this replica already voted on is a safety
    # hazard under correlated power loss, while block data is always
    # re-derivable from the quorum via state transfer. False = nothing
    # syncs (benchmarking escape hatch).
    db_sync_metadata: bool = True
    replica_sig_scheme: str = "ed25519"  # per-message replica signatures
    client_sig_scheme: str = "ed25519"
    # certificate (threshold) scheme: "multisig-ed25519", "threshold-bls",
    # or "adaptive" — resolved ONCE at key generation by cluster size:
    # below the crossover the Ed25519 multisig vector (no G1 ladder math
    # at all), at/above it compact BLS threshold certificates
    # (crypto/systems.resolve_threshold_scheme; the EdDSA-vs-BLS
    # committee measurements, arXiv 2302.00418, quantify the tradeoff)
    threshold_scheme: str = "adaptive"
    # n-crossover for "adaptive" (0 = the built-in default measured by
    # benchmarks/bench_combine.py --crossover). Every replica of a
    # cluster must configure the same value — the resolved scheme is
    # part of the cluster key material
    threshold_scheme_crossover_n: int = 0
    client_transaction_signing_enabled: bool = True

    # crypto batch dispatch (device seam)
    verify_batch_size: int = 256
    verify_batch_flush_us: int = 200
    # fused cross-slot combine plane (consensus/collectors.CombineBatcher):
    # due collectors across seqnums and kinds drain into ONE
    # combine_batch call per flush (BLS: one segmented multi-MSM launch
    # + one RLC pairing check for the whole batch) instead of one
    # combine job per slot. False = the legacy per-collector job path
    # (A/B control for bench_combine / bench_e2e pairing runs).
    fused_combine: bool = True
    # flush window / max slots per fused combine flush. The window
    # bounds added commit latency on an idle replica; under pipelined
    # load the batch fills first (see docs/OPERATIONS.md "Certificate
    # schemes & combine batching" for tuning)
    combine_flush_us: int = 300
    combine_batch_max: int = 64
    # share-aggregation overlay (arXiv 1911.04698): "off" =
    # every replica sends its Prepare/Commit shares straight to the
    # slot's collector (the O(n) fan-in path, byte-identical to the
    # pre-aggregation protocol); "tree" = shares climb a deterministic
    # view-seeded fanout tree rooted at the collector, interior nodes
    # forwarding 56-byte partial aggregates so the collector's inbound
    # share traffic drops to O(fanout); "gossip" = same overlay but
    # re-seeded every `agg_rotate_seqs` sequence numbers as well as per
    # view, so a slow interior node rotates out mid-view. Requires the
    # adaptive scheme (which resolves to "multisig-bls" when this is
    # on) or an explicit "multisig-bls" — Shamir threshold shares
    # cannot partially aggregate. Every replica of a cluster MUST
    # configure the same mode: the overlay shape is derived
    # deterministically, never negotiated on the wire.
    share_aggregation: str = "off"      # "off" | "tree" | "gossip"
    # overlay fanout (children per interior node). WIRE-VISIBLE and
    # pinned (never autotuned): every replica derives parent/children
    # from (n, fanout, view), so per-replica drift would fragment the
    # overlay — shares forwarded to a node that doesn't consider itself
    # the sender's parent would still aggregate (partials are
    # self-describing) but the O(fanout) bound and the timeout
    # accounting would be lost. See tuning/wiring.py.
    agg_fanout: int = 4
    # how long a non-root replica waits for its subtree's slot to reach
    # a full certificate before re-sending its own share DIRECT to the
    # collector (the all-to-all fallback: a dead/slow interior
    # aggregator costs one timeout, never liveness)
    agg_parent_timeout_ms: int = 250
    # how long an interior node holds a partially-filled aggregation
    # buffer before flushing what it has up the tree (bounds the
    # latency a straggler child can add at each level)
    agg_flush_ms: int = 30
    # "gossip" mode: re-seed the overlay permutation every this many
    # sequence numbers (rotation cadence within a view)
    agg_rotate_seqs: int = 16
    # below this many signatures a batch verifies on the CPU verifiers
    # instead of paying a device dispatch (latency-critical singletons)
    device_min_verify_batch: int = 32
    # hot-path verifications (client sigs at PrePrepare, combined-cert
    # checks) run as background jobs re-entering the dispatcher as
    # internal msgs (reference: RequestThreadPool +
    # CombinedSigVerificationJob); False = verify inline (debug only)
    async_verification: bool = True

    # bounded client table (million-principal client plane): max client
    # records resident in ClientsManager. Cold clients demand-page back
    # from their reply-ring reserved pages under an LRU (clients with
    # in-flight requests are pinned); the pager replays the per-client
    # restart rule, so at-most-once dedup survives an evict/reload
    # cycle exactly as it survives a restart. Autotuner-registered.
    # 0 = legacy unbounded table with eager boot restore (every client
    # O(1) resident forever — test-cluster shape only).
    client_table_max: int = 4096

    # admission pipeline (transport → dispatcher): >0 = a pool of that
    # many admission workers does all stateless per-message work off
    # the dispatcher — header peek (dead-view/stale-seq/garbage drops
    # before full unpack), parse, and signature verification coalesced
    # into ONE SigManager.verify_batch per drain cycle (one device
    # dispatch on the CUDA backend); the dispatcher's external queue
    # then carries pre-parsed, pre-verified messages and its handlers
    # only mutate state. 0 = legacy inline path (raw bytes to the
    # dispatcher, parse/verify in the handlers).
    admission_workers: int = 1
    # max messages one admission drain cycle pulls from the ingest
    # queue (bounds verify-batch size and admission latency)
    admission_drain_max: int = 256
    # key-sharded admission routing: with >1 admission workers, client
    # datagrams route to a fixed worker by a stable hash of the wire
    # principal, so each worker's verify batches / signature memo /
    # per-principal comb caches see a disjoint, stable slice of the key
    # population (cache hit-rates hold as principals scale instead of
    # being diluted across every worker). Protocol-critical and
    # consensus traffic stays on the shared queues. False = legacy
    # shared-buffer draining (the A/B control; ledgers are
    # byte-identical either way).
    admission_key_sharding: bool = True
    # overload backpressure: when the admission ingest queue reaches the
    # high watermark the plane enters shed mode — fresh client requests
    # (ClientRequest/ClientBatch datagrams) are dropped at ingest (each
    # counted in adm_shed_overload) until depth falls back to the low
    # watermark. Protocol-critical traffic (view-change family,
    # checkpoints, state transfer, restart votes) rides a separate
    # priority queue that shedding never touches and workers drain
    # first, so an overloaded replica keeps participating in liveness
    # machinery while client goodput is shed. high = 0 disables
    # watermark shedding (the hard ingest bound remains).
    admission_high_watermark: int = 15000
    admission_low_watermark: int = 5000

    # device circuit breaker (tpubft/utils/breaker.py — process-wide,
    # wrapped around every device kernel seam): trip OPEN after this
    # many CONSECUTIVE device failures, fast-failing callers into the
    # scalar/host engines
    breaker_failure_threshold: int = 3
    # how long an OPEN breaker waits before letting one half-open probe
    # batch re-test the device (doubles on failed probes, up to 16x)
    breaker_cooldown_ms: int = 2000
    # latency SLO: a device dispatch slower than this classifies as a
    # failure even when it succeeds (a wedging accelerator transport
    # turns slow long before it raises). 0 disables the classifier —
    # the default, because first-dispatch XLA compiles legitimately
    # take seconds; enable post-warmup or with a compile-clearing value.
    breaker_latency_slo_ms: int = 0

    # verified crypto-offload tier (tpubft/offload/): lease
    # BLS MSM/combine work and the ECDSA RLC fold to non-voting helper
    # processes, re-verifying every result on-replica with the 2G2T
    # constant-size soundness check before it can touch a verdict. A
    # lying helper is quarantined (operator reset required); a slow or
    # dead one cools down and is probe re-admitted. Off = the tier
    # doesn't exist; on, the autotuner's `offload_route` knob still
    # routes work helper-ward only while measured lease latency beats
    # the local per-item cost.
    offload_enabled: bool = False
    # comma-separated helper endpoints "id=host:port[,id=host:port...]"
    # (in-process tests register transports on the pool directly)
    offload_helpers: str = ""
    # lease deadline: a helper that misses it is SICK (cooldown+probe);
    # the lease retries once on another helper, then runs locally
    offload_lease_timeout_ms: int = 200
    # concurrent leases in flight across the pool; at the cap, work
    # runs locally instead of queueing behind the fleet
    offload_max_inflight: int = 4

    # health plane (tpubft/consensus/health.py): poll cadence of the
    # watchdog thread and the stall threshold for the dispatcher /
    # admission probes (the execution lane uses
    # execution_drain_timeout_ms; state transfer uses st_stall_timeout_ms
    # scaled by its retry machinery)
    health_poll_ms: int = 1000
    health_stall_ms: int = 5000

    # closed-loop autotuner (tpubft/tuning/): a per-replica controller
    # thread drives the performance knobs above (flush windows, batch
    # caps, accumulation depth, admission watermarks, the ECDSA
    # device/host crossover) from live telemetry — kernel-profiler
    # batch stats, flight-recorder stage breakdown, breaker/health
    # verdicts — within hard bounds, with per-knob hysteresis and
    # cooldown. The ReplicaConfig values stay the DEFAULTS every knob
    # backs off to whenever the health verdict leaves `healthy` or a
    # breaker opens (the controller never fights the degradation
    # plane). False = every knob stays exactly at its configured value.
    autotune_enabled: bool = True
    # controller poll cadence; each poll snapshots telemetry and casts
    # one policy vote per knob
    autotune_interval_ms: int = 1000
    # minimum interval between moves of any one knob (with the 2-vote
    # hysteresis this bounds how fast tuning can ramp — and how fast a
    # bad policy could wander)
    autotune_cooldown_ms: int = 3000
    # knob-registry seed file (JSON, written by e.g.
    # `bench_msm_crossover --ecdsa --seed-out`): measured operating
    # points loaded — and re-baselined as the degraded-reset defaults —
    # before the controller starts. "" = no seed.
    autotune_seed_file: str = ""

    # execution pipelining (reference: post-execution separation +
    # block accumulation). True = committed slots are executed by a
    # dedicated in-order executor thread that accumulates runs of
    # consecutive slots into ONE ledger commit + ONE reserved-pages
    # batch per run, keeping the dispatcher free to order the next
    # slots; False = the legacy inline path (execution on the
    # dispatcher, one commit per slot).
    execution_lane: bool = True
    # max committed slots coalesced into one execution run / ledger
    # commit. Runs always break at checkpoint-window boundaries so
    # state digests stay comparable cluster-wide. 1 degenerates to
    # per-slot commits (still off the dispatcher).
    execution_max_accumulation: int = 16
    # how long the dispatcher-side barrier (view-change send/entry,
    # state-transfer adoption, wedge/barrier batches) waits for the
    # lane to apply every submitted slot before giving up and retrying
    # on the next event. The health watchdog uses the same budget as
    # the lane's stall threshold, so a drain that would time out is
    # reported (stack dump + verdict) instead of silently eaten.
    execution_drain_timeout_ms: int = 30000
    # group-commit durability pipeline (tpubft/durability/): the
    # execution lane SEALS each run's ledger WriteBatch + reply pages
    # into a dedicated io thread that group-commits across runs — one
    # concatenated apply + ONE fsync per group — and publishes a
    # monotone durability watermark; replies, last_executed and the
    # at-most-once reply cache advance only behind it. The consensus-
    # metadata carve-out (db_sync_metadata) stays synchronous on the
    # dispatcher. Requires the execution lane; False = the legacy
    # per-run apply with immediate completion.
    durability_pipeline: bool = True
    # max runs fsynced per group (1 degenerates to the per-run durable
    # apply — the bench_e2e --durability-off A/B control's shape)
    durability_group_max: int = 8
    # how long the io thread holds a partial group open for more runs,
    # measured from the group's FIRST sealed run (bounds the extra
    # reply latency durability batching can add; autotuned live)
    durability_window_us: int = 1000
    # speculative execution ahead of the threshold combine: the
    # dispatcher hands a slot to the execution lane as SPECULATIVE at
    # prepare-quorum (slow path) or PrePrepare acceptance (fast paths,
    # which have no prepare round), so the lane executes it inside an
    # open, never-durable accumulation while the commit shares are
    # still combining; the run is sealed (one durable apply) only when
    # the commit certificate lands with the same digest, and replies +
    # last_executed stay strictly post-commit. View change, barrier
    # batches, and state-transfer adoption abort the overlay and the
    # slot re-executes from its committed body. Requires the execution
    # lane, an accumulation-capable ledger handler, and the time
    # service off (its page writes bypass the rollback substrate) —
    # silently inactive otherwise. False = legacy strictly-post-commit
    # execution.
    speculative_execution: bool = True
    # optimistic reply plane (arXiv 2407.12172): serve clients from f+1
    # matching INDIVIDUALLY-SIGNED replies instead of waiting for the
    # threshold certificate. With this on, a backup releases a slot to
    # the execution/durability pipeline as soon as a structurally-bound
    # commit certificate arrives over a VERIFIED prepare quorum (slow
    # path) or fast-path proposal — the expensive pairing check of the
    # combined signature completes asynchronously off the reply path —
    # and every ClientReplyMsg carries the replica's own signature so
    # the client's f+1 matcher can authenticate each vote. The compact
    # certificate still forms on the unchanged combine/aggregation path
    # (checkpointing, state transfer, audit), and `last_executed`
    # PERSISTENCE stays gated on verified commits (the optimistic
    # window is reply-visibility only). A certificate that fails its
    # deferred check poisons the optimistic plane for the rest of the
    # view (certificate-gated replies resume). Requires the execution
    # lane + speculation substrate to pay off; without them replies
    # simply stay certificate-gated.
    optimistic_replies: bool = False

    # retransmissions
    retransmissions_enabled: bool = True
    retransmission_timer_ms: int = 50

    # state transfer fetch pipeline (StConfig wiring — kvbc/replica.py):
    # ranges of `state_transfer_batch_blocks` blocks, up to
    # `st_window_ranges` ranges in flight striped across live sources,
    # blocks chunked at `max_block_chunk_bytes` on the wire (must clear
    # the transport datagram limit), completed windows of >=
    # `st_device_digest_threshold` blocks digest-verified as one device
    # batch
    max_block_chunk_bytes: int = 24 * 1024
    state_transfer_batch_blocks: int = 64
    st_window_ranges: int = 4
    st_device_digest_threshold: int = 16

    # key exchange
    key_exchange_on_start: bool = False

    extra: Dict[str, Any] = field(default_factory=dict)

    # ---- derived quorum arithmetic (ReplicaConfig.hpp numReplicas etc.) ----
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
                f"replica_id {self.replica_id} out of range for n={self.n_val} "
                f"(+{self.num_ro_replicas} RO)")
        if self.f_val < 1:
            raise ValueError("f_val must be >= 1")
        if self.crypto_backend not in ("cuda", "cpu", "auto"):
            raise ValueError("crypto_backend must be cuda|cpu|auto")
        if self.work_window_size % self.checkpoint_window_size != 0:
            raise ValueError("work window must be a multiple of checkpoint window")
        if self.execution_max_accumulation < 1:
            raise ValueError("execution_max_accumulation must be >= 1")
        if self.admission_workers < 0:
            raise ValueError("admission_workers must be >= 0")
        if self.client_table_max < 0:
            raise ValueError("client_table_max must be >= 0")
        if self.admission_drain_max < 1:
            raise ValueError("admission_drain_max must be >= 1")
        if self.admission_high_watermark \
                and not 0 < self.admission_low_watermark \
                < self.admission_high_watermark:
            raise ValueError("need 0 < admission_low_watermark < "
                             "admission_high_watermark (or high = 0 to "
                             "disable overload shedding)")
        if self.execution_drain_timeout_ms < 1:
            raise ValueError("execution_drain_timeout_ms must be >= 1")
        if self.durability_group_max < 1:
            raise ValueError("durability_group_max must be >= 1")
        if self.durability_window_us < 0:
            raise ValueError("durability_window_us must be >= 0")
        if self.breaker_failure_threshold < 1:
            raise ValueError("breaker_failure_threshold must be >= 1")
        if self.offload_lease_timeout_ms < 1:
            raise ValueError("offload_lease_timeout_ms must be >= 1")
        if self.offload_max_inflight < 1:
            raise ValueError("offload_max_inflight must be >= 1")
        for ep in filter(None, self.offload_helpers.split(",")):
            if "=" not in ep or ":" not in ep.split("=", 1)[1]:
                raise ValueError(
                    f"offload_helpers entry {ep!r} must be id=host:port")
        if self.health_poll_ms < 1 or self.health_stall_ms < 1:
            raise ValueError("health_poll_ms/health_stall_ms must be >= 1")
        if self.autotune_interval_ms < 10:
            raise ValueError("autotune_interval_ms must be >= 10")
        if self.autotune_cooldown_ms < 0:
            raise ValueError("autotune_cooldown_ms must be >= 0")
        if self.threshold_scheme_crossover_n < 0:
            raise ValueError("threshold_scheme_crossover_n must be >= 0")
        if self.combine_batch_max < 1 or self.combine_flush_us < 0:
            raise ValueError("combine_batch_max must be >= 1 and "
                             "combine_flush_us >= 0")
        if self.share_aggregation not in ("off", "tree", "gossip"):
            raise ValueError("share_aggregation must be off|tree|gossip")
        if self.share_aggregation != "off":
            if self.threshold_scheme not in ("adaptive", "multisig-bls"):
                raise ValueError(
                    "share_aggregation requires threshold_scheme adaptive "
                    "(resolves to multisig-bls) or multisig-bls — Shamir "
                    "threshold shares cannot partially aggregate")
            if self.n_val > 64:
                raise ValueError("share_aggregation contributor bitmaps "
                                 "are u64 (n <= 64)")
        if self.agg_fanout < 2:
            raise ValueError("agg_fanout must be >= 2")
        if self.agg_parent_timeout_ms < 1 or self.agg_flush_ms < 0 \
                or self.agg_rotate_seqs < 1:
            raise ValueError("agg_parent_timeout_ms must be >= 1, "
                             "agg_flush_ms >= 0, agg_rotate_seqs >= 1")
        if self.preexec_reply_cache_max < 1:
            raise ValueError("preexec_reply_cache_max must be >= 1")
        if self.preexec_threads < 1:
            raise ValueError("preexec_threads must be >= 1")
        if self.thin_replica_sub_buffer < 1:
            raise ValueError("thin_replica_sub_buffer must be >= 1")
        if not 0 <= self.thin_replica_port <= 65535:
            raise ValueError("thin_replica_port must be a valid TCP port")

    # ---- serialization ----
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ReplicaConfig":
        return cls(**json.loads(s))

    def describe(self) -> Dict[str, str]:
        return {f.name: str(getattr(self, f.name)) for f in dataclasses.fields(self)}
