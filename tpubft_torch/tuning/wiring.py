"""The per-replica knob catalog — ReplicaConfig seeds the defaults,
the registry owns the values from then on (port of
tpubft/tuning/wiring.py).

`build_replica_tuning(replica, cfg)` registers every live actuator the
replica exposes and binds each to its seam:

  ====================================  ==================================
  knob                                  actuator seam
  ====================================  ==================================
  verify_batch_flush_us                 BatchVerifier + CertBatchVerifier
                                        flush windows (FlushBatcher)
  verify_batch_size                     BatchVerifier batch cap
  combine_flush_us / combine_batch_max  CollectorPool → CombineBatcher
  execution_max_accumulation            ExecutionLane run-coalescing cap
  admission_high_watermark              AdmissionPipeline shed watermarks
                                        (low follows at high/3)
  ecdsa_crossover_b                     crypto/cuda.set_ecdsa_crossover
                                        (process-wide, like the device)
  device_min_verify_batch               SigManager.device_min_batch
  st_window_ranges                      StConfig.window_ranges (late-
                                        bound; kvbc attaches ST after
                                        construction)
  breaker_cooldown_ms                   device breaker configure()
  agg_fanout                            replica._agg_fanout (overlay
                                        edges; PIN-ONLY, wire-visible)
  ====================================  ==================================

Knobs with a policy move from live telemetry; the rest are
catalog/pin/seed surfaces (and still reset on degradation).
`combine_batch_max` and `agg_fanout` are additionally WIRE-VISIBLE:
they shape bytes other replicas must reproduce (certificate contributor
sets, overlay edges), so they are catalog/pin-only by design — no
policy is ever attached, and operators change them cluster-wide. The seed
file (`ReplicaConfig.autotune_seed_file`, written back by the controller
on a clean shutdown) re-baselines measured knobs before the controller
starts.

The mesh knob `crypto_shard_count` is registered where the slot
inventory has more than one slot (ops/dispatch.crypto_mesh). Port
divergence, marked where it sits: the offload counters are read from the
port's own pool.
"""
from __future__ import annotations

from tpubft_torch.tuning.controller import TuningController
from tpubft_torch.tuning.knobs import Knob, KnobRegistry, load_seed
from tpubft_torch.tuning.policies import (admission_watermark_policy,
                                          batch_amortize_policy,
                                          breaker_readmission_policy,
                                          client_table_policy,
                                          crypto_shard_policy,
                                          device_min_batch_policy,
                                          durability_amortize_policy,
                                          ecdsa_crossover_policy,
                                          exec_accumulation_policy,
                                          offload_routing_policy,
                                          optimistic_combine_policy,
                                          st_window_policy)
from tpubft_torch.utils import flight
from tpubft_torch.utils.logging import get_logger

log = get_logger("tuning")

# registry bound caps (operator bounds live per knob; these are the
# hard rails a policy can never leave)
MAX_FLUSH_US = 20_000
MAX_BATCH = 8192
MAX_ACCUMULATION = 128
MAX_WATERMARK = 1_000_000
MAX_CROSSOVER = 1 << 20


def build_replica_tuning(replica, cfg) -> TuningController:
    rid = replica.id
    registry = KnobRegistry(name=f"tuning-r{rid}")
    cool = cfg.autotune_cooldown_ms / 1e3

    def K(name: str, value: int, lo: int, hi: int, apply_fn,
          sensor: str, unit: str = "") -> Knob:
        return registry.register(Knob(
            name=name, value=int(value), default=int(value), lo=lo,
            hi=hi, apply_fn=apply_fn, sensor=sensor, unit=unit,
            cooldown_s=cool))

    controller = TuningController(
        registry, name=f"tuning-r{rid}",
        interval_s=cfg.autotune_interval_ms / 1e3,
        aggregator=getattr(replica, "aggregator", None), rid=rid,
        stages_fn=lambda: flight.stage_summary(rid=rid),
        kernels_fn=lambda: flight.kernel_profiler().snapshot(),
        health_fn=lambda: replica.health.verdict()["verdict"],
        depths_fn=lambda: _depths(replica),
        counters_fn=lambda: _counters(replica))

    # --- verify plane: flush window + batch cap, grown while the
    # ed25519 kernel's per-item cost keeps falling, shrunk when
    # admission wait dominates the slot breakdown ---
    def apply_verify_flush(v: int) -> None:
        if replica.req_batcher is not None:
            replica.req_batcher.reconfigure(flush_us=v)
        replica.cert_batcher.reconfigure(flush_us=v)

    K("verify_batch_flush_us", cfg.verify_batch_flush_us, 50,
      MAX_FLUSH_US, apply_verify_flush,
      "ed25519 kernel per-item cost vs adm_wait p50 share", "us")
    controller.add_policy("verify_batch_flush_us",
                          batch_amortize_policy("ed25519", "adm_wait"))
    if replica.req_batcher is not None:
        K("verify_batch_size", cfg.verify_batch_size, 16, MAX_BATCH,
          lambda v: replica.req_batcher.reconfigure(batch_size=v),
          "ed25519 kernel batch fill vs adm_wait p50 share", "sigs")
        controller.add_policy("verify_batch_size",
                              batch_amortize_policy("ed25519",
                                                    "adm_wait"))

    # --- combine plane: flush window + slot cap from the
    # bls_msm amortization profile vs the commit stage share ---
    K("combine_flush_us", cfg.combine_flush_us, 0, MAX_FLUSH_US,
      lambda v: replica.collector_pool.reconfigure(flush_us=v),
      "bls_msm per-item cost vs commit p50 share", "us")
    # under optimistic replies the combine runs OFF the client-visible
    # path: fresh cert_lag samples veto the SHRINK votes —
    # narrowing the flush window would trade amortization for a latency
    # nobody is waiting on anymore
    _combine = batch_amortize_policy("bls_msm", "commit")
    if cfg.optimistic_replies:
        _combine = optimistic_combine_policy(_combine)
    controller.add_policy("combine_flush_us", _combine)
    # combine_batch_max is WIRE-VISIBLE and therefore pin/catalog-only:
    # the combine-flush drain order determines which share subset a
    # certificate aggregates over, and under share aggregation the
    # cert's contributor bitmap IS wire bytes — replicas autotuning this
    # independently would emit certificates other replicas never mint
    # themselves, breaking the cross-replica retransmission cache and
    # the byte-equivalence checks. Operators pin it cluster-wide (flush
    # timing stays per-replica tunable above: WHEN a batch drains is
    # local, WHAT a cert may span is not).
    K("combine_batch_max", cfg.combine_batch_max, 1, 512,
      lambda v: replica.collector_pool.reconfigure(max_batch=v),
      "bls_msm per-item cost vs commit p50 share", "slots")
    controller.track("combine_batch_max")

    # --- execution lane: coalescing depth from the exec stage share ---
    if replica.exec_lane is not None:
        K("execution_max_accumulation", cfg.execution_max_accumulation,
          1, MAX_ACCUMULATION, replica.exec_lane.set_max_accumulation,
          "exec p50 share of the slot breakdown + lane depth", "slots")
        controller.add_policy("execution_max_accumulation",
                              exec_accumulation_policy())

    # --- durability pipeline: group-commit window + size
    # from the measured per-run fsync cost vs the reply-stage share
    # (the group-fsync wait is accounted to `reply` in the slot
    # breakdown) ---
    if getattr(replica, "durability", None) is not None:
        K("durability_group_max", cfg.durability_group_max, 1, 64,
          replica.durability.set_group_max,
          "fsync us/run falling vs reply p50 share", "runs")
        controller.add_policy("durability_group_max",
                              durability_amortize_policy())
        K("durability_window_us", cfg.durability_window_us, 0,
          MAX_FLUSH_US, replica.durability.set_window_us,
          "fsync us/run falling vs reply p50 share", "us")
        controller.add_policy("durability_window_us",
                              durability_amortize_policy())

    # --- admission backpressure: shed watermark (low follows at
    # high/3, preserving the construction-time hysteresis shape) ---
    if replica.admission is not None and cfg.admission_high_watermark:
        K("admission_high_watermark", cfg.admission_high_watermark,
          100, MAX_WATERMARK,
          lambda v: replica.admission.set_watermarks(v, max(1, v // 3)),
          "shed mode + adm_wait p50 share", "msgs")
        controller.add_policy("admission_high_watermark",
                              admission_watermark_policy())

    # --- ECDSA device/host crossover: process-wide, like
    # the device itself — measured `ecdsa` kernel tier vs the batched
    # host engine's drained per-item cost ---
    # (the seed calls ecdsa_crossover(), which raises device.NoDevice on
    # a host with no card unless the CPU was requested)
    from tpubft_torch.crypto import cuda as cuda_mod
    K("ecdsa_crossover_b", min(cuda_mod.ecdsa_crossover(), MAX_CROSSOVER),
      1, MAX_CROSSOVER, cuda_mod.set_ecdsa_crossover,
      "ecdsa kernel per-item cost vs ecdsa_host_us/items", "sigs")
    controller.add_policy("ecdsa_crossover_b", ecdsa_crossover_policy())

    # --- mesh fan-out: cap the crypto plane's shard count from the
    # measured sharded-launch amortisation. Process-wide like the device
    # and the crossover; the default is every slot, so the degraded
    # rule's reset (any breaker not CLOSED, an evicted slot's
    # `device.chip<N>` among them) restores the full width ---
    from tpubft_torch.ops import dispatch as dispatch_mod
    n_chips = dispatch_mod.crypto_mesh().device_count()
    if n_chips > 1:
        K("crypto_shard_count", n_chips, 1, n_chips,
          dispatch_mod.crypto_mesh().set_shard_count,
          "ed25519.shard per-item cost vs full-batch trend", "chips")
        controller.add_policy("crypto_shard_count", crypto_shard_policy())

    # --- device-launch floor: the smallest batch
    # worth a device ride follows the ed25519 kernel's warm per-item
    # trend — falling cost lowers the floor, rising cost raises it ---
    K("device_min_verify_batch", cfg.device_min_verify_batch, 1,
      MAX_BATCH, lambda v: setattr(replica.sig, "device_min_batch", v),
      "ed25519 warm per-item cost trend", "sigs")
    controller.add_policy("device_min_verify_batch",
                          device_min_batch_policy())

    def apply_st_window(v: int) -> None:
        # late-bound: the kvbc layer attaches state transfer after the
        # consensus replica constructs
        st = getattr(replica, "state_transfer", None)
        st_cfg = getattr(st, "cfg", None)
        if st_cfg is not None:
            st_cfg.window_ranges = int(v)

    # fetch pipelining follows the transfer's own throughput history:
    # grow while the fetched-byte rate rises, shrink on source failovers
    # — a wide window multiplies the data parked behind a source that
    # just timed out
    K("st_window_ranges", cfg.st_window_ranges, 1, 64, apply_st_window,
      "st_bytes_per_sec trend vs source_failovers", "ranges")
    controller.add_policy("st_window_ranges", st_window_policy())

    # --- paged client table: residency bound follows the
    # paging traffic — grow under evict/re-page thrash, hand memory
    # back when the resident set runs far under the bound ---
    if replica.clients.max_resident:
        K("client_table_max", cfg.client_table_max, 256, 1 << 20,
          replica.clients.set_max_resident,
          "client-table miss/eviction thrash vs resident slack",
          "clients")
        controller.add_policy("client_table_max", client_table_policy())

    def apply_breaker_cooldown(v: int) -> None:
        from tpubft_torch.ops.dispatch import device_breaker
        device_breaker().configure(cooldown_s=v / 1e3)

    # re-admission outcomes drive the cooldown: a
    # trip after a recovery = re-admitted too early, grow; recoveries
    # holding with no new trips = shrink back toward fast re-admission
    K("breaker_cooldown_ms", cfg.breaker_cooldown_ms, 100, 120_000,
      apply_breaker_cooldown, "breaker trip/recovery history", "ms")
    controller.add_policy("breaker_cooldown_ms",
                          breaker_readmission_policy())

    # --- verified crypto-offload tier: routing is a 0/1
    # actuator on the process-wide pool — work goes helper-ward only
    # while the measured leased per-item cost (lease round-trip + the
    # on-replica soundness check) beats the local bls_msm kernel's.
    # Safety is NOT this knob's job: a lying helper is quarantined by
    # the soundness check regardless of the route state.
    if cfg.offload_enabled:
        from tpubft_torch.ops.dispatch import offload_pool
        _pool = offload_pool()
        K("offload_route", 1, 0, 1,
          lambda v: _pool.set_routing(bool(v)),
          "leased per-item cost (lease+soundness) vs local bls_msm",
          "on/off")
        controller.add_policy("offload_route", offload_routing_policy())

    # agg_fanout is WIRE-VISIBLE and pin/catalog-only: every
    # replica derives the aggregation overlay deterministically from
    # (n, fanout, root, view) with no negotiation — a replica moving its
    # own fanout would compute different parent/child edges than its
    # peers, orphaning its shares (they land on nodes that don't expect
    # to be its parent and time out into the direct-send fallback: safe,
    # but the aggregation win silently evaporates). No policy may ever
    # drive it; operators pin it cluster-wide in one move.
    if getattr(replica, "_agg_mode", "off") != "off":
        K("agg_fanout", cfg.agg_fanout, 2, 16,
          lambda v: setattr(replica, "_agg_fanout", max(2, int(v))),
          "overlay depth vs per-hop flush latency (pin-only)", "children")
        controller.track("agg_fanout")

    # --- measured-operating-point seed ---
    if cfg.autotune_seed_file:
        try:
            n = load_seed(registry, cfg.autotune_seed_file)
            log.info("r%d: seeded %d knobs from %s", rid, n,
                     cfg.autotune_seed_file)
        except Exception:  # noqa: BLE001 — a bad seed must not stop
            log.exception("r%d: knob seed %s failed; using defaults",
                          rid, cfg.autotune_seed_file)
    return controller


def _depths(replica) -> dict:
    d = {}
    if replica.exec_lane is not None:
        d["exec_lane"] = replica.exec_lane.depth
    if replica.admission is not None:
        d["admission"] = replica.admission.depth
    if getattr(replica, "durability", None) is not None:
        d["dur_lag"] = replica.durability.lag
    if getattr(replica, "clients", None) is not None:
        d["client_table"] = replica.clients.resident_count
    return d


def _counters(replica) -> dict:
    c = {"ecdsa_host_items": replica.sig.ecdsa_batched_host.value,
         "ecdsa_host_us": replica.sig.ecdsa_host_us.value}
    if replica.admission is not None:
        c["adm_shedding"] = 1 if replica.admission.shedding else 0
    if getattr(replica, "durability", None) is not None:
        c.update(replica.durability.stats())
    st = getattr(replica, "state_transfer", None)
    if st is not None:
        # late-bound like the knob itself (kvbc attaches ST after
        # construction); counter DELTAS are the policy's rate signal
        c["st_bytes"] = st.m_bytes.value
        c["st_failovers"] = st.m_failovers.value
    clients = getattr(replica, "clients", None)
    if clients is not None:
        c["client_table_hits"] = clients.table_hits
        c["client_table_misses"] = clients.table_misses
        c["client_table_evictions"] = clients.table_evictions
    # the port's own pool (reference wiring.py:314 reads
    # tpubft.offload.pool)
    from tpubft_torch.offload import pool as _op
    if _op._POOL is not None and _op._POOL.enabled:
        # cumulative lease cost; the routing policy diffs these deltas.
        # Read even while routing is OFF — pool_if_active() would hide
        # the counters then, starving the policy of the signal it needs
        # to probe the route back open.
        c["off_lease_us"] = _op._POOL.lease_us_total
        c["off_lease_items"] = _op._POOL.lease_items_total
        c["off_soundness_us"] = _op._POOL.soundness_us_total
    return c
