"""Per-knob tuning policies — pure functions from telemetry to a
direction vote (port of tpubft/tuning/policies.py).

A policy never moves a knob itself: it votes GROW / SHRINK / HOLD each
controller interval, and the registry's hysteresis (consecutive
same-direction votes) + cooldown decide whether the vote becomes a
step. Policies therefore stay simple threshold rules over the measured
signals; the stability machinery lives in one place.

The shared doctrine:

  * batch/flush knobs grow while the kernel profile shows falling
    per-item cost (amortization still improving) and shrink as soon as
    the latency-sensitive stage (`adm_wait` for the verify plane,
    `commit` for the combine plane) dominates the slot breakdown —
    batching is only worth the latency it buys back;
  * `execution_max_accumulation` shrinks when `exec` dominates the
    slot breakdown and grows back while the lane is deep and exec is
    cheap;
  * the ECDSA device/host crossover follows the measured per-item cost
    of the `ecdsa` kernel vs the batched host engine;
  * every policy HOLDs without fresh signal — an idle replica's knobs
    must not wander.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from tpubft_torch.tuning.knobs import GROW, HOLD, SHRINK, Knob
from tpubft_torch.utils.flight import PIPELINE_STAGES

# a stage "dominates" the slot breakdown past this fraction of the
# summed per-stage p50s
DOMINANT_FRAC = 0.5
# and is "cheap" below this fraction
MINOR_FRAC = 0.2
# per-item kernel cost is "falling" when the fresh interval's cost is
# at most this ratio of the previous interval's
FALLING_RATIO = 0.98
# device/host crossover moves only on a >=10% measured cost gap
CROSSOVER_MARGIN = 0.9


@dataclass
class Telemetry:
    """One controller interval's sensor snapshot (built by the
    controller; policies treat it read-only)."""

    stages: Dict[str, Dict] = field(default_factory=dict)
    kernels: Dict[str, Dict] = field(default_factory=dict)
    breakers: Dict[str, Dict] = field(default_factory=dict)
    health: str = "healthy"
    depths: Dict[str, int] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    completed_slots: int = 0


Policy = Callable[[Telemetry, Optional[Telemetry], Knob], int]


# ----------------------------------------------------------------------
# signal helpers
# ----------------------------------------------------------------------
def fresh_slots(cur: Telemetry, prev: Optional[Telemetry]) -> int:
    if prev is None:
        return 0
    return max(0, cur.completed_slots - prev.completed_slots)


def stage_fraction(tel: Telemetry, stage: str) -> float:
    """`stage`'s share of the summed pipeline-stage p50s (0 when the
    breakdown is empty)."""
    total = 0.0
    for s in PIPELINE_STAGES:
        total += float(tel.stages.get(s, {}).get("p50_ms", 0.0))
    if total <= 0.0:
        return 0.0
    return float(tel.stages.get(stage, {}).get("p50_ms", 0.0)) / total


def kernel_per_item_us(tel: Telemetry, kind: str) -> Optional[float]:
    """Warm per-item cost of one kernel kind in µs (None until the
    profile has warm calls and a batch shape)."""
    st = tel.kernels.get(kind)
    if not st or st.get("calls", 0) < 2:
        return None
    batch_avg = float(st.get("batch_avg", 0.0))
    if batch_avg <= 0.0:
        return None
    return float(st.get("warm_avg_ms", 0.0)) * 1e3 / batch_avg


def kernel_calls(tel: Telemetry, kind: str) -> int:
    return int(tel.kernels.get(kind, {}).get("calls", 0))


def per_item_falling(cur: Telemetry, prev: Optional[Telemetry],
                     kind: str) -> bool:
    """True when the kernel's per-item cost this interval is at or
    below FALLING_RATIO of the previous interval's (amortization still
    paying off) — and there were fresh calls to measure it on."""
    if prev is None or kernel_calls(cur, kind) <= kernel_calls(prev, kind):
        return False
    a, b = kernel_per_item_us(cur, kind), kernel_per_item_us(prev, kind)
    if a is None or b is None or b <= 0.0:
        return False
    return a <= b * FALLING_RATIO


# ----------------------------------------------------------------------
# policy factories
# ----------------------------------------------------------------------
def batch_amortize_policy(kernel_kind: str,
                          latency_stage: str) -> Policy:
    """Flush windows and batch caps: shrink when `latency_stage`
    dominates the slot breakdown (batching is costing more latency than
    it amortizes), grow while the kernel's per-item cost is still
    falling, hold otherwise."""

    def policy(cur: Telemetry, prev: Optional[Telemetry],
               knob: Knob) -> int:
        if not fresh_slots(cur, prev):
            return HOLD
        if stage_fraction(cur, latency_stage) > DOMINANT_FRAC:
            return SHRINK
        if per_item_falling(cur, prev, kernel_kind):
            return GROW
        return HOLD

    return policy


def optimistic_combine_policy(inner: Policy) -> Policy:
    """Wrap the combine-plane amortization policy for the optimistic
    reply plane: once replies stop waiting on the combine,
    shrinking the flush window buys the client NOTHING — the cert_lag
    overlay (optimistic release → verified certificate) shows fresh
    samples exactly when certificates form off the critical path, so a
    SHRINK vote from the inner policy is downgraded to HOLD while that
    signal is fresh. GROW stays allowed: wider flush windows amortize
    the deferred combine even harder, which is the whole point."""

    def policy(cur: Telemetry, prev: Optional[Telemetry],
               knob: Knob) -> int:
        vote = inner(cur, prev, knob)
        if vote != SHRINK or prev is None:
            return vote
        fresh_lag = (int(cur.stages.get("cert_lag", {}).get("count", 0))
                     > int(prev.stages.get("cert_lag", {})
                           .get("count", 0)))
        return HOLD if fresh_lag else vote

    return policy


def breaker_readmission_policy() -> Policy:
    """`breaker_cooldown_ms` from re-admission OUTCOMES: a trip that
    lands after a recovery means the breaker re-admitted traffic too
    early and the device re-failed under it — GROW the cooldown. An
    interval whose recoveries advance with NO new trips means the plane
    held after re-admission — SHRINK back toward faster re-admission.
    Intervals without fresh breaker history hold. (The controller's
    degraded rule guarantees policies only run with every breaker
    CLOSED, so this reads the trip/recovery COUNTER deltas — the
    history of re-admissions — never live breaker state.)"""

    def policy(cur: Telemetry, prev: Optional[Telemetry],
               knob: Knob) -> int:
        if prev is None:
            return HOLD
        d_trips = d_recov = 0
        for name, b in cur.breakers.items():
            pb = prev.breakers.get(name, {})
            d_trips += max(0, int(b.get("trips", 0))
                           - int(pb.get("trips", 0)))
            d_recov += max(0, int(b.get("recoveries", 0))
                           - int(pb.get("recoveries", 0)))
        if d_trips > 0:
            return GROW
        if d_recov > 0:
            return SHRINK
        return HOLD

    return policy


def device_min_batch_policy() -> Policy:
    """`device_min_verify_batch` (the smallest batch worth a device
    launch) from the kernel profiler's WARM per-item cost of the
    ed25519 verify kernel: a falling per-item cost means the device is
    amortizing well at current sizes — SHRINK the floor so smaller
    batches ride it too; a rising per-item cost means launches stopped
    amortizing (the floor admits batches too small to pay the dispatch
    overhead) — GROW it back toward host territory. No fresh kernel
    calls => HOLD."""

    def policy(cur: Telemetry, prev: Optional[Telemetry],
               knob: Knob) -> int:
        if prev is None or kernel_calls(cur, "ed25519") \
                <= kernel_calls(prev, "ed25519"):
            return HOLD
        a = kernel_per_item_us(cur, "ed25519")
        b = kernel_per_item_us(prev, "ed25519")
        if a is None or b is None or b <= 0.0:
            return HOLD
        if a <= b * FALLING_RATIO:
            return SHRINK
        if a * FALLING_RATIO >= b:
            return GROW
        return HOLD

    return policy


def exec_accumulation_policy() -> Policy:
    """Shrink accumulation when `exec` dominates the slot breakdown
    (long coalesced runs are serializing replies behind one apply);
    grow while the lane is deeper than the current cap and exec stays
    minor (coalescing would cut per-slot commit overhead)."""

    def policy(cur: Telemetry, prev: Optional[Telemetry],
               knob: Knob) -> int:
        if not fresh_slots(cur, prev):
            return HOLD
        frac = stage_fraction(cur, "exec")
        if frac > DOMINANT_FRAC:
            return SHRINK
        if frac < MINOR_FRAC \
                and cur.depths.get("exec_lane", 0) > knob.value:
            return GROW
        return HOLD

    return policy


def ecdsa_crossover_policy() -> Policy:
    """Move the device/host crossover from measured per-item costs:
    the `ecdsa` kernel profile (device tier) vs the batched host
    engine's drained timing counters (`ecdsa_host_us` / items, fed by
    SigManager). A >=10% gap in either direction moves the boundary
    toward the cheaper tier; anything closer holds."""

    def policy(cur: Telemetry, prev: Optional[Telemetry],
               knob: Knob) -> int:
        if prev is None:
            return HOLD
        dev = kernel_per_item_us(cur, "ecdsa")
        items = cur.counters.get("ecdsa_host_items_delta", 0.0)
        us = cur.counters.get("ecdsa_host_us_delta", 0.0)
        host = (us / items) if items > 0 else None
        if dev is None or host is None or host <= 0.0:
            return HOLD
        if dev < host * CROSSOVER_MARGIN:
            return SHRINK        # device cheaper: admit smaller batches
        if host < dev * CROSSOVER_MARGIN:
            return GROW          # host cheaper: raise the bar
        return HOLD

    return policy


def crypto_shard_policy() -> Policy:
    """Mesh fan-out cap: follow the measured per-item cost
    of the SHARDED verify launches. The `ed25519.shard` profile row
    (written by device_section alongside the plain `ed25519` row on
    every mesh launch) proves fresh sharded traffic; the full-batch
    per-item cost then says whether the current width still amortizes —
    falling => GROW toward more chips, rising past the same ratio =>
    SHRINK (mesh dispatch overhead is beating the split at the current
    batch sizes). No fresh SHARDED launches => HOLD: an idle or
    single-chip-routed interval says nothing about the mesh. An evicted
    chip never reaches this policy at all — any non-CLOSED breaker
    trips the controller's degraded rule, which resets the knob to its
    default (full width) until the plane heals.

    The port attaches it to no knob: its `crypto_shard_count` knob needs
    more than one chip and the mesh tier (wiring.py; ROADMAP A.7), and
    no port seam emits `ed25519.shard` yet."""

    def policy(cur: Telemetry, prev: Optional[Telemetry],
               knob: Knob) -> int:
        if not fresh_slots(cur, prev):
            return HOLD
        if prev is None or kernel_calls(cur, "ed25519.shard") \
                <= kernel_calls(prev, "ed25519.shard"):
            return HOLD
        a = kernel_per_item_us(cur, "ed25519")
        b = kernel_per_item_us(prev, "ed25519")
        if a is None or b is None or b <= 0.0:
            return HOLD
        if a <= b * FALLING_RATIO:
            return GROW
        if a * FALLING_RATIO >= b:
            return SHRINK
        return HOLD

    return policy


def durability_amortize_policy() -> Policy:
    """Group-commit window/size: widen while the measured
    fsync cost PER RUN keeps falling (grouping is still amortizing the
    disk — the exact analog of the kernel-batch amortization rule,
    with the probed fsync as the 'kernel'); shrink as soon as `reply`
    dominates the slot breakdown — with the pipeline, the group-fsync
    wait is accounted to the reply stage, so a dominant reply share
    means durability batching is costing more latency than the
    amortization buys back."""

    def policy(cur: Telemetry, prev: Optional[Telemetry],
               knob: Knob) -> int:
        if not fresh_slots(cur, prev):
            return HOLD
        if stage_fraction(cur, "reply") > DOMINANT_FRAC:
            return SHRINK
        runs = cur.counters.get("dur_runs_delta", 0.0)
        us = cur.counters.get("dur_fsync_us_delta", 0.0)
        if prev is None or runs <= 0:
            return HOLD
        prev_runs = prev.counters.get("dur_runs_delta", 0.0)
        prev_us = prev.counters.get("dur_fsync_us_delta", 0.0)
        if prev_runs <= 0 or prev_us <= 0:
            return HOLD
        cost, prev_cost = us / runs, prev_us / prev_runs
        if cost <= prev_cost * FALLING_RATIO:
            return GROW
        return HOLD

    return policy


def st_window_policy() -> Policy:
    """`st_window_ranges` (state-transfer fetch pipelining) from the
    transfer's own throughput history: SHRINK on any fresh
    `source_failovers` — a failover means an outstanding range timed
    out on its source, and a wide window multiplies the data parked
    behind the slow/dead source when that happens; GROW while the
    fetched-byte rate keeps rising interval over interval (the pipeline
    is still source-bound, so more outstanding ranges buy throughput).
    An interval with no fresh transfer traffic holds — an idle
    replica's window must not wander, and the controller's degraded
    rule (any non-CLOSED breaker resets knobs to defaults) already
    covers a sick digest plane. Byte DELTAS stand in for
    st_bytes_per_sec: controller intervals are fixed-length, so the
    per-interval delta is the rate."""

    def policy(cur: Telemetry, prev: Optional[Telemetry],
               knob: Knob) -> int:
        if prev is None:
            return HOLD
        if cur.counters.get("st_failovers_delta", 0.0) > 0:
            return SHRINK
        b = cur.counters.get("st_bytes_delta", 0.0)
        pb = prev.counters.get("st_bytes_delta", 0.0)
        if b <= 0.0 or pb <= 0.0:
            return HOLD          # idle, or no prior interval to compare
        if b * FALLING_RATIO >= pb:
            return GROW          # rate still rising: widen the pipeline
        return HOLD

    return policy


def client_table_policy() -> Policy:
    """`client_table_max` (paged client-table residency bound) from
    paging traffic: GROW while the table is THRASHING — evictions and
    misses both advancing in the same interval means the LRU is
    re-paging records it just evicted, so the live principal working
    set doesn't fit; SHRINK when fresh table traffic runs with zero
    evictions and the resident set sits under half the bound — the
    bound is slack, and handing the memory back cannot touch a hot set
    that small. Intervals without table traffic hold."""

    def policy(cur: Telemetry, prev: Optional[Telemetry],
               knob: Knob) -> int:
        if prev is None:
            return HOLD
        hits = cur.counters.get("client_table_hits_delta", 0.0)
        misses = cur.counters.get("client_table_misses_delta", 0.0)
        if hits + misses <= 0.0:
            return HOLD
        evictions = cur.counters.get("client_table_evictions_delta", 0.0)
        if evictions > 0.0 and misses / (hits + misses) > MINOR_FRAC:
            return GROW
        if evictions <= 0.0 \
                and cur.depths.get("client_table", 0) < knob.value // 2:
            return SHRINK
        return HOLD

    return policy


def admission_watermark_policy() -> Policy:
    """Grow the shed watermark while the plane is shedding but
    admission wait is NOT the bottleneck (the queue would drain if
    allowed to buffer); shrink it when `adm_wait` dominates the slot
    breakdown (buffered traffic is just aging)."""

    def policy(cur: Telemetry, prev: Optional[Telemetry],
               knob: Knob) -> int:
        if not fresh_slots(cur, prev):
            return HOLD
        frac = stage_fraction(cur, "adm_wait")
        if frac > DOMINANT_FRAC:
            return SHRINK
        if cur.counters.get("adm_shedding", 0) and frac < MINOR_FRAC:
            return GROW
        return HOLD

    return policy


def offload_routing_policy() -> Policy:
    """Route combine work helper-ward only while a leased item is
    cheaper than a locally-computed one. The knob is binary
    (1=route, 0=local): GROW votes toward routing, SHRINK away from it.

    Leased per-item cost = Δ(lease µs + on-replica soundness µs) over
    Δ(leased items), diffed across telemetry snapshots so it tracks the
    CURRENT helper fleet, not boot-time history. Local per-item cost is
    the warm bls_msm kernel profile — the same sensor the combine-plane
    knobs trust. No fresh leases (or no local kernel profile yet) =>
    HOLD: an idle tier gives no signal, and flapping the route on stale
    numbers costs a lease round-trip per flip."""

    def policy(cur: Telemetry, prev: Optional[Telemetry],
               knob: Knob) -> int:
        if prev is None:
            return HOLD
        d_us = (cur.counters.get("off_lease_us", 0.0)
                - prev.counters.get("off_lease_us", 0.0)) \
            + (cur.counters.get("off_soundness_us", 0.0)
               - prev.counters.get("off_soundness_us", 0.0))
        d_items = (cur.counters.get("off_lease_items", 0.0)
                   - prev.counters.get("off_lease_items", 0.0))
        if d_items <= 0.0:
            # a closed route starves its own sensor (no leases => no
            # deltas, ever) — probe it back open, breaker-half-open
            # style: the knob cooldown bounds the flap rate and a
            # still-slow tier SHRINKs right back next interval. Only
            # while the combine plane is actually busy (fresh slots);
            # an idle replica's knobs must not walk.
            if knob.value == 0 and fresh_slots(cur, prev):
                return GROW
            return HOLD
        local = kernel_per_item_us(cur, "bls_msm")
        if local is None:
            return HOLD
        leased = d_us / d_items
        # the same >=10% margin the device/host crossover uses, so the
        # route doesn't flap on measurement noise
        if leased < local * CROSSOVER_MARGIN:
            return GROW
        if local < leased * CROSSOVER_MARGIN:
            return SHRINK
        return HOLD

    return policy
