"""The tuning control loop (port of tpubft/tuning/controller.py).

One `TuningController` per replica: a daemon thread that, every
`interval_s`, snapshots the telemetry plane (flight-recorder stage
summary, kernel profiler, breaker registry, health verdict, queue
depths, SigManager counters) into a `Telemetry`, and drives the knob
registry:

  * **degraded rule first** — when the health verdict leaves `healthy`
    or any breaker is not CLOSED, every unpinned knob resets to its
    configured default in one pass and tuning stops until the plane has
    been healthy again for `warmup_polls` consecutive intervals. The
    controller never fights the degradation plane: an OPEN breaker
    means the sensors are measuring the fallback path, and tuning on
    fallback costs would chase a phantom optimum.
  * **policy votes** — healthy and warmed up, each knob's policy votes
    a direction; the registry's hysteresis + cooldown turn sustained
    votes into bounded steps (`Knob.stepped`, clamped to [lo, hi]).

Every applied change is one decision: an `EV_TUNE` flight event
(seq = knob id, view = old value, arg = new value), a decision-log
entry (bounded deque, served by `status get tuning` and attached to
flight dumps via the recorder's dump-provider hook so a dump reader can
join knob changes to stage timelines), and the per-knob `knob_<name>` gauge
on the `tuning` metrics component.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from tpubft_torch.tuning.knobs import KnobRegistry
from tpubft_torch.tuning.policies import Policy, Telemetry
from tpubft_torch.utils import breaker as breaker_mod
from tpubft_torch.utils import flight
from tpubft_torch.utils.logging import get_logger
from tpubft_torch.utils.metrics import Aggregator, Component

log = get_logger("tuning")

DECISION_KEEP = 256


class TuningController:
    def __init__(self, registry: KnobRegistry, name: str = "tuning",
                 interval_s: float = 1.0,
                 aggregator: Optional[Aggregator] = None,
                 rid: int = -1,
                 warmup_polls: int = 2,
                 stages_fn: Optional[Callable[[], Dict]] = None,
                 kernels_fn: Optional[Callable[[], Dict]] = None,
                 health_fn: Optional[Callable[[], str]] = None,
                 depths_fn: Optional[Callable[[], Dict]] = None,
                 counters_fn: Optional[Callable[[], Dict]] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.registry = registry
        self._name = name
        self.interval_s = interval_s
        self._rid = rid
        self.warmup_polls = max(1, warmup_polls)
        self._stages_fn = stages_fn
        self._kernels_fn = kernels_fn
        self._health_fn = health_fn
        self._depths_fn = depths_fn
        self._counters_fn = counters_fn
        self._clock = clock
        self._policies: Dict[str, Policy] = {}
        self._prev: Optional[Telemetry] = None
        self._prev_counters: Dict[str, float] = {}
        self._healthy_streak = 0
        self._backed_off = False
        self._decisions: "deque[Dict]" = deque(maxlen=DECISION_KEEP)
        self._mu = threading.Lock()        # decisions + prev snapshot
        self._running = False
        # Event-paced loop (NOT time.sleep): stop() must return
        # immediately — with four replicas per in-process cluster and
        # hundreds of cluster teardowns per test run, a sleeping loop's
        # up-to-interval join cost compounds into minutes
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

        self.metrics = Component("tuning", aggregator)
        self.m_steps = self.metrics.register_counter("tune_steps")
        self.m_resets = self.metrics.register_counter("tune_resets")
        self.m_polls = self.metrics.register_counter("tune_polls")
        self.m_active = self.metrics.register_gauge("tuning_active")
        self.m_verdict = self.metrics.register_status("last_verdict",
                                                      "healthy")
        self._gauges: Dict[str, object] = {}

    # ------------------------------------------------------------------
    # wiring
    # ------------------------------------------------------------------
    def add_policy(self, knob_name: str, policy: Policy) -> None:
        self._policies[knob_name] = policy
        g = self.metrics.register_gauge(f"knob_{knob_name}")
        g.set(self.registry.get(knob_name))
        self._gauges[knob_name] = g

    def track(self, knob_name: str) -> None:
        """Register a knob for metrics/catalog visibility without a
        policy (manual/pinned knobs still show in `status get tuning`
        and still reset on degradation)."""
        g = self.metrics.register_gauge(f"knob_{knob_name}")
        g.set(self.registry.get(knob_name))
        self._gauges[knob_name] = g

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._stop_evt.clear()
        self.m_active.set(1)
        flight.register_dump_provider(f"{self._name}", self.dump_state)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"tuner-{self._name}")
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        self._stop_evt.set()
        self.m_active.set(0)
        flight.unregister_dump_provider(f"{self._name}")
        t = self._thread
        if t is not None:
            t.join(timeout=2)
            self._thread = None

    def _run(self) -> None:
        flight.set_thread_rid(self._rid)
        while self._running:
            if self._stop_evt.wait(self.interval_s):
                return
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the tuner must outlive
                log.exception("tuning poll failed")  # anything it tunes

    # ------------------------------------------------------------------
    # sensor gather
    # ------------------------------------------------------------------
    def gather(self) -> Telemetry:
        # each sensor is isolated: a broken PERF sensor reads as "no
        # signal" (policies hold), but it must never mask the breaker
        # and health reads below — those decide the degraded rule, and
        # a shared try would fail OPEN as "healthy" exactly when the
        # telemetry plane is misbehaving
        tel = Telemetry()
        try:
            if self._stages_fn is not None:
                summary = self._stages_fn() or {}
                tel.stages = summary.get("stages", {})
                tel.completed_slots = int(
                    summary.get("finalized_total", 0))
        except Exception:  # noqa: BLE001
            log.exception("stage sensor failed")
        try:
            if self._kernels_fn is not None:
                tel.kernels = self._kernels_fn() or {}
        except Exception:  # noqa: BLE001
            log.exception("kernel sensor failed")
        try:
            if self._depths_fn is not None:
                tel.depths = self._depths_fn() or {}
        except Exception:  # noqa: BLE001
            log.exception("depth sensor failed")
        try:
            if self._counters_fn is not None:
                cur = {k: float(v)
                       for k, v in (self._counters_fn() or {}).items()}
                tel.counters = dict(cur)
                for k, v in cur.items():
                    tel.counters[f"{k}_delta"] = \
                        v - self._prev_counters.get(k, 0.0)
                self._prev_counters = cur
        except Exception:  # noqa: BLE001
            log.exception("counter sensor failed")
        # the degraded-rule inputs: a failure here fails SAFE (treated
        # as degraded), never open
        try:
            tel.breakers = breaker_mod.snapshot_all()
            if self._health_fn is not None:
                tel.health = self._health_fn() or "healthy"
        except Exception:  # noqa: BLE001
            log.exception("health sensor failed; treating as degraded")
            tel.health = "degraded"
        return tel

    def _degraded(self, tel: Telemetry) -> bool:
        if tel.health != "healthy":
            return True
        return any(b.get("state") != breaker_mod.CLOSED
                   for b in tel.breakers.values())

    # ------------------------------------------------------------------
    # the control step
    # ------------------------------------------------------------------
    def poll_once(self) -> List[Dict]:
        """One control interval; returns the decisions made (tests call
        this directly with stubbed sensors)."""
        self.m_polls.inc()
        tel = self.gather()
        self.m_verdict.set(tel.health)
        made: List[Dict] = []
        if self._degraded(tel):
            self._healthy_streak = 0
            if not self._backed_off:
                self._backed_off = True
                for name, old, new in self.registry.reset_to_defaults():
                    made.append(self._decide(name, old, new,
                                             "degraded-reset",
                                             tel.health))
                if made:
                    self.m_resets.inc()
        else:
            self._healthy_streak += 1
            self._backed_off = False
            if self._healthy_streak > self.warmup_polls:
                made.extend(self._evaluate(tel))
        with self._mu:
            self._prev = tel
        return made

    def _evaluate(self, tel: Telemetry) -> List[Dict]:
        with self._mu:
            prev = self._prev
        made = []
        for name, policy in self._policies.items():
            try:
                knob = self.registry.knob(name)
            except KeyError:
                continue
            try:
                direction = policy(tel, prev, knob)
            except Exception:  # noqa: BLE001 — a broken policy holds
                log.exception("policy for %s raised", name)
                continue
            if not self.registry.vote(name, direction):
                continue
            old = knob.value
            applied = self.registry.step(name, direction)
            if applied is not None:
                made.append(self._decide(name, old, applied, "policy",
                                         f"dir={direction:+d}"))
        return made

    def _decide(self, name: str, old: int, new: int, source: str,
                detail: str) -> Dict:
        flight.record(flight.EV_TUNE, seq=self.registry.knob_id(name),
                      view=int(old), arg=int(new))
        self.m_steps.inc()
        g = self._gauges.get(name)
        if g is not None:
            g.set(int(new))
        d = {"ts": time.time(), "knob": name, "old": int(old),
             "new": int(new), "source": source, "detail": detail}
        with self._mu:
            self._decisions.append(d)
        log.info("tune %s: %s %d -> %d (%s)", source, name, old, new,
                 detail)
        return d

    # ------------------------------------------------------------------
    # surfaces
    # ------------------------------------------------------------------
    def write_seed(self, path: str) -> Optional[str]:
        """Persist the converged operating point as a knob-registry
        seed file: every knob's CURRENT value, frozen pins
        preserved, in exactly the format `load_seed` re-baselines from
        — so the next boot starts warm at this host's measured optimum
        instead of re-walking from cold defaults. Called on clean
        replica shutdown when `autotune_seed_file` is configured; a
        write failure is logged, never raised (shutdown must finish)."""
        from tpubft_torch.tuning.knobs import write_seed as _write
        snap = self.registry.snapshot()
        knobs = {name: ({"value": s["value"], "frozen": True}
                        if s["frozen"] else s["value"])
                 for name, s in snap.items()}
        try:
            return _write(path, knobs,
                          note=f"converged operating point written by "
                               f"{self._name} on clean shutdown")
        except Exception:  # noqa: BLE001 — see docstring
            log.exception("seed write-back to %s failed", path)
            return None

    def decisions(self, limit: int = 50) -> List[Dict]:
        with self._mu:
            return list(self._decisions)[-limit:]

    def state(self) -> Dict:
        with self._mu:
            prev = self._prev
        return {
            "rid": self._rid,
            "active": bool(self._running),
            "interval_s": self.interval_s,
            "healthy_streak": self._healthy_streak,
            "backed_off": self._backed_off,
            "last_verdict": (prev.health if prev is not None
                             else "healthy"),
            "knobs": self.registry.snapshot(),
            "knob_ids": {str(i): n
                         for i, n in self.registry.id_table().items()},
            "decisions": self.decisions(),
        }

    def dump_state(self) -> Dict:
        """Flight-dump provider payload: the decision log + knob values
        ride every dump artifact, so a dump reader can join EV_TUNE events
        (knob ids) to names and stage timelines."""
        return self.state()

    def render(self) -> str:
        """`status get tuning` payload."""
        return json.dumps(self.state(), sort_keys=True)
