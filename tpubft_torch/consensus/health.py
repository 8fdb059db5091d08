"""Replica health plane: stall watchdog + aggregate degradation verdict.

PRs 3-4 moved execution and admission onto dedicated threads; this
module is the runtime answer to one of those planes *stopping*. A
`HealthMonitor` per replica tracks liveness probes —

  * `dispatcher`      — the consensus thread's tick age (a 0.2s timer
                        beats it; a wedged handler or deadlocked
                        dispatcher stops the beats);
  * `exec_lane`       — executor-thread progress, thresholded at
                        `execution_drain_timeout_ms` (the same budget
                        the dispatcher-side drain barrier uses, so a
                        drain that WOULD time out is reported, not
                        silently eaten); busy only while slots are
                        pending/in flight;
  * `admission`       — worker-loop beats, busy only while the ingest
                        queue holds traffic;
  * `state_transfer`  — the fetch plane's last-activity pulse, busy
                        only while fetching

— and folds them with the device circuit-breaker registry
(tpubft/utils/breaker.py) and any registered degradation flags (e.g.
admission overload shedding) into one verdict:

    healthy   — all busy probes beating, breakers CLOSED, no shedding
    degraded  — live, but a breaker is OPEN/HALF_OPEN or a subsystem
                is load-shedding (the measured mode, not an outage)
    stalled   — a busy probe's beat age exceeded its threshold

The verdict rides the existing diagnostics server as `status get
health` (JSON: verdict + per-probe ages + breaker snapshots + shed
flags) and the metrics aggregator as a `health` component. On a probe's
transition into `stalled`, the monitor dumps every Python thread's
stack plus queue depths and breaker states to the log ONCE (re-armed
when the probe beats again) — the post-hoc diagnosability the
racecheck StallWatchdog provides for tests, promoted to an always-on
replica subsystem.
"""
from __future__ import annotations

import json
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

from tpubft_torch.utils import breaker as breaker_mod
from tpubft_torch.utils import flight
from tpubft_torch.utils.logging import get_logger
from tpubft_torch.utils.metrics import Aggregator, Component

log = get_logger("health")

HEALTHY = "healthy"
DEGRADED = "degraded"
STALLED = "stalled"


class _Probe:
    __slots__ = ("name", "threshold_s", "busy_fn", "detail_fn", "last_fn",
                 "last_beat", "reported")

    def __init__(self, name: str, threshold_s: float,
                 busy_fn: Optional[Callable[[], bool]],
                 detail_fn: Optional[Callable[[], object]],
                 last_fn: Optional[Callable[[], float]],
                 now: float) -> None:
        self.name = name
        self.threshold_s = threshold_s
        self.busy_fn = busy_fn            # None = always considered busy
        self.detail_fn = detail_fn        # queue depths etc. for dumps
        self.last_fn = last_fn            # pulse source overriding beats
        self.last_beat = now
        self.reported = False             # stall dumped (re-armed on beat)


class HealthMonitor:
    """One per replica. Probes beat from their own threads; a daemon
    poll thread computes verdicts and fires stall dumps. `render()` is
    also safe to call inline (the diagnostics status handler does)."""

    def __init__(self, name: str, aggregator: Optional[Aggregator] = None,
                 poll_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._name = name
        self._clock = clock
        self.poll_s = poll_s
        self._mu = threading.Lock()
        self._probes: Dict[str, _Probe] = {}
        self._degraded_flags: Dict[str, Callable[[], bool]] = {}
        self._info_sections: Dict[str, Callable[[], object]] = {}
        self._running = False
        self._thread: Optional[threading.Thread] = None

        self.metrics = Component("health", aggregator)
        self.m_verdict = self.metrics.register_status("verdict", HEALTHY)
        self.m_breakers = self.metrics.register_status("breakers", "")
        self.m_stall_dumps = self.metrics.register_counter("stall_dumps")
        self.m_stalled_probes = self.metrics.register_gauge("stalled_probes")
        self.m_flight_dumps = self.metrics.register_counter("flight_dumps")
        self._age_gauges: Dict[str, object] = {}
        # flight-dump plane: the verdict seen by the LAST poll, so a
        # transition into degraded/stalled writes exactly one artifact
        # per episode (re-armed when the verdict recovers). A flapping
        # source (e.g. a breaker cycling through half-open probes)
        # oscillates the verdict every few seconds — the min-interval
        # throttle keeps that from writing an artifact per flap, while
        # flight.MAX_DUMPS bounds total disk either way.
        self._last_verdict = HEALTHY
        self.last_flight_dump: Optional[str] = None
        self.dump_min_interval_s = 10.0
        self._last_dump_at: Optional[float] = None

    # ------------------------------------------------------------------
    # registration + beats (any thread)
    # ------------------------------------------------------------------
    def register_probe(self, name: str, threshold_s: float,
                       busy_fn: Optional[Callable[[], bool]] = None,
                       detail_fn: Optional[Callable[[], object]] = None,
                       last_fn: Optional[Callable[[], float]] = None
                       ) -> None:
        with self._mu:
            self._probes[name] = _Probe(name, threshold_s, busy_fn,
                                        detail_fn, last_fn, self._clock())
        self._age_gauges[name] = self.metrics.register_gauge(
            f"{name}_age_ms")

    def unregister_probe(self, name: str) -> None:
        with self._mu:
            self._probes.pop(name, None)

    def register_degraded_flag(self, name: str,
                               fn: Callable[[], bool]) -> None:
        """A boolean degradation source (e.g. admission shed mode): True
        pulls the aggregate verdict to `degraded` while set."""
        with self._mu:
            self._degraded_flags[name] = fn

    def register_info_section(self, name: str,
                              fn: Callable[[], object]) -> None:
        """An informational payload merged into verdict() under `name`.
        Purely additive observability — sections never move the
        aggregate verdict (that is what probes/flags/breakers are for);
        a raising section reports its error string instead of taking
        the monitor down."""
        with self._mu:
            self._info_sections[name] = fn

    def beat(self, name: str) -> None:
        now = self._clock()
        with self._mu:
            p = self._probes.get(name)
            if p is not None:
                p.last_beat = now
                p.reported = False

    # ------------------------------------------------------------------
    # verdicts
    # ------------------------------------------------------------------
    def _probe_states(self) -> List[Dict]:
        now = self._clock()
        with self._mu:
            probes = list(self._probes.values())
        out = []
        for p in probes:
            last = p.last_beat
            if p.last_fn is not None:
                try:
                    last = max(last, p.last_fn())
                except Exception:  # noqa: BLE001 — a probe source must
                    pass           # not take down the monitor
            age = max(0.0, now - last)
            busy = True
            if p.busy_fn is not None:
                try:
                    busy = bool(p.busy_fn())
                except Exception:  # noqa: BLE001
                    busy = True
            stalled = busy and age > p.threshold_s
            detail = None
            if p.detail_fn is not None:
                try:
                    detail = p.detail_fn()
                except Exception:  # noqa: BLE001
                    detail = "<detail error>"
            out.append({"name": p.name, "age_ms": round(age * 1e3, 1),
                        "threshold_ms": round(p.threshold_s * 1e3, 1),
                        "state": (STALLED if stalled
                                  else "ok" if busy else "idle"),
                        "detail": detail})
        return out

    def verdict(self) -> Dict:
        probes = self._probe_states()
        breakers = breaker_mod.snapshot_all()
        with self._mu:
            flags = list(self._degraded_flags.items())
        degraded = {}
        for name, fn in flags:
            try:
                degraded[name] = bool(fn())
            except Exception:  # noqa: BLE001
                degraded[name] = False
        stalled = [p["name"] for p in probes if p["state"] == STALLED]
        if stalled:
            agg = STALLED
        elif any(b["state"] != breaker_mod.CLOSED
                 for b in breakers.values()) or any(degraded.values()):
            agg = DEGRADED
        else:
            agg = HEALTHY
        out = {"verdict": agg, "stalled": stalled, "probes": probes,
               "breakers": breakers, "degraded": degraded}
        # mesh summary: the slot inventory and evictions, visible without
        # decoding the `device.chip<N>` breaker rows; only once the mesh
        # manager exists (making it here would ask for the device)
        mgr = getattr(sys.modules.get("tpubft_torch.parallel.sharding"),
                      "_MESH_MGR", None)
        if mgr is not None:
            out["mesh"] = mgr.snapshot()
        # offload summary: helper roster / quarantine set / lease
        # counters, visible without decoding per-helper `helper.<id>`
        # breaker rows. Gated on the module being live so offload-off
        # deployments pay nothing (pool construction registers a flight
        # dump provider; don't force that from a read path).
        # (getattr: another thread may be importing the module, which
        # has no _POOL until its import ends)
        pool = getattr(sys.modules.get("tpubft_torch.offload.pool"),
                       "_POOL", None)
        if pool is not None:
            out["offload"] = pool.snapshot()
        with self._mu:
            sections = list(self._info_sections.items())
        for name, fn in sections:
            try:
                out[name] = fn()
            except Exception as e:  # noqa: BLE001 — a section source
                out[name] = f"<error: {e}>"  # must not kill the monitor
        return out

    def render(self) -> str:
        """`status get health` payload."""
        return json.dumps(self.verdict(), sort_keys=True)

    # ------------------------------------------------------------------
    # poll thread
    # ------------------------------------------------------------------
    def start(self) -> None:
        with self._mu:
            if self._running:
                return
            self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"health-{self._name}")
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        t = self._thread
        if t is not None:
            t.join(timeout=2)
            self._thread = None

    def _run(self) -> None:
        while self._running:
            time.sleep(self.poll_s)
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the watchdog must outlive
                log.exception("health poll failed")   # anything it watches

    def poll_once(self) -> Dict:
        """One verdict pass: refresh metrics, fire stall dumps for
        probes newly past their threshold. Public for tests (and usable
        without the thread)."""
        v = self.verdict()
        self.m_verdict.set(v["verdict"])
        self.m_stalled_probes.set(len(v["stalled"]))
        # flight-dump plane: every transition INTO a non-healthy
        # verdict captures the timeline that led there (rings + kernel
        # profile + lock hold stats + queue depths ride the artifact)
        if v["verdict"] != self._last_verdict:
            flight.record(flight.EV_HEALTH,
                          arg={HEALTHY: 0, DEGRADED: 1,
                               STALLED: 2}.get(v["verdict"], 0))
            now = self._clock()
            throttled = (self._last_dump_at is not None
                         and now - self._last_dump_at
                         < self.dump_min_interval_s)
            if v["verdict"] in (DEGRADED, STALLED) and not throttled:
                self._last_dump_at = now
                path = flight.dump(
                    reason=f"{self._name}-{v['verdict']}",
                    extra={"probes": v["probes"],
                           "breakers": v["breakers"],
                           "degraded": v["degraded"],
                           "stalled": v["stalled"]})
                if path is not None:
                    self.last_flight_dump = path
                    self.m_flight_dumps.inc()
                    log.warning("%s: verdict %s -> %s; flight dump "
                                "written to %s", self._name,
                                self._last_verdict, v["verdict"], path)
            self._last_verdict = v["verdict"]
        self.m_breakers.set(json.dumps(
            {n: b["state"] for n, b in v["breakers"].items()},
            sort_keys=True))
        for p in v["probes"]:
            g = self._age_gauges.get(p["name"])
            if g is not None:
                g.set(int(p["age_ms"]))
        fresh = []
        with self._mu:
            for name in v["stalled"]:
                p = self._probes.get(name)
                if p is not None and not p.reported:
                    p.reported = True
                    fresh.append(name)
        if fresh:
            self.m_stall_dumps.inc(len(fresh))
            self._dump(fresh, v)
        return v

    def _dump(self, stalled: List[str], v: Dict) -> None:
        lines = [f"{self._name}: STALL verdict — no progress from "
                 f"{stalled} past threshold; state and all thread "
                 f"stacks follow",
                 "probes: " + json.dumps(v["probes"]),
                 "breakers: " + json.dumps(v["breakers"]),
                 "degraded: " + json.dumps(v["degraded"])]
        if self.last_flight_dump:
            lines.append(f"flight dump: {self.last_flight_dump}")
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in frames.items():
            lines.append(f"--- thread {names.get(ident, ident)} ---")
            lines.append("".join(traceback.format_stack(frame)))
        log.error("%s", "\n".join(lines))
