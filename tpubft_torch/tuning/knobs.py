"""Typed knob registry — the actuator surface the controller drives
(port of tpubft/tuning/knobs.py).

A `Knob` is one live tunable: a bounded integer value with a
multiplicative step policy, per-knob hysteresis (consecutive
same-direction policy votes required before a move) and cooldown
(minimum interval between moves), and a `frozen` pin that makes the
operator the only writer. The registry is the ONE mutation path: every
store goes through `KnobRegistry.set`, which clamps to bounds under the
registry lock and then pushes the applied value into the live actuator
via the knob's `apply_fn` (outside the lock — actuators take their own
locks, and the registry must never hold its lock across them).

Seed files hand a measured operating point to the next process (a
replica writes one on clean shutdown, `TuningController.write_seed`):
JSON ``{"knobs": {name: value | {"value": v,
"frozen": true}}}``, loaded at replica wiring via
``ReplicaConfig.autotune_seed_file``. Unknown names are ignored with a
log line — a seed measured on one build must not wedge a newer one.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from tpubft_torch.utils.logging import get_logger
from tpubft_torch.utils.racecheck import make_lock

log = get_logger("tuning")

GROW = 1
HOLD = 0
SHRINK = -1


@dataclass
class Knob:
    """One live tunable. `value` is read lock-free by hot paths that
    hold a reference (an int attribute read is atomic); every WRITE
    goes through `KnobRegistry.set`."""

    name: str
    value: int
    default: int
    lo: int
    hi: int
    # multiplicative step policy: grow multiplies by step_up, shrink by
    # step_down (always moving at least 1 so small values still step)
    step_up: float = 1.5
    step_down: float = 0.5
    # consecutive same-direction policy votes required before a move
    # (>= 2 means one noisy sample can never flip a knob)
    hysteresis: int = 2
    # minimum seconds between controller moves of this knob
    cooldown_s: float = 3.0
    # operator pin: policies and degraded resets never touch it
    frozen: bool = False
    # pushes an applied value into the live actuator (None = pull-style
    # consumers read knob.value / registry.get themselves)
    apply_fn: Optional[Callable[[int], None]] = None
    unit: str = ""
    # doc string for the catalog: which telemetry drives this knob
    sensor: str = ""
    # controller bookkeeping (registry-lock guarded). A never-moved
    # knob must never read as in-cooldown, whatever the monotonic
    # clock's origin — hence -inf, not 0.
    last_change_mono: float = float("-inf")
    changes: int = 0
    direction_flips: int = 0
    _last_move_dir: int = field(default=0, repr=False)
    _streak_dir: int = field(default=0, repr=False)
    _streak_n: int = field(default=0, repr=False)

    def clamp(self, v: int) -> int:
        return max(self.lo, min(self.hi, int(v)))

    def stepped(self, direction: int) -> int:
        """Next value in `direction` under the step policy (unclamped)."""
        if direction == GROW:
            return max(self.value + 1, int(self.value * self.step_up))
        if direction == SHRINK:
            return min(self.value - 1, int(self.value * self.step_down))
        return self.value

    def snapshot(self) -> Dict:
        return {"value": self.value, "default": self.default,
                "lo": self.lo, "hi": self.hi, "unit": self.unit,
                "frozen": self.frozen, "sensor": self.sensor,
                "changes": self.changes,
                "direction_flips": self.direction_flips,
                "hysteresis": self.hysteresis,
                "cooldown_s": self.cooldown_s}


class KnobRegistry:
    """All knobs of one replica. Thread discipline: values mutate ONLY
    inside `set` under the registry lock (the lexical make_lock region;
    a knob store anywhere else is a race), apply callbacks run after
    release."""

    def __init__(self, name: str = "tuning",
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._name = name
        self._clock = clock
        self._mu = make_lock(f"{name}.knobs")
        self._knobs: Dict[str, Knob] = {}
        self._ids: Dict[str, int] = {}     # flight-event knob ids

    # ------------------------------------------------------------------
    # registration / lookup
    # ------------------------------------------------------------------
    def register(self, knob: Knob) -> Knob:
        with self._mu:
            if knob.name in self._knobs:
                raise ValueError(f"knob {knob.name!r} already registered")
            knob.value = knob.clamp(knob.value)
            self._knobs[knob.name] = knob
            self._ids[knob.name] = len(self._ids) + 1
        return knob

    def knob(self, name: str) -> Knob:
        with self._mu:
            return self._knobs[name]

    def get(self, name: str, default: Optional[int] = None) -> int:
        with self._mu:
            k = self._knobs.get(name)
            if k is None:
                if default is None:
                    raise KeyError(name)
                return default
            return k.value

    def names(self) -> List[str]:
        with self._mu:
            return list(self._knobs)

    def knob_id(self, name: str) -> int:
        with self._mu:
            return self._ids.get(name, 0)

    def id_table(self) -> Dict[int, str]:
        with self._mu:
            return {v: k for k, v in self._ids.items()}

    # ------------------------------------------------------------------
    # mutation — the one store path
    # ------------------------------------------------------------------
    def set(self, name: str, value: int, source: str = "manual",
            force: bool = False) -> Optional[int]:
        """Clamp-and-store; returns the applied value, or None when the
        store was a no-op (same value, unknown knob, or a frozen knob
        and the caller is not the operator `force`)."""
        with self._mu:
            k = self._knobs.get(name)
            if k is None:
                return None
            if k.frozen and not force:
                return None
            v = k.clamp(value)
            old = k.value
            if v == old:
                return None
            k.value = v
            k.changes += 1
            direction = GROW if v > old else SHRINK
            if k._last_move_dir and direction != k._last_move_dir:
                k.direction_flips += 1
            k._last_move_dir = direction
            k.last_change_mono = self._clock()
            apply_fn = k.apply_fn
        # outside the lock: actuators take their own locks, and the
        # registry lock must never nest over them (lock-order pass)
        if apply_fn is not None:
            try:
                apply_fn(v)
            except Exception:  # noqa: BLE001 — a failing actuator push
                log.exception("knob %s apply failed (value=%s)", name, v)
        return v

    def rebase_default(self, name: str, value: int) -> None:
        """Re-baseline a knob's default (the degraded-reset target) —
        a seeded measured operating point IS this host's default."""
        with self._mu:
            k = self._knobs[name]
            k.default = k.clamp(int(value))

    def freeze(self, name: str, value: Optional[int] = None) -> None:
        """Operator pin: optionally set, then stop every policy (and
        degraded reset) from moving this knob."""
        if value is not None:
            self.set(name, value, source="pin", force=True)
        with self._mu:
            self._knobs[name].frozen = True

    def unfreeze(self, name: str) -> None:
        with self._mu:
            self._knobs[name].frozen = False

    def reset_to_defaults(self, source: str = "degraded"
                          ) -> List[tuple]:
        """Back every unpinned knob off to its configured default (the
        degradation rule: never fight the health plane). Returns the
        (name, old, new) changes actually made."""
        with self._mu:
            todo = [(k.name, k.value, k.default)
                    for k in self._knobs.values()
                    if not k.frozen and k.value != k.default]
        changes = []
        for name, old, default in todo:
            applied = self.set(name, default, source=source)
            if applied is not None:
                changes.append((name, old, applied))
        return changes

    # ------------------------------------------------------------------
    # hysteresis / cooldown bookkeeping (controller-side helpers; under
    # the registry lock so vote state is consistent with values)
    # ------------------------------------------------------------------
    def vote(self, name: str, direction: int) -> bool:
        """Record one policy vote for `name`; True when the knob is due
        a move: `hysteresis` consecutive same-direction votes AND past
        its cooldown AND not frozen. HOLD votes reset the streak."""
        with self._mu:
            k = self._knobs.get(name)
            if k is None or k.frozen:
                return False
            if direction == HOLD:
                k._streak_dir = 0
                k._streak_n = 0
                return False
            if direction == k._streak_dir:
                k._streak_n += 1
            else:
                k._streak_dir = direction
                k._streak_n = 1
            if k._streak_n < k.hysteresis:
                return False
            if self._clock() - k.last_change_mono < k.cooldown_s:
                return False
            return True

    def step(self, name: str, direction: int,
             source: str = "policy") -> Optional[int]:
        """Apply one policy step in `direction` (already voted through
        `vote`). Returns the applied value or None (clamped no-op)."""
        with self._mu:
            k = self._knobs.get(name)
            if k is None:
                return None
            target = k.stepped(direction)
        return self.set(name, target, source=source)

    def snapshot(self) -> Dict[str, Dict]:
        with self._mu:
            return {name: k.snapshot() for name, k in self._knobs.items()}


# ----------------------------------------------------------------------
# seed-file I/O (measured operating point → next replica boot)
# ----------------------------------------------------------------------
def write_seed(path: str, knobs: Dict[str, object],
               note: str = "") -> str:
    """Write a knob-registry seed file: {"knobs": {name: value |
    {"value": v, "frozen": bool}}}. Returns the path."""
    payload = {"knobs": knobs}
    if note:
        payload["note"] = note
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
    return path


def load_seed(registry: KnobRegistry, path: str) -> int:
    """Apply a seed file to `registry`; returns how many knobs were
    seeded. Unknown knob names are logged and skipped (forward/backward
    compatible), malformed files raise (a requested seed that cannot
    parse is an operator error, not a default)."""
    with open(path, "r", encoding="utf-8") as fh:
        payload = json.load(fh)
    entries = payload.get("knobs", {})
    if not isinstance(entries, dict):
        raise ValueError(f"seed file {path}: 'knobs' must be an object")
    seeded = 0
    known = set(registry.names())
    for name, spec in entries.items():
        if name not in known:
            log.warning("seed %s: unknown knob %r ignored", path, name)
            continue
        frozen = False
        if isinstance(spec, dict):
            value = spec.get("value")
            frozen = bool(spec.get("frozen", False))
        else:
            value = spec
        if value is not None:
            registry.set(name, int(value), source="seed", force=True)
            # seeding re-baselines the degraded-reset target too: a
            # measured operating point IS this host's default
            registry.rebase_default(name, int(value))
            seeded += 1
        if frozen:
            registry.freeze(name)
    return seeded
