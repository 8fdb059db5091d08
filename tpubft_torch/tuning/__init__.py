"""Closed-loop autotuner — the actuator half of the telemetry plane
(port of tpubft/tuning/).

The telemetry plane's sensors (breaker verdicts, HealthMonitor verdicts,
flight-recorder stage histograms, kernel-profiler batch stats) feed
every performance actuator: flush windows, batch caps, accumulation
depth, admission watermarks, the ECDSA device/host crossover. This
package closes the loop: a per-replica `TuningController` thread
periodically snapshots the telemetry plane and drives registered
`Knob`s through per-knob policies, within operator-configured bounds,
with hysteresis and cooldown so one noisy sample never flips a knob,
and with one hard rule — when the HealthMonitor leaves `healthy` or any
breaker opens, every unpinned knob backs off to its configured default
(the controller never fights the degradation plane).

Layout:

  * ``knobs.py``     — `Knob` + `KnobRegistry` (bounds, step policy,
                       hysteresis/cooldown bookkeeping, frozen pins,
                       seed-file I/O);
  * ``policies.py``  — the per-knob direction policies (grow/shrink/
                       hold) over a `Telemetry` snapshot;
  * ``controller.py``— the `TuningController` loop, decision log,
                       `tuning` metrics component, `EV_TUNE` flight
                       events, `status get tuning` payload;
  * ``wiring.py``    — `build_replica_tuning(replica, cfg)`: the knob
                       catalog for one replica, bound to its live
                       actuator seams.

The knob catalog is in `wiring.py`; operators pin knobs
(`KnobRegistry.freeze`), hand a measured operating point over in a seed
file (`ReplicaConfig.autotune_seed_file`) and read the decisions with
`status get tuning` (`TuningController.render`).
"""
from tpubft_torch.tuning.knobs import (Knob, KnobRegistry, load_seed,
                                       write_seed)
from tpubft_torch.tuning.controller import TuningController
from tpubft_torch.tuning.wiring import build_replica_tuning

__all__ = ["Knob", "KnobRegistry", "TuningController",
           "build_replica_tuning", "load_seed", "write_seed"]
