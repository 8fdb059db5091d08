"""SlowdownManager — phase-tagged delay/drop fault injection.

Rebuild of concord-bft performance/include/SlowdownManager.hpp:32-145
(compile-time-gated there via BUILD_SLOWDOWN; runtime-gated here): named
pipeline phases consult the process-wide manager, which is a no-op unless
a policy was installed. Tests install policies to simulate slow storage,
slow pre-execution, or message-drop pressure without touching protocol
code.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

# phase names (SlowdownPhase enum in the reference)
PHASE_CLIENT_REQUEST = "client_request"
PHASE_PRE_EXECUTE = "pre_execute"
PHASE_COMMIT = "commit"
PHASE_EXECUTE = "execute"
PHASE_STORAGE_WRITE = "storage_write"


@dataclass
class SlowdownPolicy:
    delay_ms: float = 0.0
    jitter_ms: float = 0.0
    drop_rate: float = 0.0   # probability a phase reports "drop this"


class SlowdownManager:
    def __init__(self) -> None:
        self._policies: Dict[str, SlowdownPolicy] = {}
        self._rng = random.Random(5160)
        self._lock = threading.Lock()
        self.enabled = False

    def install(self, phase: str, policy: SlowdownPolicy) -> None:
        with self._lock:
            self._policies[phase] = policy
            self.enabled = True

    def clear(self) -> None:
        with self._lock:
            self._policies.clear()
            self.enabled = False

    def delay_only(self, phase: str) -> None:
        """Apply only the delay component — for phases where dropping is
        not meaningful (e.g. ordered execution, which must stay
        deterministic across replicas)."""
        if not self.enabled:
            return
        with self._lock:
            policy = self._policies.get(phase)
            if policy is None:
                return
            jitter = self._rng.random() * policy.jitter_ms
        if policy.delay_ms or jitter:
            time.sleep((policy.delay_ms + jitter) / 1000.0)

    def delay(self, phase: str) -> bool:
        """Apply the phase's policy. Returns True if the operation should
        be DROPPED (delay already applied otherwise)."""
        if not self.enabled:
            return False
        with self._lock:
            policy = self._policies.get(phase)
            if policy is None:
                return False
            roll = self._rng.random()
            jitter = self._rng.random() * policy.jitter_ms
        if policy.delay_ms or jitter:
            time.sleep((policy.delay_ms + jitter) / 1000.0)
        return roll < policy.drop_rate


_manager = SlowdownManager()


def get_slowdown_manager() -> SlowdownManager:
    return _manager
