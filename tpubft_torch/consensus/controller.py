"""Commit-path controller: adaptive fast/slow path selection.

Rebuild of the reference's ControllerWithSimpleHistory
(concord-bft bftengine/src/bftengine/ControllerWithSimpleHistory.cpp):
the primary evaluates, per window of sequence numbers, whether the fast
path is completing; repeated fast-path failures demote new PrePrepares to
a slower path, sustained success upgrades back. Also owns the
fast-path-timeout decision that triggers StartSlowCommit for an in-flight
seqnum (reference ReplicaImp's commit-path timer).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from tpubft_torch.consensus.messages import CommitPath

EVALUATION_WINDOW = 16          # reference EvaluationPeriod
DOWNGRADE_FAILURE_RATIO = 0.3   # >30% slow fallbacks in a window: demote
UPGRADE_SUCCESS_RATIO = 0.9     # >=90% fast success while demoted: promote


@dataclass
class PathStats:
    fast_completions: int = 0
    slow_fallbacks: int = 0

    @property
    def total(self) -> int:
        return self.fast_completions + self.slow_fallbacks


class CommitPathController:
    def __init__(self, f: int, c: int, start_path: CommitPath = None):
        self._f = f
        self._c = c
        # reference default: OPTIMISTIC_FAST when c == 0 (all n replicas
        # expected), FAST_WITH_THRESHOLD when c > 0
        if start_path is None:
            start_path = (CommitPath.OPTIMISTIC_FAST if c == 0
                          else CommitPath.FAST_WITH_THRESHOLD)
        self._current = start_path
        self._stats = PathStats()
        self._slow_probe = 0

    @property
    def current_path(self) -> CommitPath:
        return self._current

    def on_fast_path_commit(self, seq_num: int) -> None:
        """A seqnum proposed on a fast path committed via its fast path."""
        self._stats.fast_completions += 1
        self._maybe_adapt()

    def on_slow_fallback(self, seq_num: int) -> None:
        """A seqnum proposed on a fast path had to commit via slow."""
        self._stats.slow_fallbacks += 1
        self._maybe_adapt()

    def on_slow_path_commit(self, seq_num: int) -> None:
        """A seqnum proposed as SLOW committed. After a full window of
        stability, probe one step faster (the reference periodically
        retries the faster path rather than staying demoted forever)."""
        if self._current is not CommitPath.SLOW:
            return
        self._slow_probe += 1
        if self._slow_probe >= EVALUATION_WINDOW:
            self._slow_probe = 0
            self._current = self._next_faster(self._current)
            self._stats = PathStats()

    def _maybe_adapt(self) -> None:
        if self._stats.total < EVALUATION_WINDOW:
            return
        failure_ratio = self._stats.slow_fallbacks / self._stats.total
        if self._current != CommitPath.SLOW \
                and failure_ratio > DOWNGRADE_FAILURE_RATIO:
            self._current = self._next_slower(self._current)
        elif self._current != self._fastest() \
                and (1 - failure_ratio) >= UPGRADE_SUCCESS_RATIO:
            self._current = self._next_faster(self._current)
        self._stats = PathStats()

    def _fastest(self) -> CommitPath:
        return (CommitPath.OPTIMISTIC_FAST if self._c == 0
                else CommitPath.FAST_WITH_THRESHOLD)

    @staticmethod
    def _next_slower(p: CommitPath) -> CommitPath:
        return CommitPath(min(int(p) + 1, int(CommitPath.SLOW)))

    @staticmethod
    def _next_faster(p: CommitPath) -> CommitPath:
        return CommitPath(max(int(p) - 1, int(CommitPath.OPTIMISTIC_FAST)))
