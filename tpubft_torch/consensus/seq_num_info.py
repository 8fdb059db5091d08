"""Per-seqnum consensus state + the sliding work window.

Rebuild of the reference's SeqNumInfo
(concord-bft bftengine/src/bftengine/SeqNumInfo.hpp:34) and
SequenceWithActiveWindow (SequenceWithActiveWindow.hpp): each in-flight
seqnum holds the PrePrepare, the prepare/commit share collectors (slow
path), the fast-path collector, and the full (combined) certificates;
the window slides on stable checkpoints.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Generic, Iterator, Optional, TypeVar

from tpubft_torch.consensus.collectors import ShareCollector
from tpubft_torch.consensus.messages import (CommitFullMsg, FullCommitProofMsg,
                                       PrePrepareMsg, PrepareFullMsg)


@dataclass
class SeqNumInfo:
    seq_num: int
    pre_prepare: Optional[PrePrepareMsg] = None
    commit_path: Optional[int] = None          # CommitPath actually taken
    slow_started: bool = False
    # slow path
    prepare_collector: Optional[ShareCollector] = None
    prepare_full: Optional[PrepareFullMsg] = None
    commit_collector: Optional[ShareCollector] = None
    commit_full: Optional[CommitFullMsg] = None
    # fast path
    fast_collector: Optional[ShareCollector] = None
    full_commit_proof: Optional[FullCommitProofMsg] = None
    # flags
    prepared: bool = False
    committed: bool = False
    executed: bool = False
    # optimistic reply plane: the slot was released to the client-visible
    # path on a STRUCTURALLY-valid commit cert (pairing verify still in
    # flight) — reply visibility only, `committed` still gates persistence
    opt_committed: bool = False
    opt_committed_ns: int = 0                  # monotonic_ns at release
    # slot handed to the execution lane (run in flight or queued): the
    # dispatcher's guard against double-submitting a slot whose
    # committed certificate is re-accepted while the lane still owns it
    exec_submitted: bool = False
    # slot handed to the lane SPECULATIVELY (prepare-quorum / fast-path
    # acceptance, commit certificate still combining): cleared when the
    # commit confirms (→ exec_submitted) or the speculation aborts
    spec_submitted: bool = False
    received_at: float = 0.0                   # monotonic, for path timeout
    # shares that arrived before our PrePrepare did (reference keeps them
    # in the collectors keyed by digest; we buffer until digest is known)
    early_shares: Dict[str, list] = field(default_factory=dict)
    # async verification state: the exact messages whose verify jobs are
    # in flight (identity-checked when the verdict re-enters, so a stale
    # verdict for a dropped/replaced message can't clear a newer job's
    # guard): the PrePrepare being batch-verified / per-kind full certs
    pp_verifying: Optional[PrePrepareMsg] = None
    cert_verifying: Dict[str, object] = field(default_factory=dict)
    # full certs that arrived before the PrePrepare was accepted (window
    # widened by async PP verification), keyed (kind, sender): one slot
    # PER SENDER, so a byzantine peer's forgeries can only ever displace
    # that peer's own buffered certs, never the honest collector's
    # (bounded at n_kinds x n_replicas entries)
    early_certs: Dict[tuple, object] = field(default_factory=dict)
    # certs that arrived while a same-kind verify job was in flight,
    # keyed (kind, sender) for the same anti-shadowing reason; retried
    # when the in-flight verdict lands
    cert_pending: Dict[tuple, object] = field(default_factory=dict)
    # when evidence (shares/certs) first arrived WITHOUT a PrePrepare —
    # the ReqMissingDataMsg trigger clock
    first_evidence_at: float = 0.0
    # open consensus-slot tracing span (accept -> executed)
    span: Optional[object] = None


T = TypeVar("T")


class ActiveWindow(Generic[T]):
    """Sliding window keyed by seqnum: (stable, stable + size]. The
    reference's SequenceWithActiveWindow with kWorkWindowSize=300."""

    def __init__(self, size: int, factory):
        self._size = size
        self._factory = factory
        self._base = 0                         # last stable seq
        self._items: Dict[int, T] = {}

    @property
    def base(self) -> int:
        return self._base

    def in_window(self, seq: int) -> bool:
        return self._base < seq <= self._base + self._size

    def get(self, seq: int) -> T:
        if not self.in_window(seq):
            raise KeyError(f"seq {seq} outside window "
                           f"({self._base}, {self._base + self._size}]")
        item = self._items.get(seq)
        if item is None:
            item = self._items[seq] = self._factory(seq)
        return item

    def peek(self, seq: int) -> Optional[T]:
        return self._items.get(seq)

    def advance(self, new_base: int) -> None:
        """Slide forward on stable checkpoint; drops state <= new_base."""
        if new_base <= self._base:
            return
        self._base = new_base
        for s in [s for s in self._items if s <= new_base]:
            del self._items[s]

    def drop(self, seq: int) -> None:
        """Discard one entry (view change wipes in-flight state)."""
        self._items.pop(seq, None)

    def items(self) -> Iterator:
        return iter(sorted(self._items.items()))
