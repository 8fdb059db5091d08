"""Persistent consensus metadata — crash-recovery write-ahead state.

Rebuild of the reference's PersistentStorageImp
(concord-bft bftengine/src/bftengine/PersistentStorageImp.cpp) +
ReplicaLoader (ReplicaLoader.cpp): transactional `begin/end_write_tran`
bracketing, descriptors (lastView, lastExecutedSeq, lastStableSeq), and
the seqnum-window contents (PrePrepare / full certificates) so a crashed
replica rejoins mid-protocol safely.

Two backends: InMemoryPersistentStorage (tests, NullStateTransfer-style)
and FilePersistentStorage (append-only JSON-lines WAL with atomic snapshot
compaction — the MetadataStorage-over-IDBClient role).
"""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from tpubft_torch.consensus import messages as m


@dataclass
class PersistedSeqState:
    pre_prepare: Optional[bytes] = None        # packed PrePrepareMsg
    prepare_full: Optional[bytes] = None       # packed PrepareFullMsg
    commit_full: Optional[bytes] = None        # packed CommitFullMsg
    full_commit_proof: Optional[bytes] = None  # packed FullCommitProofMsg
    slow_started: bool = False


class _TrackingSeqStates(dict):
    """seq_states dict that records per-seq dirt/deletions so incremental
    backends (DBPersistentStorage) persist only what changed in a
    transaction instead of re-encoding the full window every commit."""

    __slots__ = ("owner",)

    def __init__(self, owner: "PersistedState"):
        super().__init__()
        self.owner = owner

    def __setitem__(self, k, v):
        super().__setitem__(k, v)
        self.owner.dirty_seqs.add(k)
        self.owner.deleted_seqs.discard(k)

    def __delitem__(self, k):
        super().__delitem__(k)
        self.owner.dirty_seqs.discard(k)
        self.owner.deleted_seqs.add(k)

    def pop(self, k, *default):
        if k in self:
            self.owner.dirty_seqs.discard(k)
            self.owner.deleted_seqs.add(k)
        return super().pop(k, *default)

    def clear(self):
        self.owner.deleted_seqs.update(self.keys())
        self.owner.dirty_seqs.clear()
        super().clear()

    def update(self, *args, **kwargs):
        for k, v in dict(*args, **kwargs).items():
            self[k] = v                 # route through tracking

    def setdefault(self, k, default=None):
        if k not in self:
            self[k] = default           # route through tracking
        return super().__getitem__(k)


@dataclass
class PersistedState:
    """Everything needed to rejoin safely after a crash."""
    last_view: int = 0
    last_executed_seq: int = 0
    last_stable_seq: int = 0
    in_view_change: bool = False
    # target view of an in-flight view change (0 = none): a replica that
    # crashes between persisting in_view_change and completing the change
    # must know WHICH view it was moving to, or it cannot rebuild and
    # retransmit its ViewChangeMsg on restart (the quorum may be counting
    # on it)
    pending_view: int = 0
    seq_states: Dict[int, PersistedSeqState] = None  # set in __post_init__
    # view-change safety state (reference PersistentStorageDescriptors):
    # packed view_change.Restriction / messages.PreparedCertificate blobs
    restrictions: List[bytes] = field(default_factory=list)
    carried_certs: List[bytes] = field(default_factory=list)
    # packed PrePrepare bodies for the digests in carried_certs — certs
    # travel digest-only, so the bodies that must survive a crash live here
    carried_bodies: List[bytes] = field(default_factory=list)

    def __post_init__(self):
        # change-tracking for incremental backends; a seq appears in at
        # most one of the two sets. Backends drain both at commit.
        self.dirty_seqs: set = set()
        self.deleted_seqs: set = set()
        states = _TrackingSeqStates(self)
        if self.seq_states:                 # dataclasses.replace paths
            states.update(self.seq_states)
        self.seq_states = states

    def seq(self, seq_num: int) -> PersistedSeqState:
        st = self.seq_states.get(seq_num)
        if st is None:
            st = self.seq_states[seq_num] = PersistedSeqState()
        else:
            # the caller got a mutable entry: assume it changes
            self.dirty_seqs.add(seq_num)
        return st

    def clear_tracking(self) -> None:
        self.dirty_seqs.clear()
        self.deleted_seqs.clear()


class PersistentStorage:
    """Interface (reference PersistentStorage.hpp). Mutations must happen
    inside begin/end_write_tran; end commits atomically."""

    def begin_write_tran(self) -> PersistedState:
        raise NotImplementedError

    def end_write_tran(self) -> None:
        raise NotImplementedError

    def load(self) -> PersistedState:
        raise NotImplementedError


class InMemoryPersistentStorage(PersistentStorage):
    def __init__(self) -> None:
        self._state = PersistedState()
        self._depth = 0

    def begin_write_tran(self) -> PersistedState:
        self._depth += 1
        return self._state

    def end_write_tran(self) -> None:
        assert self._depth > 0
        self._depth -= 1
        if self._depth == 0:
            self._state.clear_tracking()    # whole state is live anyway

    def load(self) -> PersistedState:
        return self._state


class FilePersistentStorage(PersistentStorage):
    """Append-only WAL of state deltas with whole-state snapshots.

    Simple but crash-consistent: every end_write_tran appends one fsynced
    JSON line holding the FULL descriptor state + dirty seq entries;
    recovery replays the last complete line. Compaction rewrites the file
    atomically (tempfile + rename) when it grows past `compact_bytes`.
    """

    def __init__(self, path: str, compact_bytes: int = 4 << 20):
        self._path = path
        self._compact_bytes = compact_bytes
        self._state = self._recover()
        self._depth = 0
        self._fh = open(self._path, "ab")

    # ---- transactions ----
    def begin_write_tran(self) -> PersistedState:
        self._depth += 1
        return self._state

    def end_write_tran(self) -> None:
        assert self._depth > 0
        self._depth -= 1
        if self._depth == 0:
            self._state.clear_tracking()    # full-state WAL line follows
            line = json.dumps(self._encode(self._state),
                              separators=(",", ":")) + "\n"
            self._fh.write(line.encode())
            self._fh.flush()
            os.fsync(self._fh.fileno())
            if self._fh.tell() > self._compact_bytes:
                self._compact()

    def load(self) -> PersistedState:
        return self._state

    def close(self) -> None:
        self._fh.close()

    # ---- encoding ----
    @staticmethod
    def _encode(st: PersistedState) -> Dict[str, Any]:
        def b64(x: Optional[bytes]) -> Optional[str]:
            import base64
            return base64.b64encode(x).decode() if x is not None else None
        return {
            "v": st.last_view, "e": st.last_executed_seq,
            "s": st.last_stable_seq, "ivc": st.in_view_change,
            "pv": st.pending_view,
            "seqs": {str(k): {
                "pp": b64(v.pre_prepare), "pf": b64(v.prepare_full),
                "cf": b64(v.commit_full), "fcp": b64(v.full_commit_proof),
                "slow": v.slow_started,
            } for k, v in st.seq_states.items()},
            "restr": [b64(r) for r in st.restrictions],
            "certs": [b64(c) for c in st.carried_certs],
            "bodies": [b64(c) for c in st.carried_bodies],
        }

    @staticmethod
    def _decode(d: Dict[str, Any]) -> PersistedState:
        import base64

        def unb64(x: Optional[str]) -> Optional[bytes]:
            return base64.b64decode(x) if x is not None else None
        st = PersistedState(last_view=d["v"], last_executed_seq=d["e"],
                            last_stable_seq=d["s"], in_view_change=d["ivc"],
                            pending_view=d.get("pv", 0),
                            restrictions=[unb64(r)
                                          for r in d.get("restr", [])],
                            carried_certs=[unb64(c)
                                           for c in d.get("certs", [])],
                            carried_bodies=[unb64(c)
                                            for c in d.get("bodies", [])])
        for k, v in d.get("seqs", {}).items():
            st.seq_states[int(k)] = PersistedSeqState(
                pre_prepare=unb64(v["pp"]), prepare_full=unb64(v["pf"]),
                commit_full=unb64(v["cf"]),
                full_commit_proof=unb64(v["fcp"]), slow_started=v["slow"])
        return st

    def _recover(self) -> PersistedState:
        if not os.path.exists(self._path):
            return PersistedState()
        last = None
        with open(self._path, "rb") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    last = json.loads(line)
                except json.JSONDecodeError:
                    break  # torn tail write: stop at last complete line
        return self._decode(last) if last else PersistedState()

    def _compact(self) -> None:
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self._path) or ".")
        with os.fdopen(fd, "wb") as out:
            out.write((json.dumps(self._encode(self._state),
                                  separators=(",", ":")) + "\n").encode())
            out.flush()
            os.fsync(out.fileno())
        os.replace(tmp, self._path)
        self._fh.close()
        self._fh = open(self._path, "ab")


def restore_replica_state(storage: PersistentStorage):
    """ReplicaLoader::loadReplica equivalent — returns the PersistedState
    plus unpacked window messages ready to seed a Replica."""
    st = storage.load()
    unpacked = {}
    for seq, entry in st.seq_states.items():
        if seq <= st.last_stable_seq:
            continue
        row = {}
        for name, raw in (("pre_prepare", entry.pre_prepare),
                          ("prepare_full", entry.prepare_full),
                          ("commit_full", entry.commit_full),
                          ("full_commit_proof", entry.full_commit_proof)):
            if raw is not None:
                try:
                    row[name] = m.unpack(raw)
                except m.MsgError:
                    row[name] = None
        row["slow_started"] = entry.slow_started
        unpacked[seq] = row
    return st, unpacked
