"""Counter state machine — the reference's simpleTest app.

Rebuild of concord-bft tests/simpleTest/ (simple_test_replica.hpp):
the state is one signed 64-bit counter; writes add a delta and return the
new value; reads return the current value. Deterministic, so all replicas
agree on the state digest at every checkpoint.

Wire format: op byte 'A' (add) + i64 delta | 'R' (read). Replies: i64.
"""
from __future__ import annotations

import struct
from collections import OrderedDict

from tpubft_torch.consensus.replica import IRequestsHandler
from tpubft_torch.crypto.digest import digest as sha256
from tpubft_torch.utils.racecheck import make_lock

_I64 = struct.Struct("<q")

# replay-idempotence records kept per client. Covers the committed suffix
# a WAL recovery can re-execute (bounded by the per-client in-flight cap,
# consensus.clients_manager.MAX_PENDING_PER_CLIENT = 128, plus slack).
_APPLIED_PER_CLIENT = 512


def encode_add(delta: int) -> bytes:
    return b"A" + _I64.pack(delta)


def encode_read() -> bytes:
    return b"R"


def decode_reply(reply: bytes) -> int:
    return _I64.unpack(reply)[0]


class CounterHandler(IRequestsHandler):
    def __init__(self) -> None:
        self._value = 0
        # client_id -> bounded set of applied req_seqs (membership, not a
        # watermark: requests execute out of seq order, so a lower seq is
        # not evidence of a replay)
        self._applied: dict = {}        # client_id -> OrderedDict[seq, None]
        self._applied_floor: dict = {}  # client_id -> highest evicted seq
        self._lock = make_lock("counter_app")

    def _was_applied(self, client_id: int, req_seq: int) -> bool:
        return (req_seq in self._applied.get(client_id, ())
                or req_seq <= self._applied_floor.get(client_id, 0))

    def _mark_applied(self, client_id: int, req_seq: int) -> None:
        seqs = self._applied.setdefault(client_id, OrderedDict())
        seqs[req_seq] = None
        while len(seqs) > _APPLIED_PER_CLIENT:
            evicted, _ = seqs.popitem(last=False)
            if evicted > self._applied_floor.get(client_id, 0):
                self._applied_floor[client_id] = evicted

    def _persist(self) -> None:
        pass

    @property
    def value(self) -> int:
        return self._value

    def execute(self, client_id: int, req_seq: int, flags: int,
                request: bytes) -> bytes:
        if request[:1] == b"A" and len(request) == 1 + _I64.size:
            delta = _I64.unpack(request[1:])[0]
            with self._lock:
                # replay idempotence: recovery re-executes the committed
                # suffix after the WAL's executed mark, which can trail
                # app state persisted mid-crash (the same reason kvbc
                # replays are keyed by block id — add_block of an
                # existing id is a no-op)
                if req_seq and self._was_applied(client_id, req_seq):
                    return _I64.pack(self._value)
                self._value += delta
                if req_seq:
                    self._mark_applied(client_id, req_seq)
                self._persist()
                return _I64.pack(self._value)
        if request[:1] == b"R":
            return _I64.pack(self._value)
        return b""

    def read(self, client_id: int, request: bytes) -> bytes:
        return _I64.pack(self._value)

    def state_digest(self) -> bytes:
        return sha256(b"counter" + _I64.pack(self._value))


class PersistentCounterHandler(CounterHandler):
    """Counter with durable state — the app-persistence role RocksDB plays
    in the reference (consensus metadata and app state are persisted
    separately; see kvbc/). Survives replica restart."""

    def __init__(self, path: str) -> None:
        super().__init__()
        self._path = path
        try:
            with open(path, "rb") as fh:
                raw = fh.read()
            if len(raw) == _I64.size:       # legacy bare-i64 state file
                self._value = _I64.unpack(raw)[0]
            else:                           # current JSON format
                import json
                st = json.loads(raw)
                self._value = int(st["value"])
                for k, v in st.get("applied", {}).items():
                    if isinstance(v, list):
                        self._applied[int(k)] = OrderedDict(
                            (int(s), None) for s in v)
                    else:   # legacy watermark format: treat as floor
                        self._applied_floor[int(k)] = int(v)
                self._applied_floor.update(
                    {int(k): int(v)
                     for k, v in st.get("floor", {}).items()})
        except (OSError, ValueError, KeyError, struct.error):
            self._value = 0

    def _persist(self) -> None:
        """Value + per-client applied marks in ONE atomic replace: app
        state and its replay-idempotence index must never diverge."""
        import json
        import os
        tmp = self._path + ".tmp"
        applied = {c: list(seqs) for c, seqs in self._applied.items()}
        with open(tmp, "wb") as fh:
            fh.write(json.dumps({"value": self._value,
                                 "applied": applied,
                                 "floor": self._applied_floor}).encode())
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self._path)
