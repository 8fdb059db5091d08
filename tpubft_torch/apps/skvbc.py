"""SimpleKVBC — the versioned KV test application (a copy of
tpubft/apps/skvbc.py).

Rebuild of the reference's SKVBC state machine and wire protocol
(concord-bft tests/simpleKVBC/cmf/skvbc_messages.cmf,
TesterReplica/internalCommandsHandler.cpp): a conditional-write KV store
over the categorized blockchain. Writes carry a read_version + readset;
at execution the replica rejects the write (success=False) if any readset
key changed after read_version — the conflict-detection discipline the
reference uses to exercise pre-execution. This is the app Apollo-style
system tests and the linearizability tracker drive.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from tpubft_torch.consensus.replica import IRequestsHandler
from tpubft_torch.kvbc import (BLOCK_MERKLE, VERSIONED_KV, BlockUpdates,
                         KeyValueBlockchain)
from tpubft_torch.utils import serialize as ser
from tpubft_torch.utils.racecheck import make_lock

READ_LATEST = 0  # read_version 0 = latest (reference uses 0 the same way)

_CATEGORY = "kv"


# ---------------- wire messages (skvbc_messages.cmf) ----------------

@dataclass
class ReadRequest:
    ID = 3
    read_version: int = READ_LATEST
    keys: List[bytes] = field(default_factory=list)
    SPEC = [("read_version", "u64"), ("keys", ("list", "bytes"))]


@dataclass
class WriteRequest:
    ID = 4
    read_version: int = 0
    long_exec: bool = False
    readset: List[bytes] = field(default_factory=list)
    writeset: List[Tuple[bytes, bytes]] = field(default_factory=list)
    SPEC = [("read_version", "u64"), ("long_exec", "bool"),
            ("readset", ("list", "bytes")),
            ("writeset", ("list", ("pair", "bytes", "bytes")))]


@dataclass
class GetLastBlockRequest:
    ID = 5
    SPEC = []  # no fields


@dataclass
class GetBlockDataRequest:
    ID = 6
    block_id: int = 0
    SPEC = [("block_id", "u64")]


@dataclass
class ReadReply:
    ID = 7
    reads: List[Tuple[bytes, bytes]] = field(default_factory=list)
    SPEC = [("reads", ("list", ("pair", "bytes", "bytes")))]


@dataclass
class WriteReply:
    ID = 8
    success: bool = False
    latest_block: int = 0
    SPEC = [("success", "bool"), ("latest_block", "u64")]


@dataclass
class GetLastBlockReply:
    ID = 9
    latest_block: int = 0
    SPEC = [("latest_block", "u64")]


_TYPES = {cls.ID: cls for cls in
          (ReadRequest, WriteRequest, GetLastBlockRequest,
           GetBlockDataRequest, ReadReply, WriteReply, GetLastBlockReply)}


def pack(msg) -> bytes:
    return bytes([msg.ID]) + ser.encode_msg(msg)


def unpack(data: bytes):
    if not data or data[0] not in _TYPES:
        raise ser.SerializeError(f"unknown skvbc msg id {data[:1]!r}")
    return ser.decode_msg(data[1:], _TYPES[data[0]])


# ---------------- the state machine ----------------

class SkvbcHandler(IRequestsHandler):
    """InternalCommandsHandler equivalent
    (tests/simpleKVBC/TesterReplica/internalCommandsHandler.hpp:34)."""

    def __init__(self, blockchain: KeyValueBlockchain,
                 merkle: bool = False) -> None:
        """`merkle=True` keeps the kv state in a BLOCK_MERKLE category
        (the reference SKVBC layout): every key is provable with a
        sparse-merkle audit path against the block-anchored root, which
        is what the thin-replica read tier serves. Historical
        (read_version != latest) reads are unsupported in merkle mode —
        the proof plane serves those."""
        self._bc = blockchain
        self._cat_type = BLOCK_MERKLE if merkle else VERSIONED_KV
        self._lock = make_lock("skvbc_app")

    @property
    def blockchain(self) -> KeyValueBlockchain:
        return self._bc

    # -- helpers --
    def _read_at(self, key: bytes, version: int) -> Optional[bytes]:
        if version == READ_LATEST:
            hit = self._bc.get_latest(_CATEGORY, key,
                                      cat_type=self._cat_type)
            return hit[1] if hit else None
        if self._cat_type == BLOCK_MERKLE:
            return None
        return self._bc.get_versioned(_CATEGORY, key, version)

    # -- IRequestsHandler --
    def execute(self, client_id: int, req_seq: int, flags: int,
                request: bytes) -> bytes:
        try:
            msg = unpack(request)
        except ser.SerializeError:
            return b""
        with self._lock:
            if isinstance(msg, WriteRequest):
                return self._execute_write(msg)
            # reads routed through consensus still serve consistent data
            return self._execute_read(msg)

    def _readset_stale(self, msg: WriteRequest) -> bool:
        """Any readset key written after read_version ⇒ stale (the
        conflict-detection discipline of
        internalCommandsHandler.cpp verifyWriteCommand)."""
        for key in msg.readset:
            hit = self._bc.get_latest(_CATEGORY, key,
                                      cat_type=self._cat_type)
            if hit is not None and hit[0] > msg.read_version:
                return True
        return False

    def _execute_write(self, msg: WriteRequest) -> bytes:
        if msg.readset and self._readset_stale(msg):
            return pack(WriteReply(success=False,
                                   latest_block=self._bc.last_block_id))
        bu = BlockUpdates()
        for k, v in msg.writeset:
            bu.put(_CATEGORY, k, v, cat_type=self._cat_type)
        if msg.writeset:
            self._bc.add_block(bu)
        return pack(WriteReply(success=True,
                               latest_block=self._bc.last_block_id))

    def _execute_read(self, msg) -> bytes:
        if isinstance(msg, ReadRequest):
            reads = []
            for k in msg.keys:
                v = self._read_at(k, msg.read_version)
                if v is not None:
                    reads.append((k, v))
            return pack(ReadReply(reads=reads))
        if isinstance(msg, GetLastBlockRequest):
            return pack(GetLastBlockReply(latest_block=self._bc.last_block_id))
        if isinstance(msg, GetBlockDataRequest):
            blk = self._bc.get_block(msg.block_id)
            if blk is None:
                return pack(ReadReply(reads=[]))
            from tpubft_torch.kvbc.categories import decode_block_updates
            bu = decode_block_updates(blk.updates_blob)
            reads = []
            for _name, (_t, cu) in sorted(bu.categories.items()):
                for k in sorted(cu.kv):
                    v = cu.kv[k]
                    if v is not None:
                        reads.append((k, v))
            return pack(ReadReply(reads=reads))
        return b""

    def read(self, client_id: int, request: bytes) -> bytes:
        try:
            msg = unpack(request)
        except ser.SerializeError:
            return b""
        with self._lock:
            return self._execute_read(msg)

    # ---- pre-execution (reference InternalCommandsHandler PRE_PROCESS) --
    def pre_execute(self, client_id: int, req_seq: int,
                    request: bytes) -> Optional[bytes]:
        """Speculative phase: validate + canonicalize the write intent.
        The result must not depend on this replica's block height (f+1
        replicas at different heights must produce identical bytes), so
        the conflict check stays in apply_pre_executed — matching the
        reference, where verifyWriteCommand runs at commit."""
        try:
            msg = unpack(request)
        except ser.SerializeError:
            return None
        if not isinstance(msg, WriteRequest):
            return None
        if msg.long_exec:
            time.sleep(0.05)  # simulated heavy pre-processing
        canonical = WriteRequest(read_version=msg.read_version,
                                 long_exec=False,
                                 readset=sorted(msg.readset),
                                 writeset=sorted(msg.writeset))
        return pack(canonical)

    def pre_exec_conflicted(self, client_id: int, req_seq: int,
                            original_request: bytes,
                            result: bytes) -> bool:
        """Commit-time read-set watermark re-validation (the execution
        lane calls this before applying a pre-executed result): the
        speculation ran over an older snapshot — any readset key
        versioned past the request's read watermark invalidates it.
        Advisory for the replica's fallback decision; _execute_write
        repeats the scan under the lock because it is load-bearing for
        the PLAIN ordering path too (readset point reads — cheap)."""
        try:
            msg = unpack(result)
        except ser.SerializeError:
            return False
        if not isinstance(msg, WriteRequest) or not msg.readset:
            return False
        with self._lock:
            return self._readset_stale(msg)

    def apply_pre_executed(self, client_id: int, req_seq: int, flags: int,
                           original_request: bytes,
                           result: bytes) -> bytes:
        try:
            msg = unpack(result)
        except ser.SerializeError:
            return b""
        if not isinstance(msg, WriteRequest):
            return b""
        with self._lock:
            return self._execute_write(msg)

    def state_digest(self) -> bytes:
        with self._lock:
            return self._bc.state_digest()


class SkvbcClient:
    """Client-side protocol wrapper (reference: apollo util/skvbc.py
    SimpleKVBCProtocol) over a BftClient."""

    def __init__(self, bft_client) -> None:
        self._client = bft_client

    def write(self, writeset: List[Tuple[bytes, bytes]],
              readset: Optional[List[bytes]] = None,
              read_version: int = 0,
              timeout_ms: Optional[int] = None,
              pre_process: bool = False) -> WriteReply:
        req = WriteRequest(read_version=read_version,
                           readset=readset or [], writeset=writeset)
        reply = self._client.send_write(pack(req), timeout_ms=timeout_ms,
                                        pre_process=pre_process)
        return unpack(reply)

    def write_batch(self, writes: List[List[Tuple[bytes, bytes]]],
                    timeout_ms: Optional[int] = None,
                    pre_process: bool = False) -> List[WriteReply]:
        """Several independent write transactions in ONE wire message
        (BftClient.send_write_batch / ClientBatchRequestMsg); each
        element orders and replies separately. pre_process routes every
        element through the pre-execution plane."""
        reqs = [pack(WriteRequest(read_version=0, readset=[], writeset=ws))
                for ws in writes]
        replies = self._client.send_write_batch(reqs, timeout_ms=timeout_ms,
                                                pre_process=pre_process)
        return [unpack(r) for r in replies]

    def read(self, keys: List[bytes], read_version: int = READ_LATEST,
             timeout_ms: Optional[int] = None) -> Dict[bytes, bytes]:
        req = ReadRequest(read_version=read_version, keys=keys)
        reply = self._client.send_read(pack(req), timeout_ms=timeout_ms)
        return dict(unpack(reply).reads)

    def get_last_block(self, timeout_ms: Optional[int] = None) -> int:
        reply = self._client.send_read(pack(GetLastBlockRequest()),
                                       timeout_ms=timeout_ms)
        return unpack(reply).latest_block
