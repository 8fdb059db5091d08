"""Thin-replica wire protocol (port of tpubft/thinreplica/messages.py;
reference proto/thin_replica.proto), length-framed over TCP: u32le frame
length + id byte + codec body."""
from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, field
from typing import List, Tuple

from tpubft_torch.utils import serialize as ser


@dataclass
class ReadStateRequest:
    ID = 1
    key_prefix: bytes = b""
    SPEC = [("key_prefix", "bytes")]


@dataclass
class ReadStateHashRequest:
    ID = 2
    block_id: int = 0
    key_prefix: bytes = b""
    SPEC = [("block_id", "u64"), ("key_prefix", "bytes")]


@dataclass
class SubscribeRequest:
    ID = 3
    block_id: int = 1           # first block wanted
    key_prefix: bytes = b""
    hashes_only: bool = False
    SPEC = [("block_id", "u64"), ("key_prefix", "bytes"),
            ("hashes_only", "bool")]


@dataclass
class UnsubscribeRequest:
    ID = 4
    SPEC = []


@dataclass
class Update:
    ID = 5
    block_id: int = 0
    kv: List[Tuple[bytes, bytes]] = field(default_factory=list)
    SPEC = [("block_id", "u64"),
            ("kv", ("list", ("pair", "bytes", "bytes")))]


@dataclass
class UpdateHash:
    ID = 6
    block_id: int = 0
    digest: bytes = b""
    SPEC = [("block_id", "u64"), ("digest", "bytes")]


@dataclass
class StateDone:
    """End of the ReadState snapshot stream; carries the state hash."""
    ID = 7
    block_id: int = 0
    digest: bytes = b""
    SPEC = [("block_id", "u64"), ("digest", "bytes")]


@dataclass
class ProtocolError:
    ID = 8
    reason: str = ""
    SPEC = [("reason", "str")]


@dataclass
class ReadProofRequest:
    """Merkle proof for a block_merkle key AS OF a retained block
    (reference versioned sparse_merkle proofs via the kvbc adapter)."""
    ID = 9
    block_id: int = 0
    category: str = ""
    key: bytes = b""
    SPEC = [("block_id", "u64"), ("category", "str"), ("key", "bytes")]


@dataclass
class ProofReply:
    ID = 10
    block_id: int = 0
    root: bytes = b""           # category root anchored in that block
    value_hash: bytes = b""     # b"" = key absent at that block
    bitmap: bytes = b""         # sparse_merkle.Proof compressed path
    siblings: List[bytes] = field(default_factory=list)
    # the value itself when the server still holds it at the proven
    # hash (b"" otherwise) — untrusted: the client binds it to
    # value_hash, which the verified audit path proves
    value: bytes = b""
    SPEC = [("block_id", "u64"), ("root", "bytes"),
            ("value_hash", "bytes"), ("bitmap", "bytes"),
            ("siblings", ("list", "bytes")), ("value", "bytes")]


@dataclass
class AnchorRequest:
    """Ask the server for its newest quorum-certified checkpoint anchor:
    the f+1 matching signed CheckpointMsgs plus the raw block row whose
    digest is the certified state digest. The CLIENT verifies the cert
    signatures and the digest binding — the server is untrusted."""
    ID = 11
    SPEC = []


@dataclass
class AnchorReply:
    ID = 12
    ckpt_seq: int = 0           # consensus seqnum of the checkpoint
    block_id: int = 0           # chain height the certified digest binds
    block_raw: bytes = b""      # encoded Block row; sha256 == cert digest
    certs: List[bytes] = field(default_factory=list)  # packed CheckpointMsg
    SPEC = [("ckpt_seq", "u64"), ("block_id", "u64"),
            ("block_raw", "bytes"), ("certs", ("list", "bytes"))]


@dataclass
class BlockRequest:
    """Raw block row for hash-chain verification (the client walks
    parent digests from a certified anchor; the bytes prove themselves)."""
    ID = 13
    block_id: int = 0
    SPEC = [("block_id", "u64")]


@dataclass
class BlockReply:
    ID = 14
    block_id: int = 0
    raw: bytes = b""            # b"" = missing (ahead or pruned)
    SPEC = [("block_id", "u64"), ("raw", "bytes")]


_TYPES = {cls.ID: cls for cls in
          (ReadStateRequest, ReadStateHashRequest, SubscribeRequest,
           UnsubscribeRequest, Update, UpdateHash, StateDone,
           ProtocolError, ReadProofRequest, ProofReply,
           AnchorRequest, AnchorReply, BlockRequest, BlockReply)}


def pack(msg) -> bytes:
    body = bytes([msg.ID]) + ser.encode_msg(msg)
    return struct.pack("<I", len(body)) + body


def unpack_body(body: bytes):
    if not body or body[0] not in _TYPES:
        raise ser.SerializeError(f"unknown TRS msg id {body[:1]!r}")
    return ser.decode_msg(body[1:], _TYPES[body[0]])


def update_hash(block_id: int, kv: List[Tuple[bytes, bytes]]) -> bytes:
    """Canonical per-block update digest (reference kvbc_app_filter
    event-group hashing): order-independent over the kv set."""
    h = hashlib.sha256()
    h.update(struct.pack("<Q", block_id))
    for k, v in sorted(kv):
        h.update(struct.pack("<I", len(k)) + k)
        h.update(struct.pack("<I", len(v)) + v)
    return h.digest()
