"""Digests (reference: util/include/Digest.hpp, DigestType.hpp — SHA-256, 32B).

Also provides the digest combinations the protocol uses:
`calc_combination(digest, view, seq)` mirrors Digest::calcCombination
(concord-bft util/include/Digest.hpp) used when signing fast-path commit
proofs (ReplicaImp.cpp:1344).
"""
from __future__ import annotations

import hashlib
import struct

DIGEST_SIZE = 32
EMPTY_DIGEST = b"\x00" * DIGEST_SIZE


def digest(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def digest_of_parts(*parts: bytes) -> bytes:
    h = hashlib.sha256()
    for p in parts:
        h.update(struct.pack("<Q", len(p)))
        h.update(p)
    return h.digest()


def calc_combination(d: bytes, view: int, seq: int) -> bytes:
    """Bind a content digest to its consensus slot (view, seqnum)."""
    return hashlib.sha256(struct.pack("<QQ", view, seq) + d).digest()
