"""Range Validation Tree — append-only Merkle commitment over block digests
(a copy of tpubft/statetransfer/rvt.py).

Rebuild of the reference's RangeValidationTree
(concord-bft bftengine/src/bcstatetransfer/RangeValidationTree.cpp,
RVBManager.hpp:31-59): the source advertises one root in its checkpoint
summary; every fetched block then carries a membership proof, so a
Byzantine source is rejected at the first bad block instead of DOSing the
destination with a long bogus chain.

Design here is a Merkle Mountain Range (append-only, O(log n) proofs,
persistable as a flat pos→hash map) rather than the reference's fixed-
arity RVB tree — same duties, simpler append path, and old roots stay
provable because node positions never move.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from tpubft_torch.storage.interfaces import IDBClient, WriteBatch

_PARENT = b"\x02"
_BAG = b"\x03"
_ROOT = b"\x04"


def _h_parent(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(_PARENT + left + right).digest()


def _pos_height(pos: int) -> int:
    """Height of the node at 0-based MMR position `pos`."""
    pos += 1
    while pos & (pos + 1):  # until all-ones
        pos -= (1 << (pos.bit_length() - 1)) - 1
    return pos.bit_length() - 1


def _leaf_pos(i: int) -> int:
    """MMR position of the i-th (0-based) leaf."""
    return 2 * i - bin(i).count("1")


def _mmr_size(n_leaves: int) -> int:
    return 2 * n_leaves - bin(n_leaves).count("1")


def _mountains(n_leaves: int) -> List[Tuple[int, int, int]]:
    """-> [(height, first_leaf, pos_start)] per mountain, left to right."""
    out = []
    leaf_off = 0
    pos_off = 0
    for bit in reversed(range(n_leaves.bit_length())):
        if n_leaves >> bit & 1:
            out.append((bit, leaf_off, pos_off))
            leaf_off += 1 << bit
            pos_off += (1 << (bit + 1)) - 1
    return out


def _node_pos(pos_start: int, mountain_h: int, local_leaf: int,
              k: int) -> int:
    """Position of the height-k ancestor of `local_leaf` inside a mountain
    of height `mountain_h` whose nodes start at `pos_start` (post-order)."""
    lo, hi = 0, 1 << mountain_h
    pos = pos_start + (1 << (mountain_h + 1)) - 2  # mountain root
    cur = mountain_h
    while cur > k:
        mid = (lo + hi) // 2
        if local_leaf < mid:
            pos = pos - 1 - ((1 << cur) - 1)  # left child root
            hi = mid
        else:
            pos = pos - 1                      # right child root
            lo = mid
        cur -= 1
    return pos


@dataclass
class RvtProof:
    """Climb siblings (bottom-up) + the other mountains' peaks (left to
    right, ours excluded). Positions are derived from (leaf_i, n_leaves)
    at verify time, so only hashes travel."""
    path: List[bytes] = field(default_factory=list)
    peaks: List[bytes] = field(default_factory=list)

    SPEC = [("path", ("list", "bytes")), ("peaks", ("list", "bytes"))]


class RangeValidationTree:
    """Leaves are block digests; leaf i = block_id i+1. Backed by an
    IDBClient family so the source's tree survives restarts and keeps
    growing lazily as blocks are added."""

    def __init__(self, db: IDBClient, family: bytes = b"rvt") -> None:
        self._db = db
        self._family = family
        raw = db.get(b"n", family + b".meta")
        self._n_leaves = int.from_bytes(raw, "big") if raw else 0

    @property
    def n_leaves(self) -> int:
        return self._n_leaves

    def _get(self, pos: int) -> bytes:
        v = self._db.get(pos.to_bytes(8, "big"), self._family)
        if v is None:
            raise ValueError(f"missing RVT node {pos}")
        return v

    def append(self, leaf_hash: bytes) -> None:
        wb = WriteBatch()
        size = _mmr_size(self._n_leaves)
        pos = size
        wb.put(pos.to_bytes(8, "big"), leaf_hash, self._family)
        written = {pos: leaf_hash}
        size += 1
        height = 0
        while _pos_height(size) > height:
            right_pos = pos
            left_pos = pos - ((1 << (height + 1)) - 1)
            left = written.get(left_pos) or self._get(left_pos)
            right = written[right_pos]
            pos = size
            parent = _h_parent(left, right)
            wb.put(pos.to_bytes(8, "big"), parent, self._family)
            written[pos] = parent
            size += 1
            height += 1
        self._n_leaves += 1
        wb.put(b"n", self._n_leaves.to_bytes(8, "big"),
               self._family + b".meta")
        self._db.write(wb)

    def _peaks(self, n_leaves: int) -> List[bytes]:
        return [self._get(ps + (1 << (h + 1)) - 2)
                for h, _lf, ps in _mountains(n_leaves)]

    def root(self, n_leaves: Optional[int] = None) -> bytes:
        """Root commitment at a historical leaf count (append-only ⇒ old
        node positions are still live)."""
        n = self._n_leaves if n_leaves is None else n_leaves
        if n == 0 or n > self._n_leaves:
            raise ValueError(f"bad leaf count {n} (have {self._n_leaves})")
        return self.compute_root(n, self._peaks(n))

    @staticmethod
    def compute_root(n_leaves: int, peaks: List[bytes]) -> bytes:
        acc = peaks[-1]
        for p in reversed(peaks[:-1]):
            acc = hashlib.sha256(_BAG + p + acc).digest()
        return hashlib.sha256(
            _ROOT + n_leaves.to_bytes(8, "big") + acc).digest()

    def prove(self, leaf_i: int, n_leaves: Optional[int] = None) -> RvtProof:
        n = self._n_leaves if n_leaves is None else n_leaves
        if not 0 <= leaf_i < n or n > self._n_leaves:
            raise ValueError(f"bad proof request leaf={leaf_i} n={n}")
        proof = RvtProof()
        for h, first_leaf, ps in _mountains(n):
            if first_leaf <= leaf_i < first_leaf + (1 << h):
                local = leaf_i - first_leaf
                for k in range(h):
                    sib_local = (local >> k) ^ 1
                    proof.path.append(self._get(
                        _node_pos(ps, h, sib_local << k, k)))
            else:
                proof.peaks.append(self._get(ps + (1 << (h + 1)) - 2))
        return proof

    @staticmethod
    def verify(root: bytes, leaf_i: int, n_leaves: int, leaf_hash: bytes,
               proof: RvtProof) -> bool:
        if not 0 <= leaf_i < n_leaves:
            return False
        peaks: List[bytes] = []
        path_iter = iter(proof.path)
        peak_iter = iter(proof.peaks)
        try:
            for h, first_leaf, _ps in _mountains(n_leaves):
                if first_leaf <= leaf_i < first_leaf + (1 << h):
                    local = leaf_i - first_leaf
                    acc = leaf_hash
                    for k in range(h):
                        sib = next(path_iter)
                        if local >> k & 1:
                            acc = _h_parent(sib, acc)
                        else:
                            acc = _h_parent(acc, sib)
                    peaks.append(acc)
                else:
                    peaks.append(next(peak_iter))
        except StopIteration:
            return False
        if (next(path_iter, None) is not None
                or next(peak_iter, None) is not None):
            return False
        return RangeValidationTree.compute_root(n_leaves, peaks) == root

    @staticmethod
    def verify_window(root: bytes, first_leaf_i: int, n_leaves: int,
                      leaf_hashes: List[bytes],
                      proofs: List[RvtProof]) -> bool:
        """Verify a contiguous window of leaves against one root — the
        per-window proof check of the pipelined state transfer (leaf
        digests arrive pre-batched from the device hash kernel)."""
        if len(leaf_hashes) != len(proofs):
            return False
        return all(
            RangeValidationTree.verify(root, first_leaf_i + k, n_leaves,
                                       lh, pr)
            for k, (lh, pr) in enumerate(zip(leaf_hashes, proofs)))

    def sync_to(self, blockchain) -> None:
        """Lazily extend with digests of blocks appended since last sync
        (the RVBManager 'add pending blocks on checkpoint' duty)."""
        while self._n_leaves < blockchain.last_block_id:
            self.append(blockchain.block_digest(self._n_leaves + 1))
