"""Sparse Merkle tree over a 256-bit key space (port of
tpubft/kvbc/sparse_merkle.py).

The reference's rebuild of concord-bft's sparse_merkle::Tree with a
batched update path: instead of nibble-batched internal nodes walked one
at a time, updates are applied as a *batch per level* — all changed nodes
of a level are rehashed in one call, which goes through the batched
SHA-256 kernel (ops/sha256.py: the hand-written CUDA kernel on the card)
once the level holds `_DEVICE_THRESHOLD` nodes. Everything else is the
reference's semantics, byte for byte.

Layout: key -> path = SHA-256(key), 256 levels. Only non-default nodes are
persisted (family `smt`); empty subtrees hash to precomputed defaults.
Leaf hash = H(0x00 || path || value_hash); inner = H(0x01 || l || r).

Versioning: the LATEST state mutates in place — the hot path reads and
writes exactly one row per node, no version walk. Every node change is
additionally appended to an archive family keyed `node_key || version`
(version = block id), so `prove_at(key, version)` can rebuild the audit
path of any retained block by taking, per node, the newest archive row
at or below that version (absence = default subtree — any older change
would have been archived). `prune_versions(before)` is the stale-node
GC: it drops archive rows superseded before the retention point.

Degradation, as in the reference: a device call that raises a
RuntimeError (a failed launch, an OPEN device breaker) falls back to
hashlib with the same digests, because a Merkle update must never die
with the accelerator. Each such fallback is counted in the module-level
`DEGRADED` and logged, so a run can tell a device answer from a host
one. Anything else (no card at all, `device.NoDevice`; a wrapper
refusing its inputs; a kernel that does not build) raises.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from tpubft_torch.storage.interfaces import IDBClient, WriteBatch
from tpubft_torch.utils.logging import get_logger

DEPTH = 256
_EMPTY = b"\x00" * 32

# default (empty-subtree) hash per depth: _DEFAULTS[256] = empty leaf,
# _DEFAULTS[d] = H(0x01 || _DEFAULTS[d+1] || _DEFAULTS[d+1])
_DEFAULTS: List[bytes] = [b""] * (DEPTH + 1)
_DEFAULTS[DEPTH] = _EMPTY
for _d in range(DEPTH - 1, -1, -1):
    _DEFAULTS[_d] = hashlib.sha256(
        b"\x01" + _DEFAULTS[_d + 1] + _DEFAULTS[_d + 1]).digest()

# below this many nodes in a level, hashlib beats device dispatch (the
# reference's value: both packages launch on the same levels)
_DEVICE_THRESHOLD = 192

# levels whose device call raised and that hashlib answered instead
DEGRADED = 0

_log = get_logger("smt")


def _hash_level(messages: Sequence[bytes], use_device: bool) -> List[bytes]:
    global DEGRADED
    if use_device and len(messages) >= _DEVICE_THRESHOLD:
        # imported here: the ledger's host-only users (the snapshot and
        # migration tools) start without torch
        from tpubft_torch.device import NoDevice
        from tpubft_torch.ops import sha256 as _sha
        try:
            return _sha.sha256_batch(messages)
        except NoDevice:
            raise
        except RuntimeError as exc:
            # device loss (a failed launch, an OPEN breaker's BreakerOpen
            # fast-fail) degrades to hashlib: the digests are
            # byte-identical and a Merkle update must never die with the
            # accelerator. A missing card, a wrapper's ValueError or a
            # BuildError is a fault of the set-up or the program and
            # raises.
            DEGRADED += 1
            _log.warning("Merkle level of %d nodes hashed on the host: %s",
                         len(messages), exc)
    return [hashlib.sha256(m).digest() for m in messages]


def _leaf_hash(path: bytes, value_hash: bytes) -> bytes:
    return hashlib.sha256(b"\x00" + path + value_hash).digest()


def _node_key(depth: int, path_bits: int) -> bytes:
    """Physical key: depth (2B big-endian) + the leading `depth` bits."""
    nbytes = (depth + 7) // 8
    return depth.to_bytes(2, "big") + (
        (path_bits << (nbytes * 8 - depth)).to_bytes(nbytes, "big")
        if depth else b"")


@dataclass
class Proof:
    """Audit path, compressed: bitmap marks levels whose sibling is
    non-default; `siblings` lists only those, bottom (depth 256) first."""
    bitmap: bytes                    # 32 bytes, bit i = level DEPTH - i
    siblings: List[bytes]


class SparseMerkleTree:
    def __init__(self, db: IDBClient, family: bytes = b"smt",
                 use_device: bool = True) -> None:
        self._db = db
        self._family = family
        self._leaf_family = family + b".leaf"
        self._arch_family = family + b".arch"        # node_key+ver8 -> hash
        self._leaf_arch_family = family + b".leafarch"  # path+ver8 -> vh
        self._use_device = use_device

    # ---- reads ----
    # Reads go straight to the DB (no node cache): staged-but-uncommitted
    # updates must never be observable, and an aborted block must leave no
    # residue — the DB's batch atomicity is the single source of truth.
    def _node(self, depth: int, path_bits: int) -> bytes:
        v = self._db.get(_node_key(depth, path_bits), self._family)
        return v if v is not None else _DEFAULTS[depth]

    def root(self) -> bytes:
        return self._node(0, 0)

    def get_value_hash(self, key: bytes) -> Optional[bytes]:
        path = hashlib.sha256(key).digest()
        return self._db.get(path, self._leaf_family)

    # ---- batch update ----
    def update_batch(self, updates: Dict[bytes, Optional[bytes]],
                     batch: Optional[WriteBatch] = None,
                     version: int = 0) -> bytes:
        """Apply {key: value_hash or None(delete)}; returns the new root.
        If `batch` is given, node writes are staged into it (caller
        commits atomically with the block); otherwise committed here.
        `version` (the block id) > 0 additionally archives every changed
        node so `prove_at` can serve this version later."""
        if not updates:
            return self.root()
        own_batch = batch is None
        wb = WriteBatch() if own_batch else batch
        ver = version.to_bytes(8, "big") if version > 0 else None

        # leaf level
        changed: Dict[int, bytes] = {}
        for key, vh in updates.items():
            path = hashlib.sha256(key).digest()
            bits = int.from_bytes(path, "big")
            if vh is None:
                changed[bits] = _EMPTY
                wb.delete(path, self._leaf_family)
            else:
                changed[bits] = _leaf_hash(path, vh)
                wb.put(path, vh, self._leaf_family)
            if ver is not None:
                wb.put(path + ver, vh if vh is not None else b"",
                       self._leaf_arch_family)
        self._stage_level(wb, DEPTH, changed, ver)

        # ascend, rehashing all changed nodes of each level in one batch
        for depth in range(DEPTH, 0, -1):
            parents = sorted({bits >> 1 for bits in changed})
            msgs = []
            for pb in parents:
                left = changed.get(pb << 1)
                if left is None:
                    left = self._node(depth, pb << 1)
                right = changed.get((pb << 1) | 1)
                if right is None:
                    right = self._node(depth, (pb << 1) | 1)
                msgs.append(b"\x01" + left + right)
            hashes = _hash_level(msgs, self._use_device)
            changed = dict(zip(parents, hashes))
            self._stage_level(wb, depth - 1, changed, ver)

        if own_batch:
            self._db.write(wb)
        return changed[0]

    # ---- multi-block batch update ----
    def update_batches(self, updates_list: Sequence[Dict[bytes,
                                                         Optional[bytes]]],
                       batch: Optional[WriteBatch] = None,
                       first_version: int = 0) -> List[bytes]:
        """Apply N consecutive blocks' updates in one level-synchronous
        walk: block i gets version `first_version + i` (0 = unversioned,
        like update_batch). Returns the root AFTER each block, exactly as
        N sequential update_batch calls would, and stages byte-identical
        rows (final node/leaf values + one archive row per changed node
        per version).

        The win over per-block calls is hash batching: at every level,
        the changed nodes of ALL blocks hash in ONE _hash_level call (one
        ops/sha256 device dispatch per level once wide enough) instead of
        one host loop per block per level. Cross-block dependencies are
        handled by tracking, per node, the ordered list of
        (block index, hash) versions: block i's parent hash reads the
        newest child value at or below i, falling back to the DB for
        nodes untouched by the whole batch."""
        if not updates_list:
            return []
        nblocks = len(updates_list)
        if not any(updates_list):
            return [self.root()] * nblocks
        if nblocks == 1:
            # degenerate: the sequential path is the batched path
            return [self.update_batch(dict(updates_list[0]), batch=batch,
                                      version=first_version)]
        own_batch = batch is None
        wb = WriteBatch() if own_batch else batch
        vers = [(first_version + i).to_bytes(8, "big")
                if first_version > 0 else None for i in range(nblocks)]

        # leaf level: per path, ordered (block, hash) versions
        changed: Dict[int, List[Tuple[int, bytes]]] = {}
        final_leaf: Dict[bytes, Optional[bytes]] = {}
        for i, updates in enumerate(updates_list):
            for key, vh in updates.items():
                path = hashlib.sha256(key).digest()
                bits = int.from_bytes(path, "big")
                h = _EMPTY if vh is None else _leaf_hash(path, vh)
                changed.setdefault(bits, []).append((i, h))
                final_leaf[path] = vh
                if vers[i] is not None:
                    wb.put(path + vers[i],
                           vh if vh is not None else b"",
                           self._leaf_arch_family)
        for path, vh in final_leaf.items():
            if vh is None:
                wb.delete(path, self._leaf_family)
            else:
                wb.put(path, vh, self._leaf_family)
        # pre-batch values of this level's changed nodes, captured BEFORE
        # staging them: `wb` may be a read-your-writes mirrored batch (the
        # bulk add_blocks path), where a post-staging read of a node whose
        # first change is at a LATER block would see that final value
        # instead of the pre-batch one — corrupting earlier blocks' roots
        pre: Dict[int, bytes] = {b: self._node(DEPTH, b) for b in changed}
        self._stage_level_multi(wb, DEPTH, changed, vers)

        for depth in range(DEPTH, 0, -1):
            def value_at(bits: int, i: int) -> bytes:
                """Newest value of (depth, bits) at or below block i:
                the node's newest in-batch version ≤ i, its pre-batch
                value if its first change is later, or the DB (which the
                batch never touched for this node)."""
                versions = changed.get(bits)
                if versions is None:
                    return self._node(depth, bits)
                best = None
                for j, h in versions:          # ascending block order
                    if j > i:
                        break
                    best = h
                return best if best is not None else pre[bits]

            # (parent_bits, block) pairs needing a hash, in stable order
            pairs: List[Tuple[int, int]] = []
            seen = set()
            for bits, versions in changed.items():
                pb = bits >> 1
                for i, _ in versions:
                    if (pb, i) not in seen:
                        seen.add((pb, i))
                        pairs.append((pb, i))
            pairs.sort()
            msgs = [b"\x01" + value_at(pb << 1, i)
                    + value_at((pb << 1) | 1, i)
                    for pb, i in pairs]
            hashes = _hash_level(msgs, self._use_device)
            parents: Dict[int, List[Tuple[int, bytes]]] = {}
            for (pb, i), h in zip(pairs, hashes):
                parents.setdefault(pb, []).append((i, h))
            changed = parents                  # pairs sorted → ascending i
            pre = {b: self._node(depth - 1, b) for b in changed}
            self._stage_level_multi(wb, depth - 1, changed, vers)

        if own_batch:
            self._db.write(wb)
        root_versions = changed[0]
        roots, cur = [], pre[0]               # pre-batch root
        it = iter(root_versions)
        nxt = next(it, None)
        for i in range(nblocks):
            while nxt is not None and nxt[0] <= i:
                cur = nxt[1]
                nxt = next(it, None)
            roots.append(cur)
        return roots

    def _stage_level_multi(self, wb: WriteBatch, depth: int,
                           nodes: Dict[int, List[Tuple[int, bytes]]],
                           vers: List[Optional[bytes]]) -> None:
        """Stage a level's multi-version nodes: final value to the live
        family, one archive row per (node, block) change."""
        default = _DEFAULTS[depth]
        for bits, versions in nodes.items():
            k = _node_key(depth, bits)
            final = versions[-1][1]
            if final == default:
                wb.delete(k, self._family)
            else:
                wb.put(k, final, self._family)
            for i, h in versions:
                if vers[i] is not None:
                    wb.put(k + vers[i], b"" if h == default else h,
                           self._arch_family)

    def _stage_level(self, wb: WriteBatch, depth: int,
                     nodes: Dict[int, bytes],
                     ver: Optional[bytes] = None) -> None:
        default = _DEFAULTS[depth]
        for bits, h in nodes.items():
            k = _node_key(depth, bits)
            if h == default:
                wb.delete(k, self._family)
            else:
                wb.put(k, h, self._family)
            if ver is not None:
                # archive row; default is stored as empty so a historical
                # walk can tell "reverted to default at ver" from "never
                # touched" (the latter = default since genesis)
                wb.put(k + ver, b"" if h == default else h,
                       self._arch_family)

    # ---- versioned reads ----
    def _newest_row_at(self, family: bytes, prefix: bytes,
                       version: int) -> Optional[bytes]:
        """Newest archive row for `prefix` at or below `version`, or None
        if the node was never written by then. Rows of one node share a
        fixed-length prefix, so the range scan is exact."""
        row = self._db.last_in_range(
            family, start=prefix,
            end=prefix + (version + 1).to_bytes(8, "big"))
        return row[1] if row else None

    def _node_at(self, depth: int, path_bits: int, version: int) -> bytes:
        row = self._newest_row_at(self._arch_family,
                                  _node_key(depth, path_bits), version)
        if row is None or row == b"":
            return _DEFAULTS[depth]
        return row

    def root_at(self, version: int) -> bytes:
        return self._node_at(0, 0, version)

    def get_value_hash_at(self, key: bytes,
                          version: int) -> Optional[bytes]:
        path = hashlib.sha256(key).digest()
        row = self._newest_row_at(self._leaf_arch_family, path, version)
        return row if row else None        # b"" = deleted at that version

    def prove_at(self, key: bytes, version: int) -> Proof:
        """Audit path as of `version` (a retained block id). Costs one
        archive range-scan per level — proof serving, not the hot path."""
        return self._prove_with(
            key, lambda depth, bits: self._node_at(depth, bits, version))

    def prune_versions(self, before_version: int) -> int:
        """Stale-node GC (reference stale-node index role): drop archive
        rows SUPERSEDED at or below `before_version` — for each node,
        every row older than its newest row ≤ before stays unreachable
        from any retained root ≥ before. Returns rows deleted.

        Cost: one pass over the archive family (O(retained history), a
        maintenance operation like the reference's stale-node sweep, not
        the ordering hot path). A per-write stale index would make this
        O(deleted) at the price of one extra read per node on every
        block commit — wrong trade while prune frequency << block rate."""
        wb = WriteBatch()
        deleted = 0
        for fam in (self._arch_family, self._leaf_arch_family):
            prev_key: Optional[bytes] = None   # candidate superseded row
            for k, _v in self._db.range_iter(fam):
                prefix, ver = k[:-8], int.from_bytes(k[-8:], "big")
                if (prev_key is not None and prev_key[:-8] == prefix
                        and ver <= before_version):
                    wb.delete(prev_key, fam)   # newer row ≤ before exists
                    deleted += 1
                prev_key = k if ver <= before_version else None
        if deleted:
            self._db.write(wb)
        return deleted

    # ---- proofs ----
    def prove(self, key: bytes) -> Proof:
        return self._prove_with(key, self._node)

    def _prove_with(self, key: bytes, node) -> Proof:
        """One audit-path walk for both latest and versioned proofs —
        the bitmap compression must never diverge between the two."""
        path = hashlib.sha256(key).digest()
        bits = int.from_bytes(path, "big")
        bitmap = bytearray(32)
        siblings: List[bytes] = []
        node_bits = bits
        for depth in range(DEPTH, 0, -1):
            sib = node(depth, node_bits ^ 1)
            if sib != _DEFAULTS[depth]:
                i = DEPTH - depth
                bitmap[i // 8] |= 1 << (i % 8)
                siblings.append(sib)
            node_bits >>= 1
        return Proof(bytes(bitmap), siblings)

    @staticmethod
    def verify(root: bytes, key: bytes, value_hash: Optional[bytes],
               proof: Proof) -> bool:
        """Checks membership (value_hash given) or non-membership (None)."""
        if len(proof.bitmap) != 32:
            return False
        path = hashlib.sha256(key).digest()
        bits = int.from_bytes(path, "big")
        acc = _EMPTY if value_hash is None else _leaf_hash(path, value_hash)
        sib_iter = iter(proof.siblings)
        node_bits = bits
        try:
            for depth in range(DEPTH, 0, -1):
                i = DEPTH - depth
                if proof.bitmap[i // 8] >> (i % 8) & 1:
                    sib = next(sib_iter)
                else:
                    sib = _DEFAULTS[depth]
                if node_bits & 1:
                    acc = hashlib.sha256(b"\x01" + sib + acc).digest()
                else:
                    acc = hashlib.sha256(b"\x01" + acc + sib).digest()
                node_bits >>= 1
        except StopIteration:
            return False
        return acc == root
