"""v4 blockchain engine — latest-keys-native, write-optimized (a copy
of tpubft/kvbc/v4.py).

Rebuild of the reference's `concord::kvbc::v4blockchain::KeyValueBlockchain`
(concord-bft kvbc/src/v4blockchain/v4_blockchain.cpp:847 +
detail/{blockchain,latest_keys,st_chain}.cpp): three keyspaces —

  * ``blockchain``  — block id → full serialized block (the only history);
  * ``latest_keys`` — (category, key) → latest value stamped with its
                      version, giving O(1) latest reads and cheap writes
                      (no per-version history rows, no Merkle tree
                      maintenance — the categorized engine's costs);
  * ``st_chain``    — out-of-order state-transfer staging.

Historical reads walk the block store backward (the reference reads
through the ``blockchain`` column family the same way); there are no
Merkle proofs in v4 — ``prove``/``merkle_root`` raise, and callers that
need proofs configure the categorized engine (kvbc_adapter role,
reference src/kvbc_adapter/).

The public surface mirrors KeyValueBlockchain so the two engines are
interchangeable behind ``tpubft_torch.kvbc.create_blockchain``.
Plain host code: its per-category digests are hashlib's, as the
reference's are.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

from tpubft_torch.kvbc import categories as cat
from tpubft_torch.kvbc.blockchain import (Block, BlockchainError, BlockStoreMixin,
                                    _bid)
from tpubft_torch.storage.interfaces import IDBClient, WriteBatch

_BLOCKS = b"v4.blocks"
_LATEST = b"v4.latest"
_TAGS = b"v4.tags"
_MISC = b"v4.misc"
_ST = b"v4.st"


def _lk(category: str, key: bytes) -> bytes:
    """latest_keys row key: category-scoped (reference latest_keys.cpp
    prefixes keys with the category id)."""
    c = category.encode()
    return len(c).to_bytes(2, "big") + c + key


def _tag_row(category: str, tag: str, key: bytes) -> bytes:
    """Tag index row: category-scoped like the categorized engine's
    _fam(category, 'tag') family — tags never leak across categories."""
    c, t = category.encode(), tag.encode()
    return (len(c).to_bytes(2, "big") + c
            + len(t).to_bytes(4, "big") + t + key)


class V4KeyValueBlockchain(BlockStoreMixin):
    """Write-optimized engine: one latest-keys write per key per block."""

    VERSION = "v4"
    _F_BLOCKS = _BLOCKS
    _F_MISC = _MISC
    _F_ST = _ST

    def __init__(self, db: IDBClient,
                 use_device_hashing: bool = False) -> None:
        del use_device_hashing          # no Merkle trees to accelerate
        self._db = db
        self._load_head()

    def _stage_block(self, wb: WriteBatch, block_id: int,
                     updates: cat.BlockUpdates) -> Block:
        digests: Dict[str, bytes] = {}
        ver = block_id.to_bytes(8, "big")
        for name in sorted(updates.categories):
            cat_type, cu = updates.categories[name]
            h = hashlib.sha256()
            for k in sorted(cu.kv):
                v = cu.kv[k]
                row = _lk(name, k)
                if cat_type == cat.IMMUTABLE:
                    if v is None:
                        raise cat.CategoryError(
                            "immutable category cannot delete")
                    if self._db.get(row, _LATEST) is not None:
                        raise cat.CategoryError(
                            f"immutable key rewrite: {k!r}")
                    for tag in cu.tags.get(k, []):
                        wb.put(_tag_row(name, tag, k), v, _TAGS)
                if v is None:
                    wb.delete(row, _LATEST)
                    h.update(b"\x00" + len(k).to_bytes(4, "big") + k)
                else:
                    wb.put(row, ver + v, _LATEST)
                    h.update(b"\x01" + len(k).to_bytes(4, "big") + k
                             + hashlib.sha256(v).digest())
            digests[name] = h.digest()
        parent = self.block_digest(block_id - 1) if block_id > 1 else b""
        block = Block(block_id=block_id, parent_digest=parent,
                      category_digests=digests,
                      updates_blob=cat.encode_block_updates(updates))
        self._put_block_row(wb, block_id, block)
        return block

    # ---- v4 reads ----
    def get_latest(self, category: str, key: bytes,
                   cat_type: str = cat.VERSIONED_KV
                   ) -> Optional[Tuple[int, bytes]]:
        raw = self._db.get(_lk(category, key), _LATEST)
        if raw is None:
            return None
        return int.from_bytes(raw[:8], "big"), raw[8:]

    def get_versioned(self, category: str, key: bytes,
                      block_id: int) -> Optional[bytes]:
        """Newest write with version <= block_id — walks the block store
        backward (v4 keeps no per-version rows; the reference reads
        history through the blockchain CF the same way)."""
        latest = self.get_latest(category, key)
        if latest is not None and latest[0] <= block_id:
            return latest[1]
        lo = self._genesis if self._genesis else 1
        for bid in range(min(block_id, self._last), lo - 1, -1):
            blk = self.get_block(bid)
            if blk is None:
                return None                 # pruned past this point
            entry = cat.decode_block_updates(blk.updates_blob)
            got = entry.categories.get(category)
            if got is not None and key in got[1].kv:
                return got[1].kv[key]
        return None

    def get_tagged(self, category: str, tag: str
                   ) -> List[Tuple[bytes, bytes]]:
        prefix = _tag_row(category, tag, b"")
        out = []
        for k, v in self._db.range_iter(_TAGS, start=prefix):
            if not k.startswith(prefix):
                break
            out.append((k[len(prefix):], v))
        return out

    def prove(self, category: str, key: bytes):
        raise BlockchainError(
            "v4 engine keeps no Merkle trees; configure the categorized "
            "engine for proofs (kvbc_adapter role)")

    def merkle_root(self, category: str) -> bytes:
        raise BlockchainError(
            "v4 engine keeps no Merkle trees; configure the categorized "
            "engine for proofs (kvbc_adapter role)")
