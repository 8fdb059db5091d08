"""v1 "direct-KV" engine — the legacy block format (a copy of
tpubft/kvbc/v1.py).

Rebuild of the reference's v1 adapters
(concord-bft kvbc/src/direct_kv_db_adapter.cpp,
merkle_tree_db_adapter.cpp's direct-KV mode): keys are written DIRECTLY
— one latest-value row per key, no per-version history, no tag indexes,
no Merkle maintenance — with the block row carrying the raw updates for
replay. It exists so deployments on the oldest format can still be
served and, more importantly, MIGRATED: the engine plugs into the same
`create_blockchain` facade and block-row format as the categorized/v4
engines, so `tools/migrate_v4.py --from v1 --to v4` replays a legacy
chain without special cases.

This is a MIGRATION/TOOLING engine, not a consensus engine: the replica
binaries do not offer it (its raising history/proof reads would turn one
versioned client read into a deterministic execution halt on every
correct replica). Serve legacy data by migrating it.

Semantics (deliberately legacy-faithful):
- `get_latest` only; `get_versioned`/`get_tagged`/`prove` raise — the
  format stores no history and no proofs.
- Immutable categories degrade to plain writes (v1 predates category
  types); the updates blob still records the declared category types so
  a migration to a newer engine restores full semantics.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Optional

from tpubft_torch.kvbc import categories as cat
from tpubft_torch.kvbc.blockchain import Block, BlockchainError, BlockStoreMixin
from tpubft_torch.storage.interfaces import IDBClient, WriteBatch

_BLOCKS = b"v1.blocks"
_DATA = b"v1.data"
_MISC = b"v1.misc"
_ST = b"v1.st"


def _dk(category: str, key: bytes) -> bytes:
    c = category.encode()
    return len(c).to_bytes(2, "big") + c + key


class DirectKVBlockchain(BlockStoreMixin):
    """Latest-only direct writes; block rows exist purely for replay,
    state transfer, and digest chaining."""

    VERSION = "v1"
    _F_BLOCKS = _BLOCKS
    _F_MISC = _MISC
    _F_ST = _ST

    def __init__(self, db: IDBClient,
                 use_device_hashing: bool = False) -> None:
        del use_device_hashing          # nothing batched to accelerate
        self._db = db
        self._load_head()

    def _stage_block(self, wb: WriteBatch, block_id: int,
                     updates: cat.BlockUpdates) -> Block:
        digests: Dict[str, bytes] = {}
        for name in sorted(updates.categories):
            _, cu = updates.categories[name]
            h = hashlib.sha256()
            for k in sorted(cu.kv):
                v = cu.kv[k]
                row = _dk(name, k)
                if v is None:
                    wb.delete(row, _DATA)
                    h.update(b"\x00" + len(k).to_bytes(4, "big") + k)
                else:
                    wb.put(row, v, _DATA)   # DIRECT: the raw value
                    h.update(b"\x01" + len(k).to_bytes(4, "big") + k
                             + hashlib.sha256(v).digest())
            digests[name] = h.digest()
        parent = self.block_digest(block_id - 1) if block_id > 1 else b""
        block = Block(block_id=block_id, parent_digest=parent,
                      category_digests=digests,
                      updates_blob=cat.encode_block_updates(updates))
        self._put_block_row(wb, block_id, block)
        return block

    # ---- reads (latest only — the format's defining limitation) ----
    def get_latest(self, category: str, key: bytes,
                   cat_type: str = cat.VERSIONED_KV):
        """(version, value) like the modern engines — but v1 stores no
        version column, so the version is always 0 ("unknown")."""
        del cat_type                    # v1 has no category semantics
        raw = self._db.get(_dk(category, key), _DATA)
        return None if raw is None else (0, raw)

    def get_versioned(self, category: str, key: bytes, block_id: int):
        raise BlockchainError("v1 direct-KV stores no version history; "
                              "migrate to categorized/v4 for versioned "
                              "reads (tools/migrate_v4.py)")

    def get_tagged(self, category: str, tag: str):
        raise BlockchainError("v1 direct-KV has no tag indexes")

    def prove(self, category: str, key: bytes):
        raise BlockchainError("v1 direct-KV has no Merkle proofs")

    def merkle_root(self, category: str) -> bytes:
        raise BlockchainError("v1 direct-KV has no Merkle trees")
