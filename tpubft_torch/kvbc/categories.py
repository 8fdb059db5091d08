"""Block categories of the categorized blockchain (a copy of
tpubft/kvbc/categories.py): the three update/storage disciplines of
concord-bft's kvbc categorization (block_merkle, versioned_kv,
immutable_kv).

- BLOCK_MERKLE:  proven state — keys live in the sparse Merkle tree;
                 per-block root goes into the block's category digest.
- VERSIONED_KV:  multi-version reads — every (key, block) version kept,
                 plus a latest-version index.
- IMMUTABLE:     write-once keys with tags (event-group style); rewrite
                 is rejected.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from tpubft_torch.storage.interfaces import IDBClient, WriteBatch
from tpubft_torch.utils import serialize as ser

BLOCK_MERKLE = "block_merkle"
VERSIONED_KV = "versioned_kv"
IMMUTABLE = "immutable"

# names of every merkle category ever written (key = category, value
# empty) — survives restarts so pruning can GC all tree archives.
# Deliberately OUTSIDE the "smt.<category>" namespace: a merkle category
# literally named "registry" must not collide with this family.
SMT_REGISTRY_FAMILY = b"kvbc.smtcats"

CATEGORY_TYPES = (BLOCK_MERKLE, VERSIONED_KV, IMMUTABLE)


@dataclass
class CategoryUpdates:
    """One category's writes in one block. value None = delete (not
    allowed for IMMUTABLE). `tags` only meaningful for IMMUTABLE."""
    kv: Dict[bytes, Optional[bytes]] = field(default_factory=dict)
    tags: Dict[bytes, List[str]] = field(default_factory=dict)

    SPEC = [("kv", ("map", "bytes", ("opt", "bytes"))),
            ("tags", ("map", "bytes", ("list", "str")))]


@dataclass
class BlockUpdates:
    """category id -> (category type, updates)."""
    categories: Dict[str, Tuple[str, CategoryUpdates]] = field(
        default_factory=dict)

    def put(self, category: str, key: bytes, value: bytes,
            cat_type: str = VERSIONED_KV,
            tags: Optional[List[str]] = None) -> "BlockUpdates":
        cu = self._cat(category, cat_type)
        cu.kv[key] = value
        if tags:
            cu.tags[key] = tags
        return self

    def delete(self, category: str, key: bytes,
               cat_type: str = VERSIONED_KV) -> "BlockUpdates":
        self._cat(category, cat_type).kv[key] = None
        return self

    def _cat(self, category: str, cat_type: str) -> CategoryUpdates:
        if cat_type not in CATEGORY_TYPES:
            raise ValueError(f"unknown category type {cat_type}")
        if category in self.categories:
            existing_type, cu = self.categories[category]
            if existing_type != cat_type:
                raise ValueError(
                    f"category {category} is {existing_type}, not {cat_type}")
            return cu
        cu = CategoryUpdates()
        self.categories[category] = (cat_type, cu)
        return cu


# family name helpers (one keyspace per category + discipline)
def _fam(category: str, part: str) -> bytes:
    return f"cat.{category}.{part}".encode()


def _ver_key(key: bytes, block_id: int) -> bytes:
    # descending block order: latest version sorts first in the range
    return bytes([len(key) >> 8, len(key) & 0xFF]) + key + \
        (~block_id & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "big")


class CategoryError(Exception):
    pass


def stage_merkle_data(wb: WriteBatch, category: str,
                      updates: CategoryUpdates, block_id: int) -> None:
    """Stage a block_merkle category's raw data rows (the non-tree half
    of its staging — split out so bulk paths that batch the tree work
    across blocks stage the data rows identically)."""
    for k, v in updates.kv.items():
        if v is None:
            wb.delete(k, _fam(category, "data"))
        else:
            wb.put(k, block_id.to_bytes(8, "big") + v,
                   _fam(category, "data"))


def stage_category(db: IDBClient, wb: WriteBatch, category: str,
                   cat_type: str, updates: CategoryUpdates, block_id: int,
                   merkle_trees) -> bytes:
    """Stage one category's updates for `block_id` into `wb`; returns the
    category's state digest contribution for the block."""
    if cat_type == BLOCK_MERKLE:
        tree = merkle_trees(category)
        # durable registry of merkle categories: archive GC at prune time
        # must find every tree ever written, including ones untouched
        # since the last process restart (the in-memory tree cache alone
        # forgets them)
        wb.put(category.encode(), b"", SMT_REGISTRY_FAMILY)
        leaf = {k: (hashlib.sha256(v).digest() if v is not None else None)
                for k, v in updates.kv.items()}
        root = tree.update_batch(leaf, batch=wb, version=block_id)
        stage_merkle_data(wb, category, updates, block_id)
        return root

    if cat_type == VERSIONED_KV:
        h = hashlib.sha256()
        for k in sorted(updates.kv):
            v = updates.kv[k]
            wb.put(_ver_key(k, block_id),
                   b"\x00" if v is None else b"\x01" + v,
                   _fam(category, "hist"))
            if v is None:
                wb.delete(k, _fam(category, "latest"))
                h.update(b"\x00" + len(k).to_bytes(4, "big") + k)
            else:
                wb.put(k, block_id.to_bytes(8, "big") + v,
                       _fam(category, "latest"))
                h.update(b"\x01" + len(k).to_bytes(4, "big") + k
                         + hashlib.sha256(v).digest())
        return h.digest()

    if cat_type == IMMUTABLE:
        h = hashlib.sha256()
        for k in sorted(updates.kv):
            v = updates.kv[k]
            if v is None:
                raise CategoryError("immutable category cannot delete")
            if db.get(k, _fam(category, "data")) is not None:
                raise CategoryError(f"immutable key rewrite: {k!r}")
            wb.put(k, block_id.to_bytes(8, "big") + v,
                   _fam(category, "data"))
            for tag in updates.tags.get(k, []):
                tb = tag.encode()
                wb.put(len(tb).to_bytes(4, "big") + tb + k, v,
                       _fam(category, "tag"))
            h.update(b"\x01" + len(k).to_bytes(4, "big") + k
                     + hashlib.sha256(v).digest())
        return h.digest()

    raise CategoryError(f"unknown category type {cat_type}")


def get_latest(db: IDBClient, category: str, cat_type: str,
               key: bytes) -> Optional[Tuple[int, bytes]]:
    """-> (block_id, value) of the latest version, or None."""
    if cat_type == VERSIONED_KV:
        raw = db.get(key, _fam(category, "latest"))
    else:
        raw = db.get(key, _fam(category, "data"))
    if raw is None:
        return None
    return int.from_bytes(raw[:8], "big"), raw[8:]


def get_versioned(db: IDBClient, category: str, key: bytes,
                  block_id: int) -> Optional[bytes]:
    """VERSIONED_KV read at a historical version: newest write with
    version <= block_id."""
    fam = _fam(category, "hist")
    start = _ver_key(key, block_id)
    for k, v in db.range_iter(fam, start=start):
        if not k.startswith(start[:2 + len(key)]):
            return None
        return None if v[:1] == b"\x00" else v[1:]
    return None


def get_tagged(db: IDBClient, category: str, tag: str
               ) -> List[Tuple[bytes, bytes]]:
    """IMMUTABLE: all (key, value) written under a tag."""
    tb = tag.encode()
    prefix = len(tb).to_bytes(4, "big") + tb
    out = []
    for k, v in db.range_iter(_fam(category, "tag"), start=prefix):
        if not k.startswith(prefix):
            break
        out.append((k[len(prefix):], v))
    return out


# serialization of a whole block's updates (for the block store + ST)
def encode_block_updates(bu: BlockUpdates) -> bytes:
    buf = bytearray()
    ser.write_uvarint(buf, len(bu.categories))
    for cat in sorted(bu.categories):
        cat_type, cu = bu.categories[cat]
        ser.write_bytes(buf, cat.encode())
        ser.write_bytes(buf, cat_type.encode())
        ser.encode_msg_into(buf, cu)
    return bytes(buf)


def decode_block_updates(data: bytes) -> BlockUpdates:
    mv = memoryview(data)
    n, off = ser.read_uvarint(mv, 0)
    bu = BlockUpdates()
    for _ in range(n):
        cat, off = ser.read_bytes(mv, off)
        cat_type, off = ser.read_bytes(mv, off)
        cu, off = ser.decode_msg_from(mv, off, CategoryUpdates)
        bu.categories[cat.decode()] = (cat_type.decode(), cu)
    if off != len(data):
        raise ser.SerializeError("trailing bytes in block updates")
    return bu
