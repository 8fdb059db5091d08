"""Reserved pages — small mutable consensus-replicated page store.

Rebuild of the reference's IReservedPages / ReservedPagesClient
(concord-bft bftengine/include/bftengine/IReservedPages.hpp,
ReservedPagesClient.hpp): a fixed-size page store that travels with state
transfer alongside the ledger, used by the clients reply cache, key
exchange, time service, cron, and reconfiguration. Pages are namespaced
per subsystem (the reference statically carves page-id ranges per
registered client type; we key by (category, index) which gives the same
isolation without a global allocation table).
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

from tpubft_torch.storage.interfaces import IDBClient, WriteBatch

PAGE_SIZE = 4096
_FAMILY = b"respages"


class ReservedPages:
    def __init__(self, db: IDBClient) -> None:
        self._db = db

    @property
    def db(self) -> IDBClient:
        """The backing store (read-only exposure: the execution lane
        needs it as a group-fsync target on the unfolded path)."""
        return self._db

    @staticmethod
    def _key(category: str, index: int) -> bytes:
        cb = category.encode()
        return len(cb).to_bytes(2, "big") + cb + index.to_bytes(4, "big")

    def load(self, category: str, index: int = 0) -> Optional[bytes]:
        return self._db.get(self._key(category, index), _FAMILY)

    def save(self, category: str, index: int, data: bytes) -> None:
        if len(data) > PAGE_SIZE:
            raise ValueError(f"page exceeds {PAGE_SIZE} bytes")
        self._db.put(self._key(category, index), data, _FAMILY)

    def delete(self, category: str, index: int) -> None:
        self._db.delete(self._key(category, index), _FAMILY)

    # ---- batched staging (execution-lane run coalescing) ----
    def stage_save(self, wb: WriteBatch, category: str, index: int,
                   data: bytes) -> None:
        """Stage a save into a caller-owned WriteBatch: the execution
        lane coalesces a whole run's reply/marker pages into ONE batch
        (committed via write_batch, or riding the ledger's run batch
        when pages share its DB) instead of one put per page."""
        if len(data) > PAGE_SIZE:
            raise ValueError(f"page exceeds {PAGE_SIZE} bytes")
        wb.put(self._key(category, index), data, _FAMILY)

    def write_batch(self, wb: WriteBatch) -> None:
        if wb.ops:
            self._db.write(wb)

    def shares_db(self, other_db) -> bool:
        """True when this page store writes to `other_db` — the lane uses
        this to fold the pages batch into the ledger commit atomically."""
        return self._db is other_db

    def rebind(self, db: IDBClient) -> None:
        """Swap the backing handle — used when the ledger installs its
        durability pending view over a SHARED db, so page reads/digests
        observe folded-but-not-yet-applied reply pages exactly like
        ledger readers observe sealed blocks."""
        self._db = db

    def scan(self, category: str, lo_index: int,
             hi_index: int) -> List[Tuple[int, bytes]]:
        """EXISTING pages of `category` with lo_index <= index < hi_index,
        as (index, data). One bounded range_iter — cost proportional to
        the pages that exist in the range (zero for a cold client), never
        to the range width: the demand pager's primitive, so paging in a
        never-seen principal is O(log store), not O(ring slots)."""
        out: List[Tuple[int, bytes]] = []
        for k, v in self._db.range_iter(_FAMILY,
                                        start=self._key(category, lo_index),
                                        end=self._key(category, hi_index)):
            out.append((int.from_bytes(k[-4:], "big"), v))
        return out

    def all_pages(self) -> List[Tuple[bytes, bytes]]:
        return list(self._db.range_iter(_FAMILY))

    @staticmethod
    def digest_of(pages: List[Tuple[bytes, bytes]]) -> bytes:
        h = hashlib.sha256()
        for k, v in sorted(pages):
            h.update(len(k).to_bytes(4, "big") + k)
            h.update(len(v).to_bytes(4, "big") + v)
        return h.digest()

    def digest(self) -> bytes:
        """Digest over all pages — part of the checkpoint certificate
        (reference: digestOfResPagesDescriptor)."""
        return self.digest_of(list(self._db.range_iter(_FAMILY)))

    def replace_all(self, pages: List[Tuple[bytes, bytes]]) -> None:
        """State transfer install: swap the whole page set atomically."""
        wb = WriteBatch()
        for k, _ in self._db.range_iter(_FAMILY):
            wb.delete(k, _FAMILY)
        for k, v in pages:
            wb.put(k, v, _FAMILY)
        self._db.write(wb)


class ReservedPagesClient:
    """Subsystem-scoped view (reference ReservedPagesClient<T>)."""

    def __init__(self, pages: ReservedPages, category: str) -> None:
        self._pages = pages
        self._category = category

    def load(self, index: int = 0) -> Optional[bytes]:
        return self._pages.load(self._category, index)

    def scan(self, lo_index: int, hi_index: int):
        return self._pages.scan(self._category, lo_index, hi_index)

    def save(self, data: bytes, index: int = 0) -> None:
        self._pages.save(self._category, index, data)

    def delete(self, index: int = 0) -> None:
        self._pages.delete(self._category, index)
