"""In-memory IDBClient (a copy of tpubft/storage/memorydb.py). Ordered so
that range iteration matches the persistent backends of the reference.

Port divergence (reference memorydb.py:35): the reference keeps every
physical key in one sorted list and inserts with `bisect.insort`, so each
new row moves every row after it and a BLOCK_MERKLE block's cost grows
with the ledger (ROADMAP C.12). The port keeps the keys in sorted chunks
of at most CHUNK_MAX keys, with a list of each chunk's first key: an
insert or a delete moves the rows of one chunk only. The rows and the
range scans are the reference's, byte for byte."""
from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterator, List, Optional, Tuple

from tpubft_torch.storage.interfaces import (DEFAULT_FAMILY, IDBClient,
                                             WriteBatch, family_upper_bound,
                                             fkey)


class MemoryDB(IDBClient):
    # keys a chunk; a chunk that grows past it splits in two halves
    CHUNK_MAX = 2048

    def __init__(self) -> None:
        self._map: Dict[bytes, bytes] = {}
        # sorted, disjoint chunks of physical keys in order; no chunk is
        # empty, and _firsts[i] == _chunks[i][0]
        self._chunks: List[List[bytes]] = []
        self._firsts: List[bytes] = []
        self._lock = threading.RLock()

    def get(self, key: bytes,
            family: bytes = DEFAULT_FAMILY) -> Optional[bytes]:
        with self._lock:
            return self._map.get(fkey(family, key))

    def _chunk_of(self, k: bytes) -> int:
        """The chunk whose range holds `k` (the first for a key below
        every chunk's first)."""
        return max(0, bisect.bisect_right(self._firsts, k) - 1)

    def _insert(self, k: bytes) -> None:
        if not self._chunks:
            self._chunks.append([k])
            self._firsts.append(k)
            return
        i = self._chunk_of(k)
        chunk = self._chunks[i]
        bisect.insort(chunk, k)
        self._firsts[i] = chunk[0]
        if len(chunk) > self.CHUNK_MAX:
            half = len(chunk) // 2
            self._chunks[i:i + 1] = [chunk[:half], chunk[half:]]
            self._firsts[i:i + 1] = [chunk[0], chunk[half]]

    def _delete(self, k: bytes) -> None:
        i = self._chunk_of(k)
        chunk = self._chunks[i]
        del chunk[bisect.bisect_left(chunk, k)]
        if not chunk:
            del self._chunks[i]
            del self._firsts[i]
        else:
            self._firsts[i] = chunk[0]

    def write(self, batch: WriteBatch) -> None:
        with self._lock:
            for k, v in batch.ops:
                if v is None:
                    if k in self._map:
                        del self._map[k]
                        self._delete(k)
                else:
                    if k not in self._map:
                        self._insert(k)
                    self._map[k] = v

    def range_iter(self, family: bytes = DEFAULT_FAMILY,
                   start: Optional[bytes] = None,
                   end: Optional[bytes] = None
                   ) -> Iterator[Tuple[bytes, bytes]]:
        lo = fkey(family, start if start is not None else b"")
        hi = fkey(family, end) if end is not None else family_upper_bound(family)
        with self._lock:
            snap = []
            i = self._chunk_of(lo)
            j = (bisect.bisect_left(self._chunks[i], lo)
                 if self._chunks else 0)
            while i < len(self._chunks):
                chunk = self._chunks[i]
                stop = (len(chunk) if hi is None
                        else bisect.bisect_left(chunk, hi, j))
                snap.extend((k, self._map[k]) for k in chunk[j:stop])
                if stop < len(chunk):
                    break
                i, j = i + 1, 0
        prefix = 1 + len(family)
        for k, v in snap:
            yield k[prefix:], v

    def scan_all(self):
        from tpubft_torch.storage.interfaces import split_fkey
        with self._lock:
            snap = [(k, self._map[k]) for chunk in self._chunks
                    for k in chunk]
        for k, v in snap:
            fam, key = split_fkey(k)
            yield fam, key, v

    def close(self) -> None:
        pass
