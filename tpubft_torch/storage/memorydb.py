"""In-memory IDBClient (a copy of tpubft/storage/memorydb.py). Ordered via
a bisect-maintained key list so range iteration matches the persistent
backends of the reference."""
from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterator, List, Optional, Tuple

from tpubft_torch.storage.interfaces import (DEFAULT_FAMILY, IDBClient,
                                             WriteBatch, family_upper_bound,
                                             fkey)


class MemoryDB(IDBClient):
    def __init__(self) -> None:
        self._map: Dict[bytes, bytes] = {}
        self._keys: List[bytes] = []        # sorted physical keys
        self._lock = threading.RLock()

    def get(self, key: bytes,
            family: bytes = DEFAULT_FAMILY) -> Optional[bytes]:
        with self._lock:
            return self._map.get(fkey(family, key))

    def write(self, batch: WriteBatch) -> None:
        with self._lock:
            for k, v in batch.ops:
                if v is None:
                    if k in self._map:
                        del self._map[k]
                        i = bisect.bisect_left(self._keys, k)
                        del self._keys[i]
                else:
                    if k not in self._map:
                        bisect.insort(self._keys, k)
                    self._map[k] = v

    def range_iter(self, family: bytes = DEFAULT_FAMILY,
                   start: Optional[bytes] = None,
                   end: Optional[bytes] = None
                   ) -> Iterator[Tuple[bytes, bytes]]:
        lo = fkey(family, start if start is not None else b"")
        hi = fkey(family, end) if end is not None else family_upper_bound(family)
        with self._lock:
            i = bisect.bisect_left(self._keys, lo)
            snap = []
            while i < len(self._keys):
                k = self._keys[i]
                if hi is not None and k >= hi:
                    break
                snap.append((k, self._map[k]))
                i += 1
        prefix = 1 + len(family)
        for k, v in snap:
            yield k[prefix:], v

    def scan_all(self):
        from tpubft_torch.storage.interfaces import split_fkey
        with self._lock:
            snap = [(k, self._map[k]) for k in self._keys]
        for k, v in snap:
            fam, key = split_fkey(k)
            yield fam, key, v

    def close(self) -> None:
        pass
