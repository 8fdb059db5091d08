"""The storage factory (the reference's `open_db`, tpubft/kvbc/replica.py):
a path opens the persistent engine, None the in-memory store. It lives
apart from kvbc/replica.py, which builds a consensus Replica, so that the
host-only tools (tools/snapshot.py, tools/migrate_v4.py) start without
importing torch."""
from __future__ import annotations

import os
from typing import Optional

from tpubft_torch.storage.interfaces import IDBClient
from tpubft_torch.storage.memorydb import MemoryDB


def open_db(db_path: Optional[str],
            sync_writes: bool = False,
            sync_families=()) -> IDBClient:
    """Storage factory (reference: kvbc storage factories — RocksDB for
    production, memorydb for tests). `sync_writes` mirrors RocksDB
    WriteOptions.sync (reference leaves it false); `sync_families` keeps
    the named families fsync-durable regardless (the consensus-metadata
    carve-out)."""
    if db_path is None:
        return MemoryDB()
    from tpubft_torch.storage.native import NativeDB
    os.makedirs(os.path.dirname(db_path) or ".", exist_ok=True)
    return NativeDB(db_path, sync_writes=sync_writes,
                    sync_families=sync_families)
