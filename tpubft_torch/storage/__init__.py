"""Storage layer of the port (a copy of tpubft/storage/): the abstract KV
DB (interfaces.py), the in-memory backend (memorydb.py), the persistent
backend NativeDB (native.py) over the port's own native log-structured
engine (native/kvlog.cpp, built with g++ at first use instead of
RocksDB, loaded via ctypes), the consensus metadata store (metadata.py)
and the object stores of ledger archival (objectstore.py, s3.py).
"""
from tpubft_torch.storage.interfaces import (DEFAULT_FAMILY, IDBClient,
                                             StorageError, WriteBatch)
from tpubft_torch.storage.memorydb import MemoryDB

__all__ = ["IDBClient", "WriteBatch", "MemoryDB", "StorageError",
           "DEFAULT_FAMILY"]
