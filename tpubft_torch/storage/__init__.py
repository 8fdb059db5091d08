"""Storage layer of the port: the abstract KV DB and the in-memory backend
(copies of tpubft/storage/interfaces.py and memorydb.py). The reference's
native log-structured engine, object stores and consensus metadata store
wait for their slices."""
from tpubft_torch.storage.interfaces import (DEFAULT_FAMILY, IDBClient,
                                             StorageError, WriteBatch)
from tpubft_torch.storage.memorydb import MemoryDB

__all__ = ["IDBClient", "WriteBatch", "MemoryDB", "StorageError",
           "DEFAULT_FAMILY"]
