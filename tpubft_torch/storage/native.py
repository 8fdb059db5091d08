"""Persistent IDBClient backed by the native C++ kvlog engine (a copy of
tpubft/storage/native.py) — the RocksDB role of concord-bft's storage
layer (storage/src/rocksdb_client.cpp), via ctypes.

The engine is the port's own copy of the source, native/kvlog.cpp, built
with g++ into ops/_build/ at first use (ops/_build.load_host); a failed
build raises, and there is no in-memory fallback. Its files are the
reference's byte for byte, so a ledger written by either package opens
in the other.
"""
from __future__ import annotations

import ctypes
from typing import Iterator, List, Optional, Sequence, Tuple

from tpubft_torch.ops._build import load_host
from tpubft_torch.storage.interfaces import (DEFAULT_FAMILY, IDBClient,
                                             StorageError, WriteBatch,
                                             family_upper_bound, fkey)

_U8P = ctypes.POINTER(ctypes.c_uint8)


def _lib():
    # Port divergence (reference native.py:17, native/build.py's load):
    # the port builds its own copy into ops/_build/ and never loads the
    # reference's library
    lib = load_host("kvlog")
    if getattr(lib, "_kvlog_typed", False):
        return lib
    lib.kvlog_open.restype = ctypes.c_void_p
    lib.kvlog_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.kvlog_close.argtypes = [ctypes.c_void_p]
    lib.kvlog_apply.restype = ctypes.c_int
    lib.kvlog_apply.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_uint32]
    lib.kvlog_get.restype = ctypes.c_int
    lib.kvlog_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.c_uint32, ctypes.POINTER(_U8P),
                              ctypes.POINTER(ctypes.c_uint32)]
    lib.kvlog_free.argtypes = [_U8P]
    lib.kvlog_count.restype = ctypes.c_uint64
    lib.kvlog_count.argtypes = [ctypes.c_void_p]
    lib.kvlog_wal_bytes.restype = ctypes.c_uint64
    lib.kvlog_wal_bytes.argtypes = [ctypes.c_void_p]
    lib.kvlog_scan.restype = ctypes.c_int
    lib.kvlog_scan.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_uint32, ctypes.c_char_p,
                               ctypes.c_uint32, ctypes.POINTER(_U8P),
                               ctypes.POINTER(ctypes.c_uint32)]
    lib.kvlog_compact.restype = ctypes.c_int
    lib.kvlog_compact.argtypes = [ctypes.c_void_p]
    lib.kvlog_sync.restype = ctypes.c_int
    lib.kvlog_sync.argtypes = [ctypes.c_void_p]
    lib.kvlog_checkpoint.restype = ctypes.c_int
    lib.kvlog_checkpoint.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib._kvlog_typed = True
    return lib


def _decode_scan(buf: bytes) -> List[Tuple[bytes, bytes]]:
    out, off, n = [], 0, len(buf)
    while off < n:
        klen = int.from_bytes(buf[off + 1:off + 5], "little")
        off += 5
        k = buf[off:off + klen]
        off += klen
        vlen = int.from_bytes(buf[off:off + 4], "little")
        off += 4
        out.append((k, buf[off:off + vlen]))
        off += vlen
    return out


class NativeDB(IDBClient):
    """Crash-consistent persistent KV store. `sync_writes=False` trades
    durability-per-batch for throughput (recovery still sees a prefix of
    committed batches — record CRCs stop replay at the torn tail).

    `sync_families` carves out families that stay durable anyway: a batch
    touching any of them is fsync'd after apply even when
    sync_writes=False (the consensus-metadata carve-out — losing a
    prepare this replica voted on is a safety hazard; block data is
    re-derivable from the quorum). Ignored when sync_writes=True (every
    batch already syncs)."""

    def __init__(self, path: str, sync_writes: bool = True,
                 compact_bytes: int = 64 << 20,
                 sync_families: Sequence[bytes] = ()) -> None:
        self._lib = _lib()
        self._h = self._lib.kvlog_open(path.encode(), 1 if sync_writes else 0)
        if not self._h:
            raise StorageError(f"kvlog_open failed for {path}")
        self._compact_bytes = compact_bytes
        self._sync_writes = sync_writes
        self._sync_prefixes: Tuple[bytes, ...] = () if sync_writes else \
            tuple(bytes([len(f)]) + f for f in sync_families)
        # ctypes releases the GIL around C calls, and the execution lane
        # writes ledger/pages batches concurrently with the dispatcher's
        # metadata batches on the SAME handle. The C engine is not
        # audited for lock-free concurrent access, so EVERY handle
        # operation — reads and scans included — serializes here. This
        # is a deliberate latency trade: a dispatcher point read can
        # block behind the lane's run commit (one buffered batch apply;
        # fsync only for sync-family batches, which originate on the
        # dispatcher itself). Relaxing reads requires a C-side
        # concurrency audit first.
        import threading
        self._write_mu = threading.Lock()

    def _handle(self):
        if not self._h:
            raise StorageError("NativeDB is closed")
        return self._h

    def get(self, key: bytes,
            family: bytes = DEFAULT_FAMILY) -> Optional[bytes]:
        self._handle()
        k = fkey(family, key)
        val = _U8P()
        vlen = ctypes.c_uint32()
        with self._write_mu:
            rc = self._lib.kvlog_get(self._handle(), k, len(k),
                                     ctypes.byref(val),
                                     ctypes.byref(vlen))
            if rc == 1:
                return None
            if rc != 0:
                raise StorageError(f"kvlog_get rc={rc}")
            try:
                return ctypes.string_at(val, vlen.value)
            finally:
                self._lib.kvlog_free(val)

    def write(self, batch: WriteBatch) -> None:
        self._handle()
        payload = batch.encode()
        with self._write_mu:
            rc = self._lib.kvlog_apply(self._handle(), payload,
                                       len(payload))
            if rc != 0:
                raise StorageError(f"kvlog_apply rc={rc}")
            if self._sync_prefixes and any(
                    k.startswith(self._sync_prefixes)
                    for k, _ in batch.ops):
                rc = self._lib.kvlog_sync(self._h)
                if rc != 0:
                    raise StorageError(f"kvlog_sync rc={rc}")
            need_compact = (self._lib.kvlog_wal_bytes(self._h)
                            > self._compact_bytes)
        if need_compact:
            self.compact()

    def write_group(self, batches) -> None:
        """Group-commit apply seam (durability/): concatenate the
        group's batches into ONE kvlog record — one payload encode, one
        apply under the handle lock, one CRC (so the whole group is
        atomic under torn-tail recovery), and in sync_writes mode one
        fsync instead of one per batch. The consensus-metadata carve-out
        applies to the union of the group's ops, exactly as if they had
        been one batch."""
        merged = WriteBatch()
        for b in batches:
            merged.ops.extend(b.ops)
        if merged.ops:
            self.write(merged)

    @property
    def syncs_on_write(self) -> bool:
        """True in sync_writes mode: every apply already fsyncs, so the
        durability pipeline's explicit group `sync()` would pay the
        disk twice per group — the pipeline skips it."""
        return self._sync_writes

    def sync(self) -> None:
        """One fsync covering every batch applied so far — the
        durability pipeline's group-commit boundary. Held under the
        handle lock: kvlog_sync only reads the fd, but close() frees
        the handle and must never race an in-flight C call (same rule
        as every other handle op). Writers queued behind a slow sync
        pay the disk once per GROUP, not per run — the amortization the
        pipeline exists to buy."""
        with self._write_mu:
            rc = self._lib.kvlog_sync(self._handle())
            if rc != 0:
                raise StorageError(f"kvlog_sync rc={rc}")

    def range_iter(self, family: bytes = DEFAULT_FAMILY,
                   start: Optional[bytes] = None,
                   end: Optional[bytes] = None
                   ) -> Iterator[Tuple[bytes, bytes]]:
        self._handle()
        lo = fkey(family, start if start is not None else b"")
        hi = fkey(family, end) if end is not None else family_upper_bound(family)
        out = _U8P()
        outlen = ctypes.c_uint32()
        with self._write_mu:
            rc = self._lib.kvlog_scan(
                self._handle(), lo, len(lo),
                hi if hi is not None else b"",
                0xFFFFFFFF if hi is None else len(hi),
                ctypes.byref(out), ctypes.byref(outlen))
            if rc != 0:
                raise StorageError(f"kvlog_scan rc={rc}")
            try:
                buf = ctypes.string_at(out, outlen.value)
            finally:
                self._lib.kvlog_free(out)
        prefix = 1 + len(family)
        for k, v in _decode_scan(buf):
            yield k[prefix:], v

    def scan_all(self):
        from tpubft_torch.storage.interfaces import split_fkey
        self._handle()
        out = _U8P()
        outlen = ctypes.c_uint32()
        with self._write_mu:
            rc = self._lib.kvlog_scan(self._handle(), b"", 0, b"",
                                      0xFFFFFFFF, ctypes.byref(out),
                                      ctypes.byref(outlen))
            if rc != 0:
                raise StorageError(f"kvlog_scan rc={rc}")
            try:
                buf = ctypes.string_at(out, outlen.value)
            finally:
                self._lib.kvlog_free(out)
        for k, v in _decode_scan(buf):
            fam, key = split_fkey(k)
            yield fam, key, v

    def compact(self) -> None:
        with self._write_mu:
            rc = self._lib.kvlog_compact(self._handle())
            if rc != 0:
                raise StorageError(f"kvlog_compact rc={rc}")

    def checkpoint_to(self, path: str) -> None:
        """Consistent snapshot for operator backups (reference:
        DbCheckpointManager RocksDB checkpoints). The snapshot file is a
        valid kvlog — openable with NativeDB directly."""
        with self._write_mu:
            rc = self._lib.kvlog_checkpoint(self._handle(), path.encode())
            if rc != 0:
                raise StorageError(f"kvlog_checkpoint rc={rc}")

    def count(self) -> int:
        with self._write_mu:
            return self._lib.kvlog_count(self._handle())

    def close(self) -> None:
        # under the handle lock: a lane thread that outlived its join
        # timeout could still be inside a C call on this handle — close
        # must never free it mid-operation
        with self._write_mu:
            if self._h:
                self._lib.kvlog_close(self._h)
                self._h = None
