"""State snapshots — whole-state export/import for replica provisioning
(a copy of tpubft/kvbc/snapshots.py: the same MAGIC, record framing and
trailing SHA-256, so either package restores the other's files).

Rebuild of the reference's state-snapshot surface
(concord-bft kvbc/include/kvbc_app_filter/... state_snapshot_interface.hpp,
the RocksDB-checkpoint-based DbCheckpointManager stream, and the
clientservice state-snapshot gRPC service): a snapshot captures the FULL
storage state (every family — ledger, latest indexes, Merkle nodes,
reserved pages, consensus metadata excluded by filter) into one
self-verifying file a new replica can be provisioned from without
replaying history.

File layout: header JSON line (version, head block, state digest, entry
count) then length-prefixed (family, key, value) records, then a trailing
sha256 over everything before it.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import tempfile
from typing import Callable, Optional

from tpubft_torch.storage.interfaces import IDBClient, WriteBatch

MAGIC = b"TPUBFT-SNAPSHOT-1\n"

# families holding per-process consensus metadata a NEW replica must not
# inherit (it would impersonate the source's protocol position)
_DEFAULT_EXCLUDE = (b"metadata",)


class SnapshotError(Exception):
    pass


def _rec(fam: bytes, key: bytes, val: bytes) -> bytes:
    return struct.pack("<HII", len(fam), len(key), len(val)) + fam + key + val


def create_snapshot(db: IDBClient, path: str,
                    head_block: int = 0, state_digest: bytes = b"",
                    exclude: tuple = _DEFAULT_EXCLUDE,
                    filter_fn: Optional[Callable[[bytes], bool]] = None
                    ) -> dict:
    """Stream the store into `path` (atomic: tmp + rename). Returns the
    manifest."""
    # streamed, O(1) memory: records spill to a spool file first (the
    # entry count must precede them in the final layout), then the final
    # file is assembled chunk-wise with an incremental digest — a multi-GB
    # ledger never materializes in RAM
    count = 0
    dirname = os.path.dirname(path) or "."
    sfd, spool = tempfile.mkstemp(dir=dirname)
    tmp = None
    try:
        with os.fdopen(sfd, "wb") as sp:
            for fam, key, val in db.scan_all():
                if fam in exclude:       # exact family match
                    continue
                if filter_fn is not None and not filter_fn(fam):
                    continue
                sp.write(_rec(fam, key, val))
                count += 1
        manifest = {"version": 1, "head_block": head_block,
                    "state_digest": state_digest.hex(),
                    "entries": count}
        h = hashlib.sha256()
        fd, tmp = tempfile.mkstemp(dir=dirname)
        with os.fdopen(fd, "wb") as out, open(spool, "rb") as sp:
            header = MAGIC + json.dumps(manifest).encode() + b"\n"
            out.write(header)
            h.update(header)
            while True:
                chunk = sp.read(1 << 20)
                if not chunk:
                    break
                out.write(chunk)
                h.update(chunk)
            out.write(h.digest())
            out.flush()
            os.fsync(out.fileno())
        os.replace(tmp, path)
    except BaseException:
        if tmp is not None and os.path.exists(tmp):
            os.unlink(tmp)
        raise
    finally:
        if os.path.exists(spool):
            os.unlink(spool)
    return manifest


def read_manifest(path: str) -> dict:
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise SnapshotError("not a tpubft snapshot")
        return json.loads(f.readline().decode())


def restore_snapshot(path: str, db: IDBClient,
                     batch_entries: int = 1024) -> dict:
    """Stream-verify integrity while populating `db` (must be empty of
    the snapshot's families) — two sequential passes over the file, O(1)
    memory. Returns the manifest.

    The digest, record framing, AND manifest entry count are all checked
    in a FIRST full pass before any write reaches the DB, so a corrupt
    or self-inconsistent snapshot never leaves a half-restored store."""
    size = os.path.getsize(path)
    if size < len(MAGIC) + 32:
        raise SnapshotError("truncated snapshot")
    body_len = size - 32
    # pass 1: integrity + framing + count — no DB writes yet
    h = hashlib.sha256()
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise SnapshotError("not a tpubft snapshot")
        h.update(magic)
        header = f.readline()
        h.update(header)
        try:
            manifest = json.loads(header.decode())
            expected_entries = int(manifest["entries"])
        except (UnicodeDecodeError, ValueError, KeyError, TypeError) as e:
            raise SnapshotError(f"corrupt snapshot header: {e}") from e
        counted = 0
        while f.tell() < body_len:
            hdr = f.read(10)
            if len(hdr) != 10 or f.tell() > body_len:
                raise SnapshotError("corrupt record")
            fl, kl, vl = struct.unpack("<HII", hdr)
            if f.tell() + fl + kl + vl > body_len:
                raise SnapshotError("corrupt record")
            body = f.read(fl + kl + vl)
            h.update(hdr)
            h.update(body)
            counted += 1
        if f.read(32) != h.digest():
            raise SnapshotError("snapshot integrity check failed")
        if counted != expected_entries:
            raise SnapshotError(
                f"entry count mismatch: {counted} != {expected_entries}")
    # pass 2: restore (file already fully validated)
    with open(path, "rb") as f:
        f.read(len(MAGIC))
        f.readline()
        wb = WriteBatch()
        while f.tell() < body_len:
            fl, kl, vl = struct.unpack("<HII", f.read(10))
            fam = f.read(fl)
            key = f.read(kl)
            val = f.read(vl)
            wb.put(key, val, fam)
            if len(wb) >= batch_entries:
                db.write(wb)
                wb = WriteBatch()
    if len(wb):
        db.write(wb)
    return manifest
