"""tpubft-snapshot — operator CLI for state snapshots (port of
tpubft/tools/snapshot.py).

Rebuild of the reference's snapshot/object-store operator tooling
(kvbc state_snapshot_interface.hpp consumers + object_store_utility):
create a self-verifying snapshot file from a replica DB, inspect its
manifest, verify its integrity, and provision a fresh replica DB from
it — without any cluster running.

Usage:
  python -m tpubft_torch.tools.snapshot create  <db-path> <snapshot-file>
  python -m tpubft_torch.tools.snapshot inspect <snapshot-file>
  python -m tpubft_torch.tools.snapshot verify  <snapshot-file>
  python -m tpubft_torch.tools.snapshot restore <snapshot-file> <new-db-path>
"""
from __future__ import annotations

import argparse
import json
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("command",
                    choices=("create", "inspect", "verify", "restore"))
    ap.add_argument("source")
    ap.add_argument("target", nargs="?")
    ap.add_argument("--kvbc-version", default="categorized",
                    choices=("categorized", "v4", "v1"))
    args = ap.parse_args()

    from tpubft_torch.kvbc import create_blockchain
    from tpubft_torch.storage.factory import open_db
    from tpubft_torch.kvbc.snapshots import (SnapshotError, create_snapshot,
                                       read_manifest, restore_snapshot)

    import os
    try:
        if args.command == "create":
            if not args.target:
                raise SystemExit("create needs <db-path> <snapshot-file>")
            if not os.path.exists(args.source):
                # open_db would CREATE an empty store at a typo'd path
                # and the tool would happily snapshot nothing
                raise SystemExit(f"no such DB: {args.source}")
            db = open_db(args.source)
            bc = create_blockchain(db, version=args.kvbc_version,
                                   use_device_hashing=False)
            man = create_snapshot(db, args.target,
                                  head_block=bc.last_block_id,
                                  state_digest=bc.state_digest())
            print(json.dumps({"created": args.target, **man}))
        elif args.command == "inspect":
            print(json.dumps(read_manifest(args.source)))
        elif args.command == "verify":
            # restore into a throwaway in-memory store: runs the full
            # pass-1 integrity + framing + count validation
            from tpubft_torch.storage.memorydb import MemoryDB
            man = restore_snapshot(args.source, MemoryDB())
            print(json.dumps({"ok": True, **man}))
        elif args.command == "restore":
            if not args.target:
                raise SystemExit(
                    "restore needs <snapshot-file> <new-db-path>")
            if os.path.exists(args.target):
                # restore_snapshot requires an EMPTY target; merging over
                # an existing DB would leave mixed state behind a failed
                # digest check
                raise SystemExit(
                    f"target already exists: {args.target} "
                    "(restore provisions a NEW db)")
            # offline restore: fsync per batch — the provisioned DB must
            # survive a power cut the moment the tool reports success
            db = open_db(args.target, sync_writes=True)
            man = restore_snapshot(args.source, db)
            bc = create_blockchain(db, version=args.kvbc_version,
                                   use_device_hashing=False)
            ok = (man["state_digest"] == bc.state_digest().hex())
            print(json.dumps({"restored": args.target, "digest_ok": ok,
                              **man}))
            if not ok:
                return 1
    except SnapshotError as e:
        print(json.dumps({"ok": False, "error": str(e)}))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
