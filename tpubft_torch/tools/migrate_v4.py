"""Ledger engine migration: v1 / categorized / v4, any direction (port
of tpubft/tools/migrate_v4.py).

Rebuild of the reference's v4 migration CLI
(concord-bft kvbc/tools/migrations/v4migration_tool/): replays every
block of a source DB into a destination DB running the other engine,
verifying block-update round-trips as it goes. The chain digests differ
across engines by design (category digests are computed differently), so
the tool re-derives them and reports both heads.

Usage:
  python -m tpubft_torch.tools.migrate_v4 --src DB --dst DB \
      --from categorized --to v4 [--no-verify]
"""
from __future__ import annotations

import argparse
import sys

from tpubft_torch.kvbc import create_blockchain
from tpubft_torch.kvbc import categories as cat


def migrate(src_db, dst_db, src_version: str, dst_version: str,
            verify: bool = True, log=print) -> int:
    src = create_blockchain(src_db, version=src_version,
                            use_device_hashing=False)
    dst = create_blockchain(dst_db, version=dst_version,
                            use_device_hashing=False)
    if dst.last_block_id != 0:
        raise SystemExit("destination DB is not empty")
    first = src.genesis_block_id or 1
    if first > 1:
        raise SystemExit(
            "source chain is pruned below genesis block 1; a migrated "
            "chain must replay from block 1 to reproduce state")
    # bulk replay through add_blocks: one atomic WriteBatch (and, with
    # sync_writes, one fsync) per chunk instead of per block, and the
    # categorized engine hashes each chunk's merkle updates level-wise
    # across all its blocks in one batched call per tree level
    # (SparseMerkleTree.update_batches) instead of per-block host walks
    CHUNK = 64
    migrated = 0
    buf = []
    for bid in range(1, src.last_block_id + 1):
        blk = src.get_block(bid)
        if blk is None:
            raise SystemExit(f"missing source block {bid}")
        buf.append(cat.decode_block_updates(blk.updates_blob))
        if len(buf) == CHUNK:
            head = dst.add_blocks(buf)
            if head != bid:
                raise SystemExit(f"migration desync: dst head {head} "
                                 f"after source block {bid}")
            migrated += len(buf)
            buf = []
            if migrated % 1024 == 0:
                log(f"migrated {migrated} blocks...")
    if buf:
        head = dst.add_blocks(buf)
        if head != src.last_block_id:
            raise SystemExit(f"migration desync: dst head {head} != "
                             f"source head {src.last_block_id}")
        migrated += len(buf)
    if verify:
        for bid in range(1, dst.last_block_id + 1):
            sb, db_ = src.get_block(bid), dst.get_block(bid)
            if sb.updates_blob != db_.updates_blob:
                raise SystemExit(f"updates mismatch at block {bid}")
    log(f"migrated {migrated} blocks "
        f"({src_version} head {src.state_digest().hex()[:16]} -> "
        f"{dst_version} head {dst.state_digest().hex()[:16]})")
    return migrated


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--src", required=True)
    ap.add_argument("--dst", required=True)
    ap.add_argument("--from", dest="src_version", default="categorized")
    ap.add_argument("--to", dest="dst_version", default="v4")
    ap.add_argument("--no-verify", dest="verify", action="store_false",
                    default=True,
                    help="skip the full second read-and-compare pass")
    args = ap.parse_args()
    from tpubft_torch.storage.factory import open_db
    # offline tool: full per-batch durability on the destination (the
    # replica's unsynced default is a latency tradeoff this tool
    # doesn't need)
    migrate(open_db(args.src), open_db(args.dst, sync_writes=True),
            args.src_version, args.dst_version, verify=args.verify)
    return 0


if __name__ == "__main__":
    sys.exit(main())
