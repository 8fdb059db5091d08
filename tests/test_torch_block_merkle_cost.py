"""What a BLOCK_MERKLE block costs in MemoryDB, in the port and in the
reference (ROADMAP C.12).

`skvbc_replica --merkle` keeps every key of a write in the BLOCK_MERKLE
category "kv", which the thin-replica read tier's proofs need. A block
of kvbcbench's nine keys then writes a node row for each level of each
key's path in the sparse Merkle tree. The reference's MemoryDB keeps its
keys in one sorted list (`bisect.insort`, `tpubft/storage/memorydb.py:35`),
so each new row moves the rows after it and a block's cost grows with
the ledger; the port's keeps sorted chunks of keys
(`tpubft_torch/storage/memorydb.py`), so a row moves one chunk's rows.

As tests: such blocks leave the same rows in both packages' MemoryDB,
and each key adds at least a hundred node rows a block.

As a script, each package's `add_block` timed as the ledger grows:

    JAX_PLATFORMS=cpu PYTHONPATH=. \\
        python tests/test_torch_block_merkle_cost.py \\
        [--blocks 200] [--at 50,100,200] [--keys 9] [--profile]

prints one JSON line a package: at each count in `--at`, the mean ms of
the ten blocks up to it and the rows the DB holds there; with
`--profile`, also the seconds of the run under cProfile and those spent
in `bisect.insort` (the reference's one list, the port's chunks).
"""
from __future__ import annotations

import time

from tpubft.kvbc import BlockUpdates as RBlockUpdates
from tpubft.kvbc import KeyValueBlockchain as RKeyValueBlockchain
from tpubft.storage import MemoryDB as RMemoryDB
from tpubft_torch import convert
from tpubft_torch.kvbc import BlockUpdates, KeyValueBlockchain
from tpubft_torch.storage import MemoryDB

PACKAGES = {"tpubft_torch": (KeyValueBlockchain, MemoryDB, BlockUpdates),
            "tpubft": (RKeyValueBlockchain, RMemoryDB, RBlockUpdates)}


def skvbc_merkle_rows(block: int, keys: int = 9) -> list:
    """Block `block`'s rows as `skvbc_replica --merkle` stores one
    kvbcbench write of `keys` keys: all in the BLOCK_MERKLE category
    "kv", under a client's key prefix."""
    return [("kv", b"c%d/k-%d" % (block % 32, (block * keys + i) % 4096),
             b"v-%d-%d" % (block, i), "block_merkle") for i in range(keys)]


def _chain(package: str):
    bc_cls, db_cls, bu_cls = PACKAGES[package]
    db = db_cls()
    return bc_cls(db, use_device_hashing=False), db, bu_cls


def _rows(db) -> list:
    return sorted(db.scan_all())


def test_merkle_blocks_leave_the_same_rows_in_both_packages():
    """Five nine-key BLOCK_MERKLE blocks: the port's MemoryDB holds the
    reference's rows, byte for byte."""
    dbs = {}
    for package in PACKAGES:
        bc, db, bu_cls = _chain(package)
        for b in range(5):
            bc.add_block(convert.block_updates(skvbc_merkle_rows(b), bu_cls))
        dbs[package] = _rows(db)
    assert dbs["tpubft_torch"] == dbs["tpubft"]


def test_a_merkle_key_writes_a_node_row_a_level():
    """Each key of a BLOCK_MERKLE block adds at least a hundred rows in
    both packages (its path's node rows): the rows that make a block's
    MemoryDB insertions grow with the ledger."""
    for package in PACKAGES:
        bc, db, bu_cls = _chain(package)
        bc.add_block(convert.block_updates(skvbc_merkle_rows(0), bu_cls))
        before = len(_rows(db))
        bc.add_block(convert.block_updates(skvbc_merkle_rows(1, keys=1),
                                           bu_cls))
        assert len(_rows(db)) - before >= 100, package


def time_package(package: str, blocks: int, at, keys: int) -> dict:
    """`package`'s add_block as the ledger grows to `blocks`: at each
    count in `at`, the mean ms of the ten blocks up to it and the DB's
    rows."""
    bc, db, bu_cls = _chain(package)
    updates = [convert.block_updates(skvbc_merkle_rows(b, keys), bu_cls)
               for b in range(blocks)]
    ms, out = [], {}
    for b, bu in enumerate(updates, 1):
        t = time.perf_counter()
        bc.add_block(bu)
        ms.append((time.perf_counter() - t) * 1e3)
        if b in at:
            out[b] = {"ms_a_block": sum(ms[-10:]) / len(ms[-10:]),
                      "rows": len(db._map)}
    return {"package": package, "keys_a_block": keys, "at": out}


def main(argv=None) -> int:
    import argparse
    import json
    import platform
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", type=int, default=200)
    ap.add_argument("--at", default="50,100,200")
    ap.add_argument("--keys", type=int, default=9)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    at = {int(x) for x in args.at.split(",")}
    for package in PACKAGES:
        prof = None
        if args.profile:
            import cProfile
            prof = cProfile.Profile()
            prof.enable()
        out = time_package(package, args.blocks, at, args.keys)
        if prof is not None:
            import pstats
            prof.disable()
            stats = pstats.Stats(prof).stats
            out["profiled_s"] = pstats.Stats(prof).total_tt
            out["insort_s"] = sum(st[2] for fn, st in stats.items()
                                  if "insort" in fn[2])
        print(json.dumps({**out,
                          "host": platform.processor() or platform.machine(),
                          "python": platform.python_version()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
