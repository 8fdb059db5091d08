"""The port's ledger migration (tpubft_torch/tools/migrate_v4.py) against
the reference's (tpubft/tools/migrate_v4.py) in every direction between
the engines: equal destination rows from `migrate` on seeded ledgers,
byte-equal destination kvlog files from the two CLIs, and the same
refusals. The counterparts of tests/test_kvbc_v4.py's and
tests/test_kvbc_v1.py's migration tests are here too."""
import os
import subprocess
import sys

import pytest

from tpubft.kvbc import BlockUpdates as RBlockUpdates
from tpubft.kvbc import create_blockchain as rcreate
from tpubft.storage.memorydb import MemoryDB as RMemoryDB
from tpubft.tools.migrate_v4 import migrate as rmigrate
from tpubft_torch import convert, testing
from tpubft_torch.kvbc import (BLOCK_MERKLE, IMMUTABLE, BlockUpdates,
                               create_blockchain)
from tpubft_torch.storage import MemoryDB
from tpubft_torch.storage.native import NativeDB
from tpubft_torch.tools.migrate_v4 import migrate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIRECTIONS = [("v1", "v4"), ("v1", "categorized"), ("categorized", "v4"),
              ("v4", "categorized")]
BLOCKS = 70     # more than one add_blocks chunk of 64


def _quiet(*_a):
    pass


def _source(db, version, rows, cls=BlockUpdates, make=create_blockchain):
    bc = make(db, version=version, use_device_hashing=False)
    for r in rows:
        bc.add_block(convert.block_updates(r, cls))
    return bc


@pytest.mark.parametrize("src, dst", DIRECTIONS)
def test_migrate_gives_the_reference_rows(src, dst):
    rows = testing.ledger_rows(BLOCKS, seed=len(src) + 7 * len(dst))
    psrc, rsrc = MemoryDB(), RMemoryDB()
    _source(psrc, src, rows)
    _source(rsrc, src, rows, RBlockUpdates, rcreate)
    assert list(psrc.scan_all()) == list(rsrc.scan_all())
    pdst, rdst = MemoryDB(), RMemoryDB()
    assert migrate(psrc, pdst, src, dst, log=_quiet) == BLOCKS
    assert rmigrate(rsrc, rdst, src, dst, log=_quiet) == BLOCKS
    assert list(pdst.scan_all()) == list(rdst.scan_all())
    bc = create_blockchain(pdst, version=dst, use_device_hashing=False)
    assert bc.last_block_id == BLOCKS
    for b in range(1, BLOCKS + 1):
        assert bc.get_block(b).updates_blob == \
            create_blockchain(psrc, version=src).get_block(b).updates_blob


def _cli(package, env, *args):
    return subprocess.run(
        [sys.executable, "-m", f"{package}.tools.migrate_v4", *args],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)


@pytest.mark.parametrize("src, dst", DIRECTIONS)
def test_clis_write_byte_equal_destination_files(tmp_path, src, dst):
    """Both packages' CLIs migrate one kvlog file; their destination
    kvlog files are byte-equal, and each log line names the same heads."""
    rows = testing.ledger_rows(BLOCKS, seed=3)
    src_path = str(tmp_path / "src.kvlog")
    db = NativeDB(src_path)
    _source(db, src, rows)
    db.close()
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    outs = {}
    for package in ("tpubft_torch", "tpubft"):
        path = str(tmp_path / package / "dst.kvlog")
        out = _cli(package, env, "--src", src_path, "--dst", path,
                   "--from", src, "--to", dst)
        assert out.returncode == 0, out.stderr
        outs[package] = out.stdout
        with open(path, "rb") as f:
            outs[package + "_file"] = f.read()
    assert outs["tpubft_torch_file"] == outs["tpubft_file"]
    assert outs["tpubft_torch"] == outs["tpubft"]
    assert f"migrated {BLOCKS} blocks ({src} head" in outs["tpubft"]


@pytest.mark.parametrize("case", ["non_empty_destination", "pruned_source"])
def test_refusals_equal_reference(case):
    msgs = []
    for make, cls, mig, mem in (
            (create_blockchain, BlockUpdates, migrate, MemoryDB),
            (rcreate, RBlockUpdates, rmigrate, RMemoryDB)):
        src, dst = mem(), mem()
        bc = _source(src, "categorized", testing.ledger_rows(6, 1), cls,
                     make)
        if case == "pruned_source":
            bc.delete_blocks_until(3)
        else:
            _source(dst, "v4", testing.ledger_rows(1, 2), cls, make)
        with pytest.raises(SystemExit) as err:
            mig(src, dst, "categorized", "v4", log=_quiet)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert ("not empty" if case == "non_empty_destination"
            else "pruned below genesis") in msgs[0]


def test_categorized_to_v4_and_back_restores_history():
    """tests/test_kvbc_v4.py's round trip on the port: tags survive into
    v4, and v4 -> categorized reproduces multi-version reads."""
    src_db = MemoryDB()
    src = create_blockchain(src_db, version="categorized",
                            use_device_hashing=False)
    src.add_block(BlockUpdates().put("kv", b"a", b"1")
                  .put("proven", b"m", b"x", BLOCK_MERKLE))
    src.add_block(BlockUpdates().put("kv", b"a", b"2")
                  .put("ev", b"e", b"once", IMMUTABLE, tags=["t"]))
    dst_db = MemoryDB()
    assert migrate(src_db, dst_db, "categorized", "v4", log=_quiet) == 2
    dst = create_blockchain(dst_db, version="v4")
    assert dst.get_latest("kv", b"a") == (2, b"2")
    assert dst.get_tagged("ev", "t") == [(b"e", b"once")]
    back_db = MemoryDB()
    assert migrate(dst_db, back_db, "v4", "categorized", log=_quiet) == 2
    back = create_blockchain(back_db, version="categorized",
                             use_device_hashing=False)
    assert back.get_versioned("kv", b"a", 1) == b"1"
    assert back.get_latest("kv", b"a") == (2, b"2")
