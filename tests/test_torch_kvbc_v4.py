"""The port's v4 ledger engine (tpubft_torch/kvbc/v4.py) against the
reference's (tpubft/kvbc/v4.py) on the same seeded blocks, byte for
byte: every DB row, raw block, block digest and state digest, the
answers of get_latest, get_versioned and get_tagged at every block id,
the same refusals, pruning, state-transfer staging and linking, and the
kvlog files of both packages' NativeDB. The counterparts of
tests/test_kvbc_v4.py's engine tests are here too; its migration tests
are in tests/test_torch_migrate.py."""
import os

import pytest

from tpubft.kvbc import BlockUpdates as RBlockUpdates
from tpubft.kvbc import create_blockchain as rcreate
from tpubft.kvbc.blockchain import BlockchainError as RBlockchainError
from tpubft.kvbc.categories import CategoryError as RCategoryError
from tpubft.storage.memorydb import MemoryDB as RMemoryDB
from tpubft.storage.native import NativeDB as RNativeDB
from tpubft_torch import convert, testing
from tpubft_torch.kvbc import (IMMUTABLE, BlockUpdates, V4KeyValueBlockchain,
                               create_blockchain)
from tpubft_torch.kvbc.blockchain import BlockchainError
from tpubft_torch.kvbc.categories import CategoryError
from tpubft_torch.storage import MemoryDB
from tpubft_torch.storage.native import NativeDB

SEEDS = (0, 1, 2)
BLOCKS = 24


def _pair(rows, version="v4"):
    rdb, pdb = RMemoryDB(), MemoryDB()
    rbc = rcreate(rdb, version=version, use_device_hashing=False)
    pbc = create_blockchain(pdb, version=version, use_device_hashing=False)
    for r in rows:
        rbc.add_block(convert.block_updates(r, RBlockUpdates))
        pbc.add_block(convert.block_updates(r))
    return rdb, rbc, pdb, pbc


def _assert_same(rdb, rbc, pdb, pbc):
    assert pbc.last_block_id == rbc.last_block_id
    assert pbc.genesis_block_id == rbc.genesis_block_id
    for b in range(max(1, rbc.genesis_block_id), rbc.last_block_id + 1):
        assert pbc.get_raw_block(b) == rbc.get_raw_block(b)
        assert pbc.block_digest(b) == rbc.block_digest(b)
    assert pbc.state_digest() == rbc.state_digest()
    assert list(pdb.scan_all()) == list(rdb.scan_all())


def _keys(rows):
    return sorted({(r[0], r[1]) for block in rows for r in block})


@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_ledger_equals_reference(seed):
    rows = testing.ledger_rows(BLOCKS, seed)
    rdb, rbc, pdb, pbc = _pair(rows)
    assert isinstance(pbc, V4KeyValueBlockchain)
    _assert_same(rdb, rbc, pdb, pbc)
    for b in range(1, BLOCKS + 1):
        assert pbc.get_block(b).category_digests == \
            rbc.get_block(b).category_digests


@pytest.mark.parametrize("seed", SEEDS)
def test_reads_at_every_block_equal_reference(seed):
    rows = testing.ledger_rows(BLOCKS, seed)
    _, rbc, _, pbc = _pair(rows)
    keys = _keys(rows)
    for cat, key in keys:
        assert pbc.get_latest(cat, key) == rbc.get_latest(cat, key)
        for b in range(0, BLOCKS + 2):
            assert pbc.get_versioned(cat, key, b) == \
                rbc.get_versioned(cat, key, b), (cat, key, b)
    for tag in ("t0", "t1", "t2", "none"):
        for cat in ("ev", "kv"):
            assert pbc.get_tagged(cat, tag) == rbc.get_tagged(cat, tag)
    assert any(pbc.get_tagged("ev", t) for t in ("t0", "t1", "t2"))


@pytest.mark.parametrize("seed", SEEDS)
def test_pruning_equals_reference(seed):
    rows = testing.ledger_rows(BLOCKS, seed)
    rdb, rbc, pdb, pbc = _pair(rows)
    for until in (5, 11):
        assert pbc.delete_blocks_until(until) == \
            rbc.delete_blocks_until(until)
        _assert_same(rdb, rbc, pdb, pbc)
        for cat, key in _keys(rows):
            for b in range(0, BLOCKS + 1):
                assert pbc.get_versioned(cat, key, b) == \
                    rbc.get_versioned(cat, key, b)
    with pytest.raises(BlockchainError):
        pbc.delete_blocks_until(99)
    with pytest.raises(RBlockchainError):
        rbc.delete_blocks_until(99)


def test_refusals_equal_reference():
    """Immutable rewrite and delete raise CategoryError; proofs and
    Merkle roots BlockchainError; in both packages, and the store is
    left as it was."""
    rdb, rbc, pdb, pbc = _pair([[("ev", b"k", b"v", IMMUTABLE, ["t1"])]])
    cases = [
        (lambda bu: bu.put("ev", b"k", b"v2", IMMUTABLE),
         CategoryError, RCategoryError),
        (lambda bu: bu.delete("ev", b"j", IMMUTABLE),
         CategoryError, RCategoryError)]
    for make, perr, rerr in cases:
        with pytest.raises(perr):
            pbc.add_block(make(BlockUpdates()))
        with pytest.raises(rerr):
            rbc.add_block(make(RBlockUpdates()))
    for call in (lambda bc: bc.prove("ev", b"k"),
                 lambda bc: bc.merkle_root("ev")):
        with pytest.raises(BlockchainError, match="no Merkle trees"):
            call(pbc)
        with pytest.raises(RBlockchainError, match="no Merkle trees"):
            call(rbc)
    _assert_same(rdb, rbc, pdb, pbc)
    assert pbc.get_tagged("ev", "t1") == [(b"k", b"v")]


def test_write_read_latest_and_versioned():
    bc = create_blockchain(MemoryDB(), version="v4")
    bc.add_block(BlockUpdates().put("c", b"k", b"v1"))
    bc.add_block(BlockUpdates().put("c", b"k", b"v2").put("c", b"j", b"w"))
    assert bc.get_latest("c", b"k") == (2, b"v2")
    assert bc.get_latest("c", b"absent") is None
    assert bc.get_versioned("c", b"k", 1) == b"v1"
    assert bc.get_versioned("c", b"j", 1) is None
    bc.add_block(BlockUpdates().delete("c", b"k"))
    assert bc.get_latest("c", b"k") is None
    assert bc.get_block(3).parent_digest == bc.get_block(2).digest()
    assert bc.state_digest() == bc.get_block(3).digest()


@pytest.mark.parametrize("seed", SEEDS)
def test_st_staging_and_linking_of_reference_blocks(seed):
    """Raw blocks of the reference's v4 ledger, staged out of order into
    a port and a reference ledger and linked, rebuild the same rows; a
    block whose updates blob was flipped is rejected by both and
    dropped, not adopted."""
    rows = testing.ledger_rows(12, seed)
    rdb, rbc, _, _ = _pair(rows)
    dsts = [(MemoryDB(), create_blockchain), (RMemoryDB(), rcreate)]
    dsts = [(db, make(db, version="v4")) for db, make in dsts]
    raw = bytearray(rbc.get_raw_block(5))
    raw[-1] ^= 0x01
    for _, bc in dsts:
        for bid in (4, 2, 3):
            bc.add_raw_st_block(bid, rbc.get_raw_block(bid))
        assert bc.link_st_chain() == 0
        bc.add_raw_st_block(1, rbc.get_raw_block(1))
        assert bc.link_st_chain() == 4
        bc.add_raw_st_block(5, bytes(raw))
        with pytest.raises(Exception):
            bc.link_st_chain()
        assert bc.last_block_id == 4
        for bid in range(5, 13):
            bc.add_raw_st_block(bid, rbc.get_raw_block(bid))
        assert bc.link_st_chain() == 12
    (pdb, pbc), (qdb, qbc) = dsts
    _assert_same(rdb, rbc, pdb, pbc)
    _assert_same(qdb, qbc, pdb, pbc)


@pytest.mark.parametrize("seed", SEEDS)
def test_kvlog_files_equal_across_packages(tmp_path, seed):
    """The same seeded v4 ledger over each package's NativeDB gives
    byte-identical kvlog files, and each package reopens the other's at
    the same head and state digest."""
    rows = testing.ledger_rows(BLOCKS, seed)
    paths = {n: str(tmp_path / f"{n}.kvlog") for n in ("port", "ref")}
    rdb = RNativeDB(paths["ref"])
    rbc = rcreate(rdb, version="v4")
    pdb = NativeDB(paths["port"])
    pbc = create_blockchain(pdb, version="v4")
    for r in rows:
        rbc.add_block(convert.block_updates(r, RBlockUpdates))
        pbc.add_block(convert.block_updates(r))
    rbc.delete_blocks_until(3)
    pbc.delete_blocks_until(3)
    head = rbc.state_digest()
    rdb.close()
    pdb.close()
    with open(paths["port"], "rb") as f, open(paths["ref"], "rb") as g:
        assert f.read() == g.read()
    assert os.path.getsize(paths["port"]) > 0
    db = NativeDB(paths["ref"])
    assert create_blockchain(db, version="v4").state_digest() == head
    db.close()
    db = RNativeDB(paths["port"])
    assert rcreate(db, version="v4").state_digest() == head
    db.close()
