"""The port's v1 direct-KV engine (tpubft_torch/kvbc/v1.py) against the
reference's (tpubft/kvbc/v1.py) on the same seeded blocks, byte for
byte: every DB row, raw block, block digest and state digest, the
latest reads at every key, the history reads it refuses, pruning,
state-transfer staging and linking, and the kvlog files of both
packages' NativeDB. The counterparts of tests/test_kvbc_v1.py's engine
tests are here too; its migration tests are in
tests/test_torch_migrate.py."""
import pytest

from tpubft.kvbc import BlockUpdates as RBlockUpdates
from tpubft.kvbc import create_blockchain as rcreate
from tpubft.kvbc.blockchain import BlockchainError as RBlockchainError
from tpubft.storage.memorydb import MemoryDB as RMemoryDB
from tpubft.storage.native import NativeDB as RNativeDB
from tpubft_torch import convert, testing
from tpubft_torch.kvbc import BlockUpdates, create_blockchain
from tpubft_torch.kvbc.blockchain import BlockchainError
from tpubft_torch.kvbc.v1 import DirectKVBlockchain
from tpubft_torch.storage import MemoryDB
from tpubft_torch.storage.native import NativeDB

SEEDS = (0, 1, 2)
BLOCKS = 24


def _pair(rows, version="v1"):
    rdb, pdb = RMemoryDB(), MemoryDB()
    rbc = rcreate(rdb, version=version)
    pbc = create_blockchain(pdb, version=version)
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


@pytest.mark.parametrize("version", ["v1", "direct"])
@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_ledger_and_latest_reads_equal_reference(seed, version):
    rows = testing.ledger_rows(BLOCKS, seed)
    rdb, rbc, pdb, pbc = _pair(rows, version)
    assert isinstance(pbc, DirectKVBlockchain)
    _assert_same(rdb, rbc, pdb, pbc)
    for cat, key in sorted({(r[0], r[1]) for b in rows for r in b}):
        assert pbc.get_latest(cat, key) == rbc.get_latest(cat, key)
        assert pbc.get_latest(cat, key, "immutable") == \
            rbc.get_latest(cat, key, "immutable")


def test_history_reads_raise_as_the_reference():
    _, rbc, _, pbc = _pair(testing.ledger_rows(3, 5))
    calls = (lambda bc: bc.get_versioned("kv", b"kv-0", 1),
             lambda bc: bc.get_tagged("ev", "t0"),
             lambda bc: bc.prove("kv", b"kv-0"),
             lambda bc: bc.merkle_root("kv"))
    for call in calls:
        with pytest.raises(BlockchainError) as got:
            call(pbc)
        with pytest.raises(RBlockchainError) as want:
            call(rbc)
        assert str(got.value) == str(want.value)
    with pytest.raises(BlockchainError, match="migrate"):
        pbc.get_versioned("kv", b"kv-0", 1)


def test_direct_writes_reopen_and_digest_chain():
    db = MemoryDB()
    bc = create_blockchain(db, version="v1")
    for i in range(6):
        bc.add_block(BlockUpdates().put("kv", b"k%d" % (i % 3), b"v%d" % i)
                     .put("kv", b"only-%d" % i, b"x"))
    assert bc.get_latest("kv", b"k0") == (0, b"v3")   # last write wins
    assert bc.get_block(3).parent_digest == bc.block_digest(2)
    assert bc.state_digest() == bc.block_digest(6)
    bc2 = create_blockchain(db, version="v1")
    assert bc2.last_block_id == 6
    assert bc2.get_latest("kv", b"k1") == (0, b"v4")
    bc2.add_block(BlockUpdates().delete("kv", b"k0"))
    assert bc2.get_latest("kv", b"k0") is None


@pytest.mark.parametrize("seed", SEEDS)
def test_pruning_equals_reference(seed):
    rdb, rbc, pdb, pbc = _pair(testing.ledger_rows(BLOCKS, seed))
    for until in (4, 9):
        assert pbc.delete_blocks_until(until) == \
            rbc.delete_blocks_until(until)
        _assert_same(rdb, rbc, pdb, pbc)


def test_st_staging_and_linking_of_reference_blocks():
    """A reference v1 chain's raw blocks, staged out of order into the
    port's v1 ledger and linked, give the same rows; a tampered block is
    rejected and not adopted."""
    rows = testing.ledger_rows(10, 3)
    rdb, rbc, _, _ = _pair(rows)
    pdb = MemoryDB()
    pbc = create_blockchain(pdb, version="v1")
    for bid in (3, 1, 2):
        pbc.add_raw_st_block(bid, rbc.get_raw_block(bid))
    assert pbc.link_st_chain() == 3
    raw = bytearray(rbc.get_raw_block(4))
    raw[-1] ^= 0x01
    pbc.add_raw_st_block(4, bytes(raw))
    with pytest.raises(Exception):
        pbc.link_st_chain()
    assert pbc.last_block_id == 3
    for bid in range(4, 11):
        pbc.add_raw_st_block(bid, rbc.get_raw_block(bid))
    assert pbc.link_st_chain() == 10
    _assert_same(rdb, rbc, pdb, pbc)


@pytest.mark.parametrize("seed", SEEDS)
def test_kvlog_files_equal_across_packages(tmp_path, seed):
    rows = testing.ledger_rows(BLOCKS, seed)
    paths = {n: str(tmp_path / f"{n}.kvlog") for n in ("port", "ref")}
    rdb, pdb = RNativeDB(paths["ref"]), NativeDB(paths["port"])
    rbc = rcreate(rdb, version="v1")
    pbc = create_blockchain(pdb, version="v1")
    for r in rows:
        rbc.add_block(convert.block_updates(r, RBlockUpdates))
        pbc.add_block(convert.block_updates(r))
    head = rbc.state_digest()
    rdb.close()
    pdb.close()
    with open(paths["port"], "rb") as f, open(paths["ref"], "rb") as g:
        assert f.read() == g.read()
    db = NativeDB(paths["ref"])
    assert create_blockchain(db, version="v1").state_digest() == head
    db.close()
