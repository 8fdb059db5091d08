"""The port's categorized ledger (tpubft_torch/kvbc, storage,
utils/serialize) against the reference (tpubft/kvbc) on the same inputs,
byte for byte: block rows, digests, Merkle roots and every DB row. The
sparse Merkle tree alone is held against the reference in
tests/test_torch_sparse_merkle.py.

Where a test asks for `device_levels`, `_DEVICE_THRESHOLD` is lowered to 8
in both packages, so the Merkle levels of these small ledgers take the
device path: the reference's jitted SHA-256 under JAX on the CPU, the
port's plain PyTorch version on CPU tensors.
"""
import pytest
import torch

from tpubft.kvbc import BlockUpdates as RBlockUpdates
from tpubft.kvbc import KeyValueBlockchain as RKeyValueBlockchain
from tpubft.kvbc import sparse_merkle as RSM
from tpubft.storage.memorydb import MemoryDB as RMemoryDB
from tpubft_torch import convert, device, testing
from tpubft_torch.kvbc import (BLOCK_MERKLE, IMMUTABLE, BlockUpdates,
                               KeyValueBlockchain, create_blockchain)
from tpubft_torch.kvbc import sparse_merkle as SM
from tpubft_torch.ops import _build
from tpubft_torch.ops import sha256 as S
from tpubft_torch.storage import MemoryDB

# one intra-op thread: these tests run many tiny tensor ops, and several
# test workers share the host's cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def on_cpu():
    device.set_default_device("cpu")
    SM.DEGRADED = 0
    yield
    device.set_default_device(None)


@pytest.fixture
def device_levels(monkeypatch):
    """Both packages hash every level of 8+ nodes on their device path;
    the port's on CPU tensors. (Without it these small trees stay below
    the threshold and both hash with hashlib.)"""
    monkeypatch.setattr(RSM, "_DEVICE_THRESHOLD", 8)
    monkeypatch.setattr(SM, "_DEVICE_THRESHOLD", 8)


def _rows(db):
    return list(db.scan_all())


def _proof(p):
    return p.bitmap, p.siblings


def _ledgers(use_device=True):
    rdb, pdb = RMemoryDB(), MemoryDB()
    return (rdb, RKeyValueBlockchain(rdb, use_device_hashing=use_device),
            pdb, KeyValueBlockchain(pdb, use_device_hashing=use_device))


def _assert_same_ledger(rbc, rdb, pbc, pdb):
    assert pbc.last_block_id == rbc.last_block_id
    for b in range(1, rbc.last_block_id + 1):
        assert pbc.get_raw_block(b) == rbc.get_raw_block(b)
        assert pbc.block_digest(b) == rbc.block_digest(b)
        assert pbc.get_block(b).category_digests == \
            rbc.get_block(b).category_digests
    assert pbc.state_digest() == rbc.state_digest()
    assert _rows(pdb) == _rows(rdb)


def test_add_blocks_kvbcbench_equals_reference(device_levels):
    rows = testing.kvbcbench_rows(40)
    rdb, rbc, pdb, pbc = _ledgers()
    assert rbc.add_blocks([convert.block_updates(r, RBlockUpdates)
                           for r in rows]) == 40
    assert pbc.add_blocks([convert.block_updates(r) for r in rows]) == 40
    _assert_same_ledger(rbc, rdb, pbc, pdb)
    assert pbc.merkle_root("proven") == rbc.merkle_root("proven")
    assert SM.DEGRADED == 0


def test_add_blocks_equals_block_by_block():
    rows = testing.kvbcbench_rows(24)
    db_bulk, db_seq = MemoryDB(), MemoryDB()
    bulk = KeyValueBlockchain(db_bulk, use_device_hashing=True)
    seq = KeyValueBlockchain(db_seq, use_device_hashing=True)
    bulk.add_blocks([convert.block_updates(r) for r in rows])
    for r in rows:
        seq.add_block(convert.block_updates(r))
    assert _rows(db_bulk) == _rows(db_seq)


def _mixed_blocks(cls):
    return [
        cls().put("m", b"a", b"1", cat_type=BLOCK_MERKLE)
             .put("ver", b"vk", b"v1")
             .put("imm", b"ik", b"iv", cat_type=IMMUTABLE, tags=["t1"]),
        cls().put("m", b"a", b"2", cat_type=BLOCK_MERKLE)
             .put("m", b"b", b"x", cat_type=BLOCK_MERKLE)
             .put("ver", b"vk", b"v2"),
        cls().delete("m", b"a", cat_type=BLOCK_MERKLE).delete("ver", b"vk"),
    ]


def test_add_block_categories_equal_reference():
    rdb, rbc, pdb, pbc = _ledgers()
    for rb, pb in zip(_mixed_blocks(RBlockUpdates),
                      _mixed_blocks(BlockUpdates)):
        assert pbc.add_block(pb) == rbc.add_block(rb)
    _assert_same_ledger(rbc, rdb, pbc, pdb)
    for blk in (1, 2, 3):
        assert _proof(pbc.prove_at("m", b"a", blk)) == \
            _proof(rbc.prove_at("m", b"a", blk))
    assert pbc.get_versioned("ver", b"vk", 2) == b"v2"
    assert pbc.delete_blocks_until(3) == rbc.delete_blocks_until(3)
    assert _rows(pdb) == _rows(rdb)


def test_accumulated_run_equals_reference():
    rdb, rbc, pdb, pbc = _ledgers()
    for bc, cls in ((rbc, RBlockUpdates), (pbc, BlockUpdates)):
        bc.begin_accumulation()
        for bu in _mixed_blocks(cls):
            bc.add_block(bu)
        assert bc.end_accumulation() == 3
    _assert_same_ledger(rbc, rdb, pbc, pdb)


def test_raising_kernel_is_counted_and_roots_still_equal(monkeypatch,
                                                        device_levels):
    def boom(*_a, **_k):
        raise RuntimeError("device lost")
    monkeypatch.setattr(S, "sha256_batch", boom)
    rows = testing.kvbcbench_rows(12)
    rdb, rbc, pdb, pbc = _ledgers()
    rbc.add_blocks([convert.block_updates(r, RBlockUpdates) for r in rows])
    pbc.add_blocks([convert.block_updates(r) for r in rows])
    _assert_same_ledger(rbc, rdb, pbc, pdb)
    assert SM.DEGRADED == SM.DEPTH       # every level reached the device


@pytest.mark.parametrize("fault", [ValueError("words must be int32"),
                                   _build.BuildError("nvcc failed")])
def test_program_faults_raise_instead_of_degrading(monkeypatch,
                                                   device_levels, fault):
    """Only device loss (a RuntimeError) degrades to hashlib; a wrapper
    refusing its inputs or a kernel that does not build raises."""
    def boom(*_a, **_k):
        raise fault
    monkeypatch.setattr(S, "sha256_batch", boom)
    pbc = create_blockchain(MemoryDB(), use_device_hashing=True)
    with pytest.raises(type(fault)):
        pbc.add_blocks([convert.block_updates(r)
                        for r in testing.kvbcbench_rows(12)])
    assert SM.DEGRADED == 0


def test_migrate_windows_stay_below_the_device_threshold(monkeypatch):
    """Bulk ingest as the reference's migrate_v4 does it, add_blocks in
    chunks of 64: at the kvbcbench shape no Merkle level holds the 192
    nodes that send it to the device, and the ledger equals the
    reference's built the same way and the port's built in one call."""
    def boom(*_a, **_k):
        raise AssertionError("a level of a 64-block window reached the "
                             "device")
    rows = testing.kvbcbench_rows(80)
    rdb, rbc, pdb, pbc = _ledgers()
    for i in range(0, len(rows), 64):
        rbc.add_blocks([convert.block_updates(r, RBlockUpdates)
                        for r in rows[i:i + 64]])
        with monkeypatch.context() as m:
            m.setattr(S, "sha256_batch", boom)
            pbc.add_blocks([convert.block_updates(r)
                            for r in rows[i:i + 64]])
    _assert_same_ledger(rbc, rdb, pbc, pdb)
    one_db = MemoryDB()
    KeyValueBlockchain(one_db, use_device_hashing=False).add_blocks(
        [convert.block_updates(r) for r in rows])
    assert _rows(one_db) == _rows(pdb)
    assert SM.DEGRADED == 0


def test_host_hashing_never_reaches_the_device(monkeypatch,
                                              device_levels):
    def boom(*_a, **_k):
        raise AssertionError("use_device_hashing=False reached the device")
    monkeypatch.setattr(S, "sha256_batch", boom)
    pbc = create_blockchain(MemoryDB(), use_device_hashing=False)
    pbc.add_blocks([convert.block_updates(r)
                    for r in testing.kvbcbench_rows(12)])
    assert SM.DEGRADED == 0


def test_carried_ledger_continues_identically():
    """A reference ledger's DB rows carried into the port's MemoryDB: the
    port's engine reopens it and appends the same bytes the reference
    does."""
    rows = testing.kvbcbench_rows(30)
    rdb = RMemoryDB()
    rbc = RKeyValueBlockchain(rdb, use_device_hashing=True)
    rbc.add_blocks([convert.block_updates(r, RBlockUpdates)
                    for r in rows[:15]])
    pdb = convert.memorydb_from_rows(rdb.scan_all())
    pbc = KeyValueBlockchain(pdb, use_device_hashing=True)
    assert pbc.last_block_id == 15
    rbc.add_blocks([convert.block_updates(r, RBlockUpdates)
                    for r in rows[15:]])
    pbc.add_blocks([convert.block_updates(r) for r in rows[15:]])
    _assert_same_ledger(rbc, rdb, pbc, pdb)


def test_st_linking_of_reference_blocks():
    """Raw blocks of the reference ledger, staged out of order into the
    port's ledger and linked, rebuild the same state."""
    rows = testing.kvbcbench_rows(10)
    rdb, rbc, pdb, pbc = _ledgers()
    rbc.add_blocks([convert.block_updates(r, RBlockUpdates) for r in rows])
    for bid in (4, 2, 3):
        pbc.add_raw_st_block(bid, rbc.get_raw_block(bid))
    assert pbc.link_st_chain() == 0
    for bid in (1, 5, 6, 7, 8, 9, 10):
        pbc.add_raw_st_block(bid, rbc.get_raw_block(bid))
    assert pbc.link_st_chain() == 10
    _assert_same_ledger(rbc, rdb, pbc, pdb)


@pytest.mark.parametrize("version", ["categorized", "v2"])
def test_create_blockchain_categorized(version):
    assert isinstance(create_blockchain(MemoryDB(), version=version),
                      KeyValueBlockchain)


@pytest.mark.parametrize("version", ["v4", "v1", "direct"])
def test_create_blockchain_selects_the_other_engines(version):
    from tpubft_torch.kvbc.v1 import DirectKVBlockchain
    from tpubft_torch.kvbc.v4 import V4KeyValueBlockchain
    want = V4KeyValueBlockchain if version == "v4" else DirectKVBlockchain
    assert type(create_blockchain(MemoryDB(), version=version)) is want


def test_create_blockchain_unknown_engine():
    with pytest.raises(ValueError):
        create_blockchain(MemoryDB(), version="v9")
