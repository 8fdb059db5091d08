"""The port's storage layer (tpubft_torch/storage: NativeDB over the
port's own native/kvlog.cpp, the metadata store) against the reference's
(tpubft/storage) on the same inputs, byte for byte: the counterparts of
tests/test_storage.py, the ledger's and the range validation tree's
persistence across a reopen (tests/test_kvbc.py:270,
tests/test_state_transfer.py:45), kvlog files written by the two
packages from the same seeded batches (also after compaction and
checkpoint), each package opening the other's files, and torn tails
recovering the same prefix in both."""
import hashlib
import os
import threading

import numpy as np
import pytest

from tpubft.kvbc import BlockUpdates as RBlockUpdates
from tpubft.kvbc import KeyValueBlockchain as RKeyValueBlockchain
from tpubft.storage import WriteBatch as RWriteBatch
from tpubft.storage.native import NativeDB as RNativeDB
from tpubft_torch import convert, testing
from tpubft_torch.kvbc import BLOCK_MERKLE, BlockUpdates, KeyValueBlockchain
from tpubft_torch.kvbc.replica import open_db
from tpubft_torch.ops import _build
from tpubft_torch.statetransfer import RangeValidationTree
from tpubft_torch.storage import MemoryDB, StorageError, WriteBatch
from tpubft_torch.storage import native as port_native
from tpubft_torch.storage.interfaces import (family_upper_bound, fkey,
                                             split_fkey)
from tpubft_torch.storage.metadata import (CONSENSUS_META_FAMILIES,
                                           DBPersistentStorage,
                                           MetadataStorage)
from tpubft_torch.storage.native import NativeDB

# ---------------- the counterparts of tests/test_storage.py ----------------


def test_fkey_roundtrip_and_bounds():
    assert split_fkey(fkey(b"fam", b"key")) == (b"fam", b"key")
    ub = family_upper_bound(b"fam")
    assert fkey(b"fam", b"\xff" * 50) < ub
    assert fkey(b"famz", b"") > ub  # sibling family sorts outside
    assert family_upper_bound(b"\xff" * 255) is None


@pytest.mark.parametrize("kind", ["memory", "native"])
def test_basic_ops(tmp_path, kind):
    db = (MemoryDB() if kind == "memory"
          else NativeDB(str(tmp_path / "db.kvlog")))
    assert db.get(b"a") is None
    db.put(b"a", b"1")
    db.put(b"b", b"2", family=b"other")
    assert db.get(b"a") == b"1"
    assert db.get(b"a", family=b"other") is None
    assert db.get(b"b", family=b"other") == b"2"
    db.delete(b"a")
    assert db.get(b"a") is None
    assert db.multi_get([b"b", b"c"], family=b"other") == [b"2", None]
    db.close()


@pytest.mark.parametrize("kind", ["memory", "native"])
def test_range_iter_ordered(tmp_path, kind):
    db = (MemoryDB() if kind == "memory"
          else NativeDB(str(tmp_path / "db.kvlog")))
    batch = WriteBatch()
    for i in [5, 1, 9, 3, 7]:
        batch.put(bytes([i]), str(i).encode())
    batch.put(b"zzz", b"x", family=b"other")
    db.write(batch)
    assert [k for k, _ in db.range_iter()] == [bytes([i])
                                               for i in [1, 3, 5, 7, 9]]
    assert [k for k, _ in db.range_iter(start=bytes([3]), end=bytes([8]))] \
        == [bytes([3]), bytes([5]), bytes([7])]
    assert db.last_in_range() == (bytes([9]), b"9")
    db.close()


def test_batch_atomicity_overwrite(tmp_path):
    db = NativeDB(str(tmp_path / "db.kvlog"))
    db.write(WriteBatch().put(b"k", b"v1").put(b"k", b"v2").delete(b"gone")
             .put(b"x", b"y"))
    assert db.get(b"k") == b"v2"
    assert db.get(b"x") == b"y"
    db.close()


def test_native_persistence_and_recovery(tmp_path):
    path = str(tmp_path / "db.kvlog")
    db = NativeDB(path)
    for i in range(100):
        db.put(f"key-{i:03d}".encode(), f"val-{i}".encode())
    db.close()

    db = NativeDB(path)
    assert db.count() == 100
    assert db.get(b"key-050") == b"val-50"

    # Torn tail: append garbage — recovery must stop at last good record.
    db.close()
    with open(path, "ab") as fh:
        fh.write(b"\x47\x4c\x56\x4btorn-partial-record")
    db = NativeDB(path)
    assert db.count() == 100
    db.put(b"after-recovery", b"ok")  # appends cleanly after truncation
    db.close()
    db = NativeDB(path)
    assert db.get(b"after-recovery") == b"ok"
    db.close()


def test_native_sync_families_carveout(tmp_path, monkeypatch):
    """sync_writes=False + sync_families: batches touching a carved-out
    family (consensus metadata) fsync, everything else stays unsynced —
    and all data is durable across a clean close/reopen either way. The
    engine's kvlog_sync calls are counted to show which batches synced."""
    path = str(tmp_path / "db.kvlog")
    db = NativeDB(path, sync_writes=False,
                  sync_families=(b"metadata", b"metaseq"))
    syncs = []
    real = db._lib

    class Counting:
        def __getattr__(self, name):
            return getattr(real, name)

        def kvlog_sync(self, h):
            syncs.append(h)
            return real.kvlog_sync(h)
    monkeypatch.setattr(db, "_lib", Counting())
    # metadata batch -> hits the kvlog_sync path
    db.write(WriteBatch().put(b"\x00\x00\x00\x02", b"desc", b"metadata"))
    db.write(WriteBatch().put((5).to_bytes(8, "big"), b"row", b"metaseq"))
    assert len(syncs) == 2
    # block-data batch -> no sync
    db.write(WriteBatch().put(b"blk1", b"payload", b"blk.blocks"))
    # a family whose name merely PREFIXES a sync family must not match
    # (prefix check runs on the length-prefixed physical key)
    db.write(WriteBatch().put(b"x", b"y", b"meta"))
    assert len(syncs) == 2
    db.close()
    db = NativeDB(path)
    assert db.get(b"\x00\x00\x00\x02", b"metadata") == b"desc"
    assert db.get((5).to_bytes(8, "big"), b"metaseq") == b"row"
    assert db.get(b"blk1", b"blk.blocks") == b"payload"
    assert db.get(b"x", b"meta") == b"y"
    db.close()
    # sync_writes=True ignores the carve-out (everything already syncs)
    db = NativeDB(path, sync_writes=True, sync_families=(b"metadata",))
    assert db._sync_prefixes == ()
    assert db.syncs_on_write
    db.close()


def test_native_compaction(tmp_path):
    path = str(tmp_path / "db.kvlog")
    db = NativeDB(path, sync_writes=False)
    for i in range(200):
        db.put(b"hot", f"v{i}".encode())
    size_before = os.path.getsize(path)
    db.compact()
    assert os.path.getsize(path) < size_before
    assert db.get(b"hot") == b"v199"
    db.close()
    db = NativeDB(path)
    assert db.get(b"hot") == b"v199"
    db.close()


def test_metadata_storage_transactions(tmp_path):
    db = NativeDB(str(tmp_path / "meta.kvlog"))
    ms = MetadataStorage(db)
    ms.write(1, b"one")
    assert ms.read(1) == b"one"
    ms.begin_atomic_write()
    ms.write(1, b"uno")
    ms.write(2, b"dos")
    assert ms.read(1) == b"uno"      # read-your-writes inside tran
    assert db.get((2).to_bytes(4, "big"), b"metadata") is None  # not yet
    ms.commit_atomic_write()
    assert ms.read(2) == b"dos"
    db.close()


def test_db_persistent_storage_roundtrip(tmp_path):
    db = NativeDB(str(tmp_path / "ps.kvlog"))
    ps = DBPersistentStorage(db)
    st = ps.begin_write_tran()
    st.last_view = 3
    st.last_executed_seq = 17
    st.seq(17).pre_prepare = b"\x01\x02"
    ps.end_write_tran()
    db.close()

    db = NativeDB(str(tmp_path / "ps.kvlog"))
    ps2 = DBPersistentStorage(db)
    st2 = ps2.load()
    assert st2.last_view == 3
    assert st2.last_executed_seq == 17
    assert st2.seq_states[17].pre_prepare == b"\x01\x02"
    db.close()


def test_db_persistent_storage_incremental(tmp_path):
    """Dirty/deleted seq tracking: window slide prunes rows from the DB,
    VC blobs and descriptors round-trip, and mutations via seq() on a
    pre-existing entry persist."""
    path = str(tmp_path / "ps.kvlog")
    db = NativeDB(path)
    ps = DBPersistentStorage(db)
    st = ps.begin_write_tran()
    for s in range(1, 6):
        st.seq(s).pre_prepare = b"pp%d" % s
    st.restrictions = [b"r1", b"r2"]
    st.carried_certs = [b"c1"]
    st.carried_bodies = [b"b1"]
    ps.end_write_tran()
    # second tran: mutate one entry, slide the window past seq 3
    st = ps.begin_write_tran()
    st.seq(4).commit_full = b"cf4"
    st.last_stable_seq = 3
    for s in [s for s in st.seq_states if s <= 3]:
        del st.seq_states[s]
    ps.end_write_tran()
    db.close()

    db = NativeDB(path)
    st2 = DBPersistentStorage(db).load()
    assert sorted(st2.seq_states) == [4, 5]
    assert st2.seq_states[4].pre_prepare == b"pp4"
    assert st2.seq_states[4].commit_full == b"cf4"
    assert st2.last_stable_seq == 3
    assert st2.restrictions == [b"r1", b"r2"]
    assert st2.carried_certs == [b"c1"]
    assert st2.carried_bodies == [b"b1"]
    # pruned rows are gone from the seq family on disk
    assert db.get((1).to_bytes(8, "big"), b"metaseq") is None
    db.close()


def test_db_persistent_storage_fresh_db_seq_only_commit(tmp_path):
    """A fresh DB whose first commits touch only seq rows (descriptor
    scalars still at defaults — the normal prepare-before-execute order)
    must still recover those rows: the desc row is the layout marker and
    has to ride any first write."""
    path = str(tmp_path / "ps.kvlog")
    db = NativeDB(path)
    ps = DBPersistentStorage(db)
    st = ps.begin_write_tran()
    st.seq(5).pre_prepare = b"\x05"
    ps.end_write_tran()
    db.close()
    db = NativeDB(path)
    st2 = DBPersistentStorage(db).load()
    assert st2.seq_states[5].pre_prepare == b"\x05"
    db.close()


def test_db_persistent_storage_legacy_json_migration(tmp_path):
    """A DB written by the old whole-state-JSON layout loads correctly."""
    import json as _json

    from tpubft_torch.consensus.persistent import (FilePersistentStorage,
                                                   PersistedState)
    path = str(tmp_path / "ps.kvlog")
    db = NativeDB(path)
    legacy = PersistedState(last_view=2, last_executed_seq=9,
                            last_stable_seq=0)
    legacy.seq(9).pre_prepare = b"\xaa"
    raw = _json.dumps(FilePersistentStorage._encode(legacy),
                      separators=(",", ":")).encode()
    db.put((1).to_bytes(4, "big"), raw, b"metadata")
    ps = DBPersistentStorage(db)
    st = ps.load()
    assert st.last_view == 2 and st.last_executed_seq == 9
    assert st.seq_states[9].pre_prepare == b"\xaa"
    # and the next commit writes the new layout
    st = ps.begin_write_tran()
    st.seq(9).commit_full = b"\xbb"
    ps.end_write_tran()
    db.close()
    db = NativeDB(path)
    st2 = DBPersistentStorage(db).load()
    assert st2.seq_states[9].commit_full == b"\xbb"
    db.close()


# ---------------- ledger and RVT persistence over the port ----------------


def test_persistence_across_reopen(tmp_path):
    """tests/test_kvbc.py:270 over the port's ledger and NativeDB."""
    path = str(tmp_path / "bc.kvlog")
    db = NativeDB(path)
    bc = KeyValueBlockchain(db, use_device_hashing=False)
    bc.add_block(BlockUpdates().put("m", b"a", b"1", cat_type=BLOCK_MERKLE))
    bc.add_block(BlockUpdates().put("ver", b"b", b"2"))
    head = bc.state_digest()
    db.close()

    db = NativeDB(path)
    bc2 = KeyValueBlockchain(db, use_device_hashing=False)
    assert bc2.last_block_id == 2
    assert bc2.state_digest() == head
    assert bc2.get_latest("m", b"a", BLOCK_MERKLE) == (1, b"1")
    bc2.add_block(BlockUpdates().put("ver", b"b", b"3"))
    assert bc2.get_latest("ver", b"b") == (3, b"3")
    db.close()


def test_rvt_persistence(tmp_path):
    """tests/test_state_transfer.py:45 over the port's RVT and NativeDB."""
    db = NativeDB(str(tmp_path / "rvt.kvlog"))
    t = RangeValidationTree(db)
    for i in range(20):
        t.append(hashlib.sha256(str(i).encode()).digest())
    root = t.root()
    db.close()
    db = NativeDB(str(tmp_path / "rvt.kvlog"))
    t2 = RangeValidationTree(db)
    assert t2.n_leaves == 20 and t2.root() == root
    db.close()


# ---------------- the two packages' files, byte for byte ----------------

FAMILIES = (b"", b"metadata", b"metaseq", b"blk.blocks", b"meta")


def _seeded_batches(seed, n=40):
    """n batches of puts and deletes over a few families, drawn from
    `seed`: keys from a small space (so later batches overwrite and
    delete earlier keys), values of 0-300 bytes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ops = []
        for _ in range(int(rng.integers(1, 9))):
            fam = FAMILIES[int(rng.integers(0, len(FAMILIES)))]
            key = b"k%d" % int(rng.integers(0, 60))
            if rng.random() < 0.2:
                ops.append((fam, key, None))
            else:
                val = rng.integers(0, 256, int(rng.integers(0, 300)),
                                   dtype=np.uint8).tobytes()
                ops.append((fam, key, val))
        out.append(ops)
    return out


def _batch(cls, ops):
    b = cls()
    for fam, key, val in ops:
        if val is None:
            b.delete(key, family=fam)
        else:
            b.put(key, val, family=fam)
    return b


def _apply(db, wb_cls, batches, group_every=0):
    """Each batch through write(); with group_every > 0, every group of
    that many batches through one write_group."""
    if not group_every:
        for ops in batches:
            db.write(_batch(wb_cls, ops))
        return
    for i in range(0, len(batches), group_every):
        db.write_group([_batch(wb_cls, ops)
                        for ops in batches[i:i + group_every]])


def _read(path):
    with open(path, "rb") as f:
        return f.read()


PACKAGES = {"port": (NativeDB, WriteBatch), "ref": (RNativeDB, RWriteBatch)}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("group_every", [0, 5])
def test_kvlog_files_equal_across_packages(tmp_path, seed, group_every):
    """The same seeded batches through the reference's NativeDB and the
    port's give byte-identical kvlog files: as written (one record a
    batch, or one a write_group), after compact() and after
    checkpoint_to(); the live sets scan equal."""
    batches = _seeded_batches(seed)
    paths = {}
    for name, (cls, wb) in PACKAGES.items():
        path = paths[name] = str(tmp_path / f"{name}.kvlog")
        db = cls(path, sync_writes=False,
                 sync_families=CONSENSUS_META_FAMILIES)
        _apply(db, wb, batches, group_every)
        db.checkpoint_to(str(tmp_path / f"{name}.ckpt"))
        db.close()
    assert _read(paths["port"]) == _read(paths["ref"])
    assert len(_read(paths["port"])) > 0
    assert _read(str(tmp_path / "port.ckpt")) == \
        _read(str(tmp_path / "ref.ckpt"))
    for name, (cls, _) in PACKAGES.items():
        db = cls(paths[name])
        db.compact()
        db.close()
    assert _read(paths["port"]) == _read(paths["ref"])
    # a compacted log and a checkpoint are the same single record
    assert _read(paths["port"]) == _read(str(tmp_path / "port.ckpt"))


def test_compaction_past_compact_bytes_equal_across_packages(tmp_path):
    """write() compacts on its own once the log passes compact_bytes; the
    two packages compact at the same batch and leave equal files."""
    batches = _seeded_batches(7, n=60)
    paths = {}
    for name, (cls, wb) in PACKAGES.items():
        path = paths[name] = str(tmp_path / f"{name}.kvlog")
        db = cls(path, sync_writes=False, compact_bytes=4096)
        sizes = []
        for ops in batches:
            db.write(_batch(wb, ops))
            sizes.append(os.path.getsize(path))
        db.close()
        paths[name + "_sizes"] = sizes
    assert paths["port_sizes"] == paths["ref_sizes"]
    assert any(b < a for a, b in zip(paths["port_sizes"],
                                     paths["port_sizes"][1:]))
    assert _read(paths["port"]) == _read(paths["ref"])


@pytest.mark.parametrize("writer, reader", [("ref", "port"),
                                            ("port", "ref")])
def test_each_package_opens_the_others_file(tmp_path, writer, reader):
    """A file written by either package opens in the other with equal
    scan_all, equal reads and equal ranges, and takes further writes."""
    path = str(tmp_path / "x.kvlog")
    wcls, wwb = PACKAGES[writer]
    db = wcls(path)
    _apply(db, wwb, _seeded_batches(3), group_every=4)
    want = list(db.scan_all())
    want_range = list(db.range_iter(family=b"metaseq"))
    db.close()
    rcls, rwb = PACKAGES[reader]
    db = rcls(path)
    assert list(db.scan_all()) == want
    assert list(db.range_iter(family=b"metaseq")) == want_range
    assert db.count() == len(want)
    for fam, key, val in want[:10]:
        assert db.get(key, fam) == val
    db.write(rwb().put(b"more", b"data", family=b"meta"))
    db.close()
    db = wcls(path)
    expect = {(f, k): v for f, k, v in want}
    expect[(b"meta", b"more")] = b"data"
    assert {(f, k): v for f, k, v in db.scan_all()} == expect
    assert db.count() == len(expect)
    db.close()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_torn_tail_recovers_the_same_prefix(tmp_path, seed):
    """A log cut at seeded offsets inside its last records (and with
    seeded garbage after them) recovers the same prefix of batches in
    both packages: equal scans, equal truncated files, and the scan of
    the batches whose records survived whole."""
    batches = _seeded_batches(10 + seed, n=12)
    path = str(tmp_path / "full.kvlog")
    db = NativeDB(path, sync_writes=False)
    ends = []
    for ops in batches:
        db.write(_batch(WriteBatch, ops))
        ends.append(os.path.getsize(path))
    db.close()
    full = _read(path)
    rng = np.random.default_rng(seed)
    cuts = sorted({int(rng.integers(ends[-4], len(full))) for _ in range(4)})
    for cut in cuts + [ends[-2] + 5]:
        torn = full[:cut] + rng.integers(
            0, 256, int(rng.integers(0, 20)), dtype=np.uint8).tobytes()
        whole = sum(1 for e in ends if e <= cut)
        mem = MemoryDB()
        _apply(mem, WriteBatch, batches[:whole])
        got = {}
        for name, (cls, _) in PACKAGES.items():
            p = str(tmp_path / f"{name}-{cut}.kvlog")
            with open(p, "wb") as f:
                f.write(torn)
            db = cls(p)
            got[name] = list(db.scan_all())
            db.close()
            got[name + "_file"] = _read(p)
        assert got["port"] == got["ref"] == list(mem.scan_all()), cut
        assert got["port_file"] == got["ref_file"] == full[:ends[whole - 1]]


def test_kvbcbench_ledger_files_equal_across_packages(tmp_path):
    """The categorized ledger of 40 kvbcbench blocks over each package's
    NativeDB, with the reference's consensus-metadata carve-out, gives
    byte-identical kvlog files, and the reference's opens under the
    port's blockchain at the same head and state digest."""
    rows = testing.kvbcbench_rows(40)
    paths = {n: str(tmp_path / f"{n}.kvlog") for n in ("port", "ref")}
    rdb = RNativeDB(paths["ref"], sync_writes=False,
                    sync_families=CONSENSUS_META_FAMILIES)
    rbc = RKeyValueBlockchain(rdb, use_device_hashing=False)
    rbc.add_blocks([convert.block_updates(r, RBlockUpdates) for r in rows])
    head = rbc.state_digest()
    rdb.close()
    pdb = NativeDB(paths["port"], sync_writes=False,
                   sync_families=CONSENSUS_META_FAMILIES)
    pbc = KeyValueBlockchain(pdb, use_device_hashing=False)
    pbc.add_blocks([convert.block_updates(r) for r in rows])
    pdb.close()
    assert _read(paths["port"]) == _read(paths["ref"])
    db = NativeDB(paths["ref"])
    bc = KeyValueBlockchain(db, use_device_hashing=False)
    assert bc.last_block_id == 40 and bc.state_digest() == head
    db.close()


# ---------------- the engine's seams ----------------


def test_open_db_gives_the_native_engine_and_never_memory(tmp_path):
    """open_db(path) makes the directory and opens a NativeDB with the
    carve-out; open_db(None) is the in-memory store."""
    path = str(tmp_path / "sub" / "dir" / "r.kvlog")
    db = open_db(path, sync_writes=False,
                 sync_families=CONSENSUS_META_FAMILIES)
    assert type(db) is NativeDB and os.path.exists(path)
    assert not db.syncs_on_write and db._sync_prefixes
    db.close()
    assert type(open_db(None)) is MemoryDB


def test_failed_build_or_open_raises(tmp_path, monkeypatch):
    """A kvlog build that fails raises out of open_db (no MemoryDB in its
    place), and so does a path the engine cannot open."""
    def broken(name):
        raise _build.BuildError(f"g++ failed building {name}")
    monkeypatch.setattr(port_native, "load_host", broken)
    with pytest.raises(_build.BuildError):
        open_db(str(tmp_path / "r.kvlog"))
    monkeypatch.undo()
    os.makedirs(tmp_path / "adir.kvlog")
    with pytest.raises(StorageError, match="kvlog_open"):
        open_db(str(tmp_path / "adir.kvlog"))


def test_engine_loads_from_the_ports_build_dir():
    lib = port_native._lib()
    assert os.path.dirname(os.path.abspath(lib._name)) == \
        os.path.abspath(_build.BUILD_DIR)
    assert os.path.basename(lib._name).startswith("libkvlog-")


def test_closed_handle_raises_and_close_twice_is_safe(tmp_path):
    db = NativeDB(str(tmp_path / "c.kvlog"))
    db.put(b"a", b"1")
    db.close()
    db.close()
    for call in (lambda: db.get(b"a"), lambda: db.put(b"b", b"2"),
                 lambda: list(db.range_iter()), lambda: db.sync(),
                 lambda: db.count(), lambda: db.compact()):
        with pytest.raises(StorageError, match="closed"):
            call()


def test_handle_lock_serialises_concurrent_readers_and_writers(tmp_path):
    """Writers (write and write_group), point readers and scanners on one
    handle from several threads, as the execution lane and the
    dispatcher share it: no error, every key's last value reads back,
    and the file reopens to the same live set."""
    path = str(tmp_path / "cc.kvlog")
    db = NativeDB(path, sync_writes=False, compact_bytes=1 << 14,
                  sync_families=CONSENSUS_META_FAMILIES)
    errors = []

    def writer(t):
        try:
            for i in range(150):
                b = WriteBatch().put(b"t%d-%03d" % (t, i), b"v%d" % i)
                if i % 3:
                    db.write(b)
                else:
                    db.write_group([b, WriteBatch().put(
                        b"m%d" % t, b"%d" % i, family=b"metaseq")])
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    def reader():
        try:
            for _ in range(200):
                db.get(b"t0-000")
                list(db.range_iter(start=b"t1", end=b"t2"))
                db.count()
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)
    threads = ([threading.Thread(target=writer, args=(t,)) for t in range(3)]
               + [threading.Thread(target=reader) for _ in range(2)])
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors[:3]
    assert db.get(b"t2-149") == b"v149"
    want = list(db.scan_all())
    assert len(want) == 3 * 150 + 3
    db.close()
    db = NativeDB(path)
    assert list(db.scan_all()) == want
    db.close()
