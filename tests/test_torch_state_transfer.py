"""The port's state transfer (tpubft_torch/statetransfer/) and consensus
metadata store (tpubft_torch/storage/metadata.py) against the reference.

RVT roots, proofs and tampering verdicts, every ST message's wire bytes
and the metadata store's rows are compared with the reference's on
seeded inputs. The manager is driven over a synchronous in-test network
(honest, lying, stalling and reordering sources) and its whole message
transcript is compared with the reference manager's. A lagging port
replica catches up by state transfer to the reference cluster's block
digests. The window digests go through `statetransfer/digests`
(`window_digests`): the seam tests show that a window of 16 blocks or
more reaches it with `use_device=True` when the backend is "cuda", that
a RuntimeError of the device call fails the window (raised, counted,
the range re-queued with no charge to its source, nothing hashed on the
host), and that a missing card raises.
"""
import copy
import hashlib
import importlib
import time

import numpy as np
import pytest
import torch

from tpubft_torch import device
from tpubft_torch.apps import skvbc
from tpubft_torch.kvbc import KeyValueBlockchain
from tpubft_torch.statetransfer import (RangeValidationTree,
                                        StateTransferManager, digests)
from tpubft_torch.statetransfer import messages as stm
from tpubft_torch.statetransfer.manager import StConfig
from tpubft_torch.storage import MemoryDB
from tpubft_torch.utils.config import ReplicaConfig

# one intra-op thread: the plain versions run many tiny tensor ops, and
# several test workers share the host's cores
torch.set_num_threads(1)

BASE = dict(autotune_enabled=False, crypto_backend="cpu")
SEED = b"torch-state-transfer"


@pytest.fixture(autouse=True)
def _cpu():
    device.set_default_device("cpu")
    yield
    device.set_default_device(None)


def _pkg(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# ---------------- RVT ----------------

def _rvt(pkg, n):
    mem = _pkg(pkg, "storage.memorydb").MemoryDB()
    t = _pkg(pkg, "statetransfer.rvt").RangeValidationTree(mem)
    leaves = [hashlib.sha256(str(i).encode()).digest() for i in range(n)]
    roots = []
    for lh in leaves:
        t.append(lh)
        roots.append(t.root())
    return t, leaves, roots, mem


def test_rvt_roots_proofs_and_tampering_match_the_reference():
    port, leaves, roots, _ = _rvt("tpubft_torch", 130)
    ref, _, ref_roots, _ = _rvt("tpubft", 130)
    assert roots == ref_roots
    bad = hashlib.sha256(b"bad").digest()
    verify = RangeValidationTree.verify
    ref_verify = type(ref).verify
    for n in [1, 2, 3, 5, 8, 13, 64, 100, 127, 128, 130]:
        root = port.root(n)
        assert root == roots[n - 1] == ref.root(n)
        for i in sorted({x for x in (0, 1, n // 2, n - 1) if x < n}):
            p, rp = port.prove(i, n), ref.prove(i, n)
            assert (p.path, p.peaks) == (rp.path, rp.peaks)
            cases = [(leaves[i], p), (bad, p)]
            if p.path:
                p2 = copy.deepcopy(p)
                p2.path[0] = bad
                cases.append((leaves[i], p2))
            p3 = copy.deepcopy(p)
            p3.peaks.append(bad)
            cases.append((leaves[i], p3))
            got = [verify(root, i, n, leaf, q) for leaf, q in cases]
            want = [ref_verify(root, i, n, leaf, copy.deepcopy(q))
                    for leaf, q in cases]
            assert got == want and got[0] and not any(got[1:])


def test_rvt_persists_the_reference_rows_and_reloads():
    port, _, roots, mem = _rvt("tpubft_torch", 20)
    _, _, _, ref_mem = _rvt("tpubft", 20)
    assert sorted(mem.scan_all()) == sorted(ref_mem.scan_all())
    again = RangeValidationTree(mem)
    assert again.n_leaves == 20 and again.root() == roots[-1]


# ---------------- wire messages ----------------

def _st_messages(mod, rng):
    def b(n):
        return rng.bytes(n)
    proof = mod.RvtProof(path=[b(32) for _ in range(3)], peaks=[b(32)])
    return [
        mod.AskForCheckpointSummaries(msg_id=5, min_checkpoint_seq=10),
        mod.CheckpointSummary(reply_to=5, checkpoint_seq=150,
                              state_digest=b(32), last_block=7,
                              rvt_root=b(32), res_pages_digest=b(32)),
        mod.FetchBlocks(msg_id=6, from_block=1, to_block=16,
                        target_last_block=300),
        mod.ItemData(reply_to=6, block_id=3, chunk_idx=1, total_chunks=2,
                     payload=b(1000), proof=proof, last_in_response=True),
        mod.RejectFetching(reply_to=6, reason="pruned"),
        mod.FetchResPages(msg_id=8),
        mod.ResPagesData(reply_to=8, chunk_idx=0, total_chunks=1,
                         pages=[(b(14), b(100)), (b(20), b(4096))]),
    ]


def test_st_messages_pack_to_the_reference_bytes():
    from tpubft.statetransfer import messages as ref_stm
    port = _st_messages(stm, np.random.default_rng(3))
    ref = _st_messages(ref_stm, np.random.default_rng(3))
    assert len(port) == len(stm._TYPES) == len(ref_stm._TYPES)
    for p, r in zip(port, ref):
        wire = stm.pack(p)
        assert wire == ref_stm.pack(r)
        assert stm.unpack(wire) == p
        assert ref_stm.unpack(wire) == r


def test_st_message_rejects_garbage():
    from tpubft_torch.utils.serialize import SerializeError
    with pytest.raises(SerializeError):
        stm.unpack(b"\xee\x00")


# ---------------- consensus metadata store ----------------

def _metadata_rows(pkg):
    meta = _pkg(pkg, "storage.metadata")
    mem = _pkg(pkg, "storage.memorydb")
    objects = mem.MemoryDB()
    ms = meta.MetadataStorage(objects)
    ms.write(1, b"one")
    ms.begin_atomic_write()
    ms.write(1, b"uno")
    ms.write(2, b"dos")
    inside = (ms.read(1), objects.get((2).to_bytes(4, "big"), b"metadata"))
    ms.commit_atomic_write()
    db = mem.MemoryDB()
    ps = meta.DBPersistentStorage(db)
    st = ps.begin_write_tran()
    st.last_view = 3
    st.last_executed_seq = 17
    for s in range(1, 6):
        st.seq(s).pre_prepare = b"pp%d" % s
    st.seq(17).pre_prepare = b"\x01\x02"
    st.restrictions = [b"r1", b"r2"]
    st.carried_certs = [b"c1"]
    st.carried_bodies = [b"b1"]
    ps.end_write_tran()
    st = ps.begin_write_tran()
    st.seq(4).commit_full = b"cf4"
    st.last_stable_seq = 3
    st.pending_view = 4
    st.in_view_change = True
    for s in [s for s in st.seq_states if s <= 3]:
        del st.seq_states[s]
    ps.end_write_tran()
    return db, inside, sorted(objects.scan_all()) + sorted(db.scan_all()), \
        meta.CONSENSUS_META_FAMILIES


def test_db_persistent_storage_stores_the_reference_bytes():
    db, inside, rows, fams = _metadata_rows("tpubft_torch")
    _, ref_inside, ref_rows, ref_fams = _metadata_rows("tpubft")
    assert inside == ref_inside == (b"uno", None)
    assert rows == ref_rows and fams == ref_fams
    from tpubft_torch.storage.metadata import DBPersistentStorage
    st = DBPersistentStorage(db).load()
    assert sorted(st.seq_states) == [4, 5, 17]
    assert st.seq_states[4].commit_full == b"cf4"
    assert (st.last_view, st.last_executed_seq, st.last_stable_seq,
            st.pending_view, st.in_view_change) == (3, 17, 3, 4, True)
    assert st.restrictions == [b"r1", b"r2"]


def test_db_persistent_storage_reads_the_legacy_layout_through_the_port():
    """The legacy whole-state JSON row loads through the port's own
    FilePersistentStorage decoder."""
    import json

    from tpubft_torch.consensus.persistent import (FilePersistentStorage,
                                                   PersistedState)
    from tpubft_torch.storage.metadata import DBPersistentStorage
    db = MemoryDB()
    legacy = PersistedState(last_view=2, last_executed_seq=9,
                            last_stable_seq=0)
    legacy.seq(9).pre_prepare = b"\xaa"
    db.put((1).to_bytes(4, "big"), json.dumps(
        FilePersistentStorage._encode(legacy),
        separators=(",", ":")).encode(), b"metadata")
    st = DBPersistentStorage(db).load()
    assert st.last_view == 2 and st.last_executed_seq == 9
    assert st.seq_states[9].pre_prepare == b"\xaa"


# ---------------- manager protocol (direct wiring) ----------------

def _make_chain(n_blocks, pkg="tpubft_torch"):
    kvbc = _pkg(pkg, "kvbc")
    bc = kvbc.KeyValueBlockchain(_pkg(pkg, "storage.memorydb").MemoryDB(),
                                 use_device_hashing=False)
    for i in range(n_blocks):
        bc.add_block(kvbc.BlockUpdates()
                     .put("m", f"k{i}".encode(), f"v{i}".encode(),
                          cat_type=kvbc.BLOCK_MERKLE)
                     .put("ver", b"seq", str(i).encode()))
    return bc


class _Net:
    """Synchronous message router between managers, with taps and a
    transcript of every delivered message."""

    def __init__(self):
        self.nodes = {}
        self.taps = []
        self.log = []

    def add(self, node_id, mgr):
        self.nodes[node_id] = mgr

    def sender(self, from_id):
        def send(dest, payload):
            for tap in self.taps:
                payload2 = tap(from_id, dest, payload)
                if payload2 is None:
                    return
                payload = payload2
            self.log.append((from_id, dest, payload))
            mgr = self.nodes.get(dest)
            if mgr is not None:
                mgr.handle_message(from_id, payload)
        return send


def _setup(n_blocks, n_sources, dest_cfg, src_cfg=None, pkg="tpubft_torch"):
    """n_sources honest managers over one chain + an empty destination;
    returns (chain, net, dest_bc, dest, done)."""
    mgr_mod = _pkg(pkg, "statetransfer.manager")
    chain = _make_chain(n_blocks, pkg)
    net = _Net()
    for r in range(n_sources):
        mgr = mgr_mod.StateTransferManager(r, chain, src_cfg)
        net.add(r, mgr)
        mgr.bind(net.sender(r), lambda s, d: None,
                 replica_ids=list(range(n_sources)) + [9], f_val=1)
        mgr.on_checkpoint_stable(5, chain.state_digest())
    dest_bc = _pkg(pkg, "kvbc").KeyValueBlockchain(
        _pkg(pkg, "storage.memorydb").MemoryDB(), use_device_hashing=False)
    dest = mgr_mod.StateTransferManager(9, dest_bc, dest_cfg)
    net.add(9, dest)
    done = []
    dest.bind(net.sender(9), lambda s, d: done.append((s, d)),
              replica_ids=list(range(n_sources)), f_val=n_sources - 1)
    return chain, net, dest_bc, dest, done


def _cfg(pkg, **kw):
    return _pkg(pkg, "statetransfer.manager").StConfig(**kw)


def test_full_transfer_transcript_matches_the_reference():
    """40 blocks from two sources, ranges of 8, two in flight: the port
    destination sends and receives the reference's exact messages and
    lands the same chain, Merkle root and serving point."""
    out = {}
    for pkg in ("tpubft_torch", "tpubft"):
        chain, net, dest_bc, dest, done = _setup(
            40, 2, _cfg(pkg, fetch_batch_blocks=8, window_ranges=2), pkg=pkg)
        # un-anchored start: summaries must be rejected
        dest.start_collecting(5)
        assert dest.state != "idle" and done == []
        dest.state = "idle"
        dest.start_collecting(5, {5: (chain.state_digest(), b"")})
        assert done == [(5, chain.state_digest())]
        assert dest_bc.last_block_id == 40
        assert dest_bc.state_digest() == chain.state_digest()
        assert dest_bc.merkle_root("m") == chain.merkle_root("m")
        assert dest._stable is not None and dest._stable[2] == 40
        out[pkg] = (net.log, [dest_bc.get_raw_block(b)
                              for b in range(1, 41)],
                    dest.metrics.snapshot()["counters"])
    assert out["tpubft_torch"][0] == out["tpubft"][0]
    assert out["tpubft_torch"][1] == out["tpubft"][1]
    # the port's one extra counter: windows whose device call failed
    assert out["tpubft_torch"][2] == dict(out["tpubft"][2],
                                          device_digest_failures=0)


def test_manager_byzantine_source_rotation():
    chain = _make_chain(12)
    net = _Net()
    honest = StateTransferManager(0, chain)
    lying = StateTransferManager(1, chain)
    net.add(0, honest)
    net.add(1, lying)
    dest_bc = KeyValueBlockchain(MemoryDB(), use_device_hashing=False)
    dest = StateTransferManager(3, dest_bc, StConfig(fetch_batch_blocks=4))
    net.add(3, dest)

    def corrupt(from_id, dest_id, payload):
        if from_id == 1:
            msg = stm.unpack(payload)
            if isinstance(msg, stm.ItemData):
                msg.payload = b"\x00" + msg.payload[1:]
                return stm.pack(msg)
        return payload
    net.taps.append(corrupt)
    for mgr, rid in ((honest, 0), (lying, 1)):
        mgr.bind(net.sender(rid), lambda s, d: None,
                 replica_ids=[0, 1, 3], f_val=1)
        mgr.on_checkpoint_stable(5, chain.state_digest())
    done = []
    dest.bind(net.sender(3), lambda s, d: done.append((s, d)),
              replica_ids=[0, 1], f_val=1)
    dest.start_collecting(5, {5: (chain.state_digest(), b"")})
    assert done == [(5, chain.state_digest())]
    assert dest_bc.state_digest() == chain.state_digest()


def test_source_rejects_out_of_range():
    chain = _make_chain(5)
    net = _Net()
    src = StateTransferManager(0, chain)
    net.add(0, src)
    rejected = []

    class _Sink:
        def handle_message(self, sender, payload):
            rejected.append(stm.unpack(payload))
    net.add(3, _Sink())
    src.bind(net.sender(0), lambda s, d: None, replica_ids=[3], f_val=1)
    src.on_checkpoint_stable(5, chain.state_digest())
    src.handle_message(3, stm.pack(stm.FetchBlocks(msg_id=1, from_block=1,
                                                   to_block=999)))
    assert rejected and isinstance(rejected[0], stm.RejectFetching)


def test_pipelined_source_death_mid_window():
    chain, net, dest_bc, dest, done = _setup(
        32, 3, StConfig(fetch_batch_blocks=4, window_ranges=3,
                        retry_timeout_s=0.05))
    served = {"n": 0}

    def die_after_first_item(from_id, dest_id, payload):
        if from_id == 0 and isinstance(stm.unpack(payload), stm.ItemData):
            served["n"] += 1
            if served["n"] > 2:
                return None
        return payload
    net.taps.append(die_after_first_item)
    dest.start_collecting(5, {5: (chain.state_digest(), b"")})
    deadline = time.monotonic() + 30
    while not done and time.monotonic() < deadline:
        time.sleep(0.06)
        dest.tick()
    assert done == [(5, chain.state_digest())]
    assert dest_bc.state_digest() == chain.state_digest()
    assert dest.metrics.snapshot()["counters"]["source_failovers"] >= 1


def test_pipelined_corruption_punishes_only_guilty_source():
    chain, net, dest_bc, dest, done = _setup(
        24, 3, StConfig(fetch_batch_blocks=4, window_ranges=3))

    def corrupt(from_id, dest_id, payload):
        if from_id == 0:
            msg = stm.unpack(payload)
            if isinstance(msg, stm.ItemData):
                msg.payload = b"\x00" + msg.payload[1:]
                return stm.pack(msg)
        return payload
    net.taps.append(corrupt)
    dest.start_collecting(5, {5: (chain.state_digest(), b"")})
    assert done == [(5, chain.state_digest())]
    assert dest_bc.state_digest() == chain.state_digest()
    counters = dest.metrics.snapshot()["counters"]
    assert counters["source_failovers"] >= 1
    assert counters["ranges_requeued"] == counters["source_failovers"]
    for honest in (1, 2):
        st = dest.sources.stats(honest)
        assert st is not None and not st.abandoned and st.failures == 0


def test_pipelined_out_of_order_completion_links_correctly():
    chain, net, dest_bc, dest, done = _setup(
        16, 2, StConfig(fetch_batch_blocks=8, window_ranges=2,
                        retry_timeout_s=60.0))
    held = []

    def hold_source0_items(from_id, dest_id, payload):
        if from_id == 0 and isinstance(stm.unpack(payload), stm.ItemData):
            held.append(payload)
            return None
        return payload
    net.taps.append(hold_source0_items)
    dest.start_collecting(5, {5: (chain.state_digest(), b"")})
    assert not done
    assert dest_bc.last_block_id == 0
    assert dest_bc.has_st_block(16) and not dest_bc.has_st_block(1)
    net.taps.clear()
    for payload in held:
        dest.handle_message(0, payload)
    assert done == [(5, chain.state_digest())]
    assert dest_bc.last_block_id == 16
    assert dest_bc.state_digest() == chain.state_digest()


@pytest.mark.parametrize("flip", ["total", "proof", "huge_total"])
def test_malformed_chunks_punish_the_source(flip):
    """A source flipping total_chunks or the proof between chunks of one
    block, or claiming a chunk count no block could need, is punished
    and the transfer completes from the honest peer."""
    chain, net, dest_bc, dest, done = _setup(
        8, 2, StConfig(fetch_batch_blocks=4, window_ranges=2),
        src_cfg=StConfig(max_chunk_bytes=48))

    def tap(from_id, dest_id, payload):
        if from_id == 0:
            msg = stm.unpack(payload)
            if isinstance(msg, stm.ItemData):
                if flip == "total" and msg.chunk_idx == 1:
                    msg.total_chunks += 1
                elif flip == "proof" and msg.chunk_idx == 1:
                    msg.proof = stm.RvtProof(path=[b"\x13" * 32], peaks=[])
                elif flip == "huge_total" and msg.chunk_idx == 0:
                    msg.total_chunks = 1 << 30
                else:
                    return payload
                return stm.pack(msg)
        return payload
    net.taps.append(tap)
    dest.start_collecting(5, {5: (chain.state_digest(), b"")})
    assert done == [(5, chain.state_digest())]
    assert dest_bc.state_digest() == chain.state_digest()
    st = dest.sources.stats(0)
    assert st is not None and (st.abandoned or st.failures > 0)


def test_link_st_chain_segments_large_suffix(monkeypatch):
    src = _make_chain(10)
    dst = KeyValueBlockchain(MemoryDB(), use_device_hashing=False)
    monkeypatch.setattr(KeyValueBlockchain, "LINK_SEGMENT_BLOCKS", 4)
    dst.add_raw_st_blocks({b: src.get_raw_block(b) for b in range(1, 11)})
    assert dst.link_st_chain() == 10
    assert dst.state_digest() == src.state_digest()
    assert dst.merkle_root("m") == src.merkle_root("m")


# ---------------- the window-digest seam ----------------

def _recording_seam(monkeypatch):
    calls = []
    real = digests.window_digests

    def seam(raws, use_device=True, threshold=16, device=None,
             degrade=True):
        # the manager never lets a device window fall back to the host
        assert degrade is False
        calls.append((len(raws), use_device))
        return real(raws, use_device, threshold, device, degrade)
    monkeypatch.setattr(digests, "window_digests", seam)
    return calls


def test_window_digests_route_through_the_seam(monkeypatch):
    """Full windows hash their leaves in ONE call each on the device
    route (the plain SHA-256 on CPU tensors here); the tail window under
    the cutoff stays on hashlib."""
    calls = _recording_seam(monkeypatch)
    chain, net, dest_bc, dest, done = _setup(
        20, 2, StConfig(fetch_batch_blocks=8, window_ranges=2,
                        device_digest_threshold=8, use_device_digests=True))
    dest.start_collecting(5, {5: (chain.state_digest(), b"")})
    assert done == [(5, chain.state_digest())]
    assert calls == [(8, True), (8, True), (4, True)]
    counters = dest.metrics.snapshot()["counters"]
    assert counters["device_digest_batches"] == 2
    assert counters["scalar_digests"] == 4


def test_kvbc_replica_on_cuda_sends_its_windows_to_the_device(monkeypatch):
    """KvbcReplica with crypto_backend="cuda": device hashing follows the
    backend, so every window of 16 or more blocks reaches
    digests.window_digests with use_device=True (the reference's
    `== "tpu"` rule, ported). With "cpu" the windows stay on hashlib."""
    from tpubft_torch.comm.loopback import LoopbackBus
    from tpubft_torch.consensus.keys import ClusterKeys
    from tpubft_torch.kvbc.replica import KvbcReplica
    calls = _recording_seam(monkeypatch)
    bus = LoopbackBus()
    try:
        for backend, on_device in (("cuda", True), ("cpu", False)):
            cfg = ReplicaConfig(replica_id=3, f_val=1,
                                num_of_client_proxies=1,
                                **dict(BASE, crypto_backend=backend))
            keys = ClusterKeys.generate(cfg, 1, seed=SEED)
            kr = KvbcReplica(cfg, keys.for_node(3), bus.create(3))
            dest = kr.state_transfer
            assert kr.blockchain._use_device is on_device
            assert dest._use_device is on_device
            assert dest.cfg.fetch_batch_blocks == 64
            chain = _make_chain(40)
            net = _Net()
            for r in (0, 1):
                src = StateTransferManager(r, chain)
                net.add(r, src)
                src.bind(net.sender(r), lambda s, d: None,
                         replica_ids=[0, 1, 3], f_val=1)
                src.on_checkpoint_stable(5, chain.state_digest())
            done = []
            # no reserved pages to fetch: only the ledger's blocks
            dest.pages = None
            net.add(3, dest)
            dest.bind(net.sender(3), lambda s, d: done.append((s, d)),
                      replica_ids=[0, 1], f_val=1)
            dest.cfg.fetch_batch_blocks = 16
            calls.clear()
            dest.start_collecting(5, {5: (chain.state_digest(), b"")})
            assert done == [(5, chain.state_digest())]
            assert calls == [(16, on_device), (16, on_device),
                             (8, on_device)]
            counters = dest.metrics.snapshot()["counters"]
            assert counters["device_digest_batches"] == (2 if on_device
                                                         else 0)
            assert kr.blockchain.state_digest() == chain.state_digest()
    finally:
        bus.shutdown()


def test_device_loss_degrades_to_hashlib_and_is_counted(monkeypatch):
    """Outside a replica (digests.window_digests called on its own, as
    the digest tools do) a RuntimeError of the device call degrades the
    window to hashlib with the same digests and counts it in
    digests.DEGRADED. The manager instead fails the window (below)."""
    from tpubft_torch.ops import sha256 as ops_sha

    def boom(msgs, device=None):
        raise RuntimeError("device lost")
    monkeypatch.setattr(ops_sha, "sha256_batch_mixed", boom)
    raws = [b"block %d" % i * (i + 1) for i in range(16)]
    before = digests.DEGRADED
    assert digests.window_digests(raws, use_device=True) \
        == [hashlib.sha256(r).digest() for r in raws]
    assert digests.DEGRADED == before + 1
    with pytest.raises(RuntimeError, match="device lost"):
        digests.window_digests(raws, use_device=True, degrade=False)
    assert digests.DEGRADED == before + 1
    monkeypatch.setattr(digests, "DEGRADED", before)


def test_device_loss_fails_the_window_and_charges_no_source(monkeypatch):
    """A RuntimeError of the device call (device loss, an OPEN breaker)
    fails the window loudly: it raises out of the manager, nothing is
    hashed on the host or adopted, digests.DEGRADED does not move, the
    source is not charged and the range is re-queued. Once the device is
    back, the next tick fetches it again and the transfer completes."""
    from tpubft_torch.ops import sha256 as ops_sha
    real = ops_sha.sha256_batch_mixed

    def boom(msgs, device=None):
        raise RuntimeError("device lost")
    monkeypatch.setattr(ops_sha, "sha256_batch_mixed", boom)
    before = digests.DEGRADED
    chain, net, dest_bc, dest, done = _setup(
        16, 2, StConfig(fetch_batch_blocks=8, window_ranges=2,
                        device_digest_threshold=8, use_device_digests=True))
    with pytest.raises(RuntimeError, match="device lost"):
        dest.start_collecting(5, {5: (chain.state_digest(), b"")})
    counters = dest.metrics.snapshot()["counters"]
    assert counters["device_digest_failures"] == 1
    assert counters["device_digest_batches"] == 0
    assert counters["scalar_digests"] == 0
    assert counters["source_failovers"] == 0
    assert counters["blocks_fetched"] == 0
    assert dest_bc.last_block_id == 0 and not done
    assert digests.DEGRADED == before
    monkeypatch.setattr(ops_sha, "sha256_batch_mixed", real)
    dest.tick()
    assert done == [(5, chain.state_digest())]
    counters = dest.metrics.snapshot()["counters"]
    assert counters["device_digest_batches"] == 2
    assert counters["source_failovers"] == 0
    assert digests.DEGRADED == before


def test_replica_config_sets_the_window_shape():
    """KvbcReplica and the in-process cluster configure state transfer
    from the replica's config alike: ranges of
    state_transfer_batch_blocks, st_window_ranges in flight, the device
    cutoff, and StConfig's retry timeout."""
    cfg = ReplicaConfig(f_val=1, num_of_client_proxies=1,
                        **dict(BASE, state_transfer_batch_blocks=32,
                               st_window_ranges=3,
                               st_device_digest_threshold=12))
    st = StConfig.for_replica(cfg, use_device_digests=True)
    assert (st.fetch_batch_blocks, st.window_ranges,
            st.device_digest_threshold, st.max_chunk_bytes,
            st.retry_timeout_s, st.use_device_digests) \
        == (32, 3, 12, cfg.max_block_chunk_bytes,
            StConfig().retry_timeout_s, True)
    deployed = StConfig.for_replica(ReplicaConfig())
    assert (deployed.fetch_batch_blocks, deployed.window_ranges,
            deployed.device_digest_threshold, deployed.use_device_digests) \
        == (64, 4, 16, None)
    cluster = _skvbc_cluster("tpubft_torch",
                             dict(state_transfer_batch_blocks=32))
    try:
        for rep in cluster.replicas.values():
            assert vars(rep.state_transfer.cfg) == vars(StConfig.for_replica(
                rep.cfg))
            assert rep.state_transfer.cfg.fetch_batch_blocks == 32
    finally:
        cluster.stop()


def test_missing_card_raises_instead_of_hashing_on_the_host():
    """No card and no request for the CPU: the window's device call
    raises device.NoDevice out of the manager (the reference would have
    hashed on the host without a word)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    device.set_default_device(None)
    chain, net, dest_bc, dest, done = _setup(
        16, 2, StConfig(fetch_batch_blocks=8, window_ranges=2,
                        device_digest_threshold=8, use_device_digests=True))
    before = digests.DEGRADED
    with pytest.raises(device.NoDevice):
        dest.start_collecting(5, {5: (chain.state_digest(), b"")})
    assert digests.DEGRADED == before and not done


# ---------------- end to end: a lagging replica catches up ----------------

def _skvbc_cluster(pkg, overrides):
    kvbc = _pkg(pkg, "kvbc")
    app = _pkg(pkg, "apps.skvbc")
    mem = _pkg(pkg, "storage.memorydb")

    def handler(_r=None):
        return app.SkvbcHandler(
            kvbc.KeyValueBlockchain(mem.MemoryDB(), use_device_hashing=False))
    return _pkg(pkg, "testing.cluster").InProcessCluster(
        f=1, num_clients=1, seed=SEED, handler_factory=handler,
        cfg_overrides=dict(BASE, **overrides))


def _wait(cond, budget_s, what):
    deadline = time.monotonic() + budget_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {budget_s}s waiting for {what}")


def test_lagging_replica_catches_up_to_the_reference_digests():
    """Replica 3 is down while the cluster moves past its work window,
    then restarts with empty state: it fetches the ledger by state
    transfer, its head digest equals replica 0's, and every block digest
    up to its head equals the reference cluster's for the same writes."""
    overrides = dict(checkpoint_window_size=5, work_window_size=10,
                     fast_path_timeout_ms=150)
    cluster = _skvbc_cluster("tpubft_torch", overrides).start()
    try:
        kv = skvbc.SkvbcClient(cluster.client(0))
        cluster.kill(3)
        n = 0
        while min(cluster.replicas[r].last_stable for r in (0, 1, 2)) \
                <= overrides["work_window_size"]:
            assert kv.write([(b"k%d" % n, b"v%d" % n)],
                            timeout_ms=60000).success
            n += 1
        lagging_at = n
        cluster.restart(3)
        rep3 = cluster.replicas[3]

        def caught_up():
            return (rep3.state_transfer.metrics.snapshot()["counters"]
                    ["blocks_fetched"] >= lagging_at
                    and not rep3.state_transfer.is_fetching
                    and rep3.last_executed > 0)
        deadline = time.monotonic() + 120
        while not caught_up():
            assert time.monotonic() < deadline, "replica 3 never caught up"
            assert kv.write([(b"k%d" % n, b"v%d" % n)],
                            timeout_ms=60000).success
            n += 1
        h0 = cluster.handlers[0].blockchain
        h3 = cluster.handlers[3].blockchain
        head = h3.last_block_id
        assert head >= lagging_at
        assert h3.block_digest(head) == h0.block_digest(head)
        # with the load stopped, replica 3 reaches the cluster's head
        _wait(lambda: h3.last_block_id == h0.last_block_id == n, 120,
              "replica 3 to reach the head")
        assert h3.state_digest() == h0.state_digest()
        head = n
        port_digests = [h3.block_digest(b) for b in range(1, head + 1)]
    finally:
        cluster.stop()
    ref = _skvbc_cluster("tpubft", overrides).start()
    try:
        ref_kv = _pkg("tpubft", "apps.skvbc").SkvbcClient(ref.client(0))
        for i in range(head):
            assert ref_kv.write([(b"k%d" % i, b"v%d" % i)],
                                timeout_ms=60000).success
        rb = ref.handlers[0].blockchain
        assert [rb.block_digest(b) for b in range(1, head + 1)] \
            == port_digests
    finally:
        ref.stop()



def test_transfer_aborts_the_speculation_it_would_wait_on():
    """Replica 3 accepts a PrePrepare and speculates on it, but never
    sees its certificates, while the others order past its work window
    and collect the slot behind their stable checkpoint. Its transfer
    must not wait on that speculation: the link of the fetched blocks
    defers while an open speculative accumulation holds the staging lock,
    and the commit that would close it never comes. (The reference
    wedges here, st `fetching` with the speculation open; the port
    aborts the speculation when a transfer starts and speculates no more
    while one is in progress.) Replica 3 reaches the others' head with
    equal state."""
    import struct

    from tpubft_torch.consensus import messages as m
    certs = {int(c) for c in (
        m.MsgCode.PreparePartial, m.MsgCode.PrepareFull,
        m.MsgCode.CommitPartial, m.MsgCode.CommitFull,
        m.MsgCode.PartialCommitProof, m.MsgCode.FullCommitProof)}
    deaf = []

    def drop_certs_to_3(_s, d, data):
        if deaf and d == 3 and len(data) >= 2 \
                and struct.unpack_from("<H", data)[0] in certs:
            return None
        return data
    overrides = dict(checkpoint_window_size=5, work_window_size=10)
    cluster = _skvbc_cluster("tpubft_torch", overrides)
    cluster.bus.add_hook(drop_certs_to_3)
    cluster.start()
    try:
        kv = skvbc.SkvbcClient(cluster.client(0))
        reps = cluster.replicas
        for i in range(3):
            assert kv.write([(b"a%d" % i, b"v")], timeout_ms=60000).success
        _wait(lambda: reps[3].last_executed == reps[0].last_executed, 60,
              "the four to agree")
        deaf.append(True)
        assert kv.write([(b"spec", b"v")], timeout_ms=60000).success
        _wait(lambda: cluster.handlers[3].blockchain.speculation_open
              or reps[3].m_exec_spec_aborts.value > 0, 60,
              "replica 3 to speculate")
        stuck_at = reps[3].last_executed
        deadline = time.monotonic() + 120
        n = 0
        while min(reps[r].last_stable for r in (0, 1, 2)) \
                <= stuck_at + overrides["work_window_size"]:
            assert time.monotonic() < deadline, "the others never moved on"
            assert kv.write([(b"b%d" % n, b"v")], timeout_ms=60000).success
            n += 1
        deaf.clear()
        assert kv.write([(b"last", b"v")], timeout_ms=60000).success
        h0 = cluster.handlers[0].blockchain
        h3 = cluster.handlers[3].blockchain
        _wait(lambda: h3.last_block_id == h0.last_block_id
              and not reps[3].state_transfer.is_fetching, 60,
              "replica 3 to reach the head")
        assert h3.state_digest() == h0.state_digest()
        assert not h3.speculation_open
        assert reps[3].m_exec_spec_aborts.value > 0
        assert reps[3].state_transfer.metrics.snapshot()["counters"][
            "blocks_fetched"] > 0
    finally:
        cluster.stop()
