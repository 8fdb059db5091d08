"""The port's group-commit durability pipeline (tpubft_torch/durability/)
and the ledger's group-commit wiring, against the reference.

The first test holds the repaired fault: the execution lane calls
`KeyValueBlockchain.end_accumulation(extra=..., defer=...)` whenever a
durability pipeline is installed, so the port's ledger must take `defer`
(before it did, the first committed run raised TypeError). The rest are
the reference's own pipeline semantics, run on the port's copy: the
pending overlay and its read view, group formation, the watermark,
backpressure, fsync retries, the direct-write barrier, the in-flight
dedup, and the two cluster drills — no reply precedes its group's fsync,
and a crash at `dur.group_fsync` replays exactly once.
"""
import importlib
import threading
import time

import pytest
import torch

from tpubft_torch import device
from tpubft_torch.apps import skvbc
from tpubft_torch.consensus.persistent import FilePersistentStorage
from tpubft_torch.durability import (DurabilityPipeline, PendingStore,
                                     SealedRun)
from tpubft_torch.kvbc import KeyValueBlockchain
from tpubft_torch.storage.interfaces import WriteBatch, fkey
from tpubft_torch.storage.memorydb import MemoryDB
from tpubft_torch.testing.cluster import InProcessCluster

# one intra-op thread: the plain versions run many tiny tensor ops, and
# several test workers share the host's cores
torch.set_num_threads(1)

BASE = dict(autotune_enabled=False, crypto_backend="cpu")
SEED = b"torch-durability"


@pytest.fixture(autouse=True)
def _cpu():
    device.set_default_device("cpu")
    yield
    device.set_default_device(None)


def _wait(pred, timeout=90.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


# ---------------------------------------------------------------------
# the repaired fault: a lane with a pipeline over a port ledger
# ---------------------------------------------------------------------

def _two_runs(pkg):
    """A replica of package `pkg` (built, never started) whose execution
    lane runs two committed slots over a ledger that shares its db with
    the reserved pages, with a recording pipeline installed: slot 1
    before the ledger attaches the pending overlay, slot 2 after. The
    io thread's part (apply the group, retire the overlay) is done by
    hand. Returns what the test compares."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")
    m = mod("consensus.messages")

    class Ledger(mod("consensus.replica").IRequestsHandler):
        def __init__(self, bc):
            self.blockchain = bc

        def execute(self, client_id, req_seq, flags, request):
            self.blockchain.add_block(mod("kvbc").BlockUpdates().put(
                "kv", request, b"v-%d" % req_seq))
            return b"ok-%d" % req_seq

        def state_digest(self):
            return self.blockchain.state_digest()

    class Pipe:
        def __init__(self):
            self.sealed = []

        def seal(self, sealed):
            self.sealed.append(sealed)

    cfg = mod("utils.config").ReplicaConfig(
        replica_id=1, f_val=1, num_of_client_proxies=1,
        durability_pipeline=False, **BASE)
    keys = mod("consensus.keys").ClusterKeys.generate(cfg, 1, seed=SEED)
    bus = mod("comm.loopback").LoopbackBus()
    raw = mod("storage.memorydb").MemoryDB()
    bc = mod("kvbc").KeyValueBlockchain(raw, use_device_hashing=False)
    pages = mod("consensus.reserved_pages").ReservedPages(raw)
    rep = mod("consensus.replica").Replica(
        cfg, keys.for_node(1), bus.create(1), Ledger(bc),
        reserved_pages=pages)
    pipe = rep.durability = Pipe()
    signer = keys.for_node(4).my_signer()

    def pre_prepare(seq):
        req = m.ClientRequestMsg(sender_id=4, req_seq_num=seq, flags=0,
                                 request=b"key-%d" % seq, cid=f"c{seq}",
                                 signature=b"")
        req.signature = signer.sign(req.signed_payload())
        reqs = [req.pack()]
        return m.PrePrepareMsg(
            sender_id=0, view=0, seq_num=seq,
            first_path=int(m.CommitPath.SLOW), time=0,
            requests_digest=m.PrePrepareMsg.compute_requests_digest(reqs),
            requests=reqs, signature=b"")

    def base_blocks():
        return sum(1 for _ in raw.range_iter(b"blk.blocks"))

    out = {}
    try:
        rep.exec_lane._execute_run([(1, pre_prepare(1))])
        s = pipe.sealed[0]
        out["unattached"] = (s.batch, s.run_no, s.db,
                             [d is raw for d in s.sync_dbs],
                             bc.last_block_id, base_blocks())
        store = mod("durability").PendingStore("t")
        view = bc.attach_durability(store)
        out["attached"] = (bc.durability_attached, view.base is raw)
        pages.rebind(view)
        rep.exec_lane._execute_run([(2, pre_prepare(2))])
        s = pipe.sealed[1]
        page_keys = [k for k, _ in s.batch.ops
                     if k.startswith(fkey(b"respages", b""))]
        out["deferred"] = (s.run_no, s.db is raw, s.sync_dbs,
                           bc.take_deferred(), bc.last_block_id,
                           base_blocks(), bc.get_raw_block(2) is not None,
                           bool(page_keys),
                           all(store.lookup(k) is not None
                               for k in page_keys))
        s.db.write_group([s.batch])
        store.mark_applied(s.run_no, s.batch)
        out["applied"] = (store.empty, base_blocks())
        out["blocks"] = [bc.get_raw_block(b) for b in (1, 2)]
        out["state_digest"] = bc.state_digest()
        out["pages"] = sorted(pages.all_pages())
    finally:
        bus.shutdown()
    return out


def test_lane_end_accumulation_defer_on_the_port_ledger():
    """The fault: the lane passes `defer=` to end_accumulation and seals
    through `tpubft_torch.durability`; the port ledger took neither
    (TypeError at the first committed run). Now an unattached ledger
    applies and seals a sync-only ticket, and an attached one defers the
    whole run — block rows and the folded reply pages — into the pending
    store, readable before the io thread lands it. The bytes equal the
    reference's."""
    port = _two_runs("tpubft_torch")
    assert port["unattached"] == (None, None, None, [True], 1, 1)
    assert port["attached"] == (True, True)
    assert port["deferred"] == (1, True, (), None, 2, 1, True, True, True)
    assert port["applied"] == (True, 2)
    ref = _two_runs("tpubft")
    for what in ("blocks", "state_digest", "pages"):
        assert port[what] == ref[what], what


def test_end_accumulation_defer_needs_attach():
    from tpubft_torch.kvbc.blockchain import BlockchainError
    bc = KeyValueBlockchain(MemoryDB(), use_device_hashing=False)
    bc.begin_accumulation()
    with pytest.raises(BlockchainError, match="attach_durability"):
        bc.end_accumulation(defer=True)


# ---------------------------------------------------------------------
# PendingStore and the ledger's pending view
# ---------------------------------------------------------------------

def test_pending_store_stage_lookup_apply():
    st = PendingStore("t")
    n1 = st.stage({b"\x01ak1": b"v1", b"\x01ak2": None})
    n2 = st.stage({b"\x01ak1": b"v2"})      # later run overwrites
    assert n2 == n1 + 1
    assert st.lookup(b"\x01ak1") == (n2, b"v2")
    assert st.lookup(b"\x01ak2") == (n1, None)   # pending delete
    assert st.lookup(b"\x01ak3") is None
    # applying run 1 must NOT drop k1 (run 2's value still pending)
    wb1 = WriteBatch()
    wb1.ops = [(b"\x01ak1", b"v1"), (b"\x01ak2", None)]
    st.mark_applied(n1, wb1)
    assert st.lookup(b"\x01ak1") == (n2, b"v2")
    assert st.lookup(b"\x01ak2") is None
    wb2 = WriteBatch()
    wb2.ops = [(b"\x01ak1", b"v2")]
    st.mark_applied(n2, wb2)
    assert st.empty
    assert st.wait_empty(0.1)


@pytest.mark.parametrize("pkg", ["tpubft_torch", "tpubft"])
def test_pending_view_point_and_range_merge(pkg):
    """Point gets consult the overlay; range scans MERGE pending keys
    into the base iteration (pending overwrites win, pending deletes
    hide base rows, pure-pending keys appear in order) — the same rows
    on both packages."""
    bcm = importlib.import_module(f"{pkg}.kvbc.blockchain")
    dur = importlib.import_module(f"{pkg}.durability")
    mem = importlib.import_module(f"{pkg}.storage.memorydb")
    base = mem.MemoryDB()
    base.put(b"a", b"base-a", b"fam")
    base.put(b"c", b"base-c", b"fam")
    base.put(b"d", b"base-d", b"fam")
    store = dur.PendingStore("t")
    view = bcm._PendingView(base, store)
    store.stage({fkey(b"fam", b"b"): b"pend-b",      # pure pending
                 fkey(b"fam", b"c"): b"pend-c",      # overwrite
                 fkey(b"fam", b"d"): None})          # pending delete
    assert view.get(b"b", b"fam") == b"pend-b"
    assert view.get(b"c", b"fam") == b"pend-c"
    assert view.get(b"d", b"fam") is None
    assert view.get(b"a", b"fam") == b"base-a"
    assert list(view.range_iter(b"fam")) == [
        (b"a", b"base-a"), (b"b", b"pend-b"), (b"c", b"pend-c")]
    assert bcm.raw_base(view) is base and bcm.raw_base(base) is base
    # empty overlay falls straight through
    v2 = bcm._PendingView(base, dur.PendingStore("t2"))
    assert list(v2.range_iter(b"fam")) == [
        (b"a", b"base-a"), (b"c", b"base-c"), (b"d", b"base-d")]


# ---------------------------------------------------------------------
# pipeline unit semantics (stub replica)
# ---------------------------------------------------------------------

class _Run:
    def __init__(self, last):
        self.first = last
        self.last = last


class _Clients:
    def __init__(self):
        self.executed = []

    def on_request_executed(self, c, s, r):
        self.executed.append((c, s))


class _Lane:
    def __init__(self):
        self.completed = []

    def complete_durable(self, run):
        self.completed.append(run.last)


class _Incoming:
    def __init__(self):
        self.pushes = 0

    def push_internal_once(self, _key):
        self.pushes += 1


class _SyncDB(MemoryDB):
    def __init__(self):
        super().__init__()
        self.syncs = 0
        self.group_writes = []

    def sync(self):
        self.syncs += 1

    def write_group(self, batches):
        self.group_writes.append(len(batches))
        super().write_group(batches)


class _FlakyDB(_SyncDB):
    fail = True

    def sync(self):
        if self.fail:
            raise OSError("injected fsync failure")
        super().sync()


class _StubReplica:
    def __init__(self):
        self.id = 0
        self.last_executed = 0
        self.clients = _Clients()
        self.exec_lane = _Lane()
        self.incoming = _Incoming()
        self.aggregator = None
        self.health = None


def _seal(pipe, seq, db=None, store=None, key=None, val=b"v"):
    batch = run_no = None
    if db is not None and store is not None:
        batch = WriteBatch().put(key or b"k%d" % seq, val, b"blk")
        run_no = store.stage(dict(batch.ops))
    pipe.seal(SealedRun(run=_Run(seq), executed_now=[(9, seq, None)],
                        batch=batch, run_no=run_no, db=db,
                        sync_dbs=(db,) if db is not None and batch is None
                        else ()))


def test_group_formation_and_watermark():
    """group_max cuts a full group immediately; the watermark, the
    completions, the at-most-once visibility and ONE concatenated
    write_group + ONE sync per group all land together."""
    r = _StubReplica()
    db = _SyncDB()
    pipe = DurabilityPipeline(r, group_max=4, window_us=60_000_000)
    store = pipe.pending
    pipe.hold()
    pipe.start()
    try:
        for seq in range(1, 5):
            _seal(pipe, seq, db=db, store=store)
        assert pipe.watermark == 0 and not r.exec_lane.completed
        pipe.release()
        assert _wait(lambda: pipe.watermark == 4, 10)
        assert r.exec_lane.completed == [1, 2, 3, 4]
        assert r.clients.executed == [(9, s) for s in range(1, 5)]
        assert db.group_writes == [4]     # ONE concatenated apply
        assert db.syncs == 1              # ONE fsync for the group
        assert store.empty                # overlay fully retired
        assert r.incoming.pushes == 1
        assert db.get(b"k3", b"blk") == b"v"
    finally:
        pipe.stop()


def test_window_expiry_forms_partial_group():
    r = _StubReplica()
    db = _SyncDB()
    pipe = DurabilityPipeline(r, group_max=64, window_us=20_000)
    pipe.start()
    try:
        _seal(pipe, 1, db=db, store=pipe.pending)
        _seal(pipe, 2, db=db, store=pipe.pending)
        # nowhere near group_max: the 20ms window must cut the group
        assert _wait(lambda: pipe.watermark == 2, 10)
        assert db.syncs == 1 and db.group_writes == [2]
    finally:
        pipe.stop()


def test_drain_flushes_and_seal_backpressure():
    r = _StubReplica()
    pipe = DurabilityPipeline(r, group_max=2, window_us=60_000_000)
    pipe.hold()
    pipe.start()
    try:
        for seq in range(1, 4):
            _seal(pipe, seq)
        assert not pipe.drain(timeout=0.3)      # held: cannot drain
        # fill the queue to the bound: the next seal must BLOCK (lane
        # backpressure), then complete once the io thread resumes
        for seq in range(4, pipe._queue_max + 1):
            _seal(pipe, seq)
        blocked = threading.Event()

        def late_seal():
            _seal(pipe, pipe._queue_max + 1)
            blocked.set()

        t = threading.Thread(target=late_seal, daemon=True)
        t.start()
        assert not blocked.wait(0.3), "seal did not backpressure"
        pipe.release()
        assert blocked.wait(10)
        assert pipe.drain(timeout=10)
        assert pipe.idle() and pipe.watermark == pipe._queue_max + 1
    finally:
        pipe.stop()


def test_group_commit_failure_retries_never_completes_early():
    """A failing fsync requeues the WHOLE group: nothing completes,
    nothing reaches the reply cache, the watermark holds — and the
    group lands once the disk recovers."""
    r = _StubReplica()
    db = _FlakyDB()
    pipe = DurabilityPipeline(r, group_max=2, window_us=0)
    pipe.RETRY_DELAY_S = 0.05
    pipe.start()
    try:
        _seal(pipe, 1, db=db, store=pipe.pending)
        assert _wait(lambda: pipe.m_retries.value >= 1, 10)
        assert pipe.watermark == 0 and not r.exec_lane.completed
        assert not r.clients.executed
        db.fail = False
        assert _wait(lambda: pipe.watermark == 1, 10)
        assert r.exec_lane.completed == [1]
    finally:
        pipe.stop()


def test_drain_on_idle_does_not_poison_window():
    """A barrier drain against an already-idle pipeline must not leave
    a stale flush request behind."""
    r = _StubReplica()
    db = _SyncDB()
    pipe = DurabilityPipeline(r, group_max=64, window_us=60_000_000)
    pipe.start()
    try:
        assert pipe.drain(timeout=2)       # idle drain: nothing to do
        _seal(pipe, 1, db=db, store=pipe.pending)
        time.sleep(0.4)
        assert pipe.watermark == 0, \
            "stale flush bypassed the group window"
        pipe.flush()
        assert _wait(lambda: pipe.watermark == 1, 10)
    finally:
        pipe.stop()


def test_pending_barrier_waits_for_durability_not_just_overlay():
    """The direct-write barrier must see an applied-but-unsynced group
    parked for an fsync retry (overlay already empty) as NOT drained."""
    from tpubft_torch.kvbc.blockchain import BlockchainError
    bc = KeyValueBlockchain(MemoryDB(), use_device_hashing=False)
    r = _StubReplica()
    db = _FlakyDB()
    pipe = DurabilityPipeline(r, group_max=1, window_us=0)
    pipe.RETRY_DELAY_S = 0.05
    bc.attach_durability(pipe.pending, drain_fn=pipe.drain)
    pipe.start()
    try:
        _seal(pipe, 1, db=db, store=pipe.pending)
        assert _wait(lambda: pipe.m_retries.value >= 1, 10)
        assert pipe.pending.empty
        assert not pipe.idle()
        with pytest.raises(BlockchainError):
            bc._pending_barrier(timeout=0.3)
        db.fail = False
        assert _wait(lambda: pipe.watermark == 1, 10)
        bc._pending_barrier(timeout=5)     # durable now: barrier opens
    finally:
        pipe.stop()


def test_sign_group_replies_runs_under_the_sign_section():
    """Deferred replies are signed in ONE host sign_batch per group,
    inside device_section("ed25519.sign"), with no kernel launched."""
    from tpubft_torch.ops import dispatch, ed25519_cuda

    class _Reply:
        signature = b""

        def signed_payload(self):
            return b"payload"

        def pack(self):
            return b"wire:" + self.signature

    class _Sig:
        def __init__(self):
            self.batches = []

        def sign_batch(self, datas):
            self.batches.append(len(datas))
            return [b"s%d" % i for i in range(len(datas))]

    r = _StubReplica()
    r.sig = _Sig()
    sections = []
    real = dispatch.device_section

    def spy(kind, batch=0):
        sections.append((kind, batch))
        return real(kind, batch)
    launches = dict(ed25519_cuda.LAUNCHES)
    run = _Run(1)
    run.unsigned = [(7, _Reply()), (8, _Reply())]
    run.replies = []
    pipe = DurabilityPipeline(r)
    try:
        dispatch.device_section = spy
        pipe._sign_group_replies([SealedRun(run=run, executed_now=[])])
    finally:
        dispatch.device_section = real
    assert sections == [("ed25519.sign", 2)] and r.sig.batches == [2]
    assert run.replies == [(7, b"wire:s0"), (8, b"wire:s1")]
    assert pipe.m_signed.value == 2
    assert ed25519_cuda.LAUNCHES == launches


def test_inflight_dedup_across_sealed_runs():
    """Exactly-once across back-to-back runs while durability is
    pending: a request executed in a SEALED-but-not-yet-fsynced run must
    NOT execute again when a later slot re-proposes it."""
    from tpubft_torch.consensus.execution import CompletedRun, ExecutionLane

    class _Reply:
        def pack(self):
            return b"stashed-wire"

    class _Cl:
        def was_executed(self, c, s):
            return False

        def cached_reply(self, c, s):
            return None

    class _Cfg:
        time_service_enabled = False

    class _Slow:
        enabled = False

    class _Rep:
        id = 0
        clients = _Cl()
        cfg = _Cfg()
        _slowdown = _Slow()
        executions = 0

        def _execute_request(self, req, seq):
            _Rep.executions += 1
            return b"payload"

        def _build_reply(self, client, req_seq, payload, pages_wb,
                         defer_sign=False):
            return _Reply(), b"wire"

        class m_exec_lane_depth:  # noqa: N801 — gauge stub
            @staticmethod
            def set(v):
                pass

    class _Req:
        sender_id = 9
        req_seq_num = 5

    class _PP:
        time = None

        def client_requests(self):
            return [_Req()]

    r = _Rep()
    lane = ExecutionLane(r, 16, 150)      # thread never started
    pp = _PP()
    lane._run_seen = set()
    res_a = CompletedRun(first=1, last=1, n_requests=0)
    executed_a = []
    lane._execute_slot(1, pp, WriteBatch(), res_a, executed_a)
    assert _Rep.executions == 1 and executed_a
    with lane._cond:
        for client, req_seq, reply in executed_a:
            lane._inflight[(client, req_seq)] = reply
    lane._run_seen = set()
    res_b = CompletedRun(first=2, last=2, n_requests=0)
    lane._execute_slot(2, pp, WriteBatch(), res_b, [])
    assert _Rep.executions == 1, "request executed twice pre-durability"
    assert res_b.replies == [(9, b"stashed-wire")]
    lane.complete_durable(CompletedRun(first=1, last=1, n_requests=1,
                                       reply_keys=[(9, 5)]))
    assert (9, 5) not in lane._inflight


# ---------------------------------------------------------------------
# cluster drills
# ---------------------------------------------------------------------

def _kv_cluster(tmp_path, dbs, **overrides):
    def handler_factory(r):
        db = dbs.setdefault(r, MemoryDB())
        return skvbc.SkvbcHandler(
            KeyValueBlockchain(db, use_device_hashing=False))

    def storage_factory(r):
        return FilePersistentStorage(str(tmp_path / f"r{r}.wal"))

    return InProcessCluster(f=1, handler_factory=handler_factory,
                            storage_factory=storage_factory, seed=SEED,
                            cfg_overrides=dict(BASE, **overrides))


def test_reply_never_precedes_group_fsync(tmp_path):
    """Hold every replica's io thread: executed runs stay sealed, no
    reply reaches the client and last_executed never advances past the
    watermark; releasing the pipelines delivers the SAME write."""
    dbs = {}
    with _kv_cluster(tmp_path, dbs, durability_window_us=0) as cluster:
        kv = skvbc.SkvbcClient(cluster.client(0))
        assert kv.write([(b"warm", b"w")], timeout_ms=60000).success
        assert _wait(lambda: all(
            cluster.replicas[r].last_executed >= 1
            and cluster.replicas[r].durability.idle()
            for r in range(4)))
        base = [cluster.replicas[r].last_executed for r in range(4)]
        for r in range(4):
            cluster.replicas[r].durability.hold()
        box = {}

        def bg_write():
            box["r"] = kv.write([(b"gated", b"g")], timeout_ms=90000)

        t = threading.Thread(target=bg_write, daemon=True)
        t.start()
        # executed and sealed on a quorum, but not durable
        assert _wait(lambda: sum(
            cluster.replicas[r].durability.lag > 0 for r in range(4)) >= 3)
        time.sleep(0.5)
        assert "r" not in box, "reply preceded its group's fsync"
        for r in range(4):
            rep = cluster.replicas[r]
            assert rep.last_executed == base[r], \
                "last_executed advanced past the durability watermark"
            assert rep.last_executed <= rep.durability.watermark
        for r in range(4):
            cluster.replicas[r].durability.release()
        t.join(90)
        assert box.get("r") is not None and box["r"].success
        for r in range(4):
            rep = cluster.replicas[r]
            assert _wait(lambda rep=rep:
                         rep.last_executed <= rep.durability.watermark
                         and rep.durability.idle())


def test_crash_restart_at_group_fsync_exactly_once(tmp_path):
    """Park a replica's io thread AT dur.group_fsync (group applied,
    fsync never issued, watermark unpublished), then recover it
    standalone from its durable state: the committed suffix replays
    exactly once, last_executed is monotone across the crash-restart,
    and the recovered ledger digest matches the cluster's."""
    from tpubft_torch.comm.loopback import LoopbackBus
    from tpubft_torch.consensus.replica import Replica
    from tpubft_torch.testing import crashpoints as cp
    from tpubft_torch.utils.config import ReplicaConfig
    victim = 2
    dbs = {}
    hit = threading.Event()

    def crash_here():
        hit.set()
        cp.park()

    try:
        with _kv_cluster(tmp_path, dbs) as cluster:
            kv = skvbc.SkvbcClient(cluster.client(0))
            assert kv.write([(b"pre", b"1")], timeout_ms=60000).success
            assert _wait(lambda:
                         cluster.replicas[victim].last_executed >= 1)
            frozen_at = cluster.replicas[victim].last_executed
            cp.arm("dur.group_fsync", rid=victim, action=crash_here)
            assert kv.write([(b"boom", b"2")], timeout_ms=60000).success
            assert hit.wait(60)
            assert cluster.replicas[victim].last_executed == frozen_at
            target_digest = \
                cluster.handlers[0].blockchain.state_digest()
            keys = cluster.keys
            pages = cluster._pages_dbs[victim]
            cp.disarm_all()
            cp.release_parked()
        # ---- standalone recovery from the victim's durable state ----
        cfg = ReplicaConfig(replica_id=victim, f_val=1,
                            num_of_client_proxies=2,
                            execution_lane=False, **BASE)
        bus = LoopbackBus()
        recovered = Replica(
            cfg, keys.for_node(victim), bus.create(victim),
            skvbc.SkvbcHandler(
                KeyValueBlockchain(dbs[victim],
                                   use_device_hashing=False)),
            storage=FilePersistentStorage(
                str(tmp_path / f"r{victim}.wal")),
            reserved_pages=pages)
        bus.shutdown()
        assert recovered.last_executed >= frozen_at, \
            "last_executed regressed across the crash-restart"
        assert recovered.handler.blockchain.state_digest() \
            == target_digest, "replay diverged after group-fsync crash"
    finally:
        cp.disarm_all()
        cp.release_parked()


def test_default_config_builds_with_the_pipeline_and_commits(tmp_path):
    """The reference's default config, autotuner off: the durability
    pipeline is on and a ledger write commits through it."""
    dbs = {}
    with _kv_cluster(tmp_path, dbs) as cluster:
        rep = cluster.replicas[0]
        assert rep.cfg.durability_pipeline and rep.durability is not None
        assert rep.handler.blockchain.durability_attached
        assert rep.res_pages.shares_db(rep.handler.blockchain._db)
        kv = skvbc.SkvbcClient(cluster.client(0))
        assert kv.write([(b"a", b"1")], timeout_ms=60000).success
        assert _wait(lambda: rep.durability.m_groups.value > 0)
        assert kv.read([b"a"], timeout_ms=60000) == {b"a": b"1"}


def test_cluster_crash_recovers_a_ledger_replica(tmp_path):
    """cluster.crash on a ledger replica: the new incarnation reopens the
    same ledger db (its pages rebound onto the new pending view) and its
    WAL, and converges with the others on the writes that follow."""
    from tpubft_torch.kvbc.blockchain import raw_base
    dbs = {}
    with _kv_cluster(tmp_path, dbs) as cluster:
        kv = skvbc.SkvbcClient(cluster.client(0))
        for i in range(3):
            assert kv.write([(b"a%d" % i, b"1")], timeout_ms=60000).success
        # quiesce first: the abandoned incarnation's lane and io thread
        # must have nothing left to land in the db the new one reopens
        assert _wait(lambda: all(
            cluster.handlers[r].blockchain.last_block_id == 3
            and cluster.replicas[r].exec_lane.idle()
            and cluster.replicas[r].durability.idle() for r in range(4)),
            120)
        old = cluster.replicas[2]
        rep = cluster.crash(2)
        assert rep is not old and cluster.replicas[2] is rep
        bc = rep.handler.blockchain
        assert raw_base(bc._db) is dbs[2] and bc.durability_attached
        assert rep.res_pages.db is bc._db
        for i in range(3, 6):
            assert kv.write([(b"a%d" % i, b"2")], timeout_ms=60000).success
        assert _wait(lambda: all(
            cluster.handlers[r].blockchain.last_block_id == 6
            and cluster.replicas[r].durability.idle() for r in range(4)),
            120)
        assert len({cluster.handlers[r].blockchain.state_digest()
                    for r in range(4)}) == 1
