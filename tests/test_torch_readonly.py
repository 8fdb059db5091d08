"""The port's read-only replica (tpubft_torch/kvbc/readonly.py), its
process (tpubft_torch/apps/ro_replica.py, BftTestNetwork.start_ro_replica)
and v4 replica processes, on this host's CPU, held to what the reference
is held to: the counterparts of tests/test_readonly_replica.py on the
port's InProcessCluster (archives and serves reads, ignores a forged
read, a late joiner polls), of test_apollo_round4.py's
test_ro_replica_archives_to_s3_process (an RO process archiving over
SigV4 to the port's S3TestServer, every object equal to replica 0's
block from its kvlog file), a reference RO process following a port
cluster with the same archive, a v4 four-process cluster that orders
writes and catches up a replica restarted on a ledger provisioned by the
snapshot CLI (chip_smoke.py's v4_cluster at a small size), and the
divergence of the port's RO replica: its staged chain and archive are
the same bytes with its window digests on the device route or on the
host."""
import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from tpubft_torch import device
from tpubft_torch.apps import skvbc
from tpubft_torch.consensus import messages as m
from tpubft_torch.crypto.cpu import Ed25519Signer
from tpubft_torch.kvbc import KeyValueBlockchain, create_blockchain
from tpubft_torch.kvbc.readonly import (ReadOnlyReplica, archive_key,
                                        digest_key)
from tpubft_torch.statetransfer.manager import StConfig
from tpubft_torch.storage import MemoryDB
from tpubft_torch.storage.native import NativeDB
from tpubft_torch.storage.objectstore import (FsObjectStore,
                                              InMemoryObjectStore)
from tpubft_torch.storage.s3 import S3ObjectStore
from tpubft_torch.testing import network
from tpubft_torch.testing.cluster import InProcessCluster
from tpubft_torch.testing.network import BftTestNetwork
from tpubft_torch.testing.s3server import S3TestServer
from tpubft_torch.utils.config import ReplicaConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERRIDES = dict(checkpoint_window_size=5, work_window_size=10,
                 fast_path_timeout_ms=150, crypto_backend="cpu")


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    """This process's tensors on the CPU (one intra-op thread: several
    test workers share the host's cores), and the replica processes'
    too."""
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    device.set_default_device("cpu")
    yield
    device.set_default_device(None)


def _skvbc_factory(_r=None):
    return skvbc.SkvbcHandler(
        KeyValueBlockchain(MemoryDB(), use_device_hashing=False))


def _cluster(num_ro=1):
    return InProcessCluster(f=1, handler_factory=_skvbc_factory,
                            cfg_overrides=dict(OVERRIDES,
                                               num_ro_replicas=num_ro))


def _ro(cluster, idx=0, store=None, **st):
    ro_id = cluster.n + idx
    cfg = ReplicaConfig(replica_id=ro_id, f_val=1, num_of_client_proxies=2,
                        num_ro_replicas=cluster.first_client_id - cluster.n,
                        **{k: v for k, v in OVERRIDES.items()
                           if k != "num_ro_replicas"})
    return ReadOnlyReplica(cfg, cluster.keys.for_node(ro_id),
                           cluster.bus.create(ro_id), object_store=store,
                           st_cfg=StConfig(retry_timeout_s=0.3, **st))


def _write(kv, n, tag=b"k"):
    for i in range(n):
        assert kv.write([(b"%s%d" % (tag, i), b"v%d" % i)],
                        timeout_ms=8000).success


def _until(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def _read_request(cluster, cid, seq, keys, forged=False):
    req = m.ClientRequestMsg(
        sender_id=cid, req_seq_num=seq, flags=int(m.RequestFlag.READ_ONLY),
        request=skvbc.pack(skvbc.ReadRequest(read_version=skvbc.READ_LATEST,
                                             keys=keys)),
        cid="ro-read", signature=bytes(64))
    if not forged:
        signer = Ed25519Signer.generate(
            seed=cluster.keys.for_node(cid).my_sign_seed)
        req.signature = signer.sign(req.signed_payload())
    return req.pack()


def test_ro_replica_archives_and_serves_reads():
    """A 4-replica cluster orders writes past a checkpoint; the RO replica
    anchors on f+1 signed checkpoints, fetches the chain, archives every
    block with verifiable integrity (equal to replica 0's raw blocks and
    digests), answers a signed READ_ONLY request from its own state, and
    ignores a forged one."""
    store = InMemoryObjectStore()
    with _cluster() as cluster:
        ro = _ro(cluster, store=store)
        ro.start()
        try:
            client = cluster.client(0)
            client.start()
            _write(skvbc.SkvbcClient(client), 7)   # crosses checkpoint 5
            assert _until(lambda: ro.archived_to >= 5), "RO never archived"
            assert ro.blockchain.last_block_id >= 5
            ok, bad = ro.verify_archive()
            assert bad == 0 and ok >= 5
            h0 = cluster.handlers[0].blockchain
            for b in range(1, ro.archived_to + 1):
                assert store.get(archive_key(b)) == h0.get_raw_block(b)
                assert store.get(digest_key(b)) == h0.block_digest(b)
            # the second client id: the writer's stray replies must not
            # race into this sink
            cid = cluster.first_client_id + 1
            got = []

            class _Sink:
                def on_new_message(self, sender, data):
                    got.append((sender, data))
            sink = cluster.bus.create(cid)
            sink.start(_Sink())
            sink.send(ro.id, _read_request(cluster, cid, 1, [b"k1"]))
            assert _until(lambda: got, 10), "RO never answered the read"
            reply = m.unpack(got[0][1])
            assert dict(skvbc.unpack(reply.reply).reads)[b"k1"] == b"v1"
            assert reply.current_primary == 0xFFFFFFFF
            reads = lambda: ro.aggregator.get(  # noqa: E731
                "ro_replica", "counters", "served_reads")
            assert reads() == 1
            sink.send(ro.id, _read_request(cluster, cid, 2, [b"k1"],
                                           forged=True))
            time.sleep(0.4)
            assert reads() == 1 and len(got) == 1
        finally:
            ro.stop()


def test_late_joining_ro_replica_polls_for_checkpoint():
    """An RO replica started after the cluster's last checkpoint
    broadcast anchors by asking (AskForCheckpointMsg)."""
    with _cluster() as cluster:
        client = cluster.client(0)
        client.start()
        _write(skvbc.SkvbcClient(client), 7)
        ro = _ro(cluster)
        ro.ASK_CHECKPOINT_PERIOD_S = 0.5
        ro.start()
        try:
            assert _until(lambda: ro.blockchain.last_block_id >= 5, 20)
            assert ro.last_anchor >= 5
        finally:
            ro.stop()


def test_ro_chain_and_archive_equal_with_device_digests_on_or_off():
    """Two RO replicas follow one cluster, one with its window digests on
    the device route (the plain SHA-256 on CPU tensors here; on a card,
    the kernel) and one on hashlib: equal staged chains, archives and
    digests, and only the first counts device windows."""
    stores = [InMemoryObjectStore(), InMemoryObjectStore()]
    with _cluster(num_ro=2) as cluster:
        ros = [_ro(cluster, 0, stores[0], use_device_digests=True,
                   device_digest_threshold=2),
               _ro(cluster, 1, stores[1], use_device_digests=False)]
        for ro in ros:
            ro.start()
        try:
            client = cluster.client(0)
            client.start()
            _write(skvbc.SkvbcClient(client), 12)   # crosses checkpoint 10
            assert _until(lambda: min(r.archived_to for r in ros) >= 10)
            head = min(r.archived_to for r in ros)
            for b in range(1, head + 1):
                raws = {r.blockchain.get_raw_block(b) for r in ros}
                assert len(raws) == 1
                assert stores[0].get(archive_key(b)) == \
                    stores[1].get(archive_key(b)) == raws.pop()
                assert stores[0].get(digest_key(b)) == \
                    stores[1].get(digest_key(b))
            batches = [r.aggregator.get("state_transfer", "counters",
                                        "device_digest_batches") or 0
                       for r in ros]
            assert batches[0] > 0 and batches[1] == 0
        finally:
            for ro in ros:
                ro.stop()


def test_ro_replica_takes_the_device():
    """On the CPU the ledger and the transfer hash on the host, as the
    reference; asked for a card where there is none, NoDevice."""
    cluster = _cluster()            # keys and a bus; never started
    cfg = ReplicaConfig(replica_id=cluster.n, f_val=1,
                        num_of_client_proxies=2, num_ro_replicas=1)
    ro = ReadOnlyReplica(cfg, cluster.keys.for_node(cluster.n),
                         cluster.bus.create(cluster.n))
    assert ro.device.type == "cpu"
    assert not ro.blockchain._use_device
    assert not ro.state_transfer._use_device
    if not torch.cuda.is_available():
        with pytest.raises(device.NoDevice):
            ReadOnlyReplica(cfg, cluster.keys.for_node(cluster.n),
                            cluster.bus.create(cluster.n), device="cuda")


def test_ro_replica_process_refuses_the_prometheus_endpoint():
    """--prom-port is refused with the ROADMAP step that ports it, before
    anything is built; --prom-host is not an option of the port's."""
    from tpubft_torch.apps import ro_replica
    from tpubft_torch.utils.metrics import Aggregator
    p = ro_replica.make_parser()
    args = p.parse_args(["--replica", "4", "--prom-port", "0"])
    with pytest.raises(NotImplementedError, match="A.9.5"):
        ro_replica.build_ro_replica(args, Aggregator())
    with pytest.raises(SystemExit):
        p.parse_args(["--replica", "4", "--prom-host", "0.0.0.0"])


# ---------------- processes ----------------

def _load(kvs, per_client, tag, deadline_s=120):
    """Each client writes `per_client` keys in its own thread -> {key:
    value} of the acknowledged writes."""
    acked, errors = {}, []
    lock = threading.Lock()

    def work(i):
        try:
            for j in range(per_client):
                k, v = b"%s-%d-%d" % (tag, i, j), b"v-%d-%d" % (i, j)
                if kvs[i].write([(k, v)],
                                timeout_ms=int(deadline_s * 1000)).success:
                    with lock:
                        acked[k] = v
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)
    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(kvs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[:3]
    assert len(acked) == per_client * len(kvs)
    return acked


def _equal_last_executed(net, replicas, timeout=60.0):
    def same():
        le = [net.last_executed(r) for r in replicas]
        return None not in le and len(set(le)) == 1 and le
    return net.wait_for(same, timeout=timeout)


def _archived_to(net, rid):
    return net.metrics(rid).get("ro_replica", "gauges", "archived_to") or 0


def _follow(net, rids, kvs, acked, upto):
    """Write until every RO in `rids` has archived block `upto` (the
    checkpoints it anchors on come with the writes)."""
    deadline = time.monotonic() + 120
    rounds = 0
    while min(_archived_to(net, r) for r in rids) < upto:
        assert time.monotonic() < deadline, \
            [_archived_to(net, r) for r in rids]
        acked.update(_load(kvs, 1, b"f%d" % rounds))
        rounds += 1


def _audit(store, db_path):
    """Every archived block and digest object against replica 0's kvlog
    file -> the blocks audited."""
    db = NativeDB(db_path)
    try:
        bc = KeyValueBlockchain(db, use_device_hashing=False)
        keys = list(store.list("blocks/"))
        for key in keys:
            b = int(key.split("/")[1])
            assert store.get(key) == bc.get_raw_block(b), b
            assert store.get(digest_key(b)) == bc.block_digest(b), b
        assert keys == [archive_key(b) for b in range(1, len(keys) + 1)]
        return len(keys)
    finally:
        db.close()


def test_ro_replica_process_archives_to_s3(tmp_path):
    """An RO replica process (`start_ro_replica`, --device cpu) follows a
    four-process cluster on kvlog files and archives over SigV4 to the
    port's S3TestServer; an independent S3 client finds every archived
    block and digest equal to replica 0's from its file."""
    with S3TestServer(access_key="port-ak", secret_key="port-sk") as s3:
        net = BftTestNetwork(f=1, num_clients=2, num_ro=1, device="cpu",
                             seed="port-ro-s3", checkpoint_window=5,
                             work_window=10, db_dir=str(tmp_path))
        try:
            net.start_all(timeout=180)
            rid = net.start_ro_replica(
                0, extra_args=["--s3-endpoint", s3.endpoint,
                               "--s3-bucket", "archive",
                               "--s3-access-key", "port-ak"],
                extra_env={"TPUBFT_S3_SECRET": "port-sk"})
            assert rid == 4
            net.wait_for_replicas_up(replicas=[rid], timeout=120)
            kvs = [net.skvbc_client(i) for i in range(2)]
            acked = _load(kvs, 4, b"s3")
            _follow(net, [rid], kvs, acked, 5)
            snap = net.metrics(rid).snapshot()["components"]
            assert snap["ro_replica"]["gauges"]["last_anchor_seq"] >= 5
            assert snap["state_transfer"]["counters"][
                "device_digest_batches"] == 0
            assert snap["udp"]["counters"]["netio_fallbacks"] == 0
            assert json.loads(net.status(rid, "device"))["device"] == "cpu"
        finally:
            net.stop_all()
        audit = S3ObjectStore(s3.endpoint, "archive", access_key="port-ak",
                              secret_key="port-sk")
        assert _audit(audit, str(tmp_path / "replica-0.kvlog")) >= 5
    assert os.path.exists(tmp_path / "ro-4.log")


def test_reference_ro_process_follows_a_port_cluster(tmp_path):
    """The JAX package's tpubft.apps.ro_replica (on the CPU) and the
    port's follow one cluster of port replica processes: both archives
    hold the same objects, each equal to replica 0's block from its
    file."""
    net = BftTestNetwork(f=1, num_clients=2, num_ro=2, device="cpu",
                         seed="port-ro-mixed", checkpoint_window=5,
                         work_window=10, db_dir=str(tmp_path))
    dirs = [str(tmp_path / "archive-port"), str(tmp_path / "archive-ref")]
    try:
        net.start_all(timeout=180)
        net.start_ro_replica(0, extra_args=["--archive-dir", dirs[0]])
        net.procs[5] = subprocess.Popen(
            [sys.executable, "-m", "tpubft.apps.ro_replica",
             "--replica", "5", "--f", "1", "--ro", "2", "--clients", "2",
             "--base-port", str(net.base_port),
             "--metrics-port", str(net.metrics_base + 5),
             "--seed", net.seed, "--checkpoint-window", "5",
             "--archive-dir", dirs[1]],
            env=dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu"),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        net.wait_for_replicas_up(replicas=[4, 5], timeout=120)
        kvs = [net.skvbc_client(i) for i in range(2)]
        acked = _load(kvs, 4, b"mx")
        _follow(net, [4, 5], kvs, acked, 5)
    finally:
        net.stop_all()
    stores = [FsObjectStore(d) for d in dirs]
    upto = min(len(list(s.list("blocks/"))) for s in stores)
    assert upto >= 5
    for b in range(1, upto + 1):
        assert stores[0].get(archive_key(b)) == stores[1].get(archive_key(b))
    assert _audit(stores[0], str(tmp_path / "replica-0.kvlog")) >= 5
    assert _audit(stores[1], str(tmp_path / "replica-0.kvlog")) >= 5


def _snapshot_cli(*argv):
    out = subprocess.run(
        [sys.executable, "-m", "tpubft_torch.tools.snapshot", *argv,
         "--kvbc-version", "v4"], capture_output=True, text=True,
        timeout=120, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


def test_v4_process_cluster_catches_up_a_snapshot_provisioned_replica(
        tmp_path):
    """Four replica processes with --kvbc-version v4 on kvlog files:
    writes commit and read back. Replica 3 is SIGKILLed while the others
    go past its work window; the port's snapshot CLI snapshots its file
    (create, verify, restore with digest_ok into a fresh file, which
    takes its place), and replica 3 restarts on the provisioned ledger:
    without the consensus metadata the snapshot leaves out, it starts at
    last_executed 0 and catches up by state transfer, fetching no block
    of the snapshot. The four files hold equal v4 chains with every
    acknowledged write."""
    net = BftTestNetwork(f=1, num_clients=3, seed="port-v4", device="cpu",
                         checkpoint_window=5, work_window=10,
                         db_dir=str(tmp_path), kvbc_version="v4")
    path = str(tmp_path / "replica-3.kvlog")
    snap = str(tmp_path / "replica-3.snap")
    try:
        net.start_all(timeout=180)
        kvs = [net.skvbc_client(i) for i in range(3)]
        acked = _load(kvs, 3, b"a")
        assert kvs[0].read(sorted(acked), timeout_ms=60000) == acked
        le = _equal_last_executed(net, range(4))
        net.kill_replica(3)
        acked.update(_load(kvs, 8, b"b"))
        stable = min(net.metrics(r).get("replica", "gauges",
                                        "last_stable_seq") for r in range(3))
        assert stable > le[3] + net.work_window
        made = _snapshot_cli("create", path, snap)
        assert made["head_block"] == 9 and made["entries"] > 0
        assert _snapshot_cli("verify", snap)["ok"] is True
        assert _snapshot_cli("restore", snap, path + ".new")["digest_ok"]
        os.replace(path + ".new", path)
        net.start_replica(3)
        assert net.first_answer(3, timeout=180)[0] == 0
        fetched = lambda: net.metrics(3).get(  # noqa: E731
            "state_transfer", "counters", "blocks_fetched") or 0
        deadline = time.monotonic() + 180
        rounds = 0
        while fetched() == 0 or (net.last_executed(3) or 0) < stable:
            assert time.monotonic() < deadline, "replica 3 never caught up"
            acked.update(_load(kvs, 1, b"c%d" % rounds))
            rounds += 1
        _equal_last_executed(net, range(4), timeout=120)
        assert kvs[1].read(sorted(acked), timeout_ms=60000) == acked
        assert 0 < fetched() <= len(acked) - made["head_block"]
    finally:
        net.stop_all()
    files = network.ledger_files(str(tmp_path), range(4), version="v4")
    assert set(files["last_block_id"].values()) == {len(acked)}
    assert files["first_unequal_block"] is None
    db = NativeDB(path)
    try:
        bc = create_blockchain(db, version="v4")
        for k, v in acked.items():
            assert bc.get_latest("kv", k)[1] == v
    finally:
        db.close()
