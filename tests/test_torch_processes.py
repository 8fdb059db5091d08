"""One OS process a replica: the port's entry points (apps/simple_test,
apps/skvbc_replica, apps/tester_client) and its process cluster
(testing/network.BftTestNetwork) on this host's CPU (`--device cpu`:
the cuda backend's wrappers run their plain versions on CPU tensors),
held to what tests/test_skvbc_processes.py holds the reference to, plus
clusters over TCP, TLS and tls-mux, clusters of reference and port
replicas over UDP and over TLS (the direct wire check), clusters on
persistent ledgers (`db_dir`: a replica and the whole cluster SIGKILLed
and restarted on their kvlog files, and a reference replica's file taken
up by a port replica), the UDP metrics server's reply against the
reference's, and the refusals of the planes not ported yet. Every test waits on state under
its own deadline and kills its processes in a `finally`."""
import errno
import json
import os
import random
import re
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch

from tpubft_torch.apps import skvbc_replica
from tpubft_torch.testing import network
from tpubft_torch.testing.network import BftTestNetwork

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread_children(monkeypatch):
    """The replica processes run their few tensor ops on one intra-op
    thread each: several test workers and four processes a cluster share
    the host's cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=ROOT, **extra)
    env.pop("JAX_PLATFORMS", None)
    return env


def _run_group(cmd, timeout, env=None):
    """Run `cmd` in its own session; on the deadline kill the whole
    group (an orchestrator's replicas with it). -> CompletedProcess."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT,
                            env=env or _env(), start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"{cmd[2:4]} ran past {timeout} s:\n{err}")
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except OSError:
            pass
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def _free_base(ports_of):
    for _ in range(200):
        base = random.randint(20000, 50000)
        if network.ports_free(ports_of(base)):
            return base
    raise OSError(errno.EADDRINUSE, "no free port range")


def _load(kvs, per_client, tag, deadline_s=120):
    """Each client writes `per_client` keys in its own thread: ->
    {key: value} of the acknowledged writes."""
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


def _commit(kv, key, value, timeout_ms=8000, tries=6):
    for _ in range(tries):
        try:
            if kv.write([(key, value)], timeout_ms=timeout_ms).success:
                return True
        except Exception:  # noqa: BLE001 — retried, as the reference's
            pass
    return False


def test_thin_replica_stream_over_processes(tmp_path):
    """The counterpart of tests/test_apollo_round4.py:237: a
    ThinReplicaClient over the four replica processes' `--trs-port`
    servers reads the state with a hash quorum, then subscribes and sees
    the committed updates live, confirmed by f+1 servers."""
    from tpubft_torch.thinreplica.client import ThinReplicaClient

    net = BftTestNetwork(f=1, num_clients=2, seed="port-trs", device="cpu",
                         db_dir=str(tmp_path))
    try:
        net.start_all(timeout=180)
        kv = net.skvbc_client(0)
        assert _commit(kv, b"t0", b"v0")
        eps = [("127.0.0.1", net.trs_base + r) for r in range(net.n)]
        trc = ThinReplicaClient(eps, f_val=1)
        assert trc.read_state().get(b"t0") == b"v0"
        got = []
        evt = threading.Event()

        def on_update(block_id, kvs):
            got.extend(kvs)
            if any(k == b"t2" for k, _ in kvs):
                evt.set()

        trc.subscribe(on_update, start_block=1)
        try:
            assert _commit(kv, b"t1", b"v1")
            assert _commit(kv, b"t2", b"v2")
            assert evt.wait(30), f"updates never streamed: {got}"
            keys = {k for k, _ in got}
            assert b"t1" in keys and b"t2" in keys
        finally:
            trc.stop()
    finally:
        net.stop_all()


def test_thin_replica_check_of_the_card_phase_over_processes(tmp_path):
    """chip_smoke.py's thin-replica check (`_TrsCheck`, which the card's
    process_cluster phase runs) on four CPU replica processes with the
    SKVBC state in its BLOCK_MERKLE category: replica 3 the client's
    first data source; every acknowledged write streamed at its block,
    no gap and no duplicate; replica 3 SIGKILLed, the client's
    generation rises and delivery goes on through the writes after it,
    with replica 3 restarted empty and caught up; an anchor at or past
    the stable checkpoint under f+1 signed checkpoints, verified reads
    equal to the acknowledged values, a historical read, an absent key;
    pushed runs on every replica, the proofs counted, no overflow."""
    thin_replica_check("cpu", str(tmp_path))


def thin_replica_check(device: str, log_dir: str) -> dict:
    """The body of the thin-replica process tests, on `device` ("cpu"
    here, "cuda" in tests/test_torch_cuda.py): -> each replica's device
    status, read before the network stops."""
    import json
    smoke = _chip_smoke()
    net = BftTestNetwork(f=1, num_clients=3, seed="port-trs-check",
                         device=device, checkpoint_window=5,
                         work_window=10, merkle=True, log_dir=log_dir,
                         device_min_verify_batch=1 if device == "cuda"
                         else None)
    trs = None
    try:
        net.start_all(timeout=180)
        from tpubft_torch import testing
        kvs = [net.skvbc_client(i) for i in range(3)]
        writes = smoke._KvbcbenchWrites(kvs, testing.kvbcbench_rows(8),
                                        timeout_ms=60000)
        loop = smoke._ClosedLoop(3, writes)
        trs = smoke._TrsCheck(net, writes, first=3)
        trs.subscribe(os.path.join(log_dir, "stream.jsonl"))
        assert loop.run(lambda n: n >= 24, budget_s=120)["committed"] >= 24
        first = trs.streamed(kvs[0])
        assert first["writes_checked"] >= 24 and first["generations"] == 0
        generation = trs.generation
        killed_at = time.monotonic()
        net.kill_replica(3)
        assert loop.run(lambda n: n >= 30, budget_s=120)["committed"] >= 30
        assert trs.rotated(generation) > generation
        net.start_replica(3)
        net.wait_for_replicas_up(timeout=180, replicas=[3])
        # a restarted replica catches up only while writes go on
        deadline = time.monotonic() + 240
        while not (net.metrics(3).get("state_transfer", "counters",
                                      "blocks_fetched") or 0) \
                or not net.last_executed(3):
            assert time.monotonic() < deadline, "replica 3 never caught up"
            loop.run(lambda n: n >= 6, budget_s=120)
        assert not loop.errors, loop.errors
        _equal_last_executed(net, range(4))
        stream = trs.streamed(kvs[0], killed_at=killed_at)
        assert stream["blocks_streamed"] == stream["head"]
        assert stream["writes_checked"] == len(writes.log)
        # the writes acknowledged between the kill and the next
        # generation are the rotation's, apart from the steady lag
        rotation = stream["rotation"]
        assert rotation["kill_to_next_generation_ms"] > 0
        assert stream["delivery_lag_ms"]["writes"] + rotation["writes"] \
            == len(writes.log)
        reads = trs.anchored_reads(server_replica=0, reads=5)
        assert reads["wrong"] == 0 and reads["absent_is_none"]
        assert reads["anchor_checkpoint"] >= reads["stable_checkpoint"]
        per = trs.metrics(range(4))
        assert all(m["trs_pushed_runs"] > 0 for m in per.values()), per
        assert sum(m["trs_proofs"] for m in per.values()) >= 7, per
        assert not any(m["trs_overflows"] for m in per.values()), per
        return {r: json.loads(net.status(r, "device")) for r in range(4)}
    finally:
        if trs is not None:
            trs.stop()
        net.stop_all()


def _chip_smoke():
    """chip_smoke.py, imported from the checkout's root."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_simple_test_orchestrator_on_cpu():
    """python -m tpubft_torch.apps.simple_test --device cpu: four counter
    replica processes over UDP and a client, every reply checked."""
    base = _free_base(lambda b: list(range(b, b + 6))
                      + list(range(b + 100, b + 104)))
    out = _run_group([sys.executable, "-m", "tpubft_torch.apps.simple_test",
                      "--device", "cpu", "--ops", "12",
                      "--base-port", str(base)], timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["ok"] is True
    assert summary["final"] == sum(range(1, 13))


def test_four_process_cluster_write_read_restart_catch_up(tmp_path):
    """Four port replica processes over UDP: writes from three clients, a
    read-back, equal last_executed; replica 3 killed, the cluster goes on
    past its stable checkpoint; replica 3 restarted with empty state
    catches up by state transfer (its window digests through the plain
    SHA-256 on CPU tensors) while the load goes on, as the reference's
    harness needs, and all four end at the same last_executed. Then the
    tester client process runs its checked workload against the cluster."""
    net = BftTestNetwork(f=1, num_clients=5, seed="port-proc",
                         device="cpu", checkpoint_window=5, work_window=10,
                         log_dir=str(tmp_path))
    try:
        net.start_all(timeout=180)
        assert set(net.start_s) == {0, 1, 2, 3}
        kvs = [net.skvbc_client(i) for i in range(3)]
        acked = _load(kvs, 5, b"a")
        assert kvs[0].read(sorted(acked), timeout_ms=60000) == acked
        _equal_last_executed(net, range(4))

        net.kill_replica(3)
        up = (0, 1, 2)
        acked.update(_load(kvs, 8, b"b"))
        stable = [net.metrics(r).get("replica", "gauges", "last_stable_seq")
                  for r in up]
        assert min(stable) >= 2 * net.work_window, stable

        net.start_replica(3)
        net.wait_for_replicas_up(timeout=180, replicas=[3])
        fetched = lambda: net.metrics(3).get(  # noqa: E731
            "state_transfer", "counters", "blocks_fetched") or 0
        deadline = time.monotonic() + 180
        rounds = 0
        while fetched() == 0 or not net.last_executed(3):
            assert time.monotonic() < deadline, "replica 3 never caught up"
            acked.update(_load(kvs, 1, b"c%d" % rounds))
            rounds += 1
        le = _equal_last_executed(net, range(4), timeout=120)
        assert le[3] >= 2 * net.work_window
        assert kvs[1].read(sorted(acked), timeout_ms=60000) == acked

        kernels = json.loads(net.status(3, "kernels"))
        assert kernels["sha256"]["calls"] > 0, kernels
        assert json.loads(net.status(3, "device"))["device"] == "cpu"
        snap = net.metrics(3).snapshot()["components"]
        assert snap["udp"]["counters"]["netio_fallbacks"] == 0
        assert snap["signature_manager"]["counters"][
            "degraded_verifies"] == 0
        health = json.loads(net.status(3, "health"))
        assert health["verdict"] == "healthy", health

        out = _run_group(
            [sys.executable, "-m", "tpubft_torch.apps.tester_client",
             "--f", "1", "--clients", "5", "--client-idx", "3",
             "--concurrency", "2", "--ops", "12",
             "--base-port", str(net.base_port), "--seed", net.seed],
            timeout=180)
        assert out.returncode == 0, out.stdout + out.stderr
        summary = json.loads(out.stdout.strip().splitlines()[-1])
        assert summary["ok"] and summary["ops_ok"] == 12, summary
    finally:
        net.stop_all()
    assert all(p.poll() is not None for p in net.procs.values())


def test_four_process_cluster_over_tcp():
    net = BftTestNetwork(f=1, num_clients=2, seed="port-tcp", device="cpu",
                         transport="tcp")
    try:
        net.start_all(timeout=180)
        kv = net.skvbc_client(0)
        acked = _load([kv], 4, b"t")
        assert kv.read(sorted(acked), timeout_ms=60000) == acked
        _equal_last_executed(net, range(4))
    finally:
        net.stop_all()


@pytest.mark.parametrize("transport", ["tls", "tls-mux"])
def test_four_process_cluster_over_tls(transport):
    """Four port replica processes and two clients over TLS (and the
    endpoint multiplexer over TLS): writes commit, read back, and the
    four last_executed agree; the network's material is gone after
    stop_all."""
    net = BftTestNetwork(f=1, num_clients=2, seed=f"port-{transport}",
                         device="cpu", transport=transport)
    certs = net.certs_dir
    try:
        net.start_all(timeout=180)
        kvs = [net.skvbc_client(i) for i in range(2)]
        acked = _load(kvs, 3, b"s")
        assert kvs[1].read(sorted(acked), timeout_ms=60000) == acked
        _equal_last_executed(net, range(4))
    finally:
        net.stop_all()
    assert not os.path.exists(certs) and net.certs_dir is None


@pytest.mark.parametrize("transport", ["tls", "tls-mux"])
def test_network_writes_tls_material_for_every_principal(transport):
    """BftTestNetwork(transport=tls|tls-mux) writes a key and a
    certificate for the replicas, the clients and the operator (as the
    reference's network does under db_dir/tls), passes --certs-dir to
    every replica, and removes the material in stop_all."""
    net = BftTestNetwork(f=1, num_clients=3, device="cpu",
                         transport=transport)
    try:
        ids = sorted(int(name[5:-4]) for name in os.listdir(net.certs_dir)
                     if name.endswith(".crt"))
        assert ids == [0, 1, 2, 3, 4, 5, 6, net._operator_id()]
        for i in ids:
            assert os.path.exists(os.path.join(net.certs_dir,
                                               f"node-{i}.key"))
        comm = net._make_comm(4, {i: ("127.0.0.1", 1) for i in ids})
        assert type(comm).__name__ == ("TlsTcpCommunication"
                                       if transport == "tls"
                                       else "MultiplexTransport")
    finally:
        certs = net.certs_dir
        net.stop_all()
    assert not os.path.exists(certs)


def test_network_keeps_tls_material_under_db_dir(tmp_path, monkeypatch):
    """With db_dir the TLS material goes under db_dir/tls, as the
    reference's network writes it, a replica is spawned with --db-dir
    and --certs-dir there and logs to db_dir/replica-<id>.log, and
    stop_all leaves the material in place."""
    spawned = []

    class Exited:
        returncode = 0

        def __init__(self, args, **_kw):
            spawned.append(args)

        def poll(self):
            return 0

        def wait(self, timeout=None):
            return 0
    monkeypatch.setattr(network.subprocess, "Popen", Exited)
    net = BftTestNetwork(f=1, num_clients=2, device="cpu", transport="tls",
                         db_dir=str(tmp_path))
    try:
        assert net.certs_dir == str(tmp_path / "tls")
        assert os.path.exists(tmp_path / "tls" / "node-0.crt")
        net.start_replica(2)
        args = spawned[0]
        assert args[args.index("--db-dir") + 1] == str(tmp_path)
        assert args[args.index("--certs-dir") + 1] == str(tmp_path / "tls")
        assert os.path.exists(tmp_path / "replica-2.log")
    finally:
        net.stop_all()
    assert net.certs_dir == str(tmp_path / "tls")
    assert sorted(os.listdir(tmp_path / "tls"))[:2] == ["node-0.crt",
                                                       "node-0.key"]


def _spawn_reference(net, r, db_dir=None):
    """A replica of the JAX package's tpubft.apps.skvbc_replica on the
    CPU, on the port network's ports, seed and transport (over TLS with
    the material the port network wrote), on `db_dir` when given."""
    cmd = [sys.executable, "-m", "tpubft.apps.skvbc_replica",
           "--replica", str(r), "--f", str(net.f),
           "--clients", str(net.num_clients),
           "--base-port", str(net.base_port),
           "--metrics-port", str(net.metrics_base + r), "--seed", net.seed,
           "--crypto-backend", "cpu",
           "--checkpoint-window", str(net.checkpoint_window),
           "--work-window", str(net.work_window),
           "--view-change-timeout-ms", str(net.view_change_timeout_ms),
           "--transport", net.transport]
    if net.transport in ("tls", "tls-mux"):
        cmd += ["--certs-dir", net.certs_dir]
    if db_dir is not None:
        cmd += ["--db-dir", db_dir]
    net.procs[r] = subprocess.Popen(
        cmd, env=dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu"),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def test_mixed_cluster_of_reference_and_port_replicas():
    """Replicas 0-1 from the JAX package, 2-3 from the port, port
    clients, all over UDP: every write commits (a quorum needs both
    packages), reads agree from every client, and all four replicas end
    at the same last_executed."""
    _mixed_cluster("udp")


def test_mixed_cluster_of_reference_and_port_replicas_over_tls():
    """The same over TLS: the reference's replicas load the certificates
    and keys the port's network wrote, and every pair of the two
    packages completes its handshakes both ways."""
    _mixed_cluster("tls")


def _mixed_cluster(transport):
    net = BftTestNetwork(f=1, num_clients=2, seed=f"port-mixed-{transport}",
                         device="cpu", checkpoint_window=5, work_window=10,
                         transport=transport)
    try:
        network.build_libraries("cpu")
        for r in (0, 1):
            _spawn_reference(net, r)
        for r in (2, 3):
            net.start_replica(r)
        net.wait_for_replicas_up(timeout=180)
        kvs = [net.skvbc_client(i) for i in range(2)]
        acked = _load(kvs, 8, b"m")
        for kv in kvs:
            assert kv.read(sorted(acked), timeout_ms=60000) == acked
        le = _equal_last_executed(net, range(4))
        assert le[0] >= 16
    finally:
        net.stop_all()


def test_persistent_replica_restarts_from_its_own_file(tmp_path):
    """The counterpart of tests/test_skvbc_processes.py:58 on the port:
    four replica processes on persistent DBs (`db_dir`); replica 3 is
    SIGKILLed, the others go past its work window, and replica 3
    restarts on its own kvlog file: its first metrics read is the
    last_executed it had before the kill (not 0), it catches up by state
    transfer fetching only the blocks it missed, and the keys written
    before, during and after the kill read back."""
    net = BftTestNetwork(f=1, num_clients=3, seed="port-persist",
                         device="cpu", checkpoint_window=5, work_window=10,
                         db_dir=str(tmp_path))
    try:
        net.start_all(timeout=180)
        kvs = [net.skvbc_client(i) for i in range(3)]
        acked = _load(kvs, 4, b"before")
        le = _equal_last_executed(net, range(4))
        before = le[3]
        assert before > 0

        net.kill_replica(3)
        during = _load(kvs, 8, b"during")
        acked.update(during)
        stable = [net.metrics(r).get("replica", "gauges", "last_stable_seq")
                  for r in (0, 1, 2)]
        assert min(stable) > before + net.work_window, (stable, before)

        net.start_replica(3)
        assert net.first_answer(3, timeout=180)[0] == before
        fetched = lambda: net.metrics(3).get(  # noqa: E731
            "state_transfer", "counters", "blocks_fetched") or 0
        deadline = time.monotonic() + 180
        rounds = 0
        while fetched() == 0 or (net.last_executed(3) or 0) < min(stable):
            assert time.monotonic() < deadline, "replica 3 never caught up"
            acked.update(_load(kvs, 1, b"c%d" % rounds))
            rounds += 1
        _equal_last_executed(net, range(4), timeout=120)
        after = _load(kvs, 2, b"after")
        acked.update(after)
        _equal_last_executed(net, range(4), timeout=120)
        assert kvs[2].read(sorted(acked), timeout_ms=60000) == acked
        # it fetched what it missed, never the blocks it kept: at most
        # the writes committed while it was down or catching up
        missed = len(acked) - 12
        assert 0 < fetched() <= missed, (fetched(), missed)
    finally:
        net.stop_all()
    assert all(p.poll() is not None for p in net.procs.values())
    files = network.ledger_files(str(tmp_path), range(4))
    assert set(files["last_block_id"].values()) == {len(acked)}
    assert files["first_unequal_block"] is None


def test_persistent_cluster_comes_back_from_a_whole_cluster_sigkill(
        tmp_path):
    """All four replica processes SIGKILLed at once and restarted on
    their kvlog files: each resumes from its persisted last_executed,
    every acknowledged write (and the last of every client) reads back,
    and the cluster orders writes again to equal last_executed."""
    net = BftTestNetwork(f=1, num_clients=3, seed="port-persist-all",
                         device="cpu", checkpoint_window=5, work_window=10,
                         db_dir=str(tmp_path))
    try:
        net.start_all(timeout=180)
        kvs = [net.skvbc_client(i) for i in range(3)]
        acked = _load(kvs, 6, b"a")
        le = _equal_last_executed(net, range(4))
        for r in range(4):
            net.procs[r].send_signal(signal.SIGKILL)
        for r in range(4):
            net.kill_replica(r)
        for r in range(4):
            net.start_replica(r)
        assert [net.first_answer(r, timeout=180)[0] for r in range(4)] == le
        net.wait_for_replicas_up(timeout=180)
        assert kvs[0].read(sorted(acked), timeout_ms=60000) == acked
        last = {b"a-%d-5" % i: b"v-%d-5" % i for i in range(3)}
        assert kvs[1].read(sorted(last), timeout_ms=60000) == last
        more = _load(kvs, 3, b"b")
        acked.update(more)
        le2 = _equal_last_executed(net, range(4), timeout=120)
        assert le2[0] > le[0]
        assert kvs[2].read(sorted(acked), timeout_ms=60000) == acked
    finally:
        net.stop_all()
    files = network.ledger_files(str(tmp_path), range(4))
    assert set(files["last_block_id"].values()) == {len(acked)}
    assert files["first_unequal_block"] is None


def test_reference_replica_file_taken_up_by_a_port_replica(tmp_path):
    """Replica 3 runs as a reference process (the JAX package's
    skvbc_replica) on `db_dir`, orders writes with three port replicas,
    is SIGKILLed and restarts as a port process on the same kvlog file:
    it resumes from the reference's persisted last_executed and the
    cluster orders writes again, every key reading back."""
    net = BftTestNetwork(f=1, num_clients=2, seed="port-persist-mixed",
                         device="cpu", checkpoint_window=5, work_window=10,
                         db_dir=str(tmp_path))
    try:
        network.build_libraries("cpu")
        _spawn_reference(net, 3, db_dir=str(tmp_path))
        for r in (0, 1, 2):
            net.start_replica(r)
        net.wait_for_replicas_up(timeout=180)
        kvs = [net.skvbc_client(i) for i in range(2)]
        acked = _load(kvs, 5, b"ref")
        le = _equal_last_executed(net, range(4))
        net.kill_replica(3)
        net.start_replica(3)
        assert net.first_answer(3, timeout=180)[0] == le[3] > 0
        acked.update(_load(kvs, 5, b"port"))
        le2 = _equal_last_executed(net, range(4), timeout=120)
        assert le2[3] > le[3]
        assert kvs[1].read(sorted(acked), timeout_ms=60000) == acked
    finally:
        net.stop_all()
    files = network.ledger_files(str(tmp_path), range(4))
    assert set(files["last_block_id"].values()) == {len(acked)}
    assert files["first_unequal_block"] is None


def test_start_all_retries_once_on_a_taken_port():
    net = BftTestNetwork(f=1, num_clients=1, seed="port-retry",
                         device="cpu")
    first = net.base_port
    squat = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    squat.bind(("127.0.0.1", net.metrics_base + 2))
    try:
        net.start_all(timeout=180)
        assert net.base_port != first
        _equal_last_executed(net, range(4))
    finally:
        squat.close()
        net.stop_all()


def test_udp_metrics_server_replies_as_the_reference():
    from tpubft.utils import metrics as ref_metrics
    from tpubft_torch.utils import metrics as port_metrics
    servers, replies = [], {}
    try:
        for name, m in (("port", port_metrics), ("ref", ref_metrics)):
            agg = m.Aggregator()
            for comp in ("replica", "signature_manager"):
                c = m.Component(comp, agg)
                for i in range(3):
                    c.register_counter(f"c{i}").inc(7 * i + len(comp))
                    c.register_gauge(f"g{i}", 3 - i)
                c.register_status("verdict", "healthy")
            srv = m.UdpMetricsServer(agg)
            srv.start()
            servers.append(srv)
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.settimeout(10)
            got = []
            for ask in (b"metrics", b"ping"):
                s.sendto(ask, ("127.0.0.1", srv.port))
                got.append(re.sub(rb'"ts": [0-9.e+-]+', b'"ts": 0',
                                  s.recvfrom(1 << 20)[0]))
            s.close()
            replies[name] = got
    finally:
        for srv in servers:
            srv.stop()
    assert replies["port"] == replies["ref"]
    assert json.loads(replies["port"][0])["components"]["replica"][
        "counters"]["c2"] == 21


def test_metrics_client_drops_datagrams_from_other_senders():
    """A datagram from another sender that reaches the polling socket
    first (a consensus message for a killed replica whose port the
    socket was given) is dropped, and the server's reply is read; a
    poll with no reply returns None at its timeout."""
    server = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    server.bind(("127.0.0.1", 0))
    server.settimeout(10)
    stray = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    reply = json.dumps({"components": {"replica": {"gauges": {
        "last_executed_seq": 7}}}}).encode()

    def serve():
        ask, client = server.recvfrom(64)
        assert ask == b"metrics"
        stray.sendto(bytes(range(0xd0, 0x100)), client)
        time.sleep(0.05)
        server.sendto(reply, client)
    t = threading.Thread(target=serve)
    t.start()
    mc = network.MetricsClient(server.getsockname()[1])
    try:
        assert mc.get("replica", "gauges", "last_executed_seq",
                      timeout=10) == 7
    finally:
        t.join()
        stray.close()
        server.close()
    t0 = time.monotonic()
    assert mc.snapshot(timeout=0.2) is None
    assert time.monotonic() - t0 < 5


@pytest.mark.parametrize("module", ["tpubft_torch.apps.skvbc_replica",
                                    "tpubft_torch.apps.simple_test"])
def test_replica_without_a_card_exits_with_no_device(module):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    base = _free_base(lambda b: list(range(b, b + 6)) + [b + 1000])
    out = _run_group([sys.executable, "-m", module, "--replica", "0",
                      "--base-port", str(base),
                      "--metrics-port", str(base + 1000)], timeout=120)
    assert out.returncode != 0
    assert "NoDevice" in out.stderr
    assert "up (" not in out.stdout
    assert network.MetricsClient(base + 1000).snapshot(0.3) is None


@pytest.mark.parametrize("phase", ["process_cluster", "persistent_cluster",
                                   "tls_cluster", "merkle"])
def test_cluster_ab_without_a_card_exits_with_no_result(phase):
    """tools/cluster_ab.py runs a checkout's cluster phase (or, with
    --merkle, process_cluster's first load in BLOCK_MERKLE) on the card
    only: without one it exits 2 and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    what = ["--merkle"] if phase == "merkle" else ["--phase", phase]
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tpubft_torch", "tools",
                                      "cluster_ab.py"),
         "--tree", ROOT, *what, "--clients", "4"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_skvbc_replica_takes_kvbc_version_v4_and_not_v1():
    """--kvbc-version v4 parses and passes refuse_unported; v1, a
    migration source only, is not a choice (as in the reference)."""
    p = skvbc_replica.make_parser()
    args = p.parse_args(["--replica", "0", "--kvbc-version", "v4"])
    assert args.kvbc_version == "v4"
    skvbc_replica.refuse_unported(args)
    with pytest.raises(SystemExit):
        p.parse_args(["--replica", "0", "--kvbc-version", "v1"])


def test_skvbc_replica_takes_trs_port():
    """--trs-port (the read tier, ported) parses, passes refuse_unported
    and reaches the replica's thin-replica port."""
    args = skvbc_replica.make_parser().parse_args(
        ["--replica", "0", "--trs-port", "0"])
    assert args.trs_port == 0
    skvbc_replica.refuse_unported(args)


# The ids are the ones these cases had while --trs-port was refused too
# (as argv0): each case keeps its test's name. --pre-execution (A.9.4b)
# is ported: its case, a step of None, shows the option taken.
@pytest.mark.parametrize("argv, step", [
    pytest.param(["--pre-execution"], None, id="argv1-A.9.4"),
    pytest.param(["--prom-port", "0"], "A.9.5", id="argv2-A.9.5"),
    pytest.param(["--fault-port", "0"], "A.9.6", id="argv3-A.9.6"),
])
def test_skvbc_replica_refuses_unported_options(argv, step):
    args = skvbc_replica.make_parser().parse_args(["--replica", "0"] + argv)
    if step is None:
        skvbc_replica.refuse_unported(args)
        assert args.pre_execution
        return
    with pytest.raises(NotImplementedError, match=re.escape(step)):
        skvbc_replica.refuse_unported(args)


@pytest.mark.parametrize("argv, step", [
    pytest.param(["--pre-execution"], None, id="argv0-A.9.4"),
    (["--prom-port", "0"], "A.9.5"),
    (["--fault-port", "0"], "A.9.6"),
])
def test_skvbc_replica_process_still_refuses_unported_options(argv, step):
    """A replica process given an option of a plane not ported yet
    (the read tier's --trs-port is ported) exits non-zero with
    NotImplementedError naming the option's step, before it serves. With
    --pre-execution (ported) it comes up with its preprocessor built:
    its metrics carry the preprocessor's counters."""
    if step is None:
        preexecution_replica_comes_up(argv)
        return
    out = _run_group([sys.executable, "-m", "tpubft_torch.apps.skvbc_replica",
                      "--replica", "0", "--device", "cpu"] + argv,
                     timeout=120)
    assert out.returncode != 0
    assert "NotImplementedError" in out.stderr and step in out.stderr, \
        out.stderr[-2000:]
    assert "up (" not in out.stdout


def preexecution_replica_comes_up(argv) -> None:
    """One replica process with `argv` on this CPU: it answers its
    metrics, and they hold the preprocessor's `preexec_sessions`; then it
    is killed."""
    base = _free_base(lambda b: [b + i for i in range(8)] + [b + 1000])
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpubft_torch.apps.skvbc_replica",
         "--replica", "0", "--device", "cpu", "--crypto-backend", "cpu",
         "--base-port", str(base), "--metrics-port", str(base + 1000)]
        + argv, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True, cwd=ROOT, env=_env(), start_new_session=True)
    try:
        deadline = time.monotonic() + 120
        snap = None
        while snap is None:
            assert proc.poll() is None, proc.stderr.read()[-2000:]
            assert time.monotonic() < deadline, "the replica never answered"
            snap = network.MetricsClient(base + 1000).snapshot(timeout=0.5)
        counters = snap["components"]["preexec"]["counters"]
        assert counters["preexec_sessions"] == 0
    finally:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


@pytest.mark.parametrize("kw", [
    pytest.param(dict(pre_execution=True), id="kw0-A.9.4"),
])
def test_network_refuses_unported_options(kw):
    """BftTestNetwork's options (the name and id kept from when
    pre-execution was refused; no option is refused now):
    `pre_execution=True` puts --pre-execution on every replica's command
    line, and a network without it puts it on none."""
    net = BftTestNetwork(device="cpu", **kw)
    assert all("--pre-execution" in net.replica_argv(r)
               for r in range(net.n))
    assert not any("--pre-execution" in BftTestNetwork(
        device="cpu").replica_argv(r) for r in range(4))


@pytest.mark.parametrize("call, step", [
    (lambda n: n.drop_link(0, 1), "A.9.6"),
    (lambda n: n.isolate_replica(0), "A.9.6"),
    (lambda n: n.deafen_replica(0), "A.9.6"),
    (lambda n: n.set_loss(0, 0.1), "A.9.6"),
    (lambda n: n.set_delay(0, 5.0), "A.9.6"),
    (lambda n: n.heal(), "A.9.6"),
    (lambda n: n.operator_client(), "A.9.4"),
])
def test_network_refuses_unported_planes(call, step):
    net = BftTestNetwork(device="cpu")
    with pytest.raises(NotImplementedError, match=re.escape(step)):
        call(net)
    assert not net.procs


def config5_storm(device: str, cycles: int = 3) -> None:
    """BASELINE config 5 (tests/test_apollo_extended.py:183): ECDSA-P256
    client signatures, threshold-BLS commit certificates and the TLS
    transport under a view-change storm, on four port replica processes.
    Each cycle pauses the current primary (read from the replicas'
    metrics); the next write commits only after a view change deposes
    it, and the paused replica resumes as a backup. Port divergence:
    the reference kills primaries and restarts them on their `db_dir`;
    the port refuses `db_dir` until A.9.2 (a restarted replica starts
    empty), so the storm pauses them with SIGSTOP, as
    benchmarks/bench_e2e.py's config-5 storm does."""
    net = BftTestNetwork(f=1, num_clients=1, seed="port-config5",
                         device=device, transport="tls",
                         threshold_scheme="threshold-bls",
                         client_sig_scheme="ecdsa-p256",
                         view_change_timeout_ms=2000)

    def view():
        views = [net.current_view(r) for r in range(net.n)
                 if r not in net.paused]
        return max(v for v in views if v is not None)
    try:
        net.start_all(timeout=180)
        kv = net.skvbc_client(0)
        written = {}
        for i in range(cycles + 1):
            if i:
                before = view()
                net.pause_replica(before % net.n)
            key, value = b"v%d" % i, b"%d" % (i + 1)
            assert kv.write([(key, value)], timeout_ms=120000).success
            written[key] = value
            if i:
                assert view() > before
                net.resume_replica(before % net.n)
        assert kv.read(sorted(written), timeout_ms=60000) == written
        _equal_last_executed(net, range(net.n), timeout=120)
    finally:
        net.stop_all()


@pytest.mark.slow
def test_config5_ecdsa_bls_tls_view_change_storm():
    config5_storm("cpu")
