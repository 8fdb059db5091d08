"""One OS process a replica: the port's entry points (apps/simple_test,
apps/skvbc_replica, apps/tester_client) and its process cluster
(testing/network.BftTestNetwork) on this host's CPU (`--device cpu`:
the cuda backend's wrappers run their plain versions on CPU tensors),
held to what tests/test_skvbc_processes.py holds the reference to, plus
clusters over TCP, TLS and tls-mux, clusters of reference and port
replicas over UDP and over TLS (the direct wire check), the UDP metrics
server's reply against the reference's, and the refusals of the planes
not ported yet. Every test waits on state under
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


def _spawn_reference(net, r):
    """A replica of the JAX package's tpubft.apps.skvbc_replica on the
    CPU, on the port network's ports, seed and transport (over TLS with
    the material the port network wrote)."""
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


@pytest.mark.parametrize("argv, step", [
    (["--db-dir", "/nonexistent"], "A.9.2"),
    (["--kvbc-version", "v4"], "A.9.3"),
    (["--trs-port", "0"], "A.9.4"),
    (["--pre-execution"], "A.9.4"),
    (["--prom-port", "0"], "A.9.5"),
    (["--fault-port", "0"], "A.9.6"),
])
def test_skvbc_replica_refuses_unported_options(argv, step):
    args = skvbc_replica.make_parser().parse_args(["--replica", "0"] + argv)
    with pytest.raises(NotImplementedError, match=re.escape(step)):
        skvbc_replica.refuse_unported(args)


@pytest.mark.parametrize("kw, step", [
    (dict(db_dir="/nonexistent"), "A.9.2"),
    (dict(pre_execution=True), "A.9.4"),
])
def test_network_refuses_unported_options(kw, step):
    with pytest.raises(NotImplementedError, match=re.escape(step)):
        BftTestNetwork(device="cpu", **kw)


@pytest.mark.parametrize("call, step", [
    (lambda n: n.drop_link(0, 1), "A.9.6"),
    (lambda n: n.isolate_replica(0), "A.9.6"),
    (lambda n: n.deafen_replica(0), "A.9.6"),
    (lambda n: n.set_loss(0, 0.1), "A.9.6"),
    (lambda n: n.set_delay(0, 5.0), "A.9.6"),
    (lambda n: n.heal(), "A.9.6"),
    (lambda n: n.start_ro_replica(), "A.9.4"),
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
