"""simpleTest: 4 replicas + 1 client over UDP localhost (port of
tpubft/apps/simple_test.py).

Rebuild of concord-bft tests/simpleTest/ (scripts/testReplicasAndClient.sh
+ simpleTest.py CLI): the smallest real-deployment exercise — each replica
is its own OS process bound to a UDP port, a client drives counter
increments and validates replies, then everything shuts down.

Usage:
  python -m tpubft_torch.apps.simple_test [--device cpu]   # orchestrate
  python -m tpubft_torch.apps.simple_test --replica N ...  # one replica

Port divergence (reference simple_test.py:161-175): `--device cuda|cpu`
(default cuda) picks where the port's tensors live before anything is
built, the counterpart of the reference's JAX_PLATFORMS; without a card
and without `--device cpu` a replica exits non-zero with NoDevice before
it serves. The orchestrator passes its `--device` on to every replica
and puts the port's own tree first on their PYTHONPATH.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Tuple

from tpubft_torch.apps import counter as counter_app
from tpubft_torch.bftclient import BftClient, ClientConfig
from tpubft_torch.comm import CommConfig, PlainUdpCommunication
from tpubft_torch.consensus.keys import ClusterKeys
from tpubft_torch.consensus.replica import Replica
from tpubft_torch.utils.config import ReplicaConfig
from tpubft_torch.utils.metrics import Aggregator, UdpMetricsServer

# the directory that holds the tpubft_torch package: child processes
# import the port from the same tree as their parent
PORT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def endpoint_table(base_port: int, n: int, num_clients: int,
                   operator_id: int = None) -> Dict[int, Tuple[str, int]]:
    eps = {r: ("127.0.0.1", base_port + r) for r in range(n)}
    for i in range(num_clients):
        eps[n + i] = ("127.0.0.1", base_port + n + i)
    if operator_id is not None:
        # the operator principal is addressable too (reconfiguration
        # commands over the real transport)
        eps[operator_id] = ("127.0.0.1", base_port + operator_id)
    return eps


def add_scheme_args(ap) -> None:
    """Crypto-scheme flags shared by every cluster binary (replica,
    TesterClient): client and replica processes must generate matching
    keys, so the flag names and defaults live in ONE place — against a
    cluster running non-default schemes (config 3/5: ecdsa clients,
    threshold BLS) a mismatched client is rejected on every request."""
    ap.add_argument("--threshold-scheme", default="multisig-ed25519")
    ap.add_argument("--client-sig-scheme", default="ed25519")


def add_device_args(ap) -> None:
    """Port divergence: where the port's tensors live (the reference
    picks its JAX platform from JAX_PLATFORMS)."""
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default) needs a card and exits with "
                         "NoDevice without one; cpu runs the kernels' "
                         "plain versions on CPU tensors")


def select_device(name: str) -> None:
    """Set the process-wide device before anything is built; for "cuda"
    resolve it now, so a host without a card fails here (NoDevice)
    rather than after the process has started serving."""
    from tpubft_torch import device
    if name == "cpu":
        device.set_default_device("cpu")
    else:
        device.set_default_device(None)
        device.default_device()


def child_env(extra: Dict[str, str] = None) -> Dict[str, str]:
    """The environment of a process this package spawns: the port's own
    tree first on PYTHONPATH (so a checkout that is not installed, such
    as a `git archive` of the repo, runs as it is)."""
    path = os.environ.get("PYTHONPATH", "")
    return dict(os.environ, PYTHONPATH=PORT_ROOT + (os.pathsep + path
                                                    if path else ""),
                **(extra or {}))


def run_replica(args) -> None:
    cfg = ReplicaConfig(replica_id=args.replica, f_val=args.f,
                        num_of_client_proxies=args.clients)
    keys = ClusterKeys.generate(cfg, args.clients,
                                seed=args.seed.encode()).for_node(args.replica)
    eps = endpoint_table(args.base_port, cfg.n_val, args.clients)
    comm = PlainUdpCommunication(CommConfig(self_id=args.replica, endpoints=eps))
    agg = Aggregator()
    rep = Replica(cfg, keys, comm, counter_app.CounterHandler(),
                  aggregator=agg)
    metrics = UdpMetricsServer(agg, port=args.metrics_port)
    metrics.start()
    rep.start()
    print(f"replica {args.replica} up (udp {eps[args.replica][1]}, "
          f"metrics {metrics.port})", flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        rep.stop()
        metrics.stop()


def _wait_for_metrics(ports: List[int], timeout_s: float,
                      procs: List[subprocess.Popen] = ()) -> bool:
    """Poll each replica's UDP metrics server until it answers (readiness
    gate — on small machines concurrent process startup is slow). Gives
    up early when a replica process has exited."""
    import socket
    deadline = time.monotonic() + timeout_s
    pending = set(ports)
    while pending and time.monotonic() < deadline:
        if any(p.poll() is not None for p in procs):
            return False
        for port in list(pending):
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.settimeout(0.3)
            try:
                s.sendto(b"ping", ("127.0.0.1", port))
                s.recvfrom(65536)
                pending.discard(port)
            except OSError:
                pass
            finally:
                s.close()
        if pending:
            time.sleep(0.2)
    return not pending


def run_orchestrator(args) -> int:
    cfg = ReplicaConfig(f_val=args.f, num_of_client_proxies=args.clients)
    n = cfg.n_val
    metrics_base = args.metrics_base_port or args.base_port + 100
    procs: List[subprocess.Popen] = []
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tpubft_torch.apps.simple_test",
                 "--replica", str(r), "--f", str(args.f),
                 "--base-port", str(args.base_port),
                 "--clients", str(args.clients), "--seed", args.seed,
                 "--metrics-port", str(metrics_base + r),
                 "--device", args.device], env=child_env()))
        if not _wait_for_metrics([metrics_base + r for r in range(n)],
                                 timeout_s=120, procs=procs):
            print("replicas failed to become ready")
            return 1
        keys = ClusterKeys.generate(cfg, args.clients, seed=args.seed.encode())
        client_id = n
        eps = endpoint_table(args.base_port, n, args.clients)
        comm = PlainUdpCommunication(CommConfig(self_id=client_id,
                                                endpoints=eps))
        client = BftClient(ClientConfig(client_id=client_id, f_val=args.f,
                                        request_timeout_ms=30000),
                           keys.for_node(client_id), comm)
        total = 0
        t0 = time.perf_counter()
        for i in range(args.ops):
            total += i + 1
            got = counter_app.decode_reply(
                client.send_write(counter_app.encode_add(i + 1)))
            if got != total:
                print(f"MISMATCH at op {i}: got {got}, want {total}")
                return 1
        dt = time.perf_counter() - t0
        read = counter_app.decode_reply(
            client.send_read(counter_app.encode_read()))
        client.stop()
        ok = read == total
        print(json.dumps({
            "ok": ok, "ops": args.ops, "final": read,
            "throughput_ops_sec": round(args.ops / dt, 1),
            "mean_latency_ms": round(1000 * dt / args.ops, 2),
        }))
        return 0 if ok else 1
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def main() -> int:
    from tpubft_torch.utils.logging import configure
    configure()                       # level from TPUBFT_LOG (default warn)
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--replica", type=int, default=None,
                    help="run a single replica with this id (internal)")
    ap.add_argument("--f", type=int, default=1)
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--base-port", type=int, default=3710)
    ap.add_argument("--metrics-port", type=int, default=0)
    ap.add_argument("--metrics-base-port", type=int, default=0)
    ap.add_argument("--ops", type=int, default=50)
    ap.add_argument("--seed", default="tpubft-simple-test")
    add_device_args(ap)
    args = ap.parse_args()
    if args.replica is not None:
        select_device(args.device)
        run_replica(args)
        return 0
    return run_orchestrator(args)


if __name__ == "__main__":
    sys.exit(main())
