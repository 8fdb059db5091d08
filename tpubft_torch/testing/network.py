"""BftTestNetwork — the system-test harness running REAL replica
processes (port of tpubft/testing/network.py).

Rebuild of the reference's Apollo core (concord-bft tests/apollo/
util/bft.py:233 BftTestNetwork): each replica is an OS subprocess of the
actual SKVBC tester replica (subprocess.Popen, bft.py:818), driven from
the test through real UDP clients, observed through each replica's UDP
metrics server (bft_metrics.py) and diagnostics server, and
fault-injected by killing/restarting processes and by pausing them with
SIGSTOP/SIGCONT (a stopped process neither sends nor receives, which is
exactly a partition from the cluster's viewpoint).

Port divergences (reference network.py:70-491):
- `device=` ("cuda", the default, or "cpu") goes to every replica as
  `--device`, and `crypto_backend` defaults to "cuda" (the reference's
  to "cpu"); the port's own tree is first on the replicas' PYTHONPATH.
- `start_all` builds every library a replica loads (netio, and on the
  card the CUDA kernels) once in this process before it spawns the
  replicas, so that they do not all run the compilers at once.
- Without `base_port`, the base is drawn so that every UDP and TCP port
  the cluster uses binds free; a replica that still meets EADDRINUSE
  exits with that code, and `start_all` then retries once on a new base.
- Replicas run without `--fault-port` and `--trs-port`; the per-link
  faults (A.9.6), `start_ro_replica` (A.9.4) and `operator_client`
  (A.9.4) raise NotImplementedError, as does `db_dir` (A.9.2).
- The TLS transports keep their material in a temporary directory that
  the network owns (the reference keeps it under `db_dir/tls`), written
  again when a stopped network starts.
"""
from __future__ import annotations

import errno
import json
import os
import random
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
import weakref
from typing import Dict, List, Optional

from tpubft_torch.apps.simple_test import child_env, endpoint_table
from tpubft_torch.apps.skvbc import SkvbcClient
from tpubft_torch.bftclient import BftClient, ClientConfig
from tpubft_torch.comm import CommConfig, create_communication
from tpubft_torch.consensus.keys import ClusterKeys
from tpubft_torch.consensus.replica import _not_ported
from tpubft_torch.utils.config import ReplicaConfig


class MetricsClient:
    """Polls a replica's UDP metrics server (reference bft_metrics.py)."""

    def __init__(self, port: int, host: str = "127.0.0.1") -> None:
        self.addr = (host, port)

    def snapshot(self, timeout: float = 1.0) -> Optional[dict]:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.settimeout(timeout)
        try:
            s.sendto(b"metrics", self.addr)
            data, _ = s.recvfrom(1 << 20)
            return json.loads(data.decode())
        except (OSError, json.JSONDecodeError):
            return None
        finally:
            s.close()

    def get(self, component: str, kind: str, name: str,
            timeout: float = 1.0):
        snap = self.snapshot(timeout)
        if snap is None:
            return None
        try:
            return snap["components"][component][kind][name]
        except KeyError:
            return None


def diag_status(port: int, name: str, timeout: float = 5.0,
                host: str = "127.0.0.1") -> Optional[str]:
    """`status get <name>` on a replica's diagnostics server
    (diagnostics/server.py's line protocol); None if it did not answer."""
    try:
        with socket.create_connection((host, port), timeout=timeout) as s:
            s.sendall(f"status get {name}\n".encode())
            buf = b""
            while not buf.endswith(b"\n.\n"):
                chunk = s.recv(1 << 16)
                if not chunk:
                    return None
                buf += chunk
            return buf[:-3].decode()
    except OSError:
        return None


def ports_free(ports) -> bool:
    """True when every port binds free on 127.0.0.1, UDP and TCP."""
    socks = []
    try:
        for port in ports:
            for kind in (socket.SOCK_DGRAM, socket.SOCK_STREAM):
                s = socket.socket(socket.AF_INET, kind)
                socks.append(s)
                s.bind(("127.0.0.1", port))
        return True
    except OSError:
        return False
    finally:
        for s in socks:
            s.close()


def build_libraries(device: str) -> Dict[str, float]:
    """Build, once in this process, every library a replica process
    loads: the UDP transport's netio and the secrets manager's AES
    (native/aescbc.cpp, which the TLS keys' PBES2 uses) with g++, and for
    "cuda" the kernel libraries with nvcc (one thread each) and the
    native BLS engine. -> {library: seconds}. A failed kernel or aescbc
    build raises; netio may be missing (the transport then runs its
    scalar path, counted in comm/udp.FALLBACKS)."""
    from tpubft_torch.ops import _build

    def netio():
        try:
            _build.load_host("netio")
        except _build.BuildError:
            pass
    libs = {"netio": netio, "aescbc": lambda: _build.load_host("aescbc")}
    if device != "cpu":
        from tpubft_torch.crypto import bls_native
        from tpubft_torch.ops import (bls12_381_cuda, ecdsa_cuda,
                                      ed25519_cuda, sha256_cuda)
        libs.update(ed25519_verify=ed25519_cuda.library,
                    sha256=sha256_cuda.library,
                    bls12_381_msm=bls12_381_cuda.library,
                    ecdsa=ecdsa_cuda.library,
                    bls12381_native=bls_native.available)
    return _build.build_parallel(libs)


class BftTestNetwork:
    def __init__(self, f: int = 1, c: int = 0, num_clients: int = 4,
                 num_ro: int = 0,
                 base_port: Optional[int] = None,
                 db_dir: Optional[str] = None,
                 seed: str = "apollo-net",
                 view_change_timeout_ms: int = 3000,
                 crypto_backend: str = "cuda",
                 pre_execution: bool = False,
                 checkpoint_window: int = 150,
                 work_window: int = 300,
                 transport: str = "udp",
                 threshold_scheme: str = "multisig-ed25519",
                 client_sig_scheme: str = "ed25519",
                 device_min_verify_batch: Optional[int] = None,
                 merkle: bool = False,
                 cfg_overrides: Optional[dict] = None,
                 device: str = "cuda",
                 log_dir: Optional[str] = None) -> None:
        if db_dir is not None:
            _not_ported("BftTestNetwork(db_dir=...)", "A.9.2")
        if pre_execution:
            _not_ported("BftTestNetwork(pre_execution=True)", "A.9.4")
        self.f, self.c = f, c
        self.n = 3 * f + 2 * c + 1
        self.num_ro = num_ro
        self.num_clients = num_clients
        self.seed = seed
        self.view_change_timeout_ms = view_change_timeout_ms
        self.crypto_backend = crypto_backend
        self.checkpoint_window = checkpoint_window
        self.work_window = work_window
        self.transport = transport
        self.threshold_scheme = threshold_scheme
        self.client_sig_scheme = client_sig_scheme
        self.device_min_verify_batch = device_min_verify_batch
        self.merkle = merkle     # BLOCK_MERKLE skvbc state
        # arbitrary ReplicaConfig fields, forwarded to every replica
        # process as --config-override FIELD=VALUE
        self.cfg_overrides = dict(cfg_overrides or {})
        self.device = device
        self._fixed_base = base_port is not None
        self._set_base(base_port if base_port is not None
                       else self._free_base())
        # per-replica log files (replica-<r>.log, appended across
        # restarts); None sends the replicas' output to /dev/null
        self.log_dir = log_dir
        # TLS material (see _tls_material); the directories this network
        # made, removed by stop_all and by the finalizer
        self.certs_dir: Optional[str] = None
        self._tmp_dirs: List[str] = []
        if transport in ("tls", "tls-mux"):
            self._tls_material()
        self.build_s: Dict[str, float] = {}
        self.start_s: Dict[int, float] = {}
        self._spawned_at: Dict[int, float] = {}
        self.procs: Dict[int, subprocess.Popen] = {}
        self.paused: set = set()
        self._clients: Dict[int, BftClient] = {}
        # teardown guarantee: even when a red assertion (or a crashed
        # test runner) skips __exit__/stop_all, no SIGSTOP'd or live
        # replica subprocess may outlive this harness — a stopped orphan
        # holds its ports and poisons every later test on the host. The
        # finalizer fires at GC or interpreter exit and must not hold a
        # reference to self (it would never fire), so it closes over the
        # mutable dicts only.
        self._finalizer = weakref.finalize(
            self, BftTestNetwork._reap_procs, self.procs, self.paused,
            self._tmp_dirs)

    # ------------------------------------------------------------------
    # ports
    # ------------------------------------------------------------------
    def _set_base(self, base: int) -> None:
        self.base_port = base
        self.metrics_base = base + 1000
        self.diag_base = base + 4000  # diagnostics admin servers

    def _ports(self, base: int) -> List[int]:
        """Every port the cluster binds at `base`: the replicas', the
        clients' and the operator's endpoints, the metrics and the
        diagnostics servers."""
        op_id = self._operator_id()
        nodes = self.n + self.num_ro
        return (list(range(base, base + nodes + self.num_clients))
                + [base + op_id]
                + [base + 1000 + r for r in range(nodes)]
                + [base + 4000 + r for r in range(nodes)])

    def _free_base(self, tries: int = 200) -> int:
        for _ in range(tries):
            base = random.randint(20000, 50000)
            if ports_free(self._ports(base)):
                return base
        raise OSError(errno.EADDRINUSE, "no free port range for a cluster")

    def _operator_id(self) -> int:
        from tpubft_torch.consensus.replicas_info import ReplicasInfo
        return ReplicasInfo.from_config(self._node_cfg()).operator_id

    def _tls_material(self) -> str:
        """Pinned-cert material for every principal (replicas, clients,
        operator), like keygen --tls-certs, in a temporary directory of
        this network's. Port divergence (reference network.py:108-122):
        the reference asserts `db_dir` and writes under `db_dir/tls`; the
        port refuses `db_dir` until A.9.2, so the network owns the
        directory and stop_all removes it. The ids are the endpoints'
        (clients from n + num_ro on, the reference's from n: the same
        without read-only replicas)."""
        if self.certs_dir is None:
            from tpubft_torch.comm.tls import generate_tls_material
            first_client = self.n + self.num_ro
            ids = (list(range(first_client + self.num_clients))
                   + [self._operator_id()])
            self.certs_dir = tempfile.mkdtemp(prefix="bft-tls-")
            self._tmp_dirs.append(self.certs_dir)
            generate_tls_material(self.certs_dir, ids, seed=None)
        return self.certs_dir

    @staticmethod
    def _reap_procs(procs: Dict[int, subprocess.Popen],
                    paused: set, tmp_dirs: List[str]) -> None:
        """Last-resort reaper: SIGCONT anything stopped, SIGKILL, reap;
        then remove the network's temporary directories.
        (SIGKILL does kill a stopped process, but the SIGCONT keeps the
        behavior uniform with stop_all's graceful path and unsticks any
        descendant blocked on the stopped parent.)"""
        for r, p in list(procs.items()):
            try:
                if p.poll() is None:
                    if r in paused:
                        p.send_signal(signal.SIGCONT)
                    p.kill()
            except OSError:
                pass
        for p in list(procs.values()):
            try:
                p.wait(timeout=5)
            except (subprocess.TimeoutExpired, OSError):
                pass
        paused.clear()
        for d in tmp_dirs:
            shutil.rmtree(d, ignore_errors=True)
        tmp_dirs.clear()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start_all(self, timeout: float = 120.0) -> "BftTestNetwork":
        try:
            self.build_s = build_libraries(self.device)
            for attempt in (0, 1):
                for r in range(self.n):
                    self.start_replica(r)
                try:
                    self.wait_for_replicas_up(timeout=timeout)
                    break
                except TimeoutError:
                    in_use = [r for r, p in self.procs.items()
                              if p.poll() == errno.EADDRINUSE]
                    if attempt or self._fixed_base or not in_use:
                        raise
                    # a port of the range was taken after it was drawn:
                    # once more on a new base
                    self.stop_all()
                    self.procs.clear()
                    self._set_base(self._free_base())
        except BaseException:
            # a failed startup must not leak live replica processes
            self.stop_all()
            raise
        return self

    def start_replica(self, r: int,
                      extra_args: Optional[List[str]] = None,
                      extra_env: Optional[Dict[str, str]] = None) -> None:
        assert r not in self.procs or self.procs[r].poll() is not None
        args = [sys.executable, "-m", "tpubft_torch.apps.skvbc_replica",
                "--replica", str(r), "--f", str(self.f), "--c", str(self.c),
                "--ro", str(self.num_ro),
                "--clients", str(self.num_clients),
                "--base-port", str(self.base_port),
                "--metrics-port", str(self.metrics_base + r),
                "--seed", self.seed,
                "--view-change-timeout-ms",
                str(self.view_change_timeout_ms),
                "--diag-port", str(self.diag_base + r),
                "--crypto-backend", self.crypto_backend,
                "--device", self.device,
                "--checkpoint-window", str(self.checkpoint_window),
                "--work-window", str(self.work_window),
                "--threshold-scheme", self.threshold_scheme,
                "--client-sig-scheme", self.client_sig_scheme,
                "--transport", self.transport] + (extra_args or [])
        if self.transport in ("tls", "tls-mux"):
            args += ["--certs-dir", self._tls_material()]
        if self.device_min_verify_batch is not None:
            args += ["--device-min-verify-batch",
                     str(self.device_min_verify_batch)]
        for k, v in self.cfg_overrides.items():
            args += ["--config-override", f"{k}={v}"]
        if self.merkle:
            args += ["--merkle"]
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            out = open(os.path.join(self.log_dir, f"replica-{r}.log"), "ab")
        else:
            out = subprocess.DEVNULL
        self._spawned_at[r] = time.monotonic()
        self.start_s.pop(r, None)
        self.procs[r] = subprocess.Popen(args, env=child_env(extra_env),
                                         stdout=out, stderr=out)
        if out is not subprocess.DEVNULL:
            out.close()                   # child keeps its own fd

    def start_ro_replica(self, idx: int = 0, extra_args=None,
                         extra_env=None) -> int:
        _not_ported("BftTestNetwork.start_ro_replica", "A.9.4")

    def stop_all(self) -> None:
        for r, p in list(self.procs.items()):
            if p.poll() is None:
                # SIGCONT first: a SIGTERM delivered to a stopped process
                # stays pending until it resumes — without this, every
                # paused replica rides the 5s escalation below
                if r in self.paused:
                    p.send_signal(signal.SIGCONT)
                p.send_signal(signal.SIGTERM)
        for p in list(self.procs.values()):
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
                try:
                    p.wait(timeout=5)   # actually reap — no zombies
                except subprocess.TimeoutExpired:
                    pass
        self.paused.clear()
        for cl in self._clients.values():
            try:
                cl.stop()
            except Exception:  # noqa: BLE001 — teardown must not raise
                pass
        self._clients.clear()
        for d in self._tmp_dirs:
            shutil.rmtree(d, ignore_errors=True)
        self._tmp_dirs.clear()
        self.certs_dir = None

    # ------------------------------------------------------------------
    # fault injection (Apollo kill/restart + partition analogs)
    # ------------------------------------------------------------------
    def kill_replica(self, r: int) -> None:
        """Hard crash (SIGKILL) — Apollo bft.py stop_replica."""
        p = self.procs[r]
        if p.poll() is None:
            p.send_signal(signal.SIGKILL)
            p.wait()
        self.paused.discard(r)       # a dead process is no longer paused

    def wait_exit(self, r: int, timeout: float = 30.0) -> int:
        """Block until replica r's process exits on its own."""
        return self.procs[r].wait(timeout=timeout)

    def restart_replica(self, r: int,
                        extra_args: Optional[List[str]] = None,
                        extra_env: Optional[Dict[str, str]] = None) -> None:
        """Kill and start again. Without persistent DBs (A.9.2) the new
        process starts with empty state and catches up by state
        transfer."""
        self.kill_replica(r)
        self.start_replica(r, extra_args=extra_args, extra_env=extra_env)

    def pause_replica(self, r: int) -> None:
        """SIGSTOP: the replica is partitioned from the cluster (alive,
        silent) — analog of Apollo's iptables isolation."""
        self.procs[r].send_signal(signal.SIGSTOP)
        self.paused.add(r)

    def resume_replica(self, r: int) -> None:
        self.procs[r].send_signal(signal.SIGCONT)
        self.paused.discard(r)

    # ---- per-link faults: the fault-injection plane is ROADMAP A.9.6 ----
    def drop_link(self, frm: int, to: int) -> None:
        _not_ported("BftTestNetwork.drop_link", "A.9.6")

    def isolate_replica(self, r: int, peers=None) -> None:
        _not_ported("BftTestNetwork.isolate_replica", "A.9.6")

    def deafen_replica(self, r: int) -> None:
        _not_ported("BftTestNetwork.deafen_replica", "A.9.6")

    def set_loss(self, r: int, loss: float) -> None:
        _not_ported("BftTestNetwork.set_loss", "A.9.6")

    def set_delay(self, r: int, delay_ms: float,
                  jitter_ms: float = 0.0) -> None:
        _not_ported("BftTestNetwork.set_delay", "A.9.6")

    def heal(self, r: Optional[int] = None) -> None:
        _not_ported("BftTestNetwork.heal", "A.9.6")

    # ------------------------------------------------------------------
    # observation
    # ------------------------------------------------------------------
    def metrics(self, r: int) -> MetricsClient:
        return MetricsClient(self.metrics_base + r)

    def status(self, r: int, name: str,
               timeout: float = 5.0) -> Optional[str]:
        """`status get <name>` on replica r's diagnostics server (e.g.
        "kernels", "health", "replica<r>")."""
        return diag_status(self.diag_base + r, name, timeout)

    def wait_for_replicas_up(self, timeout: float = 30.0,
                             replicas: Optional[List[int]] = None) -> None:
        """Until each replica's metrics server answers; records each
        process's start seconds (spawn to first answer) in `start_s`.
        Gives up at once when a replica process has exited."""
        pending = set(replicas if replicas is not None
                      else range(self.n)) - self.paused
        deadline = time.monotonic() + timeout
        while pending and time.monotonic() < deadline:
            for r in list(pending):
                p = self.procs.get(r)
                if p is not None and p.poll() is not None:
                    raise TimeoutError(f"replica {r} exited with code "
                                       f"{p.returncode} before it was up")
                if self.metrics(r).snapshot(timeout=0.3) is not None:
                    pending.discard(r)
                    if r in self._spawned_at:
                        self.start_s[r] = (time.monotonic()
                                           - self._spawned_at[r])
            if pending:
                time.sleep(0.2)
        if pending:
            raise TimeoutError(f"replicas never came up: {sorted(pending)}")

    def wait_for(self, predicate, timeout: float = 30.0,
                 poll: float = 0.2):
        """Apollo-style polling assertion helper."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            v = predicate()
            if v:
                return v
            time.sleep(poll)
        raise TimeoutError("condition never satisfied")

    def last_executed(self, r: int) -> Optional[int]:
        return self.metrics(r).get("replica", "gauges", "last_executed_seq")

    def current_view(self, r: int) -> Optional[int]:
        return self.metrics(r).get("replica", "gauges", "view")

    # ------------------------------------------------------------------
    # clients
    # ------------------------------------------------------------------
    def _node_cfg(self) -> ReplicaConfig:
        return ReplicaConfig(f_val=self.f, c_val=self.c,
                             num_ro_replicas=self.num_ro,
                             num_of_client_proxies=self.num_clients,
                             threshold_scheme=self.threshold_scheme,
                             client_sig_scheme=self.client_sig_scheme)

    def _make_comm(self, node_id: int, eps):
        if self.transport in ("tls", "tls-mux"):
            from tpubft_torch.comm.multiplex import client_floor
            from tpubft_torch.comm.tls import TlsConfig
            floor = (client_floor(self.n, self.num_ro)
                     if self.transport == "tls-mux" else None)
            return create_communication(
                TlsConfig(self_id=node_id, endpoints=eps,
                          certs_dir=self._tls_material(),
                          mux_client_floor=floor), self.transport)
        return create_communication(CommConfig(self_id=node_id,
                                               endpoints=eps),
                                    self.transport)

    def client(self, idx: int = 0, **cfg_kw) -> BftClient:
        client_id = self.n + self.num_ro + idx
        cl = self._clients.get(client_id)
        if cl is None:
            cfg = self._node_cfg()
            keys = ClusterKeys.generate(
                cfg, self.num_clients,
                seed=self.seed.encode()).for_node(client_id)
            eps = endpoint_table(self.base_port, self.n + self.num_ro,
                                 self.num_clients)
            comm = self._make_comm(client_id, eps)
            cl = BftClient(ClientConfig(client_id=client_id, f_val=self.f,
                                        c_val=self.c, **cfg_kw), keys, comm)
            cl.start()
            self._clients[client_id] = cl
        return cl

    def skvbc_client(self, idx: int = 0, **cfg_kw) -> SkvbcClient:
        return SkvbcClient(self.client(idx, **cfg_kw))

    def operator_client(self, **cfg_kw):
        """The reconfiguration plane's operator is ROADMAP A.9.4."""
        _not_ported("BftTestNetwork.operator_client", "A.9.4")

    def __enter__(self) -> "BftTestNetwork":
        return self.start_all()

    def __exit__(self, *exc) -> None:
        self.stop_all()
