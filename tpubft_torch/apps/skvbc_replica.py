"""SKVBC TesterReplica — one OS-process KVBC replica (port of
tpubft/apps/skvbc_replica.py).

Rebuild of concord-bft tests/simpleKVBC/TesterReplica/main.cpp:192:
a standalone replica process running the SimpleKVBC state machine over
the categorized blockchain, a UDP metrics server for the system-test
harness to poll, a diagnostics admin server, and (optionally) a
byzantine communication-wrapping strategy for fault-injection tests
(TesterReplica/strategy/ + WrapCommunication.cpp).

Run:  python -m tpubft_torch.apps.skvbc_replica --replica 0 --f 1 \\
          --base-port 3710 --metrics-port 4710 [--diag-port P] \\
          [--seed S] [--device cuda|cpu]

Port divergences (reference skvbc_replica.py:27-193):
- `--device cuda|cpu` (default cuda) picks where the port's tensors live
  before anything is built; without a card and without `--device cpu`
  the process exits non-zero with NoDevice before it serves.
- `--crypto-backend` takes cuda|cpu|auto and defaults to cuda (the
  reference's default is cpu).
- The ledger lives in memory. The options of planes the port does not
  carry yet are refused with the ROADMAP step that ports them:
  `--db-dir` (A.9.2), `--kvbc-version v4` (A.9.3), `--trs-port`,
  `--pre-execution` (A.9.4), `--prom-port` (A.9.5) and `--fault-port`
  (A.9.6).
- The UDP transport's netio counters (comm/udp.METRICS) are published
  beside the replica's own components.
- `status get device` also reports ops/ecdsa.COUNTS (the RLC path's
  launches a curve).
"""
from __future__ import annotations

import argparse
import errno
import json
import os
import sys
import time

from tpubft_torch.apps.simple_test import (add_device_args, add_scheme_args,
                                           endpoint_table, select_device)
from tpubft_torch.comm import CommConfig, create_communication
from tpubft_torch.consensus.keys import ClusterKeys
from tpubft_torch.consensus.replica import _not_ported
from tpubft_torch.kvbc.replica import KvbcReplica
from tpubft_torch.utils.config import ReplicaConfig
from tpubft_torch.utils.metrics import Aggregator, UdpMetricsServer


def refuse_unported(args) -> None:
    """Port divergence: refuse, before anything is built, every option
    whose plane is not ported yet, naming its ROADMAP step."""
    for flag, on, step in (
            ("--db-dir", args.db_dir is not None, "A.9.2"),
            ("--kvbc-version v4", args.kvbc_version != "categorized",
             "A.9.3"),
            ("--trs-port", args.trs_port is not None, "A.9.4"),
            ("--pre-execution", args.pre_execution, "A.9.4"),
            ("--prom-port", args.prom_port is not None, "A.9.5"),
            ("--fault-port", args.fault_port is not None, "A.9.6")):
        if on:
            _not_ported(flag, step)


def build_replica(args, comm_wrapper=None) -> KvbcReplica:
    refuse_unported(args)
    kw = dict(replica_id=args.replica, f_val=args.f, c_val=args.c,
              num_ro_replicas=args.ro,
              num_of_client_proxies=args.clients,
              view_change_timer_ms=args.view_change_timeout_ms,
              crypto_backend=args.crypto_backend,
              pre_execution_enabled=args.pre_execution,
              checkpoint_window_size=args.checkpoint_window,
              work_window_size=args.work_window,
              kvbc_version=args.kvbc_version,
              threshold_scheme=args.threshold_scheme,
              client_sig_scheme=args.client_sig_scheme)
    if args.device_min_verify_batch is not None:
        kw["device_min_verify_batch"] = args.device_min_verify_batch
    # generic overrides win over flag-mapped fields (applied last)
    from tpubft_torch.utils.config import parse_config_overrides
    kw.update(parse_config_overrides(getattr(args, "config_override",
                                             None)))
    cfg = ReplicaConfig(**kw)
    keys = ClusterKeys.generate(cfg, args.clients,
                                seed=args.seed.encode()).for_node(args.replica)
    from tpubft_torch.consensus.replicas_info import ReplicasInfo
    eps = endpoint_table(args.base_port, cfg.n_val + args.ro, args.clients,
                         operator_id=ReplicasInfo.from_config(cfg).operator_id)
    if args.transport in ("tls", "tls-mux"):
        from tpubft_torch.comm.multiplex import client_floor
        from tpubft_torch.comm.tls import TlsConfig
        comm_cfg = TlsConfig(self_id=args.replica, endpoints=eps,
                             certs_dir=args.certs_dir,
                             key_password=os.environ.get(
                                 "TPUBFT_TLS_KEY_PASSWORD"),
                             mux_client_floor=(
                                 client_floor(cfg.n_val, args.ro)
                                 if args.transport == "tls-mux" else None))
    else:
        comm_cfg = CommConfig(self_id=args.replica, endpoints=eps)
    comm = create_communication(comm_cfg, args.transport)
    if comm_wrapper is not None:
        # byzantine strategies that re-sign mutated messages (equivocate)
        # get the replica's own signing key — the reference's strategies
        # likewise live inside the tester replica, key in hand
        comm = comm_wrapper(comm, signer=keys.my_signer()
                            if keys.my_sign_seed else None)
    agg = Aggregator()
    from tpubft_torch.comm import udp
    agg.register(udp.METRICS)
    handler_factory = None
    if getattr(args, "merkle", False):
        # provable state for the thin-replica serving tier: kv lives in
        # a BLOCK_MERKLE category so every read has an audit path
        from tpubft_torch.apps.skvbc import SkvbcHandler
        handler_factory = lambda bc: SkvbcHandler(bc, merkle=True)  # noqa: E731
    return KvbcReplica(cfg, keys, comm, db_path=None, aggregator=agg,
                       handler_factory=handler_factory)


def device_status() -> str:
    """`status get device`: where this process's tensors live, the bytes
    its CUDA caching allocator holds, and each kernel wrapper's launch
    count since the process started (every wrapper counts where it
    launches its kernel), and the RLC path's launches a curve."""
    import torch

    from tpubft_torch import device
    from tpubft_torch.ops import (bls12_381_cuda, ecdsa, ecdsa_cuda,
                                  ed25519_cuda, sha256_cuda)
    dev = device.default_device()
    return json.dumps({
        "device": str(dev),
        "memory_reserved": (torch.cuda.memory_reserved(dev)
                            if dev.type == "cuda" else 0),
        "launches": {**ed25519_cuda.LAUNCHES, **sha256_cuda.LAUNCHES,
                     **bls12_381_cuda.LAUNCHES, **ecdsa_cuda.LAUNCHES},
        "ecdsa_rlc_by_curve": ecdsa.COUNTS},
        sort_keys=True)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SKVBC tester replica")
    p.add_argument("--replica", type=int, required=True)
    p.add_argument("--f", type=int, default=1)
    p.add_argument("--c", type=int, default=0)
    p.add_argument("--ro", type=int, default=0,
                   help="read-only replicas in the topology")
    p.add_argument("--clients", type=int, default=4)
    p.add_argument("--base-port", type=int, default=3710)
    p.add_argument("--metrics-port", type=int, default=0)
    p.add_argument("--trs-port", type=int, default=None,
                   help="thin-replica streaming port (not ported: A.9.4)")
    p.add_argument("--diag-port", type=int, default=None,
                   help="diagnostics admin server port (0 = ephemeral)")
    p.add_argument("--prom-port", type=int, default=None,
                   help="Prometheus /metrics HTTP port (not ported: A.9.5)")
    p.add_argument("--db-dir", default=None,
                   help="persistent ledger directory (not ported: A.9.2; "
                        "the ledger lives in memory)")
    p.add_argument("--seed", default="tpubft-skvbc")
    p.add_argument("--transport", default="udp",
                   choices=("udp", "tcp", "tls", "tls-mux"))
    p.add_argument("--certs-dir", default=None,
                   help="TLS material dir (node-<id>.key/.crt)")
    p.add_argument("--view-change-timeout-ms", type=int, default=4000)
    p.add_argument("--strategy", default=None,
                   help="byzantine strategy name (testing)")
    p.add_argument("--device-min-verify-batch", type=int, default=None,
                   help="batches below this verify per-principal instead "
                        "of via the cross-principal device dispatch "
                        "(default: ReplicaConfig's crossover)")
    p.add_argument("--config-override", action="append", default=[],
                   metavar="FIELD=VALUE",
                   help="set any ReplicaConfig field (repeatable); the "
                        "generic escape hatch so new tunables reach "
                        "process clusters without a dedicated flag")
    # Port divergence (reference skvbc_replica.py:121-122: choices
    # cpu|tpu|auto, default cpu): the port's device backend is cuda, and
    # its entry points run on the card unless the caller asks for the CPU
    p.add_argument("--crypto-backend", default="cuda",
                   choices=("cuda", "cpu", "auto"))
    p.add_argument("--pre-execution", action="store_true",
                   help="not ported: A.9.4")
    p.add_argument("--merkle", action="store_true",
                   help="keep SKVBC state in a BLOCK_MERKLE category "
                        "(provable reads)")
    p.add_argument("--fault-port", type=int, default=None,
                   help="per-link fault-injection control port (not "
                        "ported: A.9.6)")
    p.add_argument("--checkpoint-window", type=int, default=150)
    p.add_argument("--work-window", type=int, default=300)
    # v1 (direct-KV) is deliberately NOT offered here (reference
    # skvbc_replica.py:143-146); v4 is not ported (A.9.3)
    p.add_argument("--kvbc-version", default="categorized",
                   choices=("categorized", "v4"))
    add_scheme_args(p)
    add_device_args(p)
    return p


def main() -> None:
    from tpubft_torch.utils.logging import configure
    configure()                       # level from TPUBFT_LOG (default warn)
    if os.environ.get("TPUBFT_PROFILE_DIR"):
        # profiling runs need a GRACEFUL stop on SIGTERM so the
        # dispatcher's pstats dump happens; normal runs keep the
        # default hard exit (harness timing)
        import signal

        def _term(_sig, _frm):
            raise SystemExit(0)
        signal.signal(signal.SIGTERM, _term)
    args = make_parser().parse_args()
    select_device(args.device)
    comm_wrapper = None
    if args.strategy:
        from tpubft_torch.testing.byzantine import strategy_wrapper
        comm_wrapper = strategy_wrapper(args.strategy)
    kr = build_replica(args, comm_wrapper)
    metrics = diag = None
    try:
        metrics = UdpMetricsServer(kr.replica.aggregator,
                                   port=args.metrics_port)
        metrics.start()
        if args.diag_port is not None:
            from tpubft_torch.diagnostics import DiagnosticsServer
            from tpubft_torch.utils import flight
            # `status get kernels` (the device sections' calls and
            # times) and `device` beside the replica's own `health`,
            # `durability`, `tuning`
            flight.install_diagnostics()
            from tpubft_torch.diagnostics import get_registrar
            get_registrar().register_status("device", device_status)
            diag = DiagnosticsServer(port=args.diag_port)
            diag.start()
        kr.start()
    except OSError as exc:
        if exc.errno != errno.EADDRINUSE:
            raise
        # a port of the cluster's range is taken: exit with that code,
        # which testing/network.BftTestNetwork retries on a new range
        print(f"skvbc replica {args.replica}: {exc}", file=sys.stderr,
              flush=True)
        os._exit(errno.EADDRINUSE)
    diag_note = f", diag {diag.port}" if diag is not None else ""
    print(f"skvbc replica {args.replica} up (metrics {metrics.port}"
          f"{diag_note})", flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        kr.stop()
        metrics.stop()
        if diag is not None:
            diag.stop()


if __name__ == "__main__":
    main()
