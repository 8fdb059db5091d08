"""Read-only replica process — ledger follower/archiver (port of
tpubft/apps/ro_replica.py).

Process wrapper for tpubft_torch.kvbc.readonly.ReadOnlyReplica (the
reference of concord-bft: the RO replica TesterReplica variant used by
the Apollo RO/S3 suites): joins the cluster's network as id
n..n+num_ro-1, follows checkpoints, fetches state, archives blocks to a
filesystem or S3 object store, and serves read-only queries.

Run:  python -m tpubft_torch.apps.ro_replica --replica 4 --f 1 \\
          --base-port 3710 --archive-dir DIR [--seed S] \\
          [--device cuda|cpu] [--diag-port P]

Port divergences (reference ro_replica.py:27-131):
- `--device cuda|cpu` (default cuda) picks where the port's tensors live
  before anything is built; without a card and without `--device cpu`
  the process exits non-zero with NoDevice before it serves. On the card
  the replica digests its fetched windows there (kvbc/readonly.py).
- `--prom-port` is refused with the ROADMAP step that ports the
  Prometheus endpoint (A.9.5), and `--prom-host` goes with it.
- Added: `--diag-port` serves the diagnostics statuses `kernels` and
  `device` (skvbc_replica's), and the UDP transport's netio counters
  (comm/udp.METRICS) are published beside the replica's components.
"""
from __future__ import annotations

import argparse
import errno
import os
import sys
import time

from tpubft_torch.apps.simple_test import (add_device_args, add_scheme_args,
                                           endpoint_table, not_ported,
                                           select_device)
from tpubft_torch.comm import CommConfig, create_communication
from tpubft_torch.consensus.keys import ClusterKeys
from tpubft_torch.kvbc.readonly import ReadOnlyReplica
from tpubft_torch.storage.objectstore import FsObjectStore
from tpubft_torch.utils.config import ReplicaConfig
from tpubft_torch.utils.metrics import Aggregator, UdpMetricsServer


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="read-only replica")
    p.add_argument("--replica", type=int, required=True)
    p.add_argument("--f", type=int, default=1)
    p.add_argument("--c", type=int, default=0)
    p.add_argument("--ro", type=int, default=1,
                   help="number of RO replicas in the topology")
    p.add_argument("--clients", type=int, default=4)
    p.add_argument("--base-port", type=int, default=3710)
    p.add_argument("--metrics-port", type=int, default=0)
    p.add_argument("--diag-port", type=int, default=None,
                   help="diagnostics admin server port (0 = ephemeral)")
    p.add_argument("--prom-port", type=int, default=None,
                   help="Prometheus /metrics HTTP port (not ported: A.9.5)")
    p.add_argument("--archive-dir", default=None)
    p.add_argument("--s3-endpoint", default=None,
                   help="archive to an S3-compatible store (host:port) "
                        "instead of --archive-dir")
    p.add_argument("--s3-bucket", default="tpubft-archive")
    p.add_argument("--s3-access-key", default="")
    p.add_argument("--s3-secret-key-env", default="TPUBFT_S3_SECRET",
                   help="env var holding the secret key (never a flag: "
                        "argv is world-readable)")
    p.add_argument("--seed", default="tpubft-skvbc")
    p.add_argument("--checkpoint-window", type=int, default=150)
    p.add_argument("--transport", default="udp",
                   choices=("udp", "tcp", "tls", "tls-mux"))
    p.add_argument("--certs-dir", default=None,
                   help="TLS material dir (node-<id>.key/.crt)")
    p.add_argument("--config-override", action="append", default=[],
                   metavar="FIELD=VALUE",
                   help="set any ReplicaConfig field (repeatable) — same "
                        "escape hatch as the skvbc replica binary")
    add_scheme_args(p)
    add_device_args(p)
    return p


def build_ro_replica(args, agg: Aggregator) -> ReadOnlyReplica:
    if args.prom_port is not None:
        not_ported("--prom-port", "A.9.5")
    kw = dict(replica_id=args.replica, f_val=args.f, c_val=args.c,
              num_ro_replicas=args.ro,
              num_of_client_proxies=args.clients,
              checkpoint_window_size=args.checkpoint_window,
              threshold_scheme=args.threshold_scheme,
              client_sig_scheme=args.client_sig_scheme)
    from tpubft_torch.utils.config import parse_config_overrides
    kw.update(parse_config_overrides(args.config_override))
    cfg = ReplicaConfig(**kw)
    keys = ClusterKeys.generate(cfg, args.clients,
                                seed=args.seed.encode()
                                ).for_node(args.replica)
    # the endpoint table covers replicas + RO + clients contiguously
    eps = endpoint_table(args.base_port, cfg.n_val + args.ro, args.clients)
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
    if args.s3_endpoint:
        from tpubft_torch.storage.s3 import S3ObjectStore
        store = S3ObjectStore(args.s3_endpoint, args.s3_bucket,
                              access_key=args.s3_access_key,
                              secret_key=os.environ.get(
                                  args.s3_secret_key_env, ""))
    else:
        store = FsObjectStore(args.archive_dir) if args.archive_dir else None
    from tpubft_torch.comm import udp
    agg.register(udp.METRICS)
    # st_cfg left to the replica: the reference's StConfig(), with the
    # window digests on the card where the process runs on one
    return ReadOnlyReplica(cfg, keys, comm, object_store=store,
                           aggregator=agg)


def main() -> None:
    from tpubft_torch.utils.logging import configure
    configure()
    args = make_parser().parse_args()
    select_device(args.device)
    agg = Aggregator()
    ro = build_ro_replica(args, agg)
    metrics = diag = None
    try:
        metrics = UdpMetricsServer(agg, port=args.metrics_port)
        metrics.start()
        if args.diag_port is not None:
            from tpubft_torch.apps.skvbc_replica import device_status
            from tpubft_torch.diagnostics import (DiagnosticsServer,
                                                  get_registrar)
            from tpubft_torch.utils import flight
            flight.install_diagnostics()
            get_registrar().register_status("device", device_status)
            diag = DiagnosticsServer(port=args.diag_port)
            diag.start()
        ro.start()
    except OSError as exc:
        if exc.errno != errno.EADDRINUSE:
            raise
        print(f"ro replica {args.replica}: {exc}", file=sys.stderr,
              flush=True)
        os._exit(errno.EADDRINUSE)
    diag_note = f", diag {diag.port}" if diag is not None else ""
    print(f"ro replica {args.replica} up (metrics {metrics.port}"
          f"{diag_note})", flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        ro.stop()
        metrics.stop()
        if diag is not None:
            diag.stop()


if __name__ == "__main__":
    main()
