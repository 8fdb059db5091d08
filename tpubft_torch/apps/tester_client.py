"""TesterClient — standalone random-workload checker process (port of
tpubft/apps/tester_client.py).

Rebuild of concord-bft tests/simpleKVBC/TesterClient/: drives a live
SKVBC cluster with a concurrent randomized read/write workload, verifies
read-your-writes against a local model, and prints one JSON summary line
(ops, throughput, latency percentiles, check failures).

Run (against an skvbc_replica cluster sharing --base-port/--seed):
  python -m tpubft_torch.apps.tester_client --f 1 --base-port 3710 \
      --ops 200 --concurrency 3 [--seed S] [--client-idx 0]
"""
from __future__ import annotations

import argparse
import json
import random
import statistics
import sys
import threading
import time

from tpubft_torch.apps.simple_test import add_scheme_args, endpoint_table
from tpubft_torch.apps.skvbc import SkvbcClient
from tpubft_torch.bftclient import BftClient, ClientConfig
from tpubft_torch.comm import CommConfig, PlainUdpCommunication
from tpubft_torch.consensus.keys import ClusterKeys
from tpubft_torch.utils.config import ReplicaConfig


def make_client(args, idx: int) -> SkvbcClient:
    cfg = ReplicaConfig(f_val=args.f, c_val=args.c,
                        num_of_client_proxies=args.clients,
                        threshold_scheme=args.threshold_scheme,
                        client_sig_scheme=args.client_sig_scheme)
    n = cfg.n_val
    client_id = n + args.client_idx + idx
    keys = ClusterKeys.generate(cfg, args.clients,
                                seed=args.seed.encode()).for_node(client_id)
    eps = endpoint_table(args.base_port, n, args.clients)
    comm = PlainUdpCommunication(CommConfig(self_id=client_id,
                                            endpoints=eps))
    cl = BftClient(ClientConfig(client_id=client_id, f_val=args.f,
                                c_val=args.c), keys, comm)
    cl.start()
    return SkvbcClient(cl)


def run_workload(args) -> dict:
    keys = [b"tk-%d" % i for i in range(args.keys)]
    model_lock = threading.Lock()
    model = {}                       # last value this process wrote per key
    lat, failures = [], []
    counts = [0] * args.concurrency

    def worker(w: int) -> None:
        rng = random.Random(args.workload_seed + w)
        kv = make_client(args, w)
        per = args.ops // args.concurrency
        for i in range(per):
            k = rng.choice(keys)
            try:
                if rng.random() < args.write_ratio:
                    if args.batch > 1:
                        # batched-workload mode: several independent
                        # write transactions on one wire message
                        # (ClientBatchRequestMsg)
                        kvs_payload = []
                        for j in range(args.batch):
                            bk = rng.choice(keys)
                            bv = b"%d-%d-%d-%d" % (w, i, j,
                                                   rng.randrange(1 << 30))
                            kvs_payload.append((bk, bv))
                        t0 = time.monotonic()
                        rs = kv.write_batch([[p] for p in kvs_payload],
                                            timeout_ms=args.timeout_ms)
                        lat.append(time.monotonic() - t0)
                        with model_lock:
                            for (bk, bv), r in zip(kvs_payload, rs):
                                if r.success:
                                    counts[w] += 1
                                    model[bk] = bv
                        continue
                    v = b"%d-%d-%d" % (w, i, rng.randrange(1 << 30))
                    t0 = time.monotonic()
                    r = kv.write([(k, v)], timeout_ms=args.timeout_ms)
                    lat.append(time.monotonic() - t0)
                    if r.success:
                        counts[w] += 1
                        with model_lock:
                            model[k] = v
                else:
                    t0 = time.monotonic()
                    got = kv.read([k], timeout_ms=args.timeout_ms)
                    lat.append(time.monotonic() - t0)
                    counts[w] += 1
                    with model_lock:
                        expect = model.get(k)
                    # read-your-writes: with concurrent writers the value
                    # may be NEWER than our model, never staler-than-none
                    if expect is not None and k not in got:
                        failures.append(f"key {k!r} vanished")
            except Exception as e:  # noqa: BLE001 — lossy clusters time out
                failures.append(f"op error: {type(e).__name__}")

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(args.concurrency)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    lat.sort()
    return {
        "ops_requested": args.ops, "ops_ok": sum(counts),
        "wall_s": round(wall, 2),
        "throughput_ops_sec": round(sum(counts) / wall, 1) if wall else 0,
        "mean_latency_ms": round(statistics.mean(lat) * 1e3, 2) if lat else None,
        "p99_latency_ms": round(lat[int(len(lat) * 0.99)] * 1e3, 2) if lat else None,
        "check_failures": failures[:10],
        "ok": not failures and sum(counts) > 0,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--f", type=int, default=1)
    ap.add_argument("--c", type=int, default=0)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--client-idx", type=int, default=0)
    ap.add_argument("--base-port", type=int, default=3710)
    ap.add_argument("--seed", default="tpubft-skvbc")
    ap.add_argument("--ops", type=int, default=100)
    ap.add_argument("--concurrency", type=int, default=2)
    ap.add_argument("--keys", type=int, default=16)
    ap.add_argument("--batch", type=int, default=1,
                    help=">1: each write op sends this many independent "
                         "transactions as one ClientBatchRequestMsg")
    ap.add_argument("--write-ratio", type=float, default=0.6)
    ap.add_argument("--timeout-ms", type=int, default=8000)
    ap.add_argument("--workload-seed", type=int, default=0xC11E47)
    add_scheme_args(ap)
    args = ap.parse_args()
    summary = run_workload(args)
    print(json.dumps(summary))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
