"""One checkout's process cluster phase in a fresh process, to compare
two checkouts, or the in-memory and persistent clusters at one client
count, on one card.

    python3 tpubft_torch/tools/cluster_ab.py --tree DIR
        --phase process_cluster|persistent_cluster|tls_cluster
        [--clients N] [--no-thin-replica]
    python3 tpubft_torch/tools/cluster_ab.py --tree DIR --merkle
        [--clients N]

Imports DIR's chip_smoke.py (DIR: a checkout of the repo, whose
tpubft_torch is the one imported and the one its replica processes run)
and runs the phase with `--clients` closed-loop clients (default: the
phase's own); the phase builds the libraries it loads. process_cluster
is given no in-process phase to stand beside (its beside_in_process
numbers are null); `--no-thin-replica` runs it without the read tier's
follower and proof network, to see what they cost its load. The phase's
own lines go to standard error. `--merkle` runs process_cluster's
network (config 1's four replica processes, its clients and
`device_min_verify_batch`) with the SKVBC state in its BLOCK_MERKLE
category (`skvbc_replica --merkle`) for its first load alone: until
MERKLE_TARGET writes commit or MERKLE_BUDGET_S seconds have passed (the
load's rate is the reading, however far it got), then the network
stops. Prints
one JSON line: the tree, the phase, the clients, its first load's
requests/s, commit latency p50 / p99 and committed writes, the phase's
wall seconds, and the card's name and power limit as nvidia-smi gives
them. Run the checkouts in turns (A, B, B, A) in one call: a one-card
machine shares its host, and a single pair can differ by chance.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import inspect
import json
import os
import subprocess
import sys

PHASES = ("process_cluster", "persistent_cluster", "tls_cluster")
# what process_cluster prints beside its own load, absent here
NO_IN_PROCESS = {"load": {"requests_per_s": None, "commit_latency_ms": None},
                 "config": {"clients": None}}
# --merkle: process_cluster's first-load target, and a budget that ends a
# load far short of it (BLOCK_MERKLE over a single sorted key list ran at
# about 2 writes a second)
MERKLE_TARGET = 1000
MERKLE_BUDGET_S = 90.0


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def merkle_first_load(smoke, clients: int, target: int,
                      budget_s: float) -> dict:
    """process_cluster's network in BLOCK_MERKLE, its first load alone
    (chip_smoke._ProcessCluster's start and closed loop): -> the load and
    the wall seconds."""
    import shutil
    import tempfile
    import time

    from tpubft_torch.testing.network import BftTestNetwork
    t0 = time.monotonic()
    log_dir = tempfile.mkdtemp(prefix="cluster-ab-merkle-")
    net = BftTestNetwork(f=1, num_clients=clients, seed="chip-smoke-procs",
                         device="cuda", log_dir=log_dir,
                         device_min_verify_batch=4, merkle=True)
    out = {"phase": "process_cluster (merkle)", "clients": clients}
    cl = smoke._ProcessCluster("merkle_first_load", net, clients, out)
    try:
        cl.start()
        out["load"] = cl.loop.run(lambda n: n >= target, budget_s=budget_s)
        out["load_errors"] = cl.loop.errors[:3]
    finally:
        net.stop_all()
        shutil.rmtree(log_dir, ignore_errors=True)
    out["wall_s"] = time.monotonic() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--phase", choices=PHASES)
    ap.add_argument("--clients", type=int)
    ap.add_argument("--no-thin-replica", action="store_true",
                    help="process_cluster without its thin-replica check")
    ap.add_argument("--merkle", action="store_true",
                    help="process_cluster's first load alone, its state "
                         "in BLOCK_MERKLE")
    args = ap.parse_args(argv)
    if (args.phase is None) == (not args.merkle):
        ap.error("give --phase or --merkle")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    smoke = importlib.import_module("chip_smoke")
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the phases run on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if args.merkle:
        clients = args.clients or inspect.signature(
            smoke.phase_process_cluster).parameters["clients"].default
        with contextlib.redirect_stdout(sys.stderr):
            out = merkle_first_load(smoke, clients, MERKLE_TARGET,
                                    MERKLE_BUDGET_S)
        load = out["load"]
        print(json.dumps({
            "tree": tree, "phase": out["phase"], "clients": clients,
            "target": MERKLE_TARGET, "budget_s": MERKLE_BUDGET_S,
            "requests_per_s": load["requests_per_s"],
            "committed": load["committed"], "errors": out["load_errors"],
            "p50_ms": (load["commit_latency_ms"] or {}).get("p50"),
            "p99_ms": (load["commit_latency_ms"] or {}).get("p99"),
            "wall_s": out["wall_s"], "card": card()}), flush=True)
        return 0
    fn = getattr(smoke, f"phase_{args.phase}")
    kw = {} if args.clients is None else {"clients": args.clients}
    if args.phase == "process_cluster":
        kw["ledger_replica"] = NO_IN_PROCESS
    if args.no_thin_replica:
        kw["thin_replica"] = False
    clients = kw.get("clients",
                     inspect.signature(fn).parameters["clients"].default)
    with contextlib.redirect_stdout(sys.stderr):
        out = fn(torch, dev, **kw)
    load = out["load"]
    print(json.dumps({
        "tree": tree, "phase": args.phase, "clients": clients,
        "thin_replica": not args.no_thin_replica,
        "requests_per_s": load["requests_per_s"],
        "committed": load["committed"],
        "p50_ms": load["commit_latency_ms"]["p50"],
        "p99_ms": load["commit_latency_ms"]["p99"],
        "wall_s": out["wall_s"], "card": card()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
