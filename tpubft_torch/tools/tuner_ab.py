"""chip_smoke's cluster phases with the autotuner on and off, in turns,
each run in a fresh process, on one card.

    python -m tpubft_torch.tools.tuner_ab [--phases ledger_replica
        bls_ledger_replica ecdsa_ledger_replica] [--pairs 2] [--logs DIR]

For each phase, `--pairs` pairs of runs, the tuner on first in even
pairs and off first in odd ones (on, off, off, on, ...). A run is one
process (`--run PHASE --tuner on|off`) that builds the kernels (the
first process of a call builds them into ops/_build/, the rest load
them) and runs the phase of the repo's chip_smoke.py with
`autotune_enabled` set in its cluster configs; the phase's own lines
and the process's standard error go to DIR (one .log and one .err a
run; by default a new temporary directory, printed last). Each run prints one JSON line: its
requests/s, commit latency p50 / p99, the phase's wall time and, with
the tuner on, its polls, decisions and the knobs that moved
(chip_smoke.tuner_report); a run that fails prints its error instead
and the rest go on. Last, one line of each phase's arms: every
completed run's requests/s and their medians, and the failed runs.
Run it from the repo root on the card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
PHASES = ("ledger_replica", "bls_ledger_replica", "ecdsa_ledger_replica")
CONFIGS = ("REPLICA_CONFIG", "LEDGER_REPLICA_CONFIG", "BLS_LEDGER_CONFIG",
           "ECDSA_LEDGER_CONFIG")


def run_one(phase: str, tuner: bool, log_path: str) -> dict:
    sys.path.insert(0, ROOT)
    import chip_smoke
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the phases run on the card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    for name in CONFIGS:
        getattr(chip_smoke, name)["autotune_enabled"] = tuner
    chip_smoke.build_all()
    with open(log_path, "w") as log, contextlib.redirect_stdout(log):
        out = getattr(chip_smoke, f"phase_{phase}")(torch, dev)
    load = out["load"]
    row = {"phase": phase, "tuner": tuner,
           "requests_per_s": load["requests_per_s"],
           "committed": load["committed"],
           "p50_ms": load["commit_latency_ms"]["p50"],
           "p99_ms": load["commit_latency_ms"]["p99"],
           "wall_s": out["wall_s"]}
    t = out.get("tuner") or {}
    if t.get("replicas_tuned"):
        row["tuner_report"] = {k: t[k] for k in (
            "polls", "decisions", "degraded_resets", "knobs_moved",
            "ecdsa_crossover_end")}
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", nargs="+", choices=PHASES,
                    default=list(PHASES))
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--logs", help="directory for each run's lines and "
                    "errors (default: a new temporary directory)")
    ap.add_argument("--run", choices=PHASES, help=argparse.SUPPRESS)
    ap.add_argument("--tuner", choices=("on", "off"), help=argparse.SUPPRESS)
    ap.add_argument("--log", help=argparse.SUPPRESS)   # one run's file
    args = ap.parse_args(argv)
    if args.run:
        print(json.dumps(run_one(args.run, args.tuner == "on", args.log)),
              flush=True)
        return 0
    logs = os.path.abspath(args.logs) if args.logs \
        else tempfile.mkdtemp(prefix="tuner_ab-")
    os.makedirs(logs, exist_ok=True)
    summary = {}
    for phase in args.phases:
        arms = {"on": [], "off": []}
        failed = []
        for i in range(args.pairs):
            for arm in (("on", "off") if i % 2 == 0 else ("off", "on")):
                base = os.path.join(logs, f"{phase}-{i}-{arm}")
                with open(base + ".err", "w") as err:
                    proc = subprocess.run(
                        [sys.executable, "-m", "tpubft_torch.tools.tuner_ab",
                         "--run", phase, "--tuner", arm,
                         "--log", base + ".log"], cwd=ROOT,
                        stdout=subprocess.PIPE, stderr=err, text=True,
                        timeout=1200)
                if proc.returncode != 0:
                    with open(base + ".err") as err:
                        tail = err.read()[-300:]
                    failed.append({"pair": i, "tuner": arm == "on",
                                   "error": tail})
                    print(json.dumps({"phase": phase, "tuner": arm == "on",
                                      "failed": tail}), flush=True)
                    continue
                row = json.loads(proc.stdout.strip().splitlines()[-1])
                print(json.dumps(row), flush=True)
                arms[arm].append(row["requests_per_s"])
        summary[phase] = {arm: {"requests_per_s": v,
                                "median": statistics.median(v)
                                if v else None}
                          for arm, v in arms.items()}
        summary[phase]["failed"] = failed
    print(json.dumps({"tuner_ab": summary, "logs": logs}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
