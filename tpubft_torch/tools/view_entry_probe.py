"""How long a new view takes to its first execution, in process on the
CPU: a four-replica counter cluster (threshold BLS certificates, host
crypto) is loaded by closed-loop clients until `--slots` slots past its
last stable checkpoint have executed; then the primary is stopped and
the load goes on.

    python3 tpubft_torch/tools/view_entry_probe.py [--tree DIR]
        [--slots 140] [--clients 4]

Imports DIR's tpubft_torch (default: this checkout's), so two checkouts
can be compared. Watches the three others from outside (every 5 ms):
when each enters view 1 and when its last_executed first passes the
value it had on entry. Prints one JSON line: the tree,
the slots executed past the checkpoint, and for each replica the
seconds from the stop to its entry into view 1, the ms from that entry
to its first execution, and the view it was in then (above 1 where
view 1 was deposed first).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--slots", type=int, default=140)
    ap.add_argument("--clients", type=int, default=4)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from tpubft_torch import device
    from tpubft_torch.apps import counter
    from tpubft_torch.testing import InProcessCluster
    device.set_default_device("cpu")
    cl = InProcessCluster(
        f=1, num_clients=args.clients, seed=b"view-entry-probe",
        cfg_overrides=dict(durability_pipeline=False, autotune_enabled=False,
                           crypto_backend="cpu",
                           threshold_scheme="threshold-bls",
                           view_change_timer_ms=3000)).start()
    stop = threading.Event()

    def load(i: int) -> None:
        client = cl.client(i)
        while not stop.is_set():
            try:
                client.send_write(counter.encode_add(1), timeout_ms=30000)
            except Exception:  # noqa: BLE001 — a timed-out write retries
                pass
    for i in range(args.clients):
        threading.Thread(target=load, args=(i,), daemon=True).start()
    others = (1, 2, 3)
    out = {}
    try:
        while min(cl.replicas[r].last_executed for r in others) \
                < args.slots:
            time.sleep(0.005)
        before = {r: cl.replicas[r].last_executed for r in others}
        past = {r: before[r] - cl.replicas[r].last_stable for r in others}
        t_stop = time.monotonic()
        cl.kill(0)
        entered, executed, at_entry, views = {}, {}, {}, {}
        deadline = t_stop + 120
        while len(executed) < len(others) and time.monotonic() < deadline:
            now = time.monotonic()
            for r in others:
                rep = cl.replicas[r]
                if r not in entered and rep.view >= 1 \
                        and not rep.in_view_change:
                    entered[r] = now
                    at_entry[r] = rep.last_executed
                elif r in entered and r not in executed \
                        and rep.last_executed > at_entry[r]:
                    executed[r] = now
                    views[r] = rep.view
            time.sleep(0.005)
        out = {"tree": tree,
               "past_checkpoint": past,
               "entry_s": {r: round(entered[r] - t_stop, 3)
                           for r in entered},
               "first_exec_ms": {r: round((executed[r] - entered[r]) * 1e3,
                                          1) for r in executed},
               "view_at_first_exec": views}
    finally:
        stop.set()
        cl.stop()
    print(json.dumps(out), flush=True)
    return 0 if len(out.get("first_exec_ms", {})) == len(others) else 1


if __name__ == "__main__":
    sys.exit(main())
