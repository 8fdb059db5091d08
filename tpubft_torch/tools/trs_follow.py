"""Follow a cluster's thin-replica stream and write each verified block.

    python -m tpubft_torch.tools.trs_follow --endpoint 127.0.0.1:P3 \\
        --endpoint 127.0.0.1:P0 ... --f 1 [--out FILE] [--exit-on-stdin-eof]

A ThinReplicaClient (thinreplica/client.py) subscribes from block 1
over the given servers, the first its first data source: a block is
delivered only once f+1 servers agree on its digest, and a stalled or
lying data source is rotated away from. Each delivered block is one JSON line, {"block": id,
"t": the CLOCK_MONOTONIC second it was delivered, "kv": [[key hex,
value hex], ...]}, and each change of the client's generation (a
rotation) a line {"generation": g, "t": ...}, written to FILE (default
stdout) as they come. It runs until SIGTERM or SIGINT, or with
`--exit-on-stdin-eof` until its standard input closes (a parent that
holds the pipe ends it by dying). It imports no torch, so it starts in
a fraction of a second and keeps its work off the process that drives
the cluster.
"""
from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time

from tpubft_torch.thinreplica.client import ThinReplicaClient


def _endpoint(text: str):
    host, _, port = text.rpartition(":")
    return host or "127.0.0.1", int(port)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--endpoint", action="append", type=_endpoint,
                    required=True, help="HOST:PORT of a thin-replica "
                    "server; the first is the first data source")
    ap.add_argument("--f", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--exit-on-stdin-eof", action="store_true")
    args = ap.parse_args(argv)
    out = open(args.out, "a", buffering=1) if args.out else sys.stdout
    lock = threading.Lock()

    def write(obj) -> None:
        with lock:
            out.write(json.dumps(obj) + "\n")
            out.flush()

    def on_update(block: int, kv) -> None:
        write({"block": block, "t": time.monotonic(),
               "kv": [[k.hex(), v.hex()] for k, v in kv]})

    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_a: done.set())
    if args.exit_on_stdin_eof:
        threading.Thread(target=lambda: (sys.stdin.read(), done.set()),
                         daemon=True).start()
    client = ThinReplicaClient(args.endpoint, f_val=args.f)
    client.subscribe(on_update, start_block=1)
    generation = 0
    while not done.wait(0.05):
        if client._generation != generation:
            generation = client._generation
            write({"generation": generation, "t": time.monotonic()})
    client.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
