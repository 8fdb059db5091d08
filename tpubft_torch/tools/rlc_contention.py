"""The RLC path's latency a call when several processes share one card.

    python -m tpubft_torch.tools.rlc_contention [--procs 1 4] [--calls 300]
        [--items 3] [--device cuda|cpu]

Each process calls `ops/ecdsa.rlc_verify_batch` on `--items` P-256
signatures (the size of a PrePrepare's group in config 5) `--calls`
times, read-back included, after a barrier shared by the processes; the
inputs cross to the card either one pageable copy an array ("copies",
the wrapper before PR 17) or in one pinned copy (`ops/ecdsa.to_tensors`,
"one_copy"). Runs go in turns (copies, one copy, one copy, copies for
each process count) and print one JSON line each: every process's p50,
p90 and mean ms a call and calls a second. Without a card and without
`--device cpu` it exits with NoDevice.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import sys
import time


def _copies(arrays, dev):
    """The inputs one pageable copy an array (the wrapper before its one
    pinned copy)."""
    import numpy as np
    import torch
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out.append(torch.from_numpy(a).to(dev))
    return tuple(out)


def _child(mode: str, device: str, calls: int, items: int, barrier,
           results) -> None:
    import torch

    from tpubft_torch import device as _device
    from tpubft_torch import testing
    from tpubft_torch.ops import ecdsa
    if device == "cpu":
        _device.set_default_device("cpu")
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    if mode == "copies":
        ecdsa.to_tensors = _copies
    batch = testing.ecdsa_corpus("secp256r1", items, seed=items)
    for _ in range(min(5, calls)):      # warm-up
        if not ecdsa.rlc_verify_batch("secp256r1", batch, device=dev).all():
            raise AssertionError("a clean batch failed the RLC check")
    barrier.wait()
    lat = []
    t0 = time.perf_counter()
    for _ in range(calls):
        t = time.perf_counter()
        ecdsa.rlc_verify_batch("secp256r1", batch, device=dev)
        lat.append((time.perf_counter() - t) * 1e3)
    wall = time.perf_counter() - t0
    lat.sort()
    results.put({"p50": lat[len(lat) // 2],
                 "p90": lat[int(len(lat) * 0.9)],
                 "mean": sum(lat) / len(lat), "calls_per_s": calls / wall})


def run(mode: str, procs: int, device: str, calls: int, items: int) -> dict:
    ctx = mp.get_context("spawn")
    barrier = ctx.Barrier(procs)
    results = ctx.Queue()
    children = [ctx.Process(target=_child, args=(mode, device, calls, items,
                                                 barrier, results))
                for _ in range(procs)]
    for c in children:
        c.start()
    rows = [results.get(timeout=1800) for _ in children]
    for c in children:
        c.join(timeout=60)
    return {"mode": mode, "procs": procs, "items": items,
            "p50_ms": [r["p50"] for r in rows],
            "p90_ms": [r["p90"] for r in rows],
            "mean_ms": [r["mean"] for r in rows],
            "calls_per_s": [r["calls_per_s"] for r in rows]}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--procs", type=int, nargs="+", default=[1, 4])
    p.add_argument("--calls", type=int, default=300)
    p.add_argument("--items", type=int, default=3)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args()
    if args.device == "cuda":
        import torch

        from tpubft_torch.device import NoDevice
        if not torch.cuda.is_available():
            raise NoDevice("no card: run with --device cpu")
        from tpubft_torch.ops import ecdsa_cuda
        ecdsa_cuda.library()          # built once, before the children
    for procs in args.procs:
        for mode in ("copies", "one_copy", "one_copy", "copies"):
            print(json.dumps(run(mode, procs, args.device, args.calls,
                                 args.items)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
