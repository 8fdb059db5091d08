"""One checkout's rung-3 inversion and digest phase in a fresh process,
to compare two checkouts on one card.

    python3 tpubft_torch/tools/smoke_ab.py --tree DIR [--ladder]
                                           [--digest-reps N]
                                           [--no-fe-inv-library]

Imports DIR's chip_smoke.py (DIR: a checkout of the repo, whose
tpubft_torch is the one imported) and builds its kernels (its device
phase). Then, with --ladder, runs its ladder phase and reports rung 3
(fe_inv at the ladder's 1024 elements, by graph: the row's `ms`), and
times the checkout's fe_inv at 2^17 elements with its chip_smoke's
graph_ms (10 launches), matched against the plain version on a
4096-element slice. With --digest-reps N, runs its digest phase N times
over the raw blocks of an 800-block kvbcbench ledger (the ledger phase's
blocks) and reports the median of each pass's later windows (the phase's
`later_calls_ms`) and every window's time. Prints one JSON line; the
phases' own lines are discarded. The digest phase times the host's wall
clock around each call, so a difference that holds for a whole process
shows only across several processes: run the checkouts in turns.
--no-fe-inv-library leaves the inversion's library (csrc/fe_inv.cu)
unbuilt and unloaded in the device phase, to see whether a fourth
library moves the digest phase (not with --ladder, which launches it).
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import json
import os
import sys


def rung3_wrapper():
    """The checkout's fe_inv wrapper: ops/bringup_cuda.fe_inv, or where a
    checkout predates csrc/fe_inv.cu, ops/ed25519_cuda.fe_inv."""
    from tpubft_torch.ops import bringup_cuda, ed25519_cuda
    return getattr(bringup_cuda, "fe_inv", None) or ed25519_cuda.fe_inv


def inv_large(smoke, torch, dev, n: int = 1 << 17) -> dict:
    import numpy as np

    from tpubft_torch.tools import bringup
    inv = rung3_wrapper()
    a = torch.from_numpy(bringup._rand_elems(np.random.default_rng(n),
                                             n)).to(dev)
    part = a[:, :4096].contiguous()
    equal = bool(torch.equal(inv(a)[:, :4096], bringup._plain_inv(part)))
    return {"n": n, "equal_plain_4096": equal,
            "ms": smoke.graph_ms(lambda: inv(a), 10)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--ladder", action="store_true")
    ap.add_argument("--digest-reps", type=int, default=0)
    ap.add_argument("--no-fe-inv-library", action="store_true")
    args = ap.parse_args(argv)
    if args.ladder and args.no_fe_inv_library:
        ap.error("--ladder launches the inversion's library")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    smoke = importlib.import_module("chip_smoke")
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the phases run on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = {"tree": tree, "ladder": args.ladder,
           "fe_inv_library": not args.no_fe_inv_library}
    if args.no_fe_inv_library:
        from tpubft_torch.ops import bringup_cuda
        bringup_cuda.fe_inv_library = lambda: None
    with contextlib.redirect_stdout(io.StringIO()):
        info = smoke.phase_device(torch)
        out["card"] = info["nvidia_smi"]
        if args.ladder:
            ladder = smoke.phase_ladder(torch, dev, info["clocks_max_sm_mhz"])
            rung3 = [r for r in ladder["rungs"] if r["kernel"] == "fe_inv"]
            out["fe_inv_1024"] = {k: rung3[0][k] for k in
                                  ("ms", "host_ms", "mismatches_vs_int",
                                   "mismatches_vs_plain")}
            out["fe_inv_large"] = inv_large(smoke, torch, dev)
        if args.digest_reps:
            from tpubft_torch.tools import digest_breakdown as bd
            raws = bd.ledger_raws(800)
            out["digest"] = []
            for _ in range(args.digest_reps):
                d = smoke.phase_digest(torch, dev, raws)
                out["digest"].append({
                    "later_median_ms": d["later_calls_ms"]["median"],
                    "windows_ms": [w["ms"] for w in d["windows"]]})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
