"""Where the G1 MSM kernel's route overtakes the host's, on the card.

    python -m tpubft_torch.tools.msm_crossover [--reps 5]

For each shape, the two routes a CUDA BLS verifier (crypto/cuda.py) can
take for one combine, timed end to end on the host's clock as the
verifier calls them (`--reps` calls after one warm-up call: the median,
and the minimum and maximum beside it as the spread):

  host    below TPUBFT_MSM_CROSSOVER_K: per segment, crypto/bls12381's
          combine_shares (Lagrange coefficients, the native Pippenger
          MSM) for threshold-bls, a chain of g1_add for multisig-bls
          (crypto/systems.py's host `_combine_segments` / `_sum_segments`);
  device  at or above it: ops/bls12_381's combine_shares_batch / msm_batch
          (Lagrange coefficients, kernel inputs, copy in, one bls_msm
          launch, read-back, affine conversion).

Families: `threshold_flush`, config 2's fused flushes (S slots of 5
shares, each slot's ids 5 of 7); `multisig_flush`, the same slots summed
with all-ones scalars; `threshold_combine`, one combine of K shares (ids
K of 1.5 K, config 4's at K = 667). One JSON line a shape (total shares,
both routes' median ms and their min and max, the kernel's launches),
then a last line with, for each family, the smallest total share count
from which the device route's median was below the host route's at
every larger shape measured (null if it never was). Exits 1 if
the two routes disagree on a point or the native engine did not load.
"""
from __future__ import annotations

import argparse
import json
import random
import statistics
import sys
import time
from typing import Callable, List, Optional, Sequence

import torch

from tpubft_torch.crypto import bls12381 as bls
from tpubft_torch.crypto import bls_native
from tpubft_torch.ops import bls12_381 as dev_ops
from tpubft_torch.ops import bls12_381_cuda as bc

FLUSH_SLOTS = (1, 2, 4, 8, 12, 16, 20, 26, 32, 48, 64)
COMBINE_SHARES = (5, 16, 32, 64, 96, 128, 192, 256, 384, 512, 667)


def _times_ms(fn: Callable[[], object], reps: int):
    """-> ((min, median, max) ms of `reps` calls after a warm-up, its
    result)."""
    out = fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return (min(times), statistics.median(times), max(times)), out


def _points(rng: random.Random, n: int) -> List:
    return [bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R))
            for _ in range(n)]


def _host_sum(segments) -> List:
    out = []
    for pts in segments:
        acc = None
        for pt in pts:
            acc = bls.g1_add(acc, pt)
        out.append(acc)
    return out


def shapes(rng: random.Random):
    """(family, total shares, host fn, device fn) for every shape."""
    for s in FLUSH_SLOTS:
        jobs = [(sorted(rng.sample(range(1, 8), 5)), _points(rng, 5))
                for _ in range(s)]
        yield ("threshold_flush", 5 * s,
               lambda jobs=jobs: [bls.combine_shares(i, p) for i, p in jobs],
               lambda jobs=jobs: dev_ops.combine_shares_batch(jobs))
        segs = [pts for _, pts in jobs]
        yield ("multisig_flush", 5 * s,
               lambda segs=segs: _host_sum(segs),
               lambda segs=segs: dev_ops.msm_batch(
                   [(p, [1] * len(p)) for p in segs]))
    for k in COMBINE_SHARES:
        job = (sorted(rng.sample(range(1, (3 * k) // 2 + 1), k)),
               _points(rng, k))
        yield ("threshold_combine", k,
               lambda job=job: [bls.combine_shares(*job)],
               lambda job=job: dev_ops.combine_shares_batch([job]))


def crossover(rows: List[dict]) -> Optional[int]:
    """The smallest total from which the device was faster at every larger
    shape of the family."""
    best = None
    for row in sorted(rows, key=lambda r: r["shares"], reverse=True):
        if row["device_ms"] >= row["host_ms"]:
            break
        best = row["shares"]
    return best


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the sweep runs on the card", file=sys.stderr)
        return 2
    if not bls_native.available():
        print(f"native BLS engine not loaded: {bls_native.load_error}",
              file=sys.stderr)
        return 1
    bls_native.reset_counts()
    by_family = {}
    bad = 0
    for family, shares, host, device in shapes(random.Random(args.seed)):
        host_ms, want = _times_ms(host, args.reps)
        before = bc.LAUNCHES["bls_msm"]
        device_ms, got = _times_ms(device, args.reps)
        row = {"family": family, "shares": shares, "host_ms": host_ms[1],
               "device_ms": device_ms[1],
               "host_ms_min_max": [host_ms[0], host_ms[2]],
               "device_ms_min_max": [device_ms[0], device_ms[2]],
               "launches": bc.LAUNCHES["bls_msm"] - before,
               "mismatches": sum(g != w for g, w in zip(got, want))}
        bad += row["mismatches"]
        by_family.setdefault(family, []).append(row)
        print(json.dumps(row), flush=True)
    bad += bls_native.COUNTS["fallbacks"]
    print(json.dumps({"crossover_shares": {f: crossover(rows) for f, rows
                                           in by_family.items()},
                      "native_fallbacks": bls_native.COUNTS["fallbacks"],
                      "mismatches": bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
