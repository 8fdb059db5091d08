"""Cycles a field product of the G1 MSM kernel (csrc/bls12_381_msm.cu) on
the card, for each design of lanes an element, and the kernel at its
paths' shapes.

    python -m tpubft_torch.tools.bls_msm_probe [--lanes 1 2 4] [--shapes]

For each lanes count L (1: an element a thread; 2, 4: an element on a
group of lanes), one JSON line from the kernel's clock64 probe: cycles of
one Montgomery product in a dependent chain of 4096, of one step of two
products side by side in a chain of 4096, and of one doubling in a chain
of 512, on one group alone on the card. With --shapes, then for each L
one line a path shape: bls_msm at S=64 K=5 (config 2's flush: Lagrange
coefficients of 5 of 7 ids a slot), at S=1 K=667 (config 4's combine:
667 of 1000), bls_mul at B=667; device time by a CUDA graph (`ms`),
results that differ from the native host engine (`mismatches`), the
steps of the kernel's longest chain and the chain floor they set at
this L's cycles and the SM clock (ops/bls12_381_cuda.kernel_counts,
chain_floor_ms). ops/bls12_381_cuda.LANES is the L that was fastest
here. Exits 1 on a mismatch.
"""
from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
from typing import Optional, Sequence

import torch

from tpubft_torch.crypto import bls12381 as bls
from tpubft_torch.ops import bls12_381 as bops
from tpubft_torch.ops import bls12_381_cuda as bc
from tpubft_torch.tools.timing import graph_ms


def sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.split()[0])


def path_shapes(seed: int = 11):
    """(name, reduce, host inputs, native results) at the three shapes."""
    rng = random.Random(seed)
    pts = [bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R))
           for _ in range(667)]
    segs = []
    for s in range(64):
        ids = sorted(rng.sample(range(1, 8), 5))
        segs.append((pts[5 * s:5 * s + 5], bls.lagrange_coeffs_at_zero(ids)))
    ids4 = sorted(rng.sample(range(1, 1001), 667))
    coeffs4 = bls.lagrange_coeffs_at_zero(ids4)
    yield ("bls_msm S=64 K=5", True, bops.prepare_msm_batch(segs),
           [bls.g1_msm(p, k) for p, k in segs])
    yield ("bls_msm S=1 K=667", True, bops.prepare_msm_batch(
        [(pts, coeffs4)]), [bls.g1_msm(pts, coeffs4)])
    yield ("bls_mul B=667", False, bops._prep_msm(pts, coeffs4),
           [bls.g1_mul(p, k) for p, k in zip(pts, coeffs4)])


def affine(xyz):
    cols = [c.cpu().numpy() for c in xyz]
    return [bops._to_affine_host(*(c[:, j] for c in cols))
            for j in range(cols[0].shape[1])]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, nargs="+",
                    default=list(bc.LANE_CHOICES), choices=bc.LANE_CHOICES)
    ap.add_argument("--shapes", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the probe runs on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    clock = sm_clock_mhz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    probed = {}
    for lanes in args.lanes:
        probed[lanes] = bc.probe(dev, lanes)
        print(json.dumps(probed[lanes]), flush=True)
    if not args.shapes:
        return 0
    bad = 0
    for name, reduce, host, want in path_shapes():
        t = bops.to_tensors(host, dev)
        s, k = host[3].shape if reduce else (host[3].size, 1)
        counts = bc.kernel_counts(s, k, sms)
        kern = bc.msm if reduce else bc.scalar_mul
        for lanes in args.lanes:
            got = affine(kern(*t, lanes=lanes))
            row = {"shape": name, "lanes": lanes,
                   "ms": graph_ms(lambda: kern(*t, lanes=lanes), 3,
                                  replays=3),
                   "mismatches": sum(g != w for g, w in zip(got, want)),
                   "chain_steps": counts["chain_steps"],
                   "field_muls": counts["field_muls"],
                   "chain_floor_ms": bc.chain_floor_ms(
                       counts["chain_steps"], probed[lanes], clock),
                   "plan": counts["plan"]}
            bad += row["mismatches"]
            print(json.dumps(row), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
