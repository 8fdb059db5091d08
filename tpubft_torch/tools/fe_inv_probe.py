"""Cycles a step of the rung-3 inversion kernel (csrc/fe_inv.cu) on the card.

    python -m tpubft_torch.tools.fe_inv_probe [--n 1024 131072] [--lanes 4 1]

For each element count n and lanes an element (4: fe_inv_group, 1:
fe_inv_one), one JSON line: clock64() stamps at the chain's start and end
in the first element's thread, divided by the chain's 265 steps
(`step_cycles`); device time by a CUDA graph of 20 launches (`ms`); the
host's enqueue time per call (`host_ms`); and the lanes that differ from
Python's pow(x, p-2, p) on a strided sample of 64. The stamps come from
block 0, which starts with the launch, so they see the chain, not the
grid's waves. chip_smoke.py's rung-3 row takes its cycles a step, and the
chain floor (ops/bringup_cuda.chain_floor_ms) from them, from this probe.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from tpubft_torch.ops import bringup_cuda as bu
from tpubft_torch.ops import f25519 as F
from tpubft_torch.tools import bringup
from tpubft_torch.tools.timing import cuda_ms, graph_ms


def elements(n: int, seed: int = 7) -> np.ndarray:
    """(24, n) limbs of random elements; the first lanes are the edge
    cases 0, 1, 2, 19, p-1 and (p-1)/2."""
    a = bringup._rand_elems(np.random.default_rng(seed), n)
    edges = [0, 1, 2, 19, F.P - 1, (F.P - 1) // 2][:n]
    for i, v in enumerate(edges):
        a[:, i] = F.int_to_limbs(v)
    return a


def sample_mismatches(a: np.ndarray, got: np.ndarray, samples: int = 64
                      ) -> int:
    """Lanes of a strided sample (the first and last included) where the
    result differs from pow(x, p-2, p)."""
    n = a.shape[1]
    idx = sorted(set(np.linspace(0, n - 1, min(samples, n)).astype(int)))
    return sum(not np.array_equal(
        got[:, i], F.int_to_limbs(pow(F.limbs_to_int(a[:, i]), F.P - 2,
                                      F.P))) for i in idx)


def probe(dev: torch.device, n: int, lanes: int) -> Dict:
    a_np = elements(n)
    a = torch.from_numpy(a_np).to(dev)
    stamps = torch.zeros(2, dtype=torch.int64, device=dev)
    got = bu._fe_inv(a, lanes, stamps).cpu().numpy()
    start, end = stamps.tolist()
    row = {"n": n, "lanes": lanes, "chain_cycles": end - start,
           "step_cycles": (end - start) / bu.CHAIN_STEPS,
           "mismatches_vs_int": sample_mismatches(a_np, got)}

    def call():
        return bu._fe_inv(a, lanes)
    row["ms"] = graph_ms(call, 20)
    row["host_ms"] = cuda_ms(call, 10)
    return row


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, nargs="+", default=[1024, 1 << 17])
    ap.add_argument("--lanes", type=int, nargs="+", default=[4, 1],
                    choices=(1, 4))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the probe runs on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    bad = 0
    for n in args.n:
        for lanes in args.lanes:
            row = probe(dev, n, lanes)
            bad += row["mismatches_vs_int"]
            print(json.dumps(row), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
