"""The ECDSA kernels (csrc/ecdsa.cu) on the card against their plain
versions, the host scalar engine and the reference's verdict rules.

    python -m tpubft_torch.tools.ecdsa_probe [--batches 16 128] [--reps 3]
    python -m tpubft_torch.tools.ecdsa_probe --crossover 1 2 3 4 6 8
    python -m tpubft_torch.tools.ecdsa_probe --cluster 1073741824 2 12 24

After the build line (ptxas's registers and stack frames), one line a
curve from the kernel's clock64 probe (ops/ecdsa_cuda.probe: cycles of a
product, a squaring, a Montgomery product, a pair of products, a
doubling, an addition and a mixed addition on one thread). Then for
each curve (secp256k1, P-256) and batch B, one JSON line (`measure`,
which chip_smoke.py's kernel rows call too, and here each kernel's
chain floor and bound at this run's probe cycles and SM clock:
`chain_floor_ms`, `bound_ms`, `verify_chain_floor_ms`,
`verify_bound_ms`): a seeded corpus of B signatures of 16 principals
with forged items, plus the two crafted wrap-case lanes of
testing.ecdsa_wrap_lanes.

  ecdsa_rlc     the fold of every lane (forged and wrap lanes in it)
                against rlc_fold_plain on the same tensors, word by word
                (`rlc_mismatches`; the plain call's time `rlc_plain_ms`);
                the kernel's fold of the clean lanes (forged lanes and
                the wrap lane without wrap_ok left out) must be 0
                (`clean_nonzero`); its device time by a CUDA graph
                (`rlc_ms`) and host issue time a call (`rlc_host_ms`);
  ecdsa_verify  verdicts and affine x against verify_plain
                (`verify_mismatches`), verdicts against the host scalar
                engine and the crafted lanes' expected verdicts
                (`verify_host_mismatches`); the same times;
  yardsticks    the host half (`prep_ms`: prepare_rlc_batch), the host
                engine's scalar.ecdsa_verify_batch on the same B items
                (`host_engine_cold_ms`: first call, combs built;
                `host_engine_ms`: the median of the next seven), and the
                work the function needs (ops/ecdsa_cuda.work: `ops`,
                `bytes`; its products and squarings `field_muls`,
                `field_sqrs`) beside the field products the kernel runs
                (`kernel_field_muls`) and its longest chain
                (`kernel_chain`, ops/ecdsa_cuda.kernel_counts).

With --crossover, one JSON object instead (`crossover`): the device
route against the host engine end to end at each batch, and the least
batch from which the device is the faster. With --cluster, config 3's
n=31 cluster once a crossover value, a fresh process each, one JSON line
each (`cluster_crossover`; run from the repository's root).

Exits 1 on any mismatch.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

CURVES = ("secp256k1", "secp256r1")


def measure(curve: str, b: int, dev: torch.device, seed: int = 0,
            forged: Sequence[int] = (1,), reps: int = 3,
            plain: bool = True, plain_verify: bool = True) -> Dict:
    """One curve at one batch: matches and times (see the module doc).
    `plain` / `plain_verify`: hold the fold / the per-item verify
    against its plain version (each some seconds of op-by-op PyTorch on
    the card)."""
    from tpubft_torch import testing
    from tpubft_torch.crypto import scalar
    from tpubft_torch.ops import ecdsa as E
    from tpubft_torch.ops import ecdsa_cuda as ec
    from tpubft_torch.tools.timing import cuda_ms, graph_ms
    forged = [i for i in forged if i < b]
    items = testing.ecdsa_corpus(curve, b, seed=seed, forged=forged)
    t0 = time.perf_counter()
    prep = E.prepare_rlc_batch(curve, items)
    prep_ms = (time.perf_counter() - t0) * 1e3
    rlc_w, ver_w, (_, wrap_want) = testing.ecdsa_wrap_lanes(curve)
    cols = tuple(np.concatenate([c, w], axis=-1) for c, w in
                 zip(E.rlc_columns(prep, range(b)), rlc_w))
    args = E.to_tensors(cols, dev)
    got = ec.rlc(curve, *args).cpu()
    out = {"curve": curve, "batch": b, "lanes": b + 2,
           "forged": len(forged), "prep_ms": prep_ms}
    if plain:
        t0 = time.perf_counter()
        want = E.rlc_fold_plain(curve, *args).cpu()
        out["rlc_plain_ms"] = (time.perf_counter() - t0) * 1e3
        out["rlc_mismatches"] = int((got != want).sum())
    out["fold_nonzero"] = bool(got.any())
    clean = [i for i in range(b) if i not in forged] + [b]
    cargs = E.to_tensors(tuple(c[..., clean] for c in cols), dev)
    out["clean_nonzero"] = bool(ec.rlc(curve, *cargs).cpu().any())
    out["rlc_ms"] = graph_ms(lambda: ec.rlc(curve, *cargs), 3, replays=reps)
    out["rlc_host_ms"] = cuda_ms(lambda: ec.rlc(curve, *cargs), reps)
    vprep = E.prepare_batch(curve, items)
    vcols = tuple(np.concatenate([c, w], axis=-1) for c, w in
                  zip(vprep[:6], ver_w))
    vargs = E.to_tensors(vcols, dev)
    ok, x = (t.cpu() for t in ec.verify(curve, *vargs))
    host = scalar.ecdsa_verify_batch([(pk, m, s) for m, s, pk in items],
                                     curve)
    want_ok = list(host) + wrap_want
    out["verify_host_mismatches"] = int(sum(
        bool(g) != w for g, w in zip(ok.tolist(), want_ok)))
    if plain_verify:
        t0 = time.perf_counter()
        pok, px = (t.cpu() for t in E.verify_plain(curve, *vargs))
        out["verify_plain_ms"] = (time.perf_counter() - t0) * 1e3
        out["verify_mismatches"] = int((ok != pok).sum() + (x != px).sum())
    out["verify_ms"] = graph_ms(lambda: ec.verify(curve, *vargs), 3,
                                replays=reps)
    out["verify_host_ms"] = cuda_ms(lambda: ec.verify(curve, *vargs), reps)
    hitems = [(pk, m, s) for m, s, pk in items]
    scalar.reset_ecdsa_caches()
    t0 = time.perf_counter()
    scalar.ecdsa_verify_batch(hitems, curve)
    out["host_engine_cold_ms"] = (time.perf_counter() - t0) * 1e3
    # warm: the median of seven more calls (the hot combs are built
    # after repeated use, as in a cluster whose clients sign again)
    warm = []
    for _ in range(7):
        t0 = time.perf_counter()
        scalar.ecdsa_verify_batch(hitems, curve)
        warm.append((time.perf_counter() - t0) * 1e3)
    out["host_engine_ms"] = sorted(warm)[3]
    ccols = tuple(c[..., clean] for c in cols)
    fold = (curve, ccols[0], ccols[1], ccols[7], ccols[6])
    out["ops"], out["bytes"] = ec.work(*fold)
    out["field_muls"], out["field_sqrs"] = ec.field_ops(*fold)
    kc = ec.kernel_counts(*fold)
    out["kernel_field_muls"], out["kernel_chain"] = kc["field_muls"], kc["chain"]
    every = (curve, vcols[0], vcols[1], np.ones(b + 2, bool))
    out["verify_ops"], out["verify_bytes"] = ec.work(*every, per_item=True)
    out["verify_field_muls"], out["verify_field_sqrs"] = ec.field_ops(
        *every, per_item=True)
    kc = ec.kernel_counts(*every, per_item=True)
    out["verify_kernel_field_muls"] = kc["field_muls"]
    out["verify_kernel_chain"] = kc["chain"]
    return out


def crossover(curves: Sequence[str], batches: Sequence[int],
              dev: torch.device, reps: int = 7) -> Dict:
    """The ECDSA device/host crossover end to end: for each curve and
    batch B of clean signatures, the median of `reps` calls of the device
    route (ops/ecdsa.rlc_verify_batch: the host half, one launch, its
    read-back) and of the host engine (scalar.ecdsa_verify_batch, warm
    combs and key memo), after one warm-up call of each. `crossover`:
    the least B of `batches` from which the device route is the faster on
    every curve at every larger B measured."""
    import statistics
    from tpubft_torch import testing
    from tpubft_torch.crypto import scalar
    from tpubft_torch.ops import ecdsa as E

    def median_ms(fn):
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    rows, wins = [], {}
    for curve in curves:
        for b in batches:
            items = testing.ecdsa_corpus(curve, b, seed=b)
            hitems = [(pk, m, s) for m, s, pk in items]
            row = {"curve": curve, "batch": b,
                   "device_ms": median_ms(
                       lambda: E.rlc_verify_batch(curve, items, dev)),
                   "host_engine_ms": median_ms(
                       lambda: scalar.ecdsa_verify_batch(hitems, curve))}
            rows.append(row)
            wins.setdefault(b, []).append(
                row["device_ms"] <= row["host_engine_ms"])
    cross = None
    for b in sorted(wins, reverse=True):
        if not all(wins[b]):
            break
        cross = b
    return {"rows": rows, "crossover": cross}


def _chip_smoke():
    """The repository's chip_smoke.py (its bound and nvidia-smi
    helpers), imported from the checkout's root."""
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[2])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


_CLUSTER_RUN = """
import json, sys, torch
sys.path.insert(0, {root!r})
import chip_smoke
try:
    chip_smoke.phase_ecdsa_ledger_replica(torch, torch.device("cuda", 0))
except AssertionError as e:     # the phase's checks; its load line is out
    print(json.dumps({{"problems": str(e)}}))
"""


def cluster_crossover(values: Sequence[int]) -> List[Dict]:
    """Config 3's cluster (chip_smoke.phase_ecdsa_ledger_replica: n=31,
    16 closed-loop clients, 300 writes) once a crossover value, each in a
    fresh process with TPUBFT_ECDSA_CROSSOVER_B set (1 << 30: every ECDSA
    group on the host engine): the load lines (requests/s, latency, RLC
    launches, ecdsa_batched_host) the phase prints, and its problems
    (with no RLC launch the phase fails by design)."""
    import os
    import subprocess
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[2])
    rows = []
    for v in values:
        env = dict(os.environ, TPUBFT_ECDSA_CROSSOVER_B=str(v))
        run = subprocess.run(
            [sys.executable, "-c", _CLUSTER_RUN.format(root=root)],
            env=env, capture_output=True, text=True, check=False)
        lines = [ln for ln in run.stdout.splitlines() if ln.startswith("{")]
        row = {"crossover": v, "rc": run.returncode}
        loads = [json.loads(ln) for ln in lines
                 if '"step": "load"' in ln]
        if loads:
            row.update(loads[-1])
        if lines and '"problems"' in lines[-1]:
            row["problems"] = json.loads(lines[-1])["problems"]
        rows.append(row)
    return rows


def problems(row: Dict) -> list:
    bad = [k for k in ("rlc_mismatches", "verify_mismatches",
                       "verify_host_mismatches") if row.get(k)]
    if not row["fold_nonzero"] and row["forged"]:
        bad.append("fold of a batch with forged lanes is 0")
    if row["clean_nonzero"]:
        bad.append("fold of the clean lanes is not 0")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[16, 128])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--crossover", type=int, nargs="+", metavar="B",
                    help="time the device route against the host engine "
                         "at these batches instead (`crossover`)")
    ap.add_argument("--cluster", type=int, nargs="+", metavar="B",
                    help="run config 3's cluster at these crossovers "
                         "instead (`cluster_crossover`)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ecdsa_probe: no card", file=sys.stderr)
        return 1
    from tpubft_torch.ops import _build, ecdsa_cuda
    dev = torch.device("cuda", 0)
    t0 = time.monotonic()
    ecdsa_cuda.library()
    if args.crossover:
        print(json.dumps(crossover(CURVES, args.crossover, dev)))
        return 0
    if args.cluster:
        for row in cluster_crossover(args.cluster):
            print(json.dumps(row), flush=True)
        return 0
    print(json.dumps({"build_s": time.monotonic() - t0,
                      "ptxas": _build.ptxas_functions(
                          _build.ptxas_report.get("ecdsa", ""))}),
          flush=True)
    probes = {curve: ecdsa_cuda.probe(curve, dev) for curve in CURVES}
    for curve in CURVES:
        print(json.dumps(probes[curve]), flush=True)
    smoke = _chip_smoke()
    clock = float(smoke.nvidia_smi("clocks.max.sm").split()[0])
    bad = []
    for curve in CURVES:
        for b in args.batches:
            row = measure(curve, b, dev, seed=b, reps=args.reps)
            for pre in ("", "verify_"):
                row[pre + "chain_floor_ms"] = ecdsa_cuda.chain_floor_ms(
                    row[pre + "kernel_chain"], probes[curve], clock)
                row[pre + "bound_ms"] = smoke.work_bound_ms(
                    row[pre + "ops"], row[pre + "bytes"], clock)["bound_ms"]
            print(json.dumps(row), flush=True)
            bad += [f"{curve} B={b}: {p}" for p in problems(row)]
    if bad:
        print("ecdsa_probe: " + "; ".join(bad), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
