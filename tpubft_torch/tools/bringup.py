"""Bring-up ladder of the port's Hopper kernels (port of
tools/pallas_bringup.py).

    python -m tpubft_torch.tools.bringup             # whole ladder, card
    python -m tpubft_torch.tools.bringup --rung 3    # one rung
    python -m tpubft_torch.tools.bringup --cpu       # the plain versions

Six rungs in the reference's order, each building on the constructs of
the one before, each a kernel launched on random inputs at the
reference's TILE of 1024 lanes and checked against Python-int
arithmetic (the reference's own condition) and against its plain
PyTorch version:

  0  copy           bringup_copy: (24, n) block in/out plus a constant
  1  carry          fe_carry: the 24-limb normalize on 7x loose limbs,
                    which must equal f25519.normalize limb for limb
  2  mul            fe_mul: field multiply
  3  inv            fe_inv: the 254-square inversion chain (csrc/fe_inv.cu,
                    four lanes an element at the ladder's 1024)
  4  table          fe_table_gather: a..a^4 table in shared memory,
                    selected per lane, times the base niels column 0
  5  full-verify    ed25519_verify on the strict-verify corpus, against
                    the plain verify (raw lanes) and the host scalar
                    verdicts

The ladder stops at the first rung that fails and exits non-zero. With
--cpu every rung runs the kernel's plain version on CPU tensors (the
counterpart of the reference's --interpret); that checks the ladder and
the plain versions, not the kernels.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from tpubft_torch.ops import bringup_cuda as bu
from tpubft_torch.ops import ed25519_cuda as kc
from tpubft_torch.ops import f25519 as F

NL = F.NL
TILE = 1024


@dataclass
class Rung:
    """One rung's result. `run` and `plain` re-run the kernel (on the
    CPU: its plain version) and the plain version on the rung's inputs,
    for timing."""
    report: Dict
    run: Callable[[], torch.Tensor]
    plain: Callable[[], torch.Tensor]

    @property
    def ok(self) -> bool:
        return (self.report["mismatches_vs_int"] == 0
                and self.report["mismatches_vs_plain"] == 0)


def _rand_elems(rng: np.random.Generator, n: int) -> np.ndarray:
    """(NL, n) limbs of n random field elements (the reference's draw)."""
    vals = [int.from_bytes(rng.bytes(32), "little") % F.P for _ in range(n)]
    return np.stack([F.int_to_limbs(v) for v in vals], axis=1).astype(np.int32)


def _plain_mul(a, b):
    return F.canonical(F.mul(a, b))


def _plain_inv(a):
    return F.canonical(F.inv(a))


def _routed(kernel, plain):
    """The kernel for CUDA tensors (it raises if it cannot run), its
    plain version for CPU tensors."""
    return lambda *args: (kernel if args[0].device.type == "cuda"
                          else plain)(*args)


_copy = _routed(bu.bringup_copy, bu.plain_copy)
_carry = _routed(bu.fe_carry, bu.plain_carry)
_fe_mul = _routed(kc.fe_mul, _plain_mul)
_fe_inv = _routed(bu.fe_inv, _plain_inv)
_table = _routed(bu.fe_table_gather, bu.plain_table_gather)


def _lane_mismatches(got: np.ndarray, want: np.ndarray) -> int:
    """Lanes (last axis) where any entry differs."""
    diff = got != want
    return int(diff.reshape(-1, diff.shape[-1]).any(axis=0).sum())


def _limb_rung(rung: int, name: str, kernel: str, fn, plain_fn,
               args: Sequence[torch.Tensor], want: np.ndarray,
               by_value: bool = False) -> Rung:
    """A rung on (24, n) limbs: `want` is the int check's expected limbs
    (compared mod p lane by lane when `by_value`)."""
    got = fn(*args).cpu().numpy()
    plain = plain_fn(*args).cpu().numpy()
    if by_value:
        n = got.shape[1]
        vs_int = sum(F.limbs_to_int(got[:, i]) != F.limbs_to_int(want[:, i])
                     for i in range(n))
    else:
        vs_int = _lane_mismatches(got, want)
    report = {"rung": rung, "name": name, "kernel": kernel,
              "lanes": got.shape[1], "mismatches_vs_int": int(vs_int),
              "mismatches_vs_plain": _lane_mismatches(got, plain),
              "max_abs_err": int(np.abs(got.astype(np.int64)
                                        - plain.astype(np.int64)).max())}
    return Rung(report, lambda: fn(*args), lambda: plain_fn(*args))


def rung0(rng, dev, lanes: int) -> Rung:
    a = _rand_elems(rng, lanes)
    return _limb_rung(0, "copy", "bringup_copy", _copy, bu.plain_copy,
                      [torch.from_numpy(a).to(dev)], a + bu.COPY_ADDEND)


def rung1(rng, dev, lanes: int) -> Rung:
    a = _rand_elems(rng, lanes) * 7           # force carries
    # the reference's check: the value mod p is unchanged
    return _limb_rung(1, "carry", "fe_carry", _carry, bu.plain_carry,
                      [torch.from_numpy(a).to(dev)], a, by_value=True)


def rung2(rng, dev, lanes: int) -> Rung:
    a, b = _rand_elems(rng, lanes), _rand_elems(rng, lanes)
    want = np.stack([F.int_to_limbs(F.limbs_to_int(a[:, i])
                                    * F.limbs_to_int(b[:, i]))
                     for i in range(lanes)], 1)
    return _limb_rung(2, "mul", "fe_mul", _fe_mul, _plain_mul,
                      [torch.from_numpy(a).to(dev),
                       torch.from_numpy(b).to(dev)], want)


def rung3(rng, dev, lanes: int) -> Rung:
    a = _rand_elems(rng, lanes)
    want = np.stack([F.int_to_limbs(pow(F.limbs_to_int(a[:, i]), F.P - 2,
                                        F.P)) for i in range(lanes)], 1)
    return _limb_rung(3, "inv", "fe_inv", _fe_inv, _plain_inv,
                      [torch.from_numpy(a).to(dev)], want)


def base_niels_col0() -> int:
    """Column 0 of the reference's transposed base niels table: entry
    [0]B's y+x (the niels identity, 1)."""
    from tpubft_torch.ops import ed25519
    return ed25519._base_niels_ints()[0][0]


def rung4(rng, dev, lanes: int) -> Rung:
    a = _rand_elems(rng, lanes)
    col0 = base_niels_col0()
    want = np.stack([F.int_to_limbs(
        pow(F.limbs_to_int(a[:, i]), (int(a[0, i]) & 3) + 1, F.P) * col0)
        for i in range(lanes)], 1)
    col = torch.from_numpy(F.int_to_limbs(col0)).to(dev)
    return _limb_rung(4, "table", "fe_table_gather", _table,
                      bu.plain_table_gather,
                      [torch.from_numpy(a).to(dev), col], want)


def rung5(rng, dev, lanes: int) -> Rung:
    from tpubft_torch import testing
    from tpubft_torch.crypto import scalar
    from tpubft_torch.ops import ed25519 as ops
    items = testing.ed25519_corpus(lanes, seed=int(rng.integers(1 << 30)))
    prep = ops.prepare_batch(items)
    args = ops.to_tensors(ops._pad_rows(prep, lanes, lanes), dev)
    got = ops.verify_kernel(*args).cpu().numpy()
    plain = got if dev.type == "cpu" else \
        ops.plain_verify_kernel(*args).cpu().numpy()
    host = np.array([scalar.ed25519_verify(pk, m, s) for m, s, pk in items])
    report = {"rung": 5, "name": "full-verify", "kernel": "ed25519_verify",
              "lanes": lanes,
              "mismatches_vs_int": int(((got & prep.host_valid)
                                        != host).sum()),
              "mismatches_vs_plain": int((got != plain).sum()),
              "max_abs_err": int(np.abs(got.astype(np.int64)
                                        - plain.astype(np.int64)).max()),
              "valid": int(host.sum())}
    return Rung(report, lambda: ops.verify_kernel(*args),
                lambda: ops.plain_verify_kernel(*args))


RUNGS = [rung0, rung1, rung2, rung3, rung4, rung5]


def run_ladder(device: torch.device, rungs: Optional[Sequence[int]] = None,
               lanes: int = TILE, seed: int = 7,
               log: Optional[Callable[[Rung, float], None]] = None
               ) -> List[Rung]:
    """Run the rungs in order on `device`; stop after the first that
    fails (it is the last in the returned list, with `ok` False)."""
    out = []
    for i in (range(len(RUNGS)) if rungs is None else rungs):
        t0 = time.perf_counter()
        r = RUNGS[i](np.random.default_rng(seed), device, lanes)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if log is not None:
            log(r, time.perf_counter() - t0)
        out.append(r)
        if not r.ok:
            break
    return out


def _print(r: Rung, seconds: float) -> None:
    state = "OK" if r.ok else "FAIL"
    print(f"rung {r.report['name']}: {state} ({seconds:.1f}s) "
          f"{json.dumps(r.report)}", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rung", type=int, default=None,
                    choices=range(len(RUNGS)))
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on CPU tensors")
    ap.add_argument("--lanes", type=int, default=TILE,
                    help=f"lanes per rung (default: the TILE of {TILE})")
    args = ap.parse_args(argv)
    if args.cpu:
        dev = torch.device("cpu")
    elif torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        print("no CUDA device: run on the card, or pass --cpu",
              file=sys.stderr)
        return 2
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={name} lanes={args.lanes}", flush=True)
    rungs = None if args.rung is None else [args.rung]
    done = run_ladder(dev, rungs, args.lanes, log=_print)
    return 0 if all(r.ok for r in done) else 1


if __name__ == "__main__":
    sys.exit(main())
