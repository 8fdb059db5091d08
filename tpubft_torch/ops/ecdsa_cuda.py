"""Wrapper of the hand-written Hopper ECDSA kernels (csrc/ecdsa.cu), the
port of tpubft/ops/ecdsa.py's make_rlc_kernel (rlc_fold_body) and
make_verify_kernel's kernel.

Contract: `rlc(curve, u1, u2, qx, qy, xr, xrpn, wrap_ok, active, a)` takes
seven int32 (8, B) word tensors (the canonical integers' little-endian
32-bit words, as ops/ecdsa.to_tensors builds them) and two bool (B,)
masks on one card and returns the fold sum_i a_i rho_i as an int32 (8,)
tensor of canonical words (0: the batch passes); `verify(curve, u1, u2,
qx, qy, r, r_plus_n)` takes six int32 (8, B) tensors and returns
(verdicts bool (B,), affine x int32 (8, B)). Built by nvcc at first use
(ops/_build.py) and bound with ctypes. The wrapper checks device, dtype,
shape and contiguity, allocates the outputs and the fold's scratch (one
partial sum a CTA) with torch.empty, plans the CTAs (`lanes_per_cta`),
passes G's fixed-base table (`g_table`: made from the curve's
parameters and copied to the card once a curve and device), launches on
the caller's current stream, raises if cudaGetLastError reports a
failed launch, and counts its launches in LAUNCHES (one per call, where
the kernels are launched, and nowhere else; `rlc` is two kernels, the
fold and the sum of its partials). There is no fallback: CPU tensors are
refused here and take the plain versions through
ops/ecdsa.rlc_fold_kernel / verify_kernel.

Also here: the kernel's clock64 probe (`probe`), the work the function
needs on given scalars (`field_ops`, `work`) for the bound chip_smoke.py
prints, and what the kernel runs (`kernel_counts`: its field products
and its longest chain, which `chain_floor_ms` prices at the probe's
cycles).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from tpubft_torch.ops import _build

LAUNCHES: Dict[str, int] = {"ecdsa_rlc": 0, "ecdsa_verify": 0}

SOURCES = ("ecdsa.cu",)
CURVE_INDEX = {"secp256k1": 0, "secp256r1": 1}
LPC = 16            # lanes a CTA at most (EC_LPC in csrc/ecdsa.cu)

# What the kernel's formulas cost in field products (squarings counted as
# products): a Jacobian doubling 3M + 4S (a = 0) or 4M + 4S (a = -3), an
# addition 12M + 4S, a mixed addition 8M + 3S; phi(Q)'s X one more.
MULS_DBL = {"secp256k1": 7, "secp256r1": 8}
MULS_ADD = 16
MULS_MADD = 11
# The inversion of ecdsa_verify: a^1 .. a^15 (14 products), then 4
# squarings a nibble of p - 2 below its top one and a product a nonzero
# nibble below it.
INV_TABLE = 14
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    lib = _build.load("ecdsa", SOURCES)
    lib.ecdsa_rlc_launch.argtypes = [_I] + [_P] * 10 + [_I, _I] + [_P] * 3
    lib.ecdsa_rlc_launch.restype = _I
    lib.ecdsa_verify_launch.argtypes = [_I] + [_P] * 7 + [_I, _I] + [_P] * 3
    lib.ecdsa_verify_launch.restype = _I
    lib.ecdsa_probe_launch.argtypes = [_I, _I] + [_P] * 4
    lib.ecdsa_probe_launch.restype = _I
    lib.ecdsa_error_string.argtypes = [_I]
    lib.ecdsa_error_string.restype = ctypes.c_char_p
    return lib


def lanes_per_cta(b: int, sms: int) -> int:
    """Lanes a CTA: as few as spread b lanes over the card's SMs (csrc's
    ec_lanes_per_cta), at most LPC."""
    return min(max(-(-b // max(sms, 1)), 1), LPC)


@functools.lru_cache(maxsize=None)
def g_table_words(curve_name: str) -> np.ndarray:
    """G's fixed-base table in the kernel's layout: window j, digit d at
    words (j 128 + d - 1) 16, affine x then y, canonical (uint32)."""
    from tpubft_torch.ops.ecdsa import fixed_base_table, words_of
    pts = [pt for row in fixed_base_table(curve_name) for pt in row]
    xs, ys = words_of([x for x, _ in pts]), words_of([y for _, y in pts])
    return np.ascontiguousarray(np.concatenate([xs.T, ys.T], 1).reshape(-1))


@functools.lru_cache(maxsize=None)
def g_table(curve_name: str, dev: torch.device) -> torch.Tensor:
    """g_table_words on the card, copied once a curve and device."""
    return torch.from_numpy(g_table_words(curve_name).view(np.int32)).to(dev)


@functools.lru_cache(maxsize=None)
def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device}); "
                         "CPU tensors take the plain version")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} (got {t.dtype})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)} "
                         f"(got {tuple(t.shape)})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _curve(curve_name: str) -> int:
    if curve_name not in CURVE_INDEX:
        raise ValueError(f"unknown curve {curve_name}")
    return CURVE_INDEX[curve_name]


def _check_words(words, names) -> Tuple[torch.device, int]:
    dev = words[0].device
    if words[0].dim() != 2 or words[0].shape[0] != 8 \
            or words[0].shape[1] < 1:
        raise ValueError(f"{names[0]} must have shape (8, B), B >= 1 "
                         f"(got {tuple(words[0].shape)})")
    b = words[0].shape[1]
    for t, name in zip(words, names):
        _require(t, name, torch.int32, (8, b), dev)
    return dev, b


def _raise(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} CUDA launch failed: "
                           f"{lib.ecdsa_error_string(err).decode()}")


def rlc(curve_name: str, u1, u2, qx, qy, xr, xrpn, wrap_ok, active, a
        ) -> torch.Tensor:
    """The RLC fold of B lanes -> int32 (8,) canonical words, on the card
    (not synchronised)."""
    curve = _curve(curve_name)
    dev, b = _check_words((u1, u2, qx, qy, xr, xrpn, a),
                          ("u1", "u2", "qx", "qy", "xr", "xrpn", "a"))
    _require(wrap_ok, "wrap_ok", torch.bool, (b,), dev)
    _require(active, "active", torch.bool, (b,), dev)
    lib = library()
    gtab = g_table(curve_name, dev)
    lpc = lanes_per_cta(b, _sms(dev))
    out = torch.empty(8, dtype=torch.int32, device=dev)
    partial = torch.empty(-(-b // lpc) * 8, dtype=torch.int32, device=dev)
    err = lib.ecdsa_rlc_launch(
        curve, *(t.data_ptr() for t in (u1, u2, qx, qy, xr, xrpn, wrap_ok,
                                        active, a, gtab)),
        b, lpc, partial.data_ptr(), out.data_ptr(), _stream(dev))
    _raise(lib, err, "ecdsa_rlc")
    LAUNCHES["ecdsa_rlc"] += 1
    return out


def verify(curve_name: str, u1, u2, qx, qy, r, r_plus_n
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-item verify of B lanes -> (verdicts bool (B,), x int32 (8, B)),
    on the card (not synchronised)."""
    curve = _curve(curve_name)
    dev, b = _check_words((u1, u2, qx, qy, r, r_plus_n),
                          ("u1", "u2", "qx", "qy", "r", "r_plus_n"))
    lib = library()
    gtab = g_table(curve_name, dev)
    ok = torch.empty(b, dtype=torch.bool, device=dev)
    x = torch.empty((8, b), dtype=torch.int32, device=dev)
    err = lib.ecdsa_verify_launch(
        curve, *(t.data_ptr() for t in (u1, u2, qx, qy, r, r_plus_n, gtab)),
        b, lanes_per_cta(b, _sms(dev)), ok.data_ptr(), x.data_ptr(),
        _stream(dev))
    _raise(lib, err, "ecdsa_verify")
    LAUNCHES["ecdsa_verify"] += 1
    return ok, x


# ---------------- work, for the bound ----------------
#
# What the function needs a lane, T = [u1]G + [u2]Q and its x against r,
# at the cheapest known way on the run's scalars, in products (M) and
# squarings (S) apart:
#  * Jacobian formulas (a bound may take their exceptions as branches):
#    a doubling 2M + 5S for a = 0 (dbl-2009-l), 3M + 5S for a = -3
#    (dbl-2001-b); every addition priced as the mixed one, 7M + 4S
#    (madd-2007-bl);
#  * G is fixed, so its multiples are affine tables made off line:
#    either [u1]G alone, one addition a nonzero signed digit of u1 in
#    base 2^w (w = 2..8, a table a digit position, no doubling) and one
#    to join it to [u2]Q, or u1's width-w NAF (w = 2..8) in Q's chain;
#  * [u2]Q: width-w NAF (w = 2..7), a table of odd multiples (one
#    doubling and 2^(w-2) - 1 additions), a doubling a digit below the
#    chain's top, an addition a nonzero digit; on secp256k1 also the GLV
#    split (the host engine's, crypto/scalar._glv_split) of u2 and, in
#    the chain, of u1, the halves sharing the doublings and phi(Q)'s
#    table made from Q's at 1M an entry;
#  * each scalar k or n - k, whichever is cheaper (negation is free);
#  * the fold's residual with x = X / Z^2: d1 = X - r Z^2 (1S + 1M), on a
#    wrap lane d2 and rho = d1 d2 (2M), the weight a rho (1M);
#  * the per-item verify's affine x: Montgomery's batch inversion over
#    the launch (3M a lane, one inversion of 255S + 15M by an addition
#    chain) and x = X (1/Z)^2 (1S + 1M a lane).
# Operations (the IMAD count, additions left out): a product of eight
# 32-bit words is 64 wide multiply-adds (schoolbook), a squaring 36, each
# IMAD.WIDE two 32-bit operations; the reduction by the prime's shape:
# secp256k1's p = 2^256 - 2^32 - 977 folds the high half by 977 and a
# shift (8 wide multiply-adds, 2 more for the carry word), P-256's
# Solinas prime by additions and subtractions of words alone.
DBL = {"secp256k1": (2, 5), "secp256r1": (3, 5)}
MADD = (7, 4)
INV = (15, 255)
OPS_REDUCE = {"secp256k1": 2 * (8 + 2), "secp256r1": 0}
OPS_MUL, OPS_SQR = 2 * 64, 2 * 36
G_WIDTHS = range(2, 9)
Q_WIDTHS = range(2, 8)


def op_cost(curve_name: str, muls: int, sqrs: int) -> int:
    """32-bit multiply operations of `muls` products and `sqrs`
    squarings on this curve's field."""
    red = OPS_REDUCE[curve_name]
    return muls * (OPS_MUL + red) + sqrs * (OPS_SQR + red)


def _ints(words: np.ndarray):
    """(8, B) uint32 or int32 words -> B Python ints."""
    from tpubft_torch.ops.ecdsa import int_of
    w = np.asarray(words)
    return [int_of(w[:, i]) for i in range(w.shape[1])]


@functools.lru_cache(maxsize=1 << 16)
def _wnaf(k: int, w: int) -> Tuple[int, int]:
    """(length, nonzero digits) of k's width-w NAF."""
    length = nonzero = 0
    while k:
        if k & 1:
            d = k & ((1 << w) - 1)
            k -= d - (1 << w) if d >= 1 << (w - 1) else d
            nonzero += 1
        k >>= 1
        length += 1
    return length, nonzero


@functools.lru_cache(maxsize=1 << 16)
def _fixed_digits(k: int, w: int) -> int:
    """Nonzero digits of k in base 2^w, digits in [-2^(w-1), 2^(w-1))."""
    nonzero = 0
    while k:
        d = k & ((1 << w) - 1)
        k >>= w
        if d >= 1 << (w - 1):
            k += 1
        nonzero += d != 0
    return nonzero


def _halves(curve_name: str, k: int) -> List[Tuple[int, ...]]:
    """The ways to run k: [(k,), (n - k,)] and on secp256k1 its GLV
    halves (|k1|, |k2|)."""
    from tpubft_torch.crypto import scalar
    from tpubft_torch.ops.ecdsa import CURVES
    n = CURVES[curve_name]["n"]
    ways = [(k,), (n - k,)] if k else [(0,)]
    glv = scalar._GLV_PARAMS.get(curve_name)
    if glv is not None and k:
        a, _, b, _ = scalar._glv_split(k, glv, n)
        ways.append((a, b))
    return ways


def _chain(curve_name: str, dbl: int, adds: int,
           extra: Tuple[int, int] = (0, 0)) -> Tuple[int, int]:
    """(M, S) of `dbl` doublings, `adds` additions and `extra`."""
    (dm, ds), (am, as_) = DBL[curve_name], MADD
    return dbl * dm + adds * am + extra[0], dbl * ds + adds * as_ + extra[1]


def ladder_ops(curve_name: str, u1: int, u2: int) -> Tuple[int, int]:
    """(M, S) of T = [u1]G + [u2]Q at the cheapest of the ways above."""
    best = None
    for q in _halves(curve_name, u2):
        for wq in Q_WIDTHS:
            qn = [_wnaf(k, wq) for k in q if k]
            entries = (1 << (wq - 2)) if wq >= 3 else 1
            # the table of odd multiples and phi's copy of it (GLV)
            tab = _chain(curve_name, int(wq >= 3), entries - 1,
                         (entries if len(q) == 2 else 0, 0))
            qlen = max((ln for ln, _ in qn), default=0)
            qadd = sum(nz for _, nz in qn)
            for g in _halves(curve_name, u1):
                for wg in G_WIDTHS:
                    # u1 in Q's chain, or (one scalar) on its own
                    # fixed-base tables: no doubling, joined once
                    gn = [_wnaf(k, wg) for k in g if k]
                    ways = [(max([qlen] + [ln for ln, _ in gn]),
                             sum(nz for _, nz in gn))]
                    if len(g) == 1:
                        ways.append((qlen, _fixed_digits(g[0], wg)))
                    for length, gadd in ways:
                        c = _chain(curve_name, max(length - 1, 0),
                                   max(qadd + gadd - 1, 0), tab)
                        if best is None or op_cost(curve_name, *c) < \
                                op_cost(curve_name, *best):
                            best = c
    return best


def field_ops(curve_name: str, u1, u2, active, wrap_ok=None,
              per_item: bool = False) -> Tuple[int, int]:
    """(products, squarings) the function needs on these scalars, active
    lanes only: each lane's `ladder_ops`, then the fold's residual and
    weight (per_item False) or the per-item verify's share of the batch
    inversion and its affine x (per_item True)."""
    on = np.asarray(active, bool)
    wrap = np.zeros(on.size, bool) if wrap_ok is None \
        else np.asarray(wrap_ok, bool)
    muls = sqrs = 0
    for k1, k2, live, w in zip(_ints(u1), _ints(u2), on, wrap):
        if not live:
            continue
        m, s = ladder_ops(curve_name, k1, k2)
        if per_item:
            m, s = m + 3 + 1, s + 1
        else:
            m, s = m + 2 + 2 * int(w), s + 1
        muls, sqrs = muls + m, sqrs + s
    if per_item and on.any():
        muls, sqrs = muls - 3 + INV[0], sqrs + INV[1]
    return muls, sqrs


def _lane_steps(curve_name: str, k1: int, k2: int, live: bool,
                wrap: bool, per_item: bool) -> Dict[str, int]:
    """What one lane's two threads run (csrc/ecdsa.cu) on these scalars,
    as formula calls and single products: `q` the [u2]Q thread up to the
    join, `g` the [u1]G thread, `tail` the join and the lane's end. An
    addition into the identity (a chain's first nonzero digit) computes
    nothing but phi(Q)'s X; an exceptional addition (P = Q inside a
    chain, a crafted lane's) is counted as an addition."""
    from tpubft_torch.crypto import scalar
    from tpubft_torch.ops import ecdsa as E
    zero = {"dbl": 0, "add": 0, "madd": 0, "mul": 0}
    out = {"q": dict(zero), "g": dict(zero), "tail": dict(zero)}
    if not live:
        return out
    n = E.CURVES[curve_name]["n"]
    glv = scalar._GLV_PARAMS.get(curve_name)
    nq = E.Q_DIGITS[curve_name]
    cols = ([E.signed_digits(h, E.Q_WINDOW, nq) for h in
             scalar._glv_split(k2, glv, n)[::2]] if glv is not None
            else [E.signed_digits(k2, E.Q_WINDOW, nq)])
    q = out["q"]
    half = 1 << (E.Q_WINDOW - 1)
    q["dbl"], q["madd"] = half // 2, half // 2 - 1          # the table
    started = False
    for j in range(nq - 1, -1, -1):
        if j < nq - 1:
            q["dbl"] += E.Q_WINDOW
        for c, dig in enumerate(cols):
            if dig[j]:
                q["mul"] += c            # phi's X
                q["add"] += started
                started = True
    g = out["g"]
    nz = sum(d != 0 for d in E.signed_digits(k1, E.G_WINDOW, E.G_DIGITS))
    g["madd"] = max(nz - 1, 0)
    t = out["tail"]
    t["add"] = int(started and nz > 0)
    if per_item:
        p = E.CURVES[curve_name]["p"]
        nib = [(p - 2) >> (4 * j) & 15 for j in range(63, -1, -1)]
        t["mul"] = INV_TABLE + 4 * (len(nib) - 1) + sum(
            v != 0 for v in nib[1:]) + 2
    else:
        t["mul"] = 4 + int(wrap)
    return out


def _muls(curve_name: str, steps: Dict[str, int]) -> int:
    return (steps["dbl"] * MULS_DBL[curve_name] + steps["add"] * MULS_ADD
            + steps["madd"] * MULS_MADD + steps["mul"])


def kernel_counts(curve_name: str, u1, u2, active, wrap_ok=None,
                  per_item: bool = False) -> Dict:
    """What the kernel runs on these inputs: `field_muls`, its field
    products (squarings included) over every lane (the RLC launch's
    inactive lanes run nothing; the verify launch runs every lane), and
    `chain`, the formula calls and single products on the longest
    dependent path of a lane (the longer of its two threads, then the
    join and the end)."""
    wrap = np.zeros(len(active), bool) if wrap_ok is None \
        else np.asarray(wrap_ok)
    total, chain, worst = 0, None, -1
    for k1, k2, on, w in zip(_ints(u1), _ints(u2), np.asarray(active),
                             wrap):
        st = _lane_steps(curve_name, k1, k2, bool(on) or per_item,
                         bool(w), per_item)
        total += sum(_muls(curve_name, v) for v in st.values())
        path = max(st["q"], st["g"], key=lambda v: _muls(curve_name, v))
        path = {k: path[k] + st["tail"][k] for k in path}
        if _muls(curve_name, path) > worst:
            chain, worst = path, _muls(curve_name, path)
    return {"field_muls": total, "chain": chain}


def kernel_field_muls(curve_name: str, u1, u2, active, wrap_ok=None,
                      per_item: bool = False) -> int:
    """Field products (squarings included) the kernel runs on these
    inputs (`kernel_counts`)."""
    return kernel_counts(curve_name, u1, u2, active, wrap_ok,
                         per_item)["field_muls"]


def chain_floor_ms(chain: Dict[str, int], probed: Dict,
                   sm_clock_mhz: float) -> float:
    """The least time a launch takes: its longest chain (`kernel_counts`)
    at the probe's cycles a doubling, addition, mixed addition and
    product, at the SM clock."""
    cycles = (chain["dbl"] * probed["cycles_per_dbl"]
              + chain["add"] * probed["cycles_per_add"]
              + chain["madd"] * probed["cycles_per_madd"]
              + chain["mul"] * probed["cycles_per_field_mul"])
    return cycles / (sm_clock_mhz * 1e3)


def probe(curve_name: str, dev: torch.device, iters: int = 1024) -> Dict:
    """clock64 cycles on one thread of the card (csrc's
    ecdsa_probe_kernel): a product, a squaring, a Montgomery product and
    a step of two products side by side (each of `iters` dependent ones),
    a doubling, an addition and a mixed addition (each of iters / 8)."""
    lib = library()
    stamps = torch.zeros(7, dtype=torch.int64, device=dev)
    sink = torch.zeros(8, dtype=torch.int32, device=dev)
    _raise(lib, lib.ecdsa_probe_launch(
        _curve(curve_name), iters, g_table(curve_name, dev).data_ptr(),
        stamps.data_ptr(), sink.data_ptr(), _stream(dev)), "ecdsa_probe")
    mul, sqr, mont, pair, dbl, add, madd = stamps.tolist()
    steps = iters // 8
    return {"curve": curve_name, "cycles_per_field_mul": mul / iters,
            "cycles_per_sqr": sqr / iters,
            "cycles_per_mont_mul": mont / iters,
            "cycles_per_mul_pair": pair / iters,
            "cycles_per_dbl": dbl / steps, "cycles_per_add": add / steps,
            "cycles_per_madd": madd / steps}


def work(curve_name: str, u1, u2, active, wrap_ok=None,
         per_item: bool = False) -> Tuple[int, int]:
    """(32-bit operations, bytes) the function needs: `field_ops` priced
    by `op_cost`; each input read once (seven (8, B) word arrays and two
    (B,) masks for the fold, six arrays for the verify) and each output
    written once."""
    b = np.asarray(u1).shape[1]
    ops = op_cost(curve_name, *field_ops(curve_name, u1, u2, active,
                                         wrap_ok, per_item))
    if per_item:
        nbytes = 6 * 32 * b + b + 32 * b
    else:
        nbytes = 7 * 32 * b + 2 * b + 32
    return ops, nbytes
