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
partial sum a CTA of 64 lanes) with torch.empty, launches on the
caller's current stream, raises if cudaGetLastError reports a failed
launch, and counts its launches in LAUNCHES (one per call, where the
kernels are launched, and nowhere else; `rlc` is two kernels, the fold
and the sum of its partials). There is no fallback: CPU tensors are
refused here and take the plain versions through
ops/ecdsa.rlc_fold_kernel / verify_kernel.

Also here: the work the function needs on given scalars (`field_ops`,
`work`) for the bound chip_smoke.py prints, and the kernel's own
products (`kernel_field_muls`).
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
CTA = 64            # lanes a CTA (EC_CTA in csrc/ecdsa.cu)

# The kernel's own: one complete addition (csrc/ecdsa.cu pt_add) is 14
# products for a = 0 and 18 for a = -3; it serves the doubling too. Each
# is a CIOS product of eight 32-bit words: 64 a_i b_j and 64 m p_j wide
# multiply-adds (each IMAD.WIDE counted as two 32-bit operations) and 8
# low multiplies for m.
MULS_PT_ADD = {"secp256k1": 14, "secp256r1": 18}
OPS_PER_FIELD_MUL = 2 * (64 + 64) + 8

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    lib = _build.load("ecdsa", SOURCES)
    lib.ecdsa_rlc_launch.argtypes = [_I] + [_P] * 9 + [_I] + [_P] * 3
    lib.ecdsa_rlc_launch.restype = _I
    lib.ecdsa_verify_launch.argtypes = [_I] + [_P] * 6 + [_I] + [_P] * 3
    lib.ecdsa_verify_launch.restype = _I
    lib.ecdsa_error_string.argtypes = [_I]
    lib.ecdsa_error_string.restype = ctypes.c_char_p
    return lib


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
    out = torch.empty(8, dtype=torch.int32, device=dev)
    partial = torch.empty((b + CTA - 1) // CTA * 8, dtype=torch.int32,
                          device=dev)
    err = lib.ecdsa_rlc_launch(
        curve, *(t.data_ptr() for t in (u1, u2, qx, qy, xr, xrpn, wrap_ok,
                                        active, a)),
        b, partial.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
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
    ok = torch.empty(b, dtype=torch.bool, device=dev)
    x = torch.empty((8, b), dtype=torch.int32, device=dev)
    err = lib.ecdsa_verify_launch(
        curve, *(t.data_ptr() for t in (u1, u2, qx, qy, r, r_plus_n)), b,
        ok.data_ptr(), x.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
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


def kernel_field_muls(curve_name: str, u1, u2, active, wrap_ok=None,
                      per_item: bool = False) -> int:
    """Field multiplies the kernel runs on these inputs: per active lane
    two conversions of Q, one complete addition for G + Q, 256 for the
    doublings and one a nonzero digit; then the RLC lane's conversions
    and residual products (6, 2 more where wrap_ok) or the verify lane's
    Fermat inversion (256 squarings and a product a set bit of p - 2)
    and 2 for x; the RLC sum's conversion out once."""
    from tpubft_torch.ops.ecdsa import CURVES
    pt = MULS_PT_ADD[curve_name]
    pm2 = bin(CURVES[curve_name]["p"] - 2).count("1")
    wrap = np.zeros(len(active), bool) if wrap_ok is None else wrap_ok
    total = 0 if per_item else 1
    for k1, k2, on, w in zip(_ints(u1), _ints(u2), np.asarray(active),
                             np.asarray(wrap)):
        if not on and not per_item:
            continue
        digits = bin(k1 | k2).count("1")
        total += 2 + pt * (1 + 256 + digits)
        total += (256 + pm2 + 2) if per_item else (6 + 2 * int(w))
    return total


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
