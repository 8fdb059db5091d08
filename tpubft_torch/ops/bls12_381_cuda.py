"""Wrapper of the hand-written Hopper BLS12-381 G1 kernels
(csrc/bls12_381_msm.cu), the port of tpubft/ops/bls12_381.py's
msm_kernel, msm_batch_kernel and batch_scalar_mul's kernel.

Contract: `msm(words, px, py, infinity)` takes words int64 (8, S, K),
px/py int64 (12, S, K) and infinity bool (S, K) on one card and returns
projective (X, Y, Z), each int64 (12, S) canonical Montgomery words;
`scalar_mul` takes (8, B), (12, B), (12, B), (B,) and returns (12, B) x 3
(the same launch with S = B segments of one point). Precondition: every
point lies in the order-r subgroup (the kernel signs each scalar and
splits it by GLV, which computes [k] P only there); the callers' points
are shares and keys decompressed with the subgroup check. Built by nvcc
at first use (ops/_build.py) and bound with ctypes. The wrapper checks
device, dtype, shape and contiguity, allocates outputs and scratch with
torch.empty, launches on the caller's current stream, raises if
cudaGetLastError reports a failed launch, and counts its launches in
LAUNCHES (one per call, where the kernels are launched, and nowhere
else). There is no fallback: CPU tensors are refused here and take the
plain versions through ops/bls12_381.msm_batch_kernel / scalar_mul_kernel.

Also here: the work the function needs for given scalars (`field_muls`,
`work`), for the bound chip_smoke.py prints; the kernel's own design,
mirrored for its counts (`glv_split`, `digits`, `plan`): the multiplies
it runs and the steps of its longest chain (`kernel_counts`), which at
the probe's cycles (`probe`) are its floor (`chain_floor_ms`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from tpubft_torch.crypto.bls12381 import R
from tpubft_torch.ops import _build

LAUNCHES: Dict[str, int] = {"bls_msm": 0, "bls_mul": 0}

SOURCES = ("bls12_381_msm.cu",)

# Field multiplies of the kernel's formulas (csrc/bls12_381_msm.cu):
# doubling 8 (6M + 2S), projective addition 12; mixed addition of an
# affine point 11, which the bound's count prices the cheapest additions
# at (multiplications by b3 = 12 are additions).
MULS_DBL = 8
MULS_ADD_MIXED = 11
MULS_ADD = 12
# One CIOS product of twelve 32-bit words: 144 a_i b_j and 144 m p_j wide
# multiply-adds (each IMAD.WIDE counted as two 32-bit operations) and 12
# low multiplies for m.
OPS_PER_FIELD_MUL = 2 * (144 + 144) + 12

# The kernel's shape (csrc/bls12_381_msm.cu): a digit of WINDOW bits,
# DIGITS of them a half-scalar, at most MAX_LANES lanes (two chains each)
# a CTA, PTW words a partial point.
WINDOW = 4
DIGITS = 33
MAX_LANES = 8
PTW = 36
# lanes an element the launches take: the fastest product of the clock64
# probe on the card (tools/bls_msm_probe.py; PERF.md §6)
LANES = 4
LANE_CHOICES = (1, 2, 4)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    lib = _build.load("bls12_381_msm", SOURCES)
    lib.bls_msm_launch.argtypes = [_P] * 8 + [_I] * 3 + [_P]
    lib.bls_msm_launch.restype = _I
    lib.bls_probe_launch.argtypes = [_I, _I, _P, _P, _P]
    lib.bls_probe_launch.restype = _I
    lib.bls_error_string.argtypes = [_I]
    lib.bls_error_string.restype = ctypes.c_char_p
    return lib


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


def _check(words, px, py, infinity, lanes: Tuple[int, ...]):
    dev = words.device
    _require(words, "words", torch.int64, (8,) + lanes, dev)
    _require(px, "px", torch.int64, (12,) + lanes, dev)
    _require(py, "py", torch.int64, (12,) + lanes, dev)
    _require(infinity, "infinity", torch.bool, lanes, dev)
    return dev


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} CUDA launch failed: "
                           f"{lib.bls_error_string(err).decode()}")


def _launch(words, px, py, infinity, s: int, k: int, lanes: int,
            what: str) -> Tuple[torch.Tensor, ...]:
    dev = words.device
    lib = library()
    out = [torch.empty((12, s), dtype=torch.int64, device=dev)
           for _ in range(3)]
    # the partial points of a segment wider than a CTA: at most one a lane
    partial = torch.empty(s * k * PTW if k > MAX_LANES else 1,
                          dtype=torch.int32, device=dev)
    err = lib.bls_msm_launch(
        words.data_ptr(), px.data_ptr(), py.data_ptr(), infinity.data_ptr(),
        *(t.data_ptr() for t in out), partial.data_ptr(), s, k, lanes,
        _stream(dev))
    _raise(lib, err, what)
    LAUNCHES[what] += 1
    return tuple(out)


def msm(words: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
        infinity: torch.Tensor, lanes: int = LANES
        ) -> Tuple[torch.Tensor, ...]:
    """S segmented MSMs of K lanes -> (X, Y, Z), each (12, S), on the card
    (not synchronised). `lanes`: lanes an element, LANES but for the
    probe's comparison of the designs (tools/bls_msm_probe.py)."""
    if words.dim() != 3:
        raise ValueError(
            f"words must be (8, S, K) (got {tuple(words.shape)})")
    s, k = int(words.shape[1]), int(words.shape[2])
    dev = _check(words, px, py, infinity, (s, k))
    if s == 0 or k == 0:
        raise ValueError("msm needs S >= 1 segments of K >= 1 lanes")
    return _launch(words, px, py, infinity, s, k, lanes, "bls_msm")


def scalar_mul(words: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
               infinity: torch.Tensor, lanes: int = LANES
               ) -> Tuple[torch.Tensor, ...]:
    """[k_i] P_i for B lanes -> (X, Y, Z), each (12, B), on the card (not
    synchronised): B segments of one point, each lane's two GLV halves
    summed in its CTA."""
    if words.dim() != 2:
        raise ValueError(f"words must be (8, B) (got {tuple(words.shape)})")
    b = int(words.shape[1])
    dev = _check(words, px, py, infinity, (b,))
    if b == 0:
        raise ValueError("scalar_mul needs B >= 1 lanes")
    return _launch(words, px, py, infinity, b, 1, lanes, "bls_mul")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def probe(dev: torch.device, lanes: int, iters: int = 4096) -> dict:
    """clock64 cycles of one field product, of one step of two products
    side by side and of one doubling on one group of `lanes` lanes (csrc's
    bls_probe_kernel: `iters` dependent products, iters / 8 dependent
    doublings, `iters` dependent steps of two), on the card."""
    lib = library()
    stamps = torch.zeros(3, dtype=torch.int64, device=dev)
    sink = torch.zeros(12, dtype=torch.int32, device=dev)
    _raise(lib, lib.bls_probe_launch(lanes, iters, stamps.data_ptr(),
                                     sink.data_ptr(), _stream(dev)),
           "bls_probe")
    mul, dbl, pair = stamps.tolist()
    return {"lanes": lanes, "cycles_per_field_mul": mul / iters,
            "cycles_per_mul_pair": pair / iters,
            "cycles_per_dbl": dbl / (iters // 8)}


# ---- the work, for the bound ----

# BLS12-381's G1 endomorphism (x, y) -> (beta x, y), one field multiply,
# acts as [GLV_LAMBDA] with GLV_LAMBDA = z^2 - 1 (z = -0xd201000000010000),
# a cube root of unity mod r: a scalar k splits as k1 + k2 GLV_LAMBDA with
# k1, k2 < 2^128.
GLV_LAMBDA = 0xD201000000010000 ** 2 - 1
STRAUS_WIDTHS = range(2, 8)
PIPPENGER_WINDOWS = range(2, 17)


def _lane_scalars(words: np.ndarray, infinity: np.ndarray) -> np.ndarray:
    """(lanes,) object array of Python ints: each lane's scalar, 0 on an
    identity lane."""
    w = np.asarray(words, dtype=np.int64).reshape(8, -1)
    live = ~np.asarray(infinity, dtype=bool).reshape(-1)
    ks = np.zeros(live.size, dtype=object)
    for i in np.flatnonzero(live):
        ks[i] = sum(int(w[j, i]) << (32 * j) for j in range(8))
    return ks


def glv_split(k: int) -> Tuple[int, int, bool]:
    """The kernel's scalar prologue: k (< r) -> (k1, k2, negated) with k or
    r - k (negated), whichever is at most (r - 1) / 2, = k1 + k2
    GLV_LAMBDA, k1 < GLV_LAMBDA, k2 = its quotient by GLV_LAMBDA."""
    neg = k > (R - 1) // 2
    k = R - k if neg else k
    return k % GLV_LAMBDA, k // GLV_LAMBDA, neg


def digits(kh: int) -> List[int]:
    """The kernel's signed fixed-window recoding of a half-scalar (< 2^128),
    least significant first: digit j = nibble j of kh + 0x88..8 (DIGITS
    nibbles), less 8; sum_j d_j 16^j = kh."""
    kp = kh + sum(8 << (WINDOW * j) for j in range(DIGITS))
    return [((kp >> (WINDOW * j)) & 15) - 8 for j in range(DIGITS)]


# One chain (csrc chain()), the same on every scalar: the endomorphism's
# product, the table 2P..8P (a doubling at even m, an addition at odd),
# then 4 doublings a window below the top and one addition a digit. Its
# field multiplies, and its dependent steps: the formulas run their
# products in independent pairs (f_mul2), a doubling in STEPS_DBL steps,
# an addition in STEPS_ADD; the endomorphism's product is one single.
STEPS_DBL = 4
STEPS_ADD = 6
TABLE_DBL, TABLE_ADD = 4, 3
CHAIN_DBL = TABLE_DBL + (DIGITS - 1) * WINDOW
CHAIN_ADD = TABLE_ADD + DIGITS
CHAIN_MULS = 1 + CHAIN_DBL * MULS_DBL + CHAIN_ADD * MULS_ADD
CHAIN_STEPS = CHAIN_DBL * STEPS_DBL + CHAIN_ADD * STEPS_ADD


def plan(s: int, k: int, sms: int) -> dict:
    """The kernel's launch plan (csrc bls_plan): CTAs of `piece` lanes of
    one segment, or `spc` whole segments of at most MAX_LANES lanes, as few
    lanes a CTA as spread the lanes over `sms` SMs; a wider segment is
    `pps` pieces, summed by a second launch of `reduce_groups` groups."""
    t = min(max(-(-s * k // max(sms, 1)), 1), MAX_LANES)
    if k <= MAX_LANES:
        piece, spc, pps = k, max(1, t // k), 1
        ctas = -(-s // spc)
    else:
        piece, spc = t, 1
        pps = -(-k // piece)
        ctas = s * pps
    return {"piece": piece, "spc": spc, "pps": pps, "ctas": ctas,
            "chains": spc * 2 * piece,
            "reduce_groups": min(pps, 2 * MAX_LANES) if pps > 1 else 0}


def _depth(n: int) -> int:
    """Levels of the kernel's tree over n sums."""
    return max(n - 1, 0).bit_length()


def kernel_counts(s: int, k: int, sms: int) -> dict:
    """What the kernel runs for S segments of K lanes (B multiplies: S = B,
    K = 1), whatever the scalars: `field_muls`, every chain of every CTA
    and every addition of the trees and of the second launch (each group
    adds at each level); `chain_steps`, the paired product steps on its
    longest dependent path (a chain, a tree level a piece's depth, then
    one group's additions in the second launch and its tree), beside the
    chain's one single product."""
    pl = plan(s, k, sms)
    width, g = 2 * pl["piece"], pl["reduce_groups"]
    adds = _depth(width)
    muls = pl["ctas"] * pl["chains"] * (CHAIN_MULS + adds * MULS_ADD)
    if g:
        rounds = -(-pl["pps"] // g)
        muls += s * g * (rounds + _depth(g)) * MULS_ADD
        adds += rounds + _depth(g)
    return {"field_muls": muls, "chain_steps": CHAIN_STEPS + adds * STEPS_ADD,
            "plan": pl}


def chain_floor_ms(chain_steps: int, probed: dict,
                   sm_clock_mhz: float) -> float:
    """The least time the kernel's longest dependent chain takes: its
    paired steps at the probe's cycles a step of two products and its one
    single product at the probe's cycles a product, at the SM clock."""
    cycles = (chain_steps * probed["cycles_per_mul_pair"]
              + probed["cycles_per_field_mul"])
    return cycles / (sm_clock_mhz * 1e3)


def _wnaf(k: int, w: int) -> List[int]:
    """Width-w NAF of k > 0, least significant digit first."""
    out = []
    while k:
        d = 0
        if k & 1:
            d = k & ((1 << w) - 1)
            if d >= 1 << (w - 1):
                d -= 1 << w
            k -= d
        out.append(d)
        k >>= 1
    return out


def _signed_digits(k: int, c: int) -> List[int]:
    """k > 0 in base 2^c with digits in [-2^(c-1), 2^(c-1)), least
    significant first."""
    out = []
    while k:
        d = k & ((1 << c) - 1)
        k >>= c
        if d >= 1 << (c - 1):
            d -= 1 << c
            k += 1
        out.append(d)
    return out


def _straus_muls(ks: List[int], w: int) -> int:
    """Shared doublings over every scalar's width-w NAF: a table of odd
    multiples per point (w >= 3), one addition a nonzero digit."""
    nafs = [_wnaf(k, w) for k in ks]
    table = len(ks) * (MULS_DBL + ((1 << (w - 2)) - 1) * MULS_ADD) \
        if w >= 3 else 0
    nonzero = sum(sum(1 for d in n if d) for n in nafs)
    return (table + (max(map(len, nafs)) - 1) * MULS_DBL
            + (nonzero - 1) * MULS_ADD_MIXED)


def _pippenger_muls(ks: List[int], c: int) -> int:
    """Signed buckets of c bits: per window, one addition a nonzero digit
    into its bucket (the first is a copy), the running-sum aggregation
    over the occupied buckets, then c doublings and an addition a window."""
    digits = [_signed_digits(k, c) for k in ks]
    windows = max(map(len, digits))
    muls, live_windows = 0, 0
    for j in range(windows):
        ds = [abs(d[j]) for d in digits if j < len(d) and d[j]]
        if not ds:
            continue
        live_windows += 1
        buckets = set(ds)
        muls += (len(ds) - len(buckets)) * MULS_ADD_MIXED
        muls += (len(buckets) - 1 + max(buckets) - 1) * MULS_ADD
    return (muls + (windows - 1) * c * MULS_DBL
            + (live_windows - 1) * MULS_ADD)


def _cheapest_muls(ks: List[int]) -> int:
    cands = [_straus_muls(ks, w) for w in STRAUS_WIDTHS]
    if len(ks) > 1:
        cands += [_pippenger_muls(ks, c) for c in PIPPENGER_WINDOWS]
    return min(cands)


def segment_field_muls(scalars) -> int:
    """Field multiplies the cheapest of Straus (shared doublings, width-w
    NAF, w = 2..7) and signed Pippenger (c = 2..16), with or without the
    GLV split (one multiply a split point), needs for sum_i [k_i] P_i on
    these scalars. Each k is signed first (k or r - k, negation is free);
    zero scalars drop out. Every addition is priced as the kernel's
    cheapest, the mixed one, except bucket and window aggregation."""
    ks = [min(k % R, R - k % R) for k in map(int, scalars)]
    ks = [k for k in ks if k]
    if not ks:
        return 0
    split = [(k % GLV_LAMBDA, k // GLV_LAMBDA) for k in ks]
    glv = [k for pair in split for k in pair if k]
    return min(_cheapest_muls(ks),
               sum(1 for _, k2 in split if k2) + _cheapest_muls(glv))


def field_muls(words: np.ndarray, infinity: np.ndarray,
               reduce: bool) -> int:
    """Field multiplies the function needs on these inputs (the bound's
    operations): with `reduce` (words (8, S, K)) one MSM a segment,
    else (words (8, B)) one scalar multiplication a lane, each counted by
    `segment_field_muls`."""
    ks = _lane_scalars(words, infinity)
    if reduce:
        s = int(np.asarray(infinity).shape[0])
        return sum(segment_field_muls(seg) for seg in ks.reshape(s, -1))
    return sum(segment_field_muls([k]) for k in ks)


def work(words: np.ndarray, infinity: np.ndarray, reduce: bool) -> tuple:
    """(operations, bytes) of the function on these inputs: the field
    multiplies it needs (`field_muls`) at OPS_PER_FIELD_MUL each; each
    input word read once (int64), the mask byte, each output word written
    once."""
    lanes = int(np.asarray(infinity).size)
    outs = int(np.asarray(infinity).shape[0]) if reduce else lanes
    nbytes = lanes * (8 + 12 + 12) * 8 + lanes + outs * 3 * 12 * 8
    return field_muls(words, infinity, reduce) * OPS_PER_FIELD_MUL, nbytes
