"""Prime-field arithmetic on limb tensors: the plain PyTorch counterpart of
tpubft/ops/field.py::Field, written for the port.

The card's kernels hold a field element as twelve 32-bit words, least
significant first, in Montgomery form with R = 2^384 (`to_words` /
`from_words` convert). This module computes in radix 2^16 instead: 24
limbs in int64, limb axis first, any batch axes after it. A product of
two 32-bit words does not fit a signed int64, and torch has no unsigned
64-bit multiply on the card; 16-bit limbs keep every product below 2^32
and a whole schoolbook product, 24 of them summed, below 2^37. R is the
same in both radixes (24 x 16 = 12 x 32 bits), so the Montgomery form is
the kernels' own.

Elements are loose between operations: value congruent to the element
mod p and within a few p of [0, p); every operation leaves balanced
limbs, |limb| <= 2^15 + 2 but the top one, which absorbs what does not
fit, with the sign. Carries are a fixed number of limb-parallel passes
(no data-dependent loop, no synchronisation) that round each limb's
carry to the nearest (`_passes`), and each Montgomery product ends with
an estimated reduction that brings its value back into [-p, 2p)
(`mul`). The estimates sum limbs in float64; balanced limbs keep every
term within 2^17 times the value, where a floor carry would leave a
negative value's borrow chain (limbs of 2^16 - 1 up to a -1) far above
a 256-bit p's top limb, whose terms cancel in float64 and spoil the
estimate. `canonical` gives the exact residue in [0, p) with tight
16-bit limbs for any limbs in (-2^17, 2^17); `to_words` and the
comparisons go through it. The reference keeps 36 lazy 11-bit limbs
for the TPU's int32 lanes (field.py:34,80); limb layouts are not part
of the contract, the values are. This is a plain version, written for
exactness and brevity, not speed: the kernels it is held against are
in ops/csrc/.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1
HALF = 1 << (LIMB_BITS - 1)
NL = 24                       # limbs of 16 bits
WORDS = 12                    # the kernels' 32-bit words
R_BITS = LIMB_BITS * NL       # Montgomery R = 2^384


def int_to_limbs(x: int, n: int = NL, bits: int = LIMB_BITS) -> np.ndarray:
    if x < 0 or x >> (bits * n):
        raise ValueError("integer does not fit in the limb vector")
    return np.array([(x >> (bits * i)) & ((1 << bits) - 1)
                     for i in range(n)], dtype=np.int64)


def limbs_to_int(limbs, bits: int = LIMB_BITS) -> int:
    v = 0
    for x in reversed(np.asarray(limbs).tolist()):
        v = (v << bits) + int(x)
    return v


def to_words(x: torch.Tensor) -> torch.Tensor:
    """(24, ...) tight 16-bit limbs -> (12, ...) 32-bit words (int64)."""
    return x[0::2] + (x[1::2] << LIMB_BITS)


def from_words(w: torch.Tensor) -> torch.Tensor:
    """(12, ...) 32-bit words (int64, each in [0, 2^32)) -> (24, ...)
    16-bit limbs."""
    return torch.stack([w & MASK, w >> LIMB_BITS], 1).reshape(
        (NL,) + tuple(w.shape[1:]))


def _passes(x: torch.Tensor, n: int, wrap: bool = False) -> torch.Tensor:
    """n limb-parallel carry passes along the limb axis: each limb hands
    its value rounded to the nearest multiple of 2^16 (signed) to the
    next and keeps the rest, in [-2^15, 2^15). The top limb keeps its
    carry, or with `wrap` hands it out too and the carry out is dropped
    (the value mod 2^(16 L)). A pass takes a limb bound of 2^b down to
    2^(b-16) + 2^15."""
    for _ in range(n):
        hi = (x + HALF) >> LIMB_BITS
        y = x - (hi << LIMB_BITS)
        if not wrap:
            y[-1] = x[-1]
        y[1:] += hi[:-1]
        x = y
    return x


def _carry(x: torch.Tensor) -> torch.Tensor:
    """Exact carry propagation: every limb but the top one ends in
    [0, 2^16), the top limb keeps the sign. Loops until no carry is left
    (a borrow can ripple through every limb)."""
    while True:
        hi = x[:-1] >> LIMB_BITS
        if not bool(hi.any()):
            return x
        x = torch.cat([x[:1] & MASK, (x[1:-1] & MASK) + hi[:-1],
                       x[-1:] + hi[-1:]])


def _conv(a: torch.Tensor, b: torch.Tensor, out: int) -> torch.Tensor:
    """The schoolbook product's columns: c[k] = sum_{i+j=k} a[i] b[j] for
    k < out, from (La, N) and (Lb, N) limb tensors (no carries). Row i of
    the outer product is shifted right by i through a flat view: rows
    padded to La + Lb, read back La + Lb - 1 wide, then summed."""
    la, n = a.shape[0], a.shape[1]
    width = la + b.shape[0]
    prod = a[:, None, :] * b[None, :, :]
    prod = torch.cat([prod, prod.new_zeros((la, la, n))], 1)
    cols = prod.reshape(la * width, n)[: la * (width - 1)].reshape(
        la, width - 1, n).sum(0)
    if out > cols.shape[0]:
        cols = torch.cat([cols, cols.new_zeros((out - cols.shape[0], n))])
    return cols[:out]


_SCALES: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def _value(x: torch.Tensor, shift: int = 0) -> torch.Tensor:
    """sum_k x[k] 2^(16 k - shift) in float64, over (24, N) -> (N,)."""
    key = (shift, x.device)
    scale = _SCALES.get(key)
    if scale is None:
        scale = _SCALES[key] = torch.tensor(
            [2.0 ** (LIMB_BITS * k - shift) for k in range(NL)],
            dtype=torch.float64, device=x.device).reshape(-1, 1)
    return (x.double() * scale).sum(0)


class Field:
    """Arithmetic mod a prime p < 2^382 on (24, ...batch) int64 limb
    tensors, loose in and out; Montgomery form unless the name says
    otherwise. Public: from_int / to_int (host), to_mont / from_mont,
    add, sub, neg, mul, canonical, to_words, select, eq, is_zero, zero,
    one."""

    def __init__(self, p: int):
        if p.bit_length() > R_BITS - 2:
            raise ValueError("p must be below 2^382 (4p < R)")
        self.p = p
        self.R = 1 << R_BITS
        self.r_inv = pow(self.R, -1, p)
        self.p_limbs = int_to_limbs(p)
        self.pprime_limbs = int_to_limbs((-pow(p, -1, self.R)) % self.R)
        self.r2_limbs = int_to_limbs(self.R * self.R % p)
        self.mont_one = int_to_limbs(self.R % p)
        self._consts: Dict[Tuple[str, torch.device], torch.Tensor] = {}

    # ---------- host conversions ----------
    def from_int(self, x: int) -> np.ndarray:
        """Host: python int -> Montgomery limbs (numpy, (24,))."""
        return int_to_limbs(x % self.p * self.R % self.p)

    def to_int(self, limbs) -> int:
        """Host: Montgomery limbs (24,) or words (12,) -> python int."""
        limbs = np.asarray(limbs)
        bits = LIMB_BITS if limbs.shape[0] == NL else 2 * LIMB_BITS
        return limbs_to_int(limbs, bits) * self.r_inv % self.p

    def _const(self, name: str, limbs: np.ndarray,
               device: torch.device) -> torch.Tensor:
        key = (name, device)
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = torch.as_tensor(
                limbs, dtype=torch.int64, device=device).reshape(-1, 1)
        return t

    def zero(self, batch: Tuple[int, ...], device) -> torch.Tensor:
        return torch.zeros((NL,) + tuple(batch), dtype=torch.int64,
                           device=device)

    def one(self, batch: Tuple[int, ...], device) -> torch.Tensor:
        one = torch.as_tensor(self.mont_one, device=device)
        return one.reshape((NL,) + (1,) * len(batch)).expand(
            (NL,) + tuple(batch)).clone()

    # ---------- arithmetic ----------
    def _p(self, x: torch.Tensor) -> torch.Tensor:
        return self._const("p", self.p_limbs, x.device)

    @staticmethod
    def _flat(x: torch.Tensor, shape) -> torch.Tensor:
        return x.expand(shape).reshape(NL, -1)

    def _reduce(self, x: torch.Tensor, c=None) -> torch.Tensor:
        """Subtract q p, q = floor(value / p) estimated in float64 (the
        value's relative error is about 2^-50, so q is off by at most one:
        the result lies in [-p, 2p)); `c` adds c to limb 0 first."""
        v = _value(x)
        if c is not None:
            v = v + c.double()
            x = torch.cat([x[:1] + c, x[1:]])
        q = torch.floor(v / float(self.p)).long()
        return x - q * self._p(x)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _passes(a + b, 1)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _passes(a - b, 1)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return _passes(-a, 1)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product a b R^-1 (mod p), loose in and out (the
        inputs' limbs as the operations leave them, or tight).

        Separated operand scanning: T = a b as columns (each a sum of 24
        products of limbs below 2^17, so below 2^39); m = T p' mod R from
        T's low 24 columns (terms below 2^39 x 2^16, 24 of them below
        2^60), carried mod R; U = T + m p is a multiple of R. Its low half's
        value is c R: c comes from that half's value in float64 (24 terms,
        |c| < 2^24, the sum's error below 2^-20, so rounding gives c
        exactly). U / R is the high half plus c, reduced into [-p, 2p)."""
        shape = torch.broadcast_shapes(a.shape, b.shape)
        a, b = self._flat(a, shape), self._flat(b, shape)
        n = a.shape[1]
        t = _conv(a, b, 2 * NL)
        pp = self._const("pprime", self.pprime_limbs, a.device)
        m = _passes(_conv(t[:NL], pp.expand(NL, n), NL), 4, wrap=True)
        u = t + _conv(m, self._p(m).expand(NL, n), 2 * NL)
        c = torch.round(_value(u[:NL], R_BITS)).long()
        return _passes(self._reduce(u[NL:], c), 3).reshape(shape)

    def pow_const(self, a: torch.Tensor, e: int) -> torch.Tensor:
        """a^e for a fixed public exponent, square and multiply from the
        top bit (reference field.py:221-236, there a select per bit; the
        exponent is public, so here a branch)."""
        acc = self.one(a.shape[1:], a.device)
        for i in range(max(e.bit_length(), 1) - 1, -1, -1):
            acc = self.mul(acc, acc)
            if (e >> i) & 1:
                acc = self.mul(acc, a)
        return acc

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """Fermat inversion a^(p-2); inv(0) = 0 (reference field.py:238)."""
        return self.pow_const(a, self.p - 2)

    def canonical(self, a: torch.Tensor) -> torch.Tensor:
        """The exact residue in [0, p), tight limbs. One balanced pass
        first, so that limbs the operations did not leave (any in
        (-2^17, 2^17)) estimate as well as theirs."""
        shape = a.shape
        x = _carry(self._reduce(_passes(a.reshape(NL, -1), 1)))
        p = self._p(x)
        x = torch.where(x[-1:] < 0, _carry(x + p), x)
        d = _carry(x - p)
        return torch.where(d[-1:] < 0, x, d).reshape(shape)

    def to_mont(self, x: torch.Tensor) -> torch.Tensor:
        """Integers (loose limbs) -> Montgomery form."""
        return self.mul(x, self._const("r2", self.r2_limbs, x.device)
                        .reshape((NL,) + (1,) * (x.dim() - 1)))

    def from_mont(self, x: torch.Tensor) -> torch.Tensor:
        """Montgomery form -> the canonical integer."""
        one = torch.zeros_like(x)
        one[0] = 1
        return self.canonical(self.mul(x, one))

    # ---------- selection / comparison ----------
    @staticmethod
    def select(cond: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
        """cond: (...batch) bool; a, b: (24, ...batch)."""
        return torch.where(cond.unsqueeze(0), a, b)

    def eq(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.is_zero(self.sub(a, b))

    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        return (self.canonical(a) == 0).all(0)

    def to_words(self, a: torch.Tensor) -> torch.Tensor:
        """Canonical 32-bit words (12, ...), the kernels' layout."""
        return to_words(self.canonical(a))


@functools.lru_cache(maxsize=None)
def get_field(p: int) -> Field:
    return Field(p)
