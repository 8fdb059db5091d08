"""GF(2^255-19) on torch int32 tensors (port of tpubft/ops/f25519.py).

This is the plain PyTorch field under `ops/ed25519.verify_kernel`, the
reference version the CUDA kernel is held against. It keeps the JAX
package's representation so the tests compare limbs directly:

  * 24 signed int32 limbs, shape (24, ...batch); limb i sits at bit
    W[i] = ceil(255*i/24), so limb 24 lands exactly at 2^255 and high
    limbs fold back with a plain factor 19 (2^255 ≡ 19);
  * values are redundant (any residue class) and signs live in the
    limbs, so negation is `-a`;
  * overflow budget: with |a_i| <= m*2^11 and |b_j| <= k*2^11 the
    corrected convolution stays below 2^31 for m*k <= 10. Torch wraps
    int32 silently, so the point formulas in ops/ed25519.py keep the
    reference's operand order, which is what keeps every product inside
    that budget.

`>>` on a negative int32 tensor is arithmetic and `&` works on two's
complement, as in JAX, so the carry passes are the reference's.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

P = 2**255 - 19
NL = 24
# bit position of limb i (i in 0..2*NL): W[NL] == 255 exactly
W = [(255 * i + NL - 1) // NL for i in range(2 * NL + 1)]
# bits held by position k (k in 0..2*NL-1) — 10 or 11
BITS = np.array([W[k + 1] - W[k] for k in range(2 * NL)], np.int32)
MASK = ((1 << BITS) - 1).astype(np.int32)
# doubling correction: product a_i*b_j contributes at weight 2^(W[i]+W[j])
# but position i+j has weight 2^W[i+j]; delta in {0,1}
_DBL = np.array([[W[i] + W[j] - W[i + j] for j in range(NL)]
                 for i in range(NL)], np.int32)
assert _DBL.min() == 0 and _DBL.max() == 1


def int_to_limbs(x: int) -> np.ndarray:
    """Host: python int (any residue; reduced mod p first) -> limb vector."""
    x %= P
    out = np.zeros(NL, dtype=np.int32)
    for i in range(NL):
        out[i] = x & int(MASK[i])
        x >>= int(BITS[i])
    return out


def limbs_to_int(limbs) -> int:
    """Host: limb vector (possibly loose/signed) -> canonical int mod p."""
    limbs = np.asarray(limbs)
    v = 0
    for i in range(limbs.shape[0]):
        v += int(limbs[i]) << W[i]
    return v % P


def bytes_le_to_limbs(arr_u8: np.ndarray) -> np.ndarray:
    """Host, vectorized: (B, 32) little-endian byte rows -> (NL, B) limbs.
    Values must be < 2^255 (callers mask the sign bit first)."""
    bits = np.unpackbits(arr_u8, axis=1, bitorder="little")       # (B, 256)
    out = np.zeros((NL, bits.shape[0]), np.int32)
    for i in range(NL):
        seg = bits[:, W[i]:W[i + 1]].astype(np.int32)
        out[i] = seg @ (1 << np.arange(seg.shape[1], dtype=np.int64)).astype(
            np.int32)
    return out


# ----------------------------------------------------------------------
# device-side constants, cached per device
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _consts(device: torch.device):
    """(bits48, mask48, dbl_factor (NL, NL, 1), conv_index (NL*NL,))"""
    bits = torch.as_tensor(BITS, device=device)
    mask = torch.as_tensor(MASK, device=device)
    factor = torch.as_tensor(1 + _DBL, device=device).reshape(NL, NL, 1)
    idx = (torch.arange(NL).reshape(NL, 1)
           + torch.arange(NL).reshape(1, NL)).reshape(-1).to(device)
    return bits, mask, factor, idx


def _col(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (ndim - 1))


# ----------------------------------------------------------------------
# field ops — all (NL, ...batch) int32, fully data-parallel
# ----------------------------------------------------------------------

def _carry_pass(c: torch.Tensor, start: int = 0):
    """One parallel carry step with per-position widths: limb -> (lo, hi)
    split, hi shifted up one position. Returns (same-length tensor,
    carry out of the top limb)."""
    n = c.shape[0]
    bits, mask, _, _ = _consts(c.device)
    hi = c >> _col(bits[start:start + n], c.ndim)
    lo = c & _col(mask[start:start + n], c.ndim)
    shifted = torch.cat([torch.zeros_like(hi[:1]), hi[:-1]], dim=0)
    return lo + shifted, hi[-1]


def _add_row0(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """a with x added to limb 0 (a new tensor, like JAX's .at[0].add)."""
    return torch.cat([(a[0] + x).unsqueeze(0), a[1:]], dim=0)


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Restore loose limbs to |limb| <= 2^11 + eps without changing the
    value mod p. Carry out of limb NL-1 has weight 2^255 ≡ 19."""
    a, t = _carry_pass(a)
    a = _add_row0(a, t * 19)
    a, t = _carry_pass(a)
    return _add_row0(a, t * 19)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field multiply: corrected schoolbook convolution + factor-19
    pseudo-Mersenne reduction. The convolution is one outer product
    (with the non-uniform radix's doubling folded into b) and one
    index-add onto the 48 positions. Operand budget m*k <= 10."""
    _, _, factor, idx = _consts(a.device)
    batch = a.shape[1:]
    flat_a = a.reshape(NL, 1, -1)
    flat_b = b.reshape(1, NL, -1) * factor                  # (NL, NL, n)
    prod = (flat_a * flat_b).reshape(NL * NL, -1)
    c = torch.zeros((2 * NL, prod.shape[1]), dtype=torch.int32,
                    device=a.device)
    c.index_add_(0, idx, prod)
    c = c.reshape((2 * NL,) + batch)
    # two parallel passes: |limb| < 2^31 -> ~2^21 -> <= 2^12
    c, _ = _carry_pass(c)                    # pad limb absorbs; carry 0
    c, t2 = _carry_pass(c)                   # |t2| <= 2^11
    # fold: position NL+t ≡ 19 * position t; carry-out of position 2NL-1
    # has weight 2^510 ≡ 361
    lo = c[:NL] + c[NL:] * 19
    lo = _add_row0(lo, t2 * 361)
    lo, t = _carry_pass(lo)
    lo = _add_row0(lo, t * 19)
    lo, t = _carry_pass(lo)
    return _add_row0(lo, t * 19)


def sqr(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def zero(batch_shape: Tuple[int, ...], device) -> torch.Tensor:
    return torch.zeros((NL,) + tuple(batch_shape), dtype=torch.int32,
                       device=device)


def one(batch_shape: Tuple[int, ...], device) -> torch.Tensor:
    o = zero(batch_shape, device)
    o[0] = 1
    return o


def const(value: int, batch_shape: Tuple[int, ...], device) -> torch.Tensor:
    limbs = torch.as_tensor(int_to_limbs(value), device=device)
    return limbs.reshape((NL,) + (1,) * len(batch_shape)).expand(
        (NL,) + tuple(batch_shape))


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    """cond: (batch,) bool; a, b: (NL, batch)."""
    return torch.where(cond.unsqueeze(0), a, b)


# ---- canonicalization / comparison (off the hot path) ----

# positive offset dominating any normalized-ish input (|limb| <= 2^12 ->
# |value| < 2^262); 2^10 * P ~ 2^265 dominates
_OFFSET = (1 << 10) * P


def _offset_limbs_np() -> np.ndarray:
    x = _OFFSET
    out = np.zeros(NL, dtype=np.int64)
    for i in range(NL - 1):
        out[i] = x & int(MASK[i])
        x >>= int(BITS[i])
    out[NL - 1] = x                    # top limb holds the overflow
    assert out[NL - 1] < 2**30
    return out.astype(np.int32)


_OFFSET_LIMBS = _offset_limbs_np()


def _p_tight_np() -> np.ndarray:
    # int_to_limbs reduces mod p (giving zeros), so build p's limbs directly
    x = P
    out = np.zeros(NL, dtype=np.int32)
    for i in range(NL):
        out[i] = x & int(MASK[i])
        x >>= int(BITS[i])
    assert x == 0
    return out


_P_TIGHT = _p_tight_np()


def _carry_scan(a: torch.Tensor):
    """Exact sequential carry propagation (NL steps): returns (tight
    limbs in [0, 2^BITS_k), carry_out at weight 2^255)."""
    carry = torch.zeros_like(a[0])
    rows = []
    for k in range(NL):
        t = a[k] + carry
        carry = t >> int(BITS[k])
        rows.append(t & int(MASK[k]))
    return torch.stack(rows), carry


def canonical(a: torch.Tensor) -> torch.Tensor:
    """Exact canonical residue in [0, p): (NL, B) tight non-negative
    limbs. Input must be normalized-ish (|limb| <= 2^12)."""
    off = _col(torch.as_tensor(_OFFSET_LIMBS, device=a.device), a.ndim)
    a, c = _carry_scan(a + off)                  # value now in (0, 2^266)
    a, c = _carry_scan(_add_row0(a, c * 19))     # c < 2^11
    a, _ = _carry_scan(_add_row0(a, c * 19))     # tight, value < 2^255
    # at most one subtraction of p left
    p_l = _col(torch.as_tensor(_P_TIGHT, device=a.device), a.ndim)
    d, borrow = _carry_scan(a - p_l)
    return torch.where((borrow < 0).unsqueeze(0), a, d)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Equality mod p of two normalized elements."""
    return torch.all(canonical(a - b) == 0, dim=0)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(canonical(a) == 0, dim=0)


# ---- fixed-exponent powers (x^(p-2), x^((p-5)/8)) ----

def pow2k(x: torch.Tensor, k: int) -> torch.Tensor:
    """x^(2^k): k sequential squarings."""
    for _ in range(k):
        x = sqr(x)
    return x


def _chain_250(x: torch.Tensor):
    """x^(2^250 - 1) and x^11 — shared core of the inversion and sqrt
    chains (the standard curve25519 addition chain)."""
    z2 = sqr(x)                                  # 2
    z9 = mul(pow2k(z2, 2), x)                    # 9
    z11 = mul(z9, z2)                            # 11
    z_2_5 = mul(sqr(z11), z9)                    # 2^5 - 1
    z_2_10 = mul(pow2k(z_2_5, 5), z_2_5)         # 2^10 - 1
    z_2_20 = mul(pow2k(z_2_10, 10), z_2_10)      # 2^20 - 1
    z_2_40 = mul(pow2k(z_2_20, 20), z_2_20)      # 2^40 - 1
    z_2_50 = mul(pow2k(z_2_40, 10), z_2_10)      # 2^50 - 1
    z_2_100 = mul(pow2k(z_2_50, 50), z_2_50)     # 2^100 - 1
    z_2_200 = mul(pow2k(z_2_100, 100), z_2_100)  # 2^200 - 1
    z_2_250 = mul(pow2k(z_2_200, 50), z_2_50)    # 2^250 - 1
    return z_2_250, z11


def inv(x: torch.Tensor) -> torch.Tensor:
    """x^(p-2) = x^(2^255 - 21). inv(0) = 0 (callers guard)."""
    t250, z11 = _chain_250(x)
    return mul(pow2k(t250, 5), z11)              # (2^250-1)*2^5 + 11


def pow_p58(x: torch.Tensor) -> torch.Tensor:
    """x^((p-5)/8) = x^(2^252 - 3)."""
    t250, _ = _chain_250(x)
    return mul(pow2k(t250, 2), x)                # (2^250-1)*4 + 1
