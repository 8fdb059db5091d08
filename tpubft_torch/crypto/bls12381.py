"""BLS12-381 reference implementation in pure Python (CPU backend + golden
model); port of tpubft/crypto/bls12381.py.

Plays the role RELIC plays in the reference (threshsign/src/bls/relic/ —
SURVEY.md §2.2): field/curve arithmetic, hashing to the curve, BLS signatures,
threshold (Shamir) key generation, Lagrange interpolation, and pairing-based
verification. The reference uses BN-P254; we use BLS12-381 (the modern curve,
and the one BASELINE.md's north star names for the TPU MSM).

Convention: "min-sig" — signatures/hashes in G1 (cheap shares + G1 MSM on
TPU), public keys in G2. Verify: e(sig, -g2) * e(H(m), pk) == 1.

This module is deliberately written with Python ints for clarity and
correctness; the batched device implementation lives in
tpubft_torch/ops/bls12_381.py and is tested against this one.

Port divergence: each routing point to the native engine counts the
pure-Python answer it gives when the engine is not loaded
(bls_native.count_fallback); the arithmetic is the reference's.
"""
from __future__ import annotations

import hashlib
import secrets
from typing import List, Optional, Sequence, Tuple

# ---------------- curve constants ----------------

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001  # group order
X_PARAM = -0xD201000000010000        # BLS parameter x (negative)
H_EFF_G1 = 0xD201000000010001        # 1 - x : effective G1 cofactor multiplier

G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
     0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E),
    (0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
     0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE),
)
B1 = 4          # G1: y^2 = x^3 + 4
B2 = (4, 4)     # G2: y^2 = x^3 + 4(1+u)


# ---------------- Fp ----------------

def fp_inv(a: int) -> int:
    return pow(a, P - 2, P)


def fp_sqrt(a: int) -> Optional[int]:
    """p ≡ 3 (mod 4) → candidate a^((p+1)/4); native modexp when built
    (the Python pow dominates hash-to-curve and decompress otherwise)."""
    from tpubft_torch.crypto import bls_native
    if bls_native.available():
        return bls_native.fp_sqrt(a % P)
    bls_native.count_fallback()
    c = pow(a, (P + 1) // 4, P)
    return c if c * c % P == a % P else None


# ---------------- Fp2 = Fp[u]/(u^2+1) ----------------
# elements are tuples (c0, c1) = c0 + c1*u

def fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fp2_mul(a, b):
    # Karatsuba: (a0+a1 u)(b0+b1 u) = (a0b0 - a1b1) + (a0b1 + a1b0) u
    t0 = a[0] * b[0] % P
    t1 = a[1] * b[1] % P
    t2 = (a[0] + a[1]) * (b[0] + b[1]) % P
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def fp2_sqr(a):
    # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
    t0 = (a[0] + a[1]) % P
    t1 = (a[0] - a[1]) % P
    t2 = a[0] * a[1] % P
    return (t0 * t1 % P, 2 * t2 % P)


def fp2_mul_scalar(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def fp2_conj(a):
    return (a[0], (-a[1]) % P)


def fp2_inv(a):
    t = fp_inv((a[0] * a[0] + a[1] * a[1]) % P)
    return (a[0] * t % P, (-a[1] * t) % P)


def fp2_sqrt(a) -> Optional[Tuple[int, int]]:
    """Sqrt in Fp2 via the p ≡ 3 mod 4 complex method (used for G2 decompress)."""
    if a == (0, 0):
        return (0, 0)
    # candidate = a^((p^2+7)/16)-style shortcut does not apply; use generic:
    # alpha = a^((p-3)/4) ... use the simple algorithm: c = a^((p^2+7)/16)? For
    # p^2 ≡ 9 mod 16. Simplest reliable route: solve via Fp norm equation.
    # norm = a0^2 + a1^2 must be QR in Fp: n = sqrt(norm)
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    n = fp_sqrt(norm)
    if n is None:
        return None
    for sign in (1, -1):
        # x0^2 = (a0 + n)/2  (try both signs of n)
        t = (a[0] + sign * n) % P * fp_inv(2) % P
        x0 = fp_sqrt(t)
        if x0 is None or x0 == 0:
            continue
        x1 = a[1] * fp_inv(2 * x0 % P) % P
        cand = (x0, x1)
        if fp2_sqr(cand) == (a[0] % P, a[1] % P):
            return cand
    return None


FP2_ONE = (1, 0)
FP2_ZERO = (0, 0)
FP2_U_PLUS_1 = (1, 1)


# ---------------- Fp6 = Fp2[v]/(v^3 - (u+1)) ----------------
# elements: (c0, c1, c2) with ci in Fp2

def fp6_add(a, b):
    return tuple(fp2_add(x, y) for x, y in zip(a, b))


def fp6_sub(a, b):
    return tuple(fp2_sub(x, y) for x, y in zip(a, b))


def fp6_neg(a):
    return tuple(fp2_neg(x) for x in a)


def _mul_by_xi(a):  # multiply Fp2 element by xi = u+1
    return fp2_mul(a, FP2_U_PLUS_1)


def fp6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fp2_mul(a0, b0)
    t1 = fp2_mul(a1, b1)
    t2 = fp2_mul(a2, b2)
    c0 = fp2_add(t0, _mul_by_xi(fp2_sub(fp2_mul(fp2_add(a1, a2), fp2_add(b1, b2)), fp2_add(t1, t2))))
    c1 = fp2_add(fp2_sub(fp2_mul(fp2_add(a0, a1), fp2_add(b0, b1)), fp2_add(t0, t1)), _mul_by_xi(t2))
    c2 = fp2_add(fp2_sub(fp2_mul(fp2_add(a0, a2), fp2_add(b0, b2)), fp2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fp6_sqr(a):
    return fp6_mul(a, a)


def fp6_inv(a):
    a0, a1, a2 = a
    c0 = fp2_sub(fp2_sqr(a0), _mul_by_xi(fp2_mul(a1, a2)))
    c1 = fp2_sub(_mul_by_xi(fp2_sqr(a2)), fp2_mul(a0, a1))
    c2 = fp2_sub(fp2_sqr(a1), fp2_mul(a0, a2))
    t = fp2_inv(fp2_add(fp2_mul(a0, c0),
                        _mul_by_xi(fp2_add(fp2_mul(a2, c1), fp2_mul(a1, c2)))))
    return (fp2_mul(c0, t), fp2_mul(c1, t), fp2_mul(c2, t))


FP6_ZERO = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE = (FP2_ONE, FP2_ZERO, FP2_ZERO)


# ---------------- Fp12 = Fp6[w]/(w^2 - v) ----------------
# elements: (c0, c1) with ci in Fp6

FP12_ONE = (FP6_ONE, FP6_ZERO)


def fp12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fp6_mul(a0, b0)
    t1 = fp6_mul(a1, b1)
    # v * t1 : multiply Fp6 element by v (shift with xi wrap)
    vt1 = (_mul_by_xi(t1[2]), t1[0], t1[1])
    c0 = fp6_add(t0, vt1)
    c1 = fp6_sub(fp6_mul(fp6_add(a0, a1), fp6_add(b0, b1)), fp6_add(t0, t1))
    return (c0, c1)


def fp12_sqr(a):
    return fp12_mul(a, a)


def fp12_conj(a):
    return (a[0], fp6_neg(a[1]))


def fp12_inv(a):
    a0, a1 = a
    t1 = fp6_sqr(a1)
    vt1 = (_mul_by_xi(t1[2]), t1[0], t1[1])
    t = fp6_inv(fp6_sub(fp6_sqr(a0), vt1))
    return (fp6_mul(a0, t), fp6_neg(fp6_mul(a1, t)))


def fp12_pow(a, e: int):
    if e < 0:
        return fp12_pow(fp12_inv(a), -e)
    result = FP12_ONE
    base = a
    while e:
        if e & 1:
            result = fp12_mul(result, base)
        base = fp12_sqr(base)
        e >>= 1
    return result


# ---------------- G1 (affine/jacobian over Fp) ----------------
# Points: None = infinity, else (x, y) affine.

def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x % P * x + B1)) % P == 0


def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        # doubling
        lam = 3 * x1 * x1 % P * fp_inv(2 * y1 % P) % P
    else:
        lam = (y2 - y1) * fp_inv((x2 - x1) % P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_neg(pt):
    if pt is None:
        return None
    return (pt[0], (-pt[1]) % P)


def g1_mul_py(pt, k: int):
    k %= R
    result = None
    add = pt
    while k:
        if k & 1:
            result = g1_add(result, add)
        add = g1_add(add, add)
        k >>= 1
    return result


def g1_mul(pt, k: int):
    from tpubft_torch.crypto import bls_native
    if bls_native.available():
        return bls_native.g1_mul(pt, k)
    bls_native.count_fallback()
    return g1_mul_py(pt, k)


def g1_msm_py(points: Sequence, scalars: Sequence[int]):
    """Pure-Python MSM (golden model). Must stay independent of the
    native engine — it is the differential oracle the engine is tested
    against, so it composes g1_mul_py, never the routed g1_mul."""
    acc = None
    for pt, k in zip(points, scalars):
        acc = g1_add(acc, g1_mul_py(pt, k))
    return acc


def g1_msm(points: Sequence, scalars: Sequence[int]):
    """Multi-scalar multiplication sum_i [k_i] P_i (the hot accumulate
    op); native engine when available."""
    from tpubft_torch.crypto import bls_native
    if bls_native.available():
        return bls_native.g1_msm(points, scalars)
    bls_native.count_fallback()
    return g1_msm_py(points, scalars)


# ---------------- G2 (affine over Fp2) ----------------

def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return fp2_sub(fp2_sqr(y), fp2_add(fp2_mul(fp2_sqr(x), x), B2)) == FP2_ZERO


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if fp2_add(y1, y2) == FP2_ZERO:
            return None
        lam = fp2_mul(fp2_mul_scalar(fp2_sqr(x1), 3), fp2_inv(fp2_mul_scalar(y1, 2)))
    else:
        lam = fp2_mul(fp2_sub(y2, y1), fp2_inv(fp2_sub(x2, x1)))
    x3 = fp2_sub(fp2_sub(fp2_sqr(lam), x1), x2)
    y3 = fp2_sub(fp2_mul(lam, fp2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_neg(pt):
    if pt is None:
        return None
    return (pt[0], fp2_neg(pt[1]))


def g2_mul_py(pt, k: int):
    k %= R
    result = None
    add = pt
    while k:
        if k & 1:
            result = g2_add(result, add)
        add = g2_add(add, add)
        k >>= 1
    return result


def g2_mul(pt, k: int):
    from tpubft_torch.crypto import bls_native
    if bls_native.available():
        return bls_native.g2_mul(pt, k)
    bls_native.count_fallback()
    return g2_mul_py(pt, k)


# ---------------- pairing (ate, Miller loop + final exponentiation) ----------------

def _untwist(pt):
    """Embed a G2 point (Fp2 coords) into E(Fp12) via the untwist map
    x' = x / w^2, y' = y / w^3 (D-type twist, w^2 = v). Built with generic
    Fp12 ops — this is the correctness-reference path, not the fast path."""
    x, y = pt
    W = (FP6_ZERO, FP6_ONE)                 # w
    W2 = fp12_mul(W, W)
    W3 = fp12_mul(W2, W)
    x12 = fp12_mul(_fp2_to_fp12(x), fp12_inv(W2))
    y12 = fp12_mul(_fp2_to_fp12(y), fp12_inv(W3))
    return (x12, y12)


def _fp2_to_fp12(a):
    return ((a, FP2_ZERO, FP2_ZERO), FP6_ZERO)


def _fp12_pt_add(p1, p2):
    """Affine addition on E(Fp12): y^2 = x^3 + 4."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if fp12_add(y1, y2) == _FP12_ZERO:
            return None
        lam = fp12_mul(fp12_scalar(fp12_sqr(x1), 3), fp12_inv(fp12_scalar(y1, 2)))
    else:
        lam = fp12_mul(fp12_sub(y2, y1), fp12_inv(fp12_sub(x2, x1)))
    x3 = fp12_sub(fp12_sub(fp12_sqr(lam), x1), x2)
    y3 = fp12_sub(fp12_mul(lam, fp12_sub(x1, x3)), y1)
    return (x3, y3)


_FP12_ZERO = (FP6_ZERO, FP6_ZERO)


def fp12_add(a, b):
    return (fp6_add(a[0], b[0]), fp6_add(a[1], b[1]))


def fp12_sub(a, b):
    return (fp6_sub(a[0], b[0]), fp6_sub(a[1], b[1]))


def fp12_scalar(a, k: int):
    return (tuple(fp2_mul_scalar(c, k) for c in a[0]),
            tuple(fp2_mul_scalar(c, k) for c in a[1]))


def _fp12_line(p1, p2, q):
    """Line through p1,p2 on E(Fp12) (or tangent if equal) evaluated at q."""
    x1, y1 = p1
    x2, y2 = p2
    xq, yq = q
    if x1 == x2 and y1 == y2:
        lam = fp12_mul(fp12_scalar(fp12_sqr(x1), 3), fp12_inv(fp12_scalar(y1, 2)))
    elif x1 == x2:
        # vertical line
        return fp12_sub(xq, x1)
    else:
        lam = fp12_mul(fp12_sub(y2, y1), fp12_inv(fp12_sub(x2, x1)))
    return fp12_sub(fp12_sub(yq, y1), fp12_mul(lam, fp12_sub(xq, x1)))


def miller_loop(q_g2, p_g1):
    """f_{|x|, Q}(P) over E(Fp12), textbook double-and-add Miller loop."""
    if q_g2 is None or p_g1 is None:
        return FP12_ONE
    Q = _untwist(q_g2)
    Pt = (_int_to_fp12(p_g1[0]), _int_to_fp12(p_g1[1]))
    T = Q
    f = FP12_ONE
    n = -X_PARAM  # positive loop count
    for i in reversed(range(n.bit_length() - 1)):
        f = fp12_mul(fp12_sqr(f), _fp12_line(T, T, Pt))
        T = _fp12_pt_add(T, T)
        if (n >> i) & 1:
            f = fp12_mul(f, _fp12_line(T, Q, Pt))
            T = _fp12_pt_add(T, Q)
    # x < 0: conjugate (valid up to final exponentiation since exponent
    # contains the factor p^6 - 1 and conj = inverse for unitary results)
    return fp12_conj(f)


def _int_to_fp12(a: int):
    return (((a % P, 0), FP2_ZERO, FP2_ZERO), FP6_ZERO)


def final_exponentiation(f):
    """f^((p^12-1)/r) — direct exponentiation (reference impl, not fast)."""
    return fp12_pow(f, (P ** 12 - 1) // R)


def pairing(p_g1, q_g2):
    """e(P, Q) for P in G1, Q in G2."""
    return final_exponentiation(miller_loop(q_g2, p_g1))


def pairing_check_py(pairs: Sequence[Tuple[object, object]]) -> bool:
    """Pure-Python multi-pairing product check (golden model)."""
    f = FP12_ONE
    for p_g1, q_g2 in pairs:
        f = fp12_mul(f, miller_loop(q_g2, p_g1))
    return final_exponentiation(f) == FP12_ONE


def pairing_check(pairs: Sequence[Tuple[object, object]]) -> bool:
    """prod e(Pi, Qi) == 1 — the multi-pairing product check. Routed to
    the native engine (native/bls12381.cpp, the RELIC role) when
    it builds; the pure-Python path is the differential-tested fallback."""
    from tpubft_torch.crypto import bls_native
    if bls_native.available():
        return bls_native.pairing_check(pairs)
    bls_native.count_fallback()
    return pairing_check_py(pairs)


# ---------------- hash to G1 (try-and-increment, internal ciphersuite) ----------------

DST_G1 = b"TPUBFT-V01-CS01-with-BLS12381G1_XMD:SHA-256_TAI_"


def hash_to_g1(msg: bytes):
    """Deterministic hash to a G1 point (try-and-increment + cofactor clear).

    Not RFC 9380 SSWU (that is planned for the TPU kernel path); this is an
    internal ciphersuite — both sign and verify use it consistently.
    """
    ctr = 0
    while True:
        h = hashlib.sha256(DST_G1 + ctr.to_bytes(4, "big") + msg).digest()
        x = int.from_bytes(h + hashlib.sha256(b"x2" + h).digest()[:16], "big") % P
        rhs = (x * x % P * x + B1) % P
        y = fp_sqrt(rhs)
        if y is not None:
            # choose canonical sign: smaller y
            if y > P - y:
                y = P - y
            pt = (x, y)
            # clear cofactor: multiply by (1 - x_param) = h_eff
            pt = g1_mul_nonorder(pt, H_EFF_G1)
            if pt is not None:
                return pt
        ctr += 1


def g1_mul_nonorder_py(pt, k: int):
    """Scalar mul without reducing k mod R (for cofactor clearing)."""
    result = None
    add = pt
    while k:
        if k & 1:
            result = g1_add(result, add)
        add = g1_add(add, add)
        k >>= 1
    return result


def g1_mul_nonorder(pt, k: int):
    from tpubft_torch.crypto import bls_native
    if bls_native.available():
        return bls_native.g1_mul_nonorder(pt, k)
    bls_native.count_fallback()
    return g1_mul_nonorder_py(pt, k)


# ---------------- serialization ----------------

G1_LEN = 48      # compressed
G2_LEN = 96      # compressed


def g1_compress(pt) -> bytes:
    """ZCash-style compressed encoding: 381-bit x + flag bits in top byte."""
    if pt is None:
        return bytes([0xC0] + [0] * 47)
    x, y = pt
    flags = 0x80  # compressed
    if y > (P - 1) // 2:
        flags |= 0x20
    b = bytearray(x.to_bytes(48, "big"))
    b[0] |= flags
    return bytes(b)


def g1_decompress(b: bytes, check_subgroup: bool = True):
    """Decode a compressed G1 point. Network-facing: enforces canonical
    encoding (single byte-representation per point) and, by default, membership
    in the order-R subgroup — required for BLS soundness (G1 cofactor ~2^125).
    The membership test is the fast GLV endomorphism check
    (g1_in_subgroup); a probabilistic BATCH check would be unsound here
    because the cofactor has small prime factors (3, 11, ...)."""
    if len(b) != 48:
        raise ValueError("bad G1 encoding length")
    from tpubft_torch.crypto import bls_native
    if bls_native.available():
        pt = bls_native.g1_decompress(b)        # canonical+curve, fast sqrt
    else:
        bls_native.count_fallback()
        flags = b[0]
        if not flags & 0x80:
            raise ValueError("uncompressed G1 not supported")
        if flags & 0x40:
            if b != bytes([0xC0]) + b"\x00" * 47:
                raise ValueError("non-canonical G1 infinity encoding")
            return None
        x = int.from_bytes(bytes([b[0] & 0x1F]) + b[1:], "big")
        if x >= P:
            raise ValueError("G1 x out of range")
        y = fp_sqrt((x * x % P * x + B1) % P)
        if y is None:
            raise ValueError("not on curve")
        if (y > (P - 1) // 2) != bool(flags & 0x20):
            y = P - y
        pt = (x, y)
    if pt is not None and check_subgroup and not g1_in_subgroup(pt):
        raise ValueError("G1 point not in order-R subgroup")
    return pt


# GLV endomorphism subgroup test (the blst/Scott fast check): on the
# order-R subgroup the endomorphism phi(x,y) = (beta*x, y) acts as
# multiplication by lambda = x_param^2 - 1 (a root of T^2+T+1 mod R);
# on every cofactor component the eigenvalues differ, so
#   phi(P) == [lambda]P  <=>  P is in the subgroup.
# One ~127-bit scalar mul instead of the full 255-bit [R]P check.
# beta is the cube root of unity matching this orientation (verified
# against the [R]P test on generator and cofactor points in
# tests/test_bls12381.py).
_G1_BETA = 0x1A0111EA397FE699EC02408663D4DE85AA0D857D89759AD4897D29650FB85F9B409427EB4F49FFFD8BFD00000000AAAC
_G1_LAMBDA = 0xD201000000010000 ** 2 - 1


def g1_in_subgroup(pt) -> bool:
    """Fast deterministic order-R membership test for on-curve points."""
    if pt is None:
        return True
    phi = (pt[0] * _G1_BETA % P, pt[1])
    return g1_mul_nonorder(pt, _G1_LAMBDA) == phi


def g2_compress(pt) -> bytes:
    if pt is None:
        return bytes([0xC0] + [0] * 95)
    (x0, x1), (y0, y1) = pt
    flags = 0x80
    # lexicographic "greater" on (y1, y0), ZCash convention
    greater = (y1 > (P - 1) // 2) if y1 else (y0 > (P - 1) // 2)
    if greater:
        flags |= 0x20
    b = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    b[0] |= flags
    return bytes(b)


def g2_decompress(b: bytes, check_subgroup: bool = True):
    if len(b) != 96:
        raise ValueError("bad G2 encoding length")
    flags = b[0]
    if not flags & 0x80:
        raise ValueError("uncompressed G2 not supported")
    if flags & 0x40:
        if b != bytes([0xC0]) + b"\x00" * 95:
            raise ValueError("non-canonical G2 infinity encoding")
        return None
    x1 = int.from_bytes(bytes([b[0] & 0x1F]) + b[1:48], "big")
    x0 = int.from_bytes(b[48:], "big")
    if x0 >= P or x1 >= P:
        raise ValueError("G2 x out of range")
    x = (x0, x1)
    rhs = fp2_add(fp2_mul(fp2_sqr(x), x), B2)
    y = fp2_sqrt(rhs)
    if y is None:
        raise ValueError("not on curve")
    y0, y1 = y
    greater = (y1 > (P - 1) // 2) if y1 else (y0 > (P - 1) // 2)
    if greater != bool(flags & 0x20):
        y = fp2_neg(y)
    pt = (x, y)
    if check_subgroup and g2_mul_nonorder(pt, R) is not None:
        raise ValueError("G2 point not in order-R subgroup")
    return pt


def g2_mul_nonorder_py(pt, k: int):
    """Scalar mul without reducing k mod R (subgroup checks)."""
    result = None
    add = pt
    while k:
        if k & 1:
            result = g2_add(result, add)
        add = g2_add(add, add)
        k >>= 1
    return result


def g2_mul_nonorder(pt, k: int):
    from tpubft_torch.crypto import bls_native
    if bls_native.available():
        return bls_native.g2_mul_nonorder(pt, k)
    bls_native.count_fallback()
    return g2_mul_nonorder_py(pt, k)


# ---------------- BLS signatures (min-sig: sig in G1, pk in G2) ----------------

def keygen(seed: Optional[bytes] = None) -> Tuple[int, Tuple]:
    if seed is not None:
        sk = int.from_bytes(hashlib.sha512(b"bls-keygen" + seed).digest(), "big") % (R - 1) + 1
    else:
        sk = secrets.randbelow(R - 1) + 1
    return sk, g2_mul(G2_GEN, sk)


def sign(sk: int, msg: bytes):
    return g1_mul(hash_to_g1(msg), sk)


def verify(pk_g2, msg: bytes, sig_g1) -> bool:
    if sig_g1 is None or not g1_is_on_curve(sig_g1):
        return False
    # e(sig, g2) == e(H(m), pk)  ⇔  e(sig, -g2) * e(H(m), pk) == 1
    return pairing_check([(sig_g1, g2_neg(G2_GEN)), (hash_to_g1(msg), pk_g2)])


# ---------------- Shamir threshold + Lagrange ----------------

def threshold_keygen(k: int, n: int, seed: Optional[bytes] = None):
    """k-of-n Shamir sharing of a BLS secret. Returns
    (master_pk_g2, share_pks_g2[n], secret_shares[n])."""
    if seed is not None:
        coeffs = [int.from_bytes(hashlib.sha512(b"thr" + seed + i.to_bytes(4, "big")).digest(),
                                 "big") % (R - 1) + 1 for i in range(k)]
    else:
        coeffs = [secrets.randbelow(R - 1) + 1 for _ in range(k)]
    master_pk = g2_mul(G2_GEN, coeffs[0])
    shares = []
    for i in range(1, n + 1):
        v = 0
        for j, c in enumerate(coeffs):
            v = (v + c * pow(i, j, R)) % R
        shares.append(v)
    share_pks = [g2_mul(G2_GEN, s) for s in shares]
    return master_pk, share_pks, shares


def lagrange_coeffs_at_zero(ids: Sequence[int]) -> List[int]:
    """L_i(0) mod R for the signer-id set (reference:
    threshsign/src/bls/relic/BlsThresholdAccumulator.cpp:42
    computeLagrangeCoeff).

    Optimized for large signer sets (n=1000 scale): the shared numerator
    Π(-j) is computed once; per-i denominators accumulate the SMALL
    integer differences (i-j) in machine-size chunks before each modular
    reduction; and all k inversions collapse into ONE modexp via
    Montgomery batch inversion. ~10x over the naive per-i modexp loop at
    k=667."""
    k = len(ids)
    if k == 0:
        return []
    # fail loud on degenerate id sets: an id ≡ 0 mod R zeroes the
    # batched products (silently-infinite combined signature), and
    # duplicates make the interpolation meaningless
    if len(set(i % R for i in ids)) != k or any(i % R == 0 for i in ids):
        raise ValueError("signer ids must be distinct and nonzero mod R")
    num_total = 1
    for j in ids:
        num_total = num_total * (R - j) % R          # Π (0 - j)
    # den_i = Π_{j != i} (i - j); |i - j| is small, so bundle ~5 factors
    # per big-int modmul
    terms = []
    for i in ids:
        den = 1
        small = 1
        nsmall = 0
        for j in ids:
            if j == i:
                continue
            small *= i - j
            nsmall += 1
            if nsmall == 5:
                den = den * small % R
                small, nsmall = 1, 0
        if nsmall:
            den = den * small % R
        # fold the numerator's surplus (0 - i) factor into the inversion
        terms.append(den * (R - i) % R)
    # batch inversion: one modexp total
    prefix = [1] * (k + 1)
    for t in range(k):
        prefix[t + 1] = prefix[t] * terms[t] % R
    inv_all = pow(prefix[k], R - 2, R)
    coeffs = [0] * k
    for t in range(k - 1, -1, -1):
        coeffs[t] = num_total * (inv_all * prefix[t] % R) % R
        inv_all = inv_all * terms[t] % R
    return coeffs


def combine_shares(ids: Sequence[int], shares_g1: Sequence) -> object:
    """Lagrange-weighted MSM of signature shares → combined signature.

    The hot op the TPU backend shards (reference FastMultExp.cpp:27)."""
    coeffs = lagrange_coeffs_at_zero(ids)
    return g1_msm(shares_g1, coeffs)


# ---------------- batch share verification (aggregation tree) ----------------

def g2_msm_py(points: Sequence, scalars: Sequence[int]):
    """Pure-Python golden model — composes g2_mul_py, never the routed
    g2_mul (same independence rule as g1_msm_py)."""
    acc = None
    for pt, k in zip(points, scalars):
        acc = g2_add(acc, g2_mul_py(pt, k))
    return acc


def g2_msm(points: Sequence, scalars: Sequence[int]):
    from tpubft_torch.crypto import bls_native
    if bls_native.available():
        return bls_native.g2_msm(points, scalars)
    bls_native.count_fallback()
    return g2_msm_py(points, scalars)


def _rlc_scalars(n: int, context: bytes) -> List[int]:
    """Deterministic 128-bit random-linear-combination coefficients. A
    forged share survives the combined check only with probability
    2^-128 per coefficient choice; deriving them from the share data
    itself (Fiat-Shamir style) means the adversary committed to the
    shares before learning the coefficients."""
    out = []
    for i in range(n):
        h = hashlib.sha256(b"bls-rlc" + context + i.to_bytes(4, "big"))
        out.append(int.from_bytes(h.digest()[:16], "big") | 1)
    return out


def batch_verify_shares(pks_g2: Sequence, h_g1, shares_g1: Sequence) -> bool:
    """One pairing check for a whole batch of shares over ONE message
    point: e(Σ z_i·s_i, -g2) · e(H, Σ z_i·pk_i) == 1 with random z_i
    (the role of the reference's aggregated root check,
    BlsBatchVerifier.cpp:44). Sound up to 2^-128 per batch."""
    if not shares_g1:
        return True
    if any(s is None or not g1_is_on_curve(s) for s in shares_g1):
        return False
    # bind the full statement (message point + every pk + every share)
    # into the coefficient transcript, per standard batch-verify practice
    ctx = (g1_compress(h_g1)
           + b"".join(g2_compress(p) for p in pks_g2)
           + b"".join(g1_compress(s) for s in shares_g1))
    zs = _rlc_scalars(len(shares_g1), ctx)
    agg_sig = g1_msm(shares_g1, zs)
    agg_pk = g2_msm(pks_g2, zs)
    return pairing_check([(agg_sig, g2_neg(G2_GEN)), (h_g1, agg_pk)])


class BlsBatchVerifier:
    """Binary aggregation tree over shares: verify the aggregate first,
    descend only into failing halves — b bad shares cost O(b·log n)
    pairing checks instead of n (reference BlsBatchVerifier::batchVerify
    / batchVerifyRecursive, threshsign/src/bls/relic/BlsBatchVerifier.cpp:
    44,84)."""

    def __init__(self, pks_g2: Sequence, h_g1):
        self._pks = list(pks_g2)
        self._h = h_g1
        self.checks = 0                 # pairing-check count (observability)

    def batch_verify(self, shares_g1: Sequence) -> List[bool]:
        out = [False] * len(shares_g1)
        self._recurse(list(range(len(shares_g1))), list(shares_g1), out)
        return out

    def _recurse(self, idxs: List[int], shares: List, out: List[bool]) -> None:
        if not idxs:
            return
        self.checks += 1
        if batch_verify_shares([self._pks[i] for i in idxs], self._h,
                               [shares[i] for i in idxs]):
            for i in idxs:
                out[i] = True
            return
        if len(idxs) == 1:
            out[idxs[0]] = False
            return
        mid = len(idxs) // 2
        self._recurse(idxs[:mid], shares, out)
        self._recurse(idxs[mid:], shares, out)
