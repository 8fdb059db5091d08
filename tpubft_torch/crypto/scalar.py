"""Self-hosted scalar Ed25519 engine — stdlib only (port of the Ed25519
half of tpubft/crypto/scalar.py).

Pure-Python Ed25519 (RFC 8032) for the host-side sign / keygen /
single-verify paths and for the degraded tier behind the device
breaker. The batched CUDA kernel (ops/ed25519_cuda.py) is the hot
verification plane. Byte contracts are the reference's: 32-byte public
keys, 64-byte signatures, and the historical seed -> private-key
derivation, so key material generated by either package is identical.

The group math is plain Python ints: extended twisted-Edwards
coordinates with the same add-2008-hwcd-3 / dbl-2008-hwcd formulas as
the device kernel. Fixed-base multiplications walk a cached comb table.
This is NOT constant-time; replica keys here already assume a trusted
host.

The ECDSA half (port of reference scalar.py:262-1160) is the same code:
secp256k1 / secp256r1 over Jacobian coordinates, RFC 6979 signing, the
batched host verify (`ecdsa_verify_batch`: one batch inversion a comb
column, graduated per-principal combs, the GLV split on secp256k1) with
its pubkey memo and evictions, and the attributed stats sinks
(`new_stats_sink` / `attribute_stats`) that SigManager folds into its
ECDSA counters. `ecdsa_precheck_batch` is the one admission both the
host engine and the CUDA kernels' host half (ops/ecdsa.py) consume.
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
import hmac
import os
import threading
from typing import (Dict, Iterator, List, NamedTuple, Optional, Sequence,
                    Tuple)

# ---------------------------------------------------------------------------
# Ed25519 (RFC 8032)
# ---------------------------------------------------------------------------

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = -121665 * pow(121666, -1, P) % P
_K2D = 2 * D % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
BASE_X = 15112221349535400772501151409588531511454012693041857206046113283949847762202
BASE_Y = 46316835694926478169428394003475163141307993866256225615783033603165251855960

# extended coordinates (X, Y, Z, T) with x = X/Z, y = Y/Z, T = XY/Z
_EXT_IDENT = (0, 1, 1, 0)


def _ext_add(p, q):
    """Unified extended addition (add-2008-hwcd-3, a=-1, k=2d) — the
    int-scalar twin of ops/ed25519.point_add."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * t2 % P * _K2D % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _ext_double(p):
    """Dedicated doubling (dbl-2008-hwcd, a=-1) — twin of point_dbl."""
    x, y, z, _ = p
    a = x * x % P
    b = y * y % P
    c = 2 * z * z % P
    e = ((x + y) * (x + y) - a - b) % P
    g = (b - a) % P
    h = (-a - b) % P
    f = (g - c) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _ext_neg(p):
    x, y, z, t = p
    return (P - x if x else 0, y, z, P - t if t else 0)


@functools.lru_cache(maxsize=1)
def _base_comb_table():
    """Comb table for fixed-base mults: tab[j][d] = [d·16^j]B for
    j in 0..63, d in 0..15 — a 256-bit scalar mult becomes ≤64 additions
    with zero doublings. ~1k point ops to build, built once."""
    tab = []
    win = (BASE_X, BASE_Y, 1, BASE_X * BASE_Y % P)
    for _ in range(64):
        row = [_EXT_IDENT, win]
        for _ in range(14):
            row.append(_ext_add(row[-1], win))
        tab.append(row)
        # 16^(j+1)·B = 15·16^j·B + 16^j·B
        win = _ext_add(row[-1], row[1])
    return tab


def _mul_base(k: int):
    """[k]B via the cached comb table (≤64 additions, no doublings)."""
    acc = _EXT_IDENT
    tab = _base_comb_table()
    j = 0
    while k:
        d = k & 15
        if d:
            acc = _ext_add(acc, tab[j][d])
        k >>= 4
        j += 1
    return acc


def _ext_mul(k: int, pt):
    """[k]P, 4-bit fixed-window ladder (variable base: verify only) —
    15 table adds + 4 doublings and ≤1 add per window."""
    row = [_EXT_IDENT, pt]
    for _ in range(14):
        row.append(_ext_add(row[-1], pt))
    acc = _EXT_IDENT
    started = False
    for shift in range((max(k.bit_length(), 1) + 3) // 4 * 4 - 4, -1, -4):
        if started:
            acc = _ext_double(_ext_double(_ext_double(_ext_double(acc))))
        d = (k >> shift) & 15
        if d:
            acc = _ext_add(acc, row[d])
            started = True
    return acc


def _compress(pt) -> bytes:
    x, y, z, _ = pt
    zi = pow(z, -1, P)
    x, y = x * zi % P, y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _decompress(b32: bytes):
    """Canonical RFC 8032 decoding: reject y >= p and x=0 with sign=1 —
    the same strictness as the device kernel's host prechecks."""
    y = int.from_bytes(b32, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    if y >= P:
        return None
    y2 = y * y % P
    u = (y2 - 1) % P
    v = (D * y2 + 1) % P
    # x = sqrt(u/v) via the (p-5)/8 exponent trick
    x = u * pow(v, 3, P) % P * pow(u * pow(v, 7, P) % P, (P - 5) // 8, P) % P
    vx2 = v * x % P * x % P
    if vx2 != u:
        if vx2 != P - u:
            return None
        x = x * SQRT_M1 % P
    if x == 0 and sign:
        return None
    if (x & 1) != sign:
        x = P - x
    return (x, y, 1, x * y % P)


def _clamp(b32: bytes) -> int:
    a = int.from_bytes(b32, "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


def ed25519_seed_to_private(seed: bytes) -> bytes:
    """Historical keyfile derivation — must never change: existing
    keygen'd key material depends on it."""
    return hashlib.sha256(b"ed25519-keygen" + seed).digest()


def ed25519_public_key(sk: bytes) -> bytes:
    h = hashlib.sha512(sk).digest()
    return _compress(_mul_base(_clamp(h[:32])))


def ed25519_sign(sk: bytes, msg: bytes, pk: Optional[bytes] = None) -> bytes:
    """RFC 8032 deterministic signature — byte-identical to OpenSSL's.
    `pk` (the signer's own public key) is recomputed when not supplied;
    long-lived signers pass their cached copy."""
    h = hashlib.sha512(sk).digest()
    a = _clamp(h[:32])
    prefix = h[32:]
    if pk is None:
        pk = _compress(_mul_base(a))
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
    rb = _compress(_mul_base(r))
    k = int.from_bytes(hashlib.sha512(rb + pk + msg).digest(), "little") % L
    s = (r + k * a) % L
    return rb + s.to_bytes(32, "little")


def ed25519_sign_batch(sk: bytes, msgs: Sequence[bytes],
                       pk: Optional[bytes] = None) -> List[bytes]:
    """RFC 8032 deterministic signatures for a batch of messages under
    ONE key — byte-identical to `ed25519_sign` per item. The comb walks
    stay per-item (≤64 cached-table adds each — already cheap), but the
    R-point affine compressions share ONE Montgomery batch inversion
    (`_batch_inv`) instead of paying a full field inversion per
    signature, the same amortization the batched verifier's residue
    paths lean on. Key-derivation hashing and the public-key compress
    are hoisted out of the loop."""
    if not msgs:
        return []
    h = hashlib.sha512(sk).digest()
    a = _clamp(h[:32])
    prefix = h[32:]
    if pk is None:
        pk = _compress(_mul_base(a))
    rs: List[int] = []
    pts = []
    for msg in msgs:
        r = int.from_bytes(hashlib.sha512(prefix + msg).digest(),
                           "little") % L
        rs.append(r)
        pts.append(_mul_base(r))
    invs = _batch_inv([pt[2] for pt in pts], P)
    out: List[bytes] = []
    for msg, r, pt, zi in zip(msgs, rs, pts, invs):
        x, y = pt[0] * zi % P, pt[1] * zi % P
        rb = (y | ((x & 1) << 255)).to_bytes(32, "little")
        k = int.from_bytes(hashlib.sha512(rb + pk + msg).digest(),
                           "little") % L
        s = (r + k * a) % L
        out.append(rb + s.to_bytes(32, "little"))
    return out


def ed25519_verify(pk: bytes, msg: bytes, sig: bytes) -> bool:
    """Strict cofactorless verify: s < L, canonical A and R encodings,
    encode([s]B - [k]A) == R — the same equation and strictness as the
    batched kernel (ops/ed25519.verify_kernel), so scalar and device
    verdicts can never diverge."""
    if len(sig) != 64 or len(pk) != 32:
        return False
    sig, pk = bytes(sig), bytes(pk)
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False                    # malleability: reject s >= L
    a_pt = _decompress(pk)
    if a_pt is None:
        return False
    k = int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(),
                       "little") % L
    q = _ext_add(_mul_base(s), _ext_mul(k, _ext_neg(a_pt)))
    # a non-canonical R encoding can never equal a canonical compress
    return _compress(q) == sig[:32]


def _batch_inv(values: Sequence[int], m: int) -> List[int]:
    """Montgomery's trick: invert every element mod m with ONE pow.
    All values must be nonzero mod m (callers screen them)."""
    k = len(values)
    prefix = [1] * (k + 1)
    acc = 1
    for i, v in enumerate(values):
        acc = acc * v % m
        prefix[i + 1] = acc
    inv = pow(acc, -1, m)
    out = [0] * k
    for i in range(k - 1, -1, -1):
        out[i] = inv * prefix[i] % m
        inv = inv * values[i] % m
    return out


# ---------------------------------------------------------------------------
# ECDSA over short-Weierstrass curves (SHA-256, RFC 6979 nonces)
# ---------------------------------------------------------------------------

# Parameters mirror ops/ecdsa.CURVES (tests/test_torch_ecdsa_engine.py
# checks both against the reference's) — duplicated so this module stays
# importable with the stdlib alone.
CURVES = {
    "secp256k1": dict(
        p=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F,
        a=0, b=7,
        gx=0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
        gy=0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
        n=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141),
    "secp256r1": dict(
        p=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
        a=-3, b=0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
        gx=0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
        gy=0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
        n=0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551),
}

_JAC_IDENT = (0, 1, 0)


def _jac_double(pt, p: int, a: int):
    x, y, z = pt
    if z == 0:
        return _JAC_IDENT
    ys = y * y % p
    s = 4 * x * ys % p
    z2 = z * z % p
    m = (3 * x * x + a * z2 % p * z2) % p
    x3 = (m * m - 2 * s) % p
    y3 = (m * (s - x3) - 8 * ys * ys) % p
    z3 = 2 * y * z % p
    return (x3, y3, z3)


def _jac_add(q, r, p: int, a: int):
    if q[2] == 0:
        return r
    if r[2] == 0:
        return q
    z1z1 = q[2] * q[2] % p
    z2z2 = r[2] * r[2] % p
    u1 = q[0] * z2z2 % p
    u2 = r[0] * z1z1 % p
    s1 = q[1] * z2z2 % p * r[2] % p
    s2 = r[1] * z1z1 % p * q[2] % p
    if u1 == u2:
        if s1 != s2:
            return _JAC_IDENT           # P + (-P)
        return _jac_double(q, p, a)
    h = (u2 - u1) % p
    rr = (s2 - s1) % p
    h2 = h * h % p
    h3 = h * h2 % p
    v = u1 * h2 % p
    x3 = (rr * rr - h3 - 2 * v) % p
    y3 = (rr * (v - x3) - s1 * h3) % p
    z3 = h * q[2] % p * r[2] % p
    return (x3, y3, z3)


def _jac_to_affine(pt, p: int) -> Optional[Tuple[int, int]]:
    x, y, z = pt
    if z == 0:
        return None
    zi = pow(z, -1, p)
    zi2 = zi * zi % p
    return (x * zi2 % p, y * zi2 % p * zi % p)


@functools.lru_cache(maxsize=None)
def _g_table(curve_name: str):
    """2^i·G in Jacobian coords — fixed-base mult for sign/keygen."""
    cv = CURVES[curve_name]
    p, a = cv["p"], cv["a"]
    tab = []
    pt = (cv["gx"], cv["gy"], 1)
    for _ in range(256):
        tab.append(pt)
        pt = _jac_double(pt, p, a)
    return tab


def _mul_g(k: int, curve_name: str):
    cv = CURVES[curve_name]
    p, a = cv["p"], cv["a"]
    acc = _JAC_IDENT
    tab = _g_table(curve_name)
    i = 0
    while k:
        if k & 1:
            acc = _jac_add(acc, tab[i], p, a)
        k >>= 1
        i += 1
    return acc


def _jac_mul(k: int, affine, cv):
    p, a = cv["p"], cv["a"]
    acc = _JAC_IDENT
    base = (affine[0], affine[1], 1)
    for i in range(k.bit_length() - 1, -1, -1):
        acc = _jac_double(acc, p, a)
        if (k >> i) & 1:
            acc = _jac_add(acc, base, p, a)
    return acc


def ecdsa_seed_to_private(seed: bytes, curve_name: str) -> int:
    """Historical keyfile derivation — must never change (see
    ed25519_seed_to_private)."""
    n = CURVES[curve_name]["n"]
    v = int.from_bytes(hashlib.sha512(b"ecdsa-keygen" + seed).digest(), "big")
    return v % (n - 1) + 1


def ecdsa_random_private(curve_name: str) -> int:
    n = CURVES[curve_name]["n"]
    return int.from_bytes(os.urandom(48), "big") % (n - 1) + 1


def ecdsa_public_key(d: int, curve_name: str) -> bytes:
    """SEC1 uncompressed point: 0x04 || x || y (65 bytes)."""
    aff = _jac_to_affine(_mul_g(d, curve_name), CURVES[curve_name]["p"])
    assert aff is not None, "private value is a multiple of the order"
    return b"\x04" + aff[0].to_bytes(32, "big") + aff[1].to_bytes(32, "big")


def _rfc6979_nonces(x: int, h1: bytes, q: int) -> Iterator[int]:
    """RFC 6979 §3.2 deterministic nonce stream (HMAC-SHA256), qlen=256."""
    qlen = (q.bit_length() + 7) // 8

    def bits2int(b: bytes) -> int:
        v = int.from_bytes(b, "big")
        extra = len(b) * 8 - q.bit_length()
        return v >> extra if extra > 0 else v

    bx = x.to_bytes(qlen, "big") + (bits2int(h1) % q).to_bytes(qlen, "big")
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + bx, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + bx, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        t = b""
        while len(t) < qlen:
            v = hmac.new(k, v, hashlib.sha256).digest()
            t += v
        cand = bits2int(t)
        if 1 <= cand < q:
            yield cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def ecdsa_sign(d: int, msg: bytes, curve_name: str) -> bytes:
    """Deterministic ECDSA (RFC 6979, SHA-256), raw r||s output. The
    OpenSSL path signs with a random nonce — both verify identically;
    determinism here buys reproducible tests and no RNG dependence."""
    cv = CURVES[curve_name]
    n = cv["n"]
    h1 = hashlib.sha256(msg).digest()
    z = int.from_bytes(h1, "big") % n
    for k in _rfc6979_nonces(d, h1, n):
        aff = _jac_to_affine(_mul_g(k, curve_name), cv["p"])
        if aff is None:
            continue
        r = aff[0] % n
        if r == 0:
            continue
        s = pow(k, -1, n) * (z + r * d) % n
        if s == 0:
            continue
        return r.to_bytes(32, "big") + s.to_bytes(32, "big")
    raise AssertionError("unreachable: RFC 6979 stream exhausted")


def ecdsa_on_curve(x: int, y: int, curve_name: str) -> bool:
    cv = CURVES[curve_name]
    p = cv["p"]
    if not (0 <= x < p and 0 <= y < p):
        return False
    return (y * y - (x * x * x + cv["a"] * x + cv["b"])) % p == 0


# ---------------------------------------------------------------------------
# Batched ECDSA verification (the degraded-mode hot path)
#
# The per-item `ecdsa_verify` below pays a full generic double-and-add
# ladder plus a fresh pow(s, -1, n) per signature (~30/s-class on the
# bench container through the verifier stack).  `ecdsa_verify_batch`
# amortizes everything that can be shared across a batch:
#
#   * ONE Montgomery batch inversion for every s^-1 (and one more per
#     comb column for the affine-addition denominators, so the whole
#     group walk runs in affine coordinates — ~6 mulmods per point add
#     instead of ~16 for a Jacobian add);
#   * a precomputed fixed-base comb table for G shared module-wide
#     (tab[j][d] = [d * 2^(w*j)]G, so [u1]G is ~32 table additions with
#     zero doublings);
#   * a per-principal comb table for each public key Q, built lazily
#     and graduated: a cheap 4-bit comb on first contact, upgraded to
#     an 8-bit comb once the principal is hot (BFT clients re-sign for
#     their whole session, so the build cost amortizes to noise);
#   * a per-principal decoded-pubkey memo — SEC1 decode + on-curve
#     check paid once per key, not once per retransmitted verify.
#
# All items walk their comb columns in lockstep: each column step
# gathers one affine addition per item, batch-inverts all denominators
# in one Montgomery pass (one pow per column for the whole batch), and
# applies the additions.  Verdicts are byte-identical to the scalar
# loop (locked by tests/test_ecdsa_batch.py three-way vectors).
# ---------------------------------------------------------------------------

# comb widths / cache sizing (env-tunable, read once at import; see
# docs/OPERATIONS.md "ECDSA verification tuning")
_COMB_G_WIDTH = max(1, min(8, int(os.environ.get(
    "TPUBFT_ECDSA_COMB_G", "8"))))
_COMB_Q_COLD_WIDTH = 4
_COMB_Q_HOT_WIDTH = 8
# lifetime verifies after which a principal's comb is rebuilt hot
_COMB_HOT_AFTER = max(1, int(os.environ.get(
    "TPUBFT_ECDSA_COMB_HOT_AFTER", "192")))
_PK_CACHE_MAX = max(4, int(os.environ.get(
    "TPUBFT_ECDSA_PK_CACHE", "256")))
# hot (8-bit) tables are ~2MB each — cap how many stay resident
_HOT_COMB_MAX = max(1, int(os.environ.get(
    "TPUBFT_ECDSA_HOT_COMBS", "24")))


# ---- GLV endomorphism split (secp256k1) ------------------------------
# phi(x, y) = (beta*x, y) equals [lam]P on secp256k1 (beta^3 = 1 mod p,
# lam^3 = 1 mod n), so any scalar k splits as k = k1 + k2*lam (mod n)
# with |k1|, |k2| ~ sqrt(n) via the standard lattice basis
# (a1, b1), (a2, b2) — libsecp256k1's constants. The batched verify
# walks BOTH half-scalars over the same ~17 comb columns (width 8)
# instead of 32, sharing one batch inversion per column; see
# _ecdsa_verify_batch. secp256r1 has no such endomorphism and keeps the
# full-length walk.
_GLV_PARAMS = {
    "secp256k1": dict(
        beta=0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE,
        lam=0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72,
        a1=0x3086D221A7D46BCDE86C90E49284EB15,
        b1=-0xE4437ED6010E88286F547FA90ABFE4C3,
        a2=0x114CA50F7A8E2F3F657C1108D9D44CFD8,
        b2=0x3086D221A7D46BCDE86C90E49284EB15,
    ),
}
# decomposition magnitude rail: reduced scalars always split below
# ~2^128.5; the walk guards at 2^132 and routes a (mathematically
# unreachable) violator through the plain per-item verify instead
_GLV_MAX = 1 << 132


def _glv_enabled() -> bool:
    """Read per call (not at import) so the equivalence tests can pin
    GLV on vs off inside one process; the comb tables serve both paths
    unchanged (full 256-bit rows, the GLV walk just stops early)."""
    return os.environ.get("TPUBFT_ECDSA_GLV", "1") != "0"


def _glv_max_walk() -> int:
    """GLV pays while the per-column batch inversion is the dominant
    serial cost. Each item trades 64 comb additions (32 G + 32 Q at
    width 8) for 68 (2 x 17 + 2 x 17: the half-scalar column count
    ceilings at 17, since |k_i| can exceed 2^128), so past ~32 lockstep
    items the four extra additions outweigh the halved inversion count
    and the full-length walk takes over. The host engine is the
    small-batch / breaker-open path (the device kernel owns large
    batches), so the gated regime is the common one."""
    return int(os.environ.get("TPUBFT_ECDSA_GLV_MAX_B", "32"))


def _glv_cols(width: int) -> int:
    """Comb columns a half-scalar walk needs at this width."""
    return (132 + width - 1) // width


def _glv_split(k: int, glv: dict, n: int) -> Tuple[int, bool, int, bool]:
    """k -> (|k1|, k1<0, |k2|, k2<0) with k1 + k2*lam ≡ k (mod n)."""
    c1 = (glv["b2"] * k + (n >> 1)) // n
    c2 = (-glv["b1"] * k + (n >> 1)) // n
    k1 = k - c1 * glv["a1"] - c2 * glv["a2"]
    k2 = -c1 * glv["b1"] - c2 * glv["b2"]
    return abs(k1), k1 < 0, abs(k2), k2 < 0


def _jac_batch_to_affine(pts: Sequence, p: int) -> List[Optional[Tuple[int, int]]]:
    """Jacobian -> affine for a whole list with one batch inversion."""
    live = [(i, pt) for i, pt in enumerate(pts) if pt[2] != 0]
    out: List[Optional[Tuple[int, int]]] = [None] * len(pts)
    if not live:
        return out
    invs = _batch_inv([pt[2] for _, pt in live], p)
    for (i, pt), zi in zip(live, invs):
        zi2 = zi * zi % p
        out[i] = (pt[0] * zi2 % p, pt[1] * zi2 % p * zi % p)
    return out


def _build_comb(x: int, y: int, width: int, curve_name: str,
                nbits: int = 256) -> List[List[Optional[Tuple[int, int]]]]:
    """Comb table rows[j][d] = [d * 2^(width*j)](x, y) in AFFINE coords
    (d in 1..2^width-1; index 0 unused).  Affine entries make every
    lockstep addition a mixed add with a batch-shared inversion."""
    cv = CURVES[curve_name]
    p, a = cv["p"], cv["a"]
    cols = (nbits + width - 1) // width
    base = (x, y, 1)
    jac_rows = []
    for _ in range(cols):
        row = [base]
        for _ in range(2, 1 << width):
            row.append(_jac_add(row[-1], base, p, a))
        jac_rows.append(row)
        for _ in range(width):
            base = _jac_double(base, p, a)
    flat = [pt for row in jac_rows for pt in row]
    aff = _jac_batch_to_affine(flat, p)
    out: List[List[Optional[Tuple[int, int]]]] = []
    i = 0
    for _ in range(cols):
        out.append([None] + aff[i:i + (1 << width) - 1])
        i += (1 << width) - 1
    return out


@functools.lru_cache(maxsize=None)
def _g_comb(curve_name: str):
    cv = CURVES[curve_name]
    return _build_comb(cv["gx"], cv["gy"], _COMB_G_WIDTH, curve_name)


class _PubkeyEntry:
    """Per-principal cache slot: decoded point + graduated comb."""
    __slots__ = ("pt", "verifies", "comb", "width")

    def __init__(self, pt: Optional[Tuple[int, int]]):
        self.pt = pt
        self.verifies = 0
        self.comb: Optional[list] = None
        self.width = 0


def _make_stats_lock():
    try:
        from tpubft_torch.utils.racecheck import make_lock
        return make_lock("scalar.ecdsa_cache")
    except Exception:  # pragma: no cover — bootstrap fallback
        import threading
        return threading.Lock()


_cache_lock = _make_stats_lock()
# (curve, pk bytes) -> _PubkeyEntry, LRU-bounded (hits move-to-end so a
# busy principal's hot comb is never evicted by insertion age)
from collections import OrderedDict as _OrderedDict
_pk_cache: "_OrderedDict[Tuple[str, bytes], _PubkeyEntry]" = _OrderedDict()
_HOST_SIZES_KEEP = 256
_hot_combs: List[Tuple[str, bytes]] = []

_SINK_KEYS = ("hits", "misses", "evictions", "comb_evictions",
              "comb_builds", "host_batches", "host_items", "host_ns")


class StatsSink:
    """Attributed counter sink with an ATOMIC drain: increments and the
    drain-and-reset swap serialize on the sink's own lock, so two
    replicas' SigManagers (or a writer racing a concurrent drain — the
    event recorded on one side of the swap lands in exactly one drain,
    never both, never neither) can't lose or double-count updates.
    `host_ns` carries the batched engine's wall time — the autotuner's
    host-tier cost sensor next to the kernel profiler's device tier."""

    __slots__ = ("_mu", "_d", "_sizes")

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._d = {k: 0 for k in _SINK_KEYS}
        self._sizes: List[int] = []

    def add(self, key: str, amount: int = 1) -> None:
        with self._mu:
            self._d[key] += amount

    def note_host_batch(self, size: int, elapsed_ns: int = 0) -> None:
        with self._mu:
            self._d["host_batches"] += 1
            self._d["host_items"] += size
            self._d["host_ns"] += elapsed_ns
            self._sizes.append(size)
            del self._sizes[:-_HOST_SIZES_KEEP]

    def drain(self) -> Dict[str, object]:
        """Atomic drain-and-reset: one lock section swaps the counters
        out, so a concurrent writer's increment is either in this drain
        or the next — never torn across both."""
        with self._mu:
            out: Dict[str, object] = dict(self._d)
            out["host_sizes"] = self._sizes
            self._d = {k: 0 for k in _SINK_KEYS}
            self._sizes = []
        return out


# module-level fallback sink: engine users outside an attribute_stats
# scope (standalone benches, direct cpu.EcdsaVerifier callers) land
# here; consume_decode_stats drains it
_module_sink = StatsSink()

# thread-local stats attribution: a SigManager wraps its verification in
# `attribute_stats(sink)` so events recorded on ITS thread land in ITS
# sink — exact per-replica metrics in multi-replica processes, where the
# engine (and its caches) is shared module state.  Without a sink,
# events fall through to the module sink above.
_TLS = threading.local()


def new_stats_sink() -> StatsSink:
    return StatsSink()


@contextlib.contextmanager
def attribute_stats(sink: StatsSink):
    prev = getattr(_TLS, "sink", None)
    _TLS.sink = sink
    try:
        yield sink
    finally:
        _TLS.sink = prev


def _sink() -> StatsSink:
    sink = getattr(_TLS, "sink", None)
    return sink if sink is not None else _module_sink


def _stat(key: str, amount: int = 1) -> None:
    _sink().add(key, amount)


def _note_host_batch(size: int, elapsed_ns: int = 0) -> None:
    _sink().note_host_batch(size, elapsed_ns)


def _pk_entry(pk: bytes, curve_name: str) -> _PubkeyEntry:
    """SEC1-uncompressed decode + on-curve check, memoized per key: a
    retransmitting client pays the decode once per key, not per verify
    (hits surface as `pubkey_memo_hits` on signature_manager)."""
    key = (curve_name, bytes(pk))
    with _cache_lock:
        e = _pk_cache.get(key)
        if e is not None:
            _pk_cache.move_to_end(key)
    if e is not None:
        _stat("hits")
        return e
    _stat("misses")
    pt: Optional[Tuple[int, int]] = None
    if len(pk) == 65 and pk[0] == 0x04:
        x = int.from_bytes(pk[1:33], "big")
        y = int.from_bytes(pk[33:], "big")
        if ecdsa_on_curve(x, y, curve_name):
            pt = (x, y)
    e = _PubkeyEntry(pt)
    with _cache_lock:
        cur = _pk_cache.get(key)
        if cur is not None:
            return cur                      # racing first decoders share
        _pk_cache[key] = e
        evicted = comb_evicted = 0
        while len(_pk_cache) > _PK_CACHE_MAX:
            old, _ = _pk_cache.popitem(last=False)
            evicted += 1
            if old in _hot_combs:
                _hot_combs.remove(old)
                comb_evicted += 1
    if evicted:
        # eviction telemetry: a high rate here with a falling decode
        # hit-rate means the live principal population outruns
        # TPUBFT_ECDSA_PK_CACHE — the bounded-LRU health signal at
        # million-principal scale (per-shard admission routing exists
        # to keep each worker's slice of the population inside this)
        _stat("evictions", evicted)
        if comb_evicted:
            _stat("comb_evictions", comb_evicted)
    return e


def reset_ecdsa_caches() -> None:
    """Drop every cached pubkey entry and comb table (test/bench
    isolation: a sweep measuring cold-vs-warm tiers must not inherit
    another row's cache residency or hot-slot occupancy)."""
    with _cache_lock:
        _pk_cache.clear()
        _hot_combs.clear()


def consume_decode_stats() -> Dict[str, object]:
    """Drain-and-reset the module-level (unattributed) sink: decode-memo
    counters plus recent host batch sizes/time. Atomic per sink
    (StatsSink.drain) — concurrent drains can't double-count, and a
    racing writer's increment lands in exactly one drain."""
    return _module_sink.drain()


def _q_comb(entry: _PubkeyEntry, key: Tuple[str, bytes], batch: int):
    """Graduated per-principal comb: 4-bit on first contact, rebuilt
    8-bit once the principal crosses _COMB_HOT_AFTER lifetime verifies
    (bounded by _HOT_COMB_MAX resident hot tables)."""
    curve_name = key[0]
    with _cache_lock:
        entry.verifies += batch
        # prune ghosts: a key evicted from _pk_cache while its comb was
        # still building would otherwise hold a hot slot forever
        _hot_combs[:] = [k for k in _hot_combs if k in _pk_cache]
        want_hot = (entry.verifies >= _COMB_HOT_AFTER
                    and entry.width < _COMB_Q_HOT_WIDTH
                    and len(_hot_combs) < _HOT_COMB_MAX)
        if entry.comb is not None and not want_hot:
            return entry.comb, entry.width
    width = _COMB_Q_HOT_WIDTH if want_hot else _COMB_Q_COLD_WIDTH
    comb = _build_comb(entry.pt[0], entry.pt[1], width, curve_name)
    _stat("comb_builds")
    with _cache_lock:
        _hot_combs[:] = [k for k in _hot_combs if k in _pk_cache]
        if key not in _pk_cache:
            # evicted while building: hand the caller the table for this
            # batch but don't let an uncached key occupy a hot slot
            entry.comb, entry.width = comb, width
            return entry.comb, entry.width
        if width >= _COMB_Q_HOT_WIDTH \
                and len(_hot_combs) >= _HOT_COMB_MAX \
                and key not in _hot_combs:
            # lost the cap race to a concurrent upgrade (the check above
            # ran before the build released the lock): discard this
            # build so resident hot tables respect TPUBFT_ECDSA_HOT_COMBS.
            # A comb-less entry keeps it anyway — never leave a decoded
            # key rebuilding per batch — which can transiently exceed
            # the cap by the number of racing first-contact threads.
            if entry.comb is None:
                entry.comb, entry.width = comb, width
                _hot_combs.append(key)
            return entry.comb, entry.width
        if width > entry.width:
            entry.comb, entry.width = comb, width
            if width >= _COMB_Q_HOT_WIDTH and key not in _hot_combs:
                _hot_combs.append(key)
        return entry.comb, entry.width


def _digit_columns(k: int, width: int) -> Tuple[int, ...]:
    """LSB-first base-2^width digits of a 256-bit scalar."""
    b = k.to_bytes(32, "little")
    if width == 8:
        return tuple(b)
    if width == 4:
        out = []
        for byte in b:
            out.append(byte & 15)
            out.append(byte >> 4)
        return tuple(out)
    return tuple((k >> (width * j)) & ((1 << width) - 1)
                 for j in range((256 + width - 1) // width))


class EcdsaBatchPrecheck(NamedTuple):
    """Shared admission result: the ONE precheck both the host batch
    engine and the device kernels' host prep consume (ops/ecdsa
    adapts its item order onto this), so the four verification paths
    cannot drift on what they admit."""
    live: List[int]                      # indices that passed admission
    r: List[int]                         # per-index r (0 when invalid)
    u1: Dict[int, int]                   # e/s mod n for live indices
    u2: Dict[int, int]                   # r/s mod n for live indices
    entries: List[Optional[_PubkeyEntry]]  # decoded-pubkey cache slots


def ecdsa_precheck_batch(items: Sequence[Tuple[bytes, bytes, bytes]],
                         curve_name: str) -> EcdsaBatchPrecheck:
    """Admission identical to `ecdsa_verify` (shape, 0 < r,s < n,
    on-curve pubkey via the per-principal memo) plus u1/u2 scalars with
    ONE Montgomery batch inversion for every s^-1.
    items: (pubkey, message, sig) triples."""
    n = CURVES[curve_name]["n"]
    B = len(items)
    live: List[int] = []
    rs = [0] * B
    ss = [0] * B
    es = [0] * B
    entries: List[Optional[_PubkeyEntry]] = [None] * B
    for i, (pk, msg, sig) in enumerate(items):
        if len(sig) != 64:
            continue
        sig = bytes(sig)
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:], "big")
        if not (0 < r < n and 0 < s < n):
            continue
        entry = _pk_entry(pk, curve_name)
        if entry.pt is None:
            continue
        rs[i], ss[i] = r, s
        es[i] = int.from_bytes(hashlib.sha256(msg).digest(), "big") % n
        entries[i] = entry
        live.append(i)
    u1: Dict[int, int] = {}
    u2: Dict[int, int] = {}
    if live:
        winv = _batch_inv([ss[i] for i in live], n)
        for i, w in zip(live, winv):
            u1[i] = es[i] * w % n
            u2[i] = rs[i] * w % n
    return EcdsaBatchPrecheck(live, rs, u1, u2, entries)


# a cold principal's comb build (~6ms for 4-bit) only beats the plain
# per-item ladder once it serves this many verifies
_COMB_MIN_GROUP = 3


def ecdsa_verify_batch(items: Sequence[Tuple[bytes, bytes, bytes]],
                       curve_name: str) -> List[bool]:
    """Batched ECDSA verify: items are (pubkey, message, raw r||s sig)
    triples (pubkeys may all differ).  Verdict-identical to calling
    `ecdsa_verify` per item, ~10x faster at batch 256 on the bench
    container (see benchmarks/RESULTS.md). Batch shape AND wall time
    land in the attributed stats sink (`host_ns`) — the autotuner's
    host-tier cost sensor for the device/host crossover."""
    if not items:
        return []
    import time as _time
    t0 = _time.monotonic_ns()
    try:
        return _ecdsa_verify_batch(items, curve_name)
    finally:
        _note_host_batch(len(items), _time.monotonic_ns() - t0)


def _ecdsa_verify_batch(items: Sequence[Tuple[bytes, bytes, bytes]],
                        curve_name: str) -> List[bool]:
    cv = CURVES[curve_name]
    p, n, a = cv["p"], cv["n"], cv["a"]
    B = len(items)
    out = [False] * B
    chk = ecdsa_precheck_batch(items, curve_name)
    rs, u1, u2 = chk.r, chk.u1, chk.u2
    if not chk.live:
        return out
    # ---- per-principal combs (one build/bump per distinct key) ----
    by_key: Dict[Tuple[str, bytes], List[int]] = {}
    for i in chk.live:
        by_key.setdefault((curve_name, bytes(items[i][0])), []).append(i)
    qcomb = {}
    qwidth = {}
    walk: List[int] = []
    for key, idxs in by_key.items():
        entry = chk.entries[idxs[0]]
        with _cache_lock:
            cold_small = (entry.comb is None
                          and entry.verifies + len(idxs) < _COMB_MIN_GROUP)
            if cold_small:
                entry.verifies += len(idxs)
        if cold_small:
            # a comb build for 1-2 cold items costs more than the plain
            # ladder it replaces: verify directly (verifies still
            # accumulate, so a recurring principal graduates to a comb)
            for i in idxs:
                pk, msg, sig = items[i]
                out[i] = ecdsa_verify(pk, msg, sig, curve_name)
            continue
        comb, width = _q_comb(entry, key, len(idxs))
        for i in idxs:
            qcomb[i] = comb
            qwidth[i] = width
        walk.extend(idxs)
    if not walk:
        return out
    # ---- lockstep affine comb walk ----
    # steps: (shared_row_or_None, per_item_rows_or_None, idxs, digits,
    #         phis, negs) — phis (per-entry, GLV only) routes the
    #         gathered entry through the secp256k1 endomorphism
    #         (x, y) -> (beta*x mod p, y) (the [lam]P half-scalar
    #         stream, reusing the same comb rows); negs flags per-item
    #         sign flips (y -> p - y at gather) for negative
    #         half-scalars
    steps = []
    g_rows = _g_comb(curve_name)
    glv = (_GLV_PARAMS.get(curve_name)
           if _glv_enabled() and len(walk) <= _glv_max_walk() else None)
    if glv is not None:
        # GLV split: u = s1*|k1| + s2*|k2|*lam
        # (mod n) with |k1|, |k2| < 2^~128.5, so the walk is
        # _glv_cols(width) columns instead of the full 256-bit run.
        # Both half-scalars of one column share a single step — and so
        # a single _batch_inv — by accumulating into two independent
        # lanes (item i: lane A at slot i, lane B at slot B+i; adds
        # across lanes have no serial dependency, unlike two adds into
        # one accumulator). The walk length (= the count of per-column
        # modular inversions, the serial cost here) halves and each
        # surviving inversion amortizes over twice the additions; a
        # final batched merge add folds lane B into lane A.
        splits = {}
        bounded = []
        for i in walk:
            s = (_glv_split(u1[i], glv, n) + _glv_split(u2[i], glv, n))
            if max(s[0], s[2], s[4], s[6]) >= _GLV_MAX:
                # magnitude rail (unreachable for reduced scalars):
                # verdict via the plain per-item path, never a wrong
                # answer from truncated digits
                pk_i, msg_i, sig_i = items[i]
                out[i] = ecdsa_verify(pk_i, msg_i, sig_i, curve_name)
                continue
            splits[i] = s
            bounded.append(i)
        walk = bounded
        if not walk:
            return out
        lane_b = [B + i for i in walk]
        both = walk + lane_b
        g_phis = [False] * len(walk) + [True] * len(walk)
        g_negs = ([splits[i][1] for i in walk]
                  + [splits[i][3] for i in walk])
        da = {i: _digit_columns(splits[i][0], _COMB_G_WIDTH)
              for i in walk}
        db = {i: _digit_columns(splits[i][2], _COMB_G_WIDTH)
              for i in walk}
        for j in range(_glv_cols(_COMB_G_WIDTH)):
            steps.append((g_rows[j], None, both,
                          [da[i][j] for i in walk]
                          + [db[i][j] for i in walk], g_phis, g_negs))
        for width in (_COMB_Q_HOT_WIDTH, _COMB_Q_COLD_WIDTH):
            sub = [i for i in walk if qwidth[i] == width]
            if not sub:
                continue
            sub_both = sub + [B + i for i in sub]
            q_phis = [False] * len(sub) + [True] * len(sub)
            q_negs = ([splits[i][5] for i in sub]
                      + [splits[i][7] for i in sub])
            qa = {i: _digit_columns(splits[i][4], width) for i in sub}
            qb = {i: _digit_columns(splits[i][6], width) for i in sub}
            for j in range(_glv_cols(width)):
                rows_j = [qcomb[i][j] for i in sub]
                steps.append((None, rows_j + rows_j, sub_both,
                              [qa[i][j] for i in sub]
                              + [qb[i][j] for i in sub],
                              q_phis, q_negs))
    else:
        g_digs = {i: _digit_columns(u1[i], _COMB_G_WIDTH) for i in walk}
        for j, row in enumerate(g_rows):
            steps.append((row, None, walk,
                          [g_digs[i][j] for i in walk], None, None))
        for width in (_COMB_Q_HOT_WIDTH, _COMB_Q_COLD_WIDTH):
            sub = [i for i in walk if qwidth[i] == width]
            if not sub:
                continue
            digs = {i: _digit_columns(u2[i], width) for i in sub}
            for j in range(len(qcomb[sub[0]])):
                steps.append((None, [qcomb[i][j] for i in sub], sub,
                              [digs[i][j] for i in sub], None, None))
    beta = glv["beta"] if glv is not None else 0
    lanes = 2 * B if glv is not None else B
    ax = [0] * lanes
    ay = [0] * lanes
    inf = [True] * lanes
    for shared_row, rows, idxs, digs, phis, negs in steps:
        denoms: List[int] = []
        dap = denoms.append
        acts: List[Tuple[int, int, int, int]] = []
        aap = acts.append
        for t, i in enumerate(idxs):
            d = digs[t]
            if not d:
                continue
            e = shared_row[d] if shared_row is not None else rows[t][d]
            if phis is not None:
                if phis[t]:
                    e = (beta * e[0] % p, e[1])
                if negs[t]:
                    e = (e[0], p - e[1])
            if inf[i]:
                ax[i], ay[i] = e
                inf[i] = False
                continue
            dx = e[0] - ax[i]
            if dx:
                dap(dx)
                aap((i, e[0], e[1], 0))
            elif e[1] == ay[i]:
                # doubling (2-torsion is impossible on these curves, so
                # 2*y is never 0 here)
                dap(2 * ay[i])
                aap((i, e[0], e[1], 1))
            else:
                inf[i] = True               # P + (-P)
        if not denoms:
            continue
        invs = _batch_inv(denoms, p)
        for (i, ex, ey, dbl), invd in zip(acts, invs):
            x1 = ax[i]
            y1 = ay[i]
            if dbl:
                lam = (3 * x1 * x1 + a) * invd % p
                x3 = (lam * lam - 2 * x1) % p
            else:
                lam = (ey - y1) * invd % p
                x3 = (lam * lam - x1 - ex) % p
            ay[i] = (lam * (x1 - x3) - y1) % p
            ax[i] = x3
    if glv is not None:
        # fold lane B (the [lam]-stream accumulator) into lane A with
        # one final batched affine add
        denoms = []
        acts = []
        for i in walk:
            ib = B + i
            if inf[ib]:
                continue
            if inf[i]:
                ax[i], ay[i] = ax[ib], ay[ib]
                inf[i] = False
                continue
            dx = ax[ib] - ax[i]
            if dx:
                denoms.append(dx)
                acts.append((i, ax[ib], ay[ib], 0))
            elif ay[ib] == ay[i]:
                denoms.append(2 * ay[i])
                acts.append((i, ax[ib], ay[ib], 1))
            else:
                inf[i] = True               # A + (-A)
        if denoms:
            invs = _batch_inv(denoms, p)
            for (i, ex, ey, dbl), invd in zip(acts, invs):
                x1 = ax[i]
                y1 = ay[i]
                if dbl:
                    lam = (3 * x1 * x1 + a) * invd % p
                    x3 = (lam * lam - 2 * x1) % p
                else:
                    lam = (ey - y1) * invd % p
                    x3 = (lam * lam - x1 - ex) % p
                ay[i] = (lam * (x1 - x3) - y1) % p
                ax[i] = x3
    for i in walk:
        # x(T) mod n == r covers the r+n wrap case by construction
        out[i] = (not inf[i]) and ax[i] % n == rs[i]
    return out


def ecdsa_verify(pk: bytes, msg: bytes, sig: bytes, curve_name: str) -> bool:
    """Standard ECDSA verify with the same admission checks as the
    batched kernel's host precheck (ops/ecdsa.prepare_batch): shapes,
    0 < r,s < n, pubkey on curve; then x([u1]G + [u2]Q) ≡ r (mod n)."""
    cv = CURVES[curve_name]
    p, n = cv["p"], cv["n"]
    if len(sig) != 64 or len(pk) != 65 or pk[0] != 0x04:
        return False
    sig, pk = bytes(sig), bytes(pk)
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:], "big")
    x = int.from_bytes(pk[1:33], "big")
    y = int.from_bytes(pk[33:], "big")
    if not (0 < r < n and 0 < s < n):
        return False
    if not ecdsa_on_curve(x, y, curve_name):
        return False
    z = int.from_bytes(hashlib.sha256(msg).digest(), "big") % n
    w = pow(s, -1, n)
    u1, u2 = z * w % n, r * w % n
    pt = _jac_add(_mul_g(u1, curve_name), _jac_mul(u2, (x, y), cv),
                  p, cv["a"])
    aff = _jac_to_affine(pt, p)
    if aff is None:
        return False                    # R' is the identity
    return aff[0] % n == r
