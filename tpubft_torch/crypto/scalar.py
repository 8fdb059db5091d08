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
host. The ECDSA half waits for its slice.
"""
from __future__ import annotations

import functools
import hashlib
from typing import List, Optional, Sequence

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
