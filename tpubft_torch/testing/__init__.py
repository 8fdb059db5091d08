"""Seeded test inputs shared by the CPU tests and chip_smoke.py.

`ed25519_corpus` is the verify corpus the port is held against: the
reference's Pallas-test mix (valid, tampered, wrong key, wrong message)
plus the strict-verify corner cases that live half on the host and half
in the kernel — s >= L, non-canonical A and R (y >= p), A and R with
x = 0 and the sign bit set, A and R whose y has no square root, a
small-order A (y = 0, a point of order 4), wrong-length signature and
key, and R bytes that are not a point encoding.

`ecdsa_corpus` is a seeded ECDSA batch (a few principals, RFC 6979
signatures, forged items at chosen indices), and `ecdsa_wrap_lanes` the
kernels' inputs for the wrap case x(T) = r + n, which no honest
signature reaches (the reference's tests/test_ecdsa_batch.py:180-240
crafts it the same way).

`kvbcbench_rows` is the ledger's block shape: the reference's kvbcbench
(benchmarks/bench_kvbc.py), 8 versioned keys and one Merkle-proven key
per block. `ledger_rows` are seeded blocks of puts, deletes and tags in
all three category types, which every ledger engine accepts.

The package also holds the harnesses (port of tpubft/testing/):
`InProcessCluster` runs a cluster in this process, `BftTestNetwork`
(with its `MetricsClient`) one OS process a replica over UDP, TCP or TLS,
and `S3TestServer` is the S3-compatible test server of storage/s3.py.
They are exported lazily (PEP 562), since
`tpubft_torch.testing.slowdown` and `.crashpoints` are imported by the
consensus engine at module scope and an eager cluster import here would
close a circular import back into tpubft_torch.consensus.replica.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

from tpubft_torch.crypto import cpu, scalar

KINDS = ("valid", "tampered", "wrong_key", "wrong_msg", "s_ge_l",
         "a_noncanonical", "r_noncanonical", "a_x0_sign", "a_nonsquare",
         "short_sig", "short_pk", "r_random", "valid_long_msg",
         "r_x0_sign", "r_nonsquare", "a_small_order")


@functools.lru_cache(maxsize=None)
def _signer(i: int) -> cpu.Ed25519Signer:
    return cpu.Ed25519Signer.generate(seed=f"sk-{i}".encode())


@functools.lru_cache(maxsize=1)
def nonsquare_y() -> int:
    """The smallest y whose (y^2-1)/(d y^2+1) has no square root: an
    encoding that passes the host checks and fails decompression."""
    y = 2
    while scalar._decompress(y.to_bytes(32, "little")) is not None:
        y += 1
    return y


def ed25519_corpus(n: int, seed: int = 0
                   ) -> List[Tuple[bytes, bytes, bytes]]:
    """n (message, signature, public key) triples; item i is of kind
    KINDS[i % len(KINDS)], messages and tampering drawn from `seed`."""
    rng = np.random.default_rng(seed)
    p = scalar.P
    items = []
    for i in range(n):
        kind = KINDS[i % len(KINDS)]
        signer = _signer(i % 17)
        size = 200 if kind == "valid_long_msg" else 24
        msg = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        sig = signer.sign(msg)
        pk = signer.public_bytes()
        if kind == "tampered":
            j = int(rng.integers(0, 64))
            sig = sig[:j] + bytes([sig[j] ^ 0x40]) + sig[j + 1:]
        elif kind == "wrong_key":
            pk = _signer((i + 1) % 17).public_bytes()
        elif kind == "wrong_msg":
            msg = msg + b"!"
        elif kind == "s_ge_l":
            s = int.from_bytes(sig[32:], "little") + scalar.L
            sig = sig[:32] + s.to_bytes(32, "little")
        elif kind == "a_noncanonical":
            pk = (p + int(rng.integers(0, 18))).to_bytes(32, "little")
        elif kind == "r_noncanonical":
            r = p + int(rng.integers(0, 18)) | (i & 1) << 255
            sig = r.to_bytes(32, "little") + sig[32:]
        elif kind == "a_x0_sign":
            # y = 1 and y = p-1 both give x = 0; sign bit 1 must reject
            y = 1 if i & 1 else p - 1
            pk = (y | 1 << 255).to_bytes(32, "little")
        elif kind == "a_nonsquare":
            pk = (nonsquare_y() | (i & 1) << 255).to_bytes(32, "little")
        elif kind == "short_sig":
            sig = sig[:63]
        elif kind == "short_pk":
            pk = pk[:31]
        elif kind == "r_x0_sign":
            # R = (0, 1) or (0, -1) encoded with the sign bit: no point
            # encodes so, whatever Q the ladder reaches
            y = 1 if i & 1 else p - 1
            sig = (y | 1 << 255).to_bytes(32, "little") + sig[32:]
        elif kind == "r_nonsquare":
            r = nonsquare_y() | (i & 1) << 255
            sig = r.to_bytes(32, "little") + sig[32:]
        elif kind == "a_small_order":
            # y = 0: x^2 = -1, a point of order 4 (both signs decode)
            pk = ((i & 1) << 255).to_bytes(32, "little")
        elif kind == "r_random":
            r = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
            sig = r + sig[32:]
        items.append((msg, sig, pk))
    return items


@functools.lru_cache(maxsize=1)
def small_y_point() -> Tuple[int, int]:
    """(x, y) of the point with the smallest y >= 2 that decompresses,
    x even (sign bit 0). Its y is below 2^255 - p, so y + p is a tight
    limb value too."""
    y = 2
    while scalar._decompress(y.to_bytes(32, "little")) is None:
        y += 1
    return scalar._decompress(y.to_bytes(32, "little"))[0], y


def raw_kernel_lanes() -> Tuple[Tuple[np.ndarray, ...], List[bool]]:
    """Verify-kernel inputs the host never sends (prepare_batch zeroes every
    row with a y >= p), with the plain version's raw verdicts: A = (x, y)
    of `small_y_point`, s = 0 and h = 1, so Q = -A, checked against R =
    -A's encoding as is (accepted), with R's y + p (rejected: the plain
    version compares canonical y), with A's y + p (decompressed mod p:
    accepted) and with R's sign flipped (rejected).
    -> ((s_win, h_win, a_y, a_sign, r_y, r_sign), verdicts)."""
    from tpubft_torch.ops import f25519 as F
    x, y = small_y_point()
    p = scalar.P
    neg_sign = (p - x) & 1
    rows = [(y, y, neg_sign, True), (y, y + p, neg_sign, False),
            (y + p, y, neg_sign, True), (y, y, 1 - neg_sign, False)]

    def limbs(values):
        raw = np.array([list(v.to_bytes(32, "little")) for v in values],
                       np.uint8)
        return F.bytes_le_to_limbs(raw)

    n = len(rows)
    s_win = np.zeros((64, n), np.int32)
    h_win = np.zeros((64, n), np.int32)
    h_win[0] = 1
    arrays = (s_win, h_win, limbs([r[0] for r in rows]),
              np.zeros(n, np.int32), limbs([r[1] for r in rows]),
              np.array([r[2] for r in rows], np.int32))
    return arrays, [r[3] for r in rows]


@functools.lru_cache(maxsize=None)
def _ecdsa_signer(curve: str, i: int) -> cpu.EcdsaSigner:
    return cpu.EcdsaSigner.generate(curve, seed=f"ecdsa-{i}".encode())


def ecdsa_corpus(curve: str, n: int, seed: int = 0, forged=(),
                 principals: int = 16
                 ) -> List[Tuple[bytes, bytes, bytes]]:
    """n (message, signature r||s, SEC1 public key) triples of
    `principals` signers, messages drawn from `seed`; the items at the
    indices in `forged` carry another message than the one signed."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        signer = _ecdsa_signer(curve, i % principals)
        msg = rng.integers(0, 256, 48, dtype=np.uint8).tobytes()
        sig = signer.sign(msg)
        if i in forged:
            msg = b"forged" + msg[6:]
        items.append((msg, sig, signer.public_bytes()))
    return items


def ecdsa_wrap_lanes(curve: str):
    """Two crafted lanes of each ECDSA kernel's inputs, as (8, 2) uint32
    words and (2,) masks: u1, u2 and Q are fixed, T = [u1]G + [u2]Q is
    computed on the host, and r is x(T) + 1, so only the wrap candidate
    r + n = x(T) can match. Returns (rlc, verify, want): rlc is
    ops/ecdsa.rlc_fold_kernel's arguments after the curve, lane 0 with
    wrap_ok (its residual is 0) and lane 1 the same without (nonzero);
    verify is verify_kernel's, lane 0 with r+n = x(T) (accepted), lane 1
    with r+n = x(T) + 1 (rejected); want = (x(T), [True, False])."""
    from tpubft_torch.ops import ecdsa as ops_ecdsa
    cv = scalar.CURVES[curve]
    p, a = cv["p"], cv["a"]
    u1, u2 = 0x1234567, 0x89ABCDE
    d = scalar.ecdsa_seed_to_private(b"wrap", curve)
    q = scalar._jac_to_affine(scalar._mul_g(d, curve), p)
    t = scalar._jac_add(scalar._mul_g(u1, curve),
                        scalar._jac_mul(u2, q, cv), p, a)
    xt, _ = scalar._jac_to_affine(t, p)
    junk = (xt + 1) % p
    w = ops_ecdsa.words_of
    both = (w([u1, u1]), w([u2, u2]), w([q[0], q[0]]), w([q[1], q[1]]))
    rlc = both + (w([junk, junk]), w([xt, xt]), np.array([True, False]),
                  np.ones(2, bool), w([12345, 12345]))
    verify = both + (w([junk, junk]), w([xt, junk]))
    return rlc, verify, (xt, [True, False])


def ecdsa_exceptional_lanes(curve: str):
    """Crafted inputs of each ECDSA kernel that reach the exceptional
    cases of its Jacobian additions (fed to the kernel directly: the
    precheck would refuse some): Q = G with u1 = u2 (the join adds equal
    points: a doubling), Q = G with u2 = n - u1 and Q = -G with u2 = u1
    (the join adds inverses: the identity), u1 = 0, u2 = 0, u1 = u2 = 0,
    and Q = G with u1 = u2 again with r off by one. r is x(T) mod n where
    T is not the identity. Returns (verify, rlc, want, xs): verify_kernel's
    arguments after the curve, rlc_fold_kernel's (every lane active, the
    wrap factor on the first three where r + n < p, odd coefficients),
    the expected verdicts and the expected affine x (0 for the
    identity)."""
    from tpubft_torch.ops import ecdsa as ops_ecdsa
    c = scalar.CURVES[curve]
    p, n = c["p"], c["n"]
    g, gneg = (c["gx"], c["gy"]), (c["gx"], p - c["gy"])
    q = scalar._jac_to_affine(scalar._mul_g(0xC0FFEE, curve), p)
    u = 0x1234567890ABCDEF1234567890ABCDEF
    lanes = [(u, u, g, 2 * u), (u, n - u, g, 0), (u, u, gneg, 0),
             (0, u, q, u * 0xC0FFEE), (u, 0, q, u), (0, 0, q, 0),
             (u, u, g, 2 * u)]
    rows, want, xs = [], [], []
    for i, (u1, u2, pt, k) in enumerate(lanes):
        t = scalar._jac_to_affine(scalar._mul_g(k % n, curve), p) \
            if k % n else None
        r = t[0] % n if t else 1
        if i == len(lanes) - 1:
            r = (r + 1) % n
        rows.append((u1, u2, pt[0], pt[1], r, r + n if r + n < p else p))
        want.append(bool(t) and i != len(lanes) - 1)
        xs.append(t[0] if t else 0)
    w = ops_ecdsa.words_of
    verify = tuple(w([row[k] for row in rows]) for k in range(6))
    wrap = np.array([i < 3 and row[4] + n < p for i, row in enumerate(rows)])
    rlc = verify[:5] + (w([row[4] + n if ok else 0
                           for row, ok in zip(rows, wrap)]), wrap,
                        np.ones(len(rows), bool),
                        w([2 * i + 1 for i in range(len(rows))]))
    return verify, rlc, want, xs


def kvbcbench_rows(blocks: int, keys_per_block: int = 8, big_every: int = 0
                   ) -> List[List[Tuple[str, bytes, bytes, str]]]:
    """Blocks b = 0 .. blocks-1 of the reference's kvbcbench:
    `keys_per_block` VERSIONED_KV writes to category "bench" (keys
    k-<n> cycling over 2*blocks names) and one BLOCK_MERKLE write of
    m-<b % 64> to category "proven", as (category, key, value, category
    type) rows. With `big_every` > 0, every big_every-th block's first
    versioned value is 4 KiB instead (blocks of mixed sizes)."""
    out = []
    for b in range(blocks):
        rows = []
        for i in range(keys_per_block):
            k = b"k-%d" % ((b * keys_per_block + i) % (blocks * 2))
            v = b"v-%d-%d" % (b, i)
            if big_every and i == 0 and b % big_every == 0:
                v = v.ljust(4096, b".")
            rows.append(("bench", k, v, "versioned_kv"))
        rows.append(("proven", b"m-%d" % (b % 64), b"mv-%d" % b,
                     "block_merkle"))
        out.append(rows)
    return out


def ledger_rows(blocks: int, seed: int, keys: int = 6
                ) -> List[List[tuple]]:
    """Seeded blocks that every ledger engine accepts, mixing the three
    category types: puts and deletes of `keys` names in the versioned
    category "kv" and the Merkle category "mk", and in the immutable
    category "ev" a new key a write (never rewritten or deleted) with
    zero to two of the tags t0..t2. Rows are convert.block_updates'
    (category, key, value or None, category type, tags)."""
    rng = np.random.default_rng(seed)
    out, fresh = [], 0
    for b in range(blocks):
        rows = {}
        for _ in range(int(rng.integers(1, 6))):
            kind = int(rng.integers(0, 3))
            if kind == 2:
                tags = sorted({f"t{int(t)}" for t in
                               rng.integers(0, 3, int(rng.integers(0, 3)))})
                rows[("ev", b"e-%d" % fresh)] = (
                    b"ev-%d-%d" % (b, fresh), "immutable", tags)
                fresh += 1
                continue
            cat, cat_type = (("kv", "versioned_kv") if kind == 0
                             else ("mk", "block_merkle"))
            key = b"%s-%d" % (cat.encode(), int(rng.integers(0, keys)))
            value = (None if rng.random() < 0.25
                     else b"%s-%d-%d" % (cat.encode(), b,
                                         int(rng.integers(0, 1 << 16))))
            rows[(cat, key)] = (value, cat_type, [])
        out.append([(cat, key, value, cat_type, tags) for (cat, key),
                    (value, cat_type, tags) in rows.items()])
    return out


def __getattr__(name):
    if name == "InProcessCluster":
        from tpubft_torch.testing.cluster import InProcessCluster
        return InProcessCluster
    if name in ("BftTestNetwork", "MetricsClient"):
        from tpubft_torch.testing import network
        return getattr(network, name)
    if name == "S3TestServer":
        from tpubft_torch.testing.s3server import S3TestServer
        return S3TestServer
    raise AttributeError(name)
