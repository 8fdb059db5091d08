"""Seeded test inputs shared by the CPU tests and chip_smoke.py.

`ed25519_corpus` is the verify corpus the port is held against: the
reference's Pallas-test mix (valid, tampered, wrong key, wrong message)
plus the strict-verify corner cases that live half on the host and half
in the kernel — s >= L, non-canonical A and R (y >= p), A and R with
x = 0 and the sign bit set, A and R whose y has no square root, a
small-order A (y = 0, a point of order 4), wrong-length signature and
key, and R bytes that are not a point encoding.

`kvbcbench_rows` is the ledger's block shape: the reference's kvbcbench
(benchmarks/bench_kvbc.py), 8 versioned keys and one Merkle-proven key
per block.

The package also holds the in-process harnesses (port of
tpubft/testing/): `InProcessCluster` is exported lazily (PEP 562), since
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


def __getattr__(name):
    if name == "InProcessCluster":
        from tpubft_torch.testing.cluster import InProcessCluster
        return InProcessCluster
    raise AttributeError(name)
