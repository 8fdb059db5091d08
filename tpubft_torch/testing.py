"""Seeded test inputs shared by the CPU tests and chip_smoke.py.

`ed25519_corpus` is the verify corpus the port is held against: the
reference's Pallas-test mix (valid, tampered, wrong key, wrong message)
plus the strict-verify corner cases that live half on the host and half
in the kernel — s >= L, non-canonical A and R (y >= p), A with x = 0 and
the sign bit set, A whose y has no square root, wrong-length signature
and key, and R bytes that are not a point encoding.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

from tpubft_torch.crypto import cpu, scalar

KINDS = ("valid", "tampered", "wrong_key", "wrong_msg", "s_ge_l",
         "a_noncanonical", "r_noncanonical", "a_x0_sign", "a_nonsquare",
         "short_sig", "short_pk", "r_random", "valid_long_msg")


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
        elif kind == "r_random":
            r = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
            sig = r + sig[32:]
        items.append((msg, sig, pk))
    return items
