"""ctypes bridge to the native BLS12-381 engine (port of
tpubft/crypto/bls_native.py).

The RELIC role in concord-bft (threshsign/src/bls/relic/): pairing
checks and G1/G2 multi-scalar multiplications in C++ instead of pure
Python — the ~100x that takes a combined-certificate verification from
~1 s to low milliseconds. Callers go through
tpubft_torch.crypto.bls12381, which routes here only when the library
builds (set TPUBFT_NO_NATIVE=1 to force the pure-Python paths).

Port divergences (reference bls_native.py:24-31): the engine is the
port's own copy of the source, tpubft_torch/native/bls12381.cpp, built
with g++ into ops/_build/ at first use (ops/_build.load_host); the
reference's library is never loaded. Every answer the pure-Python
fallback gives instead of the engine is counted in
COUNTS["fallbacks"] (bls12381.py counts at each routing point), and
the engine's pairing checks in COUNTS["pairing_checks"];
`load_error` keeps why the engine did not load.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence, Tuple

_lib = None
_tried = False
_load_lock = threading.Lock()
load_error: Optional[str] = None
COUNTS = {"pairing_checks": 0, "fallbacks": 0}


def count_fallback() -> None:
    """One answer given by the pure-Python engine instead of this one."""
    COUNTS["fallbacks"] += 1


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def available() -> bool:
    if _tried:
        return _lib is not None
    # Port divergence (reference bls_native.py:21-26): the first load is
    # taken under a lock, so a thread arriving during the g++ build waits
    # for the engine instead of answering from the pure-Python one
    with _load_lock:
        return _load()


def _load() -> bool:
    global _lib, _tried, load_error
    if _tried:
        return _lib is not None
    if os.environ.get("TPUBFT_NO_NATIVE"):
        load_error = "TPUBFT_NO_NATIVE is set"
    else:
        try:
            from tpubft_torch.ops._build import load_host
            lib = load_host("bls12381")
            for fn in ("bls381_pairing_check", "bls381_g1_msm",
                       "bls381_g2_msm", "bls381_g1_decompress",
                       "bls381_fp_sqrt"):
                getattr(lib, fn).restype = ctypes.c_int
            _lib = lib
        except Exception as exc:  # noqa: BLE001 — no toolchain: the
            # pure-Python fallback, counted at each routing point
            load_error = f"{type(exc).__name__}: {exc}"
    _tried = True        # last: the lock-free check in available() reads it
    return _lib is not None


def _fp48(x: int) -> bytes:
    return x.to_bytes(48, "big")


def pairing_check(pairs: Sequence[Tuple[object, object]]) -> bool:
    """prod e(P_i, Q_i) == 1 with P affine G1 int tuples, Q affine G2
    Fp2-tuple points (None = infinity) — same contract as the Python
    pairing_check."""
    n = len(pairs)
    g1 = bytearray(96 * n)
    g2 = bytearray(192 * n)
    infs = bytearray(n)
    for i, (p, q) in enumerate(pairs):
        if p is None:
            infs[i] |= 1
        else:
            g1[96 * i:96 * i + 48] = _fp48(p[0])
            g1[96 * i + 48:96 * i + 96] = _fp48(p[1])
        if q is None:
            infs[i] |= 2
        else:
            (x0, x1), (y0, y1) = q
            off = 192 * i
            g2[off:off + 48] = _fp48(x0)
            g2[off + 48:off + 96] = _fp48(x1)
            g2[off + 96:off + 144] = _fp48(y0)
            g2[off + 144:off + 192] = _fp48(y1)
    COUNTS["pairing_checks"] += 1
    ok = _lib.bls381_pairing_check(
        bytes(g1), bytes(g2), bytes(infs), n)
    return ok == 1


def g1_msm(points: Sequence, scalars: Sequence[int]):
    """sum_i [k_i] P_i over affine G1 int-tuple points -> point/None."""
    n = len(points)
    pts = bytearray(96 * n)
    infs = bytearray(n)
    ks = bytearray(32 * n)
    for i, (p, k) in enumerate(zip(points, scalars)):
        if p is None:
            infs[i] = 1
        else:
            pts[96 * i:96 * i + 48] = _fp48(p[0])
            pts[96 * i + 48:96 * i + 96] = _fp48(p[1])
        ks[32 * i:32 * i + 32] = (k % _R).to_bytes(32, "big")
    out = ctypes.create_string_buffer(96)
    out_inf = ctypes.c_uint8(0)
    _lib.bls381_g1_msm(out, ctypes.byref(out_inf), bytes(pts), bytes(infs),
                       bytes(ks), n)
    if out_inf.value:
        return None
    raw = out.raw
    return (int.from_bytes(raw[:48], "big"), int.from_bytes(raw[48:], "big"))


def g1_mul(point, k: int):
    return g1_msm([point], [k])


def fp_sqrt(x: int):
    """sqrt mod p for 0 <= x < p, or None when x is not a QR."""
    out = ctypes.create_string_buffer(48)
    if _lib.bls381_fp_sqrt(out, x.to_bytes(48, "big")) != 1:
        return None
    return int.from_bytes(out.raw, "big")


def g1_decompress(b: bytes):
    """Decode one compressed G1 point (canonical + on-curve checks, sqrt
    in native code; NO subgroup check — bls12381.g1_decompress layers the
    GLV membership test on top). Returns the affine int tuple, None for
    canonical infinity; raises ValueError on invalid encodings."""
    if len(b) != 48:
        raise ValueError("bad G1 encoding length")
    out = ctypes.create_string_buffer(96)
    rc = _lib.bls381_g1_decompress(out, bytes(b))
    if rc == 2:
        return None
    if rc != 1:
        raise ValueError("invalid G1 encoding")
    raw = out.raw
    return (int.from_bytes(raw[:48], "big"), int.from_bytes(raw[48:], "big"))


def g1_mul_nonorder(point, k: int):
    """[k]P without reducing k mod R (order/cofactor checks; k < 2^256)."""
    if point is None or k == 0:
        return None
    pts = _fp48(point[0]) + _fp48(point[1])
    out = ctypes.create_string_buffer(96)
    out_inf = ctypes.c_uint8(0)
    _lib.bls381_g1_msm(out, ctypes.byref(out_inf), pts, b"\x00",
                       k.to_bytes(32, "big"), 1)
    if out_inf.value:
        return None
    raw = out.raw
    return (int.from_bytes(raw[:48], "big"), int.from_bytes(raw[48:], "big"))


def g2_mul_nonorder(point, k: int):
    if point is None or k == 0:
        return None
    (x0, x1), (y0, y1) = point
    pts = _fp48(x0) + _fp48(x1) + _fp48(y0) + _fp48(y1)
    out = ctypes.create_string_buffer(192)
    out_inf = ctypes.c_uint8(0)
    _lib.bls381_g2_msm(out, ctypes.byref(out_inf), pts, b"\x00",
                       k.to_bytes(32, "big"), 1)
    if out_inf.value:
        return None
    raw = out.raw
    return ((int.from_bytes(raw[:48], "big"),
             int.from_bytes(raw[48:96], "big")),
            (int.from_bytes(raw[96:144], "big"),
             int.from_bytes(raw[144:], "big")))


def g2_msm(points: Sequence, scalars: Sequence[int]):
    n = len(points)
    pts = bytearray(192 * n)
    infs = bytearray(n)
    ks = bytearray(32 * n)
    for i, (q, k) in enumerate(zip(points, scalars)):
        if q is None:
            infs[i] = 1
        else:
            (x0, x1), (y0, y1) = q
            off = 192 * i
            pts[off:off + 48] = _fp48(x0)
            pts[off + 48:off + 96] = _fp48(x1)
            pts[off + 96:off + 144] = _fp48(y0)
            pts[off + 144:off + 192] = _fp48(y1)
        ks[32 * i:32 * i + 32] = (k % _R).to_bytes(32, "big")
    out = ctypes.create_string_buffer(192)
    out_inf = ctypes.c_uint8(0)
    _lib.bls381_g2_msm(out, ctypes.byref(out_inf), bytes(pts), bytes(infs),
                       bytes(ks), n)
    if out_inf.value:
        return None
    raw = out.raw
    return ((int.from_bytes(raw[:48], "big"),
             int.from_bytes(raw[48:96], "big")),
            (int.from_bytes(raw[96:144], "big"),
             int.from_bytes(raw[144:], "big")))


def g2_mul(point, k: int):
    return g2_msm([point], [k])


_R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
