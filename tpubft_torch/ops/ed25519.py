"""Batched Ed25519 signature verification (port of tpubft/ops/ed25519.py).

Split of labour, as in the reference:
  host   — parse 64B sig + 32B pk, SHA-512 → h mod L (vectorized numpy
           except the hash itself), canonicality prechecks (s < L,
           y < p), scalar→window recoding (`prepare_batch`);
  device — A decompression (sqrt in Fp), Q = [s]B + [h](-A), affine
           canonicalization, compare with R's encoding (`verify_kernel`).

`verify_kernel` routes on where its tensors lie: CUDA tensors go to the
hand-written Hopper kernel (ops/ed25519_cuda.py), CPU tensors to the
plain PyTorch version below, which is the torch counterpart of the
reference's XLA kernel over ops/f25519.py in the same 24-limb layout.
The plain version is what the CPU tests and chip_smoke hold the kernel
against; with a card present nothing on the main path calls it.

Verification equation (RFC 8032, cofactorless/strict): [s]B == R + [h]A,
checked as encode([s]B + [h](-A)) == R_bytes with canonical encodings.
"""
from __future__ import annotations

import functools
import hashlib
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from tpubft_torch import device as _device
from tpubft_torch.ops import f25519 as F

P = F.P
NL = F.NL
L = 2**252 + 27742317777372353535851937790883648493
D = -121665 * pow(121666, -1, P) % P
K2D = 2 * D % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
BASE_X = 15112221349535400772501151409588531511454012693041857206046113283949847762202
BASE_Y = 46316835694926478169428394003475163141307993866256225615783033603165251855960

WINDOWS = 64                     # 4-bit windows over 256-bit scalars
WIN = 16


class Point(NamedTuple):
    """Extended twisted-Edwards coordinates (X:Y:Z:T), f25519 limbs."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor


def identity(batch: int, device) -> Point:
    return Point(F.zero((batch,), device), F.one((batch,), device),
                 F.one((batch,), device), F.zero((batch,), device))


def point_neg(p: Point) -> Point:
    """Signed limbs: negation is elementwise negate of x and t."""
    return Point(-p.x, p.y, p.z, -p.t)


def point_add(p: Point, q: Point) -> Point:
    """Unified extended addition (EFD add-2008-hwcd-3, a=-1, k=2d) —
    complete for ed25519, so it covers doubling and identity. 9 field
    muls, operand looseness within f25519's m*k <= 10 budget."""
    k2d = F.const(K2D, p.x.shape[1:], p.x.device)
    a = F.mul(p.y - p.x, q.y - q.x)
    b = F.mul(p.y + p.x, q.y + q.x)
    c = F.mul(F.mul(p.t, k2d), q.t)
    d = F.mul(p.z, q.z + q.z)
    e = b - a
    f = d - c
    g = d + c
    h = b + a
    return Point(F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def point_dbl(p: Point) -> Point:
    """Dedicated doubling (EFD dbl-2008-hwcd, a=-1): 4 muls + 4 squares +
    one carry-normalize to keep the E*F product in budget."""
    a = F.sqr(p.x)
    b = F.sqr(p.y)
    c = F.sqr(p.z)
    c = c + c
    e = F.sqr(p.x + p.y) - a - b          # 3 multiples
    g = b - a                              # 2
    h = -a - b                             # 2
    f = F.normalize(g - c)                 # 4 -> 1 multiple
    return Point(F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def point_mixed_add(p: Point, n_ypx, n_ymx, n_t2d) -> Point:
    """Mixed addition with a precomputed affine niels point
    (y+x, y-x, 2d·xy): 7 field muls."""
    a = F.mul(p.y - p.x, n_ymx)
    b = F.mul(p.y + p.x, n_ypx)
    c = F.mul(p.t, n_t2d)
    d = p.z + p.z
    e = b - a
    f = d - c
    g = d + c
    h = b + a
    return Point(F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


# ---------------- host-precomputed base-point table ----------------

def _edw_add_int(p, q):
    (x1, y1), (x2, y2) = p, q
    denx = (1 + D * x1 * x2 * y1 * y2) % P
    deny = (1 - D * x1 * x2 * y1 * y2) % P
    x3 = (x1 * y2 + x2 * y1) * pow(denx, -1, P) % P
    y3 = (y1 * y2 + x1 * x2) * pow(deny, -1, P) % P
    return (x3, y3)


@functools.lru_cache(maxsize=None)
def _base_niels_ints() -> Tuple[Tuple[int, int, int], ...]:
    """d·B for d in 0..15 in niels form (y+x, y-x, 2d·xy) as ints mod p;
    d=0 is the niels identity (1, 1, 0)."""
    out = [(1, 1, 0)]
    pt = None
    for _ in range(1, WIN):
        pt = (BASE_X, BASE_Y) if pt is None else _edw_add_int(
            pt, (BASE_X, BASE_Y))
        x, y = pt
        out.append(((y + x) % P, (y - x) % P, 2 * D * x * y % P))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _base_niels_table() -> np.ndarray:
    """(WIN, 3, NL) int32: the niels table in f25519 limbs."""
    out = np.zeros((WIN, 3, NL), np.int32)
    for d, coords in enumerate(_base_niels_ints()):
        for c, v in enumerate(coords):
            out[d, c] = F.int_to_limbs(v)
    return out


# ---------------- the plain PyTorch kernel ----------------

def _select_rows(tab: torch.Tensor, digit: torch.Tensor) -> torch.Tensor:
    """tab (WIN, NL, B), digit (B,) in 0..15 -> (NL, B): entry digit[b]
    of lane b."""
    idx = digit.long().reshape(1, 1, -1).expand(1, NL, -1)
    return torch.gather(tab, 0, idx).squeeze(0)


def _build_a_table(na: Point) -> Point:
    """16-entry table [0·(-A) .. 15·(-A)] in extended coords, stacked on
    a leading axis: coords (WIN, NL, B)."""
    rows = [identity(na.x.shape[1], na.x.device)]
    for _ in range(WIN - 1):
        rows.append(point_add(rows[-1], na))
    return Point(*(torch.stack([getattr(r, c) for r in rows])
                   for c in Point._fields))


def decompress(y_limbs: torch.Tensor, sign: torch.Tensor
               ) -> Tuple[Point, torch.Tensor]:
    """Point decompression: x = sqrt((y^2-1)/(d y^2+1)) via the (p-5)/8
    exponent trick. Returns (point, valid_mask)."""
    batch = y_limbs.shape[1:]
    dev = y_limbs.device
    y = y_limbs
    one = F.one(batch, dev)
    y2 = F.sqr(y)
    u = y2 - one
    v = F.mul(y2, F.const(D, batch, dev)) + one
    v3 = F.mul(F.sqr(v), v)
    v7 = F.mul(F.sqr(v3), v)
    w = F.pow_p58(F.mul(u, v7))
    x = F.mul(F.mul(u, v3), w)
    vx2 = F.mul(v, F.sqr(x))
    c1 = F.eq(vx2, u)
    c2 = F.eq(vx2, -u)
    valid = c1 | c2
    x = F.select(c2, F.mul(x, F.const(SQRT_M1, batch, dev)), x)
    # parity fix: canonical x, flip sign if needed; x==0 with sign=1 invalid
    x_raw = F.canonical(x)
    parity = (x_raw[0] & 1).bool()
    x_is_zero = torch.all(x_raw == 0, dim=0)
    sign_b = sign.bool()
    x = F.select(parity != sign_b, -x, x)
    valid = valid & ~(x_is_zero & sign_b)
    return Point(x, y, one, F.mul(x, y)), valid


def double_scalar_mul(s_win: torch.Tensor, h_win: torch.Tensor,
                      a_point: Point) -> Point:
    """[s]B + [h]A', where A' is `a_point` (callers pass -A): 4-bit
    windowed ladder with shared doublings, msb-first. s_win/h_win:
    (WINDOWS, B) int32 nibbles in little-endian window order."""
    batch = s_win.shape[1]
    dev = s_win.device
    atab = _build_a_table(a_point)
    btab = torch.as_tensor(_base_niels_table(), device=dev)   # (WIN,3,NL)
    bcoords = [btab[:, c, :].unsqueeze(2).expand(WIN, NL, batch)
               for c in range(3)]
    acc = identity(batch, dev)
    for w in range(WINDOWS - 1, -1, -1):     # most significant first
        acc = point_dbl(point_dbl(point_dbl(point_dbl(acc))))
        ypx, ymx, t2d = (_select_rows(tab, s_win[w]) for tab in bcoords)
        acc = point_mixed_add(acc, ypx, ymx, t2d)
        acc = point_add(acc, Point(*(_select_rows(tab, h_win[w])
                                     for tab in atab)))
    return acc


def compress_eq(p: Point, r_y: torch.Tensor, r_sign: torch.Tensor
                ) -> torch.Tensor:
    """encode(P) == (r_y, r_sign) without materializing bytes: compare
    canonical affine y limbs and the x parity bit."""
    zi = F.inv(p.z)
    x_aff = F.canonical(F.mul(p.x, zi))
    y_aff = F.canonical(F.mul(p.y, zi))
    parity = (x_aff[0] & 1).bool()
    y_equal = torch.all(y_aff == r_y, dim=0)
    return y_equal & (parity == r_sign.bool())


def plain_verify_kernel(s_win, h_win, a_y, a_sign, r_y, r_sign
                        ) -> torch.Tensor:
    """The plain PyTorch batch verifier. Shapes: s_win,h_win (64,B) int32
    nibble windows; a_y,r_y (NL,B) int32 canonical limbs;
    a_sign,r_sign (B,). Returns (B,) bool."""
    a_pt, a_valid = decompress(a_y, a_sign)
    q = double_scalar_mul(s_win, h_win, point_neg(a_pt))
    return a_valid & compress_eq(q, r_y, r_sign)


def verify_kernel(s_win, h_win, a_y, a_sign, r_y, r_sign) -> torch.Tensor:
    """Route by device: CUDA tensors launch the Hopper kernel (which
    raises if it cannot), CPU tensors run the plain version. Nothing
    else is accepted."""
    dev = s_win.device
    if dev.type == "cuda":
        from tpubft_torch.ops import ed25519_cuda
        return ed25519_cuda.verify(s_win, h_win, a_y, a_sign, r_y, r_sign)
    if dev.type == "cpu":
        return plain_verify_kernel(s_win, h_win, a_y, a_sign, r_y, r_sign)
    raise ValueError(f"ed25519 verify_kernel: no kernel for device {dev}")


# ---------------- host-side preparation (vectorized) ----------------

class PreparedBatch(NamedTuple):
    s_win: np.ndarray
    h_win: np.ndarray
    a_y: np.ndarray
    a_sign: np.ndarray
    r_y: np.ndarray
    r_sign: np.ndarray
    host_valid: np.ndarray     # False where host-side canonicality failed


def _lex_lt(rows_le: np.ndarray, bound: int) -> np.ndarray:
    """Vectorized rows (B, 32) little-endian < bound (256-bit)."""
    b_be = np.frombuffer(bound.to_bytes(32, "big"), np.uint8)
    r_be = rows_le[:, ::-1]
    diff = r_be != b_be[None, :]
    has = diff.any(axis=1)
    first = diff.argmax(axis=1)
    rows_first = r_be[np.arange(len(r_be)), first]
    return np.where(has, rows_first < b_be[first], False)


def _windows_le(rows_le: np.ndarray) -> np.ndarray:
    """(B, 32) little-endian byte rows -> (WINDOWS, B) 4-bit windows in
    little-endian window order."""
    bits = np.unpackbits(rows_le, axis=1, bitorder="little")   # (B, 256)
    nib = bits.reshape(bits.shape[0], WINDOWS, 4).astype(np.int32)
    vals = nib @ np.array([1, 2, 4, 8], np.int32)
    return np.ascontiguousarray(vals.T)


def prepare_batch(items: Sequence[Tuple[bytes, bytes, bytes]]
                  ) -> PreparedBatch:
    """items: (message, signature64, public_key32) triples → host arrays.

    Performs the host half of verification: SHA-512 challenge, s < L
    check, canonical y < p checks. Everything but the hash loop is
    vectorized numpy."""
    n = len(items)
    sig_raw = np.zeros((n, 64), np.uint8)
    pk_raw = np.zeros((n, 32), np.uint8)
    shaped = np.zeros(n, bool)
    h_raw = np.zeros((n, 32), np.uint8)
    for i, (msg, sig, pk) in enumerate(items):
        if len(sig) != 64 or len(pk) != 32:
            continue
        shaped[i] = True
        sig_raw[i] = np.frombuffer(sig, np.uint8)
        pk_raw[i] = np.frombuffer(pk, np.uint8)
        h = int.from_bytes(
            hashlib.sha512(sig[:32] + pk + msg).digest(), "little") % L
        h_raw[i] = np.frombuffer(h.to_bytes(32, "little"), np.uint8)
    r_bytes = sig_raw[:, :32].copy()
    s_bytes = sig_raw[:, 32:].copy()
    a_sign = (pk_raw[:, 31] >> 7).astype(np.int32)
    r_sign = (r_bytes[:, 31] >> 7).astype(np.int32)
    a_masked = pk_raw.copy()
    a_masked[:, 31] &= 0x7F
    r_masked = r_bytes.copy()
    r_masked[:, 31] &= 0x7F
    host_valid = (shaped
                  & _lex_lt(s_bytes, L)          # malleability: s < L
                  & _lex_lt(a_masked, P)         # canonical encodings
                  & _lex_lt(r_masked, P))
    # zero out invalid rows so the kernel runs on benign values
    keep = host_valid[:, None]
    return PreparedBatch(
        s_win=_windows_le(np.where(keep, s_bytes, 0)),
        h_win=_windows_le(np.where(keep, h_raw, 0)),
        a_y=F.bytes_le_to_limbs(np.where(keep, a_masked, 0)),
        a_sign=np.where(host_valid, a_sign, 0),
        r_y=F.bytes_le_to_limbs(np.where(keep, r_masked, 0)),
        r_sign=np.where(host_valid, r_sign, 0),
        host_valid=host_valid)


# the reference pads the batch to one of these sizes so jit caches a few
# programs; the port keeps them for the plain path's shapes (equal to
# the reference's, which the tests rely on) — the CUDA kernel takes any B
_SIZE_CLASSES = (64, 256, 1024, 4096, 8192, 16384, 32768)


def _pad_to_class(n: int) -> int:
    for s in _SIZE_CLASSES:
        if n <= s:
            return s
    return ((n + _SIZE_CLASSES[-1] - 1)
            // _SIZE_CLASSES[-1]) * _SIZE_CLASSES[-1]


def _pad_rows(prep: PreparedBatch, n: int, m: int):
    """Zero-pad the prepared arrays from n to m lanes (padding lanes
    carry benign values and are masked out by host_valid)."""
    def pad(a, axis):
        if m == n:
            return a
        width = [(0, 0)] * a.ndim
        width[axis] = (0, m - n)
        return np.pad(a, width)

    return (pad(prep.s_win, 1), pad(prep.h_win, 1), pad(prep.a_y, 1),
            pad(prep.a_sign, 0), pad(prep.r_y, 1), pad(prep.r_sign, 0))


def to_tensors(arrays, device) -> Tuple[torch.Tensor, ...]:
    """(s_win, h_win, a_y, a_sign, r_y, r_sign) numpy arrays -> contiguous
    int32 tensors on `device`, the kernel's input layout."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32))
                 .to(device) for a in arrays)


def _run_kernel(prep: PreparedBatch, n: int, m: int, launch,
                shards: int = 1) -> np.ndarray:
    """launch(arrays) over the batch padded to m lanes -> its verdicts,
    read back inside the device section."""
    from tpubft_torch.ops.dispatch import device_section
    with device_section("ed25519", batch=n, shards=shards):
        out = launch(_pad_rows(prep, n, m))
        if out.shape[0] < n:
            # a garbage device result must classify as a device failure
            # (breaker), never silently truncate into false verdicts
            raise RuntimeError(
                f"ed25519 kernel returned {out.shape[0]} verdicts "
                f"for a batch of {n}")
        return out[:n] & prep.host_valid


def _single_device_verify(prep: PreparedBatch, n: int,
                          dev: torch.device) -> np.ndarray:
    """One launch on `dev`. The CUDA kernel masks its own ragged edge;
    the plain version runs at the reference's padded size class."""
    m = n if dev.type == "cuda" else _pad_to_class(n)
    return _run_kernel(
        prep, n, m,
        lambda arrays: verify_kernel(*to_tensors(arrays, dev)).cpu().numpy())


def _mesh_verify(plan, prep: PreparedBatch, n: int) -> np.ndarray:
    """One launch under a MeshPlan (reference ed25519.py:419-437): the
    batch axis sharded over the plan's slots, pow2 rows a shard with a
    floor of 8. A plan that eviction shrank to one slot takes the
    single-device route on that slot's device."""
    if plan.mesh is None:
        return _single_device_verify(prep, n, plan.devices[0].device)
    from tpubft_torch.parallel import sharding
    rows = max(sharding.shard_rows(n, plan.n), 8)
    kernel = sharding.mesh_manager().cached_kernel(
        "ed25519", plan, sharding.sharded_verify_ed25519)
    return _run_kernel(prep, n, rows * plan.n, lambda a: kernel(*a),
                       shards=plan.n)


def verify_batch(items: Sequence[Tuple[bytes, bytes, bytes]],
                 device: Optional[torch.device] = None) -> np.ndarray:
    """End-to-end batched verify: (msg, sig, pk) triples → bool array.
    Runs on `device`; without one, on the mesh's slots when the plan has
    more than one and the batch reaches the gate, else on the default
    device (the card unless the CPU was asked for). Per-lane verdicts
    are the same on every route."""
    if not items:
        return np.zeros(0, bool)
    n = len(items)
    prep = prepare_batch(list(items))
    # Port divergence: the reference has no `device` argument; an
    # explicit device pins the single-device route
    if device is None:
        from tpubft_torch.ops import dispatch
        plan = dispatch.mesh_plan()
        # mesh gate (reference :456-464): >= 8 rows a shard before the
        # fan-out pays; below it a sharded launch is mostly padding
        if plan.mesh is not None and n >= 8 * plan.n:
            return dispatch.mesh_launch(
                "ed25519", lambda p: _mesh_verify(p, prep, n))
    return _single_device_verify(prep, n, _device.resolve(device))
