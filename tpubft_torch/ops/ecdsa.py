"""Batched ECDSA verification (secp256k1 / P-256) on the card (port of
tpubft/ops/ecdsa.py).

Two device shapes, as in the reference:

  * `verify_batch` — per-item Shamir ladders R' = [u1]G + [u2]Q with a
    per-item affine x-compare (one verdict a item, one launch);
  * `rlc_verify_batch` — the random-linear-combination batch check: ONE
    launch folds every item's verify equation into a single aggregate
    residual, checked against zero; an aggregate failure bisects, so a
    forged signature fails only itself while its siblings verify.

The RLC form (the reference's docstring, ecdsa.py:17-35): with
T_i = [u1]G + [u2]Q = (X_i : Y_i : Z_i),

    rho_i = (X_i - r_i Z_i) (X_i - (r_i + n) Z_i)      (in F_p)
    check:  sum_i a_i rho_i == 0                        (in F_p)

(the reference's projective form; the port's kernel and plain version
take Jacobian T_i, x = X / Z^2, and Z_i^2 in place of Z_i)

rho_i is 0 exactly when x(T_i) is r_i or r_i + n (the wrap case, only
where r_i + n < p; elsewhere the second factor is 1), an identity T_i
gets rho_i = 1, and the a_i are 128-bit Fiat-Shamir draws bound to the
whole batch (`_rlc_coeffs`, the reference's bytes), so a forged item
survives the aggregate with probability about 2^-128 and never survives
bisection: a singleton launch checks a_i rho_i == 0 with invertible a_i.

Split of labor:
  host   — the shared admission (crypto/scalar.ecdsa_precheck_batch:
           shapes, 0 < r, s < n, the memoized on-curve pubkey decode,
           one batch inversion for every s^-1), u1 and u2, the
           coefficients, the bisection;
  device — the ladder (secp256k1's GLV split of u2 included), the
           residuals and the fold (ops/csrc/ecdsa.cu's `ecdsa_rlc`,
           through ops/ecdsa_cuda.py), or the ladder, an inversion and
           the compare (`ecdsa_verify`). CPU
           tensors take the plain versions here, `rlc_fold_plain` and
           `verify_plain`, written on ops/field.py and ops/weierstrass.py.

The kernel's inputs are its own layout: each scalar and each
coordinate as eight little-endian 32-bit words (8, B) of its canonical
integer, not Montgomery limbs. The kernels keep canonical integers and
the plain versions their field's Montgomery form (R = 2^384); the fold's
value out is a canonical integer, the same in both. The fold's value
depends on the Jacobian representation of each T_i (rho_i scales with
Z_i^2), so `rlc_fold_plain` runs the kernel's own schedule (`_ladder`:
G's fixed-base windows, Q's signed windows with secp256k1's GLV halves,
Curve.fixed_base_sum / window_sum / jac_add, the kernel's formulas and
exceptional cases) and the card holds the value word for word against
it; against the reference only the verdicts are compared. The residual
in Jacobian coordinates is X - r Z^2.

Port divergences, each also marked where it sits:
  * scalars go in as (8, B) words, not the reference's (256, B) bit
    matrices (`_bits_msb`, ecdsa.py:98): the host packs 32 times less;
  * no power-of-two padding on the single-device route (ecdsa.py:316-319):
    the kernel takes any B, and the `active` mask only marks host-invalid
    lanes; the mesh route pads to pow2 rows a slot as the reference does;
  * an explicit `device=` pins the single-device route (the reference
    has no `device` argument).

The mesh route (`_rlc_mesh_round`, ecdsa.py:330-378, 414-421): without a
device, a group of at least `_MESH_MIN_ROWS` live items a slot folds on
every slot of the plan at once (parallel/sharding.sharded_rlc_kernel:
each slot its own columns, with the whole batch's coefficients), one
verdict a shard; a failing shard is bisected alone.
"""
from __future__ import annotations

import functools
import hashlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from tpubft_torch import device as _device
from tpubft_torch.crypto import scalar as _scalar
from tpubft_torch.ops.field import from_words, get_field, to_words
from tpubft_torch.ops.weierstrass import Curve, WPoint

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

WORDS = 8            # 32-bit words of a scalar or a coordinate

# Per-curve counts of the RLC path: aggregate launches, bisection
# launches (every launch after a group's first) and lanes launched, on
# the CPU and the card alike (the wrapper's LAUNCHES count the card's).
COUNTS: Dict[str, Dict[str, int]] = {
    c: {"rlc_launches": 0, "bisection_launches": 0, "lanes": 0}
    for c in CURVES}


def reset_counts() -> None:
    for c in COUNTS.values():
        for k in c:
            c[k] = 0


@functools.lru_cache(maxsize=None)
def get_curve(name: str) -> Curve:
    c = CURVES[name]
    return Curve(get_field(c["p"]), c["a"], c["b"])


class PreparedEcdsaBatch(NamedTuple):
    u1: np.ndarray            # (8, B) uint32 words
    u2: np.ndarray
    qx: np.ndarray            # (8, B) affine x, canonical (not Montgomery)
    qy: np.ndarray
    r: np.ndarray             # (8, B) r
    r_plus_n: np.ndarray      # (8, B) r+n, or p (never an affine x)
    host_valid: np.ndarray    # (B,) bool


class PreparedRlcBatch(NamedTuple):
    u1: np.ndarray            # (8, B) uint32 words
    u2: np.ndarray
    qx: np.ndarray            # (8, B) affine x, canonical
    qy: np.ndarray
    xr: np.ndarray            # (8, B) r as a field element
    xrpn: np.ndarray          # (8, B) r+n where wrap_ok, else 0
    wrap_ok: np.ndarray       # (B,) bool: r+n < p, the wrap candidate exists
    a: np.ndarray             # (8, B) Fiat-Shamir RLC coefficients
    host_valid: np.ndarray    # (B,) bool


def words_of(values: Sequence[int]) -> np.ndarray:
    """(8, B) uint32: each integer (< 2^256) as little-endian 32-bit words.
    Replaces the reference's per-item `_bits_msb` (ecdsa.py:98)."""
    b = len(values)
    buf = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(buf, dtype="<u4").reshape(b, WORDS).T.astype(
        np.uint32)


def int_of(words) -> int:
    """(8,) words -> the integer (host)."""
    v = 0
    for w in reversed(np.asarray(words).astype(np.int64).tolist()):
        v = (v << 32) | (w & 0xFFFFFFFF)
    return v


class _Checked(NamedTuple):
    """Host prechecks shared by both kernel shapes."""
    u1: List[int]
    u2: List[int]
    r: List[int]
    q: List[Optional[Tuple[int, int]]]
    valid: np.ndarray


def _precheck(curve_name: str,
              items: Sequence[Tuple[bytes, bytes, bytes]]) -> _Checked:
    """Adapter over crypto/scalar.ecdsa_precheck_batch — ONE shared
    admission implementation (shape, 0 < r,s < n, memoized on-curve
    pubkey decode, batch-inverted s^-1) so kernel and host verdicts
    cannot drift on what they admit. This module's item order is
    (msg, sig, pk); the scalar engine's is (pk, msg, sig)."""
    B = len(items)
    chk = _scalar.ecdsa_precheck_batch(
        [(pk, msg, sig) for msg, sig, pk in items], curve_name)
    u1 = [0] * B
    u2 = [0] * B
    valid = np.zeros(B, bool)
    qs: List[Optional[Tuple[int, int]]] = [None] * B
    for i in chk.live:
        u1[i] = chk.u1[i]
        u2[i] = chk.u2[i]
        qs[i] = chk.entries[i].pt
        valid[i] = True
    return _Checked(u1, u2, chk.r, qs, valid)


def prepare_batch(curve_name: str,
                  items: Sequence[Tuple[bytes, bytes, bytes]]
                  ) -> PreparedEcdsaBatch:
    """items: (message, raw_sig r||s 64B, pubkey SEC1-uncompressed 65B).
    Host-invalid items go in as zeros (u1 = u2 = 0: the identity, a
    reject) and are masked by host_valid."""
    c = CURVES[curve_name]
    p, n = c["p"], c["n"]
    chk = _precheck(curve_name, items)
    qs = [q if q is not None else (0, 0) for q in chk.q]
    r = [chk.r[i] if v else 0 for i, v in enumerate(chk.valid)]
    # ECDSA accepts x(R') = r + n when r + n < p (the wrap case); p is
    # never an affine x, so it matches nothing
    rpn = [x + n if x + n < p else p for x in r]
    return PreparedEcdsaBatch(
        words_of(chk.u1), words_of(chk.u2), words_of([q[0] for q in qs]),
        words_of([q[1] for q in qs]), words_of(r), words_of(rpn),
        chk.valid)


def _rlc_coeffs(items: Sequence[Tuple[bytes, bytes, bytes]]) -> List[int]:
    """128-bit Fiat-Shamir coefficients bound to the FULL batch
    transcript (message digests, signatures, pubkeys): the adversary
    commits to every item before learning any coefficient, so
    engineering residuals that cancel inside the aggregate (or inside
    any bisection subtree, which reuses these coefficients) means
    inverting the hash. Odd => nonzero => invertible mod p."""
    h = hashlib.sha256(b"ecdsa-rlc")
    for msg, sig, pk in items:
        h.update(hashlib.sha256(msg).digest())
        h.update(bytes(sig))
        h.update(bytes(pk))
    ctx = h.digest()
    out = []
    for i in range(len(items)):
        hi = hashlib.sha256(ctx + i.to_bytes(4, "big"))
        out.append(int.from_bytes(hi.digest()[:16], "big") | 1)
    return out


def prepare_rlc_batch(curve_name: str,
                      items: Sequence[Tuple[bytes, bytes, bytes]]
                      ) -> PreparedRlcBatch:
    c = CURVES[curve_name]
    p, n = c["p"], c["n"]
    chk = _precheck(curve_name, items)
    coeffs = _rlc_coeffs(items)
    valid = chk.valid
    qs = [q if q is not None else (0, 0) for q in chk.q]
    r = [chk.r[i] if v else 0 for i, v in enumerate(valid)]
    wrap_ok = np.array([bool(v) and x + n < p for v, x in zip(valid, r)],
                       dtype=bool)
    return PreparedRlcBatch(
        words_of(chk.u1), words_of(chk.u2), words_of([q[0] for q in qs]),
        words_of([q[1] for q in qs]), words_of(r),
        words_of([x + n if w else 0 for x, w in zip(r, wrap_ok)]), wrap_ok,
        words_of([a if v else 0 for a, v in zip(coeffs, valid)]), valid)


_TORCH_DTYPES = {np.dtype(np.int32): torch.int32,
                 np.dtype(np.bool_): torch.bool}


def to_tensors(arrays: Sequence[np.ndarray], dev: torch.device
               ) -> Tuple[torch.Tensor, ...]:
    """Host kernel inputs -> contiguous tensors on `dev`: the (8, B)
    uint32 words as int32 (the same bits), the (B,) masks as bool.

    On a card the arrays cross in one copy: packed into one pinned host
    buffer (each part at a 16-byte offset), copied once, and returned as
    views of the device copy. One pageable copy an array made a launch
    nine synchronous copies, and with four replica processes on one card
    each copy waited on the others' work (PERF.md §6, PR 17)."""
    parts = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        parts.append(a)
    if dev.type != "cuda":
        return tuple(torch.from_numpy(a).to(dev) for a in parts)
    offsets, total = [], 0
    for a in parts:
        offsets.append(total)
        total += -(-a.nbytes // 16) * 16
    host = torch.empty(max(total, 16), dtype=torch.uint8, pin_memory=True)
    flat = host.numpy()
    for a, off in zip(parts, offsets):
        flat[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = host.to(dev, non_blocking=True)
    return tuple(buf[off:off + a.nbytes].view(_TORCH_DTYPES[a.dtype])
                 .view(a.shape) for a, off in zip(parts, offsets))


# ---------------- plain versions ----------------

def _limbs(words: torch.Tensor) -> torch.Tensor:
    """(8, ...) int32 words -> (24, ...) 16-bit limbs of the integer."""
    w = words.long() & 0xFFFFFFFF
    return from_words(torch.cat([w, w.new_zeros((4,) + tuple(w.shape[1:]))]))


def _mont(cv: Curve, words: torch.Tensor) -> torch.Tensor:
    return cv.f.to_mont(_limbs(words))


def _i32(w: torch.Tensor) -> torch.Tensor:
    """Words held in int64 (each in [0, 2^32)) -> int32 of the same bits."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


# csrc/ecdsa.cu's schedule: [u1]G in G_DIGITS signed windows of G_WINDOW
# bits over G's fixed-base table, [u2]Q in signed windows of Q_WINDOW
# bits (Q_DIGITS of them: a GLV half on secp256k1, u2 on P-256) over
# 1Q .. 2^(Q_WINDOW-1) Q
G_WINDOW, G_DIGITS = 8, 33
Q_WINDOW = 5
Q_DIGITS = {"secp256k1": 26, "secp256r1": 52}


def signed_digits(k: int, width: int, count: int) -> List[int]:
    """k as `count` digits in [-2^(width-1), 2^(width-1)), least
    significant first: window j of k + sum_j 2^(width-1) 2^(width j),
    less 2^(width-1) (k must be below 2^(width count - 1))."""
    half = 1 << (width - 1)
    off = sum(half << (width * j) for j in range(count))
    kp = k + off
    if kp >> (width * count):
        raise ValueError("scalar too large for its windows")
    mask = (1 << width) - 1
    return [((kp >> (width * j)) & mask) - half for j in range(count)]


@functools.lru_cache(maxsize=None)
def fixed_base_table(curve_name: str) -> Tuple[Tuple[Tuple[int, int], ...],
                                               ...]:
    """G's multiples d 2^(G_WINDOW j) G for windows j < G_DIGITS and
    d = 1 .. 2^(G_WINDOW-1), affine, from the curve's parameters (the
    kernel's table, ops/ecdsa_cuda.g_table_words)."""
    c = CURVES[curve_name]
    p, a = c["p"], c["a"]
    rows, base = [], (c["gx"], c["gy"], 1)
    for _ in range(G_DIGITS):
        row = [base]
        for _ in range(1, 1 << (G_WINDOW - 1)):
            row.append(_scalar._jac_add(row[-1], base, p, a))
        rows.append(row)
        for _ in range(G_WINDOW):
            base = _scalar._jac_double(base, p, a)
    flat = _scalar._jac_batch_to_affine([q for r in rows for q in r], p)
    n = 1 << (G_WINDOW - 1)
    return tuple(tuple(flat[j * n:(j + 1) * n]) for j in range(G_DIGITS))


@functools.lru_cache(maxsize=8)
def _g_limbs(curve_name: str, dev: torch.device
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fixed_base_table as (windows, entries, 24) Montgomery limbs, x
    and y."""
    f = get_curve(curve_name).f
    tab = fixed_base_table(curve_name)
    return tuple(torch.as_tensor(np.array([[f.from_int(pt[k]) for pt in row]
                                           for row in tab]), device=dev)
                 for k in (0, 1))


def _ints(words: torch.Tensor) -> List[int]:
    """(8, B) words -> B Python ints."""
    w = (words.long() & 0xFFFFFFFF).cpu().numpy()
    return [int_of(w[:, i]) for i in range(w.shape[1])]


def _digit_rows(scalars: Sequence[int], width: int, count: int,
                dev: torch.device) -> torch.Tensor:
    return torch.tensor([signed_digits(k, width, count) for k in scalars],
                        dtype=torch.int64, device=dev).T.contiguous()


def _ladder(curve_name: str, u1, u2, qx, qy) -> WPoint:
    """T = [u2]Q + [u1]G, Jacobian, in the kernel's own sequence of
    formulas: its two parts (Curve.window_sum, Curve.fixed_base_sum) and
    the addition that joins them. The digits and secp256k1's GLV split
    (scalar._glv_split, which the kernel's glv_split computes exactly)
    are host integers here."""
    cv = get_curve(curve_name)
    dev = qx.device
    q = cv.from_affine(_mont(cv, qx), _mont(cv, qy))
    k2 = _ints(u2)
    glv = _scalar._GLV_PARAMS.get(curve_name)
    nq = Q_DIGITS[curve_name]
    if glv is not None:
        n = CURVES[curve_name]["n"]
        halves = [_scalar._glv_split(k, glv, n) for k in k2]
        digits = [_digit_rows([h[i] for h in halves], Q_WINDOW, nq, dev)
                  for i in (0, 2)]
        negs = [torch.tensor([h[i] for h in halves], dtype=torch.bool,
                             device=dev) for i in (1, 3)]
        qpart = cv.window_sum(q, digits, negs, Q_WINDOW, glv["beta"])
    else:
        qpart = cv.window_sum(q, [_digit_rows(k2, Q_WINDOW, nq, dev)],
                              [torch.zeros(len(k2), dtype=torch.bool,
                                           device=dev)], Q_WINDOW)
    gx, gy = _g_limbs(curve_name, dev)
    gpart = cv.fixed_base_sum(gx, gy, _digit_rows(_ints(u1), G_WINDOW,
                                                  G_DIGITS, dev))
    return cv.jac_add(qpart, gpart)


def rlc_fold_plain(curve_name: str, u1: torch.Tensor, u2: torch.Tensor,
                   qx: torch.Tensor, qy: torch.Tensor, xr: torch.Tensor,
                   xrpn: torch.Tensor, wrap_ok: torch.Tensor,
                   active: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The RLC kernel's function in plain PyTorch (reference
    rlc_fold_body, ecdsa.py:267-300): (8, B) words and (B,) masks -> the
    fold sum_i a_i rho_i as a canonical integer in eight int32 words (8,).
    The batch passes when it is 0."""
    cv = get_curve(curve_name)
    f = cv.f
    batch, dev = tuple(qx.shape[1:]), qx.device
    t = _ladder(curve_name, u1, u2, qx, qy)
    one = f.one(batch, dev)
    zz = f.mul(t.z, t.z)
    # Jacobian x-residuals: zero iff x(T) == r (resp. r+n)
    d1 = f.sub(t.x, f.mul(_mont(cv, xr), zz))
    d2 = f.select(wrap_ok, f.sub(t.x, f.mul(_mont(cv, xrpn), zz)), one)
    rho = f.mul(d1, d2)
    # the identity (Z=0) would make d1 vanish spuriously where X == 0,
    # and the identity is a reject — pin rho nonzero
    rho = f.select(f.is_zero(t.z), one, rho)
    # host-invalid lanes must not poison the aggregate
    rho = f.select(active, rho, f.zero(batch, dev))
    w = f.mul(_mont(cv, a), rho)
    # the sum of loose limbs is exact in int64; canonical reduces it
    total = f.canonical(w.sum(-1, keepdim=True))
    return _i32(to_words(f.from_mont(total))[:WORDS, 0])


def verify_plain(curve_name: str, u1: torch.Tensor, u2: torch.Tensor,
                 qx: torch.Tensor, qy: torch.Tensor, r: torch.Tensor,
                 r_plus_n: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-item verify kernel's function in plain PyTorch (reference
    make_verify_kernel.kernel, ecdsa.py:169-184): (8, B) words ->
    (verdicts (B,) bool, affine x = X / Z^2 of T as (8, B) int32 words;
    0 for the identity, whose inverse of Z is 0)."""
    cv = get_curve(curve_name)
    f = cv.f
    t = _ladder(curve_name, u1, u2, qx, qy)
    zi = f.inv(t.z)
    x = f.from_mont(f.mul(t.x, f.mul(zi, zi)))
    is_id = f.is_zero(t.z)
    xw = _i32(to_words(x)[:WORDS])
    match = (xw == r).all(0) | (xw == r_plus_n).all(0)
    return match & ~is_id, xw


def rlc_fold_kernel(curve_name: str, *args) -> torch.Tensor:
    """CUDA tensors launch the kernel (ops/ecdsa_cuda.rlc), CPU tensors
    take the plain version."""
    if args[0].device.type == "cuda":
        from tpubft_torch.ops import ecdsa_cuda
        return ecdsa_cuda.rlc(curve_name, *args)
    return rlc_fold_plain(curve_name, *args)


def verify_kernel(curve_name: str, *args
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CUDA tensors launch the kernel (ops/ecdsa_cuda.verify), CPU
    tensors take the plain version."""
    if args[0].device.type == "cuda":
        from tpubft_torch.ops import ecdsa_cuda
        return ecdsa_cuda.verify(curve_name, *args)
    return verify_plain(curve_name, *args)


# ---------------- host-facing entry points ----------------

def verify_batch(curve_name: str,
                 items: Sequence[Tuple[bytes, bytes, bytes]],
                 device: Optional[torch.device] = None) -> np.ndarray:
    """Per-item verdicts, one launch of the verify kernel."""
    if not items:
        return np.zeros(0, bool)
    prep = prepare_batch(curve_name, items)
    dev = _device.resolve(device)
    from tpubft_torch.ops.dispatch import device_section
    with device_section("ecdsa", batch=len(items)):
        ok, _ = verify_kernel(curve_name, *to_tensors(prep[:6], dev))
        out = ok.cpu().numpy()
        if out.shape[0] < len(items):
            raise RuntimeError(
                f"ecdsa kernel returned {out.shape[0]} verdicts "
                f"for a batch of {len(items)}")
        return out & prep.host_valid


def rlc_columns(prep: PreparedRlcBatch, idxs: Sequence[int]
                ) -> Tuple[np.ndarray, ...]:
    """The RLC kernel's inputs for a subset of prepared columns, in its
    argument order (u1, u2, qx, qy, xr, xrpn, wrap_ok, active, a)."""
    sel = list(idxs)
    return (prep.u1[:, sel], prep.u2[:, sel], prep.qx[:, sel],
            prep.qy[:, sel], prep.xr[:, sel], prep.xrpn[:, sel],
            prep.wrap_ok[sel], prep.host_valid[sel], prep.a[:, sel])


# the RLC aggregate rides the mesh only past this per-shard lane count
# (reference :325-328)
_MESH_MIN_ROWS = 32


def _rlc_mesh_round(plan, curve_name: str, prep: PreparedRlcBatch,
                    idxs: Sequence[int]) -> List[List[int]]:
    """One sharded aggregate round (reference :330-378) -> the index
    subsets, one a failing shard, that still need bisection; empty when
    every shard's fold was zero. The columns are padded to pow2 rows a
    slot with inactive lanes. A plan that eviction shrank to one slot
    takes one aggregate launch on that slot's device."""
    if plan.mesh is None:
        ok = _rlc_launch(curve_name, prep, idxs, plan.devices[0].device)
        return [] if ok else [list(idxs)]
    from tpubft_torch.ops.dispatch import device_section
    from tpubft_torch.parallel import sharding
    d = plan.n
    rows = sharding.shard_rows(len(idxs), d)
    m = rows * d
    sel = list(idxs) + [idxs[0]] * (m - len(idxs))
    active = np.zeros(m, bool)
    active[:len(idxs)] = prep.host_valid[list(idxs)]
    cols = rlc_columns(prep, sel)
    cols = cols[:7] + (active,) + cols[8:]
    counts = COUNTS[curve_name]
    counts["rlc_launches"] += d
    counts["lanes"] += m
    kern = sharding.mesh_manager().cached_kernel(
        f"ecdsa_rlc.{curve_name}", plan,
        lambda mesh: sharding.sharded_rlc_kernel(curve_name, mesh))
    with device_section("ecdsa", batch=len(idxs), shards=d):
        ok = kern(*cols)
        if ok.shape[0] < d:
            raise RuntimeError(
                f"sharded rlc fold returned {ok.shape[0]} shard "
                f"verdicts for a plan of {d}")
    failing = []
    for j in range(d):
        if not ok[j]:
            sub = [idxs[k] for k in range(j * rows,
                                          min((j + 1) * rows, len(idxs)))]
            if sub:
                failing.append(sub)
    return failing


def _rlc_launch(curve_name: str, prep: PreparedRlcBatch,
                idxs: Sequence[int], dev: torch.device,
                bisection: bool = False) -> bool:
    """One aggregate launch over a subset of prepared columns; reads the
    sum back (one synchronisation a launch). No padding: the kernel
    takes any width (the reference pads to a power of two, :316-319)."""
    counts = COUNTS[curve_name]
    counts["rlc_launches"] += 1
    counts["bisection_launches"] += int(bisection)
    counts["lanes"] += len(idxs)
    from tpubft_torch.ops.dispatch import device_section
    with device_section("ecdsa", batch=len(idxs)):
        out = rlc_fold_kernel(curve_name,
                              *to_tensors(rlc_columns(prep, idxs), dev))
        return not bool(out.cpu().any())


def rlc_verify_batch(curve_name: str,
                     items: Sequence[Tuple[bytes, bytes, bytes]],
                     device: Optional[torch.device] = None) -> np.ndarray:
    """RLC batch verification: ONE launch checks the whole flush; on
    aggregate failure, binary bisection re-launches halves (b forged
    items cost O(b log B) launches, reference ecdsa.py:381-423) so only
    guilty items fail. Verdicts are identical to `verify_batch` / the
    scalar engine's."""
    if not items:
        return np.zeros(0, bool)
    prep = prepare_rlc_batch(curve_name, items)
    out = prep.host_valid.copy()
    dev = _device.resolve(device)
    first = [True]

    def descend(idxs: List[int]) -> None:
        live = [i for i in idxs if prep.host_valid[i]]
        if not live:
            return
        ok = _rlc_launch(curve_name, prep, live, dev,
                         bisection=not first[0])
        first[0] = False
        if ok:
            return
        if len(live) == 1:
            # singleton aggregate = a * rho with invertible a: exact
            out[live[0]] = False
            return
        mid = len(live) // 2
        descend(live[:mid])
        descend(live[mid:])

    live = [i for i in range(len(items)) if prep.host_valid[i]]
    # Port divergence: the reference has no `device` argument; an
    # explicit device pins the single-device route
    if device is None and live:
        from tpubft_torch.ops import dispatch
        plan = dispatch.mesh_plan()
        if plan.mesh is not None and len(live) >= _MESH_MIN_ROWS * plan.n:
            failing = dispatch.mesh_launch(
                "ecdsa",
                lambda p: _rlc_mesh_round(p, curve_name, prep, live))
            # bisection inside a failing shard, on the first healthy slot
            first[0] = False
            dev = dispatch.mesh_plan().devices[0].device
            for sub in failing:
                descend(sub)
            return out
    descend(live)
    return out
