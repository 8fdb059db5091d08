"""BLS12-381 G1: batched scalar-mul and Lagrange-weighted MSM (port of
tpubft/ops/bls12_381.py).

The device half of threshold-share accumulation (concord-bft's
BlsThresholdAccumulator::computeLagrangeCoeff + exponentiateLagrangeCoeff
-> fastMultExp, threshsign/src/bls/relic/FastMultExp.cpp:27): combine k
signature shares into the threshold signature as sum_i [L_i(0)] S_i.

Split of labor:
  host   — Lagrange coefficients mod r, the kernel inputs (scalar words,
           Montgomery point words, the identity mask), and the affine
           conversion of the projective result;
  device — the MSM: each (segment, point) lane's scalar signed and split
           by GLV into two chains, each a group of four lanes, then a
           tree a segment (ops/csrc/bls12_381_msm.cu, through
           ops/bls12_381_cuda.py; the points must lie in the order-r
           subgroup). CPU tensors take the plain versions here,
           `plain_msm_batch_kernel` and `plain_scalar_mul_kernel`.

The boundary contract is the reference's: scalars are reduced mod r, a
None point or a zero scalar contributes the identity, segments of unequal
width are padded with the identity, and each result is None for the
identity or the canonical affine (x, y) int tuple.

Port divergences, each also marked where it sits:
  * the kernel takes each scalar as eight little-endian 32-bit words
    (`_scalar_words`), not the reference's (255, B) bit matrix, whose
    host loop `_bits_msb_batch` (bls12_381.py:38-43) it replaces;
  * no power-of-two padding of the segment count or width (the
    reference pads for XLA's compile cache, :68-70, :166-167);
  * no mesh tier (`_msm_launch`'s plan, `dispatch.mesh_plan`): ROADMAP
    A.7. `device_section` takes no shard count.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpubft_torch import device as _device
from tpubft_torch.crypto import bls12381 as ref
from tpubft_torch.ops.field import WORDS, from_words, get_field
from tpubft_torch.ops.weierstrass import Curve, WPoint

SCALAR_BITS = 255
SCALAR_WORDS = 8


@functools.lru_cache(maxsize=None)
def g1_curve() -> Curve:
    return Curve(get_field(ref.P), 0, ref.B1)


# ---------------- host half: kernel inputs ----------------

def _scalar_words(scalars: Sequence[int]) -> np.ndarray:
    """(8, B) int64: each scalar (already < 2^256) as little-endian 32-bit
    words. Replaces the reference's per-bit host loop (bls12_381.py:38-43)."""
    raw = b"".join(int(k).to_bytes(32, "little") for k in scalars)
    return np.frombuffer(raw, dtype="<u4").reshape(
        len(scalars), SCALAR_WORDS).T.astype(np.int64)


def _affine_words(pts: Sequence[Tuple[int, int]]) -> Tuple[np.ndarray,
                                                           np.ndarray]:
    """Affine int points -> Montgomery words (12, B) of x and of y."""
    f = g1_curve().f
    out = []
    for coord in (0, 1):
        raw = b"".join((pt[coord] * f.R % ref.P).to_bytes(48, "little")
                       for pt in pts)
        out.append(np.frombuffer(raw, dtype="<u4").reshape(
            len(pts), WORDS).T.astype(np.int64))
    return out[0], out[1]


def _prep_msm(points: Sequence, scalars: Sequence[int],
              m: Optional[int] = None):
    """Pad an n-point MSM to m slots (identity padding; m defaults to n)
    -> (words, px, py, infinity) host arrays. A None point, a padded slot
    or a zero scalar is an identity lane."""
    n = len(points)
    m = n if m is None else m
    points = list(points) + [None] * (m - n)
    ks, pts = [], []
    infinity = np.zeros(m, bool)
    for i, p in enumerate(points):
        k = scalars[i] % ref.R if p is not None else 0
        if p is None or k == 0:
            infinity[i] = True
            ks.append(0)
            pts.append((0, 0))
        else:
            ks.append(k)
            pts.append(p)
    px, py = _affine_words(pts)
    return _scalar_words(ks), px, py, infinity


def prepare_msm_batch(segments: Sequence[Tuple[Sequence, Sequence[int]]]):
    """Segments of (points, scalars) -> (words (8, S, K), px, py
    (12, S, K), infinity (S, K)) host arrays, K the widest segment; the
    narrower ones are padded with identity lanes."""
    s = len(segments)
    kwidth = max(1, max(len(p) for p, _ in segments))
    lanes = [_prep_msm(pts, ks, kwidth) for pts, ks in segments]
    words, px, py, infinity = (np.concatenate([lane[i] for lane in lanes],
                                              axis=-1) for i in range(4))
    return (words.reshape(SCALAR_WORDS, s, kwidth),
            px.reshape(WORDS, s, kwidth), py.reshape(WORDS, s, kwidth),
            infinity.reshape(s, kwidth))


def to_tensors(arrays, dev: torch.device) -> Tuple[torch.Tensor, ...]:
    """Host kernel inputs -> contiguous tensors on `dev` (int64 words, the
    mask as bool)."""
    words, px, py, infinity = arrays
    out = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
           for a in (words, px, py)]
    out.append(torch.from_numpy(np.ascontiguousarray(infinity)).to(dev))
    return tuple(out)


def _to_affine_host(x_words, y_words, z_words):
    """Projective Montgomery words -> affine ints, None for the identity."""
    f = g1_curve().f
    z = f.to_int(z_words)
    if z == 0:
        return None
    zi = pow(z, -1, ref.P)
    return (f.to_int(x_words) * zi % ref.P, f.to_int(y_words) * zi % ref.P)


# ---------------- plain versions ----------------

def _bits(words: torch.Tensor) -> torch.Tensor:
    """(8, ...) scalar words -> (255, ...) bits, msb first."""
    idx = torch.arange(SCALAR_BITS - 1, -1, -1, device=words.device)
    shape = (-1,) + (1,) * (words.dim() - 1)
    return (words[idx // 32] >> (idx % 32).reshape(shape)) & 1


def _plain_ladder(words, px, py, infinity) -> WPoint:
    cv = g1_curve()
    pts = cv.from_affine(from_words(px), from_words(py))
    pts = cv.select(infinity, cv.identity(px.shape[1:], px.device), pts)
    bits = torch.where(infinity.unsqueeze(0), 0, _bits(words))
    return cv.scalar_mul_bits(bits, pts)


def plain_msm_batch_kernel(words: torch.Tensor, px: torch.Tensor,
                           py: torch.Tensor, infinity: torch.Tensor
                           ) -> Tuple[torch.Tensor, ...]:
    """The MSM kernel's function in plain PyTorch: words (8, S, K), px/py
    (12, S, K), infinity (S, K) -> projective (X, Y, Z), each (12, S)
    canonical Montgomery words. Every (segment, point) lane ladders from
    the identity (the reference's msm_batch_kernel, :137-138), then a
    tree reduce along K."""
    cv = g1_curve()
    out = cv.msm_reduce(_plain_ladder(words, px, py, infinity))
    return tuple(cv.f.to_words(c[..., 0]) for c in out)


def plain_scalar_mul_kernel(words: torch.Tensor, px: torch.Tensor,
                            py: torch.Tensor, infinity: torch.Tensor
                            ) -> Tuple[torch.Tensor, ...]:
    """[k_i] P_i with no reduce: words (8, B), px/py (12, B), infinity
    (B,) -> (X, Y, Z), each (12, B) canonical Montgomery words (the
    reference's batch_scalar_mul kernel, :241)."""
    cv = g1_curve()
    return tuple(cv.f.to_words(c)
                 for c in _plain_ladder(words, px, py, infinity))


def msm_batch_kernel(words, px, py, infinity) -> Tuple[torch.Tensor, ...]:
    """CUDA tensors launch the kernel (ops/bls12_381_cuda.msm), CPU
    tensors take the plain version."""
    if words.device.type == "cuda":
        from tpubft_torch.ops import bls12_381_cuda
        return bls12_381_cuda.msm(words, px, py, infinity)
    return plain_msm_batch_kernel(words, px, py, infinity)


def scalar_mul_kernel(words, px, py, infinity) -> Tuple[torch.Tensor, ...]:
    """CUDA tensors launch the kernel (ops/bls12_381_cuda.scalar_mul), CPU
    tensors take the plain version."""
    if words.device.type == "cuda":
        from tpubft_torch.ops import bls12_381_cuda
        return bls12_381_cuda.scalar_mul(words, px, py, infinity)
    return plain_scalar_mul_kernel(words, px, py, infinity)


# ---------------- host-facing entry points ----------------

def _read(t: Tuple[torch.Tensor, ...]) -> List[np.ndarray]:
    return [c.cpu().numpy() for c in t]


def msm_batch(segments: Sequence[Tuple[Sequence, Sequence[int]]],
              device: Optional[torch.device] = None) -> List:
    """Cross-slot fused MSM: each segment is (points, scalars); the whole
    batch is ONE launch. Returns one affine point (or None for the
    identity) per segment."""
    s = len(segments)
    if s == 0:
        return []
    from tpubft_torch.ops.dispatch import device_section
    host = prepare_msm_batch(segments)
    dev = _device.resolve(device)
    total = sum(len(p) for p, _ in segments)
    # no shard count: the port has no mesh tier (ROADMAP A.7)
    with device_section("bls_msm", batch=total):
        x, y, z = _read(msm_batch_kernel(*to_tensors(host, dev)))
    # host-side affine conversion stays outside the gate
    return [_to_affine_host(x[:, j], y[:, j], z[:, j]) for j in range(s)]


def msm(points: Sequence, scalars: Sequence[int],
        device: Optional[torch.device] = None):
    """Host-facing MSM: G1 affine int points + int scalars -> affine point
    (drop-in for fastMultExp, FastMultExp.cpp:27-59): one segment of the
    batched kernel."""
    if len(points) == 0:
        return None
    return msm_batch([(points, scalars)], device)[0]


def combine_shares(ids: Sequence[int], shares_g1: Sequence,
                   device: Optional[torch.device] = None) -> object:
    """Threshold combine: Lagrange coefficients (host) + MSM (device)."""
    coeffs = ref.lagrange_coeffs_at_zero(ids)
    return msm(list(shares_g1), coeffs, device)


def combine_shares_batch(jobs: Sequence[Tuple[Sequence[int], Sequence]],
                         device: Optional[torch.device] = None) -> List:
    """Fused threshold combine across slots: jobs of (ids, shares_g1) —
    Lagrange coefficients per job on the host, then ONE segmented MSM for
    every job together. Element-wise identical to per-job
    `combine_shares`."""
    return msm_batch([(list(shares), ref.lagrange_coeffs_at_zero(ids))
                      for ids, shares in jobs], device)


def batch_scalar_mul(points: Sequence, scalars: Sequence[int],
                     device: Optional[torch.device] = None) -> List:
    """[k_i] P_i for each i (no reduction): the MSM kernel's launch with
    one point a segment."""
    n = len(points)
    if n == 0:
        return []
    from tpubft_torch.ops.dispatch import device_section
    host = _prep_msm(points, scalars)
    dev = _device.resolve(device)
    with device_section("bls_mul", batch=n):
        x, y, z = _read(scalar_mul_kernel(*to_tensors(host, dev)))
    return [_to_affine_host(x[:, i], y[:, i], z[:, i]) for i in range(n)]
