"""The port's field and curve (ops/field.py, ops/weierstrass.py) at the
256-bit primes of secp256k1 and P-256, against the JAX package's
(tpubft/ops/field.py, tpubft/ops/weierstrass.py) and Python ints,
exactly (tolerance: none; every value is an integer mod p):

  * Field: mul, add, sub, neg, canonical and inv on 0, 1, 2, p-1, p-2,
    values near 2^256 and random values, and on loose inputs (limbs out
    of their 16-bit range, negative values, values of several p);
  * Curve: the complete addition at P+P, P+(-P), O+P, P+O and P+Q
    (projective coordinates equal as field values); the ECDSA kernel's
    own ladder (ops/ecdsa._ladder: Curve.window_sum, fixed_base_sum and
    jac_add, Jacobian) against the reference's Shamir ladder
    double_scalar_mul_bits and to_affine, both curves (a = 0 and the
    a = -3 terms of P-256).
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubft.crypto import scalar as RS
from tpubft.ops import ecdsa as RE
from tpubft.ops import field as RF
from tpubft_torch.crypto import scalar as S
from tpubft_torch.ops import ecdsa as E
from tpubft_torch.ops import field as F

torch.set_num_threads(1)

CURVES = ("secp256k1", "secp256r1")


def _values(p, n_random=6, seed=0):
    rng = random.Random(seed)
    fixed = [0, 1, 2, p - 1, p - 2, (1 << 256) - p, p >> 1, (p + 1) >> 1]
    return fixed + [rng.randrange(p) for _ in range(n_random)]


def _port(f, xs):
    return torch.stack([torch.as_tensor(f.from_int(x)) for x in xs], 1)


def _ref(f, xs):
    return jnp.asarray(np.stack([f.from_int(x) for x in xs], -1))


def _ints(f, t):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return [f.to_int(t[:, j]) for j in range(t.shape[1])]


def _loosen(x: torch.Tensor, p: int, seed: int) -> torch.Tensor:
    """The same values mod p with loose limbs: a multiple of p (up to
    3p, or minus up to p) added, and 2^16 moved down from limb i+1 into
    limb i at random limbs."""
    rng = np.random.default_rng(seed)
    n = x.shape[1]
    k = torch.as_tensor(rng.integers(-1, 4, n))
    pl = torch.as_tensor(F.int_to_limbs(p)).reshape(-1, 1)
    y = x + pl * k
    for _ in range(6):
        i = int(rng.integers(0, F.NL - 1))
        y[i] += 1 << F.LIMB_BITS
        y[i + 1] -= 1
    return y


@pytest.mark.parametrize("curve", CURVES)
def test_field_ops_match_the_reference_and_ints(curve):
    p = E.CURVES[curve]["p"]
    f, rf = F.get_field(p), RF.get_field(p)
    assert E.get_curve(curve).f is f
    xs = _values(p, seed=1)
    ys = list(reversed(_values(p, seed=2)))
    a, b = _port(f, xs), _port(f, ys)
    ra, rb = _ref(rf, xs), _ref(rf, ys)
    want_mul = [x * y % p for x, y in zip(xs, ys)]
    assert _ints(f, f.canonical(f.mul(a, b))) == want_mul
    assert _ints(rf, rf.mul(ra, rb)) == want_mul
    assert _ints(f, f.canonical(f.add(a, b))) == \
        [(x + y) % p for x, y in zip(xs, ys)]
    assert _ints(f, f.canonical(f.sub(a, b))) == \
        [(x - y) % p for x, y in zip(xs, ys)]
    assert _ints(f, f.canonical(f.neg(a))) == [(-x) % p for x in xs]
    # the reference's add/sub are lazy: its Montgomery product of the
    # results must equal the port's
    one = [1] * len(xs)
    assert _ints(rf, rf.mul(rf.add(ra, rb), _ref(rf, one))) == \
        _ints(f, f.canonical(f.mul(f.add(a, b), _port(f, one))))
    assert _ints(rf, rf.mul(rf.sub(ra, rb), _ref(rf, one))) == \
        _ints(f, f.canonical(f.mul(f.sub(a, b), _port(f, one))))


@pytest.mark.parametrize("curve", CURVES)
def test_field_ops_on_loose_inputs(curve):
    p = E.CURVES[curve]["p"]
    f = F.get_field(p)
    xs, ys = _values(p, seed=3), _values(p, seed=4)
    a, b = _port(f, xs), _port(f, ys)
    la, lb = _loosen(a, p, 5), _loosen(b, p, 6)
    assert (la != a).any()
    canon = f.canonical(la)
    assert _ints(f, canon) == xs
    assert (canon >= 0).all() and (canon < 1 << F.LIMB_BITS).all()
    assert torch.equal(canon, f.canonical(a))
    # the operations take such limbs and leave balanced ones: products,
    # sums and differences of them are exact, negative values too
    ma, mb = f.add(la, f.zero((la.shape[1],), la.device)), f.neg(f.neg(lb))
    assert _ints(f, f.canonical(f.mul(ma, mb))) == \
        [x * y % p for x, y in zip(xs, ys)]
    # a chain of loose operations, as the point formulas run them
    t = f.sub(f.add(ma, mb), f.mul(ma, ma))
    t = f.mul(f.neg(t), f.sub(mb, ma))
    want = [(-((x + y) - x * x) * (y - x)) % p for x, y in zip(xs, ys)]
    assert _ints(f, f.canonical(t)) == want
    neg = f.sub(f.sub(a, b), f.add(a, a))        # values below 0
    assert _ints(f, f.canonical(neg)) == [(-x - y) % p for x, y in
                                          zip(xs, ys)]
    assert f.is_zero(f.sub(la, a)).all()
    assert f.eq(la, a).all()


@pytest.mark.parametrize("curve", CURVES)
def test_inv_and_conversions_match_the_reference(curve):
    p = E.CURVES[curve]["p"]
    f, rf = F.get_field(p), RF.get_field(p)
    xs = _values(p, n_random=3, seed=7)
    got = _ints(f, f.canonical(f.inv(_port(f, xs))))
    want = [pow(x, -1, p) if x else 0 for x in xs]
    assert got == want == _ints(rf, rf.inv(_ref(rf, xs)))
    raw = torch.stack([torch.as_tensor(F.int_to_limbs(x)) for x in xs], 1)
    assert _ints(f, f.canonical(f.to_mont(raw))) == xs
    limbs = f.from_mont(_port(f, xs))
    assert [F.limbs_to_int(limbs[:, j]) for j in range(len(xs))] == xs


def _points(curve, n, seed):
    rng = random.Random(seed)
    c = RS.CURVES[curve]
    out = []
    for _ in range(n):
        k = rng.randrange(1, c["n"])
        out.append(S._jac_to_affine(S._mul_g(k, curve), c["p"]))
    return out


def _port_points(cv, pts):
    f = cv.f
    return cv.from_affine(_port(f, [x for x, _ in pts]),
                          _port(f, [y for _, y in pts]))


def _ref_points(cv, pts):
    xs, ys = cv.affine_to_device(pts)
    return cv.from_affine(jnp.asarray(xs), jnp.asarray(ys))


def _proj(f, pt):
    return [tuple(v) for v in zip(*(_ints(f, c) for c in pt))]


@pytest.mark.parametrize("curve", CURVES)
def test_complete_addition_matches_the_reference(curve):
    """P+P, P+(-P), O+P, P+O and P+Q: the same projective coordinates."""
    cv, rcv = E.get_curve(curve), RE.get_curve(curve)
    f, rf = cv.f, rcv.f
    p = E.CURVES[curve]["p"]
    pts = _points(curve, 3, seed=11)
    qs = _points(curve, 3, seed=12)
    neg = [(x, (-y) % p) for x, y in pts]
    P, Q, N = (_port_points(cv, v) for v in (pts, qs, neg))
    rP, rQ, rN = (_ref_points(rcv, v) for v in (pts, qs, neg))
    O, rO = cv.identity((3,), torch.device("cpu")), rcv.identity((3,))
    for got, want in ((cv.add(P, P), rcv.add(rP, rP)),
                      (cv.add(P, N), rcv.add(rP, rN)),
                      (cv.add(O, P), rcv.add(rO, rP)),
                      (cv.add(P, O), rcv.add(rP, rO)),
                      (cv.add(P, Q), rcv.add(rP, rQ))):
        assert _proj(f, got) == _proj(rf, want)
    # P + (-P) is the identity, P + P is [2]P
    assert cv.f.is_zero(cv.add(P, N).z).all()
    x, y, is_id = cv.to_affine(cv.add(P, P))
    assert not is_id.any()
    want2 = [S._jac_to_affine(S._jac_add((px, py, 1), (px, py, 1), p,
                                         RS.CURVES[curve]["a"]), p)
             for px, py in pts]
    assert [(F.limbs_to_int(x[:, j]), F.limbs_to_int(y[:, j]))
            for j in range(3)] == want2


@pytest.mark.parametrize("curve", CURVES)
def test_shamir_ladders_and_to_affine_match_the_reference(curve):
    """The kernel's ladder (ops/ecdsa._ladder: G's fixed-base windows, Q's
    signed windows, secp256k1's GLV halves, Jacobian) on 12-bit scalars
    (zero and equal ones among them) reaches the affine point of the
    reference's Shamir ladder double_scalar_mul_bits (its to_affine) and
    the host engine's [k1]G + [k2]Q; the identity where both are 0."""
    cv, rcv = E.get_curve(curve), RE.get_curve(curve)
    c = RS.CURVES[curve]
    k1 = [0, 5, 4095, 77, 0]
    k2 = [0, 5, 1, 0, 3000]
    nb = 12
    b1 = np.array([[(k >> (nb - 1 - i)) & 1 for k in k1] for i in range(nb)],
                  dtype=np.int32)
    b2 = np.array([[(k >> (nb - 1 - i)) & 1 for k in k2] for i in range(nb)],
                  dtype=np.int32)
    qs = _points(curve, 5, seed=13)
    rQ = _ref_points(rcv, qs)
    rG = rcv.generator((5,))
    words = [torch.as_tensor(E.words_of(v).view(np.int32)) for v in
             (k1, k2, [q[0] for q in qs], [q[1] for q in qs])]
    t = E._ladder(curve, *words)
    f = cv.f
    zi = f.inv(t.z)
    zi2 = f.mul(zi, zi)
    x = f.from_mont(f.mul(t.x, zi2))
    y = f.from_mont(f.mul(t.y, f.mul(zi2, zi)))
    is_id = f.is_zero(t.z)
    want = rcv.double_scalar_mul_bits(jnp.asarray(b1), rG, jnp.asarray(b2),
                                      rQ)
    rx, ry, rid = rcv.to_affine(want)
    assert is_id.tolist() == np.asarray(rid).tolist() == \
        [True, False, False, False, False]
    for j in range(5):
        assert F.limbs_to_int(x[:, j]) == RF.limbs_to_int(np.asarray(rx)[:, j])
        assert F.limbs_to_int(y[:, j]) == RF.limbs_to_int(np.asarray(ry)[:, j])
    for j in range(1, 5):
        t = S._jac_add(S._mul_g(k1[j], curve),
                       S._jac_mul(k2[j], qs[j], c), c["p"], c["a"])
        assert (F.limbs_to_int(x[:, j]), F.limbs_to_int(y[:, j])) == \
            S._jac_to_affine(t, c["p"])
