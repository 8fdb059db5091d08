"""The port's plain PyTorch field (tpubft_torch/ops/f25519.py) against the
reference field (tpubft/ops/f25519.py, JAX on the CPU).

Both run the same integer operations in the same order on the same
24-limb layout, so their limbs must be equal exactly, not just modulo p:
the products, the carry passes, the canonical residues. Inputs are drawn
with seeded numpy: canonical values, loose signed limbs at the edge of
the m*k <= 10 overflow budget, and the values next to 0 and p.
"""
import jax
import numpy as np
import pytest
import torch

from tpubft.ops import f25519 as RF
from tpubft_torch.ops import f25519 as F

# one intra-op thread: these tests run many tiny tensor ops, and several
# test workers share the host's cores
torch.set_num_threads(1)

N = 64


def _canonical_limbs(rng, n):
    vals = [int.from_bytes(rng.bytes(32), "little") % F.P for _ in range(n)]
    vals[:4] = [0, 1, F.P - 1, F.P - 2]
    return np.stack([F.int_to_limbs(v) for v in vals], 1), vals


def _loose_limbs(rng, n, m):
    """Signed limbs with |limb| <= m * 2^11 (m-times-normalized)."""
    bound = m * (1 << 11)
    out = rng.integers(-bound, bound + 1, size=(F.NL, n), dtype=np.int64)
    out[:, 0] = bound                       # worst cases: all limbs at
    out[:, 1] = -bound                      # the budget edge
    return out.astype(np.int32)


def _operands(case):
    rng = np.random.default_rng({"canonical": 1, "loose_2x5": 2,
                                 "loose_3x3": 3, "loose_1x10": 4}[case])
    if case == "canonical":
        return _canonical_limbs(rng, N)[0], _canonical_limbs(rng, N)[0]
    m, k = {"loose_2x5": (2, 5), "loose_3x3": (3, 3),
            "loose_1x10": (1, 10)}[case]
    return _loose_limbs(rng, N, m), _loose_limbs(rng, N, k)


def _port(fn, *arrays):
    return fn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
              ).numpy()


def _ref(fn, *arrays):
    return np.asarray(jax.jit(fn)(*arrays))


CASES = ["canonical", "loose_2x5", "loose_3x3", "loose_1x10"]


def test_constants_match_reference():
    assert F.W == RF.W
    assert np.array_equal(F.BITS, RF.BITS)
    assert np.array_equal(F.MASK, RF.MASK)
    assert np.array_equal(F._DBL, RF._DBL)
    assert np.array_equal(F._OFFSET_LIMBS, RF._OFFSET_LIMBS)
    assert np.array_equal(F._P_TIGHT, RF._P_TIGHT)


@pytest.mark.parametrize("case", CASES)
def test_mul_limbs_equal(case):
    a, b = _operands(case)
    got = _port(F.mul, a, b)
    want = _ref(RF.mul, a, b)
    assert np.array_equal(got, want)
    assert np.array_equal(_port(F.canonical, got), _ref(RF.canonical, want))
    for i in range(0, N, 7):
        assert F.limbs_to_int(got[:, i]) == \
            F.limbs_to_int(a[:, i]) * F.limbs_to_int(b[:, i]) % F.P


@pytest.mark.parametrize("case", CASES)
def test_sqr_limbs_equal(case):
    a, _ = _operands(case)
    if case != "canonical":
        a = a // 4                         # sqr: m*m <= 10 needs m <= 3
    assert np.array_equal(_port(F.sqr, a), _ref(RF.sqr, a))


@pytest.mark.parametrize("case", CASES)
def test_normalize_and_canonical_equal(case):
    a, b = _operands(case)
    loose = a + b                          # sums of loose values
    got_n = _port(F.normalize, loose)
    assert np.array_equal(got_n, _ref(RF.normalize, loose))
    got_c = _port(F.canonical, got_n)
    assert np.array_equal(got_c, _ref(RF.canonical, got_n))
    assert (got_c >= 0).all()
    for i in range(0, N, 5):
        assert np.array_equal(got_c[:, i],
                              F.int_to_limbs(F.limbs_to_int(loose[:, i])))


@pytest.mark.parametrize("fn", ["inv", "pow_p58"])
def test_fixed_exponent_chains_equal(fn):
    a, vals = _canonical_limbs(np.random.default_rng(9), 16)
    got = _port(getattr(F, fn), a)
    assert np.array_equal(got, _ref(getattr(RF, fn), a))
    exp = F.P - 2 if fn == "inv" else (F.P - 5) // 8
    canon = _port(F.canonical, got)
    for i, v in enumerate(vals):
        assert F.limbs_to_int(canon[:, i]) == pow(v, exp, F.P)


def test_eq_and_is_zero_equal():
    a, _ = _canonical_limbs(np.random.default_rng(11), N)
    b = a.copy()
    b[:, ::2] = np.roll(a, 1, axis=1)[:, ::2]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = F.eq(ta, tb).numpy()
    assert np.array_equal(got, np.asarray(jax.jit(RF.eq)(a, b)))
    assert np.array_equal(F.is_zero(ta - ta).numpy(), np.ones(N, bool))


def test_host_helpers_equal():
    rng = np.random.default_rng(13)
    rows = rng.integers(0, 256, size=(N, 32), dtype=np.uint8)
    rows[:, 31] &= 0x7F
    assert np.array_equal(F.bytes_le_to_limbs(rows),
                          RF.bytes_le_to_limbs(rows))
    for v in (0, 1, F.P - 1, F.P, F.P + 5, 2**300 + 7):
        assert np.array_equal(F.int_to_limbs(v), RF.int_to_limbs(v))
        assert F.limbs_to_int(F.int_to_limbs(v)) == v % F.P
