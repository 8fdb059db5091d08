"""The port's host BLS12-381 engine (tpubft_torch/crypto/bls12381.py over
its own build of native/bls12381.cpp) against the reference's
tpubft.crypto.bls12381, on a seeded corpus, exactly: G1/G2 multiplies,
compress/decompress with invalid encodings, hash-to-G1, pairing-check
verdicts, Lagrange coefficients, keygen from a seed and g1_msm. Each runs
twice: with both native engines loaded, and with both on their
pure-Python paths (what TPUBFT_NO_NATIVE selects), where the port counts
every fallback answer.
"""
import random

import pytest

from tpubft.crypto import bls12381 as RB
from tpubft.crypto import bls_native as RN
from tpubft_torch.crypto import bls12381 as PB
from tpubft_torch.crypto import bls_native as PN

MODES = ("native", "python")


@pytest.fixture(params=MODES)
def mode(request, monkeypatch):
    if request.param == "native":
        assert RN.available() and PN.available(), PN.load_error
    else:
        for mod in (RN, PN):
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_tried", True)
    PN.reset_counts()
    yield request.param
    if request.param == "native":
        assert PN.COUNTS["fallbacks"] == 0


def _scalars(n, seed=7):
    rng = random.Random(seed)
    return [0, 1, 2, RB.R - 1, RB.R, RB.R + 5] + [
        rng.randrange(1, 1 << 256) for _ in range(n)]


def test_g1_mul_and_compress(mode):
    for k in _scalars(4):
        a = PB.g1_mul(PB.G1_GEN, k)
        assert a == RB.g1_mul(RB.G1_GEN, k)
        enc = PB.g1_compress(a)
        assert enc == RB.g1_compress(a)
        assert PB.g1_decompress(enc) == RB.g1_decompress(enc) == a
    # every pure-Python answer is counted, none of the engine's
    assert (PN.COUNTS["fallbacks"] > 0) == (mode == "python")


def test_g2_mul_and_compress(mode):
    for k in _scalars(1)[:4] + [123456789]:
        a = PB.g2_mul(PB.G2_GEN, k)
        assert a == RB.g2_mul(RB.G2_GEN, k)
        enc = PB.g2_compress(a)
        assert enc == RB.g2_compress(a)
        if mode == "native":      # the pure-Python [R]Q check is slow
            assert PB.g2_decompress(enc) == RB.g2_decompress(enc) == a


def _invalid_g1():
    good = RB.g1_compress(RB.g1_mul(RB.G1_GEN, 99))
    out = [b"", good[:47], good + b"\x00", bytes(48),          # no flag
           bytes([0xC0]) + b"\x00" * 46 + b"\x01",               # bad inf
           bytes([0x9F]) + b"\xff" * 47]                         # x >= p
    x = 1
    while True:                                    # an x off the curve
        if RB.fp_sqrt((x ** 3 + RB.B1) % RB.P) is None:
            out.append(bytes([0x80 | (x >> 376)]) + (x % (1 << 376))
                       .to_bytes(47, "big"))
            break
        x += 1
    # on the curve, outside the order-r subgroup
    x = 3
    while RB.fp_sqrt((x ** 3 + RB.B1) % RB.P) is None:
        x += 1
    out.append(RB.g1_compress((x, RB.fp_sqrt((x ** 3 + RB.B1) % RB.P))))
    return out


@pytest.mark.parametrize("idx", range(8))
def test_invalid_g1_encodings_raise_alike(mode, idx):
    enc = _invalid_g1()[idx]
    with pytest.raises(ValueError) as ref_exc:
        RB.g1_decompress(enc)
    with pytest.raises(ValueError) as port_exc:
        PB.g1_decompress(enc)
    assert str(port_exc.value) == str(ref_exc.value)


def test_invalid_g2_encodings_raise_alike(mode):
    good = RB.g2_compress(RB.g2_mul(RB.G2_GEN, 5))
    for enc in (good[:95], bytes(96), bytes([0xC0]) + b"\x01" + bytes(94),
                bytes([0x9F]) + b"\xff" * 95):
        with pytest.raises(ValueError) as ref_exc:
            RB.g2_decompress(enc)
        with pytest.raises(ValueError) as port_exc:
            PB.g2_decompress(enc)
        assert str(port_exc.value) == str(ref_exc.value)


def test_hash_to_g1(mode):
    for msg in (b"", b"m", b"\x00" * 33, bytes(range(200))):
        assert PB.hash_to_g1(msg) == RB.hash_to_g1(msg)


def test_pairing_check_verdicts(mode):
    sk, pk = RB.keygen(seed=b"pair")
    assert PB.keygen(seed=b"pair") == (sk, pk)
    sig = RB.sign(sk, b"msg")
    assert PB.sign(sk, b"msg") == sig
    cases = [(pk, b"msg", sig), (pk, b"other", sig)]
    if mode == "native":
        cases += [(pk, b"msg", RB.g1_neg(sig)), (RB.G2_GEN, b"msg", sig),
                  (pk, b"msg", None)]
    for key, msg, s in cases:
        assert PB.verify(key, msg, s) == RB.verify(key, msg, s)
    assert PB.verify(pk, b"msg", sig) and not PB.verify(pk, b"other", sig)


def test_lagrange_coefficients():
    rng = random.Random(4)
    for ids in ([1, 2, 3], [1, 2, 3, 5, 7], sorted(rng.sample(
            range(1, 1001), 667)), [4]):
        assert PB.lagrange_coeffs_at_zero(ids) == \
            RB.lagrange_coeffs_at_zero(ids)
    for bad in ([1, 1, 2], [0, 1], [RB.R, 2]):
        with pytest.raises(ValueError):
            PB.lagrange_coeffs_at_zero(bad)


def test_threshold_keygen_from_seed(mode):
    want = RB.threshold_keygen(3, 4, seed=b"kg")
    assert PB.threshold_keygen(3, 4, seed=b"kg") == want


def test_g1_msm_and_combine(mode):
    rng = random.Random(11)
    pts = [RB.g1_mul(RB.G1_GEN, rng.randrange(1, RB.R)) for _ in range(6)]
    pts[2] = None
    ks = _scalars(0)
    assert PB.g1_msm(pts, ks) == RB.g1_msm(pts, ks)
    assert PB.g1_msm(pts[:2], [5, RB.R - 5]) == RB.g1_msm(pts[:2],
                                                          [5, RB.R - 5])
    shares = [RB.g1_mul(RB.G1_GEN, k) for k in (3, 5, 7)]
    assert PB.combine_shares([1, 2, 4], shares) == \
        RB.combine_shares([1, 2, 4], shares)


def test_no_native_env_selects_the_python_engine(monkeypatch):
    monkeypatch.setenv("TPUBFT_NO_NATIVE", "1")
    for name, value in (("_tried", False), ("_lib", None),
                        ("load_error", None)):
        monkeypatch.setattr(PN, name, value)
    assert not PN.available()
    assert PN.load_error == "TPUBFT_NO_NATIVE is set"
    PN.reset_counts()
    assert PB.g1_mul(PB.G1_GEN, 5) == RB.g1_mul_py(RB.G1_GEN, 5)
    assert PN.COUNTS["fallbacks"] == 1
