"""The port's ECDSA host engine (crypto/scalar.py's ECDSA half,
crypto/cpu.py's EcdsaSigner / EcdsaVerifier) against the reference's
pure-Python engine (tpubft/crypto/scalar.py), exactly (tolerance: none;
bytes and verdicts):

  * curve parameters, keys, and RFC 6979 signatures byte for byte;
  * ecdsa_verify_batch / ecdsa_verify verdicts on the edge cases of the
    reference's tests/test_ecdsa_batch.py (high s, s = n, s = 0, r = 0,
    r out of range, a short signature, an off-curve and a compressed key,
    a wrong key and a wrong message), both curves, with GLV on and off,
    through the hot (8-bit) comb and through the cold small-group path;
  * the attributed stats sinks: the same counts in both engines for the
    same calls, evictions included;
  * the signer and verifier classes against the reference's with its
    OpenSSL branch off (`tpubft.crypto.cpu._openssl` patched to None:
    where `cryptography` is installed the reference signs with random
    nonces and skips the batched engine).
"""
import hashlib

import pytest

from tpubft.crypto import cpu as RC
from tpubft.crypto import scalar as RS
from tpubft.ops import ecdsa as RE
from tpubft_torch.crypto import cpu as C
from tpubft_torch.crypto import scalar as S
from tpubft_torch.ops import ecdsa as E

CURVES = ("secp256k1", "secp256r1")


@pytest.fixture(autouse=True)
def _fresh_caches():
    S.reset_ecdsa_caches()
    RS.reset_ecdsa_caches()
    S.consume_decode_stats()
    RS.consume_decode_stats()
    yield


@pytest.fixture
def no_openssl(monkeypatch):
    monkeypatch.setattr(RC, "_openssl", lambda: None)


def test_curve_parameters_match_the_reference():
    assert S.CURVES == RS.CURVES == E.CURVES == RE.CURVES
    assert S._GLV_PARAMS == RS._GLV_PARAMS


@pytest.mark.parametrize("curve", CURVES)
def test_keys_and_rfc6979_signatures_are_byte_equal(curve):
    for i in range(4):
        seed = b"engine-%d" % i
        d = S.ecdsa_seed_to_private(seed, curve)
        assert d == RS.ecdsa_seed_to_private(seed, curve)
        assert S.ecdsa_public_key(d, curve) == RS.ecdsa_public_key(d, curve)
        for msg in (b"", b"m", hashlib.sha256(seed).digest() * 5):
            sig = S.ecdsa_sign(d, msg, curve)
            assert sig == RS.ecdsa_sign(d, msg, curve)
            assert S.ecdsa_verify(S.ecdsa_public_key(d, curve), msg, sig,
                                  curve)


def _corpus(curve, valid=4):
    """(pk, msg, sig) triples and verdicts: valid items of two signers,
    the high-s twin, and every reject class."""
    n = S.CURVES[curve]["n"]
    s1 = C.EcdsaSigner.generate(curve, seed=b"eb-1")
    s2 = C.EcdsaSigner.generate(curve, seed=b"eb-2")
    items, want = [], []
    for i in range(valid):
        signer = s1 if i % 2 else s2
        m = b"batch-msg-%d" % i
        items.append((signer.public_bytes(), m, signer.sign(m)))
        want.append(True)
    pk, m, sig = items[0]
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:], "big")
    other = s1.public_bytes() if pk == s2.public_bytes() else \
        s2.public_bytes()
    items += [
        (pk, m, sig[:32] + (n - s).to_bytes(32, "big")),      # high s
        (pk, b"forged", sig),                                 # wrong msg
        (other, m, sig),                                      # wrong key
        (pk, m, b"\x00" * 32 + sig[32:]),                     # r = 0
        (pk, m, sig[:32] + b"\x00" * 32),                     # s = 0
        (pk, m, sig[:32] + n.to_bytes(32, "big")),            # s = n
        (pk, m, (r + n if r + n < 2 ** 256 else n).to_bytes(32, "big")
         + sig[32:]),                                         # r >= n
        (pk, m, sig[:40]),                                    # short sig
        (b"\x04" + b"\x00" * 64, m, sig),                     # off curve
        (b"\x02" + pk[1:33], m, sig),                         # compressed
    ]
    want += [True] + [False] * 9
    return items, want


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("glv", ["1", "0"])
def test_verify_batch_verdicts_match_on_the_edge_cases(curve, glv,
                                                       monkeypatch):
    monkeypatch.setenv("TPUBFT_ECDSA_GLV", glv)
    items, want = _corpus(curve)
    # the first call builds the cold combs, the second walks them
    for _ in range(2):
        assert S.ecdsa_verify_batch(items, curve) == want
        assert RS.ecdsa_verify_batch(items, curve) == want
    assert [S.ecdsa_verify(pk, m, s, curve) for pk, m, s in items] == want


@pytest.mark.parametrize("curve", CURVES)
def test_hot_comb_and_small_cold_groups_match(curve, monkeypatch):
    """Principals past the hot threshold walk the 8-bit comb; a one- or
    two-item cold group takes the plain per-item verify: the same
    verdicts as the reference in each."""
    for mod in (S, RS):
        monkeypatch.setattr(mod, "_COMB_HOT_AFTER", 4)
    items, want = _corpus(curve, valid=6)
    for _ in range(3):
        assert S.ecdsa_verify_batch(items, curve) == want == \
            RS.ecdsa_verify_batch(items, curve)
    key = (curve, items[0][0])
    assert S._pk_cache[key].width == RS._pk_cache[key].width == 8
    single = [items[0], items[-4]]
    assert S.ecdsa_verify_batch(single, curve) == \
        RS.ecdsa_verify_batch(single, curve) == [True, False]


def _sink_counts(mod, calls, curve):
    sink = mod.new_stats_sink()
    with mod.attribute_stats(sink):
        for items in calls:
            mod.ecdsa_verify_batch(items, curve)
    out = sink.drain()
    out.pop("host_ns")
    return out


def test_stats_sinks_count_the_same_with_evictions(monkeypatch):
    curve = "secp256k1"
    for mod in (S, RS):
        monkeypatch.setattr(mod, "_PK_CACHE_MAX", 4)
        monkeypatch.setattr(mod, "_HOT_COMB_MAX", 1)
        monkeypatch.setattr(mod, "_COMB_HOT_AFTER", 3)
    signers = [C.EcdsaSigner.generate(curve, seed=b"sink-%d" % i)
               for i in range(6)]
    calls = []
    for j in range(3):
        calls.append([(s.public_bytes(), b"x%d" % j, s.sign(b"x%d" % j))
                      for s in signers[:3] for _ in range(2)])
    calls.append([(s.public_bytes(), b"y", s.sign(b"y")) for s in signers])
    got = _sink_counts(S, calls, curve)
    want = _sink_counts(RS, calls, curve)
    assert got == want
    assert got["evictions"] > 0 and got["hits"] > 0
    assert got["host_items"] == sum(map(len, calls))
    # outside a scope, the module sink gets the events
    S.ecdsa_verify_batch(calls[0], curve)
    assert S.consume_decode_stats()["host_batches"] == 1


@pytest.mark.parametrize("scheme,curve", [("ecdsa-secp256k1", "secp256k1"),
                                          ("secp256k1", "secp256k1"),
                                          ("ecdsa-p256", "secp256r1"),
                                          ("ecdsa-secp256r1", "secp256r1")])
def test_signer_and_verifier_match_the_reference(no_openssl, scheme, curve):
    seed = b"signer-" + scheme.encode()
    port, ref = C.make_signer(scheme, seed=seed), RC.make_signer(scheme,
                                                               seed=seed)
    assert port.curve_name == ref.curve_name == curve
    assert port.public_bytes() == ref.public_bytes()
    assert port.signature_length == ref.signature_length == 64
    msgs = [b"a", b"b" * 100, b""]
    sigs = [port.sign(m) for m in msgs]
    assert sigs == [ref.sign(m) for m in msgs]
    v = C.make_verifier(scheme, port.public_bytes())
    rv = RC.make_verifier(scheme, port.public_bytes())
    assert v.uses_scalar_engine and rv.uses_scalar_engine
    pairs = list(zip(msgs, sigs)) + [(b"forged", sigs[0]), (msgs[0], b"\0")]
    assert v.verify_batch(pairs) == rv.verify_batch(pairs) == \
        [True, True, True, False, False]
    assert [v.verify(m, s) for m, s in pairs] == \
        [rv.verify(m, s) for m, s in pairs]
    assert v.verify_batch(pairs[:1]) == [True]


def test_verifier_and_signer_refuse_bad_keys(no_openssl):
    pk = C.make_signer("ecdsa-secp256k1", seed=b"k").public_bytes()
    for bad in (b"\x02" + b"\x01" * 32, pk[:64], b"\x04" + b"\x00" * 64):
        with pytest.raises(ValueError):
            C.EcdsaVerifier(bad, "secp256k1")
        with pytest.raises(ValueError):
            RC.EcdsaVerifier(bad, "secp256k1")
    with pytest.raises(ValueError):
        C.EcdsaSigner(0, "secp256k1")
    with pytest.raises(ValueError):
        C.EcdsaSigner(1, "no-such-curve")
    with pytest.raises(ValueError):
        C.make_verifier("no-such-scheme", pk)
