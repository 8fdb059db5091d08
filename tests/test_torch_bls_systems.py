"""threshold-bls and multisig-bls on the port against the reference, byte
for byte: key material from one seed, `sign_share` bytes, `combine_batch`
tuples (verdict, certificate bytes, bad-share ids) with bad, out-of-range
and undecodable shares present, `verify_batch_certs` verdicts,
accumulator certificates and multisig-bls `aggregate_partials` bytes.

Then the same on the port's CUDA classes (crypto/cuda.py) with the CPU
asked for and TPUBFT_MSM_CROSSOVER_K=1, as tests/test_crypto_tpu_backend.py
does for the reference, so every flush and every accumulator combine
takes the MSM kernel's plain version on CPU tensors; and at the default
crossover, where config 2's flushes stay on the host engine.
"""
import pytest
import torch

from tpubft.crypto import systems as RS
from tpubft.crypto.interfaces import Cryptosystem as RefCryptosystem
from tpubft_torch import convert, device
from tpubft_torch.crypto import cuda as CC
from tpubft_torch.crypto import systems as PS
from tpubft_torch.crypto.interfaces import Cryptosystem

torch.set_num_threads(1)

K, N = 3, 4


@pytest.fixture(autouse=True)
def _cpu():
    device.set_default_device("cpu")
    yield
    device.set_default_device(None)


def _systems(scheme):
    ref = RefCryptosystem(scheme, K, N, seed=b"bls-systems")
    port = Cryptosystem(scheme, K, N, seed=b"bls-systems")
    assert port.public_key == ref.public_key
    assert port.share_public_keys == ref.share_public_keys
    assert port.secret_shares == ref.secret_shares
    carried = convert.cryptosystem_from_keys(
        scheme, K, N, ref.public_key, ref.share_public_keys,
        ref.secret_shares)
    return ref, port, carried


def _shares(system, digest, ids):
    return {i: system.create_threshold_signer(i).sign_share(digest)
            for i in ids}


def _jobs(ref):
    """Four slots: clean; one share over another digest (bad); an
    out-of-range id and an undecodable share beside a full quorum; too
    few shares."""
    digests = [bytes([j]) * 32 for j in range(4)]
    jobs = [(digests[0], _shares(ref, digests[0], [1, 2, 3])),
            (digests[1], _shares(ref, digests[1], [1, 2, 4]))]
    jobs[1][1][2] = _shares(ref, b"other", [2])[2]
    extra = _shares(ref, digests[2], [2, 3, 4])
    extra[9] = extra[2]
    extra[1] = b"\x01" * 48
    jobs.append((digests[2], extra))
    jobs.append((digests[3], _shares(ref, digests[3], [4])))
    return jobs


@pytest.mark.parametrize("scheme", ["threshold-bls", "multisig-bls"])
def test_signing_and_keys_match(scheme):
    ref, port, carried = _systems(scheme)
    for system in (port, carried):
        for i in range(1, N + 1):
            assert (system.create_threshold_signer(i).sign_share(b"d")
                    == ref.create_threshold_signer(i).sign_share(b"d"))


def _compare(ref_v, port_v, jobs):
    want = ref_v.combine_batch(jobs)
    assert [ok for ok, _, _ in want] == [True, False, True, False]
    assert want[1][2] == [2]
    assert port_v.combine_batch(jobs) == want
    certs = [(d, c) for (d, _), (ok, c, _) in zip(jobs, want) if ok]
    forged = certs + [(b"\x07" * 32, certs[0][1]), (certs[0][0], b"\x00")]
    assert port_v.verify_batch_certs(forged) == \
        ref_v.verify_batch_certs(forged) == [True, True, False, False]
    for d, c in certs:
        assert port_v.verify(d, c) and ref_v.verify(d, c)
    # the accumulator path over the first job
    acc_r = ref_v.new_accumulator(False)
    acc_p = port_v.new_accumulator(False)
    for a in (acc_r, acc_p):
        a.set_expected_digest(jobs[0][0])
        for sid, share in jobs[0][1].items():
            a.add(sid, share)
    assert acc_p.get_full_signed_data() == acc_r.get_full_signed_data() \
        == want[0][1]
    acc_r.add(4, jobs[1][1][4])
    acc_p.add(4, jobs[1][1][4])
    assert acc_p.identify_bad_shares() == acc_r.identify_bad_shares()
    return want


@pytest.mark.parametrize("scheme", ["threshold-bls", "multisig-bls"])
def test_host_classes_match_the_reference(scheme):
    ref, port, _ = _systems(scheme)
    _compare(ref.create_threshold_verifier(),
             port.create_threshold_verifier(), _jobs(ref))


def test_multisig_partials_match_the_reference():
    ref, port, _ = _systems("multisig-bls")
    digest = b"\x05" * 32
    shares = _shares(ref, digest, [1, 2, 3, 4])
    rv, pv = ref.create_threshold_verifier(), port.create_threshold_verifier()
    pts = {i: RS.bls.g1_decompress(s) for i, s in shares.items()}
    jobs = [([1, 2], [pts[1], pts[2]]), ([3], [pts[3]]), ([4], [pts[4]])]
    partials = pv.aggregate_partials(jobs)
    assert partials == rv.aggregate_partials(jobs)
    assert PS.unpack_agg_cert(partials[0]) == RS.unpack_agg_cert(partials[0])
    assert PS.pack_contributors([1, 3]) == RS.pack_contributors([1, 3]) == 5
    assert PS.unpack_contributors(5) == [1, 3]
    # a partial and the raw shares it covers feed one certificate
    feed = {1: partials[0], 3: shares[3], 4: shares[4]}
    assert pv.combine_batch([(digest, feed)]) == \
        rv.combine_batch([(digest, feed)])
    acc_p, acc_r = pv.new_accumulator(True), rv.new_accumulator(True)
    for a in (acc_p, acc_r):
        a.set_expected_digest(digest)
        a.add_partial(partials[0])
        a.add(3, shares[3])
    assert acc_p.get_full_signed_data() == acc_r.get_full_signed_data()


@pytest.mark.parametrize("scheme", ["threshold-bls", "multisig-bls"])
def test_cuda_classes_on_cpu_tensors_match(scheme, monkeypatch):
    """Crossover 1: every flush and accumulator combine goes to the MSM
    kernel's route, which on CPU tensors is its plain version."""
    monkeypatch.setenv("TPUBFT_MSM_CROSSOVER_K", "1")
    ref, port, _ = _systems(scheme)
    cuda_v = CC.make_threshold_verifier(scheme, K, N, port.public_key,
                                        port.share_public_keys)
    assert type(cuda_v).__name__ == {
        "threshold-bls": "CudaBlsThresholdVerifier",
        "multisig-bls": "CudaBlsMultisigVerifier"}[scheme]
    _compare(ref.create_threshold_verifier(), cuda_v, _jobs(ref))
    assert cuda_v.host_combines == 0
    assert cuda_v.device_combines >= 1 + (scheme == "threshold-bls")


@pytest.mark.parametrize("scheme", ["threshold-bls", "multisig-bls"])
def test_cuda_classes_stay_on_the_host_below_the_crossover(scheme):
    """At the default crossover (128 shares) config 2's small flushes
    combine with the host engine, as the reference's do."""
    ref, port, _ = _systems(scheme)
    cuda_v = CC.make_threshold_verifier(scheme, K, N, port.public_key,
                                        port.share_public_keys)
    jobs = _jobs(ref)
    assert cuda_v.combine_batch(jobs) == \
        ref.create_threshold_verifier().combine_batch(jobs)
    assert cuda_v.device_combines == 0 and cuda_v.host_combines == 1


def test_unknown_scheme_is_refused():
    with pytest.raises(ValueError):
        CC.make_threshold_verifier("threshold-rsa", K, N, None, [])
    with pytest.raises(ValueError):
        Cryptosystem("threshold-rsa", K, N)
