"""The port's config-1 signature plane (tpubft_torch: ClusterKeys,
SigManager/BatchVerifier, the multisig-ed25519 cryptosystem over the
CUDA plugin) against the reference (tpubft with the JAX backend on the
CPU). The port runs on the CPU here (plain PyTorch kernel). Key
material, verdict vectors, combined certificates and bad-share lists
must be exactly equal.
"""
import dataclasses

import pytest
import torch

from tpubft.consensus import keys as RK
from tpubft.consensus import sig_manager as RS
from tpubft.crypto import interfaces as RI
from tpubft.crypto import systems as RSYS
from tpubft.crypto import tpu as RT
from tpubft.utils import config as RC
from tpubft_torch import convert, device
from tpubft_torch.consensus import keys as K
from tpubft_torch.consensus import sig_manager as S
from tpubft_torch.crypto import cuda as C
from tpubft_torch.crypto import interfaces as I
from tpubft_torch.crypto import scalar
from tpubft_torch.crypto import systems as SYS
from tpubft_torch.crypto.digest import calc_combination, digest
from tpubft_torch.ops import ed25519 as ops
from tpubft_torch.ops.dispatch import device_breaker
from tpubft_torch.utils import config as PC

# one intra-op thread: these tests run many tiny tensor ops, and several
# test workers share the host's cores
torch.set_num_threads(1)

SEED = b"torch-plane-test"


@pytest.fixture(autouse=True)
def _on_cpu():
    device.set_default_device("cpu")
    device_breaker().reset()
    yield
    device_breaker().reset()
    device.set_default_device(None)


@pytest.fixture(scope="module")
def both_keys():
    cfg_r = RC.ReplicaConfig(f_val=1, c_val=0, threshold_scheme="adaptive")
    cfg_p = PC.ReplicaConfig(f_val=1, c_val=0, threshold_scheme="adaptive")
    return (RK.ClusterKeys.generate(cfg_r, num_clients=6, seed=SEED),
            K.ClusterKeys.generate(cfg_p, num_clients=6, seed=SEED))


def _systems(ck):
    return {a: getattr(ck, a) for a in ("slow_path_system",
                                        "commit_path_system",
                                        "optimistic_system")}


@pytest.mark.parametrize("f_val", [1, 2])
def test_cluster_keys_byte_identical(f_val, both_keys):
    if f_val == 1:
        ref, port = both_keys
    else:
        ref = RK.ClusterKeys.generate(RC.ReplicaConfig(f_val=2),
                                      num_clients=2, seed=SEED + b"2")
        port = K.ClusterKeys.generate(PC.ReplicaConfig(f_val=2),
                                      num_clients=2, seed=SEED + b"2")
    assert (port.n, port.f, port.c) == (ref.n, ref.f, ref.c)
    assert port.threshold_scheme == ref.threshold_scheme == \
        "multisig-ed25519"
    assert port.replica_pubkeys == ref.replica_pubkeys
    assert port.client_pubkeys == ref.client_pubkeys
    assert port.operator_id == ref.operator_id
    for name, rsys in _systems(ref).items():
        psys = getattr(port, name)
        assert psys.type_name == rsys.type_name
        assert psys.threshold_ == rsys.threshold_
        assert psys.share_public_keys == rsys.share_public_keys
        assert psys.secret_shares == rsys.secret_shares
    assert port.for_node(0).my_sign_seed == ref.for_node(0).my_sign_seed


def test_cluster_keys_from_public_material(both_keys):
    ref, port = both_keys
    conv = convert.cluster_keys_from_public(
        ref.n, ref.f, ref.c, ref.threshold_scheme, ref.replica_pubkeys,
        ref.client_pubkeys,
        {a: (s.threshold_, s.share_public_keys)
         for a, s in _systems(ref).items()},
        operator_id=ref.operator_id)
    assert conv.replica_pubkeys == port.replica_pubkeys
    assert conv.client_pubkeys == port.client_pubkeys
    sysr = ref.slow_path_system
    d = calc_combination(digest(b"blk"), 0, 1)
    shares = {i: sysr.create_threshold_signer(i).sign_share(d)
              for i in range(1, 4)}
    v = conv.threshold_verifier(conv.slow_path_system, backend="cuda")
    ok, cert, bad = v.combine_batch([(d, shares)])[0]
    assert ok and bad == []
    assert cert == RSYS.pack_multisig_vector([1, 2, 3], shares)
    with pytest.raises(TypeError):
        conv.slow_path_system.create_threshold_signer(1)


def _client_items(ref, n_items=40):
    """(principal, data, sig) over the cluster's clients and replicas:
    valid, forged, wrong length, and an unknown principal."""
    items = []
    principals = sorted(ref.client_pubkeys)[:6] + [0, 1]
    for j in range(n_items):
        p = principals[j % len(principals)]
        kind = "replica" if p < ref.n else "client"
        if p == ref.operator_id:
            kind = "operator"
        signer = scalar_signer(RK._derive_seed(SEED, kind, p))
        data = b"request-%d-%d" % (p, j)
        sig = signer.sign(data)
        if j % 7 == 3:
            sig = sig[:9] + bytes([sig[9] ^ 0x20]) + sig[10:]
        elif j % 11 == 5:
            sig = sig[:60]
        elif j % 13 == 6:
            data = data + b"?"
        items.append((p, data, sig))
    items.append((99999, b"nobody", b"\x01" * 64))
    return items


def scalar_signer(seed):
    from tpubft_torch.crypto.cpu import Ed25519Signer
    return Ed25519Signer.generate(seed=seed)


def test_sig_manager_matches_reference(both_keys):
    ref, port = both_keys
    items = _client_items(ref)
    want = RS.SigManager(ref.for_node(0), batch_fn=RT.verify_batch_mixed,
                         device_min_batch=1).verify_batch(items)
    sm = S.SigManager(port.for_node(0), batch_fn=C.verify_batch_mixed,
                      device_min_batch=1)
    got = sm.verify_batch(items)
    assert got == want
    assert sum(got) > len(items) // 2 and not all(got)
    c = sm.metrics.snapshot()["counters"]
    assert c["batched_verifies"] == len(items)
    assert c["degraded_verifies"] == 0 and c["scalar_fallbacks"] == 0
    # memo: identical re-presentation short-circuits valid items
    assert sm.verify_batch(items) == want
    assert sm.metrics.snapshot()["counters"]["memo_hits"] == sum(want)


def test_batch_verifier_matches_reference(both_keys):
    ref, port = both_keys
    items = _client_items(ref, n_items=24)
    want = RS.SigManager(ref.for_node(0)).verify_batch(items)
    sm = S.SigManager(port.for_node(0), batch_fn=C.verify_batch_mixed,
                      device_min_batch=4, memo_capacity=0)
    bv = S.BatchVerifier(sm, batch_size=256, flush_us=200)
    try:
        pend = [bv.submit(p, d, s) for p, d, s in items]
        got = [v.result(timeout=120) for v in pend]
    finally:
        bv.stop()
    assert got == want


def _jobs(signers, k, digests, bad=()):
    jobs = []
    for j, d in enumerate(digests):
        shares = {}
        for i in range(1, k + 1):
            msg = b"wrong" * 6 + b"xx" if (j, i) in bad else d
            shares[i] = signers[i].sign_share(msg)
        jobs.append((d, shares))
    return jobs


@pytest.fixture(scope="module")
def multisig():
    rcs = RI.Cryptosystem("multisig-ed25519", threshold=3, num_signers=4,
                          seed=b"fused-ms")
    pcs = I.Cryptosystem("multisig-ed25519", threshold=3, num_signers=4,
                         seed=b"fused-ms")
    assert pcs.share_public_keys == rcs.share_public_keys
    signers = {i: rcs.create_threshold_signer(i) for i in range(1, 5)}
    digests = [bytes([i + 16]) * 32 for i in range(3)]
    jobs = _jobs(signers, 3, digests, bad={(1, 1), (1, 3)})
    jobs.append((bytes([40]) * 32,           # 4 shares, one out of range
                 {**_jobs(signers, 4, [bytes([40]) * 32])[0][1],
                  9: b"\0" * 64}))
    return rcs, pcs, jobs, digests


def test_combine_batch_byte_equal(multisig):
    rcs, pcs, jobs, digests = multisig
    rv = RT.make_threshold_verifier("multisig-ed25519", 3, 4,
                                    rcs.public_key, rcs.share_public_keys)
    pv = C.make_threshold_verifier("multisig-ed25519", 3, 4,
                                   pcs.public_key, pcs.share_public_keys)
    got = pv.combine_batch(jobs)
    assert got == rv.combine_batch(jobs)
    assert got == I.IThresholdVerifier.combine_batch(pv, jobs)
    assert [ok for ok, _, _ in got] == [True, False, True, True]
    assert got[1][2] == [1, 3]
    # the host multisig scheme (no device) gives the same bytes
    assert got == pcs.create_threshold_verifier().combine_batch(jobs)


def test_verify_batch_certs_equal_and_aligned(multisig):
    rcs, pcs, jobs, digests = multisig
    rv = RT.make_threshold_verifier("multisig-ed25519", 3, 4,
                                    rcs.public_key, rcs.share_public_keys)
    pv = C.make_threshold_verifier("multisig-ed25519", 3, 4,
                                   pcs.public_key, pcs.share_public_keys)
    fused = pv.combine_batch(jobs)
    two_bad = bytearray(fused[0][1])
    two_bad[10] ^= 0xFF
    two_bad[80] ^= 0xFF
    certs = [(digests[0], bytes(two_bad)), (digests[2], fused[2][1]),
             (digests[0], fused[0][1]), (digests[1], fused[0][1]),
             (digests[0], fused[0][1][:-1]),                  # short
             (digests[0], fused[0][1] + b"\0")]
    got = pv.verify_batch_certs(certs)
    assert got == rv.verify_batch_certs(certs)
    assert got == [False, True, True, False, False, False]
    assert [pv.verify(d, s) for d, s in certs] == got
    assert pv.verify_share_batch([(1, digests[0], jobs[0][1][1]),
                                  (7, digests[0], jobs[0][1][1]),
                                  (2, digests[0], jobs[0][1][1])]) == \
        [True, False, False]


def test_raising_kernel_degrades_to_scalar_tier(both_keys, multisig,
                                                monkeypatch):
    """A failing kernel trips the port's breaker; every caller degrades
    to the host scalar engine (never the plain kernel) with verdicts
    identical to the healthy reference."""
    ref, port = both_keys
    items = _client_items(ref, n_items=16)
    want = RS.SigManager(ref.for_node(0)).verify_batch(items)
    calls = {"kernel": 0, "plain": 0, "scalar": 0}

    def broken(*args):
        calls["kernel"] += 1
        raise RuntimeError("injected device fault")

    def plain(*args):
        calls["plain"] += 1
        raise AssertionError("degradation must not use the plain kernel")

    real_scalar = scalar.ed25519_verify

    def counted_scalar(*args):
        calls["scalar"] += 1
        return real_scalar(*args)

    monkeypatch.setattr(ops, "verify_kernel", broken)
    monkeypatch.setattr(ops, "plain_verify_kernel", plain)
    monkeypatch.setattr(scalar, "ed25519_verify", counted_scalar)
    sm = S.SigManager(port.for_node(0), batch_fn=C.verify_batch_mixed,
                      device_min_batch=1, memo_capacity=0)
    breaker = device_breaker()
    threshold = breaker.failure_threshold
    # no half-open probe inside the test, however slow the host
    monkeypatch.setattr(breaker, "base_cooldown_s", 600.0)
    monkeypatch.setattr(breaker, "_cooldown_s", 600.0)
    for attempt in range(threshold + 1):
        assert sm.verify_batch(items) == want
    # the first `threshold` batches reached the kernel, then it tripped
    assert calls["kernel"] == threshold
    assert breaker.state == "open"
    assert calls["plain"] == 0 and calls["scalar"] >= len(items)
    c = sm.metrics.snapshot()["counters"]
    assert c["degraded_verifies"] == (threshold + 1) * len(items)
    assert c["batched_verifies"] == 0

    # the multisig plane degrades the same way (breaker open: fast-fail)
    rcs, pcs, jobs, _ = multisig
    pv = C.make_threshold_verifier("multisig-ed25519", 3, 4,
                                   pcs.public_key, pcs.share_public_keys)
    assert pv.combine_batch(jobs) == \
        pcs.create_threshold_verifier().combine_batch(jobs)
    assert pv.degraded >= 1
    ev = C.CudaEd25519Verifier(port.replica_pubkeys[0])
    assert ev.verify_batch([(b"x", b"\0" * 64)]) == [False]
    assert ev.degraded == 1
    assert calls["kernel"] == threshold and calls["plain"] == 0


@pytest.mark.parametrize("entry", ["combine_batch", "verify_batch_certs"])
def test_one_kernel_fault_is_counted(multisig, monkeypatch, entry):
    """A kernel fault after the launch is answered alike by the host
    tier; the verifier's `degraded` counter and the breaker's failure
    count are what tell the fallback apart from a device answer."""
    rcs, pcs, jobs, digests = multisig
    pv = C.make_threshold_verifier("multisig-ed25519", 3, 4,
                                   pcs.public_key, pcs.share_public_keys)
    host = pcs.create_threshold_verifier()
    fused = pv.combine_batch(jobs)
    certs = [(digests[0], fused[0][1]), (digests[2], fused[2][1])]
    assert pv.degraded == 0
    real = ops.verify_kernel

    def faulty(*args):
        real(*args)
        raise RuntimeError("injected fault after the launch")

    monkeypatch.setattr(ops, "verify_kernel", faulty)
    breaker = device_breaker()
    before = breaker.snapshot()
    if entry == "combine_batch":
        assert pv.combine_batch(jobs) == host.combine_batch(jobs)
    else:
        # 6 shares ride the device; each cert's fallback (k=3) the host
        monkeypatch.setattr(pv, "min_device_batch", 4)
        assert pv.verify_batch_certs(certs) == host.verify_batch_certs(certs)
    assert breaker.snapshot()["failures"] > before["failures"]
    assert pv.degraded >= 1


def test_verify_batch_mixed_routes_by_scheme(both_keys):
    ref, _ = both_keys
    pk = ref.replica_pubkeys[0]
    sig = scalar_signer(RK._derive_seed(SEED, "replica", 0)).sign(b"m")
    got = C.verify_batch_mixed([("ed25519", pk, b"m", sig),
                                ("no-such-scheme", pk, b"m", sig),
                                ("ed25519", pk, b"n", sig)])
    assert got == RT.verify_batch_mixed([("ed25519", pk, b"m", sig),
                                         ("no-such-scheme", pk, b"m", sig),
                                         ("ed25519", pk, b"n", sig)])
    assert got == [True, False, False]
    # an ECDSA group routes too (on the CPU below the crossover, to the
    # batched host engine): an off-curve key is a failed verify
    bad = [("secp256k1", b"\x04" * 65, b"m", sig)]
    assert C.verify_batch_mixed(bad) == RT.verify_batch_mixed(bad) == [False]


def test_config_fields_match_reference():
    ref = {f.name: f.default for f in dataclasses.fields(RC.ReplicaConfig)}
    for f in dataclasses.fields(PC.ReplicaConfig):
        assert f.name in ref, f.name
        if f.name not in ("crypto_backend", "extra"):
            assert f.default == ref[f.name], f.name
    cfg = PC.ReplicaConfig(f_val=1, c_val=0)
    rcfg = RC.ReplicaConfig(f_val=1, c_val=0)
    for prop in ("n_val", "slow_path_quorum", "fast_path_threshold_quorum",
                 "optimistic_fast_quorum"):
        assert getattr(cfg, prop) == getattr(rcfg, prop)
    cfg.validate()
    assert PC.ReplicaConfig.from_json(cfg.to_json()) == cfg


@pytest.mark.parametrize("n,agg", [(4, "off"), (15, "off"), (16, "off"),
                                   (4, "tree")])
def test_resolve_threshold_scheme_matches(n, agg):
    assert SYS.resolve_threshold_scheme("adaptive", n, aggregation=agg) == \
        RSYS.resolve_threshold_scheme("adaptive", n, aggregation=agg)


def test_bls_schemes_wait_for_their_slice():
    """The BLS slice has landed: both schemes register and get their CUDA
    verifiers (tests/test_torch_bls_systems.py holds them against the
    reference); "adaptive" still has to be resolved first."""
    SYS.register_builtin("threshold-bls")
    SYS.register_builtin("multisig-bls")
    assert isinstance(C.make_threshold_verifier("multisig-bls", 3, 4, None,
                                                []),
                      C.CudaBlsMultisigVerifier)
    assert isinstance(C.make_threshold_verifier("threshold-bls", 3, 4, None,
                                                []),
                      C.CudaBlsThresholdVerifier)
    with pytest.raises(ValueError, match="adaptive"):
        SYS.register_builtin("adaptive")


def test_unported_scheme_never_charges_the_device_breaker(both_keys):
    """A batch that holds an ECDSA principal (ported since; below the
    CPU's crossover its group verifies on the batched host engine) is a
    verify like any other: a bad ECDSA signature fails only itself,
    three such batches leave the breaker closed with no failure, and the
    next all-Ed25519 batch still rides the device."""
    ref, port = both_keys
    mixed_keys = dataclasses.replace(port.for_node(0),
                                     client_sig_scheme="secp256k1")
    sm = S.SigManager(mixed_keys, batch_fn=C.verify_batch_mixed,
                      device_min_batch=1, memo_capacity=0)
    replica_items = [it for it in _client_items(ref, n_items=16)
                     if it[0] in ref.replica_pubkeys]
    client = sorted(ref.client_pubkeys)[0]
    breaker = device_breaker()
    before = breaker.snapshot()
    want = RS.SigManager(ref.for_node(0)).verify_batch(replica_items)
    for j in range(breaker.failure_threshold):
        batch = replica_items + [(client, b"ecdsa-%d" % j, b"\0" * 64)]
        assert sm.verify_batch(batch) == want + [False]
    after = breaker.snapshot()
    assert after["failures"] == before["failures"]
    assert breaker.state == "closed"
    c = sm.metrics.snapshot()["counters"]
    n_batch = len(replica_items) + 1
    assert c["degraded_verifies"] == 0
    assert c["sigs_device_dispatched"] == breaker.failure_threshold * n_batch
    assert sm.verify_batch(replica_items) == want
    c = sm.metrics.snapshot()["counters"]
    assert c["sigs_device_dispatched"] == \
        breaker.failure_threshold * n_batch + len(replica_items)
    assert c["batched_verifies"] == c["sigs_device_dispatched"]
