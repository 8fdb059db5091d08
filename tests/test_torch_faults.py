"""Every device call site of the port that answers a lost device from the
host: a RuntimeError from the launch degrades there and is counted, while
a missing card (device.NoDevice), a kernel that does not build
(_build.BuildError) and a wrapper refusing its inputs (ValueError) raise
and are not counted.

Sites: the Merkle level hash (kvbc/sparse_merkle._hash_level), the
state-transfer window digests, CudaEd25519Verifier.verify_batch, each
device handler of CudaMultisigEd25519Verifier and SigManager.verify_batch.
The kernels are replaced by a function that raises the fault; "no card"
instead leaves them alone and makes torch report no CUDA device, with no
request for the CPU, so the port's own device resolution raises.
"""
import hashlib
from types import SimpleNamespace

import pytest
import torch

from tpubft_torch import device
from tpubft_torch.consensus import keys as K
from tpubft_torch.consensus import sig_manager as S
from tpubft_torch.crypto import cuda as C
from tpubft_torch.crypto import interfaces as I
from tpubft_torch.kvbc import sparse_merkle as SM
from tpubft_torch.ops import _build
from tpubft_torch.ops import ed25519 as ops
from tpubft_torch.ops import sha256 as sha
from tpubft_torch.ops.dispatch import device_breaker
from tpubft_torch.statetransfer import digests
from tpubft_torch.utils.config import ReplicaConfig

torch.set_num_threads(1)

SEED = b"torch-fault-sites"
FAULTS = {"no_card": None,
          "build_error": _build.BuildError("nvcc failed"),
          "value_error": ValueError("a_y must be int32"),
          "runtime_error": RuntimeError("device lost")}


@pytest.fixture(autouse=True)
def _clean():
    device.set_default_device("cpu")
    device_breaker().reset()
    SM.DEGRADED = 0
    digests.DEGRADED = 0
    yield
    device_breaker().reset()
    device.set_default_device(None)


@pytest.fixture(scope="module")
def cluster():
    cfg = ReplicaConfig(f_val=1, c_val=0, threshold_scheme="adaptive")
    ck = K.ClusterKeys.generate(cfg, num_clients=2, seed=SEED)
    cs = I.Cryptosystem("multisig-ed25519", threshold=3, num_signers=4,
                        seed=SEED)
    signers = {i: cs.create_threshold_signer(i) for i in range(1, 5)}
    jobs = []
    for j in range(2):
        d = bytes([j + 1]) * 32
        jobs.append((d, {i: signers[i].sign_share(d) for i in (1, 2, 3)}))
    return ck, cs, jobs


def _multisig(cs):
    return C.make_threshold_verifier("multisig-ed25519", 3, 4, cs.public_key,
                                     cs.share_public_keys)


def _sig_items(ck):
    from tpubft_torch.crypto.cpu import Ed25519Signer
    client = sorted(ck.client_pubkeys)[0]
    signer = Ed25519Signer.generate(
        seed=K._derive_seed(SEED, "client", client))
    return [(client, b"req-%d" % i, signer.sign(b"req-%d" % i))
            for i in range(4)]


def _site(name, cluster):
    """-> (call, expected result, degradation count read after the call)."""
    ck, cs, jobs = cluster
    if name == "hash_level":
        msgs = [b"\x01" + bytes([i % 256]) * 64
                for i in range(SM._DEVICE_THRESHOLD)]
        return (lambda: SM._hash_level(msgs, True),
                [hashlib.sha256(m).digest() for m in msgs],
                lambda: SM.DEGRADED)
    if name == "window_digests":
        raws = [bytes([i]) * (60 + 9 * i)
                for i in range(digests.DEVICE_DIGEST_THRESHOLD)]
        return (lambda: digests.window_digests(raws, use_device=True),
                [hashlib.sha256(r).digest() for r in raws],
                lambda: digests.DEGRADED)
    if name == "ed25519_verifier":
        items = _sig_items(ck)
        v = C.CudaEd25519Verifier(ck.client_pubkeys[items[0][0]])
        return (lambda: v.verify_batch([(d, s) for _, d, s in items]),
                [True] * len(items), lambda: v.degraded)
    if name == "sig_manager":
        sm = S.SigManager(ck.for_node(0), batch_fn=C.verify_batch_mixed,
                          device_min_batch=1, memo_capacity=0)
        items = _sig_items(ck)

        def degraded():
            c = sm.metrics.snapshot()["counters"]
            return c["degraded_verifies"]
        return lambda: sm.verify_batch(items), [True] * len(items), degraded
    pv = _multisig(cs)
    host = cs.create_threshold_verifier()
    if name == "multisig_combine_batch":
        return (lambda: pv.combine_batch(jobs), host.combine_batch(jobs),
                lambda: pv.degraded)
    certs = [(d, sig) for (d, _), (_, sig, _) in
             zip(jobs, host.combine_batch(jobs))]
    if name == "multisig_verify":
        return (lambda: pv.verify(*certs[0]), True, lambda: pv.degraded)
    if name == "multisig_verify_batch_certs":
        return (lambda: pv.verify_batch_certs(certs), [True, True],
                lambda: pv.degraded)
    if name == "multisig_verify_share_batch":
        d, shares = jobs[0]
        items = [(i, d, shares[i]) for i in (1, 2, 3)]
        return (lambda: pv.verify_share_batch(items), [True] * 3,
                lambda: pv.degraded)
    raise AssertionError(name)


SITES = ("hash_level", "window_digests", "ed25519_verifier", "sig_manager",
         "multisig_combine_batch", "multisig_verify",
         "multisig_verify_batch_certs", "multisig_verify_share_batch")


def _inject(monkeypatch, fault_name):
    if fault_name == "no_card":
        device.set_default_device(None)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        return
    fault = FAULTS[fault_name]

    def raising(*_a, **_k):
        raise fault
    monkeypatch.setattr(ops, "verify_kernel", raising)
    monkeypatch.setattr(sha, "sha256_kernel", raising)


@pytest.mark.parametrize("fault", tuple(FAULTS))
@pytest.mark.parametrize("site", SITES)
def test_device_call_site_degrades_only_on_device_loss(monkeypatch, cluster,
                                                       site, fault):
    call, want, degraded = _site(site, cluster)
    assert call() == want and degraded() == 0      # the device answers
    _inject(monkeypatch, fault)
    if fault == "runtime_error":
        assert call() == want          # the host answers, and it counts
        assert degraded() >= 1
        return
    expect = device.NoDevice if fault == "no_card" else \
        type(FAULTS[fault])
    with pytest.raises(expect):
        call()
    assert degraded() == 0


def test_no_card_is_a_runtime_error_that_names_the_way_out(monkeypatch):
    device.set_default_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="set_default_device"):
        device.default_device()
    with pytest.raises(device.NoDevice):
        device.resolve("cuda")
    assert device.resolve("cpu") == torch.device("cpu")


# ---- a ladder wrapper: bringup_cuda.fe_inv has no fallback ----

class _FailingLaunch:
    """A kernel library whose launch reports a CUDA error."""

    @staticmethod
    def fe_inv_launch(*_args):
        return 700

    @staticmethod
    def fe_inv_error_string(_err):
        return b"an illegal memory access was encountered"


@pytest.mark.parametrize("fault", ["cpu_tensor", "build_error",
                                   "launch_error"])
def test_fe_inv_wrapper_raises_and_does_not_count(monkeypatch, fault):
    """A CPU tensor is refused (the ladder routes it to the plain version),
    a failed build raises BuildError and a failed launch RuntimeError; none
    is answered by the plain version or counted as a launch. The build and
    launch faults get past the device check and the card's SM count by
    standing in for them, as no card is present here."""
    from tpubft_torch.ops import bringup_cuda as bu
    a = torch.zeros((bu.NL, 8), dtype=torch.int32)
    if fault != "cpu_tensor":
        monkeypatch.setattr(bu, "_lanes", lambda t: t.shape[1])
        monkeypatch.setattr(bu, "_stream", lambda _dev: 0)
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda _dev: SimpleNamespace(
                                multi_processor_count=132))
    if fault == "build_error":
        def no_nvcc(*_a, **_k):
            raise _build.BuildError("nvcc failed building fe_inv")
        bu.fe_inv_library.cache_clear()
        monkeypatch.setattr(bu._build, "load", no_nvcc)
    if fault == "launch_error":
        monkeypatch.setattr(bu, "fe_inv_library", lambda: _FailingLaunch)
    expect = {"cpu_tensor": ValueError, "build_error": _build.BuildError,
              "launch_error": RuntimeError}[fault]
    before = dict(bu.LAUNCHES), dict(bu.FE_INV_LANES)
    with pytest.raises(expect):
        bu.fe_inv(a)
    assert (bu.LAUNCHES, bu.FE_INV_LANES) == before
    if fault == "build_error":
        bu.fe_inv_library.cache_clear()     # drop nothing cached by the fault
