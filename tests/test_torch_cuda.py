"""The CUDA kernels of the port on a card: the verify kernel against the
plain PyTorch version and the host scalar engine, the field kernels
(fe_mul, and fe_inv in both of its designs) against Python ints, the SHA-256 kernel against hashlib and its plain
version, the bring-up kernels against theirs, the ECDSA kernels against
their plain versions and the host engine (and rlc_verify_batch's
bisection), a short config-1 replica cluster on the card, and an SKVBC ledger cluster (one write
through the durability pipeline, one catch-up by state transfer whose
windows go through the SHA-256 kernel), BASELINE config 5 over TLS
under a view-change storm, config 1 on the v4 engine with a
snapshot-provisioned replica, the read-only replica, whose fetched
windows go through the SHA-256 kernel, and the thin-replica read tier
over replica processes. Marked `cuda`; each test
skips where no card is present (run on the card:
python -m pytest --noconftest tests/test_torch_cuda.py).
"""
import hashlib
import time

import numpy as np
import pytest
import torch

from tpubft_torch import testing
from tpubft_torch.crypto import scalar
from tpubft_torch.ops import bringup_cuda as bu
from tpubft_torch.ops import ed25519 as ops
from tpubft_torch.ops import ed25519_cuda as kc
from tpubft_torch.ops import f25519 as F
from tpubft_torch.ops import sha256 as sha
from tpubft_torch.ops import sha256_cuda
from tpubft_torch.tools import bringup

# one intra-op thread: these tests run many tiny tensor ops, and several
# test workers share the host's cores
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("batch", [1, 3, 33, 100, 192, 1024])
def test_verify_kernel_matches_plain_and_scalar(card, batch):
    items = testing.ed25519_corpus(batch, seed=batch)
    prep = ops.prepare_batch(items)
    args = ops.to_tensors(ops._pad_rows(prep, batch, batch), card)
    before = kc.LAUNCHES["ed25519_verify"]
    got = ops.verify_kernel(*args).cpu().numpy()
    assert kc.LAUNCHES["ed25519_verify"] == before + 1
    assert np.array_equal(got, ops.plain_verify_kernel(*args).cpu().numpy())
    want = [scalar.ed25519_verify(pk, m, s) for m, s, pk in items]
    assert (got & prep.host_valid).tolist() == want
    assert ops.verify_batch(items, device=card).tolist() == want


def test_verify_kernel_on_raw_lanes(card):
    """y >= p for A or R, which the host never sends: the kernel's raw
    verdicts equal the plain version's."""
    arrays, want = testing.raw_kernel_lanes()
    args = ops.to_tensors(arrays, card)
    assert kc.verify(*args).cpu().tolist() == want
    assert ops.plain_verify_kernel(*args).cpu().tolist() == want


def test_copy_kernel_at_2p20_lanes(card):
    a = torch.randint(0, 1 << 26, (F.NL, 1 << 20), dtype=torch.int32,
                      device=card)
    assert torch.equal(bu.bringup_copy(a), bu.plain_copy(a))
    # a view one word in: not 16-byte aligned, the scalar path
    flat = torch.arange(F.NL * 1000 + 1, dtype=torch.int32, device=card)
    off = flat[1:].view(F.NL, 1000)
    assert torch.equal(bu.bringup_copy(off), bu.plain_copy(off))


def test_field_kernels_match_python_ints(card):
    rng = np.random.default_rng(0)
    va = [int.from_bytes(rng.bytes(32), "little") % F.P for _ in range(512)]
    vb = [int.from_bytes(rng.bytes(32), "little") % F.P for _ in range(512)]
    ta = torch.from_numpy(np.stack([F.int_to_limbs(v) for v in va], 1))
    tb = torch.from_numpy(np.stack([F.int_to_limbs(v) for v in vb], 1))
    mul = kc.fe_mul(ta.to(card), tb.to(card)).cpu().numpy()
    inv = bu.fe_inv(ta.to(card)).cpu().numpy()
    for i in range(512):
        assert np.array_equal(mul[:, i], F.int_to_limbs(va[i] * vb[i]))
        assert np.array_equal(inv[:, i],
                              F.int_to_limbs(pow(va[i], F.P - 2, F.P)))


@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("n", [1, 3, 33, 1024, 1 << 17])
def test_fe_inv_ragged_and_edges(card, n, lanes):
    """Both designs at ragged sizes (a partial group, warp and block), the
    edge cases 0, 1, 2, 19, p-1, (p-1)/2 first: every lane against
    Python ints up to 1024 (a strided sample of 257 above), and against
    the plain version on the first 1024."""
    from tpubft_torch.tools import fe_inv_probe
    a_np = fe_inv_probe.elements(n, seed=n)
    a = torch.from_numpy(a_np).to(card)
    before = bu.LAUNCHES["fe_inv"], bu.FE_INV_LANES[lanes]
    got = bu._fe_inv(a, lanes)
    assert (bu.LAUNCHES["fe_inv"], bu.FE_INV_LANES[lanes]) == (
        before[0] + 1, before[1] + 1)
    got_np = got.cpu().numpy()
    assert fe_inv_probe.sample_mismatches(
        a_np, got_np, samples=n if n <= 1024 else 257) == 0
    m = min(n, 1024)
    plain = bringup._plain_inv(a[:, :m].contiguous()).cpu().numpy()
    assert np.array_equal(got_np[:, :m], plain)


def test_fe_inv_lanes_rule_on_this_card(card):
    """The public wrapper runs four lanes an element up to 32 x SMs and one
    above, as the launcher reports it, and both designs agree."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    a = torch.from_numpy(bringup._rand_elems(np.random.default_rng(1),
                                             32 * sms + 1)).to(card)
    small, large = a[:, :32 * sms].contiguous(), a
    assert bu.lanes_for(small.shape[1], sms) == 4
    assert bu.lanes_for(large.shape[1], sms) == 1
    bu.reset_launches()
    got_small = bu.fe_inv(small)
    assert bu.FE_INV_LANES == {4: 1, 1: 0}
    got_large = bu.fe_inv(large)
    assert bu.FE_INV_LANES == {4: 1, 1: 1}
    assert torch.equal(got_small, bu._fe_inv(small, 1))
    assert torch.equal(got_large[:, :32 * sms], bu._fe_inv(small, 4))


def _sha_messages(batch, mixed):
    """Merkle nodes (65 bytes: every start residue mod 4 and 16), or
    lengths around the padding edges, up to 69 blocks at small batch."""
    rng = np.random.default_rng(batch)
    if not mixed:
        return [b"\x01" + rng.bytes(64) for _ in range(batch)]
    sizes = [0, 1, 55, 56, 63, 64, 119, 120, 300]
    if batch <= 1024:
        sizes.append(4400)
    return [rng.bytes(sizes[i % len(sizes)]) for i in range(batch)]


@pytest.mark.parametrize("mixed", [False, True], ids=["uniform", "mixed"])
@pytest.mark.parametrize("batch", [1, 3, 33, 64, 1024, 16384])
def test_sha256_kernel_matches_hashlib_and_plain(card, batch, mixed):
    msgs = _sha_messages(batch, mixed)
    blob, offsets = sha.pack(msgs)
    data, offs = sha.to_device(blob, offsets, card)
    assert data.data_ptr() % 4 == 0
    before = sha256_cuda.LAUNCHES["sha256"]
    got = sha.sha256_kernel(data, offs)
    assert sha256_cuda.LAUNCHES["sha256"] == before + 1
    assert torch.equal(got, sha.plain_sha256_raw(data, offs))
    want = [hashlib.sha256(m).digest() for m in msgs]
    raw = got.cpu().numpy().tobytes()
    assert [raw[i:i + 32] for i in range(0, len(raw), 32)] == want
    assert sha.sha256_batch_mixed(msgs, device=card) == want


@pytest.mark.parametrize("case", ["cpu", "dtype", "non_monotone",
                                  "wrong_end", "host_wrong_end"])
def test_sha256_wrapper_refuses_bad_offsets(card, case):
    blob, offsets = sha.pack(_sha_messages(33, True))
    data, offs = sha.to_device(blob, offsets, card)
    host = None
    if case == "cpu":
        offs = offs.cpu()
    elif case == "dtype":
        offs = offs.to(torch.int32)
    elif case == "non_monotone":
        offs = offs.clone()
        offs[[5, 6]] = offs[[6, 5]]
    elif case == "wrong_end":
        offs = offs.clone()
        offs[-1] -= 1
    else:
        host = offsets.copy()
        host[-1] -= 1
    before = sha256_cuda.LAUNCHES["sha256"]
    with pytest.raises(ValueError):
        sha256_cuda.sha256_raw(data, offs, host)
    assert sha256_cuda.LAUNCHES["sha256"] == before


@pytest.mark.parametrize("rung", [0, 1, 4])
def test_bringup_kernels_match_plain_and_ints(card, rung):
    before = dict(bu.LAUNCHES)
    r = bringup.RUNGS[rung](np.random.default_rng(rung), card, 1000)
    assert r.ok, r.report
    assert sum(bu.LAUNCHES.values()) == sum(before.values()) + 1


def test_table_gather_with_a_random_constant(card):
    rng = np.random.default_rng(5)
    a = torch.from_numpy(bringup._rand_elems(rng, 300)).to(card)
    col = torch.from_numpy(bringup._rand_elems(rng, 1)[:, 0].copy()).to(card)
    assert torch.equal(bu.fe_table_gather(a, col),
                       bu.plain_table_gather(a, col))


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity"])
def test_wrappers_refuse_bad_cuda_tensors(card, case):
    good = torch.zeros((F.NL, 64), dtype=torch.int32, device=card)
    bad = {"dtype": good.to(torch.int64), "shape": good[:12].contiguous(),
           "contiguity": good.t().contiguous().t()}[case]
    data = torch.zeros(256, dtype=torch.uint8, device=card)
    offsets = torch.tensor([0, 64, 128], dtype=torch.int64, device=card)
    bad_data = {"dtype": data.to(torch.int32)[:128],
                "shape": data.view(2, 128),
                "contiguity": data[::2]}[case]
    for call in (lambda: bu.bringup_copy(bad), lambda: bu.fe_carry(bad),
                 lambda: bu.fe_inv(bad),
                 lambda: bu.fe_table_gather(bad, good[:, 0].contiguous()),
                 lambda: sha256_cuda.sha256_raw(bad_data, offsets)):
        with pytest.raises(ValueError):
            call()


def test_sha256_roundtrip_refuses_bad_staging(card):
    """The host half's one-call round trip takes uint8 host buffers whose
    head holds batch+1 offsets; anything else raises before the card."""
    blob, offsets = sha.pack(_sha_messages(3, True))
    pinned = torch.empty(offsets.nbytes + len(blob), dtype=torch.uint8,
                         pin_memory=True)
    pinned[:offsets.nbytes] = torch.from_numpy(offsets.view(np.uint8))
    pinned[offsets.nbytes:] = torch.frombuffer(bytearray(blob),
                                               dtype=torch.uint8)
    out = torch.empty(96, dtype=torch.uint8, pin_memory=True)
    before = sha256_cuda.LAUNCHES["sha256"]
    for args in ((pinned.view(torch.int8), offsets.nbytes, out, 3),
                 (pinned.to(card), offsets.nbytes, out, 3),
                 (pinned, offsets.nbytes - 8, out, 3),         # short head
                 (pinned, offsets.nbytes, out[:64], 3)):       # short out
        with pytest.raises(ValueError):
            sha256_cuda.sha256_roundtrip(*args, card)
    assert sha256_cuda.LAUNCHES["sha256"] == before
    sha256_cuda.sha256_roundtrip(pinned, offsets.nbytes, out, 3, card)
    assert out.numpy().tobytes() == b"".join(
        hashlib.sha256(m).digest() for m in _sha_messages(3, True))
    assert sha256_cuda.LAUNCHES["sha256"] == before + 1


def test_replica_cluster_commits_on_the_card(card):
    """A short config-1 counter cluster on the card: 8 clients, 200
    writes, every batch on the device route (device_min_verify_batch=1),
    the verify kernel launched on the path and nothing degraded."""
    import threading

    from tpubft_torch.apps import counter
    from tpubft_torch.ops.dispatch import device_breaker
    from tpubft_torch.testing import InProcessCluster
    cfg = dict(durability_pipeline=False, autotune_enabled=False,
               crypto_backend="cuda", device_min_verify_batch=1)
    per_client, errors = 25, []
    cluster = InProcessCluster(f=1, num_clients=8, cfg_overrides=cfg)
    try:
        cluster.start()
        clients = [cluster.client(i) for i in range(8)]
        kc.reset_launches()
        failures = device_breaker().snapshot()["failures"]

        def drive(client):
            try:
                for _ in range(per_client):
                    client.send_write(counter.encode_add(1),
                                      timeout_ms=60000)
            except Exception as exc:  # noqa: BLE001 — asserted below
                errors.append(exc)
        threads = [threading.Thread(target=drive, args=(c,))
                   for c in clients]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not errors, errors
        reps = list(cluster.replicas.values())
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and any(
                h.value != 200 for h in cluster.handlers.values()):
            time.sleep(0.05)
        assert [h.value for h in cluster.handlers.values()] == [200] * 4
        assert kc.LAUNCHES["ed25519_verify"] > 0
        assert all(r.sig.degraded_verifies.value == 0 for r in reps)
        assert all(v.degraded == 0 for r in reps for v in (
            r.slow_verifier, r.thr_verifier, r.opt_verifier))
        assert device_breaker().snapshot()["failures"] == failures
    finally:
        cluster.stop()


def _skvbc_cluster_on_card(**overrides):
    from tpubft_torch.apps import skvbc
    from tpubft_torch.kvbc import KeyValueBlockchain
    from tpubft_torch.storage import MemoryDB
    from tpubft_torch.testing import InProcessCluster

    def handler(_r=None):
        return skvbc.SkvbcHandler(KeyValueBlockchain(MemoryDB()))
    cfg = dict(autotune_enabled=False, crypto_backend="cuda",
               device_min_verify_batch=1, **overrides)
    return InProcessCluster(f=1, num_clients=1, handler_factory=handler,
                            cfg_overrides=cfg)


def test_skvbc_write_commits_through_the_pipeline_on_the_card(card):
    """One SKVBC write on the card with the durability pipeline on: the
    verify kernel admits it, every replica lands the block through a
    group fsync, and nothing degrades."""
    from tpubft_torch.apps import skvbc
    from tpubft_torch.ops.dispatch import device_breaker
    cluster = _skvbc_cluster_on_card()
    try:
        cluster.start()
        kv = skvbc.SkvbcClient(cluster.client(0))
        kc.reset_launches()
        failures = device_breaker().snapshot()["failures"]
        assert kv.write([(b"card", b"1")], timeout_ms=60000).success
        deadline = time.monotonic() + 30
        reps = list(cluster.replicas.values())
        while time.monotonic() < deadline and not all(
                r.handler.blockchain.last_block_id == 1
                and r.durability.m_groups.value > 0 for r in reps):
            time.sleep(0.05)
        assert all(r.handler.blockchain.last_block_id == 1 for r in reps)
        assert all(r.durability.m_groups.value > 0 for r in reps)
        assert kc.LAUNCHES["ed25519_verify"] > 0
        assert all(r.sig.degraded_verifies.value == 0 for r in reps)
        assert device_breaker().snapshot()["failures"] == failures
        assert kv.read([b"card"], timeout_ms=60000) == {b"card": b"1"}
    finally:
        cluster.stop()


def test_catch_up_window_goes_through_the_sha256_kernel(card):
    """A replica restarted with empty state after the cluster moved past
    its work window fetches its ledger by state transfer; its windows of
    16 blocks or more are digested by the SHA-256 kernel (launches
    counted, none degraded or failed) and its head digest equals replica
    0's."""
    from tpubft_torch.apps import skvbc
    from tpubft_torch.statetransfer import digests
    cluster = _skvbc_cluster_on_card(checkpoint_window_size=5,
                                     work_window_size=10,
                                     fast_path_timeout_ms=150)
    degraded = digests.DEGRADED
    try:
        cluster.start()
        kv = skvbc.SkvbcClient(cluster.client(0))
        cluster.kill(3)
        n = 0
        while n < 20 or min(cluster.replicas[r].last_stable
                            for r in (0, 1, 2)) <= 10:
            assert kv.write([(b"k%d" % n, b"v")], timeout_ms=60000).success
            n += 1
        lagging_at = n
        sha256_cuda.reset_launches()
        cluster.restart(3)
        st = cluster.replicas[3].state_transfer
        deadline = time.monotonic() + 120
        while (st.metrics.snapshot()["counters"]["blocks_fetched"]
               < lagging_at or st.is_fetching):
            assert time.monotonic() < deadline, "no catch-up"
            assert kv.write([(b"k%d" % n, b"v")], timeout_ms=60000).success
            n += 1
        counters = st.metrics.snapshot()["counters"]
        assert counters["device_digest_batches"] > 0
        assert counters["device_digest_failures"] == 0
        assert sha256_cuda.LAUNCHES["sha256"] \
            >= counters["device_digest_batches"]
        assert digests.DEGRADED == degraded
        h0 = cluster.handlers[0].blockchain
        h3 = cluster.handlers[3].blockchain
        head = h3.last_block_id
        assert head >= 16 and h3.block_digest(head) == h0.block_digest(head)
    finally:
        cluster.stop()


# ---- BLS12-381 G1: the MSM kernel ----

def _bls_segments(s, k, seed):
    """s segments of up to k shares with Lagrange coefficients, and in
    every segment wide enough an identity slot (a None point), a zero
    scalar and one >= r; odd segments one share narrower (padding)."""
    import random

    from tpubft_torch.crypto import bls12381 as bls
    rng = random.Random(seed)
    base = [bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R))
            for _ in range(min(k, 16))]
    segs = []
    for j in range(s):
        width = k - (j % 2 if k > 1 else 0)
        pts = [base[(i + j) % len(base)] for i in range(width)]
        ks = bls.lagrange_coeffs_at_zero(list(range(1, width + 1)))
        if width >= 4:
            pts[1] = None
            ks[2] = 0
            ks[3] += bls.R
        segs.append((pts, ks))
    return segs


def _bls_edge_scalars():
    """Scalars at the edges of the kernel's signing and GLV split: r - 1,
    r - 10, lambda - 1, lambda, lambda + 1, 2^128, one with k2 = 0 and one
    with k1 = 0, (r -+ 1) / 2 and small ones."""
    from tpubft_torch.crypto import bls12381 as bls
    from tpubft_torch.ops import bls12_381_cuda as bc
    lam, r = bc.GLV_LAMBDA, bls.R
    return [r - 1, r - 10, lam - 1, lam, lam + 1, 1 << 128,
            0x123456789ABCDEF00FEDCBA987654321, 12345 * lam, (r - 1) // 2,
            (r + 1) // 2, 1, 8, 16]


def _bls_edge_segments():
    """A segment a edge scalar: P at k, Q and -Q at k (they cancel), a
    third point at 7; and an all-identity segment."""
    import random

    from tpubft_torch.crypto import bls12381 as bls
    rng = random.Random(21)
    segs = []
    for k in _bls_edge_scalars():
        p, q, o = (bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R))
                   for _ in range(3))
        segs.append(([p, q, bls.g1_neg(q), o], [k, k, k, 7]))
    segs.append(([None, None, None, None], [1, 2, 3, 4]))
    return segs


@pytest.mark.parametrize("shape", [(1, 1), (1, 5), (64, 5), (1, 667),
                                   (3, 7)])
def test_bls_msm_kernel_matches_plain_and_host(card, shape):
    from tpubft_torch.crypto import bls12381 as bls
    from tpubft_torch.ops import bls12_381 as B
    from tpubft_torch.ops import bls12_381_cuda as bc
    segs = _bls_segments(*shape, seed=shape[0] * 1000 + shape[1])
    args = B.to_tensors(B.prepare_msm_batch(segs), card)
    before = bc.LAUNCHES["bls_msm"]
    got = [t.cpu().numpy() for t in B.msm_batch_kernel(*args)]
    assert bc.LAUNCHES["bls_msm"] == before + 1
    plain = [t.cpu().numpy() for t in B.plain_msm_batch_kernel(*args)]

    def affine(xyz):
        return [B._to_affine_host(*(c[:, j] for c in xyz))
                for j in range(xyz[0].shape[1])]
    want = [bls.g1_msm([p for p in pts if p is not None],
                       [x for p, x in zip(pts, ks) if p is not None])
            for pts, ks in segs]
    assert affine(got) == affine(plain) == want
    assert B.msm_batch(segs, device=card) == want
    if shape == (1, 5):
        # the edge scalars, one segment each, and an all-identity one
        edge = _bls_edge_segments()
        want = [bls.g1_msm([p for p in pts if p is not None],
                           [x for p, x in zip(pts, ks) if p is not None])
                for pts, ks in edge]
        assert want[-1] is None
        eargs = B.to_tensors(B.prepare_msm_batch(edge), card)
        got = [t.cpu().numpy() for t in B.msm_batch_kernel(*eargs)]
        plain = [t.cpu().numpy() for t in B.plain_msm_batch_kernel(*eargs)]
        assert affine(got) == affine(plain) == want


def test_bls_scalar_mul_kernel_matches_plain_and_host(card):
    from tpubft_torch.crypto import bls12381 as bls
    from tpubft_torch.ops import bls12_381 as B
    from tpubft_torch.ops import bls12_381_cuda as bc
    pts, ks = _bls_segments(1, 667, seed=8)[0]
    # the edge scalars on lanes 4.. (lanes 1-3: a None point, a zero
    # scalar, one >= r)
    edge = _bls_edge_scalars()
    ks[4:4 + len(edge)] = edge
    args = B.to_tensors(B._prep_msm(pts, ks), card)
    before = bc.LAUNCHES["bls_mul"]
    got = [t.cpu().numpy() for t in B.scalar_mul_kernel(*args)]
    assert bc.LAUNCHES["bls_mul"] == before + 1
    plain = [t.cpu().numpy() for t in B.plain_scalar_mul_kernel(*args)]

    def affine(xyz):
        return [B._to_affine_host(*(c[:, i] for c in xyz))
                for i in range(len(pts))]
    assert affine(got) == affine(plain)
    want = [None if p is None else bls.g1_mul(p, x) for p, x in zip(pts, ks)]
    assert B.batch_scalar_mul(pts, ks, device=card) == want


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity"])
def test_bls_wrappers_refuse_bad_cuda_tensors(card, case):
    from tpubft_torch.ops import bls12_381_cuda as bc
    words = torch.zeros((8, 2, 4), dtype=torch.int64, device=card)
    px = torch.zeros((12, 2, 4), dtype=torch.int64, device=card)
    inf = torch.ones((2, 4), dtype=torch.bool, device=card)
    bad = {"dtype": px.to(torch.int32), "shape": px[:11].contiguous(),
           "contiguity": px.transpose(1, 2).contiguous().transpose(1, 2)
           }[case]
    before = dict(bc.LAUNCHES)
    for call in (lambda: bc.msm(words, bad, px, inf),
                 lambda: bc.scalar_mul(words[:, 0].contiguous(),
                                       bad[:, 0], px[:, 0].contiguous(),
                                       inf[0].contiguous())):
        with pytest.raises(ValueError):
            call()
    assert bc.LAUNCHES == before


def test_bls_threshold_flush_on_the_card(card, monkeypatch):
    """CudaBlsThresholdVerifier.combine_batch at the crossover the flush
    clears (320 shares > 128): one bls_msm launch, certificates equal to
    the host classes', a bad share identified."""
    from tpubft_torch.crypto import cuda as CC
    from tpubft_torch.crypto.interfaces import Cryptosystem
    from tpubft_torch.ops import bls12_381_cuda as bc
    cs = Cryptosystem("threshold-bls", 5, 7, seed=b"card-flush")
    signers = [cs.create_threshold_signer(i) for i in range(1, 8)]
    jobs = []
    for j in range(64):
        d = j.to_bytes(32, "big")
        jobs.append((d, {i + 1: signers[i].sign_share(d)
                         for i in range(j % 3, j % 3 + 5)}))
    first = next(iter(jobs[5][1]))
    jobs[5][1][first] = signers[first - 1].sign_share(b"other")
    v = CC.make_threshold_verifier("threshold-bls", 5, 7, cs.public_key,
                                   cs.share_public_keys)
    bc.reset_launches()
    got = v.combine_batch(jobs)
    assert bc.LAUNCHES["bls_msm"] == 1 and v.device_combines == 1
    assert got == cs.create_threshold_verifier().combine_batch(jobs)
    assert [ok for ok, _, _ in got].count(False) == 1


# ---- ECDSA (ops/csrc/ecdsa.cu) ----

@pytest.mark.parametrize("curve", ["secp256k1", "secp256r1"])
@pytest.mark.parametrize("batch", [1, 33, 128])
def test_ecdsa_kernels_match_plain_and_host(card, curve, batch):
    """tools/ecdsa_probe.measure: the fold word for word against its plain
    version on a batch with a forged lane and the wrap lanes, the clean
    lanes' fold 0, the per-item verify's verdicts and x against its
    plain version and the host engine."""
    from tpubft_torch.tools import ecdsa_probe
    row = ecdsa_probe.measure(curve, batch, card, seed=batch, reps=1,
                              forged=(batch // 2,))
    assert ecdsa_probe.problems(row) == []
    assert row["fold_nonzero"] and not row["clean_nonzero"]


@pytest.mark.parametrize("curve", ["secp256k1", "secp256r1"])
def test_ecdsa_rlc_verify_batch_bisects_on_the_card(card, curve):
    """rlc_verify_batch on the card: one launch for a clean batch, the
    bisection's launches for forged items, verdicts of the host engine;
    verify_batch (one launch) the same verdicts."""
    from tpubft_torch.ops import ecdsa as E
    from tpubft_torch.ops import ecdsa_cuda as ec
    items = testing.ecdsa_corpus(curve, 40, seed=9, forged=(3, 30))
    want = scalar.ecdsa_verify_batch([(pk, m, s) for m, s, pk in items],
                                     curve)
    ec.reset_launches()
    E.reset_counts()
    clean = [it for it, ok in zip(items, want) if ok]
    assert E.rlc_verify_batch(curve, clean, device=card).all()
    assert ec.LAUNCHES["ecdsa_rlc"] == 1
    assert E.rlc_verify_batch(curve, items, device=card).tolist() == want
    assert ec.LAUNCHES["ecdsa_rlc"] == E.COUNTS[curve]["rlc_launches"] > 3
    assert E.verify_batch(curve, items, device=card).tolist() == want
    assert ec.LAUNCHES["ecdsa_verify"] == 1


@pytest.mark.parametrize("batch", [1, 3, 40])
def test_ecdsa_inputs_cross_to_the_card_in_one_copy(card, batch):
    """ops/ecdsa.to_tensors on the card: the RLC kernel's nine inputs are
    views of one device buffer (one copy), each contiguous, of its dtype
    and shape, and equal to the CPU path's tensors."""
    from tpubft_torch.ops import ecdsa as E
    items = testing.ecdsa_corpus("secp256r1", batch, seed=batch)
    prep = E.prepare_rlc_batch("secp256r1", items)
    cols = E.rlc_columns(prep, range(batch))
    got = E.to_tensors(cols, card)
    want = E.to_tensors(cols, torch.device("cpu"))
    assert len({t.untyped_storage().data_ptr() for t in got}) == 1
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.is_contiguous()
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("curve", ["secp256k1", "secp256r1"])
def test_ecdsa_kernels_on_exceptional_lanes(card, curve):
    """testing.ecdsa_exceptional_lanes on the card (P = Q and P = -Q in
    the join, u1 = 0, u2 = 0): verdicts and x as the host's integers say
    and as verify_plain gives them, the fold word for word equal to
    rlc_fold_plain's and 0 over the accepted lanes alone."""
    from tpubft_torch.ops import ecdsa as E
    from tpubft_torch.ops import ecdsa_cuda as ec
    vcols, rcols, want, xs = testing.ecdsa_exceptional_lanes(curve)
    vargs = E.to_tensors(vcols, card)
    ok, x = (t.cpu() for t in ec.verify(curve, *vargs))
    pok, px = (t.cpu() for t in E.verify_plain(curve, *vargs))
    assert ok.tolist() == pok.tolist() == want
    assert torch.equal(x, px)
    assert [E.int_of(x[:, i].numpy()) for i in range(len(xs))] == xs
    rargs = E.to_tensors(rcols, card)
    fold = ec.rlc(curve, *rargs).cpu()
    assert torch.equal(fold, E.rlc_fold_plain(curve, *rargs).cpu())
    assert fold.any()
    acc = [i for i, w in enumerate(want) if w]
    assert not ec.rlc(curve, *E.to_tensors(
        tuple(c[..., acc] for c in rcols), card)).cpu().any()


def test_ecdsa_probe_reads_cycles(card):
    """The clock64 probe of ecdsa.cu: every step a positive number of
    cycles, a doubling and an addition more than a product, a pair of
    products less than two."""
    from tpubft_torch.ops import ecdsa_cuda as ec
    for curve in ("secp256k1", "secp256r1"):
        p = ec.probe(curve, card)
        assert all(v > 0 for k, v in p.items() if k.startswith("cycles"))
        assert p["cycles_per_dbl"] > p["cycles_per_field_mul"]
        assert p["cycles_per_add"] > p["cycles_per_dbl"]
        assert p["cycles_per_mul_pair"] < 2 * p["cycles_per_field_mul"]


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "mask"])
def test_ecdsa_wrappers_refuse_bad_cuda_tensors(card, case):
    from tpubft_torch.ops import ecdsa_cuda as ec
    w = torch.zeros((8, 4), dtype=torch.int32, device=card)
    m = torch.ones(4, dtype=torch.bool, device=card)
    bad = {"dtype": w.long(), "shape": w[:7].contiguous(),
           "contiguity": torch.zeros((4, 8), dtype=torch.int32,
                                     device=card).t(),
           "mask": m.int()}[case]
    before = dict(ec.LAUNCHES)
    args = [w] * 6 + [m, m, w]
    args[6 if case == "mask" else 2] = bad
    with pytest.raises(ValueError):
        ec.rlc("secp256k1", *args)
    if case != "mask":
        with pytest.raises(ValueError):
            ec.verify("secp256k1", w, w, bad, w, w, w)
    assert ec.LAUNCHES == before


# ---- the mesh tier on one card (parallel/sharding.py) ----

@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (64, 4), (3, 17)])
def test_bls_msm_combine_matches_plain(card, shape):
    """bls_msm_combine against its plain version on D partial points a
    segment (the MSM kernel's own outputs, one an identity column where
    a segment is all None)."""
    from tpubft_torch.ops import bls12_381 as B
    from tpubft_torch.ops import bls12_381_cuda as bc
    s, d = shape
    parts = []
    for j in range(d):
        segs = _bls_segments(s, 3, seed=7 * j + s)
        if j == 1:
            segs[0] = ([None, None, None], [1, 2, 3])
        parts.append(B.msm_batch_kernel(
            *B.to_tensors(B.prepare_msm_batch(segs), card)))
    x, y, z = (torch.stack([p[c] for p in parts], -1).contiguous()
               for c in range(3))
    before = bc.LAUNCHES["bls_msm_combine"]
    got = [t.cpu().numpy() for t in bc.combine(x, y, z)]
    assert bc.LAUNCHES["bls_msm_combine"] == before + 1
    plain = [t.cpu().numpy() for t in B.plain_combine(x, y, z)]

    def affine(xyz):
        return [B._to_affine_host(*(c[:, j] for c in xyz))
                for j in range(xyz[0].shape[1])]
    assert affine(got) == affine(plain)


def test_slot_streams_on_one_card_match_the_one_slot_route(card):
    """Four virtual slots on cuda:0, each launching on its own stream:
    the verify, digest, MSM and RLC routes give the one-slot route's
    answers, with one launch a slot and one combine."""
    from tpubft_torch.crypto import bls12381 as bls
    from tpubft_torch.ops import bls12_381 as B
    from tpubft_torch.ops import bls12_381_cuda as bc
    from tpubft_torch.ops import ecdsa as E
    from tpubft_torch.ops import ecdsa_cuda as ec
    from tpubft_torch.parallel import sharding
    items = testing.ed25519_corpus(256, seed=5)
    msgs = _sha_messages(256, True)
    segs = _bls_segments(1, 64, seed=64)
    eitems = testing.ecdsa_corpus("secp256k1", 128, seed=2, forged=(3, 77))
    one = (ops.verify_batch(items), sha.sha256_batch_mixed(msgs),
           B.msm(*segs[0]), E.rlc_verify_batch("secp256k1", eitems))
    sharding.set_virtual_devices(4, card)
    try:
        assert sharding.mesh_manager().plan().n == 4
        launches = dict(kc.LAUNCHES, **sha256_cuda.LAUNCHES, **bc.LAUNCHES,
                        **ec.LAUNCHES)
        four = (ops.verify_batch(items), sha.sha256_batch_mixed(msgs),
                B.msm(*segs[0]), E.rlc_verify_batch("secp256k1", eitems))
        after = dict(kc.LAUNCHES, **sha256_cuda.LAUNCHES, **bc.LAUNCHES,
                     **ec.LAUNCHES)
    finally:
        sharding.set_virtual_devices(None)
    assert four[0].tolist() == one[0].tolist()
    assert four[1] == one[1] and four[2] == one[2] \
        == bls.g1_msm(*segs[0])
    assert four[3].tolist() == one[3].tolist()
    delta = {k: after[k] - launches[k] for k in after}
    assert delta["ed25519_verify"] == 4 and delta["sha256"] == 4
    assert delta["bls_msm"] == 4 and delta["bls_msm_combine"] == 1
    assert delta["ecdsa_rlc"] >= 4


def test_process_cluster_on_the_card(card):
    """Four replica OS processes (apps/skvbc_replica through
    testing.BftTestNetwork) on the card over UDP: writes commit, replica
    3 is killed and restarted with empty state and catches up by state
    transfer under load; every process launched the verify kernel
    (device_min_verify_batch 1 sends every batch there), the restarted
    one the SHA-256 kernel, and none degraded."""
    import json
    import threading

    from tpubft_torch.testing.network import BftTestNetwork
    net = BftTestNetwork(f=1, num_clients=4, seed="card-procs",
                         device="cuda", checkpoint_window=5,
                         work_window=10, device_min_verify_batch=1)

    def load(tag, per_client=4):
        errors = []

        def work(i):
            try:
                kv = net.skvbc_client(i)
                for j in range(per_client):
                    assert kv.write([(b"%s-%d-%d" % (tag, i, j), b"v")],
                                    timeout_ms=30000).success
            except Exception as exc:  # noqa: BLE001 — asserted below
                errors.append(exc)
        ts = [threading.Thread(target=work, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errors, errors

    def status(r, name):
        return json.loads(net.status(r, name))
    try:
        net.start_all(timeout=180)
        load(b"a")
        before = status(3, "device")["launches"]
        assert before["ed25519_verify"] > 0
        net.kill_replica(3)
        load(b"b", per_client=8)
        net.start_replica(3)
        deadline = time.monotonic() + 120
        rounds = 0
        while not (net.metrics(3).get("state_transfer", "counters",
                                      "blocks_fetched") or 0):
            assert time.monotonic() < deadline
            load(b"c%d" % rounds, per_client=1)
            rounds += 1
        net.wait_for(lambda: len({net.last_executed(r)
                                  for r in range(4)}) == 1, timeout=60)
        for r in range(4):
            dev = status(r, "device")
            assert dev["device"].startswith("cuda")
            assert dev["launches"]["ed25519_verify"] > 0, (r, dev)
            sig = net.metrics(r).get("signature_manager", "counters",
                                     "degraded_verifies")
            assert sig == 0
        assert status(3, "device")["launches"]["sha256"] > 0
    finally:
        net.stop_all()


def test_config5_storm_on_the_card(card):
    """BASELINE config 5 (P-256 clients, threshold-BLS, TLS) on four
    replica processes on the card under a view-change storm
    (tests/test_torch_processes.config5_storm)."""
    # the tests directory is on sys.path (no __init__.py): imported by
    # its module name, as pytest imported it
    from test_torch_processes import config5_storm
    config5_storm("cuda")


def test_thin_replica_stream_over_card_processes(card, tmp_path):
    """The thin-replica read tier over four replica processes on the card
    (tests/test_torch_processes.thin_replica_check): every acknowledged
    write streamed at its block with no gap, the data source SIGKILLed
    and rotated away from, anchored verified reads; the verify kernel
    launched in every process and the SHA-256 kernel in the restarted
    one."""
    from test_torch_processes import thin_replica_check
    devices = thin_replica_check("cuda", str(tmp_path))
    for r, dev in devices.items():
        assert dev["device"].startswith("cuda"), (r, dev)
        assert dev["launches"]["ed25519_verify"] > 0, (r, dev)
    assert devices[3]["launches"]["sha256"] > 0, devices[3]


def test_persistent_cluster_on_the_card(card):
    """chip_smoke.py's persistent_cluster phase, with all its checks, at a
    smaller size: four replica processes on the card on their own kvlog
    files (BftTestNetwork(db_dir=...)); replica 3 SIGKILLed and
    restarted on its file (back at its last_executed, caught up by state
    transfer through the SHA-256 kernel, no block it kept fetched), the
    whole cluster SIGKILLed and restarted (every acknowledged write read
    back, more writes commit), equal blocks in the four files, the verify
    kernel launched and nothing degraded; beside them an ro_replica
    process on the card digests its fetched windows with the SHA-256
    kernel, archives over SigV4 an archive equal to replica 0's file,
    and answers a signed read (not a forged one). With pre-execution on:
    40 pre-executed writes and the conflict triple before replica 3's
    SIGKILL, the verify kernel launched during that step."""
    out = _chip_smoke().phase_persistent_cluster(
        torch, card, clients=8, target=120, reads=40, more=40,
        preexec_writes=40, checkpoint_window=10, work_window=20,
        min_anchor=20, budget_s=300)
    pre = out["preexec"]
    assert pre["triple"] == [True, True, False] and pre["expired"] == 0
    assert pre["total"]["agreed"] >= pre["writes_sent"] >= 43
    assert pre["total"]["verify_launches"] > 0
    assert out["restart_one"]["first_read_last_executed"] == \
        out["restart_one"]["last_executed_before_kill"] > 0
    assert out["verify_launches"] > 0 and out["sha256_launches"] > 0
    ro = out["ro_replica"]
    assert ro["device_digest_batches"] > 0
    assert ro["sha256_launches"] >= ro["device_digest_batches"]
    assert ro["audit"]["failures"] == 0 and ro["audit"]["verified"] > 0
    assert ro["audit"]["read_equal_to_acknowledged"]


def _chip_smoke():
    """chip_smoke.py, imported from the checkout's root."""
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_v4_cluster_on_the_card(card):
    """chip_smoke.py's v4_cluster phase, with all its checks, at a smaller
    size: four --kvbc-version v4 replica processes on the card on their
    kvlog files, every one launching the verify kernel; replica 3
    SIGKILLed, provisioned by the snapshot CLI and restarted, catching up
    on the gap alone through the SHA-256 kernel; equal v4 chains in the
    four files."""
    out = _chip_smoke().phase_v4_cluster(
        torch, card, clients=8, target=120, reads=40, checkpoint_window=10,
        work_window=20, budget_s=300)
    assert all(n > 0 for n in out["verify_launches_by_process"].values())
    assert out["snapshot"]["digest_ok"] is True
    assert 0 < out["restart"]["blocks_fetched"] <= out["restart"][
        "gap_blocks"]
    assert out["sha256_launches"] > 0


def test_ro_replica_window_digests_launch_sha256(card):
    """An in-process read-only replica on the card (device=card) joining
    a config-1 SKVBC cluster on the card 40 blocks in: its fetched
    windows of 16 blocks go through the SHA-256 kernel (launches counted, no device digest
    failure), and every archived digest equals hashlib's of the archived
    block, which equals replica 0's."""
    from tpubft_torch.apps import skvbc
    from tpubft_torch.kvbc.readonly import (ReadOnlyReplica, archive_key,
                                            digest_key)
    from tpubft_torch.statetransfer.manager import StConfig
    from tpubft_torch.storage.objectstore import InMemoryObjectStore
    from tpubft_torch.utils.config import ReplicaConfig
    windows = dict(checkpoint_window_size=10, work_window_size=20,
                   fast_path_timeout_ms=150)
    cluster = _skvbc_cluster_on_card(num_ro_replicas=1, **windows)
    store = InMemoryObjectStore()
    ro = None
    try:
        cluster.start()
        ro_cfg = ReplicaConfig(replica_id=cluster.n, f_val=1,
                               num_of_client_proxies=1, num_ro_replicas=1,
                               **windows)
        ro = ReadOnlyReplica(ro_cfg, cluster.keys.for_node(cluster.n),
                             cluster.bus.create(cluster.n),
                             object_store=store,
                             st_cfg=StConfig(retry_timeout_s=1.0),
                             device=card)
        assert ro.state_transfer._use_device
        kv = skvbc.SkvbcClient(cluster.client(0))
        # 40 blocks before the RO joins: its first transfer spans full
        # windows of 16
        for n in range(40):
            assert kv.write([(b"k%d" % n, b"v%d" % n)],
                            timeout_ms=60000).success
        sha256_cuda.library()       # built before the transfer needs it
        sha256_cuda.reset_launches()
        ro.start()
        n = 40
        deadline = time.monotonic() + 120
        while ro.archived_to < 48:
            assert time.monotonic() < deadline, ro.archived_to
            assert kv.write([(b"k%d" % n, b"v%d" % n)],
                            timeout_ms=60000).success
            n += 1
        counters = ro.state_transfer.metrics.snapshot()["counters"]
        assert counters["device_digest_batches"] > 0
        assert counters["device_digest_failures"] == 0
        assert sha256_cuda.LAUNCHES["sha256"] >= \
            counters["device_digest_batches"]
        h0 = cluster.handlers[0].blockchain
        for b in range(1, ro.archived_to + 1):
            raw = store.get(archive_key(b))
            assert raw == h0.get_raw_block(b)
            assert store.get(digest_key(b)) == \
                hashlib.sha256(raw).digest() == h0.block_digest(b)
    finally:
        if ro is not None:
            ro.stop()
        cluster.stop()
