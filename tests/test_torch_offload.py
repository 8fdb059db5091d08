"""The port's verified crypto-offload tier (tpubft_torch/offload/) against
the reference's (tpubft/offload/).

Parity: the lease frames are the reference's bytes and both decoders
refuse the same malformed inputs; `HelperServer.handle` gives the
reference's responses under every strategy; the port's pool leases to a
reference helper (in process and over TCP) and a reference pool to a
port helper. Then the port's counterparts of the reference's helper
fault matrix (tests/test_offload_plane.py): an honest lease is verified
and identical, a liar costs one local re-run and is quarantined, a stale
replay fails only its own lease, quarantine ends only with
`operator_reset`, slow-loris is sick and not Byzantine, a crash degrades
to local, a retry lands on the second helper, the in-flight cap holds, a
disabled pool never leases, and the verifiers' certificates and
SigManager's ECDSA verdicts are byte-equal with offload off, honest and
lying. ECDSA runs the plain RLC fold on the CPU (about 3 s a launch), so
its corpus is three items.
"""
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tpubft.crypto import bls12381 as ref_bls
from tpubft.offload import helper as ref_helper
from tpubft.offload import pool as ref_pool
from tpubft.offload import protocol as ref_proto
from tpubft_torch import device
from tpubft_torch.crypto import bls12381 as bls
from tpubft_torch.crypto import cpu
from tpubft_torch.crypto import cuda as crypto_cuda
from tpubft_torch.crypto.interfaces import Cryptosystem
from tpubft_torch.offload import helper as port_helper
from tpubft_torch.offload import pool as port_pool
from tpubft_torch.offload import protocol as port_proto
from tpubft_torch.offload.helper import HelperServer
from tpubft_torch.offload.pool import (InprocHelper, combine_via_offload,
                                       ecdsa_via_offload, get_offload_pool,
                                       reset_offload_pool, sum_via_offload)
from tpubft_torch.utils.breaker import CLOSED, OPEN, BreakerOpen, get_breaker

torch.set_num_threads(1)
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True)
def _clean():
    device.set_default_device("cpu")
    crypto_cuda.set_ecdsa_crossover(None)
    reset_offload_pool()
    ref_pool.reset_offload_pool()
    yield
    reset_offload_pool()
    ref_pool.reset_offload_pool()
    crypto_cuda.set_ecdsa_crossover(None)
    device.set_default_device(None)


def _pool_with(*servers, timeout_ms=30000):
    pool = get_offload_pool()
    pool.configure(enabled=True, lease_timeout_ms=timeout_ms,
                   max_inflight=4)
    for s in servers:
        pool.add_helper(InprocHelper(s.helper_id, s))
    return pool


# ---------------------------------------------------------------------
# shared material: 3-of-4 threshold BLS, 3-of-4 multisig BLS, ECDSA
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def thr():
    return Cryptosystem("threshold-bls", 3, 4, seed=b"offload-fault")


@pytest.fixture(scope="module")
def ms():
    return Cryptosystem("multisig-bls", 3, 4, seed=b"offload-ms")


def _combine_job(thr, digest, sids=(1, 2, 3)):
    pts = {sid: bls.g1_decompress(
        thr.create_threshold_signer(sid).sign_share(digest))
        for sid in sids}
    ids = sorted(pts)
    return [(ids, [pts[i] for i in ids])], [digest]


def _counted_local(segments):
    calls = []

    def local_fn():
        calls.append(1)
        return [bls.combine_shares(ids, pts) if ids else None
                for ids, pts in segments]
    return local_fn, calls


def _ms_verifier(ms):
    return crypto_cuda.make_threshold_verifier(
        "multisig-bls", 3, 4, ms.public_key, ms.share_public_keys)


def _sum_job(ms, digest, sids=(1, 2, 4)):
    pts = [bls.g1_decompress(
        ms.create_threshold_signer(sid).sign_share(digest)[:48])
        for sid in sids]
    return _ms_verifier(ms), [pts], [(digest, tuple(sids))]


def _counted_sum_local(segments):
    calls = []

    def local_fn():
        calls.append(1)
        out = []
        for pts in segments:
            acc = pts[0]
            for p in pts[1:]:
                acc = bls.g1_add(acc, p)
            out.append(acc)
        return out
    return local_fn, calls


CURVE = "secp256k1"


@pytest.fixture(scope="module")
def ecdsa():
    """Three items, the first forged: the plain RLC fold (offload off)
    takes three launches, the bisection's least for a mixed vector. The
    offload-off verdicts are SigManager's batch entry on the RLC path,
    which the reference's host engine confirms."""
    from tpubft.crypto import scalar as ref_scalar
    device.set_default_device("cpu")
    s1 = cpu.EcdsaSigner.generate(CURVE, seed=b"off-1")
    s2 = cpu.EcdsaSigner.generate(CURVE, seed=b"off-2")
    items = []
    for i in range(3):
        signer = s1 if i % 2 else s2
        m = b"off-msg-%d" % i
        items.append((m, signer.sign(m), signer.public_bytes()))
    items[0] = (b"forged", items[0][1], items[0][2])
    mixed = [("ecdsa-secp256k1", pk, d, s) for d, s, pk in items]
    crypto_cuda.set_ecdsa_crossover(1)
    from tpubft_torch.ops import ecdsa as ops_ecdsa
    ops_ecdsa.reset_counts()
    want = crypto_cuda.verify_batch_mixed(mixed)
    off_launches = ops_ecdsa.COUNTS[CURVE]["rlc_launches"]
    crypto_cuda.set_ecdsa_crossover(None)
    assert want == [False, True, True]
    assert want == ref_scalar.ecdsa_verify_batch(
        [(pk, d, s) for d, s, pk in items], CURVE)
    assert off_launches == 3
    return items, mixed, want


def _memo_local(want):
    calls = []

    def local_fn():
        calls.append(1)
        return list(want)
    return local_fn, calls


# ---------------------------------------------------------------------
# the wire: frames, encoders, decoders
# ---------------------------------------------------------------------
def _points(seed, n):
    rng = np.random.default_rng(seed)
    return [bls.g1_compress(bls.hash_to_g1(rng.bytes(16))) for _ in range(n)]


def _encodings(seed):
    rng = np.random.default_rng(seed)
    segs = [(sorted(rng.choice(1000, size=k, replace=False).tolist()),
             _points(seed * 10 + j, k))
            for j, k in enumerate(rng.integers(0, 4, size=3))]
    items = [(rng.bytes(32), rng.bytes(int(rng.integers(0, 80))),
              rng.bytes(int(rng.integers(0, 66)))) for _ in range(4)]
    bits = rng.integers(0, 2, size=6).astype(bool).tolist()
    lease, dl = int(rng.integers(0, 1 << 63)), int(rng.integers(0, 1 << 31))
    return [
        ("request", lambda P: P.encode_request(lease, P.KIND_BLS_SUM, dl,
                                               rng.bytes(0) + b"pl")),
        ("response", lambda P: P.encode_response(lease, P.ST_ERR, b"x")),
        ("segments", lambda P: P.encode_bls_segments(segs)),
        ("points", lambda P: P.encode_points([p for _, ps in segs
                                              for p in ps])),
        ("ecdsa_k1", lambda P: P.encode_ecdsa_items("secp256k1", items)),
        ("ecdsa_r1", lambda P: P.encode_ecdsa_items("secp256r1", items)),
        ("verdicts", lambda P: P.encode_verdicts(bits))]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_encoders_give_the_reference_bytes(seed):
    for name, enc in _encodings(seed):
        assert enc(port_proto) == enc(ref_proto), name
    for const in ("MAX_FRAME", "KIND_BLS_COMBINE", "KIND_BLS_SUM",
                  "KIND_ECDSA_RLC", "KIND_NAMES", "ST_OK", "ST_ERR",
                  "G1_LEN", "_CURVE_IDS"):
        assert getattr(port_proto, const) == getattr(ref_proto, const)


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — the class is the outcome
        return ("raise", type(e).__name__)


def _malformed(seed):
    """Valid encodings cut, extended, bit-flipped and random."""
    rng = np.random.default_rng(seed)
    out = []
    for name, enc in _encodings(seed):
        good = enc(port_proto)
        out.append(good)
        for cut in sorted(set(rng.integers(0, len(good) + 1, size=6))):
            out.append(good[:cut])
        out.append(good + b"\x00")
        if good:
            i = int(rng.integers(0, len(good)))
            out.append(good[:i] + bytes([good[i] ^ 0xFF]) + good[i + 1:])
    out += [rng.bytes(int(n)) for n in rng.integers(0, 64, size=20)]
    return out


@pytest.mark.parametrize("seed", [4, 5])
def test_decoders_refuse_what_the_reference_refuses(seed):
    for blob in _malformed(seed):
        for P in (port_proto,):
            got = [
                _outcome(P.decode_request, blob),
                _outcome(P.decode_response, blob),
                _outcome(P.decode_bls_segments, blob),
                _outcome(P.decode_ecdsa_items, blob),
                _outcome(P.decode_points, blob, 2),
                _outcome(P.decode_verdicts, blob, 6)]
        want = [
            _outcome(ref_proto.decode_request, blob),
            _outcome(ref_proto.decode_response, blob),
            _outcome(ref_proto.decode_bls_segments, blob),
            _outcome(ref_proto.decode_ecdsa_items, blob),
            _outcome(ref_proto.decode_points, blob, 2),
            _outcome(ref_proto.decode_verdicts, blob, 6)]
        assert got == want, blob


def test_frames_over_a_socket_pair():
    a, b = socket.socketpair()
    try:
        for P, Q in ((port_proto, ref_proto), (ref_proto, port_proto)):
            P.send_frame(a, b"lease-body")
            assert Q.recv_frame(b) == b"lease-body"
        a.sendall((port_proto.MAX_FRAME + 1).to_bytes(4, "little"))
        with pytest.raises(port_proto.ProtocolError):
            port_proto.recv_frame(b)
        with pytest.raises(port_proto.ProtocolError):
            port_proto.send_frame(a, b"\x00" * (port_proto.MAX_FRAME + 1))
    finally:
        a.close()
        b.close()
    c, d = socket.socketpair()
    c.close()
    assert port_proto.recv_frame(d) is None       # clean EOF
    d.close()


# ---------------------------------------------------------------------
# the helper: the reference's responses, strategy by strategy
# ---------------------------------------------------------------------
def _lease_requests(thr, ms, ecdsa_items):
    digests = [bytes([0x40 + j]) * 32 for j in range(2)]
    segs = []
    for d in digests:
        ids = [1, 2, 3]
        segs.append((ids, [thr.create_threshold_signer(i).sign_share(d)
                           for i in ids]))
    sums = [([0, 0, 0], [ms.create_threshold_signer(i).sign_share(d)[:48]
                         for i in (1, 2, 4)]) for d in digests]
    return {
        "bls-combine": port_proto.encode_request(
            11, port_proto.KIND_BLS_COMBINE, 500,
            port_proto.encode_bls_segments(segs)),
        "bls-sum": port_proto.encode_request(
            12, port_proto.KIND_BLS_SUM, 500,
            port_proto.encode_bls_segments(sums)),
        "ecdsa-rlc": port_proto.encode_request(
            13, port_proto.KIND_ECDSA_RLC, 500,
            port_proto.encode_ecdsa_items(CURVE, ecdsa_items)),
        "bad-kind": port_proto.encode_request(14, 9, 500, b"")}


@pytest.mark.parametrize("strategy", sorted(port_helper.STRATEGIES))
def test_helper_responses_equal_the_reference(thr, ms, strategy):
    """Every strategy on every lease kind: the same response bytes (or
    the same crash), and for stale-replay the same replay of the first
    lease on the second."""
    assert sorted(port_helper.STRATEGIES) == sorted(ref_helper.STRATEGIES)
    s1 = cpu.EcdsaSigner.generate(CURVE, seed=b"helper-parity")
    items = [(b"m%d" % i, s1.sign(b"m%d" % i), s1.public_bytes())
             for i in range(2)] + [(b"bad", s1.sign(b"x"), s1.public_bytes())]
    reqs = _lease_requests(thr, ms, items)
    servers = [mod.HelperServer("h", strategy=strategy, slow_s=0.01)
               for mod in (port_helper, ref_helper)]
    for kind, req in sorted(reqs.items()):
        outs = []
        for srv, crashed in ((servers[0], port_helper.HelperCrashed),
                             (servers[1], ref_helper.HelperCrashed)):
            try:
                outs.append([srv.handle(req), srv.handle(req)])
            except crashed:
                outs.append("crashed")
        assert outs[0] == outs[1], (strategy, kind)
    assert servers[0].leases_served == servers[1].leases_served
    with pytest.raises(ValueError):
        HelperServer("h", strategy="nope")


def test_honest_compute_answers_like_the_host_engine(thr, ms):
    """The helper's honest answers decode to what the port's engine
    computes: combined signatures, sums and verdicts."""
    s1 = cpu.EcdsaSigner.generate(CURVE, seed=b"helper-compute")
    items = [(b"a", s1.sign(b"a"), s1.public_bytes()),
             (b"b", s1.sign(b"c"), s1.public_bytes())]
    reqs = _lease_requests(thr, ms, items)
    srv = HelperServer("h")
    _, st, body = port_proto.decode_response(srv.handle(reqs["bls-combine"]))
    assert st == port_proto.ST_OK
    d = bytes([0x40]) * 32
    want = bls.combine_shares([1, 2, 3], [bls.g1_decompress(
        thr.create_threshold_signer(i).sign_share(d)) for i in (1, 2, 3)])
    assert port_proto.decode_points(body, 2)[0] == bls.g1_compress(want)
    _, _, body = port_proto.decode_response(srv.handle(reqs["ecdsa-rlc"]))
    assert port_proto.decode_verdicts(body, 2) == [True, False]
    _, st, body = port_proto.decode_response(srv.handle(reqs["bad-kind"]))
    assert (st, body) == (port_proto.ST_ERR, b"")


# ---------------------------------------------------------------------
# across packages: port pool -> reference helper, and back
# ---------------------------------------------------------------------
def test_port_pool_leases_to_a_reference_helper(thr):
    """The port's pool, through a transport wrapping the reference's
    HelperServer, verifies the reference helper's answer; a reference
    liar is caught and quarantined like a port one."""
    pool = get_offload_pool()
    pool.configure(enabled=True, lease_timeout_ms=30000)
    pool.add_helper(InprocHelper("ref", ref_helper.HelperServer("ref")))
    segments, digests = _combine_job(thr, b"r" * 32)
    local_fn, calls = _counted_local(segments)
    out = combine_via_offload(segments, digests, thr.public_key, local_fn)
    want = local_fn()
    assert [bls.g1_compress(p) for p in out] \
        == [bls.g1_compress(p) for p in want]
    assert calls == [1]                   # only the comparison's own call
    assert pool.snapshot()["counters"]["lease_verified"] == 1
    reset_offload_pool()
    pool = _pool_with()
    pool.add_helper(InprocHelper("liar", ref_helper.HelperServer(
        "liar", strategy="wrong-on-curve")))
    local_fn, calls = _counted_local(segments)
    out = combine_via_offload(segments, digests, thr.public_key, local_fn)
    assert calls == [1] and pool.snapshot()["quarantined"] == ["liar"]
    assert [bls.g1_compress(p) for p in out] \
        == [bls.g1_compress(p) for p in want]


def test_tcp_leases_cross_the_packages(thr):
    """Over TCP: the port's pool to a reference helper daemon, and the
    reference's pool to a port helper daemon; both verified."""
    segments, digests = _combine_job(thr, b"t" * 32)
    want = [bls.g1_compress(p) for p in _counted_local(segments)[0]()]
    ref_d = ref_helper.HelperDaemon(0, helper_id="rd").start()
    port_d = port_helper.HelperDaemon(0, helper_id="pd").start()
    try:
        pool = get_offload_pool()
        pool.configure(enabled=True, lease_timeout_ms=30000)
        pool.add_endpoint("rd", "127.0.0.1", ref_d.port)
        out = combine_via_offload(segments, digests, thr.public_key,
                                  _counted_local(segments)[0])
        assert [bls.g1_compress(p) for p in out] == want
        assert pool.snapshot()["counters"]["lease_verified"] == 1

        rpool = ref_pool.get_offload_pool()
        rpool.configure(enabled=True, lease_timeout_ms=30000)
        rpool.add_endpoint("pd", "127.0.0.1", port_d.port)
        ref_segs = [(ids, [ref_bls.g1_decompress(bls.g1_compress(p))
                           for p in pts]) for ids, pts in segments]
        rout = ref_pool.combine_via_offload(
            ref_segs, digests, thr.public_key,
            lambda: [ref_bls.combine_shares(i, p) for i, p in ref_segs])
        assert [ref_bls.g1_compress(p) for p in rout] == want
        assert rpool.snapshot()["counters"]["lease_verified"] == 1
        assert port_d.server.leases_served == 1
    finally:
        reset_offload_pool()
        ref_pool.reset_offload_pool()
        ref_d.stop()
        port_d.stop()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_helper_module_serves_leases(thr):
    """`python -m tpubft_torch.offload.helper --port P --strategy S`
    serves verified leases; the process is stopped and gone after."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpubft_torch.offload.helper", "--port",
         str(port), "--id", "sub", "--strategy", "honest",
         "--log-level", "WARNING"], cwd=ROOT, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        pool = get_offload_pool()
        pool.configure(enabled=True, lease_timeout_ms=60000)
        pool.add_endpoint("sub", "127.0.0.1", port)
        deadline = time.monotonic() + 120
        while True:                        # wait for the listener
            try:
                socket.create_connection(("127.0.0.1", port), 1).close()
                break
            except OSError:
                assert proc.poll() is None, "helper exited"
                assert time.monotonic() < deadline, "helper never listened"
                time.sleep(0.1)
        segments, digests = _combine_job(thr, b"s" * 32)
        out = combine_via_offload(segments, digests, thr.public_key,
                                  _counted_local(segments)[0])
        assert out is not None
        assert pool.snapshot()["counters"]["lease_verified"] == 1
    finally:
        reset_offload_pool()
        proc.terminate()
        proc.wait(30)
    assert proc.poll() is not None


# ---------------------------------------------------------------------
# the fault matrix: threshold combine
# ---------------------------------------------------------------------
def test_honest_combine_verified_and_identical(thr):
    pool = _pool_with(HelperServer("h0"))
    segments, digests = _combine_job(thr, b"d" * 32)
    local_fn, calls = _counted_local(segments)
    out = combine_via_offload(segments, digests, thr.public_key, local_fn)
    want = [bls.combine_shares(ids, pts) for ids, pts in segments]
    assert [bls.g1_compress(p) for p in out] \
        == [bls.g1_compress(p) for p in want]
    assert calls == []
    snap = pool.snapshot()
    assert snap["counters"]["lease_verified"] == 1
    assert snap["counters"]["lease_rejected"] == 0
    assert snap["quarantined"] == []
    assert snap["lease_items_total"] == 3 and snap["lease_us_total"] > 0
    assert get_breaker("helper.h0").state == CLOSED


@pytest.mark.parametrize("strategy", ["wrong-point", "wrong-on-curve",
                                      "garbage"])
def test_lying_combine_costs_one_rerun_and_quarantine(thr, strategy):
    pool = _pool_with(HelperServer("liar", strategy=strategy))
    segments, digests = _combine_job(thr, b"e" * 32)
    local_fn, calls = _counted_local(segments)
    out = combine_via_offload(segments, digests, thr.public_key, local_fn)
    want = [bls.combine_shares(ids, pts) for ids, pts in segments]
    assert [bls.g1_compress(p) for p in out] \
        == [bls.g1_compress(p) for p in want]
    assert calls == [1]
    snap = pool.snapshot()
    assert snap["quarantined"] == ["liar"]
    assert snap["counters"]["lease_rejected"] == 1
    assert snap["counters"]["helper_evicted"] == 1
    assert get_breaker("helper.liar").state == OPEN


def test_stale_replay_fails_only_its_own_lease(thr):
    pool = _pool_with(HelperServer("replayer", strategy="stale-replay"))
    seg1, dig1 = _combine_job(thr, b"f" * 32)
    local1, calls1 = _counted_local(seg1)
    assert combine_via_offload(seg1, dig1, thr.public_key,
                               local1) is not None and calls1 == []
    seg2, dig2 = _combine_job(thr, b"g" * 32, sids=(2, 3, 4))
    local2, calls2 = _counted_local(seg2)
    assert combine_via_offload(seg2, dig2, thr.public_key, local2) is None
    assert calls2 == []
    assert pool.snapshot()["quarantined"] == ["replayer"]
    assert get_breaker("helper.replayer").state == OPEN


def test_only_operator_reset_readmits_a_liar(thr):
    pool = _pool_with(HelperServer("liar", strategy="wrong-on-curve"))
    segments, digests = _combine_job(thr, b"h" * 32)
    combine_via_offload(segments, digests, thr.public_key,
                        _counted_local(segments)[0])
    assert pool.snapshot()["quarantined"] == ["liar"]
    br = get_breaker("helper.liar")
    assert not br.allow()
    br.configure(cooldown_s=0.01)
    time.sleep(0.05)
    assert pool._pick(set()) is None       # quarantine is a set
    local2, calls2 = _counted_local(segments)
    assert combine_via_offload(segments, digests, thr.public_key,
                               local2) is None and calls2 == []
    pool._helpers["liar"].server.set_strategy("honest")
    pool.operator_reset("liar")
    assert get_breaker("helper.liar").state == CLOSED
    local3, calls3 = _counted_local(segments)
    assert combine_via_offload(segments, digests, thr.public_key,
                               local3) is not None and calls3 == []


# ---------------------------------------------------------------------
# transport shapes: sick, not Byzantine
# ---------------------------------------------------------------------
def test_slow_loris_is_sick_not_byzantine(thr):
    slow = HelperServer("slow", strategy="slow-loris", slow_s=0.05)
    pool = _pool_with(slow, timeout_ms=1)
    segments, digests = _combine_job(thr, b"i" * 32)
    local_fn, calls = _counted_local(segments)
    assert combine_via_offload(segments, digests, thr.public_key,
                               local_fn) is None and calls == []
    snap = pool.snapshot()
    assert snap["quarantined"] == []
    assert snap["counters"]["lease_timeouts"] >= 1
    br = get_breaker("helper.slow")
    assert br.failures >= 1
    slow.set_strategy("honest")
    pool.configure(lease_timeout_ms=30000)
    br.configure(cooldown_s=0.01)
    while br.state != OPEN:
        try:
            with br.attempt("lease"):
                raise OSError("still sick")
        except (OSError, BreakerOpen):
            pass
    time.sleep(0.3)
    assert combine_via_offload(segments, digests, thr.public_key,
                               _counted_local(segments)[0]) is not None
    assert br.state == CLOSED


def test_crash_is_sick_and_pool_degrades_to_local(thr):
    pool = _pool_with(HelperServer("flaky", strategy="crash"))
    segments, digests = _combine_job(thr, b"j" * 32)
    local_fn, calls = _counted_local(segments)
    assert combine_via_offload(segments, digests, thr.public_key,
                               local_fn) is None and calls == []
    assert pool.snapshot()["quarantined"] == []
    assert get_breaker("helper.flaky").failures >= 1


def test_retry_lands_on_second_helper_in_same_flush(thr):
    slow = HelperServer("slow", strategy="slow-loris", slow_s=0.2)
    pool = _pool_with(slow, HelperServer("good"), timeout_ms=50)
    segments, digests = _combine_job(thr, b"k" * 32)
    for _ in range(4):
        local_fn, calls = _counted_local(segments)
        assert combine_via_offload(segments, digests, thr.public_key,
                                   local_fn) is not None and calls == []
    snap = pool.snapshot()
    assert snap["counters"]["lease_timeouts"] >= 1
    assert snap["counters"]["lease_verified"] == 4
    assert snap["quarantined"] == []


# ---------------------------------------------------------------------
# multisig sums
# ---------------------------------------------------------------------
def test_honest_sum_verified_and_identical(ms):
    pool = _pool_with(HelperServer("h0"))
    v, segments, meta = _sum_job(ms, b"m" * 32)
    local_fn, calls = _counted_sum_local(segments)
    out = sum_via_offload(segments, meta, v, local_fn)
    want = _counted_sum_local(segments)[0]()
    assert calls == [] and [bls.g1_compress(p) for p in out] \
        == [bls.g1_compress(p) for p in want]
    assert pool.snapshot()["counters"]["lease_verified"] == 1


def test_lying_sum_caught_and_quarantined(ms):
    pool = _pool_with(HelperServer("liar", strategy="wrong-on-curve"))
    v, segments, meta = _sum_job(ms, b"n" * 32)
    local_fn, calls = _counted_sum_local(segments)
    out = sum_via_offload(segments, meta, v, local_fn)
    want = _counted_sum_local(segments)[0]()
    assert [bls.g1_compress(p) for p in out] \
        == [bls.g1_compress(p) for p in want]
    assert calls == [1]
    assert pool.snapshot()["quarantined"] == ["liar"]


# ---------------------------------------------------------------------
# ECDSA verdicts
# ---------------------------------------------------------------------
def test_honest_ecdsa_verdicts_one_refold(ecdsa):
    """The helper's verdicts cost one re-fold over the accepted subset
    and a host re-check of the rejected one, never a local re-run."""
    from tpubft_torch.ops import ecdsa as ops_ecdsa
    items, _mixed, want = ecdsa
    pool = _pool_with(HelperServer("h0"))
    local_fn, calls = _memo_local(want)
    ops_ecdsa.reset_counts()
    assert ecdsa_via_offload(CURVE, items, local_fn) == want
    assert calls == []
    assert ops_ecdsa.COUNTS[CURVE]["rlc_launches"] == 1
    assert ops_ecdsa.COUNTS[CURVE]["lanes"] == 2
    snap = pool.snapshot()
    assert snap["counters"]["lease_verified"] == 1
    assert snap["soundness_us_total"] > 0


@pytest.mark.parametrize("strategy", ["wrong-on-curve", "garbage"])
def test_lying_ecdsa_verdicts_caught(ecdsa, strategy):
    items, _mixed, want = ecdsa
    pool = _pool_with(HelperServer("liar", strategy=strategy))
    local_fn, calls = _memo_local(want)
    assert ecdsa_via_offload(CURVE, items, local_fn) == want
    assert calls == [1]
    assert pool.snapshot()["quarantined"] == ["liar"]


def test_no_device_is_not_swallowed_by_the_check(ecdsa):
    """A missing card during the soundness launch raises, where the
    reference would quietly run the local path (pool.py:579-587)."""
    items, _mixed, want = ecdsa
    pool = _pool_with(HelperServer("h0"))
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    device.set_default_device(None)
    local_fn, calls = _memo_local(want)
    with pytest.raises(device.NoDevice):
        ecdsa_via_offload(CURVE, items, local_fn)
    assert calls == []
    assert pool.snapshot()["quarantined"] == []


@pytest.mark.parametrize("route", ["honest", "garbage"])
def test_sig_manager_ecdsa_verdicts_equal_with_offload(ecdsa, route):
    """SigManager's batch entry (crypto/cuda.verify_batch_mixed) with the
    group on the RLC path: the verdicts equal the offload-off run's. The
    honest helper's costs one re-fold launch instead of the bisection's
    three; the liar's costs the full local run and its quarantine."""
    from tpubft_torch.ops import ecdsa as ops_ecdsa
    _items, mixed, want = ecdsa
    pool = _pool_with(HelperServer("h", strategy=route))
    crypto_cuda.set_ecdsa_crossover(1)
    ops_ecdsa.reset_counts()
    assert crypto_cuda.verify_batch_mixed(mixed) == want
    launches = ops_ecdsa.COUNTS[CURVE]["rlc_launches"]
    snap = pool.snapshot()
    if route == "honest":
        assert launches == 1 and snap["counters"]["lease_verified"] == 1
    else:
        assert launches == 3 and snap["quarantined"] == ["h"]


# ---------------------------------------------------------------------
# pool mechanics
# ---------------------------------------------------------------------
def test_inflight_cap_degrades_to_local(thr):
    pool = _pool_with(HelperServer("h0"))
    pool.configure(max_inflight=1)
    with pool._mu:
        pool._inflight = 1
    segments, digests = _combine_job(thr, b"p" * 32)
    local_fn, _calls = _counted_local(segments)
    assert combine_via_offload(segments, digests, thr.public_key,
                               local_fn) is None
    assert pool.snapshot()["counters"]["local_fallbacks"] == 1
    with pool._mu:
        pool._inflight = 0


def test_disabled_or_unrouted_pool_never_leases(thr):
    pool = get_offload_pool()
    pool.add_helper(InprocHelper("h0", HelperServer("h0")))
    segments, digests = _combine_job(thr, b"q" * 32)
    local_fn, _calls = _counted_local(segments)
    assert combine_via_offload(segments, digests, thr.public_key,
                               local_fn) is None
    pool.configure(enabled=True)
    pool.set_routing(False)               # the tuner's actuator
    assert combine_via_offload(segments, digests, thr.public_key,
                               local_fn) is None
    assert pool.snapshot()["counters"]["lease_issued"] == 0


# ---------------------------------------------------------------------
# the verifiers: certificates with offload off, honest and lying
# ---------------------------------------------------------------------
def _thr_jobs(thr, n_jobs=2, bad_job=None):
    jobs = []
    for j in range(n_jobs):
        digest = bytes([0x30 + j]) * 32
        shares = {sid: thr.create_threshold_signer(sid).sign_share(digest)
                  for sid in (1, 2, 3)}
        if bad_job == j:
            s = shares[2]
            shares[2] = s[:5] + bytes([s[5] ^ 0xFF]) + s[6:]
        jobs.append((digest, shares))
    return jobs


@pytest.mark.parametrize("strategy,bad_job", [
    ("honest", None), ("wrong-on-curve", None), ("honest", 1)])
def test_combine_batch_byte_identical_with_offload(thr, strategy, bad_job):
    """The fused combine entry point with offload on returns the
    offload-off (ok, cert, bad_shares) tuples, and those equal the
    reference's host classes'."""
    from tpubft.crypto.interfaces import Cryptosystem as RefCryptosystem
    v = crypto_cuda.make_threshold_verifier(
        "threshold-bls", 3, 4, thr.public_key, thr.share_public_keys)
    jobs = _thr_jobs(thr, bad_job=bad_job)
    want = v.combine_batch(jobs)
    ref = RefCryptosystem("threshold-bls", 3, 4, seed=b"offload-fault")
    assert want == ref.create_threshold_verifier().combine_batch(jobs)
    _pool_with(HelperServer("h", strategy=strategy))
    assert v.combine_batch(jobs) == want
    snap = get_offload_pool().snapshot()
    if strategy != "honest":
        assert snap["quarantined"] == ["h"]
    elif bad_job is None:
        assert snap["counters"]["lease_verified"] == 1
    else:
        # honest helper, bad share: the check fails, the one local
        # re-run agrees with the helper, and nobody is quarantined
        assert snap["counters"]["lease_rejected"] == 1
        assert snap["quarantined"] == []


@pytest.mark.parametrize("strategy", ["honest", "wrong-on-curve"])
def test_device_combine_reruns_once_on_the_msm_path(thr, ms, monkeypatch,
                                                     strategy):
    """With the crossover at 1 the local combine is the MSM kernel's
    wrapper (its plain version on CPU tensors): offload off takes one
    device combine a flush, an honest lease none, and a liar exactly one
    re-run. The multisig sums likewise."""
    monkeypatch.setenv("TPUBFT_MSM_CROSSOVER_K", "1")
    v = crypto_cuda.make_threshold_verifier(
        "threshold-bls", 3, 4, thr.public_key, thr.share_public_keys)
    jobs = _thr_jobs(thr)
    want = v.combine_batch(jobs)
    assert v.device_combines == 1
    mv = _ms_verifier(ms)
    mjobs = []
    for j in range(2):
        d = bytes([0x50 + j]) * 32
        mjobs.append((d, {sid: ms.create_threshold_signer(sid).sign_share(d)
                          for sid in (1, 2, 4)}))
    mwant = mv.combine_batch(mjobs)
    assert mv.device_combines == 1 and all(ok for ok, _, _ in mwant)
    _pool_with(HelperServer("h", strategy=strategy))
    assert v.combine_batch(jobs) == want
    if strategy == "wrong-on-curve":
        get_offload_pool().operator_reset("h")
    assert mv.combine_batch(mjobs) == mwant
    reruns = 0 if strategy == "honest" else 1
    assert (v.device_combines, mv.device_combines) == (1 + reruns,
                                                       1 + reruns)


# ---------------------------------------------------------------------
# the replica and the health plane
# ---------------------------------------------------------------------
def test_offload_replica_builds_the_pool_and_health_shows_it():
    """offload_enabled builds the process-wide pool from
    `offload_helpers`, the tuner gets its `offload_route` knob, replicas
    advertise CAP_OFFLOAD, and the health payload carries the pool's
    snapshot: a quarantined helper reads as degraded."""
    from tpubft_torch.consensus import messages as m
    from tpubft_torch.testing import InProcessCluster
    with InProcessCluster(f=1, num_clients=1, cfg_overrides=dict(
            crypto_backend="cpu", offload_enabled=True,
            offload_helpers="h0=127.0.0.1:9,h1=127.0.0.1:10",
            offload_lease_timeout_ms=150,
            offload_max_inflight=2)) as cluster:
        rep = cluster.replicas[0]
        pool = get_offload_pool()
        snap = pool.snapshot()
        assert snap["enabled"] and snap["helpers"] == ["h0", "h1"]
        assert (snap["lease_timeout_ms"], snap["max_inflight"]) == (150, 2)
        assert "offload_route" in rep.tuning.registry.names()
        rep.tuning.registry.set("offload_route", 0)
        assert pool.snapshot()["routing"] is False
        assert rep._my_capabilities() & m.CAP_OFFLOAD
        health = rep.health.verdict()
        assert health["offload"]["helpers"] == ["h0", "h1"]
        assert health["breakers"]["helper.h0"]["state"] == CLOSED
        pool.report_byzantine("h1", "test")
        health = rep.health.verdict()
        assert health["offload"]["quarantined"] == ["h1"]
        assert health["verdict"] == "degraded"
