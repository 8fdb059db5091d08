"""The port's pre-execution plane (tpubft_torch/preprocessor/, wired into
the port's Replica, skvbc_replica --pre-execution and BftTestNetwork)
against the reference on this host's CPU: the counterparts of
tests/test_preexecution.py, of tests/test_client_batch.py::
test_batch_composes_with_pre_execution and of tests/
test_apollo_extended.py::test_preexecution_conflicts_over_processes.

Where both packages run the same seeded sequence in process (one client,
its request ids and correlation ids pinned on both sides), the frames
the preprocessors send (PreProcessRequestMsg, PreProcessReplyMsg, the
grouped batch frames), the requests the primary's PrePrepares order, the
replies, every
replica's raw blocks and state digest are compared byte for byte. Every
wait is on state, with a bound."""
import collections
import time

import pytest
import torch

from tpubft.apps import counter as ref_counter
from tpubft.apps import skvbc as ref_skvbc
from tpubft.consensus import messages as ref_m
from tpubft.kvbc import KeyValueBlockchain as RefChain
from tpubft.preprocessor import preprocessor as ref_pre
from tpubft.storage import MemoryDB as RefDB
from tpubft.testing import InProcessCluster as RefCluster
from tpubft.utils import serialize as ref_ser
from tpubft_torch import device
from tpubft_torch.apps import counter as port_counter
from tpubft_torch.apps import skvbc as port_skvbc
from tpubft_torch.consensus import messages as port_m
from tpubft_torch.kvbc import KeyValueBlockchain as PortChain
from tpubft_torch.preprocessor import preprocessor as port_pre
from tpubft_torch.storage import MemoryDB as PortDB
from tpubft_torch.testing import InProcessCluster as PortCluster
from tpubft_torch.utils import serialize as port_ser

torch.set_num_threads(1)

BASE = dict(autotune_enabled=False, crypto_backend="cpu")
PREEXEC = dict(BASE, pre_execution_enabled=True)
SEED = b"torch-preexec-parity"

PORT = dict(cluster=PortCluster, skvbc=port_skvbc, chain=PortChain,
            db=PortDB, m=port_m, pre=port_pre, ser=port_ser,
            counter=port_counter)
REF = dict(cluster=RefCluster, skvbc=ref_skvbc, chain=RefChain, db=RefDB,
           m=ref_m, pre=ref_pre, ser=ref_ser, counter=ref_counter)
PREEXEC_CODES = (21, 22, 25, 26)     # PreProcess{Request,Reply,Batch*}


@pytest.fixture(autouse=True)
def _cpu():
    device.set_default_device("cpu")
    yield
    device.set_default_device(None)


def _pin(client, start=9_000_000):
    """Deterministic request ids and correlation ids for one client."""
    client._req_seq = start
    orig = client._new_request_locked

    def pinned(payload, flags, cid, quorum):
        return orig(payload, flags, f"preexec-{client._req_seq + 1}", quorum)
    client._new_request_locked = pinned
    return client


def _wait(cond, budget_s, what):
    deadline = time.monotonic() + budget_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out after {budget_s}s waiting for {what}")


def _handler(pkg):
    def make(_r=None):
        return pkg["skvbc"].SkvbcHandler(
            pkg["chain"](pkg["db"](), use_device_hashing=False))
    return make


def _record_frames(cl, frames):
    """Wrap every replica's send: (sender, dest, code, raw) of each
    pre-execution frame and PrePrepare into `frames`."""
    for r, rep in cl.replicas.items():
        orig = rep.comm.send

        def send(dest, raw, _orig=orig, _r=r):
            code = int.from_bytes(bytes(raw[:2]), "little")
            if code in PREEXEC_CODES or code == 3:
                frames.append((_r, dest, code, bytes(raw)))
            return _orig(dest, raw)
        rep.comm.send = send


def _drive(pkg, writes, overrides, budget_s=60):
    """One pinned client sends `writes` ((writeset, readset, read_version,
    pre_process) each) in turn; -> the replies, each replica's raw blocks,
    state digest and preexec counters, and the frames sent."""
    frames = []
    with pkg["cluster"](f=1, num_clients=1, seed=SEED,
                        handler_factory=_handler(pkg),
                        cfg_overrides=overrides) as cl:
        _record_frames(cl, frames)
        kv = pkg["skvbc"].SkvbcClient(_pin(cl.client()))
        replies = [kv.write(ws, readset=rs, read_version=rv,
                            pre_process=pre, timeout_ms=budget_s * 1000)
                   for ws, rs, rv, pre in writes]
        n_blocks = sum(1 for r in replies if r.success)
        reps = list(cl.replicas.values())

        def applied():
            head = max(rep.last_executed for rep in reps)
            return all(rep.last_executed == head
                       and cl.handlers[rep.id].blockchain.last_block_id
                       == n_blocks and rep.exec_lane.idle()
                       and (rep.durability is None
                            or rep.durability.idle())
                       for rep in reps)
        _wait(applied, budget_s, "every replica to apply")
        out = {"replies": [(r.success, r.latest_block) for r in replies],
               "read": kv.read([k for ws, _rs, _rv, _p in writes
                                for k, _v in ws])}
        for r, rep in cl.replicas.items():
            bc = cl.handlers[r].blockchain
            out[r] = dict(
                blocks=[bc.get_raw_block(b) for b in range(1, n_blocks + 1)],
                state_digest=bc.state_digest(),
                conflicts=rep.m_preexec_conflicts.value,
                applied=rep.m_preexec_applied.value,
                sessions=(rep.preprocessor.m_sessions.value
                          if rep.preprocessor else None),
                agreed=(rep.preprocessor.m_agreed.value
                        if rep.preprocessor else None))
        out["frames"] = frames
        return out


def _frames(run, code, sender=None):
    """The distinct frames of `code` (retransmissions and cache answers
    repeat them byte for byte), as a sorted list."""
    return sorted({(s, d, raw) for s, d, c, raw in run["frames"]
                   if c == code and (sender is None or s == sender)})


def _ordered(run, m, ser):
    """What the primary's PrePrepares ordered: {seq: each wrapper's flags,
    client, request id, original's bytes, result and number of
    signatures} (a PrePrepare's own bytes carry the primary's clock, and
    which f replies joined the primary's own first is a race)."""
    out = {}
    for _s, _d, raw in _frames(run, 3, sender=0):
        pp = m.unpack(raw)
        out[pp.seq_num] = [
            (r.flags, r.sender_id, r.req_seq_num, env.original, env.result,
             len(env.signatures))
            for r in pp.client_requests()
            for env in [ser.decode_msg(r.request, m.PreProcessResult)]]
    return out


def _same_ledgers(a, b):
    assert a["replies"] == b["replies"]
    assert a["read"] == b["read"]
    for r in range(4):
        for what in ("blocks", "state_digest"):
            assert a[r][what] == b[r][what], (r, what)
            assert a[r][what] == a[0][what], (r, what)


# the reference's end-to-end sequence (test_preexecution.py:36-60): a
# write, an overwrite, a stale conditional write at block 1
E2E = [([(b"a", b"1")], [], 0, True),
       ([(b"a", b"2")], [], 0, True),
       ([(b"b", b"x")], [b"a"], 1, True)]


# ---------------------------------------------------------------------
# test_preexecution.py's eight
# ---------------------------------------------------------------------
def test_preexec_codec_and_digest():
    """The envelope's codec and the result digest, and the same bytes in
    both packages."""
    env = port_m.PreProcessResult(original=b"orig", result=b"res",
                                  signatures=[(0, b"s0"), (2, b"s2")])
    raw = port_ser.encode_msg(env)
    assert port_ser.decode_msg(raw, port_m.PreProcessResult) == env
    renv = ref_m.PreProcessResult(original=b"orig", result=b"res",
                                  signatures=[(0, b"s0"), (2, b"s2")])
    assert ref_ser.encode_msg(renv) == raw
    d1 = port_m.preexec_digest(5, 7, b"orig", b"res")
    assert d1 == ref_m.preexec_digest(5, 7, b"orig", b"res")
    assert d1 != port_m.preexec_digest(5, 7, b"orig", b"res2")
    assert d1 != port_m.preexec_digest(5, 8, b"orig", b"res")


def test_preexec_end_to_end_and_conflicts():
    """A pre-executed write, an overwrite and a stale conditional write
    (caught at commit): the reference's replies, raw blocks and state
    digests, a conflict counted on every replica, and the same
    PreProcessRequestMsg / PreProcessReplyMsg frames on the wire and the
    same wrappers ordered as the reference's."""
    ref = _drive(REF, E2E, PREEXEC)
    port = _drive(PORT, E2E, PREEXEC)
    _same_ledgers(port, ref)
    assert port["replies"] == [(True, 1), (True, 2), (False, 2)]
    assert port["read"] == {b"a": b"2"}
    for r in range(4):
        assert port[r]["conflicts"] == ref[r]["conflicts"] == 1
        assert port[r]["applied"] == ref[r]["applied"] == 2
    assert port[0]["sessions"] == port[0]["agreed"] == 3
    for code in (21, 22):
        assert _frames(port, code) == _frames(ref, code), code
    assert _ordered(port, port_m, port_ser) == _ordered(ref, ref_m, ref_ser)
    assert sorted(_ordered(port, port_m, port_ser)) == [1, 2, 3]
    assert len(_frames(port, 21)) == 3 * 3      # 3 writes x 3 backups
    assert len(_frames(port, 22)) == 3 * 3


def test_preexec_unsupported_handler_falls_back():
    """The counter's pre_execute returns None: the request is ordered
    normally, with the reference's reply."""
    replies = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        with pkg["cluster"](f=1, num_clients=1, seed=SEED,
                            cfg_overrides=PREEXEC) as cl:
            client = _pin(cl.client(0))
            replies[name] = client.send_write(
                pkg["counter"].encode_add(4), pre_process=True)
            if name == "port":
                assert cl.replicas[0].preprocessor.m_fallbacks.value == 1
    assert replies["port"] == replies["ref"]
    assert port_counter.decode_reply(replies["port"]) == 4


def _signed_original(pkg, cl, seq=50):
    """A client-signed PRE_PROCESS write from the cluster's first
    client, as the package builds it."""
    m, skvbc = pkg["m"], pkg["skvbc"]
    client_id = cl.n
    orig = m.ClientRequestMsg(
        sender_id=client_id, req_seq_num=seq,
        flags=int(m.RequestFlag.PRE_PROCESS),
        request=skvbc.pack(skvbc.WriteRequest(writeset=[(b"k", b"v")])),
        cid="x", signature=b"")
    if pkg is PORT:
        from tpubft_torch.crypto.cpu import Ed25519Signer
    else:
        from tpubft.crypto.cpu import Ed25519Signer
    signer = Ed25519Signer.generate(
        seed=cl.keys.for_node(client_id).my_sign_seed)
    orig.signature = signer.sign(orig.signed_payload())
    return orig


def _wrappers(pkg, cl):
    """The reference test's wrappers (test_preexecution.py:80-125), by
    name: a valid one and its forgeries."""
    m, ser = pkg["m"], pkg["ser"]
    orig = _signed_original(pkg, cl)
    result = orig.request
    digest = m.preexec_digest(orig.sender_id, 50, orig.pack(), result)
    sigs = [(r, cl.replicas[r].sig.sign(digest)) for r in (0, 2)]

    def wrapper(signatures, res=result, original=orig):
        env = m.PreProcessResult(original=original.pack(), result=res,
                                 signatures=signatures)
        return m.ClientRequestMsg(
            sender_id=orig.sender_id, req_seq_num=50,
            flags=int(m.RequestFlag.HAS_PRE_PROCESSED),
            request=ser.encode_msg(env), cid="x", signature=b"")
    unsigned = m.unpack(orig.pack())
    unsigned.signature = bytes(64)
    return {
        "valid": wrapper(sigs),
        "too_few": wrapper(sigs[:1]),
        "duplicate_signer": wrapper([sigs[0], sigs[0]]),
        "other_digest": wrapper([(0, cl.replicas[0].sig.sign(
            b"\x00" * 32)), sigs[1]]),
        "tampered_result": wrapper(sigs, res=b"evil"),
        "forged_client_signature": wrapper(sigs, original=unsigned),
        "not_a_replica": wrapper([sigs[0], (cl.n, sigs[1][1])]),
    }, result


def test_preexec_wrapper_validation_rejects_forgeries():
    """The reference's forged wrappers (too few signers, a duplicated
    signer, a signature over another digest, a tampered result) and two
    more (the original's client signature forged, a client id among the
    signers): refused by a port backup, accepted when valid; the same
    wrapper bytes in both packages and the same verdicts from a
    reference backup; unpack_preprocessed round-trips."""
    verdicts, raws = {}, {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        with pkg["cluster"](f=1, seed=SEED, handler_factory=_handler(pkg),
                            cfg_overrides=PREEXEC) as cl:
            wrappers, result = _wrappers(pkg, cl)
            rep = cl.replicas[1]
            verdicts[name] = {k: pkg["pre"].validate_preprocessed_request(
                rep, w) for k, w in wrappers.items()}
            raws[name] = {k: w.pack() for k, w in wrappers.items()}
            o, res = pkg["pre"].unpack_preprocessed(
                wrappers["valid"].request)
            assert o.req_seq_num == 50 and res == result
    assert raws["port"] == raws["ref"]
    assert verdicts["port"] == verdicts["ref"]
    assert verdicts["port"] == {k: k == "valid" for k in verdicts["port"]}


def _count_sends(cl, sent):
    for r, rep in cl.replicas.items():
        orig = rep.comm.send

        def counting_send(dest, raw, _orig=orig, _r=r):
            sent[(_r, int.from_bytes(bytes(raw[:2]), "little"))] += 1
            return _orig(dest, raw)
        rep.comm.send = counting_send


def test_preprocess_batch_wire_grouping():
    """A client batch's eight PRE_PROCESS elements ride grouped frames:
    one PreProcessBatchRequestMsg from the primary to each backup and a
    folded PreProcessBatchReplyMsg back from each, with fewer singles
    than elements x backups; the batch request frames equal the
    reference's, and so do the blocks and the read."""
    runs = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        sent, frames = collections.Counter(), []
        with pkg["cluster"](f=1, num_clients=1, seed=SEED,
                            handler_factory=_handler(pkg),
                            cfg_overrides=dict(
                                PREEXEC, async_verification=False)) as cl:
            _record_frames(cl, frames)
            _count_sends(cl, sent)
            kv = pkg["skvbc"].SkvbcClient(_pin(cl.client(0)))
            rs = kv.write_batch([[(b"g%d" % i, b"v%d" % i)]
                                 for i in range(8)],
                                timeout_ms=20000, pre_process=True)
            assert all(r.success for r in rs)
            got = kv.read([b"g%d" % i for i in range(8)], timeout_ms=20000)
            assert len(got) == 8
            _wait(lambda: {h.blockchain.last_block_id
                           for h in cl.handlers.values()} == {8},
                  20, "every replica's eighth block")
            blocks = [cl.handlers[0].blockchain.get_raw_block(b)
                      for b in range(1, 9)]
        runs[name] = dict(sent=sent, frames=frames, got=got, blocks=blocks)
    port = runs["port"]
    sent = port["sent"]
    assert sent[(0, 25)] >= 3                    # one per backup (n-1)
    assert sum(sent[(r, 26)] for r in (1, 2, 3)) >= 3
    assert sent[(0, 21)] < 8 * 3
    batch = {"frames": port["frames"]}
    ref_batch = {"frames": runs["ref"]["frames"]}
    assert _frames(batch, 25) == _frames(ref_batch, 25)
    assert port["got"] == runs["ref"]["got"]
    assert port["blocks"] == runs["ref"]["blocks"]


class _FakeDispatcher:
    def register_internal(self, *a, **kw):
        pass

    def add_timer(self, *a, **kw):
        pass


class _FakeIncoming:
    def push_internal(self, *a, **kw):
        pass


def _cache_trace(pkg):
    """The reference test's cache sequence on `pkg`'s PreProcessor over
    a fake replica: -> every observable step."""
    if pkg is PORT:
        from tpubft_torch.utils.config import ReplicaConfig
        from tpubft_torch.utils.metrics import Component
    else:
        from tpubft.utils.config import ReplicaConfig
        from tpubft.utils.metrics import Component

    class _FakeReplica:
        dispatcher = _FakeDispatcher()
        incoming = _FakeIncoming()
        cfg = ReplicaConfig(pre_execution_enabled=True,
                            preexec_reply_cache_max=3)
        preexec_metrics = Component("preexec")

    pp = pkg["pre"].PreProcessor(_FakeReplica(), num_threads=1)
    trace = []
    try:
        for i in range(5):
            pp._cache_put((1, i, 1), b"r%d" % i)
        trace += [len(pp._reply_cache), pp.m_cache_evictions.value,
                  pp._cache_get((1, 0, 1)), pp._cache_get((1, 4, 1)),
                  pp.m_cache_hits.value, pp._cache_get((1, 2, 1))]
        pp._cache_put((1, 5, 1), b"r5")
        pp._cache_put((1, 6, 1), b"r6")
        trace += [pp._cache_get((1, 2, 1)), pp._cache_get((1, 3, 1)),
                  list(pp._reply_cache), pp.m_cache_evictions.value,
                  pp.m_cache_hits.value]
    finally:
        pp.shutdown()
    return trace


def test_reply_cache_is_lru_bounded_with_eviction_counter():
    """The backup's reply cache is a capped LRU: the reference test's
    sequence gives the same hits, evictions and order in both
    packages."""
    port = _cache_trace(PORT)
    assert port == _cache_trace(REF)
    assert port[:6] == [3, 2, None, b"r4", 1, b"r2"]
    assert port[6:8] == [b"r2", None]


def test_reply_cache_rebroadcast_does_not_reexecute():
    """A primary's rebroadcast of a PreProcessRequest the backup already
    executed is answered from the reply cache, byte for byte: the
    handler's pre_execute runs once."""
    with PortCluster(f=1, seed=SEED, handler_factory=_handler(PORT),
                     cfg_overrides=PREEXEC) as cluster:
        rep = cluster.replicas[1]
        calls, replies = [], []
        orig_pre = rep.handler.pre_execute

        def counting_pre(client_id, req_seq, request):
            calls.append((client_id, req_seq))
            return orig_pre(client_id, req_seq, request)
        rep.handler.pre_execute = counting_pre
        orig_send = rep.comm.send

        def send(dest, raw):
            if int.from_bytes(bytes(raw[:2]), "little") == 22:
                replies.append(bytes(raw))
            return orig_send(dest, raw)
        rep.comm.send = send
        orig = _signed_original(PORT, cluster, seq=777)
        ppr = port_m.PreProcessRequestMsg(
            sender_id=0, client_id=orig.sender_id, req_seq_num=777,
            retry_id=55, request=orig.pack())
        rep.incoming.push_external(0, ppr.pack())
        _wait(lambda: len(replies) == 1, 10, "the backup's reply")
        assert calls == [(orig.sender_id, 777)]
        hits = rep.preprocessor.m_cache_hits.value
        rep.incoming.push_external(0, ppr.pack())
        _wait(lambda: len(replies) == 2, 10, "the cached reply")
        assert rep.preprocessor.m_cache_hits.value == hits + 1
        assert replies[0] == replies[1]
        time.sleep(0.2)                     # any stray execution
        assert len(calls) == 1, "rebroadcast re-executed the handler"


def test_preexec_conflict_fallback_state_equivalence():
    """Contended and uncontended writes give byte-identical ledgers with
    pre-execution on and off, in the port, and equal to the reference's
    with it on; the contended run counts a conflict."""
    def writes(pre):
        return [([(b"z", b"9"), (b"a", b"1")], [], 0, pre),
                ([(b"a", b"2")], [], 0, pre),
                ([(b"b", b"x")], [b"a"], 1, pre),
                ([(b"c", b"3")], [], 0, pre)]
    on = _drive(PORT, writes(True), PREEXEC)
    off = _drive(PORT, writes(False), BASE)
    ref = _drive(REF, writes(True), PREEXEC)
    _same_ledgers(on, off)
    _same_ledgers(on, ref)
    assert [ok for ok, _ in on["replies"]] == [True, True, False, True]
    assert sum(on[r]["conflicts"] for r in range(4)) >= 1
    assert sum(off[r]["conflicts"] for r in range(4)) == 0


# ---------------------------------------------------------------------
# beside them
# ---------------------------------------------------------------------
def test_batch_composes_with_pre_execution():
    """test_client_batch.py's case: PRE_PROCESS elements of a
    ClientBatchRequestMsg each flow through pre-execution, with the
    reference's blocks."""
    got = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        with pkg["cluster"](f=1, num_clients=1, seed=SEED,
                            handler_factory=_handler(pkg),
                            cfg_overrides=PREEXEC) as cl:
            kv = pkg["skvbc"].SkvbcClient(_pin(cl.client(0)))
            rs = kv.write_batch([[(b"pa", b"1")], [(b"pb", b"2")]],
                                timeout_ms=20000, pre_process=True)
            assert all(r.success for r in rs)
            got[name] = kv.read([b"pa", b"pb"], timeout_ms=20000)
            if name == "port":
                assert cl.replicas[0].preprocessor.m_agreed.value == 2
    assert got["port"] == got["ref"] == {b"pa": b"1", b"pb": b"2"}


def test_port_backups_accept_an_all_pre_executed_pre_prepare():
    """Every request of each PrePrepare is a pre-executed wrapper (no
    client signature of its own, so the backups' batched verify has no
    item): each port backup validates its proof set, executes it through
    apply_pre_executed, and holds the primary's PrePrepare."""
    writes = [([(b"w%d" % i, b"v%d" % i)], [], 0, True) for i in range(4)]
    run = _drive(PORT, writes, PREEXEC)
    assert run["replies"] == [(True, i + 1) for i in range(4)]
    pps = _frames(run, 3, sender=0)
    assert pps
    for _s, _d, raw in pps:
        reqs = port_m.unpack(raw).client_requests()
        assert reqs and all(r.flags & port_m.RequestFlag.HAS_PRE_PROCESSED
                            and r.signature == b"" for r in reqs)
    for r in (1, 2, 3):
        assert run[r]["applied"] == 4 and run[r]["conflicts"] == 0


def test_port_backups_refuse_a_forged_wrapper(monkeypatch):
    """A primary that orders a wrapper whose result is not the one the
    f+1 signatures bind: every port backup's validation refuses the
    PrePrepare, so none executes it and the write never commits."""
    seen = []
    real = port_pre.validate_preprocessed_request

    def spy(replica, req):
        ok = real(replica, req)
        seen.append((replica.id, ok))
        return ok
    monkeypatch.setattr(port_pre, "validate_preprocessed_request", spy)
    with PortCluster(f=1, num_clients=1, seed=SEED,
                     handler_factory=_handler(PORT),
                     cfg_overrides=dict(PREEXEC,
                                        view_change_timer_ms=600_000)
                     ) as cl:
        primary = cl.replicas[0]
        admit = primary._admit_request

        def forge(req):
            if req.flags & port_m.RequestFlag.HAS_PRE_PROCESSED:
                env = port_ser.decode_msg(req.request,
                                          port_m.PreProcessResult)
                env.result = port_skvbc.pack(port_skvbc.WriteRequest(
                    writeset=[(b"k", b"evil")]))
                req.request = port_ser.encode_msg(env)
            return admit(req)
        primary._admit_request = forge
        kv = port_skvbc.SkvbcClient(_pin(cl.client(0)))
        with pytest.raises(Exception):
            kv.write([(b"k", b"honest")], pre_process=True, timeout_ms=3000)
        _wait(lambda: {r for r, ok in seen if not ok} >= {1, 2, 3}, 10,
              "every backup's refusal")
        assert not any(ok for _r, ok in seen)
        for r in (1, 2, 3):
            assert cl.replicas[r].last_executed == 0
            assert cl.handlers[r].blockchain.last_block_id == 0
            assert cl.replicas[r].m_preexec_applied.value == 0


def _stalled_session_run(pkg) -> dict:
    """A pre-executed write, then a second whose session stalls on the
    primary (its PreProcessRequest frames dropped): the backups complain,
    the view changes, and the client's retransmissions start a session
    on the new primary. -> the replies, views, counters and blocks."""
    with pkg["cluster"](f=1, num_clients=1, seed=SEED,
                        handler_factory=_handler(pkg),
                        cfg_overrides=dict(PREEXEC,
                                           view_change_timer_ms=900)) as cl:
        kv = pkg["skvbc"].SkvbcClient(_pin(cl.client(0)))
        first = kv.write([(b"a", b"1")], pre_process=True, timeout_ms=20000)
        primary = cl.replicas[0]
        send = primary.comm.send

        def drop_requests(dest, raw):
            if int.from_bytes(bytes(raw[:2]), "little") not in (21, 25):
                return send(dest, raw)
        primary.comm.send = drop_requests
        second = kv.write([(b"a", b"2")], pre_process=True,
                          timeout_ms=60000)
        _wait(lambda: {h.blockchain.last_block_id
                       for h in cl.handlers.values()} == {2}, 20,
              "every replica's second block")
        return {"replies": [(w.success, w.latest_block)
                            for w in (first, second)],
                "read": kv.read([b"a"]),
                "views": [rep.view for rep in cl.replicas.values()],
                "sessions": [rep.preprocessor.m_sessions.value
                             for rep in cl.replicas.values()],
                "agreed": [rep.preprocessor.m_agreed.value
                           for rep in cl.replicas.values()],
                "blocks": [[h.blockchain.get_raw_block(b) for b in (1, 2)]
                           for h in cl.handlers.values()]}


def test_view_change_during_a_session_reaches_the_new_primary():
    """A session that cannot finish on the primary: a view change, and
    the write commits through a session on the new primary, with the
    reference's replies and blocks on every replica."""
    port = _stalled_session_run(PORT)
    ref = _stalled_session_run(REF)
    assert port["replies"] == ref["replies"] == [(True, 1), (True, 2)]
    assert port["read"] == ref["read"] == {b"a": b"2"}
    assert port["blocks"] == ref["blocks"]
    assert all(b == port["blocks"][0] for b in port["blocks"])
    assert min(port["views"]) >= 1
    # the old primary started both sessions and finished the first only
    assert port["sessions"][0] == 2 and port["agreed"][0] == 1
    assert sum(port["agreed"][1:]) >= 1


def test_stop_shuts_the_preexecution_pool_down():
    """Replica.stop shuts the preprocessor's pool down: after the cluster
    stops no `preexec` worker thread is left."""
    import threading
    with PortCluster(f=1, num_clients=1, seed=SEED,
                     handler_factory=_handler(PORT),
                     cfg_overrides=PREEXEC) as cl:
        kv = port_skvbc.SkvbcClient(cl.client(0))
        assert kv.write([(b"p", b"1")], pre_process=True,
                        timeout_ms=20000).success
        assert any(t.name.startswith("preexec")
                   for t in threading.enumerate())
    _wait(lambda: not any(t.name.startswith("preexec")
                          for t in threading.enumerate()), 10,
          "the preexec pool's threads to exit")


# ---------------------------------------------------------------------
# replica processes
# ---------------------------------------------------------------------
def test_preexecution_conflicts_over_processes(tmp_path, monkeypatch):
    """test_apollo_extended.py:124-146 on four port replica processes on
    this CPU, on kvlog files (`db_dir`), with `--pre-execution`: a
    pre-executed write, a fresh conditional write at its block (commits),
    a stale one at the same block (refused as a conflict), the read
    gives the fresh value; then chip_smoke.py's pre-execution step (the
    card's persistent_cluster runs it) over the same processes, from
    three closed-loop clients."""
    from test_torch_processes import _chip_smoke
    from tpubft_torch import testing
    from tpubft_torch.testing.network import BftTestNetwork, ledger_files
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    smoke = _chip_smoke()
    net = BftTestNetwork(f=1, num_clients=3, seed="port-preexec",
                         device="cpu", crypto_backend="cpu",
                         db_dir=str(tmp_path), pre_execution=True)
    assert all("--pre-execution" in a for a in
               (net.replica_argv(r) for r in range(net.n)))
    try:
        net.start_all(timeout=180)
        kv = net.skvbc_client(0)
        r = kv.write([(b"acct", b"100")], pre_process=True,
                     timeout_ms=30000)
        assert r.success
        v1 = r.latest_block
        r2 = kv.write([(b"acct", b"90")], readset=[b"acct"],
                      read_version=v1, pre_process=True, timeout_ms=30000)
        assert r2.success
        r3 = kv.write([(b"acct", b"80")], readset=[b"acct"],
                      read_version=v1, pre_process=True, timeout_ms=30000)
        assert not r3.success
        assert kv.read([b"acct"]) == {b"acct": b"90"}

        cl = smoke._ProcessCluster("preexec", net, 3, {})
        cl.kvs = [net.skvbc_client(i) for i in range(3)]
        cl.writes = smoke._KvbcbenchWrites(
            cl.kvs, testing.kvbcbench_rows(8), timeout_ms=60000)
        cl.loop = smoke._ClosedLoop(3, cl.writes)
        pre = smoke._preexec_step(cl, 15, reads=10, seed=3, budget_s=120)
        assert not cl.problems, cl.problems
        assert pre["triple"] == [True, True, False]
        assert pre["triple_read"] == {"preexec/acct": "90"}
        assert pre["read_back"]["wrong"] == 0
        assert pre["total"]["agreed"] >= pre["writes_sent"] >= 18
        assert pre["expired"] == 0
        assert all(g["conflicts"] == 1 for g in pre["grew"].values())
        assert pre["blocks_beside_loop"] == 2
        assert len(set(pre["last_executed"])) == 1
    finally:
        net.stop_all()
    # the first triple's two blocks, the loop's and the step's triple's
    files = ledger_files(str(tmp_path), range(4))
    assert files["first_unequal_block"] is None
    assert set(files["last_block_id"].values()) == {
        2 + sum(cl.writes.next_write) + pre["blocks_beside_loop"]}
