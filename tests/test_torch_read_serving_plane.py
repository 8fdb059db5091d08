"""The port's read-scaling serving plane (tpubft_torch/thinreplica/ over
the port's ledger and Replica) on this host's CPU: the counterparts of
tests/test_read_serving_plane.py. Checkpoint-anchored reads (f+1 signed
CheckpointMsgs, the block row hashing to their digest, backward
parent-digest walks) and their rejections, the run-listener feed (the
same runs as the reference's ledger), a gap-free history-to-live handoff
across coalesced seals, a counted subscriber overflow, and the
in-process cluster with `thin_replica_enabled`. Every wait is on state,
with a bound."""
import threading
import time

import pytest

from tpubft.kvbc import BlockUpdates as RBlockUpdates
from tpubft.kvbc import KeyValueBlockchain as RKeyValueBlockchain
from tpubft.storage import MemoryDB as RMemoryDB
from tpubft_torch import device
from tpubft_torch.consensus import messages as cm
from tpubft_torch.crypto.cpu import Ed25519Signer, Ed25519Verifier
from tpubft_torch.kvbc import BLOCK_MERKLE, BlockUpdates, KeyValueBlockchain
from tpubft_torch.storage import MemoryDB
from tpubft_torch.thinreplica import (FilterSpec, ThinReplicaClient,
                                      ThinReplicaServer)
from tpubft_torch.thinreplica import messages as tm


@pytest.fixture(autouse=True)
def _cpu():
    device.set_default_device("cpu")
    yield
    device.set_default_device(None)


def _wait(pred, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def _merkle_chain(n_blocks: int = 5) -> KeyValueBlockchain:
    bc = KeyValueBlockchain(MemoryDB(), use_device_hashing=False)
    for i in range(n_blocks):
        bc.add_block(BlockUpdates().put("kv", b"k%d" % i, b"v%d" % i,
                                        cat_type=BLOCK_MERKLE))
    return bc


def _signers(n: int = 3):
    return {i: Ed25519Signer.generate(seed=bytes([40 + i]) * 32)
            for i in range(n)}


def _cert(signer_id, signer, digest, seq=16):
    ck = cm.CheckpointMsg(sender_id=signer_id, seq_num=seq,
                          state_digest=digest, is_stable=False,
                          res_pages_digest=b"", signature=b"")
    ck.signature = signer.sign(ck.signed_payload())
    return ck.pack()


def _anchor_for(bc, signers, seq=16, block_id=None, digest=None):
    bid = block_id or bc.last_block_id
    digest = digest or bc.block_digest(bid)
    return (seq, bid, tuple(_cert(i, s, digest, seq)
                            for i, s in signers.items()))


def _verifier_fn(signers):
    vs = {i: Ed25519Verifier(s.public_bytes()) for i, s in signers.items()}

    def verify(rid, payload, sig):
        v = vs.get(rid)
        return v is not None and v.verify(payload, sig)
    return verify


def _serve(bc, anchor):
    s = ThinReplicaServer(bc, FilterSpec(category="kv"),
                          anchor_fn=lambda: anchor)
    s.start()
    return s


def test_anchored_verified_reads_latest_and_historical():
    signers = _signers()
    bc = _merkle_chain(5)
    srv = _serve(bc, _anchor_for(bc, signers))
    try:
        trc = ThinReplicaClient([("127.0.0.1", srv.port)], f_val=1,
                                cert_verifier=_verifier_fn(signers))
        assert trc.fetch_anchor() == 5
        assert trc.anchor_block == 5
        assert trc.verified_read("kv", b"k4") == b"v4"
        assert trc.verified_read("kv", b"missing") is None
        assert trc.verified_read("kv", b"k0", block_id=2) == b"v0"
        trc.stop()
    finally:
        srv.stop()


def test_anchor_rejects_insufficient_or_forged_certs():
    signers = _signers()
    bc = _merkle_chain(3)
    digest = bc.block_digest(3)
    rogue = Ed25519Signer.generate(seed=b"\x66" * 32)
    servers = [
        _serve(bc, (16, 3, (_cert(0, signers[0], digest),))),
        _serve(bc, (16, 3, (_cert(0, signers[0], digest),
                            _cert(1, rogue, digest)))),
        _serve(bc, (16, 3, (_cert(0, signers[0], digest),
                            _cert(0, signers[0], digest)))),
        _serve(bc, _anchor_for(bc, signers, digest=b"\x01" * 32)),
    ]
    try:
        for srv in servers:
            trc = ThinReplicaClient([("127.0.0.1", srv.port)], f_val=1,
                                    cert_verifier=_verifier_fn(signers))
            with pytest.raises(ValueError):
                trc.fetch_anchor()
    finally:
        for srv in servers:
            srv.stop()


def test_verified_read_rejects_bitflipped_value_and_wrong_root():
    signers = _signers()
    honest = _merkle_chain(4)
    anchor = _anchor_for(honest, signers)

    class _BitflipServer(ThinReplicaServer):
        def _serve_proof(self, conn, req):
            class _Tap:
                def sendall(self, data):
                    msg = tm.unpack_body(data[4:])
                    if isinstance(msg, tm.ProofReply) and msg.value:
                        msg.value = bytes([msg.value[0] ^ 1]) \
                            + msg.value[1:]
                    conn.sendall(tm.pack(msg))
            ThinReplicaServer._serve_proof(self, _Tap(), req)

    forged = KeyValueBlockchain(MemoryDB(), use_device_hashing=False)
    for i in range(4):
        v = b"evil" if i == 1 else b"v%d" % i
        forged.add_block(BlockUpdates().put("kv", b"k%d" % i, v,
                                            cat_type=BLOCK_MERKLE))
    flip = _BitflipServer(honest, FilterSpec(category="kv"),
                          anchor_fn=lambda: anchor)
    flip.start()
    wrongroot = _serve(forged, anchor)
    try:
        vf = _verifier_fn(signers)
        trc = ThinReplicaClient([("127.0.0.1", flip.port)], f_val=1,
                                cert_verifier=vf)
        assert trc.fetch_anchor() == 4
        with pytest.raises(ValueError, match="match the proven hash"):
            trc.verified_read("kv", b"k0")
        trc_direct = ThinReplicaClient([("127.0.0.1", wrongroot.port)],
                                       f_val=1, cert_verifier=vf)
        with pytest.raises(ValueError, match="hash to the certified"):
            trc_direct.fetch_anchor()
        trc2 = ThinReplicaClient([("127.0.0.1", wrongroot.port),
                                  ("127.0.0.1", flip.port)],
                                 f_val=1, cert_verifier=vf)
        assert trc2.fetch_anchor(server=1) == 4
        with pytest.raises(ValueError,
                           match="not reach the anchored root"):
            trc2.verified_read("kv", b"k1")
        with pytest.raises(ValueError):
            trc2.verified_read("kv", b"k1", block_id=2)
    finally:
        flip.stop()
        wrongroot.stop()


def test_backward_walk_rejects_substituted_parent():
    signers = _signers()
    bc = _merkle_chain(4)
    anchor = _anchor_for(bc, signers)

    class _SubstituteBlock(ThinReplicaServer):
        def _serve_block(self, conn, req):
            from tpubft_torch.kvbc.blockchain import Block
            from tpubft_torch.utils import serialize as ser
            raw = self.bc.get_raw_block(req.block_id) or b""
            if raw and req.block_id == 2:
                blk = ser.decode_msg(raw, Block)
                blk.updates_blob = b"forged"
                raw = ser.encode_msg(blk)
            conn.sendall(tm.pack(tm.BlockReply(block_id=req.block_id,
                                               raw=raw)))

    srv = _SubstituteBlock(bc, FilterSpec(category="kv"),
                           anchor_fn=lambda: anchor)
    srv.start()
    try:
        trc = ThinReplicaClient([("127.0.0.1", srv.port)], f_val=1,
                                cert_verifier=_verifier_fn(signers))
        assert trc.fetch_anchor() == 4
        with pytest.raises(ValueError, match="hash chain broken"):
            trc.verified_read("kv", b"k1", block_id=2)
    finally:
        srv.stop()


def _feed(bc, bu_cls):
    runs, blocks = [], []
    bc.add_run_listener(lambda items: runs.append([b for b, _ in items]))
    bc.add_listener(lambda bid, _bu: blocks.append(bid))
    bc.add_block(bu_cls().put("kv", b"a", b"1"))
    bc.add_blocks([bu_cls().put("kv", b"b%d" % i, b"x") for i in range(3)])
    bc.begin_accumulation()
    bc.add_block(bu_cls().put("kv", b"c", b"1"))
    bc.add_block(bu_cls().put("kv", b"d", b"1"))
    bc.end_accumulation()
    return runs, blocks


def test_run_listener_fires_once_per_atomic_commit():
    runs, blocks = _feed(KeyValueBlockchain(MemoryDB(),
                                            use_device_hashing=False),
                         BlockUpdates)
    assert runs == [[1], [2, 3, 4], [5, 6]]
    assert blocks == [1, 2, 3, 4, 5, 6]
    assert (runs, blocks) == _feed(
        RKeyValueBlockchain(RMemoryDB(), use_device_hashing=False),
        RBlockUpdates)


def test_gap_free_history_to_live_handoff_across_coalesced_seals():
    chains = [KeyValueBlockchain(MemoryDB(), use_device_hashing=False)
              for _ in range(3)]

    def seal(lo, hi):
        for bc in chains:
            bc.add_blocks([BlockUpdates().put("kv", b"k%03d" % i,
                                              b"v%d" % i)
                           for i in range(lo, hi)])

    seal(0, 6)
    servers = []
    for bc in chains:
        s = ThinReplicaServer(bc, FilterSpec(category="kv"))
        s.start()
        servers.append(s)
    try:
        trc = ThinReplicaClient([("127.0.0.1", s.port) for s in servers],
                                f_val=1)
        got = []
        done = threading.Event()

        def cb(block_id, kv):
            got.append((block_id, dict(kv)))
            if block_id >= 12:
                done.set()
        trc.subscribe(cb, start_block=2)
        _wait(lambda: len(got) >= 5, 10, "the history, blocks 2-6")
        seal(6, 9)
        seal(9, 12)
        assert done.wait(timeout=15), f"stream stalled: {got}"
        trc.stop()
        assert [b for b, _ in got] == list(range(2, 13)), \
            f"gap/dup across the handoff: {got}"
        for b, kv in got:
            assert kv == {b"k%03d" % (b - 1): b"v%d" % (b - 1)}
    finally:
        for s in servers:
            s.stop()


def test_subscriber_overflow_is_counted_not_silent():
    from tpubft_torch.thinreplica.server import _Subscriber
    bc = KeyValueBlockchain(MemoryDB(), use_device_hashing=False)
    srv = ThinReplicaServer(bc, FilterSpec(category="kv"), sub_buffer=2)
    sub = _Subscriber(start_block=1, maxsize=2)
    with srv._subs_lock:
        srv._subs.append(sub)
    for i in range(3):
        bc.add_block(BlockUpdates().put("kv", b"x%d" % i, b"y"))
    assert sub.dead
    assert srv.m_overflows.value == 1
    assert srv.m_dropped_subs.value == 1
    assert srv.m_subscribers.value == 0
    assert srv.m_pushed_runs.value == 3
    srv.stop()


def test_cluster_anchor_and_verified_reads():
    """thin_replica_enabled wires the server into the port Replica's
    start; the dispatcher publishes the f+1-signed anchor at checkpoint
    quorum; a client verifies reads against it."""
    from tpubft_torch.apps import skvbc
    from tpubft_torch.testing.cluster import InProcessCluster
    from tpubft_torch.thinreplica import keys_cert_verifier

    def hf(_r=None):
        return skvbc.SkvbcHandler(
            KeyValueBlockchain(MemoryDB(), use_device_hashing=False),
            merkle=True)

    ov = dict(thin_replica_enabled=True, checkpoint_window_size=8,
              work_window_size=16, crypto_backend="cpu")
    with InProcessCluster(f=1, handler_factory=hf,
                          cfg_overrides=ov) as cl:
        kv = skvbc.SkvbcClient(cl.client(0))
        for i in range(10):
            assert kv.write([(b"k%d" % i, b"v%d" % i)],
                            timeout_ms=20000).success
        eps = [("127.0.0.1", cl.replicas[r].thin_replica.port)
               for r in range(4)]
        trc = ThinReplicaClient(eps, f_val=1,
                                cert_verifier=keys_cert_verifier(cl.keys))
        deadline = time.monotonic() + 20
        bid = None
        while time.monotonic() < deadline and not bid:
            bid = trc.fetch_anchor()
            if not bid:
                time.sleep(0.05)
        assert bid and bid >= 8, f"anchor never formed: {bid}"
        assert trc.verified_read("kv", b"k0") == b"v0"
        assert trc.verified_read("kv", b"k0",
                                 block_id=max(1, bid - 2)) == b"v0"
        assert trc.verified_read("kv", b"absent") is None
        trc.stop()
        proofs = sum(cl.aggregators[r].get("thinreplica", "counters",
                                           "trs_proofs") or 0
                     for r in range(4))
        runs = sum(cl.aggregators[r].get("thinreplica", "counters",
                                         "trs_pushed_runs") or 0
                   for r in range(4))
        assert proofs >= 3 and runs > 0
