"""The port's thin-replica read tier (tpubft_torch/thinreplica/) held to
the reference's (tpubft/thinreplica/) on this host's CPU: the
counterparts of tests/test_thinreplica.py on the port's servers and
client, the wire bytes of every message and of the per-block update
hash on seeded inputs, the replies of a port server and a reference
server over the same ledger rows (carried across by convert.py), and
each package's client against the other's servers. Every wait is on
state, with a bound."""
import hashlib
import random
import socket
import struct
import threading
import time

import pytest

from tpubft.crypto.cpu import Ed25519Signer as RSigner
from tpubft.kvbc import BLOCK_MERKLE as R_BLOCK_MERKLE
from tpubft.kvbc import BlockUpdates as RBlockUpdates
from tpubft.kvbc import KeyValueBlockchain as RKeyValueBlockchain
from tpubft.consensus import messages as rcm
from tpubft.storage import MemoryDB as RMemoryDB
from tpubft.thinreplica import FilterSpec as RFilterSpec
from tpubft.thinreplica import ThinReplicaClient as RClient
from tpubft.thinreplica import ThinReplicaServer as RServer
from tpubft.thinreplica import messages as rtm
from tpubft_torch import convert
from tpubft_torch.crypto.cpu import Ed25519Verifier
from tpubft_torch.kvbc import BLOCK_MERKLE, BlockUpdates, KeyValueBlockchain
from tpubft_torch.storage import MemoryDB
from tpubft_torch.thinreplica import (FilterSpec, ThinReplicaClient,
                                      ThinReplicaServer)
from tpubft_torch.thinreplica import messages as tm


def _wait(pred, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def _chain_with(n_blocks: int) -> KeyValueBlockchain:
    bc = KeyValueBlockchain(MemoryDB(), use_device_hashing=False)
    for i in range(n_blocks):
        bu = BlockUpdates().put("kv", f"key-{i}".encode(),
                                f"val-{i}".encode())
        bu.put("other", b"hidden", b"x")  # filtered out
        bc.add_block(bu)
    return bc


def _servers(chains):
    servers = []
    for bc in chains:
        s = ThinReplicaServer(bc, FilterSpec(category="kv"))
        s.start()
        servers.append(s)
    return servers


def _eps(servers):
    return [("127.0.0.1", s.port) for s in servers]


def _merkle_chain() -> KeyValueBlockchain:
    bc = KeyValueBlockchain(MemoryDB(), use_device_hashing=False)
    bc.add_block(BlockUpdates().put("m", b"k", b"v1",
                                    cat_type=BLOCK_MERKLE))
    bc.add_block(BlockUpdates().put("m", b"k", b"v2",
                                    cat_type=BLOCK_MERKLE))
    bc.add_block(BlockUpdates().delete("m", b"k", cat_type=BLOCK_MERKLE))
    return bc


# ----------------------------------------------------------------------
# counterparts of tests/test_thinreplica.py
# ----------------------------------------------------------------------

def test_update_hash_canonical():
    kv = [(b"b", b"2"), (b"a", b"1")]
    assert tm.update_hash(5, kv) == tm.update_hash(5, list(reversed(kv)))
    assert tm.update_hash(5, kv) != tm.update_hash(6, kv)
    assert tm.update_hash(5, kv) != tm.update_hash(5, [(b"a", b"1")])


def test_read_state_with_hash_quorum():
    servers = _servers([_chain_with(4) for _ in range(3)])
    try:
        trc = ThinReplicaClient(_eps(servers), f_val=1)
        assert trc.read_state() == {f"key-{i}".encode(): f"val-{i}".encode()
                                    for i in range(4)}
    finally:
        for s in servers:
            s.stop()


def test_versioned_proof_over_thin_replica():
    servers = _servers([_merkle_chain() for _ in range(3)])
    try:
        trc = ThinReplicaClient(_eps(servers), f_val=1)
        assert trc.verified_proof("m", b"k", 1, value=b"v1") == \
            hashlib.sha256(b"v1").digest()
        assert trc.verified_proof("m", b"k", 2, value=b"v2") == \
            hashlib.sha256(b"v2").digest()
        assert trc.verified_proof("m", b"k", 3) is None  # deleted
        with pytest.raises(ValueError):
            trc.verified_proof("m", b"k", 1, value=b"forged")
    finally:
        for s in servers:
            s.stop()


def test_versioned_proof_rejects_block_substitution():
    class _SubstitutingServer(ThinReplicaServer):
        def _serve_proof(self, conn, req):
            req.block_id = 1            # substitute pre-delete state
            super()._serve_proof(conn, req)

    chains = [_merkle_chain() for _ in range(3)]
    evil = _SubstitutingServer(chains[0], FilterSpec(category="kv"))
    evil.start()
    servers = [evil] + _servers(chains[1:])
    try:
        trc = ThinReplicaClient(_eps(servers), f_val=1)
        with pytest.raises(ValueError, match="asked 3"):
            trc.verified_proof("m", b"k", 3)
    finally:
        for s in servers:
            s.stop()


def test_versioned_proof_detects_lying_data_server():
    forged = KeyValueBlockchain(MemoryDB(), use_device_hashing=False)
    for v in (b"v1", b"evil"):
        forged.add_block(BlockUpdates().put("m", b"k", v,
                                            cat_type=BLOCK_MERKLE))
    forged.add_block(BlockUpdates().delete("m", b"k",
                                           cat_type=BLOCK_MERKLE))
    servers = _servers([forged] + [_merkle_chain() for _ in range(2)])
    try:
        trc = ThinReplicaClient(_eps(servers), f_val=1)
        with pytest.raises(ValueError):
            trc.verified_proof("m", b"k", 2)
        assert trc.verified_proof("m", b"k", 1) == \
            hashlib.sha256(b"v1").digest()
    finally:
        for s in servers:
            s.stop()


def test_read_state_detects_forged_data_server():
    forged = _chain_with(3)
    forged.add_block(BlockUpdates().put("kv", b"evil", b"1"))
    servers = _servers([forged] + [_chain_with(3) for _ in range(2)])
    try:
        trc = ThinReplicaClient(_eps(servers), f_val=1)
        with pytest.raises(ValueError):
            trc.read_state()
    finally:
        for s in servers:
            s.stop()


def test_live_subscription_and_catchup():
    chains = [_chain_with(3) for _ in range(3)]
    servers = _servers(chains)
    try:
        trc = ThinReplicaClient(_eps(servers), f_val=1)
        got = []
        trc.subscribe(lambda b, kv: got.append((b, dict(kv))),
                      start_block=1)
        _wait(lambda: len(got) >= 3, 10, "the history")
        for i in (3, 4):
            for bc in chains:
                bc.add_block(BlockUpdates().put(
                    "kv", f"live-{i}".encode(), str(i).encode()))
        _wait(lambda: len(got) >= 5, 10, f"the live blocks: {got}")
        trc.stop()
        assert [b for b, _ in got] == [1, 2, 3, 4, 5]
        assert got[0] == (1, {b"key-0": b"val-0"})
        assert got[-1][1] == {b"live-4": b"4"}
    finally:
        for s in servers:
            s.stop()


def test_subscription_rotates_away_from_dead_data_server():
    chains = [_chain_with(2) for _ in range(3)]
    servers = _servers(chains)
    try:
        trc = ThinReplicaClient(_eps(servers), f_val=1)
        trc.STALL_TIMEOUT_S = 1.0
        got = []
        trc.subscribe(lambda b, kv: got.append(b), start_block=1)
        _wait(lambda: got == [1, 2], 10, "blocks 1 and 2")
        gen = trc._generation
        # the data server's stream ends (its subscription thread sees the
        # stop within one buffer poll) before block 3 is committed
        servers[0].stop()
        _wait(lambda: servers[0].m_subscribers.value == 0, 10,
              "the data server's stream to end")
        for bc in chains:
            bc.add_block(BlockUpdates().put("kv", b"k3", b"3"))
        _wait(lambda: 3 in got, 15, f"rotation to recover: {got}")
        trc.stop()
        assert got == [1, 2, 3] and trc._generation > gen
    finally:
        for s in servers:
            s.stop()


def test_subscription_rejects_unconfirmed_updates():
    honest = [_chain_with(2) for _ in range(2)]
    lying = _chain_with(2)
    servers = _servers([lying] + honest)
    try:
        trc = ThinReplicaClient(_eps(servers), f_val=1)
        got = []
        trc.subscribe(lambda b, kv: got.append(b), start_block=1)
        _wait(lambda: got == [1, 2], 10, "the agreed prefix")
        # only the data server commits block 3: its update reaches the
        # client, and is withheld without f matching hashes
        lying.add_block(BlockUpdates().put("kv", b"fake", b"x"))
        _wait(lambda: 3 in trc._pending_data, 10, "block 3's data")
        assert got == [1, 2]
        # the honest servers commit a DIFFERENT block 3: its hash comes,
        # and never matches
        for bc in honest:
            bc.add_block(BlockUpdates().put("kv", b"real", b"y"))
        _wait(lambda: 3 in trc._hash_votes, 10, "block 3's hash")
        trc._try_deliver()
        assert got == [1, 2]
        trc.stop()
    finally:
        for s in servers:
            s.stop()


# ----------------------------------------------------------------------
# wire bytes against the reference
# ----------------------------------------------------------------------

def _seeded_fields(cls, rng):
    out = {}
    for name, kind in cls.SPEC:
        if kind == "u64":
            out[name] = rng.randrange(1 << 40)
        elif kind == "bytes":
            out[name] = rng.randbytes(rng.randrange(0, 40))
        elif kind == "str":
            out[name] = "".join(rng.choice("abcxyz ") for _ in
                                range(rng.randrange(12)))
        elif kind == "bool":
            out[name] = bool(rng.randrange(2))
        elif kind == ("list", "bytes"):
            out[name] = [rng.randbytes(rng.randrange(1, 33))
                         for _ in range(rng.randrange(4))]
        elif kind == ("list", ("pair", "bytes", "bytes")):
            out[name] = [(rng.randbytes(rng.randrange(1, 9)),
                          rng.randbytes(rng.randrange(0, 9)))
                         for _ in range(rng.randrange(5))]
        else:
            raise AssertionError(f"{cls.__name__}.{name}: {kind}")
    return out


@pytest.mark.parametrize("msg_id", sorted(tm._TYPES))
def test_messages_pack_and_unpack_like_the_reference(msg_id):
    pcls, rcls = tm._TYPES[msg_id], rtm._TYPES[msg_id]
    assert pcls.__name__ == rcls.__name__ and pcls.SPEC == rcls.SPEC
    rng = random.Random(1000 + msg_id)
    for _ in range(8):
        fields = _seeded_fields(pcls, rng)
        raw = tm.pack(pcls(**fields))
        assert raw == rtm.pack(rcls(**fields))
        assert tm.unpack_body(raw[4:]) == pcls(**fields)
        assert vars(rtm.unpack_body(raw[4:])) == vars(pcls(**fields))
    with pytest.raises(Exception):
        tm.unpack_body(bytes([99]))


def test_update_hash_equals_the_reference_on_seeded_inputs():
    rng = random.Random(7)
    for _ in range(50):
        kv = [(rng.randbytes(rng.randrange(0, 12)),
               rng.randbytes(rng.randrange(0, 30)))
              for _ in range(rng.randrange(6))]
        bid = rng.randrange(1 << 50)
        assert tm.update_hash(bid, kv) == rtm.update_hash(bid, kv)


# ----------------------------------------------------------------------
# a port server and a reference server over the same ledger rows
# ----------------------------------------------------------------------

def _ref_signers(n: int = 3):
    return {i: RSigner.generate(seed=bytes([60 + i]) * 32)
            for i in range(n)}


def _ref_anchor(bc, signers, seq=16):
    bid = bc.last_block_id
    digest = bc.block_digest(bid)
    certs = []
    for i, s in signers.items():
        ck = rcm.CheckpointMsg(sender_id=i, seq_num=seq,
                               state_digest=digest, is_stable=False,
                               res_pages_digest=b"", signature=b"")
        ck.signature = s.sign(ck.signed_payload())
        certs.append(ck.pack())
    return (seq, bid, tuple(certs))


def _verifier_fn(signers):
    vs = {i: Ed25519Verifier(s.public_bytes()) for i, s in signers.items()}

    def verify(rid, payload, sig):
        v = vs.get(rid)
        return v is not None and v.verify(payload, sig)
    return verify


def _paired_ledgers(n_blocks: int = 12):
    """A reference ledger of seeded BLOCK_MERKLE and versioned rows
    (overwrites and deletes among them) and the port's ledger on the
    same DB rows."""
    rng = random.Random(21)
    rbc = RKeyValueBlockchain(RMemoryDB(), use_device_hashing=False)
    for b in range(n_blocks):
        rows = []
        for _ in range(rng.randrange(1, 4)):
            key = b"k%d" % rng.randrange(6)
            value = None if rng.randrange(5) == 0 else rng.randbytes(12)
            rows.append(("kv", key, value, R_BLOCK_MERKLE))
        rows.append(("other", b"v%d" % b, rng.randbytes(5), "versioned_kv"))
        rbc.add_block(convert.block_updates(rows, RBlockUpdates))
    pbc = KeyValueBlockchain(convert.memorydb_from_rows(rbc._db.scan_all()),
                             use_device_hashing=False)
    assert pbc.last_block_id == rbc.last_block_id == n_blocks
    return rbc, pbc


def _exchange(port: int, requests) -> list:
    """Each request's raw reply frame, over one pipelined connection."""
    out = []
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        for req in requests:
            s.sendall(rtm.pack(req))
            hdr = b""
            while len(hdr) < 4:
                hdr += s.recv(4 - len(hdr))
            (n,) = struct.unpack("<I", hdr)
            body = b""
            while len(body) < n:
                body += s.recv(n - len(body))
            out.append(hdr + body)
    return out


def test_proof_anchor_and_block_replies_equal_the_reference():
    rbc, pbc = _paired_ledgers()
    anchor = _ref_anchor(rbc, _ref_signers())
    rsrv = RServer(rbc, RFilterSpec(category="kv"), anchor_fn=lambda: anchor)
    psrv = ThinReplicaServer(pbc, FilterSpec(category="kv"),
                             anchor_fn=lambda: anchor)
    rsrv.start()
    psrv.start()
    try:
        reqs = [rtm.ReadProofRequest(block_id=b, category="kv",
                                     key=b"k%d" % k)
                for b in (0, 1, 4, 7, 12) for k in range(7)]
        reqs += [rtm.AnchorRequest(), rtm.BlockRequest(block_id=5),
                 rtm.BlockRequest(block_id=40),
                 rtm.ReadStateHashRequest(block_id=6),
                 rtm.ReadStateHashRequest(block_id=0),
                 rtm.ReadProofRequest(block_id=99, category="kv", key=b"k1")]
        theirs = _exchange(rsrv.port, reqs)
        ours = _exchange(psrv.port, reqs)
        kinds = {type(tm.unpack_body(r[4:])).__name__ for r in ours}
        assert {"ProofReply", "AnchorReply", "BlockReply", "StateDone",
                "ProtocolError"} <= kinds
        assert ours == theirs
        assert psrv.m_proofs.value == rsrv.m_proofs.value == 35
        assert psrv.m_anchors.value == 1
    finally:
        rsrv.stop()
        psrv.stop()


# ----------------------------------------------------------------------
# each package's client against the other's servers
# ----------------------------------------------------------------------

def _mixed_servers(server_cls, spec_cls, chains, anchors):
    servers = []
    for bc, anchor in zip(chains, anchors):
        s = server_cls(bc, spec_cls(category="kv"),
                       anchor_fn=lambda a=anchor: a)
        s.start()
        servers.append(s)
    return servers


@pytest.mark.parametrize("side", ["reference_client_port_servers",
                                  "port_client_reference_servers"])
def test_clients_and_servers_across_packages(side):
    signers = _ref_signers()
    pairs = [_paired_ledgers() for _ in range(3)]
    anchor = _ref_anchor(pairs[0][0], signers)
    if side == "reference_client_port_servers":
        chains = [p for _r, p in pairs]
        servers = _mixed_servers(ThinReplicaServer, FilterSpec, chains,
                                 [anchor] * 3)
        client_cls = RClient
        add = (lambda bc, k, v: bc.add_block(
            BlockUpdates().put("kv", k, v, cat_type=BLOCK_MERKLE)))
    else:
        chains = [r for r, _p in pairs]
        servers = _mixed_servers(RServer, RFilterSpec, chains, [anchor] * 3)
        client_cls = ThinReplicaClient
        add = (lambda bc, k, v: bc.add_block(
            RBlockUpdates().put("kv", k, v, cat_type=R_BLOCK_MERKLE)))
    try:
        trc = client_cls(_eps(servers), f_val=1,
                         cert_verifier=_verifier_fn(signers))
        # the snapshot reads the versioned "latest" family, which a
        # BLOCK_MERKLE category leaves empty, in both packages
        assert trc.read_state() == RClient(_eps(servers),
                                           f_val=1).read_state() == {}
        rbc = pairs[0][0]
        latest = {k: hit[1] for k in (b"k%d" % i for i in range(6))
                  if (hit := rbc.get_latest("kv", k,
                                            cat_type=R_BLOCK_MERKLE))}
        assert len(latest) >= 2
        for key, value in sorted(latest.items()):
            assert trc.verified_proof("kv", key, 12, value=value) == \
                hashlib.sha256(value).digest()
        assert trc.fetch_anchor() == 12
        for key, value in sorted(latest.items()):
            assert trc.verified_read("kv", key) == value
        assert trc.verified_read("kv", b"absent") is None
        trc.stop()
        # a subscriber of its own: read_state moved trc's cursor to 12
        sub = client_cls(_eps(servers), f_val=1)
        got = []
        sub.subscribe(lambda b, kv: got.append((b, dict(kv))),
                      start_block=10)
        _wait(lambda: len(got) >= 3, 10, "blocks 10-12")
        for bc in chains:
            add(bc, b"live", b"1")
        _wait(lambda: len(got) >= 4, 10, f"block 13: {got}")
        sub.stop()
        assert [b for b, _ in got] == [10, 11, 12, 13]
        assert got[-1] == (13, {b"live": b"1"})
    finally:
        for s in servers:
            s.stop()


def test_trs_follow_writes_each_verified_block(tmp_path):
    """python -m tpubft_torch.tools.trs_follow: each block that f+1
    servers agree on, one JSON line with its kv in hex; a rotation away
    from a dead data source, a generation line; it ends when its
    standard input closes."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    chains = [_chain_with(3) for _ in range(3)]
    servers = _servers(chains)
    out = tmp_path / "stream.jsonl"
    argv = [sys.executable, "-m", "tpubft_torch.tools.trs_follow",
            "--f", "1", "--out", str(out), "--exit-on-stdin-eof"]
    for _host, port in _eps(servers):
        argv += ["--endpoint", f"127.0.0.1:{port}"]
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.Popen(argv, stdin=subprocess.PIPE, cwd=root, env=env)

    def lines():
        if not out.exists():
            return []
        return [json.loads(x) for x in out.read_text().splitlines()]
    try:
        _wait(lambda: len(lines()) >= 3, 30, "blocks 1-3")
        assert [x["block"] for x in lines()] == [1, 2, 3]
        assert lines()[0]["kv"] == [[b"key-0".hex(), b"val-0".hex()]]
        # the data source dies; block 4 comes from the next one
        servers[0].stop()
        _wait(lambda: servers[0].m_subscribers.value == 0, 10,
              "the data server's stream to end")
        for bc in chains:
            bc.add_block(BlockUpdates().put("kv", b"k4", b"4"))
        _wait(lambda: any(x.get("block") == 4 for x in lines())
              and any("generation" in x for x in lines()), 30,
              "block 4 and a rotation")
        assert [x["generation"] for x in lines() if "generation" in x] \
            == [1]
        proc.stdin.close()
        assert proc.wait(30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for s in servers:
            s.stop()
