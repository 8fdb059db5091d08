"""ECDSA client signatures through the port's entry points, against the
reference, exactly (tolerance: none; verdicts, counters and ledger bytes):

  * SigManager over crypto.cuda.verify_batch_mixed on a corpus that mixes
    Ed25519 replicas with secp256k1 or P-256 clients (valid, forged, junk
    and host-invalid signatures), with the ECDSA crossover at 1 << 30
    (the batched host engine: `ecdsa_batched_host`, `ecdsa_host_us`,
    `pubkey_memo_hits` and the host-batch histogram count) and at 1 (the
    RLC path, here the plain fold on CPU tensors): the verdicts of the
    reference's scalar SigManager, and the routing knobs of crypto/cuda;
  * a degraded device batch (the breaker open) rides the host engines
    and is counted;
  * an n=4 InProcessCluster whose clients sign with secp256k1 commits
    SKVBC writes on the CPU with the same replies, blocks and state
    digests as the reference's cluster (its OpenSSL branch off, so that
    both sign by RFC 6979), and a P-256 cluster commits and agrees.
"""
import time

import pytest
import torch

from tpubft.consensus import keys as RK
from tpubft.consensus import sig_manager as RSM
from tpubft.crypto import cpu as RC
from tpubft.kvbc.blockchain import KeyValueBlockchain as RefChain
from tpubft.storage.memorydb import MemoryDB as RefDB
from tpubft.testing import InProcessCluster as RefCluster
from tpubft.apps import skvbc as ref_skvbc
from tpubft.utils import config as RCFG
from tpubft_torch import convert, device
from tpubft_torch.apps import skvbc as port_skvbc
from tpubft_torch.consensus import keys as K
from tpubft_torch.consensus import sig_manager as SM
from tpubft_torch.crypto import cuda as C
from tpubft_torch.crypto import scalar as S
from tpubft_torch.diagnostics import get_registrar
from tpubft_torch.kvbc.blockchain import KeyValueBlockchain as PortChain
from tpubft_torch.ops import ecdsa as E
from tpubft_torch.ops.dispatch import device_breaker
from tpubft_torch.storage.memorydb import MemoryDB as PortDB
from tpubft_torch.testing import InProcessCluster as PortCluster
from tpubft_torch.utils import config as PCFG

torch.set_num_threads(1)

SEED = b"torch-ecdsa-plane"


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    device.set_default_device("cpu")
    monkeypatch.delenv("TPUBFT_ECDSA_CROSSOVER_B", raising=False)
    device_breaker().reset()
    yield
    device_breaker().reset()
    device.set_default_device(None)


def _keys(pkg_keys, pkg_cfg, scheme):
    cfg = pkg_cfg.ReplicaConfig(f_val=1, num_of_client_proxies=3,
                                client_sig_scheme=scheme)
    return cfg, pkg_keys.ClusterKeys.generate(cfg, 3, seed=SEED)


def _corpus(cfg, keys, sig_manager_cls):
    """Three clients' valid requests, a replica's message, a forged
    request, a junk signature and a second round of the valid ones:
    (items, verdicts)."""
    cid = cfg.n_val + cfg.num_ro_replicas
    items = []
    for j in range(3):
        sm = sig_manager_cls(keys.for_node(cid + j))
        for k in range(2):
            msg = b"req-%d-%d" % (j, k)
            items.append((cid + j, msg, sm.sign(msg)))
    rsig = sig_manager_cls(keys.for_node(1)).sign(b"replica-msg")
    items.append((1, b"replica-msg", rsig))
    items.append((cid, b"forged", items[1][2]))
    items.append((cid + 1, items[2][1], b"\x00" * 64))
    return items, [True] * 7 + [False, False]


@pytest.fixture
def no_openssl(monkeypatch):
    monkeypatch.setattr(RC, "_openssl", lambda: None)


@pytest.mark.parametrize("scheme", ["ecdsa-secp256k1", "ecdsa-p256"])
def test_sig_manager_on_the_host_engine_matches_the_reference(no_openssl,
                                                              scheme):
    """Crossover 1 << 30 (the CPU's default): every ECDSA group rides the
    batched host engine, whose counters land in this manager's metrics."""
    cfg, keys = _keys(K, PCFG, scheme)
    rcfg, rkeys = _keys(RK, RCFG, scheme)
    assert keys.client_pubkeys == rkeys.client_pubkeys
    items, want = _corpus(cfg, keys, SM.SigManager)
    ritems, _ = _corpus(rcfg, rkeys, RSM.SigManager)
    assert items == ritems
    assert C.ecdsa_crossover() == 1 << 30
    S.reset_ecdsa_caches()
    sm = SM.SigManager(keys.for_node(0), batch_fn=C.verify_batch_mixed,
                       device_min_batch=1, memo_capacity=0)
    ref = RSM.SigManager(rkeys.for_node(0), memo_capacity=0)
    for _ in range(2):
        assert sm.verify_batch(items) == ref.verify_batch(items) == want
    c = sm.metrics.snapshot()["counters"]
    ecdsa_items = 2 * (len(items) - 1)
    assert c["ecdsa_batched_host"] == ecdsa_items
    # 7 of the 8 ECDSA items a call decode their key (not the junk
    # signature's), 3 distinct keys: 3 misses, the rest memo hits
    assert c["pubkey_memo_hits"] == 2 * 7 - 3
    assert c["ecdsa_host_us"] > 0
    assert c["degraded_verifies"] == 0 and c["scalar_fallbacks"] == 0
    assert c["sigs_device_dispatched"] == 2 * len(items)
    hist = get_registrar().histogram_snapshot("sigmgr0.ecdsa_host_batch")
    assert hist is not None and hist["count"] >= 2


def test_sig_manager_on_the_rlc_path_matches_the_reference(no_openssl,
                                                          monkeypatch):
    """Crossover 1: the ECDSA group rides rlc_verify_batch (the plain fold
    on CPU tensors): one launch for the clean group, the host engine
    untouched; the verdicts of the reference's scalar SigManager. The
    config's device_min_verify_batch (32) holds back the one Ed25519
    item alone: it verifies on the host."""
    cfg, keys = _keys(K, PCFG, "ecdsa-secp256k1")
    rcfg, rkeys = _keys(RK, RCFG, "ecdsa-secp256k1")
    items, want = _corpus(cfg, keys, SM.SigManager)
    clean = [it for it, ok in zip(items, want) if ok] + [items[-1]]
    monkeypatch.setenv("TPUBFT_ECDSA_CROSSOVER_B", "1")
    assert C.ecdsa_crossover() == 1
    E.reset_counts()
    sm = SM.SigManager(keys.for_node(0), batch_fn=C.verify_batch_mixed,
                       device_min_batch=cfg.device_min_verify_batch,
                       memo_capacity=0)
    ref = RSM.SigManager(rkeys.for_node(0), memo_capacity=0)
    assert sm.verify_batch(clean) == ref.verify_batch(clean) == \
        [True] * 7 + [False]
    assert E.COUNTS["secp256k1"]["rlc_launches"] == 1
    assert E.COUNTS["secp256k1"]["lanes"] == 6     # the junk sig is not live
    c = sm.metrics.snapshot()["counters"]
    assert c["ecdsa_batched_host"] == 0 and c["degraded_verifies"] == 0
    assert c["pubkey_memo_hits"] >= 3
    assert cfg.device_min_verify_batch == 32
    assert c["sigs_device_dispatched"] == len(clean) - 1
    assert c["scalar_fallbacks"] == 1


def test_cluster_keys_from_public_take_ecdsa_clients(no_openssl):
    """The reference's public material with 65-byte SEC1 client keys
    carried across: the port's SigManager verifies its clients."""
    rcfg, rkeys = _keys(RK, RCFG, "ecdsa-p256")
    systems = {attr: (getattr(rkeys, attr).threshold_,
                      getattr(rkeys, attr).share_public_keys)
               for attr in ("slow_path_system", "commit_path_system",
                            "optimistic_system")}
    ck = convert.cluster_keys_from_public(
        rkeys.n, rkeys.f, rkeys.c, rkeys.threshold_scheme,
        rkeys.replica_pubkeys, rkeys.client_pubkeys, systems,
        operator_id=rkeys.operator_id, client_sig_scheme="ecdsa-p256")
    assert all(len(pk) == 65 for pk in ck.client_pubkeys.values())
    items, want = _corpus(rcfg, rkeys, RSM.SigManager)
    sm = SM.SigManager(ck, batch_fn=C.verify_batch_mixed, memo_capacity=0)
    assert sm.verify_batch(items) == want


def test_crossover_knobs(monkeypatch):
    assert C.ecdsa_crossover() == 1 << 30        # the CPU's default
    monkeypatch.setenv("TPUBFT_ECDSA_CROSSOVER_B", "7")
    assert C.ecdsa_crossover() == 7
    monkeypatch.setenv("TPUBFT_ECDSA_CROSSOVER_B", "many")
    assert C.ecdsa_crossover() == 1 << 30        # a malformed knob is ignored
    monkeypatch.delenv("TPUBFT_ECDSA_CROSSOVER_B")
    device.set_default_device(None)
    if torch.cuda.is_available():
        assert C.ecdsa_crossover() == C.CARD_ECDSA_CROSSOVER


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="needs a host without a card")
def test_ecdsa_group_without_a_card_raises_no_device(no_openssl):
    """No card and no request for the CPU: an ECDSA group raises
    device.NoDevice (from the crossover's default), never verifies on
    the host engine unasked."""
    cfg, keys = _keys(K, PCFG, "ecdsa-secp256k1")
    items, _ = _corpus(cfg, keys, SM.SigManager)
    pk = keys.client_pubkeys[items[0][0]]
    device.set_default_device(None)
    with pytest.raises(device.NoDevice):
        C.verify_batch_mixed([("ecdsa-secp256k1", pk, items[0][1],
                               items[0][2])])
    sm = SM.SigManager(keys.for_node(0), batch_fn=C.verify_batch_mixed,
                       device_min_batch=32, memo_capacity=0)
    with pytest.raises(device.NoDevice):
        sm.verify_batch(items[:2])


def test_breaker_open_rides_the_host_engines(no_openssl):
    cfg, keys = _keys(K, PCFG, "ecdsa-secp256k1")
    items, want = _corpus(cfg, keys, SM.SigManager)
    device_breaker().trip()
    sm = SM.SigManager(keys.for_node(0), batch_fn=C.verify_batch_mixed,
                       device_min_batch=1, memo_capacity=0)
    assert sm.verify_batch(items) == want
    c = sm.metrics.snapshot()["counters"]
    assert c["degraded_verifies"] == len(items)
    assert c["scalar_fallbacks"] == len(items)
    assert c["ecdsa_batched_host"] >= 2


# ---- clusters whose clients sign with ECDSA ----

BASE = dict(autotune_enabled=False, crypto_backend="cpu")


def _pin(client, start=5_000_000):
    """Deterministic request ids and correlation ids for one client."""
    client._req_seq = start
    orig = client._new_request_locked

    def pinned(payload, flags, cid, quorum):
        return orig(payload, flags, f"ecdsa-{client._req_seq + 1}", quorum)
    client._new_request_locked = pinned
    return client


def _drive(cluster_cls, skvbc, chain, memdb, scheme, writes=6,
           budget_s=120):
    def handler(_r=None):
        return skvbc.SkvbcHandler(chain(memdb(), use_device_hashing=False))

    with cluster_cls(f=1, num_clients=1, seed=SEED, handler_factory=handler,
                     cfg_overrides=dict(BASE, client_sig_scheme=scheme)) \
            as cl:
        assert cl.keys.client_sig_scheme == scheme
        kv = skvbc.SkvbcClient(_pin(cl.client()))
        replies = [kv.write([(b"k%d" % i, b"v%d" % i)],
                            timeout_ms=budget_s * 1000)
                   for i in range(writes)]
        deadline = time.monotonic() + budget_s
        chains = [cl.handlers[r].blockchain for r in range(4)]
        while time.monotonic() < deadline and not all(
                c.last_block_id == writes for c in chains):
            time.sleep(0.02)
        out = {"replies": [(r.success, r.latest_block) for r in replies],
               "blocks": [[c.get_raw_block(b) for b in range(1, writes + 1)]
                          for c in chains],
               "digests": [c.state_digest() for c in chains],
               "read": kv.read([b"k0", b"k%d" % (writes - 1)])}
        return out


def test_secp256k1_cluster_matches_the_reference_ledger(no_openssl):
    port = _drive(PortCluster, port_skvbc, PortChain, PortDB,
                  "ecdsa-secp256k1")
    ref = _drive(RefCluster, ref_skvbc, RefChain, RefDB, "ecdsa-secp256k1")
    assert port["replies"] == ref["replies"] == \
        [(True, i + 1) for i in range(6)]
    assert port["blocks"] == ref["blocks"]
    assert all(b == port["blocks"][0] for b in port["blocks"])
    assert port["digests"] == ref["digests"]
    assert len(set(port["digests"])) == 1
    assert port["read"] == {b"k0": b"v0", b"k5": b"v5"}


def test_p256_cluster_commits_and_agrees():
    out = _drive(PortCluster, port_skvbc, PortChain, PortDB, "ecdsa-p256",
                 writes=3)
    assert out["replies"] == [(True, 1), (True, 2), (True, 3)]
    assert all(b == out["blocks"][0] for b in out["blocks"])
    assert len(set(out["digests"])) == 1
