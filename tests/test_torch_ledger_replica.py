"""The port's ledger replica against the reference: a four-replica SKVBC
cluster on each package, with the durability pipeline on, the same seed,
the same overrides and one client sending sequential writes.

Every committed write is one ledger block, so the blocks, the state
digest and the reply-ring and clients pages are deterministic and are
compared byte for byte, on every replica and across the packages. The
client's request ids and correlation ids are pinned on both sides (the
reference draws them from the wall clock and the process tracer).

The abort-heavy schedule runs the same comparison under an equivocating
primary (`testing/byzantine.py`'s `equivocate`) with conflicting skvbc
writes: a write whose readset key changed after its read version is
rejected (success False, no block). The autotuner is off on both sides
(its default-config parity run is in test_torch_tuning.py); the crypto
backend is "cpu" on both sides except in the one-write device-route
test.
"""
import time

import pytest
import torch

from tpubft.apps import skvbc as ref_skvbc
from tpubft.kvbc import KeyValueBlockchain as RefChain
from tpubft.storage.memorydb import MemoryDB as RefDB
from tpubft.testing import InProcessCluster as RefCluster
from tpubft_torch import device
from tpubft_torch.apps import skvbc as port_skvbc
from tpubft_torch.kvbc import KeyValueBlockchain as PortChain
from tpubft_torch.storage.memorydb import MemoryDB as PortDB
from tpubft_torch.testing import InProcessCluster as PortCluster

# one intra-op thread: the plain versions run many tiny tensor ops, and
# several test workers share the host's cores
torch.set_num_threads(1)

BASE = dict(autotune_enabled=False, crypto_backend="cpu")
SEED = b"torch-ledger-parity"
RING = (b"clientreplies", b"clients")

PORT = (PortCluster, port_skvbc, PortChain, PortDB)
REF = (RefCluster, ref_skvbc, RefChain, RefDB)


@pytest.fixture(autouse=True)
def _cpu():
    device.set_default_device("cpu")
    yield
    device.set_default_device(None)


def _pin(client, start=5_000_000):
    """Deterministic request ids and correlation ids for one client."""
    client._req_seq = start
    orig = client._new_request_locked

    def pinned(payload, flags, cid, quorum):
        return orig(payload, flags, f"ledger-{client._req_seq + 1}", quorum)
    client._new_request_locked = pinned
    return client


def _wait(cond, budget_s, what):
    deadline = time.monotonic() + budget_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out after {budget_s}s waiting for {what}")


def _clean_writes(n):
    return [([(b"k%d" % i, b"v%d-%d" % (i, i * 7))], [], 0)
            for i in range(n)]


def _conflicting_writes(n):
    """Every third write reads k0 at version 0 after k0 was written at
    block 1: stale, rejected without a block."""
    out = []
    for i in range(n):
        if i % 3 == 2:
            out.append(([(b"x%d" % i, b"lost")], [b"k0"], 0))
        else:
            out.append(([(b"k%d" % i, b"v%d" % i)], [b"k%d" % (i - 1)]
                        if i else [], i))
    return out


def _drive(pkg, writes, overrides, honest=(0, 1, 2, 3), byzantine=None,
           use_device_hashing=False, budget_s=120):
    """Run the writes; return what the comparison needs."""
    cluster_cls, skvbc, chain, memdb = pkg

    def handler(_r=None):
        return skvbc.SkvbcHandler(
            chain(memdb(), use_device_hashing=use_device_hashing))

    with cluster_cls(f=1, num_clients=1, seed=SEED, handler_factory=handler,
                     byzantine=byzantine,
                     cfg_overrides=dict(BASE, **overrides)) as cl:
        kv = skvbc.SkvbcClient(_pin(cl.client()))
        replies = [kv.write(ws, readset=rs, read_version=rv,
                            timeout_ms=budget_s * 1000)
                   for ws, rs, rv in writes]
        n_blocks = sum(1 for r in replies if r.success)
        reps = [cl.replicas[r] for r in honest]

        def applied():
            # a quorum holds the last write; every honest replica reaches
            # the same head with its lane and its pipeline idle
            head = max(rep.last_executed for rep in reps)
            return all(
                rep.last_executed == head
                and cl.handlers[rep.id].blockchain.last_block_id
                == n_blocks
                and rep.exec_lane.idle()
                and (rep.durability is None or rep.durability.idle())
                for rep in reps)
        _wait(applied, budget_s, "every honest replica to apply")
        out = {"replies": [(r.success, r.latest_block) for r in replies],
               "cluster": cl}
        for r in honest:
            bc = cl.handlers[r].blockchain
            out[r] = dict(
                blocks=[bc.get_raw_block(b)
                        for b in range(1, n_blocks + 1)],
                state_digest=bc.state_digest(),
                pages=sorted(_ring(cl.replicas[r])))
        return out


def _ring(rep):
    return ((k, v) for k, v in rep.res_pages.all_pages()
            if k[2:].startswith(RING))


def _same_ledger(port, ref, honest=(0, 1, 2, 3)):
    assert port["replies"] == ref["replies"]
    first = honest[0]
    assert ref[first]["blocks"] and ref[first]["pages"]
    for r in honest:
        for what in ("blocks", "state_digest", "pages"):
            assert port[r][what] == ref[r][what], (r, what)
            assert port[r][what] == port[first][what], (r, what)


def test_clean_skvbc_run_matches_the_reference_byte_for_byte():
    writes = _clean_writes(10)
    ref = _drive(REF, writes, {})
    port = _drive(PORT, writes, {})
    _same_ledger(port, ref)
    assert port["replies"] == [(True, i + 1) for i in range(10)]
    for rep in port["cluster"].replicas.values():
        assert rep.durability is not None
        assert rep.durability.m_groups.value > 0


def test_abort_heavy_schedule_matches_the_reference():
    """An equivocating primary forces a view change at the first write,
    and every third write conflicts and is rejected; the honest replicas
    commit the same blocks, digests and reply pages as the reference."""
    writes = _conflicting_writes(9)
    kw = dict(byzantine={0: "equivocate"}, honest=(1, 2, 3))
    ov = dict(view_change_timer_ms=900)
    ref = _drive(REF, writes, ov, **kw)
    port = _drive(PORT, writes, ov, **kw)
    _same_ledger(port, ref, honest=(1, 2, 3))
    assert [ok for ok, _ in port["replies"]] == [
        i % 3 != 2 for i in range(9)]
    for r in (1, 2, 3):
        assert port["cluster"].replicas[r].view >= 1


def test_pipeline_on_off_ledger_equivalence():
    """Same sequential workload, pipeline on (default group shape) against
    off: the port lands byte-identical ledger blocks, state digest and
    reply-ring / at-most-once pages — durability batching changes WHEN
    bytes land, never WHICH bytes."""
    writes = _clean_writes(8)
    on = _drive(PORT, writes, dict(durability_pipeline=True))
    off = _drive(PORT, writes, dict(durability_pipeline=False))
    _same_ledger(on, off)
    assert off["cluster"].replicas[0].durability is None


def test_group_max_one_matches_the_reference():
    """group_max=1 with a zero window — one apply and one fsync a run —
    against the reference with the same shape and the port with the
    pipeline off."""
    writes = _clean_writes(6)
    ov = dict(durability_group_max=1, durability_window_us=0)
    ref = _drive(REF, writes, ov)
    port = _drive(PORT, writes, ov)
    off = _drive(PORT, writes, dict(durability_pipeline=False))
    _same_ledger(port, ref)
    _same_ledger(port, off)
    for rep in port["cluster"].replicas.values():
        st = rep.durability.state()
        assert st["group_max"] == 1 and st["groups"] == st["runs"]


def test_device_route_on_cpu_tensors_gives_the_same_ledger(monkeypatch):
    """crypto_backend="cuda" with every verify batch on the device route
    and device hashing on: the wrappers run the plain versions on CPU
    tensors, through crypto/cuda.verify_batch_mixed. The plain verify
    runs op by op (about 2 s a call, 17 calls a write), so the timers
    are long and the run is one write."""
    from tpubft_torch.crypto import cuda as cuda_backend
    calls = {"mixed": 0}
    mixed = cuda_backend.verify_batch_mixed

    def counted_mixed(items):
        calls["mixed"] += 1
        return mixed(items)
    monkeypatch.setattr(cuda_backend, "verify_batch_mixed", counted_mixed)
    slow = dict(device_min_verify_batch=1, view_change_timer_ms=600_000,
                health_stall_ms=600_000)
    writes = _clean_writes(1)
    ref = _drive(REF, writes, slow)
    port = _drive(PORT, writes, dict(slow, crypto_backend="cuda"),
                  use_device_hashing=True, budget_s=240)
    _same_ledger(port, ref)
    assert calls["mixed"] > 0
    for rep in port["cluster"].replicas.values():
        assert rep.crypto_backend == "cuda"
        assert rep.sig.degraded_verifies.value == 0
        assert rep.handler.blockchain._use_device
