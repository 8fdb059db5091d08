"""BASELINE config 2 on the port against the reference: a seven-replica
(f=2) SKVBC ledger cluster certifying with threshold-bls, the same seed,
the same overrides and one client sending sequential writes.

Every committed write is one ledger block, so the blocks, the state
digest and the reply-ring and clients pages are deterministic and are
compared byte for byte, on every honest replica and across the packages
(the pattern of test_torch_ledger_replica.py, with its pinned client
ids). The certificates themselves are checked byte for byte in
test_torch_bls_systems.py; here they carry the protocol. Clean, under an
equivocating primary, and with the share-aggregation overlay on, where
the adaptive scheme resolves to multisig-bls. The crypto backend is
"cpu" on both sides and the autotuner is off on both sides (its
default-config parity run is in test_torch_tuning.py).
"""
import pytest
import torch

from tpubft.apps import skvbc as ref_skvbc
from tpubft.kvbc import KeyValueBlockchain as RefChain
from tpubft.storage.memorydb import MemoryDB as RefDB
from tpubft.testing import InProcessCluster as RefCluster
from tpubft_torch import device
from tpubft_torch.apps import skvbc as port_skvbc
from tpubft_torch.crypto import bls_native
from tpubft_torch.kvbc import KeyValueBlockchain as PortChain
from tpubft_torch.storage.memorydb import MemoryDB as PortDB
from tpubft_torch.testing import InProcessCluster as PortCluster

from test_torch_ledger_replica import (_clean_writes, _conflicting_writes,
                                       _pin, _ring, _wait)

torch.set_num_threads(1)

BASE = dict(autotune_enabled=False, crypto_backend="cpu",
            threshold_scheme="threshold-bls")
SEED = b"torch-bls-config2"
F = 2
N = 3 * F + 1

PORT = (PortCluster, port_skvbc, PortChain, PortDB)
REF = (RefCluster, ref_skvbc, RefChain, RefDB)


@pytest.fixture(autouse=True)
def _cpu():
    device.set_default_device("cpu")
    yield
    device.set_default_device(None)


def _drive(pkg, writes, overrides, honest=tuple(range(N)), byzantine=None,
           budget_s=180):
    cluster_cls, skvbc, chain, memdb = pkg

    def handler(_r=None):
        return skvbc.SkvbcHandler(chain(memdb(), use_device_hashing=False))

    with cluster_cls(f=F, num_clients=1, seed=SEED, handler_factory=handler,
                     byzantine=byzantine,
                     cfg_overrides=dict(BASE, **overrides)) as cl:
        kv = skvbc.SkvbcClient(_pin(cl.client()))
        replies = [kv.write(ws, readset=rs, read_version=rv,
                            timeout_ms=budget_s * 1000)
                   for ws, rs, rv in writes]
        n_blocks = sum(1 for r in replies if r.success)
        reps = [cl.replicas[r] for r in honest]

        def applied():
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
               "scheme": cl.replicas[honest[0]].keys.threshold_scheme,
               "cluster": cl}
        for r in honest:
            bc = cl.handlers[r].blockchain
            out[r] = dict(
                blocks=[bc.get_raw_block(b)
                        for b in range(1, n_blocks + 1)],
                state_digest=bc.state_digest(),
                pages=sorted(_ring(cl.replicas[r])))
        return out


def _same_ledger(port, ref, honest):
    assert port["replies"] == ref["replies"]
    assert port["scheme"] == ref["scheme"]
    first = honest[0]
    assert ref[first]["blocks"] and ref[first]["pages"]
    for r in honest:
        for what in ("blocks", "state_digest", "pages"):
            assert port[r][what] == ref[r][what], (r, what)
            assert port[r][what] == port[first][what], (r, what)


def test_config2_threshold_bls_cluster_matches_the_reference():
    writes = _clean_writes(20)
    bls_native.reset_counts()
    ref = _drive(REF, writes, {})
    port = _drive(PORT, writes, {})
    _same_ledger(port, ref, tuple(range(N)))
    assert port["scheme"] == "threshold-bls"
    assert port["replies"] == [(True, i + 1) for i in range(20)]
    # the port's certificates were checked by its own native engine
    assert bls_native.COUNTS["pairing_checks"] > 0
    assert bls_native.COUNTS["fallbacks"] == 0


def test_config2_equivocating_primary_matches_the_reference():
    """An equivocating primary forces a view change at the first write;
    every third write conflicts and is rejected. The six honest replicas
    commit the reference's blocks, digests and reply pages."""
    writes = _conflicting_writes(9)
    honest = tuple(range(1, N))
    kw = dict(byzantine={0: "equivocate"}, honest=honest)
    ov = dict(view_change_timer_ms=900)
    ref = _drive(REF, writes, ov, **kw)
    port = _drive(PORT, writes, ov, **kw)
    _same_ledger(port, ref, honest)
    assert [ok for ok, _ in port["replies"]] == [
        i % 3 != 2 for i in range(9)]
    for r in honest:
        assert port["cluster"].replicas[r].view >= 1


def test_share_aggregation_resolves_to_multisig_bls():
    """With the aggregation overlay on, the adaptive scheme resolves to
    multisig-bls (n=7 is below the threshold-bls crossover): the port's
    cluster keys are multisig-bls and its ledger equals the
    reference's."""
    writes = _clean_writes(6)
    ov = dict(threshold_scheme="adaptive", share_aggregation="tree")
    ref = _drive(REF, writes, ov)
    port = _drive(PORT, writes, ov)
    assert port["scheme"] == "multisig-bls"
    _same_ledger(port, ref, tuple(range(N)))
