"""The port's replica under a Byzantine primary, against the reference.

An equivocating primary (the `equivocate` strategy: odd-id backups get a
validly re-signed variant of every PrePrepare, even-id backups the
original) must be view-changed away, and the honest quorum must commit
exactly one fork: the write applies once, every honest replica
converges, and the reply equals the reference cluster's on the same seed.
"""
import time

import numpy as np
import pytest

from tpubft.apps import counter as ref_counter
from tpubft.consensus import messages as ref_m
from tpubft.testing import InProcessCluster as RefCluster
from tpubft_torch import device
from tpubft_torch.apps import counter as port_counter
from tpubft_torch.consensus import messages as port_m
from tpubft_torch.testing import InProcessCluster as PortCluster

OVERRIDES = dict(durability_pipeline=False, autotune_enabled=False,
                 crypto_backend="cpu", view_change_timer_ms=900)
SEED = b"torch-byzantine-parity"


@pytest.fixture(autouse=True)
def _cpu():
    device.set_default_device("cpu")
    yield
    device.set_default_device(None)


def _wait_value(cluster, replicas, expected, budget_s=45.0):
    deadline = time.monotonic() + budget_s
    while time.monotonic() < deadline:
        if all(cluster.handlers[r].value == expected for r in replicas):
            return
        time.sleep(0.05)
    got = {r: cluster.handlers[r].value for r in replicas}
    raise AssertionError(f"replicas never converged on {expected}: {got}")


def _equivocation_run(cluster_cls, counter_mod):
    with cluster_cls(f=1, seed=SEED, byzantine={0: "equivocate"},
                     cfg_overrides=dict(OVERRIDES)) as cluster:
        cl = cluster.client()
        reply = cl.send_write(counter_mod.encode_add(9), timeout_ms=60000)
        for r in (1, 2, 3):
            assert cluster.replicas[r].view >= 1, \
                f"replica {r} never left the equivocating primary's view"
        _wait_value(cluster, (1, 2, 3), 9)
        # exactly once: one execution per honest replica, never two
        executed = [cluster.metric(r, "counters", "executed_requests")
                    for r in (1, 2, 3)]
        return reply, executed


def test_equivocating_primary_commits_exactly_one_fork_like_the_reference():
    ref_reply, ref_exec = _equivocation_run(RefCluster, ref_counter)
    port_reply, port_exec = _equivocation_run(PortCluster, port_counter)
    assert ref_counter.decode_reply(ref_reply) == 9
    assert port_reply == ref_reply
    assert port_counter.decode_reply(port_reply) == 9
    assert port_exec == ref_exec == [1, 1, 1]


@pytest.mark.parametrize("dest", [1, 2, 3])
def test_equivocate_strategy_forks_like_the_reference(dest):
    """The mutator on the same signed PrePrepare: the reference and the
    port send byte-identical frames to every destination (the fork is
    re-signed with the same deterministic Ed25519 key)."""
    from tpubft.consensus.keys import ClusterKeys as RefKeys
    from tpubft.testing.byzantine import _Equivocate as RefEq
    from tpubft.utils.config import ReplicaConfig as RefConfig
    from tpubft_torch.consensus.keys import ClusterKeys
    from tpubft_torch.testing.byzantine import _Equivocate
    from tpubft_torch.utils.config import ReplicaConfig
    ref_keys = RefKeys.generate(RefConfig(f_val=1), 2,
                                seed=SEED).for_node(0)
    port_keys = ClusterKeys.generate(ReplicaConfig(f_val=1), 2,
                                     seed=SEED).for_node(0)
    rng = np.random.default_rng(dest)
    reqs = [ref_m.ClientRequestMsg(
        sender_id=4, req_seq_num=i, flags=0,
        request=ref_counter.encode_add(int(rng.integers(1, 99))),
        cid=f"c{i}", signature=rng.bytes(64)).pack() for i in range(3)]
    pp = ref_m.PrePrepareMsg(
        sender_id=0, view=0, seq_num=1,
        first_path=int(ref_m.CommitPath.SLOW), time=0,
        requests_digest=ref_m.PrePrepareMsg.compute_requests_digest(reqs),
        requests=reqs, signature=b"")
    pp.signature = ref_keys.my_signer().sign(pp.signed_payload())
    wire = pp.pack()
    ref_out = RefEq(signer=ref_keys.my_signer())(dest, wire)
    port_out = _Equivocate(signer=port_keys.my_signer())(dest, wire)
    assert port_out == ref_out
    fork = port_m.unpack(port_out)
    assert port_keys.verifier_of(0).verify(fork.signed_payload(),
                                           fork.signature)
    assert (port_out == wire) == (dest % 2 == 0)
