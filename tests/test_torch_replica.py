"""The port's replica core against the reference: a four-replica counter
cluster on each package, the same seed and the same overrides, one
client sending sequential writes.

With one request per PrePrepare the reply bytes, the counter's value
after every seq and every seq's PrePrepare digest are deterministic, so
they are compared byte for byte. The client's request ids and
correlation ids are pinned on both sides (the reference draws them from
the wall clock and the process tracer).
"""
import json
import time

import pytest

from tpubft.apps import counter as ref_counter
from tpubft.testing import InProcessCluster as RefCluster
from tpubft_torch import device
from tpubft_torch.apps import counter as port_counter
from tpubft_torch.testing import InProcessCluster as PortCluster

# the counter runs keep the durability pipeline off on both sides (the
# ledger parity tests hold it against the reference); the autotuner is
# off on both sides (test_torch_tuning.py holds a default-config
# cluster, tuner on, against the reference)
PLANES_OFF = dict(durability_pipeline=False, autotune_enabled=False)
SEED = b"torch-replica-parity"


@pytest.fixture(autouse=True)
def _cpu():
    device.set_default_device("cpu")
    yield
    device.set_default_device(None)


def _recording(counter_mod):
    class Recording(counter_mod.CounterHandler):
        """The counter, recording its value after every execution."""

        def __init__(self):
            super().__init__()
            self.values = []

        def execute(self, client_id, req_seq, flags, request):
            out = super().execute(client_id, req_seq, flags, request)
            self.values.append(self.value)
            return out
    return Recording


def _pin(client, start=7_000_000):
    """Deterministic request ids and correlation ids for one client."""
    client._req_seq = start
    orig = client._new_request_locked

    def pinned(payload, flags, cid, quorum):
        return orig(payload, flags, f"parity-{client._req_seq + 1}", quorum)
    client._new_request_locked = pinned
    return client


def _wait(cond, budget_s, what):
    deadline = time.monotonic() + budget_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out after {budget_s}s waiting for {what}")


def _drive(cluster_cls, counter_mod, overrides, deltas, budget_s=60):
    """Run the writes; return what the comparison needs."""
    with cluster_cls(f=1, num_clients=1, seed=SEED,
                     handler_factory=_recording(counter_mod),
                     cfg_overrides=dict(PLANES_OFF, **overrides)) as cl:
        client = _pin(cl.client())
        replies = [client.send_write(counter_mod.encode_add(d),
                                     timeout_ms=budget_s * 1000)
                   for d in deltas]
        n = len(deltas)
        _wait(lambda: all(r.last_executed >= n
                          for r in cl.replicas.values())
              and all(len(h.values) >= n for h in cl.handlers.values()),
              budget_s, "every replica to execute every write")
        digests = {}
        for rid, rep in cl.replicas.items():
            states = rep.storage.load().seq_states
            digests[rid] = {}
            for seq in range(1, n + 1):
                raw = states[seq].pre_prepare if seq in states else None
                if raw is not None:
                    digests[rid][seq] = rep_m(cluster_cls).unpack(
                        raw).digest()
        return dict(
            replies=replies,
            values={r: list(h.values) for r, h in cl.handlers.items()},
            last_executed={r: rep.last_executed
                           for r, rep in cl.replicas.items()},
            digests=digests,
            pages={r: rep.res_pages.all_pages()
                   for r, rep in cl.replicas.items()},
            cluster=cl)


def rep_m(cluster_cls):
    if cluster_cls is PortCluster:
        from tpubft_torch.consensus import messages
    else:
        from tpubft.consensus import messages
    return messages


def _same_run(port, ref, n):
    assert port["replies"] == ref["replies"]
    expect = [ref_counter.decode_reply(r) for r in ref["replies"]]
    assert [port_counter.decode_reply(r) for r in port["replies"]] == expect
    for rid in range(4):
        assert port["values"][rid] == ref["values"][rid] == expect
        assert port["last_executed"][rid] == ref["last_executed"][rid] == n
        assert port["pages"][rid] == ref["pages"][rid]
    # the primary holds every seq's PrePrepare; backups agree where held
    assert sorted(ref["digests"][0]) == list(range(1, n + 1))
    assert port["digests"][0] == ref["digests"][0]
    for rid in range(1, 4):
        for seq, d in port["digests"][rid].items():
            assert d == ref["digests"][0][seq]


def test_clean_run_matches_the_reference_byte_for_byte():
    deltas = [(-1) ** i * (i * 37 % 101) for i in range(20)]
    ref = _drive(RefCluster, ref_counter, dict(crypto_backend="cpu"),
                 deltas)
    port = _drive(PortCluster, port_counter, dict(crypto_backend="cpu"),
                  deltas)
    _same_run(port, ref, len(deltas))
    assert port["cluster"].replicas[0].crypto_backend == "cpu"


def test_device_route_on_cpu_tensors_gives_the_same_replies(monkeypatch):
    """crypto_backend="cuda" with every batch on the device route: the
    wrappers run the plain verify on CPU tensors, through
    crypto/cuda.verify_batch_mixed and the multisig device verifier.
    The plain verify runs op by op on the CPU (about 2 s a call,
    17 calls a write), so the timers are long and the run is one write."""
    from tpubft_torch.crypto import cuda as cuda_backend
    from tpubft_torch.ops import ed25519 as ops
    calls = {"plain": 0, "mixed": 0}
    plain, mixed = ops.plain_verify_kernel, cuda_backend.verify_batch_mixed

    def counted_plain(*a, **k):
        calls["plain"] += 1
        return plain(*a, **k)

    def counted_mixed(items):
        calls["mixed"] += 1
        return mixed(items)
    monkeypatch.setattr(ops, "plain_verify_kernel", counted_plain)
    monkeypatch.setattr(cuda_backend, "verify_batch_mixed", counted_mixed)
    slow = dict(device_min_verify_batch=1, view_change_timer_ms=600_000,
                health_stall_ms=600_000)
    deltas = [5]
    ref = _drive(RefCluster, ref_counter, dict(slow, crypto_backend="cpu"),
                 deltas)
    port = _drive(PortCluster, port_counter,
                  dict(slow, crypto_backend="cuda"), deltas, budget_s=240)
    _same_run(port, ref, len(deltas))
    assert calls["mixed"] > 0 and calls["plain"] >= calls["mixed"]
    for rep in port["cluster"].replicas.values():
        assert rep.crypto_backend == "cuda"
        assert rep.sig.degraded_verifies.value == 0
        for v in (rep.slow_verifier, rep.thr_verifier, rep.opt_verifier):
            assert type(v) is cuda_backend.CudaMultisigEd25519Verifier
            assert v.degraded == 0


# Both planes are ported (the read tier in A.9.4's first part,
# pre-execution in A.9.4b): each case (its name kept from when they were
# refused) builds the cluster and checks the plane is attached.
_PLANES = {
    # every replica builds its preprocessor, whose pool Replica.stop
    # shuts down
    "pre_execution_enabled": (dict(PLANES_OFF, pre_execution_enabled=True),
                              lambda r: r.preprocessor is not None
                              and not r.preprocessor._pool._shutdown),
    # every ledger replica attaches its thin-replica server
    "thin_replica_enabled": (dict(PLANES_OFF, thin_replica_enabled=True),
                             lambda r: r.thin_replica is not None
                             and r.thin_replica.port),
}


@pytest.mark.parametrize("plane", sorted(_PLANES))
def test_unported_plane_refuses_to_start(plane):
    from tpubft_torch.apps.skvbc import SkvbcHandler
    from tpubft_torch.kvbc import KeyValueBlockchain
    from tpubft_torch.storage import MemoryDB
    overrides, attached = _PLANES[plane]

    def hf(_r=None):
        return SkvbcHandler(KeyValueBlockchain(
            MemoryDB(), use_device_hashing=False))
    with PortCluster(f=1, num_clients=1, handler_factory=hf,
                     cfg_overrides=dict(overrides,
                                        crypto_backend="cpu")) as cl:
        assert all(attached(r) for r in cl.replicas.values())
        reps = list(cl.replicas.values())
    if plane == "pre_execution_enabled":
        assert all(r.preprocessor._pool._shutdown for r in reps)


@pytest.mark.parametrize("pipeline", [True, False])
def test_default_config_refuses_only_for_the_autotuner(pipeline):
    """The reference's default config builds a port Replica: nothing of
    it is refused any more, and its tuner runs from `start` (awaited by
    its poll count) to `stop`, with the durability pipeline on or off.
    (The name is kept from when the autotuner was the one plane of the
    default config the port refused.)"""
    from tpubft_torch.comm.loopback import LoopbackBus
    from tpubft_torch.consensus.keys import ClusterKeys
    from tpubft_torch.consensus.replica import Replica
    from tpubft_torch.tuning import TuningController
    from tpubft_torch.utils.config import ReplicaConfig
    cfg = ReplicaConfig(durability_pipeline=pipeline)
    assert cfg.autotune_enabled and not cfg.offload_enabled
    keys = ClusterKeys.generate(cfg, 1, seed=SEED)
    bus = LoopbackBus()
    try:
        rep = Replica(cfg, keys.for_node(0), bus.create(0),
                      port_counter.CounterHandler())
        assert rep.crypto_backend == "cuda"
        assert (rep.durability is not None) == pipeline
        assert isinstance(rep.tuning, TuningController)
        assert ("durability_group_max" in rep.tuning.registry.names()) \
            == pipeline
        rep.start()
        try:
            _wait(lambda: rep.tuning.m_polls.value >= 1, 60,
                  "the tuner's first poll")
            assert rep.tuning.state()["active"] is True
        finally:
            rep.stop()
        assert rep.tuning.state()["active"] is False
    finally:
        bus.shutdown()


@pytest.mark.parametrize("backend", ["cuda", "auto"])
def test_no_card_raises_no_device(backend):
    """Without a card and without a request for the CPU, a cuda or auto
    cluster refuses to build: nothing falls back to the host."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    device.set_default_device(None)
    with pytest.raises(device.NoDevice):
        PortCluster(f=1, num_clients=1,
                    cfg_overrides=dict(PLANES_OFF, crypto_backend=backend))


@pytest.mark.parametrize("requested,resolved", [
    ("cuda", "cuda"), ("cpu", "cpu"), ("auto", "cuda")])
def test_backend_resolution_has_no_probe(requested, resolved):
    from tpubft_torch.crypto.backend import resolve_backend
    assert resolve_backend(requested) == resolved


def test_backend_resolution_refuses_unknown_names():
    from tpubft_torch.crypto.backend import resolve_backend
    with pytest.raises(ValueError):
        resolve_backend("tpu")


def test_three_threshold_systems_build_for_config_one():
    """n=4 with the adaptive scheme: slow, commit and optimistic systems
    are multisig-ed25519 with the reference's keys; the cuda verifiers
    are the device multisig verifier, the cpu ones the host verifier."""
    from tpubft.consensus.keys import ClusterKeys as RefKeys
    from tpubft.utils.config import ReplicaConfig as RefConfig
    from tpubft_torch.consensus.keys import ClusterKeys
    from tpubft_torch.crypto import cuda as cuda_backend
    from tpubft_torch.crypto.systems import MultisigEd25519Verifier
    from tpubft_torch.utils.config import ReplicaConfig
    port = ClusterKeys.generate(ReplicaConfig(), 100, seed=SEED)
    ref = RefKeys.generate(RefConfig(), 100, seed=SEED)
    assert port.threshold_scheme == ref.threshold_scheme \
        == "multisig-ed25519"
    for name, k in (("slow_path_system", 3), ("commit_path_system", 4),
                    ("optimistic_system", 4)):
        ps, rs = getattr(port, name), getattr(ref, name)
        assert ps.type_name == rs.type_name
        assert ps.threshold_ == rs.threshold_ == k
        assert ps.share_public_keys == rs.share_public_keys
        v = port.threshold_verifier(ps, "cuda", 32)
        assert type(v) is cuda_backend.CudaMultisigEd25519Verifier
        assert v.min_device_batch == 32
        assert isinstance(port.threshold_verifier(ps, "cpu"),
                          MultisigEd25519Verifier)
    assert port.client_pubkeys == ref.client_pubkeys
    assert port.replica_pubkeys == ref.replica_pubkeys



@pytest.mark.parametrize("unproductive,reproposed,factor", [
    (0, 150, 1), (1, 0, 1), (1, 75, 1.5), (1, 150, 2), (1, 600, 2),
    (2, 150, 4), (3, 0, 4), (4, 0, 8), (9, 75, 12)])
def test_no_progress_timeout_grows_until_a_new_view_executes(
        unproductive, reproposed, factor):
    """The watchdog gives a view `factor` view-change timeouts before it
    complains: 1 once the view has executed; before that, 1 plus the
    slots its primary re-proposed over the checkpoint window (at most
    2), doubled for each earlier view entered since one executed
    (capped at 8), and one timeout again once the view executes (a port
    divergence: the reference's timeout is fixed)."""
    cl = PortCluster(f=1, num_clients=1, seed=SEED,
                     cfg_overrides=dict(PLANES_OFF, crypto_backend="cpu"))
    rep = cl.replicas[1]
    try:
        complaints = []
        rep._complain = lambda view, *a, **kw: complaints.append(view)
        rep._running = True
        rep.pending_requests = [object()]
        timeout = rep.cfg.view_change_timer_ms / 1e3
        rep._progress_view = 4
        rep.view = 4 + unproductive
        rep._reproposed = reproposed
        rep._last_progress = time.monotonic() - (factor - 0.25) * timeout
        rep._check_view_change_timer()
        assert complaints == []
        rep._last_progress = time.monotonic() - (factor + 0.25) * timeout
        rep._check_view_change_timer()
        assert complaints == [rep.view]
        # the view executes: one timeout again
        rep._note_progress()
        assert rep._progress_view == rep.view
        rep._last_progress = time.monotonic() - 1.25 * timeout
        rep._check_view_change_timer()
        assert complaints == [rep.view, rep.view]
    finally:
        rep._running = False
        cl.stop()


def test_a_view_records_its_reproposals_and_first_execution():
    """An equivocating primary is deposed at the first write: each honest
    replica records the view it entered, the slots re-proposed there and
    the time from its entry to its first execution, and after that
    execution the view's no-progress timeout is the configured one."""
    overrides = dict(PLANES_OFF, crypto_backend="cpu",
                     view_change_timer_ms=900)
    with PortCluster(f=1, seed=SEED, byzantine={0: "equivocate"},
                     cfg_overrides=overrides) as cl:
        reply = cl.client().send_write(port_counter.encode_add(9),
                                       timeout_ms=60000)
        assert port_counter.decode_reply(reply) == 9
        for r in (1, 2, 3):
            rep = cl.replicas[r]
            _wait(lambda: rep._view_entries
                  and rep._view_entries[-1]["first_exec_ms"] is not None,
                  30, f"replica {r}'s first execution in its new view")
            entry = rep._view_entries[-1]
            assert entry["view"] == rep.view >= 1
            assert 0 <= entry["reproposed"] <= rep.cfg.checkpoint_window_size
            assert entry["first_exec_ms"] > 0
            assert rep._no_progress_factor() == 1.0
            shown = json.loads(rep._diag.get_status(
                f"replica{r}.views"))[-1]
            assert {k: shown[k] for k in ("view", "reproposed",
                                          "first_exec_ms")} \
                == {k: entry[k] for k in ("view", "reproposed",
                                          "first_exec_ms")}


def test_new_primary_reproposes_unexecuted_slots_first_then_paces_the_rest():
    """A new primary re-proposes the slots past its last execution at
    once, then the ones it has executed, highest first, with at most
    REPROPOSE_IN_FLIGHT of them uncommitted; the rest go as those
    commit, and none once the view is left (a port divergence: the
    reference re-proposes every slot ascending in one loop)."""
    cl = PortCluster(f=1, num_clients=1, seed=SEED,
                     cfg_overrides=dict(PLANES_OFF, crypto_backend="cpu"))
    rep = cl.replicas[1]
    try:
        sent = []
        rep._repropose_seq = sent.append
        rep.view = 1
        assert rep.is_primary
        rep.last_executed = 20
        rep.restrictions = {q: None for q in range(1, 24)}
        k = rep.REPROPOSE_IN_FLIGHT
        rep._repropose()
        assert sent == [21, 22, 23] + list(range(20, 20 - k, -1))
        assert rep.primary_next_seq == 24
        rep._pump_reproposals()
        assert len(sent) == 3 + k
        for q in (20, 19):
            rep.window.get(q).committed = True
        rep._pump_reproposals()
        assert sent[3 + k:] == [20 - k, 19 - k]
        rep.in_view_change = True
        rep._pump_reproposals()
        assert len(sent) == 5 + k and rep._reproposals[1] == []
    finally:
        cl.stop()


def test_view_entry_probe_sees_view_one_execute():
    """tools/view_entry_probe.py: with 140 slots past the checkpoint the
    view after a stopped primary executes in that view, without being
    deposed while its primary re-proposes (ROADMAP C.8)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, os.path.join(root, "tpubft_torch", "tools",
                                      "view_entry_probe.py"),
         "--slots", "140"],
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(res["view_at_first_exec"].values()) == {1}
    assert all(v >= 140 for v in res["past_checkpoint"].values())
