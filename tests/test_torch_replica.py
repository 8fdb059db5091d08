"""The port's replica core against the reference: a four-replica counter
cluster on each package, the same seed and the same overrides, one
client sending sequential writes.

With one request per PrePrepare the reply bytes, the counter's value
after every seq and every seq's PrePrepare digest are deterministic, so
they are compared byte for byte. The client's request ids and
correlation ids are pinned on both sides (the reference draws them from
the wall clock and the process tracer).
"""
import time

import pytest

from tpubft.apps import counter as ref_counter
from tpubft.testing import InProcessCluster as RefCluster
from tpubft_torch import device
from tpubft_torch.apps import counter as port_counter
from tpubft_torch.testing import InProcessCluster as PortCluster

# the planes the port does not carry yet are off on both sides
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


_PLANES = {
    "durability_pipeline": (dict(autotune_enabled=False), "durability"),
    "autotune_enabled": (dict(durability_pipeline=False), "autotuner"),
    "offload_enabled": (dict(PLANES_OFF, offload_enabled=True), "offload"),
    "pre_execution_enabled": (dict(PLANES_OFF, pre_execution_enabled=True),
                              "pre_execution"),
    "thin_replica_enabled": (dict(PLANES_OFF, thin_replica_enabled=True),
                             "thin_replica"),
}


@pytest.mark.parametrize("plane", sorted(_PLANES))
def test_unported_plane_refuses_to_start(plane):
    overrides, word = _PLANES[plane]
    with pytest.raises(NotImplementedError, match=word):
        PortCluster(f=1, num_clients=1, cfg_overrides=dict(
            overrides, crypto_backend="cpu"))


def test_default_config_refuses_and_names_the_durability_pipeline():
    from tpubft_torch.comm.loopback import LoopbackBus
    from tpubft_torch.consensus.keys import ClusterKeys
    from tpubft_torch.consensus.replica import Replica
    from tpubft_torch.utils.config import ReplicaConfig
    cfg = ReplicaConfig()
    keys = ClusterKeys.generate(cfg, 1, seed=SEED)
    bus = LoopbackBus()
    try:
        with pytest.raises(NotImplementedError,
                           match="durability pipeline.*ROADMAP A.3"):
            Replica(cfg, keys.for_node(0), bus.create(0),
                    port_counter.CounterHandler())
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
