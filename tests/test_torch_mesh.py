"""The port's mesh tier on 8 virtual CPU slots, held against the
reference's 8-device CPU mesh (tests/conftest.py): the control plane
(shard rows, plans, snapshots, epochs, eviction and readmission), the
sharded verify, digest and MSM routes, the cross-shard combine's plain
version, and the mesh's readers (the ECDSA crossover, the
`crypto_shard_count` knob and its policy, `mesh_sharded_verifies`, the
health plane's `mesh` section).

Each per-slot launch on the CPU runs the plain version op by op: a
verify a few rows wide takes about 1.5 s, an MSM about 5 s whatever its
width. The MSM and eviction routes therefore run over a plan capped at
2 or 4 slots (`set_shard_count`); the full 8-slot comparisons against
the reference's compiled mesh programs (20-50 s of XLA compile each)
are marked slow.
"""
import hashlib
import random

import jax  # noqa: F401  (the reference's 8-device CPU mesh)
import numpy as np
import pytest
import torch

from tpubft.crypto import bls12381 as ref_bls
from tpubft.crypto import cpu as ref_cpu
from tpubft.ops import dispatch as ref_dispatch
from tpubft.parallel import sharding as ref_sh
from tpubft_torch import device
from tpubft_torch.crypto import bls12381 as bls
from tpubft_torch.crypto import cpu
from tpubft_torch.ops import bls12_381 as bops
from tpubft_torch.ops import dispatch
from tpubft_torch.ops import ed25519 as ops_ed
from tpubft_torch.ops import sha256 as ops_sha
from tpubft_torch.parallel import sharding
from tpubft_torch.utils import breaker as breaker_mod


@pytest.fixture(autouse=True)
def _slots():
    """8 virtual CPU slots; after each test the default inventory, a
    reset manager (breakers closed, cap dropped) and no faults."""
    device.set_default_device("cpu")
    sharding.clear_chip_faults()
    sharding.set_virtual_devices(8, "cpu")
    dispatch.crypto_mesh().reset()
    yield
    device.set_default_device("cpu")
    sharding.clear_chip_faults()
    mgr = dispatch.crypto_mesh()
    for s in mgr.slots():
        b = mgr.chip_breaker(s.id)
        if b is not None:
            b.configure(cooldown_s=2.0)
    mgr.reset()
    sharding.set_virtual_devices(None)
    from tpubft_torch.crypto import cuda
    cuda.set_ecdsa_crossover(None)
    device.set_default_device(None)


def _ed_items(n, forge_every=5, seed=b"mesh-plane"):
    signer = cpu.Ed25519Signer.generate(seed=seed)
    pk = signer.public_bytes()
    items = []
    for i in range(n):
        m = b"mp-%d" % i
        sig = signer.sign(m)
        if forge_every and i % forge_every == 0:
            sig = sig[:8] + bytes([sig[8] ^ 1]) + sig[9:]
        items.append((m, sig, pk))
    return items


def _ref_verdicts(items):
    return [ref_cpu.Ed25519Verifier(pk).verify(m, s) for m, s, pk in items]


# ---------------------------------------------------------------------
# the control plane
# ---------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 7, 8, 9, 63, 64, 65, 100, 256, 1000])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 7, 8])
@pytest.mark.parametrize("multiple", [1, 8])
def test_shard_rows_matches_the_reference(n, d, multiple):
    assert sharding.shard_rows(n, d, multiple) \
        == ref_sh.shard_rows(n, d, multiple)


def _plan_trace(mgr, inject, clear):
    """A fixed sequence of cap, eviction and reset; -> what each step's
    plan and snapshot show."""
    def view():
        plan = mgr.plan()
        snap = dict(mgr.snapshot())
        snap.pop("last_rebalance_ms")
        return plan.n, plan.mesh is None, plan.epoch, snap

    out = [view()]
    mgr.set_shard_count(3)
    out.append(view())
    mgr.set_shard_count(1)
    out.append(view())
    mgr.set_shard_count(0)
    out.append(view())
    inject(5)
    plan = mgr.plan()
    out.append(mgr.on_launch_failure(plan, "trace"))
    out.append(view())
    out.append(mgr.on_launch_failure(mgr.plan(), "trace"))
    clear()
    mgr.reset()
    out.append(view())
    return out


def test_plans_snapshots_and_epochs_match_the_reference():
    port = _plan_trace(sharding.CryptoMesh(), sharding.inject_chip_fault,
                       sharding.clear_chip_faults)
    ref = _plan_trace(ref_sh.CryptoMesh(), ref_sh.inject_chip_fault,
                      ref_sh.clear_chip_faults)
    assert port == ref
    assert port[0][:2] == (8, False) and port[5][0] == 7


def test_one_slot_plan_has_no_mesh_and_no_chip_breakers():
    sharding.set_virtual_devices(None)
    plan = dispatch.mesh_plan()
    assert plan.n == 1 and plan.mesh is None
    assert plan.devices[0].device == torch.device("cpu")
    assert dispatch.mesh_shards() == 1
    assert dispatch.crypto_mesh().chip_breaker(0) is None


def test_inventory_raises_no_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    sharding.set_virtual_devices(None)
    device.set_default_device(None)
    with pytest.raises(device.NoDevice):
        dispatch.mesh_plan()
    with pytest.raises(device.NoDevice):
        ops_sha.sha256_batch([b"x"] * 64)


# ---------------------------------------------------------------------
# the sharded routes
# ---------------------------------------------------------------------

def test_sharded_ed25519_verify_at_64():
    """n = 64 on 8 slots: the gate (8 rows a slot) routes it over the
    mesh, as the reference's verify_batch takes its mesh at 64; every
    5th item forged. Verdicts equal the reference's host engine."""
    from tpubft_torch.ops import ed25519_cuda
    items = _ed_items(64)
    before = dict(ed25519_cuda.LAUNCHES)
    got = ops_ed.verify_batch(items)
    assert got.tolist() == _ref_verdicts(items)
    assert got.tolist() == [i % 5 != 0 for i in range(64)]
    assert ed25519_cuda.LAUNCHES == before     # CPU slots: plain versions
    from tpubft_torch.utils import flight
    rows = flight.kernel_profiler().snapshot()
    assert rows["ed25519.shard"]["calls"] >= 1


@pytest.mark.parametrize("mixed", [False, True], ids=["uniform", "mixed"])
def test_sharded_sha256_matches_reference_and_hashlib(mixed):
    from tpubft.ops import sha256 as ref_sha
    if mixed:
        msgs = [b"m-%d" % i + b"x" * (i % 91) for i in range(256)]
        got = ops_sha.sha256_batch_mixed(msgs)
        want = ref_sha.sha256_batch_mixed(msgs)
    else:
        msgs = [b"u-%05d" % i for i in range(256)]
        got = ops_sha.sha256_batch(msgs)
        want = ref_sha.sha256_batch(msgs)
    assert [bytes(d) for d in got] == [bytes(d) for d in want]
    assert got == [hashlib.sha256(m).digest() for m in msgs]
    assert ops_sha.sha256_batch_mixed(msgs, device="cpu") == got


def _g1_points(n, seed):
    rng = random.Random(seed)
    pts = [bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R)) for _ in range(n)]
    return pts, [rng.randrange(bls.R) for _ in range(n)]


@pytest.mark.parametrize("n", [16, 17])
def test_sharded_msm_matches_the_golden_msm(n):
    """Two slots (capped): each runs the plain MSM on its K-shard, the
    plain combine sums the partials. Equal to the port's and the
    reference's host engines."""
    dispatch.crypto_mesh().set_shard_count(2)
    pts, ks = _g1_points(n, seed=n)
    got = bops.msm(pts, ks)
    assert got == bls.g1_msm(pts, ks) == ref_bls.g1_msm(pts, ks)


def test_sharded_msm_batch_with_identities_and_ragged_segments():
    dispatch.crypto_mesh().set_shard_count(2)
    pts, ks = _g1_points(9, seed=3)
    segs = [(pts[:5], ks[:5]),
            ([pts[5], None, pts[6]], ks[5:8]),
            ([pts[7]], [0]),                       # zero scalar
            ([pts[8], None], [ks[8], 1])]
    got = bops.msm_batch(segs)

    def golden(p, k):
        live = [(a, b) for a, b in zip(p, k) if a is not None]
        return ref_bls.g1_msm([a for a, _ in live], [b for _, b in live])
    assert got == [golden(p, k) for p, k in segs]
    assert got[2] is None


def test_plain_combine_sums_the_partials():
    """The combine's plain version (the Curve's complete additions in
    msm_reduce's order) over D = 3 projective partials a segment, one of
    them the identity: each segment's sum equals the reference host
    engine's sum of the same points."""
    pts, ks = _g1_points(6, seed=11)
    parts = [[bls.g1_mul(p, k) for p, k in zip(pts[:3], ks[:3])],
             [bls.g1_mul(pts[3], ks[3]), None, bls.g1_mul(pts[4], ks[4])]]
    words = [bops._prep_msm(seg, [1] * 3)[1:3] for seg in parts]
    cv = bops.g1_curve()
    one = cv.f.to_words(cv.f.one((2, 3), torch.device("cpu")))
    ident = torch.tensor([[p is None for p in seg] for seg in parts])
    x = torch.from_numpy(np.stack([w[0] for w in words], 1))
    y = torch.where(ident, one,
                    torch.from_numpy(np.stack([w[1] for w in words], 1)))
    z = torch.where(ident, 0, one)
    gx, gy, gz = (c.numpy() for c in bops.plain_combine(x, y, z))
    got = [bops._to_affine_host(gx[:, j], gy[:, j], gz[:, j])
           for j in range(2)]
    want = [ref_bls.g1_msm([p for p in seg if p is not None],
                           [1] * sum(p is not None for p in seg))
            for seg in parts]
    assert got == want


# ---------------------------------------------------------------------
# eviction and readmission
# ---------------------------------------------------------------------

def test_injected_fault_evicts_one_slot_not_the_plane():
    """Slot 3 dies under a 4-slot plan: one eviction, the retry runs on
    the 3 survivors, exact verdicts, the global breaker closed, and the
    health plane's mesh section names the slot."""
    from tpubft_torch.consensus.health import HealthMonitor
    from tpubft_torch.utils.metrics import Aggregator
    sharding.set_virtual_devices(4, "cpu")
    mgr = dispatch.crypto_mesh()
    before = mgr.snapshot()["evictions"]
    items = _ed_items(32)
    sharding.inject_chip_fault(3)
    got = ops_ed.verify_batch(items)
    assert got.tolist() == _ref_verdicts(items)
    snap = mgr.snapshot()
    assert snap["evicted"] == [3] and snap["evictions"] == before + 1
    assert snap["last_rebalance_ms"] > 0.0
    plan = dispatch.mesh_plan()
    assert plan.n == 3 and [s.id for s in plan.devices] == [0, 1, 2]
    assert dispatch.device_breaker().state == "closed"
    chips = breaker_mod.prefixed(mgr.CHIP_PREFIX)
    assert chips[f"{mgr.CHIP_PREFIX}3"].state != "closed"
    assert breaker_mod.any_degraded()
    health = HealthMonitor("mesh-test", Aggregator()).verdict()
    assert health["mesh"]["evicted"] == [3]
    assert health["verdict"] == "degraded"


def test_evicted_slot_readmitted_after_cooldown():
    """Wait on state, not on the clock: after the fault clears and a
    0.05 s cooldown, the next plans probe the slot back in."""
    import time
    mgr = dispatch.crypto_mesh()
    msgs = [b"r-%04d" % i for i in range(256)]
    sharding.inject_chip_fault(6)
    assert ops_sha.sha256_batch(msgs) \
        == [hashlib.sha256(m).digest() for m in msgs]
    assert dispatch.mesh_plan().n == 7
    sharding.clear_chip_faults()
    mgr.chip_breaker(6).configure(cooldown_s=0.05)
    deadline = time.monotonic() + 30.0
    while dispatch.mesh_plan().n < 8:
        assert time.monotonic() < deadline, "slot 6 never readmitted"
        time.sleep(0.01)
    assert mgr.snapshot()["readmits"] >= 1
    assert mgr.chip_breaker(6).state == "closed"
    assert ops_sha.sha256_batch(msgs) \
        == [hashlib.sha256(m).digest() for m in msgs]


def test_mesh_launch_passes_breaker_open_through():
    mgr = dispatch.crypto_mesh()
    before = mgr.snapshot()["evictions"]

    def launch(_plan):
        raise dispatch.BreakerOpen("device open")
    with pytest.raises(dispatch.BreakerOpen):
        dispatch.mesh_launch("t", launch)
    assert mgr.snapshot()["evictions"] == before


def test_unblamed_launch_failure_reraises():
    """A launch that fails while every slot's probe passes is not a sick
    slot: nothing is evicted and the error reaches the caller."""
    def launch(_plan):
        raise RuntimeError("not a slot's fault")
    with pytest.raises(RuntimeError, match="not a slot"):
        dispatch.mesh_launch("t", launch)
    assert dispatch.crypto_mesh().snapshot()["evicted"] == []


# ---------------------------------------------------------------------
# the readers of the mesh
# ---------------------------------------------------------------------

def test_ecdsa_crossover_divided_by_the_width(monkeypatch):
    from tpubft.crypto import tpu as ref_tpu
    from tpubft_torch.crypto import cuda
    monkeypatch.setenv("TPUBFT_ECDSA_CROSSOVER_B", "64")
    assert ref_dispatch.mesh_shards() == 8
    assert cuda.ecdsa_crossover() == ref_tpu.ecdsa_crossover() == 8
    dispatch.crypto_mesh().set_shard_count(3)
    assert cuda.ecdsa_crossover() == 64 // 3
    monkeypatch.delenv("TPUBFT_ECDSA_CROSSOVER_B")
    assert cuda.ecdsa_crossover() == (1 << 30) // 3
    cuda.set_ecdsa_crossover(40)              # the override is exempt
    assert cuda.ecdsa_crossover() == 40
    ref_tpu.set_ecdsa_crossover(40)
    try:
        assert ref_tpu.ecdsa_crossover() == 40
    finally:
        ref_tpu.set_ecdsa_crossover(None)


def test_mesh_sharded_verifies_counted():
    from tpubft_torch.consensus.keys import ClusterKeys
    from tpubft_torch.consensus.sig_manager import SigManager
    from tpubft_torch.utils.config import ReplicaConfig
    cfg = ReplicaConfig(replica_id=0, f_val=1, c_val=0,
                        num_of_client_proxies=1)
    keys = ClusterKeys.generate(cfg, 1, seed=b"mesh-sig")

    def host(entries):
        return [cpu.Ed25519Verifier(pk).verify(d, s)
                for _, pk, d, s in entries]
    sm = SigManager(keys.for_node(0), batch_fn=host)
    signer = keys.for_node(1).my_signer()
    items = [(1, b"d-%d" % i, signer.sign(b"d-%d" % i)) for i in range(4)]
    assert all(sm.verify_batch(items))
    assert sm.mesh_sharded_verifies.value == 4
    sharding.set_virtual_devices(None)
    sm.verify_batch([(1, b"e", signer.sign(b"e"))])
    assert sm.mesh_sharded_verifies.value == 4
    assert sm.sigs_device_dispatched.value == 5


def _shard_knob_cluster():
    from tpubft_torch.testing import InProcessCluster
    return InProcessCluster(f=1, cfg_overrides=dict(
        crypto_backend="cpu", autotune_interval_ms=10))


def test_crypto_shard_count_registered_at_the_slot_count():
    with _shard_knob_cluster() as cluster:
        reg = cluster.replicas[0].tuning.registry
        knob = reg.knob("crypto_shard_count")
        assert (knob.value, knob.default, knob.lo, knob.hi) == (8, 8, 1, 8)
        reg.set("crypto_shard_count", 3)
        assert dispatch.mesh_plan().n == 3
    sharding.set_virtual_devices(None)
    with _shard_knob_cluster() as cluster:
        assert "crypto_shard_count" \
            not in cluster.replicas[0].tuning.registry.names()


def test_wired_shard_policy_votes_as_the_reference():
    """The policy the port's wiring attaches to `crypto_shard_count`,
    on seeded `ed25519` / `ed25519.shard` rows, votes as the
    reference's crypto_shard_policy."""
    from tpubft.tuning import knobs as ref_knobs
    from tpubft.tuning import policies as ref_pol
    from tpubft_torch.tuning import knobs as port_knobs
    from tpubft_torch.tuning import policies as port_pol
    rng = np.random.default_rng(16)
    seq, slots, calls = [], 0, {"ed25519": 0, "ed25519.shard": 0}
    for _ in range(400):
        slots += int(rng.choice([0, 3, 8]))
        kernels = {}
        for k in calls:
            calls[k] += int(rng.choice([0, 0, 1, 2]))
            kernels[k] = {"calls": calls[k],
                          "batch_avg": float(rng.choice([8.0, 64.0])),
                          "warm_avg_ms": float(rng.choice(
                              [0.5, 1.0, 1.2, 2.0, 4.0]))}
        seq.append(dict(kernels=kernels, completed_slots=slots))
    with _shard_knob_cluster() as cluster:
        port = cluster.replicas[0].tuning._policies["crypto_shard_count"]
        votes = {}
        for name, pol, mod, kmod in (
                ("port", port, port_pol, port_knobs),
                ("ref", ref_pol.crypto_shard_policy(), ref_pol, ref_knobs)):
            prev, out = None, []
            for d in seq:
                cur = mod.Telemetry(**d)
                out.append(pol(cur, prev, kmod.Knob(
                    name="crypto_shard_count", value=4, default=8, lo=1,
                    hi=8, cooldown_s=0.0)))
                prev = cur
            votes[name] = out
    assert votes["port"] == votes["ref"]
    assert len(set(votes["port"])) == 3, set(votes["port"])


# ---------------------------------------------------------------------
# slow: the reference's compiled mesh programs, and the dry run
# ---------------------------------------------------------------------

@pytest.mark.slow
def test_sharded_ed25519_equals_the_reference_mesh():
    from tpubft.ops import ed25519 as ref_ed
    items = _ed_items(64)
    assert ops_ed.verify_batch(items).tolist() \
        == ref_ed.verify_batch(items).tolist()


@pytest.mark.slow
@pytest.mark.parametrize("n", [16, 17])
def test_sharded_msm_equals_the_reference_sharded_msm(n):
    pts, ks = _g1_points(n, seed=n)
    assert sharding.sharded_msm(pts, ks) \
        == ref_sh.sharded_msm(pts, ks, ref_sh.make_mesh())


@pytest.mark.slow
def test_rlc_forged_isolation_survives_midflush_reshard():
    """A slot dies between the flush starting on 8 slots and finishing
    on 7: the per-shard verdicts and in-shard bisection still isolate
    exactly the forged items, as the single-device route does (the
    reference's test_mesh_plane.py:167-201)."""
    from tpubft_torch.ops import ecdsa as ops_ecdsa
    mgr = dispatch.crypto_mesh()
    curve = "secp256k1"
    s = cpu.EcdsaSigner.generate(curve, seed=b"mesh-rlc")
    pk = s.public_bytes()
    n = 32 * mgr.device_count()
    items = [(b"r-%d" % i, s.sign(b"r-%d" % i), pk) for i in range(n)]
    forged = (3, n - 56)
    for i in forged:
        items[i] = (b"forged-%d" % i, items[i][1], pk)
    want = [i not in forged for i in range(n)]
    single = ops_ecdsa.rlc_verify_batch(curve, items, device="cpu")
    assert single.tolist() == want
    sharding.inject_chip_fault(dispatch.mesh_plan().devices[1].id)
    got = ops_ecdsa.rlc_verify_batch(curve, items)
    assert got.tobytes() == single.tobytes()
    assert mgr.snapshot()["evicted"] == [1]
    assert dispatch.mesh_plan().n == mgr.device_count() - 1
    assert dispatch.device_breaker().state == "closed"


@pytest.mark.slow
def test_dryrun_multichip_on_two_slots():
    from tpubft_torch import graft_entry
    graft_entry.dryrun_multichip(2)
    fn, args = graft_entry.entry()
    assert fn(*args).all()
