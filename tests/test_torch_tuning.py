"""The port's closed-loop autotuner (tpubft_torch/tuning/) against the
reference's (tpubft/tuning/).

Parity: every policy votes as the reference's on the same seeded
sequences of Telemetry; KnobRegistry reaches the same values under the
same operations and clock; the controller makes the same decisions on
the same sensor readings; a seed file written by either package loads
in the other; and a default-config port cluster (tuner on, polling every
10 ms) gives the reference's ledgers and replies on the same schedule.
The rest are the port's counterparts of the reference's controller and
actuator tests. A running tuner is awaited through its poll count, never
through the clock.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

from tpubft.tuning import controller as ref_controller
from tpubft.tuning import knobs as ref_knobs
from tpubft.tuning import policies as ref_policies
from tpubft_torch import device
from tpubft_torch.tuning import controller as port_controller
from tpubft_torch.tuning import knobs as port_knobs
from tpubft_torch.tuning import policies as port_policies
from tpubft_torch.utils import flight

torch.set_num_threads(1)

PKGS = {"port": (port_knobs, port_policies, port_controller),
        "ref": (ref_knobs, ref_policies, ref_controller)}


@pytest.fixture(autouse=True)
def _cpu():
    from tpubft_torch.crypto import cuda as port_cuda
    device.set_default_device("cpu")
    port_cuda.set_ecdsa_crossover(None)
    yield
    port_cuda.set_ecdsa_crossover(None)
    device.set_default_device(None)


def _await(cond, what, budget_s=120.0):
    """Wait on a state predicate; the budget is a safety net only."""
    deadline = time.monotonic() + budget_s
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"never reached: {what}")
        time.sleep(0.005)


# ----------------------------------------------------------------------
# seeded telemetry
# ----------------------------------------------------------------------
KINDS = ("ed25519", "bls_msm", "ecdsa", "ed25519.shard")
STAGES = port_policies.PIPELINE_STAGES + ("cert_lag",)


def _telemetry_seq(seed: int, n: int, health: bool = False):
    """n telemetry readings as plain dicts: cumulative counts move
    forward, everything else is drawn from small sets so that every
    threshold of every policy is crossed both ways."""
    rng = np.random.default_rng(seed)
    slots, calls, cnt = 0, {k: 0 for k in KINDS}, {s: 0 for s in STAGES}
    trips = recov = 0
    off = {"off_lease_us": 0.0, "off_lease_items": 0.0,
           "off_soundness_us": 0.0}
    out = []
    for _ in range(n):
        slots += int(rng.choice([0, 0, 5, 10]))
        stages = {}
        for s in STAGES:
            if rng.random() < 0.8:
                cnt[s] += int(rng.choice([0, 1, 3]))
                stages[s] = {"p50_ms": float(rng.choice(
                    [0.0, 0.5, 1.0, 4.0, 8.0, 20.0])), "count": cnt[s]}
        kernels = {}
        for k in KINDS:
            calls[k] += int(rng.choice([0, 0, 1, 2]))
            if rng.random() < 0.85:
                kernels[k] = {"calls": calls[k],
                              "batch_avg": float(rng.choice(
                                  [0.0, 8.0, 16.0, 64.0, 128.0])),
                              "warm_avg_ms": float(rng.choice(
                                  [0.5, 1.0, 1.5, 2.0, 10.0]))}
        trips += int(rng.random() < 0.2)
        recov += int(rng.random() < 0.2)
        for key, step in (("off_lease_us", [0, 0, 400, 4000]),
                          ("off_lease_items", [0, 0, 4, 40]),
                          ("off_soundness_us", [0, 100, 1000])):
            off[key] += float(rng.choice(step))
        counters = dict(off)
        for key, choices in (
                ("ecdsa_host_items_delta", [0, 100]),
                ("ecdsa_host_us_delta", [0, 1000, 10000, 200000]),
                ("dur_runs_delta", [0, 4, 8]),
                ("dur_fsync_us_delta", [0, 400, 800, 1600]),
                ("st_bytes_delta", [0, 1e6, 1.5e6, 4e5]),
                ("st_failovers_delta", [0, 0, 0, 1]),
                ("client_table_hits_delta", [0, 10, 60, 100]),
                ("client_table_misses_delta", [0, 1, 40, 90]),
                ("client_table_evictions_delta", [0, 0, 35]),
                ("adm_shedding", [0, 1])):
            counters[key] = float(rng.choice(choices))
        state = "closed"
        verdict = "healthy"
        if health and rng.random() < 0.1:
            verdict = "degraded"
        if health and rng.random() < 0.05:
            state = "open"
        out.append(dict(
            stages=stages, kernels=kernels,
            breakers={"device": {"state": state, "trips": trips,
                                 "recoveries": recov}},
            health=verdict,
            depths={"exec_lane": int(rng.choice([0, 8, 40, 200])),
                    "client_table": int(rng.choice([0, 80, 900]))},
            counters=counters, completed_slots=slots))
    return out


def _tel(pkg, d):
    return PKGS[pkg][1].Telemetry(**d)


def _knob(pkg, value, **kw):
    kw.setdefault("cooldown_s", 0.0)
    return PKGS[pkg][0].Knob(name=kw.pop("name", "k"), value=value,
                             default=value, lo=kw.pop("lo", 0),
                             hi=kw.pop("hi", 1 << 20), **kw)


POLICIES = {
    "amortize_ed25519": lambda p: p.batch_amortize_policy("ed25519",
                                                          "adm_wait"),
    "amortize_bls_msm": lambda p: p.batch_amortize_policy("bls_msm",
                                                          "commit"),
    "optimistic_combine": lambda p: p.optimistic_combine_policy(
        p.batch_amortize_policy("bls_msm", "commit")),
    "breaker_readmission": lambda p: p.breaker_readmission_policy(),
    "device_min_batch": lambda p: p.device_min_batch_policy(),
    "exec_accumulation": lambda p: p.exec_accumulation_policy(),
    "ecdsa_crossover": lambda p: p.ecdsa_crossover_policy(),
    "crypto_shard": lambda p: p.crypto_shard_policy(),
    "durability_amortize": lambda p: p.durability_amortize_policy(),
    "st_window": lambda p: p.st_window_policy(),
    "client_table": lambda p: p.client_table_policy(),
    "admission_watermark": lambda p: p.admission_watermark_policy(),
    "offload_routing": lambda p: p.offload_routing_policy(),
}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_policy_votes_as_the_reference(name):
    """The same seeded readings and knob values through the port's and
    the reference's policy: the same vote at every interval, and the
    readings reach more than one vote."""
    seq = _telemetry_seq(seed=len(name), n=600)
    rng = np.random.default_rng(7)
    values = rng.choice([0, 1, 16, 64, 1024], size=len(seq))
    votes = {}
    for pkg in PKGS:
        pol = POLICIES[name](PKGS[pkg][1])
        prev, out = None, []
        for d, v in zip(seq, values):
            cur = _tel(pkg, d)
            out.append(pol(cur, prev, _knob(pkg, int(v))))
            prev = cur
        votes[pkg] = out
    assert votes["port"] == votes["ref"]
    assert len(set(votes["port"])) > 1, set(votes["port"])


def test_signal_helpers_match_the_reference():
    seq = _telemetry_seq(seed=99, n=200)
    for prev_d, cur_d in zip(seq, seq[1:]):
        got = []
        for pkg in PKGS:
            p = PKGS[pkg][1]
            cur, prev = _tel(pkg, cur_d), _tel(pkg, prev_d)
            got.append((
                p.fresh_slots(cur, prev),
                [p.stage_fraction(cur, s) for s in STAGES],
                [p.kernel_per_item_us(cur, k) for k in KINDS],
                [p.kernel_calls(cur, k) for k in KINDS],
                [p.per_item_falling(cur, prev, k) for k in KINDS]))
        assert got[0] == got[1]
    assert port_policies.PIPELINE_STAGES == ref_policies.PIPELINE_STAGES
    for const in ("DOMINANT_FRAC", "MINOR_FRAC", "FALLING_RATIO",
                  "CROSSOVER_MARGIN"):
        assert getattr(port_policies, const) == getattr(ref_policies, const)


# ----------------------------------------------------------------------
# knob registry
# ----------------------------------------------------------------------
def _registry_run(pkg, seed):
    """A seeded sequence of registry operations on a fake clock; every
    return value and the snapshot after each operation."""
    K = PKGS[pkg][0]
    rng = np.random.default_rng(seed)
    now = [0.0]
    reg = K.KnobRegistry("t", clock=lambda: now[0])
    applied = []
    names = ["a", "b", "c"]
    for i, name in enumerate(names):
        reg.register(K.Knob(
            name=name, value=int(rng.integers(1, 500)),
            default=int(rng.integers(1, 500)), lo=int(rng.integers(0, 10)),
            hi=int(rng.integers(400, 2000)),
            step_up=float(rng.choice([1.5, 1.01, 2.0])),
            step_down=float(rng.choice([0.5, 0.99, 0.75])),
            hysteresis=int(rng.integers(1, 4)),
            cooldown_s=float(rng.choice([0.0, 1.0, 5.0])),
            apply_fn=(lambda v, n=name: applied.append((n, v)))))
    trace = []
    for _ in range(400):
        now[0] += float(rng.choice([0.0, 0.5, 2.0, 6.0]))
        op = int(rng.integers(0, 9))
        name = names[int(rng.integers(0, 3))]
        if op <= 3:
            d = int(rng.choice([K.GROW, K.HOLD, K.SHRINK]))
            due = reg.vote(name, d)
            trace.append(("vote", name, d, due,
                          reg.step(name, d) if due else None))
        elif op == 4:
            trace.append(("set", name, reg.set(
                name, int(rng.integers(-10, 3000)))))
        elif op == 5:
            v = int(rng.integers(0, 1000)) if rng.random() < 0.5 else None
            reg.freeze(name, v)
            trace.append(("freeze", name, v))
        elif op == 6:
            reg.unfreeze(name)
            trace.append(("unfreeze", name))
        elif op == 7:
            trace.append(("reset", reg.reset_to_defaults()))
        else:
            v = int(rng.integers(0, 1000))
            reg.rebase_default(name, v)
            trace.append(("rebase", name, v))
        trace.append(reg.snapshot())
    return trace, applied, reg.id_table()


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_registry_matches_the_reference(seed):
    assert _registry_run("port", seed) == _registry_run("ref", seed)


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_seed_file_loads_in_the_other_package(tmp_path, writer, reader):
    p = str(tmp_path / "seed.json")
    PKGS[writer][0].write_seed(
        p, {"a": 250, "b": {"value": 40, "frozen": True}, "gone": 3},
        note="cross-package")
    regs = {}
    for pkg in PKGS:
        K = PKGS[pkg][0]
        reg = K.KnobRegistry("t")
        for n in ("a", "b", "c"):
            reg.register(K.Knob(name=n, value=100, default=100, lo=10,
                                hi=1000))
        regs[pkg] = reg
    assert PKGS[reader][0].load_seed(regs[reader], p) == 2
    PKGS[writer][0].load_seed(regs[writer], p)
    assert regs[reader].snapshot() == regs[writer].snapshot()
    assert regs[reader].get("a") == 250
    assert regs[reader].knob("b").frozen and regs[reader].get("b") == 40
    # the seed re-baselines the degraded-reset target
    regs[reader].set("a", 900)
    regs[reader].reset_to_defaults()
    assert regs[reader].get("a") == 250


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_malformed_seed_raises_in_both(tmp_path, pkg):
    p = tmp_path / "seed.json"
    p.write_text('{"knobs": [1, 2]}')
    K = PKGS[pkg][0]
    reg = K.KnobRegistry("t")
    reg.register(K.Knob(name="a", value=1, default=1, lo=0, hi=9))
    with pytest.raises(ValueError):
        K.load_seed(reg, str(p))


# ----------------------------------------------------------------------
# controller
# ----------------------------------------------------------------------
CATALOG = (("combine_flush_us", "amortize_bls_msm", 300, 0, 5000),
           ("verify_batch_flush_us", "amortize_ed25519", 200, 50, 20000),
           ("execution_max_accumulation", "exec_accumulation", 16, 1, 128),
           ("ecdsa_crossover_b", "ecdsa_crossover", 32, 1, 1 << 20),
           ("breaker_cooldown_ms", "breaker_readmission", 2000, 100,
            120_000),
           ("st_window_ranges", "st_window", 4, 1, 64),
           ("offload_route", "offload_routing", 1, 0, 1))


def _controller_run(pkg, seq, monkeypatch):
    """One controller per package over the same sensor readings (each
    sensor a function, as the replica wires them; the breaker registry
    read is the reading's)."""
    K, P, C = PKGS[pkg]
    now = [0.0]
    reg = K.KnobRegistry("t", clock=lambda: now[0])
    for name, _pol, v, lo, hi in CATALOG:
        reg.register(K.Knob(name=name, value=v, default=v, lo=lo, hi=hi,
                            cooldown_s=2.0))
    reg.register(K.Knob(name="pinned", value=7, default=7, lo=0, hi=9))
    cur = {}
    c = C.TuningController(
        reg, warmup_polls=2,
        stages_fn=lambda: {"stages": cur["stages"],
                           "finalized_total": cur["completed_slots"]},
        kernels_fn=lambda: cur["kernels"],
        health_fn=lambda: cur["health"],
        depths_fn=lambda: cur["depths"],
        counters_fn=lambda: {k: v for k, v in cur["counters"].items()
                             if not k.endswith("_delta")},
        clock=lambda: now[0])
    for name, pol, *_ in CATALOG:
        c.add_policy(name, POLICIES[pol](P))
    c.track("pinned")
    monkeypatch.setattr(C.breaker_mod, "snapshot_all",
                        lambda: cur["breakers"])
    made = []
    for i, d in enumerate(seq):
        now[0] += 1.0
        cur.update(d)
        if i == 40:
            reg.freeze("pinned", 3)
        made.append([(x["knob"], x["old"], x["new"], x["source"],
                      x["detail"]) for x in c.poll_once()])
    return made, reg.snapshot(), c.m_steps.value, c.m_resets.value


def test_controller_decides_as_the_reference(monkeypatch):
    seq = _telemetry_seq(seed=11, n=400, health=True)
    port = _controller_run("port", seq, monkeypatch)
    ref = _controller_run("ref", seq, monkeypatch)
    assert port == ref
    sources = {x[3] for step in port[0] for x in step}
    assert sources == {"policy", "degraded-reset"}, sources


def _reg(*knobs, clock=time.monotonic):
    r = port_knobs.KnobRegistry("t", clock=clock)
    for k in knobs:
        r.register(k)
    return r


def _k(name="a", value=100, lo=10, hi=1000, **kw):
    kw.setdefault("cooldown_s", 0.0)
    return port_knobs.Knob(name=name, value=value, default=value, lo=lo,
                           hi=hi, **kw)


def _ctl(reg, health=lambda: "healthy", **kw):
    kw.setdefault("warmup_polls", 1)
    return port_controller.TuningController(
        reg, interval_s=0.01, stages_fn=lambda: {"finalized_total": 0,
                                                 "stages": {}},
        kernels_fn=dict, health_fn=health, **kw)


def test_degraded_resets_once_and_spares_pins():
    reg = _reg(_k("a"), _k("b", value=50))
    reg.set("a", 400)
    reg.freeze("b", 90)
    c = _ctl(reg, health=lambda: "degraded")
    made = c.poll_once()
    assert [(d["knob"], d["old"], d["new"], d["source"]) for d in made] \
        == [("a", 400, 100, "degraded-reset")]
    assert reg.get("b") == 90
    assert c.poll_once() == []             # once per episode
    assert c.m_resets.value == 1


def test_open_port_breaker_counts_as_degraded():
    from tpubft_torch.utils import breaker as breaker_mod
    b = breaker_mod.CircuitBreaker("test-torch-tuning-breaker",
                                   failure_threshold=1, cooldown_s=60.0)
    try:
        reg = _reg(_k("a"))
        reg.set("a", 500)
        c = _ctl(reg)
        b.record_failure()
        assert c.poll_once()[0]["source"] == "degraded-reset"
        assert reg.get("a") == 100
    finally:
        b.reset()
        breaker_mod._registry.pop("test-torch-tuning-breaker", None)


def test_recovery_requires_a_healthy_warmup():
    health = ["degraded"]
    reg = _reg(_k("a"))
    c = _ctl(reg, health=lambda: health[0], warmup_polls=2)
    c.add_policy("a", lambda cur, prev, k: port_knobs.GROW)
    c.poll_once()
    health[0] = "healthy"
    assert c.poll_once() == [] and c.poll_once() == []   # warming up
    assert c.poll_once() == []             # first vote
    assert c.poll_once() != []             # second vote moves
    assert reg.get("a") == 150


def test_ev_tune_event_and_decision_log():
    if not flight.enabled():
        pytest.skip("flight recorder disabled")
    reg = _reg(_k("a"))
    c = _ctl(reg)
    c.add_policy("a", lambda cur, prev, k: port_knobs.GROW)
    for _ in range(4):
        c.poll_once()
    assert reg.get("a") > 100
    evs = [e for e in flight._ring().events() if e[1] == flight.EV_TUNE]
    assert evs
    d = c.decisions()[-1]
    _t, _code, seq, view, arg = evs[-1]
    assert seq == reg.knob_id("a") and (view, arg) == (d["old"], d["new"])


def test_render_dump_provider_and_running_loop():
    """The status payload, the flight-dump provider while running, and
    the daemon loop itself: awaited by its poll count; stop() returns
    at once and unregisters the provider."""
    reg = _reg(_k("a"))
    c = _ctl(reg)
    c.track("a")
    payload = json.loads(c.render())
    assert payload["knobs"]["a"]["value"] == 100
    assert payload["active"] is False and "decisions" in payload
    c.start()
    try:
        _await(lambda: c.m_polls.value >= 5, "five polls")
        assert json.loads(c.render())["active"] is True
        assert c._name in flight._providers
        assert flight.snapshot(max_events_per_ring=1)["providers"]
    finally:
        t0 = time.monotonic()
        c.stop()
        assert time.monotonic() - t0 < 1.0
    assert c._name not in flight._providers


def test_broken_sensors():
    """A broken PERF sensor reads as no signal; a broken HEALTH sensor
    fails safe, as degraded."""
    reg = _reg(_k("a"))
    c = port_controller.TuningController(
        reg, stages_fn=lambda: 1 / 0, health_fn=lambda: "healthy",
        warmup_polls=0)
    c.add_policy("a", port_policies.batch_amortize_policy("bls_msm",
                                                          "commit"))
    for _ in range(4):
        assert c.poll_once() == []
    reg.set("a", 500)
    c2 = port_controller.TuningController(reg, health_fn=lambda: 1 / 0,
                                          warmup_polls=0)
    made = c2.poll_once()
    assert [(d["knob"], d["new"], d["source"]) for d in made] \
        == [("a", 100, "degraded-reset")]


# ----------------------------------------------------------------------
# the crossover actuator
# ----------------------------------------------------------------------
def test_ecdsa_crossover_precedence(monkeypatch):
    """override, then TPUBFT_ECDSA_CROSSOVER_B, then the device default
    (1 << 30 on the CPU), as the reference's tpu.py:63-72, 94-117."""
    from tpubft_torch.crypto import cuda
    monkeypatch.delenv("TPUBFT_ECDSA_CROSSOVER_B", raising=False)
    assert cuda.ecdsa_crossover() == 1 << 30
    monkeypatch.setenv("TPUBFT_ECDSA_CROSSOVER_B", "12")
    assert cuda.ecdsa_crossover() == 12
    cuda.set_ecdsa_crossover(7)
    assert cuda.ecdsa_crossover() == 7
    cuda.set_ecdsa_crossover(0)               # clamped to >= 1
    assert cuda.ecdsa_crossover() == 1
    cuda.set_ecdsa_crossover(None)
    assert cuda.ecdsa_crossover() == 12


def test_no_card_seed_raises_no_device():
    """Seeding ecdsa_crossover_b asks for the device default: without a
    card and without a request for the CPU it raises, never guesses."""
    from tpubft_torch.crypto import cuda
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    device.set_default_device(None)
    with pytest.raises(device.NoDevice):
        cuda.ecdsa_crossover()
    cuda.set_ecdsa_crossover(5)              # the override needs no device
    assert cuda.ecdsa_crossover() == 5


# ----------------------------------------------------------------------
# the replica's catalog
# ----------------------------------------------------------------------
# the reference's catalog (tests/test_autotuner.py) less the mesh knob,
# which needs more than one chip
EXPECTED_KNOBS = {
    "verify_batch_flush_us", "verify_batch_size", "combine_flush_us",
    "combine_batch_max", "execution_max_accumulation",
    "admission_high_watermark", "ecdsa_crossover_b",
    "device_min_verify_batch", "st_window_ranges", "breaker_cooldown_ms",
    "durability_group_max", "durability_window_us", "client_table_max",
}


def test_replica_catalog_status_and_live_actuators(tmp_path):
    from tpubft.testing.cluster import InProcessCluster as RefCluster
    from tpubft_torch.testing import InProcessCluster
    seed = str(tmp_path / "seed.json")
    # a seed the reference wrote seeds the port's replicas
    ref_knobs.write_seed(seed, {"verify_batch_flush_us": 300})
    over = dict(crypto_backend="cpu", autotune_interval_ms=10,
                autotune_seed_file=seed)
    with RefCluster(f=1, cfg_overrides=dict(
            over, autotune_seed_file="")) as ref:
        ref_names = set(ref.replicas[0].tuning.registry.names())
    with InProcessCluster(f=1, cfg_overrides=over) as cluster:
        rep = cluster.replicas[0]
        assert set(rep.tuning.registry.names()) == EXPECTED_KNOBS \
            == ref_names - {"crypto_shard_count"}
        _await(lambda: all(r.tuning.m_polls.value >= 3
                           for r in cluster.replicas.values()),
               "three polls on every replica")
        payload = json.loads(rep.tuning.render())
        assert set(payload["knobs"]) == EXPECTED_KNOBS
        assert payload["active"] is True and payload["rid"] == 0
        assert payload["knobs"]["combine_flush_us"]["value"] \
            == rep.cfg.combine_flush_us
        assert payload["knobs"]["ecdsa_crossover_b"]["value"] == 1 << 20
        assert payload["knobs"]["verify_batch_flush_us"]["value"] \
            == payload["knobs"]["verify_batch_flush_us"]["default"] == 300
        # `status get tuning` through the diagnostics registrar
        served = json.loads(rep._diag.get_status("replica0.tuning"))
        assert served["rid"] == 0 and set(served["knobs"]) == EXPECTED_KNOBS
        # pinned: a degraded reset (any open breaker of the process)
        # cannot undo it before the seed is written
        for r in cluster.replicas.values():
            r.tuning.registry.freeze("execution_max_accumulation", 4)
        assert rep.exec_lane.max_accumulation == 4
        rep.tuning.registry.set("client_table_max", 512)
        assert rep.clients.max_resident == 512
        rep.tuning.registry.set("device_min_verify_batch", 3)
        assert rep.sig.device_min_batch == 3
        rep.tuning.registry.set("ecdsa_crossover_b", 9)
        from tpubft_torch.crypto import cuda
        assert cuda.ecdsa_crossover() == 9
    # a clean stop writes the operating point back (each replica in
    # turn, the last one wins); the reference loads it
    reg = ref_knobs.KnobRegistry("t")
    reg.register(ref_knobs.Knob(name="execution_max_accumulation", value=16,
                                default=16, lo=1, hi=128))
    assert ref_knobs.load_seed(reg, seed) == 1
    assert reg.get("execution_max_accumulation") == 4
    assert reg.knob("execution_max_accumulation").frozen


def test_policy_kernel_kinds_are_emitted_by_the_port():
    """Every kernel-profiler kind that a policy attached by the port's
    wiring reads is a kind some port `device_section(...)` emits: a
    renamed kind would starve its policy without any error."""
    import ast

    from tpubft_torch.testing import InProcessCluster
    root = os.path.join(os.path.dirname(__file__), "..", "tpubft_torch")
    emitted = set()
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Call) and getattr(
                        node.func, "id", getattr(node.func, "attr", "")) \
                        == "device_section" and node.args \
                        and isinstance(node.args[0], ast.Constant):
                    emitted.add(node.args[0].value)
    assert {"ed25519", "bls_msm", "ecdsa"} <= emitted, emitted

    read = set()

    class Recording(dict):
        def __init__(self, calls):
            super().__init__()
            self.calls = calls

        def get(self, kind, default=None):
            read.add(kind)
            return {"calls": self.calls, "batch_avg": 8.0,
                    "warm_avg_ms": 1.0}

    with InProcessCluster(f=1, cfg_overrides=dict(
            crypto_backend="cpu", offload_enabled=True,
            optimistic_replies=True)) as cluster:
        policies = cluster.replicas[0].tuning._policies
        for name, pol in policies.items():
            knob = cluster.replicas[0].tuning.registry.knob(name)
            for lease_items in (0.0, 4.0):
                prev = port_policies.Telemetry(
                    kernels=Recording(2), completed_slots=1,
                    counters={"off_lease_items": 0.0})
                cur = port_policies.Telemetry(
                    kernels=Recording(4), completed_slots=5,
                    counters={"off_lease_items": lease_items,
                              "ecdsa_host_items_delta": 10.0,
                              "ecdsa_host_us_delta": 1000.0})
                pol(cur, prev, knob)
    from tpubft_torch.offload.pool import reset_offload_pool
    reset_offload_pool()
    assert read == {"ed25519", "bls_msm", "ecdsa"}, read
    assert read <= emitted


# ----------------------------------------------------------------------
# default config, against the reference
# ----------------------------------------------------------------------
def _ledger_run(pkg, writes, overrides, budget_s=120):
    if pkg == "port":
        from tpubft_torch.apps import skvbc
        from tpubft_torch.kvbc import KeyValueBlockchain as Chain
        from tpubft_torch.storage.memorydb import MemoryDB
        from tpubft_torch.testing import InProcessCluster as Cluster
    else:
        from tpubft.apps import skvbc
        from tpubft.kvbc import KeyValueBlockchain as Chain
        from tpubft.storage.memorydb import MemoryDB
        from tpubft.testing import InProcessCluster as Cluster

    def handler(_r=None):
        return skvbc.SkvbcHandler(Chain(MemoryDB(),
                                        use_device_hashing=False))

    with Cluster(f=1, num_clients=1, seed=b"torch-tuning-default",
                 handler_factory=handler, cfg_overrides=overrides) as cl:
        client = cl.client()
        client._req_seq = 9_000_000
        orig = client._new_request_locked
        client._new_request_locked = (
            lambda payload, flags, cid, quorum: orig(
                payload, flags, f"tune-{client._req_seq + 1}", quorum))
        kv = skvbc.SkvbcClient(client)
        polls0 = {r: rep.tuning.m_polls.value
                  for r, rep in cl.replicas.items()}
        replies = []
        for ws in writes:
            replies.append(kv.write(ws, timeout_ms=budget_s * 1000))
        reps = list(cl.replicas.values())
        n = len(writes)
        _await(lambda: all(
            rep.last_executed == reps[0].last_executed
            and cl.handlers[rep.id].blockchain.last_block_id == n
            and rep.exec_lane.idle()
            and (rep.durability is None or rep.durability.idle())
            for rep in reps), "every replica to apply", budget_s)
        # the tuner ran through the load on every replica
        _await(lambda: all(rep.tuning.m_polls.value > polls0[rep.id] + 2
                           for rep in reps), "tuner polls")
        out = {"replies": [(r.success, r.latest_block) for r in replies],
               "tuned": {r: rep.tuning is not None
                         for r, rep in cl.replicas.items()}}
        for r, rep in cl.replicas.items():
            bc = cl.handlers[r].blockchain
            out[r] = (
                [bc.get_raw_block(b) for b in range(1, n + 1)],
                bc.state_digest(),
                sorted((k, v) for k, v in rep.res_pages.all_pages()
                       if k[2:].startswith((b"clientreplies",
                                            b"clients"))))
        return out


@pytest.mark.parametrize("cooldown_ms", [3000, 0])
def test_default_config_cluster_matches_the_reference(cooldown_ms):
    """ReplicaConfig's defaults (tuner and durability pipeline on) on
    both packages, the tuner polling every 10 ms (and, in the second
    case, free to move a knob at every vote): the same blocks, state
    digests, reply pages and replies."""
    writes = [[(b"k%d" % i, b"v%d-%d" % (i, i * 7))] for i in range(12)]
    over = dict(crypto_backend="cpu", autotune_interval_ms=10,
                autotune_cooldown_ms=cooldown_ms)
    port = _ledger_run("port", writes, over)
    ref = _ledger_run("ref", writes, over)
    assert port["tuned"] == ref["tuned"] == {r: True for r in range(4)}
    assert port == ref
    assert all(ok for ok, _ in port["replies"])
