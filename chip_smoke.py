#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpubft_torch) on one NVIDIA card.

    python3 chip_smoke.py

builds the CUDA kernels from the sources in the checkout (one nvcc per
source, all started together) and runs these phases in order, one JSON
line each; any failure exits non-zero:

  device   the card's name, power limit and SM clock, the builds, and from
           the SHA-256 kernel's SASS (cuobjdump) the opcodes of its longest
           loop (a diagnostic); SHA-256's bound counts the algorithm's
           operations (ops/sha256_cuda.OPS_PER_COMPRESSION), not a build's,
           and its chain floor takes the cycles a round from
           ops/sha256_cuda.ROUND_CYCLES;
  ladder   the bring-up ladder (python -m tpubft_torch.tools.bringup):
           six rungs at 1024 lanes — bringup_copy, fe_carry, fe_mul,
           fe_inv, fe_table_gather and the verify kernel — each against
           Python ints (or the host scalar verdicts) and against its
           plain PyTorch version; each timed by the host's enqueue time
           per call and by device time (a CUDA graph of the calls replayed
           under CUDA events), beside the plain version's time;
           bringup_copy and torch.add also by the profiler's kernel time,
           and at 2^20 lanes, where the bytes bound them; fe_inv
           (csrc/fe_inv.cu) also with the lanes an element its launch ran
           (four at 1024 by ops/bringup_cuda.lanes_for, as the launcher
           reports them), both designs' clock64 cycles a step
           (tools/fe_inv_probe.py) and the chain floor at the launched
           design's cycles, and at 2^17 elements (one lane an element),
           where its throughput bound applies, against Python ints on a
           strided sample and its plain version on a 4096-element slice;
  kernel   the CUDA verify kernel against the plain PyTorch verify on the
           card, raw, and against the host scalar verdicts, on the
           strict-verify corpus at B = 1, 3, 33, 100, 192 and 1024 (edges
           inside a warp and a four-lane group), and on raw inputs the
           host never sends (y >= p);
  plane    BASELINE config 1 end to end through the normal entry points:
           n=4 f=1 c=0, Ed25519 replicas and clients, the adaptive
           certificate scheme (multisig-ed25519). 8 PrePrepare batches of
           100 client requests (about 3% forged) through BatchVerifier over
           SigManager(batch_fn=crypto.cuda.verify_batch_mixed), then the
           commit certificates of 64 slots through combine_batch and
           verify_batch_certs; every verdict, certificate and bad-share list
           equals the host scalar backend's, the kernel was launched on
           every step, nothing degraded or fell back to the host (the
           SigManager's and the multisig verifier's counters, and the
           breaker: no failure, one success per launch) and the device
           breaker is closed;
  ledger   config 1's categorized KVBC ledger at the kvbcbench block shape
           (800 blocks of 8 versioned keys and one Merkle-proven key) on a
           MemoryDB with use_device_hashing=True, against the same ledger
           hashed by hashlib, applied twice: as the reference's migrate_v4
           ingests, add_blocks in chunks of 64 (no Merkle level reaches the
           192 nodes that send it to the device; the count is printed), and
           as a synthetic stress of the SHA-256 kernel, one add_blocks of
           all 800 blocks (every level reaches the device). Each run: every
           block's Merkle root, block digest and raw block and every DB row
           byte-equal to hashlib's, nothing degraded, one breaker success
           per launch; the stress run launched once per device level;
  digest   the ledger's raw blocks in state-transfer windows of 64 through
           the window-digest helper (sha256_batch_mixed), plus one window
           of mixed block sizes, against hashlib: config 1's SHA-256 path,
           one launch a window and one copy each way, the bytes sent equal
           to the window's raw bytes plus its offsets. Per window the
           call's time, its steps (host pack and pinned staging; copy
           in, kernel and copy out between CUDA events) and hashlib's; then windows of 16 to
           256 blocks, device call against hashlib, 20 calls each
           (tpubft_torch/tools/digest_breakdown.py);
  rate     the verify kernel alone (CUDA events, after warm-up) at B = 100,
           192, 256, 1024 and 16384, the host prepare_batch time at the
           same B and the plain version's time at B=1024, with the
           kernel's critical path in dependent field steps; the SHA-256
           kernel alone at B = 192, 1024, 4096 and 16384 two-block Merkle
           messages (per call and by a CUDA graph) beside the host pack,
           hashlib over the same messages and the plain version at
           B=1024;
  kernels  every kernel with its launches on its path (the plane, the
           ladder, the state-transfer digests), its match against the plain
           version, its device time (`ms`, a CUDA graph) and host enqueue
           time (`host_ms`), its bound and the plain version's time;
           SHA-256 also with its chain floor, and matched against its plain
           version on both windows and a 1024-node Merkle level.

Then the card's name and power limit as nvidia-smi reports them, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a card, or without the tpubft_torch package beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.isdir(os.path.join(HERE, "tpubft_torch")):
    sys.path.insert(0, HERE)
    from tpubft_torch.tools.timing import cuda_ms, graph_ms

# SM count and INT32 multiply-add lanes per SM per clock of an H100 SXM
# (NVIDIA Hopper architecture white paper); HBM rate from the data sheet
H100_SMS = 132
INT32_IMAD_PER_SM_CLK = 64
HBM_BYTES_PER_S = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def profiler_kernel_ms(fn, iters: int = 20):
    """Mean device time per call of the kernels fn() launches, from a
    torch.profiler trace; None where the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.self_device_time_total for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA)
    return us / 1e3 / iters if us > 0 else None


def verify_bound_ms(batch: int, sm_clock_mhz: float) -> dict:
    """Least time the card could take for `batch` verifies: the larger of
    the integer multiply-adds the function needs (an IMAD.WIDE counted as
    two) over the INT32 rate and the bytes (each input read once, the
    verdict written once) over the HBM rate. `executed_ops` counts what the
    four-lane kernel runs instead, for its work efficiency."""
    from tpubft_torch.ops import ed25519_cuda as kc

    def imad_ops(counts):
        imad = kc.imad_per_verify(counts)
        return batch * (2 * imad["imad_wide"] + imad["imad"])

    nbytes = batch * ((2 * 64 + 2 * 24 + 2) * 4 + 1)
    out = work_bound_ms(imad_ops(kc.function_ops_per_verify()), nbytes,
                        sm_clock_mhz)
    out["executed_ops"] = imad_ops(kc.field_ops_per_verify())
    return out


# ---------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------

def phase_device(torch) -> dict:
    from tpubft_torch.ops import _build
    smi = nvidia_smi("name,power.limit")
    clk = nvidia_smi("clocks.max.sm").split()[0]
    from tpubft_torch.ops import sha256_cuda
    t0 = time.monotonic()
    build_s = build_all()
    build_wall_s = time.monotonic() - t0
    loop = sha256_cuda.sass_loop_body()
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "clocks_max_sm_mhz": float(clk),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "build_s": build_s, "build_wall_s": build_wall_s,
            "ptxas": dict(_build.ptxas_report),
            "sha256_sass_loop": dict(loop.most_common()),
            "sha256_sass_loop_int32": sha256_cuda.int32_ops(loop),
            "sha256_ops_per_compression": sha256_cuda.OPS_PER_COMPRESSION,
            "sha256_round_cycles": sha256_cuda.ROUND_CYCLES}
    emit(info)
    return info


def build_all() -> dict:
    """Build every kernel library at once, one nvcc per source in its own
    thread; -> {library: seconds}. A failed build raises."""
    import threading

    from tpubft_torch.ops import bringup_cuda, ed25519_cuda, sha256_cuda
    libs = {"ed25519_verify": ed25519_cuda.library,
            "sha256": sha256_cuda.library, "bringup": bringup_cuda.library,
            "fe_inv": bringup_cuda.fe_inv_library}
    seconds, errors = {}, []

    def build(name, fn):
        t0 = time.monotonic()
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)
        seconds[name] = time.monotonic() - t0

    threads = [threading.Thread(target=build, args=item)
               for item in libs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return seconds


def work_bound_ms(ops: int, nbytes: int, sm_clock_mhz: float) -> dict:
    """The larger of `ops` 32-bit integer operations over 132 SMs x 64
    INT32 lanes x the SM clock and `nbytes` over the HBM rate."""
    ops_ms = ops / (H100_SMS * INT32_IMAD_PER_SM_CLK * sm_clock_mhz * 1e6) \
        * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": by, "ops": ops,
            "bytes": nbytes}


def reset_all_launches() -> None:
    from tpubft_torch.ops import bringup_cuda, ed25519_cuda, sha256_cuda
    for mod in (bringup_cuda, ed25519_cuda, sha256_cuda):
        mod.reset_launches()


def all_launches() -> dict:
    from tpubft_torch.ops import bringup_cuda, ed25519_cuda, sha256_cuda
    return {**ed25519_cuda.LAUNCHES, **bringup_cuda.LAUNCHES,
            **sha256_cuda.LAUNCHES}


def phase_ladder(torch, dev, sm_clock_mhz: float) -> dict:
    """The six bring-up rungs through tpubft_torch.tools.bringup."""
    from tpubft_torch.ops import bringup_cuda
    from tpubft_torch.tools import bringup
    reset_all_launches()
    rungs = bringup.run_ladder(dev)
    launches = all_launches()
    inv_lanes = launched_lanes(bringup_cuda.FE_INV_LANES)
    rows = []
    for r in rungs:
        row = dict(r.report)
        name = row["kernel"]
        row["launches"] = launches[name]
        verify = name == "ed25519_verify"
        # the host's enqueue time per call, then device time (a CUDA graph
        # of the calls)
        row["host_ms"] = cuda_ms(r.run, 5 if verify else 20)
        row["ms"] = graph_ms(r.run, 5 if verify else 100)
        row["plain_ms"] = cuda_ms(r.plain, 1)
        # rung 0's plain version is one PyTorch call (an add), so it is
        # also the library yardstick; no single call computes the others
        row["library_ms"] = None
        if name == "bringup_copy":
            row["library_host_ms"] = cuda_ms(r.plain, 20)
            row["library_ms"] = graph_ms(r.plain, 100)
            copy_rung = (row, r)
        if verify:
            row.update(verify_bound_ms(row["lanes"], sm_clock_mhz))
        else:
            row.update(work_bound_ms(*bringup_cuda.work(name, row["lanes"]),
                                     sm_clock_mhz))
        if name == "fe_inv":
            row.update(fe_inv_yardsticks(dev, row, inv_lanes, sm_clock_mhz))
        rows.append(row)
    # the profiler's kernel time of the copy and torch.add, once, after
    # every other timing: it splits the graph time into kernel and node
    row, r = copy_rung
    row["kernel_ms"] = profiler_kernel_ms(r.run)
    row["library_kernel_ms"] = profiler_kernel_ms(r.plain)
    out = {"phase": "ladder", "lanes": bringup.TILE, "rungs": rows,
           "copy_large": copy_large_row(torch, dev, sm_clock_mhz),
           "fe_inv_large": fe_inv_large_row(torch, dev, sm_clock_mhz)}
    emit(out)
    if len(rungs) != len(bringup.RUNGS) or not all(r.ok for r in rungs):
        raise AssertionError(f"ladder rung failed: {rows[-1]}")
    if not out["copy_large"]["equal_plain"]:
        raise AssertionError("bringup_copy at 2^20 lanes differs from its "
                             "plain version")
    big = out["fe_inv_large"]
    if big["mismatches_vs_int"] or big["mismatches_vs_plain"]:
        raise AssertionError(f"fe_inv at 2^17 elements differs: {big}")
    probes = [p for r in rows if r["kernel"] == "fe_inv"
              for p in r["probes"].values()]
    if any(p["mismatches_vs_int"] for p in probes):
        raise AssertionError(f"fe_inv probe differs: {probes}")
    # the lanes each side's launch ran, as the launcher reported them
    if {inv_lanes, big["lanes_per_element"]} != {1, 4}:
        raise AssertionError(
            f"fe_inv launched {inv_lanes} lanes an element at "
            f"{bringup.TILE} elements and {big['lanes_per_element']} at "
            f"{big['lanes']}: the ladder did not drive both sides of its "
            "lanes rule")
    missing = [r["kernel"] for r in rows if r["launches"] < 1]
    if missing:
        raise AssertionError(f"ladder ran without launching {missing}")
    return out


def copy_large_row(torch, dev, sm_clock_mhz: float) -> dict:
    """bringup_copy and torch.add at 2^20 lanes (96 MB in, 96 MB out),
    where the bytes bound the copy."""
    from tpubft_torch.ops import bringup_cuda as bu
    lanes = 1 << 20
    gen = torch.Generator(device=dev).manual_seed(3)
    a = torch.randint(0, 1 << 26, (bu.NL, lanes), dtype=torch.int32,
                      device=dev, generator=gen)
    got = bu.bringup_copy(a)
    row = {"lanes": lanes, "equal_plain": bool(torch.equal(
        got, bu.plain_copy(a)))}
    del got
    row["host_ms"] = cuda_ms(lambda: bu.bringup_copy(a), 10)
    row["ms"] = graph_ms(lambda: bu.bringup_copy(a), 10)
    row["library_ms"] = graph_ms(lambda: bu.plain_copy(a), 10)
    row.update(work_bound_ms(*bu.work("bringup_copy", lanes), sm_clock_mhz))
    row["gb_per_s"] = row["bytes"] / row["ms"] / 1e6
    torch.cuda.empty_cache()
    return row


def launched_lanes(counts) -> int:
    """The lanes an element (4 or 1) of the fe_inv launches counted in
    `counts` (bringup_cuda.FE_INV_LANES, or a difference of two), or 0
    where they ran neither design or both."""
    used = [lanes for lanes, k in counts.items() if k]
    return used[0] if len(used) == 1 else 0


def fe_inv_yardsticks(dev, row, lanes: int, sm_clock_mhz: float) -> dict:
    """The rung-3 row's yardsticks: the lanes an element its launch ran,
    what those lanes execute beside what the function needs, the clock64
    cycles a step of both designs at the rung's size (tools/fe_inv_probe;
    measurement launches, after the ladder's counts were read), the chain
    floor at the cycles of the design the launch ran, and the bound's
    share of the device time."""
    from tpubft_torch.ops import bringup_cuda as bu
    from tpubft_torch.tools import fe_inv_probe
    n = row["lanes"]
    if lanes not in (1, 4):
        raise AssertionError("the ladder's fe_inv launch ran no single "
                             f"design: {dict(bu.FE_INV_LANES)}")
    probes = {f"lanes_{k}": fe_inv_probe.probe(dev, n, k) for k in (4, 1)}
    step = probes[f"lanes_{lanes}"]["step_cycles"]
    return {"lanes_per_element": lanes,
            "executed_ops": bu.executed_ops(n, lanes),
            "step_cycles": step,
            "chain_floor_ms": bu.chain_floor_ms(n, sm_clock_mhz, step),
            "share_of_bound": row["bound_ms"] / row["ms"],
            "probes": probes}


def fe_inv_large_row(torch, dev, sm_clock_mhz: float) -> dict:
    """fe_inv at 2^17 elements, where the card is full and its throughput
    bound applies (one lane an element by lanes_for): the lanes the
    launcher ran, device time by graph against the bound, checked against
    Python ints on a strided sample and against the plain version on a
    4096-element slice."""
    from tpubft_torch.ops import bringup_cuda as bu
    from tpubft_torch.tools import bringup, fe_inv_probe
    n = 1 << 17
    a_np = fe_inv_probe.elements(n, seed=11)
    a = torch.from_numpy(a_np).to(dev)
    before = dict(bu.FE_INV_LANES)
    got = bu.fe_inv(a)
    lanes = launched_lanes({k: bu.FE_INV_LANES[k] - before[k]
                            for k in before})
    part = a[:, :4096].contiguous()
    row = {"lanes": n, "lanes_per_element": lanes,
           "mismatches_vs_int": fe_inv_probe.sample_mismatches(
               a_np, got.cpu().numpy(), samples=257),
           "mismatches_vs_plain": bringup._lane_mismatches(
               got[:, :4096].cpu().numpy(),
               bringup._plain_inv(part).cpu().numpy())}
    row["host_ms"] = cuda_ms(lambda: bu.fe_inv(a), 10)
    row["ms"] = graph_ms(lambda: bu.fe_inv(a), 10)
    row["plain_4096_ms"] = cuda_ms(lambda: bringup._plain_inv(part), 1)
    row.update(work_bound_ms(*bu.work("fe_inv", n), sm_clock_mhz))
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    if lanes in (1, 4):
        row["executed_ops"] = bu.executed_ops(n, lanes)
    return row


# the verify kernel's batch sizes: one lane, a ragged warp and group edge
# (3, 33), config 1's PrePrepare (100), its verify_batch_size-sized flushes
# (192 drains), and the ladder's tile
KERNEL_BATCHES = (1, 3, 33, 100, 192, 1024)


def phase_kernel(torch, dev) -> dict:
    """The CUDA verify vs the plain PyTorch verify on the card, raw, and
    (masked by host_valid) vs the host scalar engine, on the strict-verify
    corpus at every KERNEL_BATCHES size, plus the raw inputs the host never
    sends (testing.raw_kernel_lanes)."""
    import numpy as np

    from tpubft_torch import testing
    from tpubft_torch.crypto import scalar
    from tpubft_torch.ops import ed25519 as ops
    from tpubft_torch.ops import ed25519_cuda as kc
    rows = []
    for b in KERNEL_BATCHES:
        items = testing.ed25519_corpus(b, seed=7 + b)
        prep = ops.prepare_batch(items)
        args = ops.to_tensors(ops._pad_rows(prep, b, b), dev)
        got = kc.verify(*args).cpu().numpy()
        plain = ops.plain_verify_kernel(*args).cpu().numpy()
        host = np.array([scalar.ed25519_verify(pk, m, s)
                         for m, s, pk in items])
        rows.append({"batch": b,
                     "kinds": len({testing.KINDS[i % len(testing.KINDS)]
                                   for i in range(b)}),
                     "raw_mismatches": int((got != plain).sum()),
                     "host_mismatches": int(((got & prep.host_valid)
                                             != host).sum()),
                     "valid": int(host.sum()),
                     "kernel_accepts_host_rejected": int(
                         (got & ~prep.host_valid).sum())})
    arrays, want = testing.raw_kernel_lanes()
    args = ops.to_tensors(arrays, dev)
    got = kc.verify(*args).cpu().numpy()
    plain = ops.plain_verify_kernel(*args).cpu().numpy()
    raw = {"lanes": len(want), "verdicts": got.tolist(),
           "plain": plain.tolist(), "expected": want}
    out = {"phase": "kernel", "batches": rows, "raw_lanes": raw,
           "raw_mismatches": sum(r["raw_mismatches"] for r in rows)
           + int((got != plain).sum()),
           "host_mismatches": sum(r["host_mismatches"] for r in rows)}
    out["max_abs_err"] = int(out["raw_mismatches"] > 0)
    emit(out)
    if out["raw_mismatches"] or out["host_mismatches"] \
            or got.tolist() != want:
        raise AssertionError(f"kernel phase mismatches: {out}")
    return out


def phase_plane(torch, dev, num_pp: int = 8, slots: int = 64) -> dict:
    """Config 1 through SigManager/BatchVerifier and the multisig
    cryptosystem, against the host scalar backend."""
    import numpy as np

    from tpubft_torch.consensus import keys as K
    from tpubft_torch.consensus.sig_manager import BatchVerifier, SigManager
    from tpubft_torch.crypto import cuda as crypto_cuda
    from tpubft_torch.crypto.cpu import make_signer
    from tpubft_torch.crypto.digest import calc_combination, digest
    from tpubft_torch.ops import ed25519_cuda as kc
    from tpubft_torch.ops.dispatch import device_breaker
    from tpubft_torch.utils import flight
    from tpubft_torch.utils.config import ReplicaConfig

    seed = b"chip-smoke-config-1"
    cfg = ReplicaConfig(f_val=1, c_val=0, threshold_scheme="adaptive")
    t0 = time.monotonic()
    ck = K.ClusterKeys.generate(cfg, num_clients=100, seed=seed)
    keygen_s = time.monotonic() - t0
    assert ck.n == 4 and ck.threshold_scheme == "multisig-ed25519", ck
    first_client = cfg.n_val + cfg.num_ro_replicas
    clients = list(range(first_client, first_client + 100))
    rng = np.random.default_rng(1)
    per_client = {}
    for cl in clients:
        signer = make_signer("ed25519", seed=K._derive_seed(seed, "client",
                                                            cl))
        msgs = [rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
                for _ in range(num_pp)]
        per_client[cl] = list(zip(msgs, signer.sign_batch(msgs)))
    batch = cfg.max_num_of_requests_in_batch
    pps = []
    forged = set(rng.choice(num_pp * batch, size=num_pp * batch * 3 // 100,
                            replace=False).tolist())
    for p in range(num_pp):
        reqs = []
        for r in range(batch):
            cl = clients[r % len(clients)]
            msg, sig = per_client[cl][p]
            if p * batch + r in forged:
                j = int(rng.integers(0, 64))
                sig = sig[:j] + bytes([sig[j] ^ 0x10]) + sig[j + 1:]
            reqs.append((cl, msg, sig))
        pps.append(reqs)

    # the host scalar backend's verdicts (no batch backend)
    host_sm = SigManager(ck.for_node(0))
    t_host = time.monotonic()
    want_pp = [host_sm.verify_batch(reqs) for reqs in pps]
    host_pp_s = time.monotonic() - t_host

    breaker = device_breaker()
    breaker.reset()
    br0 = breaker.snapshot()
    kc.reset_launches()
    flight.kernel_profiler().reset()
    sm = SigManager(ck.for_node(0), batch_fn=crypto_cuda.verify_batch_mixed,
                    device_min_batch=cfg.device_min_verify_batch)
    bv = BatchVerifier(sm, batch_size=cfg.verify_batch_size,
                       flush_us=cfg.verify_batch_flush_us)
    steps = []
    got_pp = []
    t_pp = time.monotonic()
    try:
        for reqs in pps:
            before = kc.LAUNCHES["ed25519_verify"]
            t_step = time.monotonic()
            pend = [bv.submit(cl, m, s) for cl, m, s in reqs]
            got_pp.append([v.result(timeout=300) for v in pend])
            steps.append(("preprepare",
                          kc.LAUNCHES["ed25519_verify"] - before,
                          (time.monotonic() - t_step) * 1e3))
    finally:
        bv.stop()
    pp_s = time.monotonic() - t_pp

    # commit certificates: slow-path system, threshold 2f+c+1 = 3
    system = ck.slow_path_system
    k = system.threshold_
    signers = {r + 1: ck.threshold_signer(system, r) for r in range(ck.n)}
    digests = [calc_combination(digest(b"block-%d" % i), 0, i + 1)
               for i in range(slots)]
    bad_slot = slots // 3
    jobs = []
    for i, d in enumerate(digests):
        shares = {}
        for sid in range(1, k + 1):
            msg = b"forged" + d[6:] if (i == bad_slot and sid == 2) else d
            shares[sid] = signers[sid].sign_share(msg)
        jobs.append((d, shares))
    dev_v = ck.threshold_verifier(system, backend="cuda",
                                  min_device_batch=cfg.device_min_verify_batch)
    host_v = system.create_threshold_verifier()
    before = kc.LAUNCHES["ed25519_verify"]
    t_c = time.monotonic()
    got_comb = dev_v.combine_batch(jobs)
    comb_s = time.monotonic() - t_c
    steps.append(("combine_batch", kc.LAUNCHES["ed25519_verify"] - before,
                  comb_s * 1e3))
    want_comb = host_v.combine_batch(jobs)
    certs = [(d, sig) for (d, _), (ok, sig, _) in zip(jobs, got_comb) if ok]
    tampered = bytearray(certs[0][1])
    tampered[2 + 2 + 10] ^= 0x01              # first share's signature
    certs.append((certs[0][0], bytes(tampered)))
    before = kc.LAUNCHES["ed25519_verify"]
    t_v = time.monotonic()
    got_certs = dev_v.verify_batch_certs(certs)
    certs_s = time.monotonic() - t_v
    steps.append(("verify_batch_certs",
                  kc.LAUNCHES["ed25519_verify"] - before, certs_s * 1e3))
    want_certs = host_v.verify_batch_certs(certs)
    launches = dict(kc.LAUNCHES)
    br1 = breaker.snapshot()

    counters = sm.metrics.snapshot()["counters"]
    profile = flight.kernel_profiler().snapshot()
    out = {"phase": "plane", "n": ck.n, "f": ck.f, "c": ck.c,
           "scheme": ck.threshold_scheme, "clients": len(clients),
           "preprepares": num_pp, "requests_per_pp": batch,
           "forged": len(forged), "slots": slots, "threshold": k,
           "keygen_s": keygen_s, "preprepare_s": pp_s,
           "host_scalar_preprepare_s": host_pp_s,
           "combine_s": comb_s, "certs_s": certs_s,
           "launches": launches, "steps": steps,
           "pp_verdicts_equal": got_pp == want_pp,
           "accepted": sum(map(sum, got_pp)),
           "combine_equal": got_comb == want_comb,
           "combine_ok": sum(ok for ok, _, _ in got_comb),
           "bad_shares": [bad for _, _, bad in got_comb if bad],
           "certs_equal": got_certs == want_certs,
           "certs_ok": sum(got_certs), "certs": len(certs),
           "degraded_verifies": counters["degraded_verifies"],
           "scalar_fallbacks": counters["scalar_fallbacks"],
           "batched_verifies": counters["batched_verifies"],
           "breaker": br1["state"],
           # every outermost device section is one ed25519 launch here; a
           # fault the host tier answered shows as a breaker failure and in
           # the multisig verifier's `degraded` count, not in the verdicts
           "breaker_successes": br1["successes"] - br0["successes"],
           "breaker_failures": br1["failures"] - br0["failures"],
           "breaker_fast_fails": br1["fast_fails"] - br0["fast_fails"],
           "multisig_degraded": dev_v.degraded,
           "profile": profile.get("ed25519")}
    emit(out)
    problems = []
    if not out["pp_verdicts_equal"]:
        problems.append("PrePrepare verdicts differ from the host backend")
    if not out["combine_equal"] or not out["certs_equal"]:
        problems.append("certificates differ from the host backend")
    if out["bad_shares"] != [[2]]:
        problems.append(f"bad shares {out['bad_shares']} != [[2]]")
    if any(n_launch < 1 for _, n_launch, _ in steps):
        problems.append(f"a step ran without a kernel launch: {steps}")
    if out["degraded_verifies"] or out["scalar_fallbacks"]:
        problems.append("the device path degraded or fell back")
    if out["multisig_degraded"]:
        problems.append("the multisig verifier fell back to the host "
                        f"{out['multisig_degraded']} times")
    if out["breaker_failures"] or out["breaker_fast_fails"]:
        problems.append(f"device breaker recorded {out['breaker_failures']} "
                        f"failures, {out['breaker_fast_fails']} fast-fails")
    if out["breaker_successes"] != launches["ed25519_verify"]:
        problems.append(f"{out['breaker_successes']} device sections "
                        f"succeeded for {launches['ed25519_verify']} launches")
    if out["breaker"] != "closed":
        problems.append(f"device breaker {out['breaker']}")
    if not out["profile"]:
        problems.append("kernel profiler has no ed25519 rows")
    if problems:
        raise AssertionError("; ".join(problems))
    return out


def phase_ledger(torch, dev, blocks: int = 800, chunk: int = 64) -> dict:
    """Config 1's categorized ledger at the kvbcbench block shape, device
    hashing against hashlib: ingested in add_blocks chunks of 64 as the
    reference's migrate_v4 does, and once as one 800-block add_blocks, a
    synthetic stress in which every Merkle level reaches the device."""
    from tpubft_torch import convert, testing
    from tpubft_torch.kvbc import create_blockchain, sparse_merkle
    from tpubft_torch.ops import sha256_cuda
    from tpubft_torch.ops.dispatch import device_breaker
    from tpubft_torch.storage import MemoryDB
    from tpubft_torch.utils import flight

    updates = [convert.block_updates(rows)
               for rows in testing.kvbcbench_rows(blocks)]
    ids = range(1, blocks + 1)

    def ingest(bc, size):
        t0 = time.perf_counter()
        for i in range(0, blocks, size):
            bc.add_blocks(updates[i:i + size])
        return time.perf_counter() - t0

    db_host = MemoryDB()
    bc_host = create_blockchain(db_host, use_device_hashing=False)
    host_s = ingest(bc_host, chunk)
    host_rows = list(db_host.scan_all())

    # count the Merkle levels that go to the device and the wall time of
    # their calls (host prepare + copies + kernel), around the module's
    # own function
    real_hash_level = sparse_merkle._hash_level
    breaker = device_breaker()
    runs = {}
    for name, size in (("migrate_chunks", chunk), ("stress", blocks)):
        levels = {"device": 0, "host": 0, "device_s": 0.0}

        def counted(messages, use_device, levels=levels):
            on_device = use_device and \
                len(messages) >= sparse_merkle._DEVICE_THRESHOLD
            levels["device" if on_device else "host"] += 1
            t0 = time.perf_counter()
            try:
                return real_hash_level(messages, use_device)
            finally:
                if on_device:
                    levels["device_s"] += time.perf_counter() - t0

        breaker.reset()
        br0 = breaker.snapshot()
        flight.kernel_profiler().reset()
        sparse_merkle.DEGRADED = 0
        db = MemoryDB()
        bc = create_blockchain(db, use_device_hashing=True)
        sparse_merkle._hash_level = counted
        reset_all_launches()
        try:
            dev_s = ingest(bc, size)
        finally:
            sparse_merkle._hash_level = real_hash_level
        launches = sha256_cuda.LAUNCHES["sha256"]
        br1 = breaker.snapshot()
        runs[name] = {
            "add_blocks_calls": -(-blocks // size),
            "blocks_per_call": size, "head": bc.last_block_id,
            "device_ledger_s": dev_s,
            "levels_on_device": levels["device"],
            "levels_on_host": levels["host"],
            "device_level_calls_s": levels["device_s"],
            "sha256_launches": launches,
            "device_sections": flight.kernel_profiler().snapshot().get(
                "sha256", {}),
            "roots_equal": all(
                bc.get_block(b).category_digests
                == bc_host.get_block(b).category_digests for b in ids),
            "block_digests_equal": all(
                bc.block_digest(b) == bc_host.block_digest(b) for b in ids),
            "raw_blocks_equal": all(
                bc.get_raw_block(b) == bc_host.get_raw_block(b)
                for b in ids),
            "db_equal": list(db.scan_all()) == host_rows,
            "merkle_root": bc.merkle_root("proven").hex(),
            "degraded": sparse_merkle.DEGRADED,
            "breaker_successes": br1["successes"] - br0["successes"],
            "breaker_failures": br1["failures"] - br0["failures"],
            "breaker_fast_fails": br1["fast_fails"] - br0["fast_fails"]}
    out = {"phase": "ledger", "blocks": blocks,
           "hashlib_ledger_s": host_s, "hashlib_chunk": chunk,
           "db_rows": len(host_rows), **runs}
    emit(out)
    problems = []
    for name, r in runs.items():
        problems += [f"{name}: {k}" for k in
                     ("roots_equal", "block_digests_equal",
                      "raw_blocks_equal", "db_equal") if not r[k]]
        if r["head"] != blocks:
            problems.append(f"{name}: head {r['head']} != {blocks}")
        if r["sha256_launches"] < r["levels_on_device"]:
            problems.append(f"{name}: {r['sha256_launches']} sha256 "
                            f"launches for {r['levels_on_device']} "
                            "device levels")
        if r["degraded"]:
            problems.append(f"{name}: {r['degraded']} Merkle levels fell "
                            "back to hashlib")
        if r["breaker_failures"] or r["breaker_fast_fails"]:
            problems.append(f"{name}: device breaker recorded failures")
        if r["breaker_successes"] != r["sha256_launches"]:
            problems.append(f"{name}: {r['breaker_successes']} device "
                            f"sections succeeded for "
                            f"{r['sha256_launches']} launches")
    if runs["stress"]["levels_on_device"] < 1:
        problems.append("the stress run sent no Merkle level to the device")
    if problems:
        raise AssertionError("; ".join(problems))
    out["raws"] = [bc_host.get_raw_block(b) for b in ids]
    return out


def phase_digest(torch, dev, raws, window: int = 64, reps: int = 20
                 ) -> dict:
    """State-transfer window digests of the ledger's raw blocks, and one
    window of mixed sizes, against hashlib; then each window's steps and
    the crossover sweep (measurement launches, not counted)."""
    import hashlib

    from tpubft_torch.ops import sha256 as sha
    from tpubft_torch.ops import sha256_cuda
    from tpubft_torch.statetransfer import digests
    from tpubft_torch.tools import digest_breakdown as bd

    windows = [raws[i:i + window] for i in range(0, len(raws), window)]
    windows.append(bd.ledger_raws(window, big_every=8))
    digests.DEGRADED = 0
    reset_all_launches()
    rows = []
    for w in windows:
        before = sha256_cuda.LAUNCHES["sha256"]
        copies = dict(sha.COPIES)
        t0 = time.perf_counter()
        got = digests.window_digests(w, use_device=True)
        ms = (time.perf_counter() - t0) * 1e3
        rows.append({"blocks": len(w), "bytes": sum(map(len, w)),
                     "expect_launch": len(w) >= digests.DEVICE_DIGEST_THRESHOLD,
                     "block_counts": sorted({sha.blocks_needed(len(r))
                                             for r in w}),
                     "launches": sha256_cuda.LAUNCHES["sha256"] - before,
                     "ms": ms,
                     **{k: sha.COPIES[k] - copies[k] for k in sha.COPIES},
                     "equal": got == [hashlib.sha256(r).digest()
                                      for r in w]})
    launches = sha256_cuda.LAUNCHES["sha256"]
    for row, w in zip(rows, windows):
        row["raw_plus_offsets"] = row["bytes"] + 8 * (len(w) + 1)
        t0 = time.perf_counter()
        [hashlib.sha256(r).digest() for r in w]
        row["hashlib_ms"] = (time.perf_counter() - t0) * 1e3
        if row["expect_launch"]:
            row["steps"] = bd.steps(w, dev)
    out = {"phase": "digest", "window": window, "windows": rows,
           "first_call_ms": rows[0]["ms"],
           "later_calls_ms": bd.spread([r["ms"] for r in rows[1:]]),
           "launches": launches, "degraded": digests.DEGRADED,
           "crossover": bd.sweep(raws, windows[-1], dev, reps)}
    emit(out)
    problems = []
    if not all(r["equal"] for r in rows):
        problems.append("window digests differ from hashlib")
    if out["degraded"] or any(r["launches"] != int(r["expect_launch"])
                              for r in rows):
        problems.append("a window of at least the device threshold did "
                        "not take exactly one launch")
    for r in rows:
        if r["expect_launch"] and (
                r["h2d"] != 1 or r["d2h"] != 1
                or r["h2d_bytes"] != r["raw_plus_offsets"]
                or r["d2h_bytes"] != 32 * r["blocks"]):
            problems.append(f"window of {r['blocks']} blocks copied "
                            f"{r['h2d']} x {r['h2d_bytes']} bytes in, "
                            f"{r['d2h']} x {r['d2h_bytes']} out; expected "
                            f"1 x {r['raw_plus_offsets']} and "
                            f"1 x {32 * r['blocks']}")
    if len(rows[-1]["block_counts"]) < 2:
        problems.append("the mixed window has one block count")
    if problems:
        raise AssertionError("; ".join(problems))
    out["window_raws"] = (windows[0], windows[-1])
    return out


RATE_BATCHES = (100, 192, 256, 1024, 16384)


SHA_RATE_BATCHES = (192, 1024, 4096, 16384)


def phase_rate(torch, dev, sm_clock_mhz: float, smi: str) -> dict:
    """Verify-kernel time at RATE_BATCHES; host prepare time; the plain
    version's time at 1024. SHA-256 at Merkle-level shapes."""
    import numpy as np

    from tpubft_torch.crypto.cpu import Ed25519Signer
    from tpubft_torch.ops import ed25519 as ops
    from tpubft_torch.ops import ed25519_cuda as kc
    rng = np.random.default_rng(3)
    uniq = []
    for key in range(16):
        signer = Ed25519Signer.generate(seed=b"rate-%d" % key)
        msgs = [rng.integers(0, 256, 100, dtype=np.uint8).tobytes()
                for _ in range(256)]
        uniq += [(m, s, signer.public_bytes())
                 for m, s in zip(msgs, signer.sign_batch(msgs))]
    rows = []
    for b in RATE_BATCHES:
        items = (uniq * (b // len(uniq) + 1))[:b]
        t0 = time.perf_counter()
        prep = ops.prepare_batch(items)
        prep_ms = (time.perf_counter() - t0) * 1e3
        args = ops.to_tensors(ops._pad_rows(prep, b, b), dev)
        ok = bool((kc.verify(*args).cpu().numpy() & prep.host_valid).all())
        ms = cuda_ms(lambda: kc.verify(*args), 10 if b <= 1024 else 5)
        row = {"batch": b, "ms": ms, "sigs_per_s": b / ms * 1e3,
               "prepare_ms": prep_ms, "all_valid": ok,
               **verify_bound_ms(b, sm_clock_mhz)}
        if b == 1024:
            row["plain_ms"] = cuda_ms(lambda: ops.plain_verify_kernel(*args),
                                      1)
        rows.append(row)
    sha_rows = [sha256_rate_row(torch, dev, b, sm_clock_mhz)
                for b in SHA_RATE_BATCHES]
    out = {"phase": "rate", "card": smi,
           "clocks_sm_now": nvidia_smi("clocks.sm,power.draw"),
           "verify_critical_path_steps": kc.critical_path_steps(),
           "verify_field_ops": kc.function_ops_per_verify(),
           "verify_executed_field_ops": kc.field_ops_per_verify(),
           "rows": rows, "sha256_rows": sha_rows}
    emit(out)
    if not all(r["all_valid"] for r in rows):
        raise AssertionError("rate corpus did not verify")
    if not all(r["equal_hashlib"] for r in sha_rows):
        raise AssertionError("sha256 rate batch differs from hashlib")
    return out


def merkle_messages(b: int, seed: int = 5):
    """b Merkle inner-node messages (0x01 || left || right, 65 bytes:
    two SHA-256 blocks), the ledger's shape."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [b"\x01" + rng.bytes(64) for _ in range(b)]


def sha256_inputs(msgs, dev):
    """The kernel's inputs for a batch, staged as the host half stages
    them: (data, offsets) on the card and the host offsets."""
    from tpubft_torch.ops import sha256 as sha
    blob, offsets = sha.pack(msgs)
    return (*sha.to_device(blob, offsets, dev), offsets)


def sha256_rate_row(torch, dev, b: int, sm_clock_mhz: float) -> dict:
    """The SHA-256 kernel alone on b two-block messages (per call by CUDA
    events, as earlier rows were timed, and by a CUDA graph), the host
    pack and hashlib over the same messages; the plain version at
    B=1024."""
    import hashlib

    from tpubft_torch.ops import sha256 as sha
    from tpubft_torch.ops import sha256_cuda
    msgs = merkle_messages(b)
    t0 = time.perf_counter()
    sha.pack(msgs)
    prep_ms = (time.perf_counter() - t0) * 1e3
    data, offs, host = sha256_inputs(msgs, dev)
    t0 = time.perf_counter()
    want = [hashlib.sha256(m).digest() for m in msgs]
    hashlib_ms = (time.perf_counter() - t0) * 1e3
    raw = sha256_cuda.sha256_raw(data, offs, host).cpu().numpy().tobytes()

    def call():
        return sha256_cuda.sha256_raw(data, offs, host)
    lengths = [len(m) for m in msgs]
    row = {"batch": b, "blocks_per_msg": sha.blocks_needed(len(msgs[0])),
           "ms": cuda_ms(call, 50 if b <= 1024 else 20),
           "graph_ms": graph_ms(call, 20),
           "prepare_ms": prep_ms, "hashlib_ms": hashlib_ms,
           "equal_hashlib": [raw[i:i + 32] for i in range(0, len(raw), 32)]
           == want,
           **work_bound_ms(*sha256_cuda.work(lengths), sm_clock_mhz),
           "chain_floor_ms": sha256_cuda.chain_floor_ms(lengths,
                                                        sm_clock_mhz)}
    row["hashes_per_s"] = b / row["ms"] * 1e3
    if b == 1024:
        row["plain_ms"] = cuda_ms(lambda: sha.plain_sha256_raw(data, offs),
                                  1)
    return row


def phase_kernels(torch, dev, plane, kernel, ladder, ledger, digest,
                  sm_clock_mhz) -> dict:
    """Every kernel, timed at its path's shape: the verify kernel at one
    PrePrepare drain of 100 signatures, the ladder kernels at the ladder's
    1024 lanes, SHA-256 at one state-transfer window of 64 raw blocks."""
    import numpy as np

    from tpubft_torch import testing
    from tpubft_torch.ops import ed25519 as ops
    from tpubft_torch.ops import ed25519_cuda as kc
    b = plane["requests_per_pp"]
    items = testing.ed25519_corpus(b, seed=11)
    prep = ops.prepare_batch(items)
    args = ops.to_tensors(ops._pad_rows(prep, b, b), dev)
    got = kc.verify(*args).cpu().numpy()
    plain = ops.plain_verify_kernel(*args).cpu().numpy()
    err = max(kernel["max_abs_err"],
              int(np.abs(got.astype(np.int64) - plain.astype(np.int64))
                  .max()))
    row = {"name": "ed25519_verify", "route": "cuda",
           "source": "tpubft_torch/ops/csrc/ed25519_verify.cu",
           "replaces": "tpubft/ops/ed25519_pallas.py:421",
           "launches": plane["launches"]["ed25519_verify"],
           "max_abs_err": err, "batch": b,
           "host_ms": cuda_ms(lambda: kc.verify(*args), 20),
           "ms": graph_ms(lambda: kc.verify(*args), 20),
           "plain_ms": cuda_ms(lambda: ops.plain_verify_kernel(*args), 1),
           "library_ms": None,
           "critical_path_steps": kc.critical_path_steps()["total"]}
    bound = verify_bound_ms(b, sm_clock_mhz)
    for k in ("bound_ms", "bound_by", "executed_ops", "ops"):
        row[k] = bound[k]
    rows = [row]
    for r in ladder["rungs"]:
        if r["kernel"] == "ed25519_verify":
            continue
        rows.append({"name": r["kernel"], "route": "cuda",
                     "source": LADDER_SOURCES[r["kernel"]],
                     "replaces": LADDER_REPLACES[r["kernel"]],
                     "launches": r["launches"],
                     "max_abs_err": r["max_abs_err"], "batch": r["lanes"],
                     "ms": r["ms"], "host_ms": r["host_ms"],
                     "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "path": "ladder"})
        if r["kernel"] == "fe_inv":
            big = ladder["fe_inv_large"]
            # the lanes its launch ran, and the cycles a step this run's
            # probe read for that design, with the chain floor they set
            rows[-1].update({
                k: r[k] for k in ("lanes_per_element", "step_cycles",
                                  "chain_floor_ms", "share_of_bound")})
            rows[-1]["large"] = {k: big[k] for k in (
                "lanes", "lanes_per_element", "ms", "host_ms", "bound_ms",
                "share_of_bound", "mismatches_vs_int",
                "mismatches_vs_plain")}
    rows.append(sha256_kernel_row(torch, dev, ledger, digest, sm_clock_mhz))
    out = {"kernels": rows}
    emit(out)
    bad = [r["name"] for r in rows if r["max_abs_err"]]
    if bad:
        raise AssertionError(f"kernels disagree with plain versions: {bad}")
    return out


LADDER_SOURCES = {
    "fe_mul": "tpubft_torch/ops/csrc/ed25519_verify.cu",
    "fe_inv": "tpubft_torch/ops/csrc/fe_inv.cu",
    "bringup_copy": "tpubft_torch/ops/csrc/bringup.cu",
    "fe_carry": "tpubft_torch/ops/csrc/bringup.cu",
    "fe_table_gather": "tpubft_torch/ops/csrc/bringup.cu"}
LADDER_REPLACES = {
    "bringup_copy": "tools/pallas_bringup.py:95",
    "fe_carry": "tools/pallas_bringup.py:99",
    "fe_mul": "tools/pallas_bringup.py:104",
    "fe_inv": "tools/pallas_bringup.py:109",
    "fe_table_gather": "tools/pallas_bringup.py:175"}


def sha256_kernel_row(torch, dev, ledger, digest, sm_clock_mhz) -> dict:
    """The SHA-256 kernel at config 1's launch shape, a state-transfer
    window of 64 raw ledger blocks, against its plain version there, on
    the mixed window and on a 1024-node Merkle level; launches are the
    digest phase's (the migrate-chunk ledger launched none), the stress
    ledger's beside them."""
    import hashlib

    from tpubft_torch.ops import sha256 as sha
    from tpubft_torch.ops import sha256_cuda
    first, mixed = digest["window_raws"]
    errs, inputs = {}, {}
    for name, msgs in (("mixed_window", mixed),
                       ("merkle_level_1024", merkle_messages(1024, seed=8)),
                       ("window", first)):
        data, offs, host = inputs[name] = sha256_inputs(msgs, dev)
        got = sha256_cuda.sha256_raw(data, offs, host)
        plain = sha.plain_sha256_raw(data, offs)
        errs[name] = int((got.int() - plain.int()).abs().max())
    t0 = time.perf_counter()
    for r in first:
        hashlib.sha256(r).digest()
    hashlib_ms = (time.perf_counter() - t0) * 1e3

    def call():
        return sha256_cuda.sha256_raw(data, offs, host)
    lengths = [len(r) for r in first]
    bound = work_bound_ms(*sha256_cuda.work(lengths), sm_clock_mhz)
    return {"name": "sha256", "route": "cuda",
            "source": "tpubft_torch/ops/csrc/sha256.cu",
            "replaces": "tpubft/ops/sha256.py:82 (and :178)",
            "launches": digest["launches"]
            + ledger["migrate_chunks"]["sha256_launches"],
            "stress_launches": ledger["stress"]["sha256_launches"],
            "max_abs_err": max(errs.values()), "max_abs_err_by_input": errs,
            "batch": len(first),
            "compressions": int(sum(sha.blocks_needed(n) for n in lengths)),
            "host_ms": cuda_ms(call, 50),
            "ms": graph_ms(call, 50),
            "mixed_window_ms": graph_ms(
                lambda: sha256_cuda.sha256_raw(*inputs["mixed_window"]), 20),
            "mixed_window_chain_floor_ms": sha256_cuda.chain_floor_ms(
                [len(r) for r in mixed], sm_clock_mhz),
            "plain_ms": cuda_ms(lambda: sha.plain_sha256_raw(data, offs), 1),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "ops": bound["ops"], "bytes": bound["bytes"],
            "chain_floor_ms": sha256_cuda.chain_floor_ms(lengths,
                                                         sm_clock_mhz),
            "round_cycles": sha256_cuda.ROUND_CYCLES,
            "library_ms": None,
            "hashlib_host_ms": hashlib_ms,
            "path": "state-transfer digests"}


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "tpubft_torch")):
        return fail("the tpubft_torch package is not beside chip_smoke.py")
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: no card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    info = phase_device(torch)
    clock = info["clocks_max_sm_mhz"]
    ladder = phase_ladder(torch, dev, clock)
    kernel = phase_kernel(torch, dev)
    plane = phase_plane(torch, dev)
    ledger = phase_ledger(torch, dev)
    digest = phase_digest(torch, dev, ledger.pop("raws"))
    phase_rate(torch, dev, clock, info["nvidia_smi"])
    phase_kernels(torch, dev, plane, kernel, ladder, ledger, digest, clock)
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # noqa: BLE001 — any phase failing fails the run
        import traceback
        traceback.print_exc()
        sys.exit(fail(f"{type(exc).__name__}: {exc}"))
