#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpubft_torch) on one NVIDIA card.

    python3 chip_smoke.py

builds the CUDA kernels from the sources in the checkout on first use and
runs these phases in order, one JSON line each; any failure exits non-zero:

  device   the card's name, power limit and SM clock;
  ladder   the kernel's own fe_mul / fe_inv on 4096 random field elements
           against Python-int arithmetic mod p and the plain PyTorch field;
  kernel   the CUDA verify kernel against the plain PyTorch verify on the
           card at B=1024 (the strict-verify corpus plus zero padding
           lanes), exactly, and against the host scalar verdicts;
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
  rate     the kernel alone (CUDA events, after warm-up) at B = 256, 1024
           and 16384, the host prepare_batch time at the same B and the
           plain version's time at B=1024;
  kernels  every kernel of the main path with its launches in the plane
           run, its match against the plain version, its time, its bound
           and the plain version's time.

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


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn() over `iters` launches, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def verify_bound_ms(batch: int, sm_clock_mhz: float) -> dict:
    """Least time the card could take for `batch` verifies: the larger of
    the integer multiply-adds over the INT32 rate and the bytes (each
    input read once, the verdict written once) over the HBM rate."""
    from tpubft_torch.ops import ed25519_cuda as kc
    imad = kc.imad_per_verify()
    ops = batch * (2 * imad["imad_wide"] + imad["imad"])
    ops_ms = ops / (H100_SMS * INT32_IMAD_PER_SM_CLK * sm_clock_mhz * 1e6) \
        * 1e3
    nbytes = batch * ((2 * 64 + 2 * 24 + 2) * 4 + 1)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    if ops_ms >= bytes_ms:
        return {"bound_ms": ops_ms, "bound_by": "operations", "ops": ops,
                "bytes": nbytes}
    return {"bound_ms": bytes_ms, "bound_by": "bytes", "ops": ops,
            "bytes": nbytes}


# ---------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------

def phase_device(torch) -> dict:
    smi = nvidia_smi("name,power.limit")
    clk = nvidia_smi("clocks.max.sm").split()[0]
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "clocks_max_sm_mhz": float(clk),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_ladder(torch, dev) -> dict:
    """Bring-up rungs 2-3: fe_mul and fe_inv kernels vs Python ints."""
    import numpy as np

    from tpubft_torch.ops import _build
    from tpubft_torch.ops import ed25519_cuda as kc
    from tpubft_torch.ops import f25519 as F
    t0 = time.monotonic()
    kc.library()
    build_s = time.monotonic() - t0
    n = 4096
    rng = np.random.default_rng(2026)
    va = [int.from_bytes(rng.bytes(32), "little") % F.P for _ in range(n)]
    vb = [int.from_bytes(rng.bytes(32), "little") % F.P for _ in range(n)]
    va[:4] = [0, 1, F.P - 1, F.P - 2]
    vb[:4] = [F.P - 1, F.P - 1, F.P - 1, 2**255 - 20]
    la = np.stack([F.int_to_limbs(v) for v in va], 1)
    lb = np.stack([F.int_to_limbs(v) for v in vb], 1)
    ta = torch.from_numpy(la).to(dev)
    tb = torch.from_numpy(lb).to(dev)
    got_mul = kc.fe_mul(ta, tb).cpu().numpy()
    got_inv = kc.fe_inv(ta).cpu().numpy()
    want_mul = np.stack([F.int_to_limbs(a * b) for a, b in zip(va, vb)], 1)
    want_inv = np.stack([F.int_to_limbs(pow(a, F.P - 2, F.P))
                         for a in va], 1)
    plain_mul = F.canonical(F.mul(ta, tb)).cpu().numpy()
    plain_inv = F.canonical(F.inv(ta)).cpu().numpy()
    out = {"phase": "ladder", "n": n, "build_s": build_s,
           "ptxas": _build.ptxas_report.get("ed25519_verify", ""),
           "kernels": []}
    for name, got, want, plain, fn, pfn in (
            ("fe_mul", got_mul, want_mul, plain_mul,
             lambda: kc.fe_mul(ta, tb),
             lambda: F.canonical(F.mul(ta, tb))),
            ("fe_inv", got_inv, want_inv, plain_inv,
             lambda: kc.fe_inv(ta), lambda: F.canonical(F.inv(ta)))):
        out["kernels"].append({
            "name": name, "route": "cuda",
            "source": "tpubft_torch/ops/csrc/ed25519_verify.cu",
            "replaces": "tools/pallas_bringup.py:80",
            "mismatches_vs_int": int((got != want).any(axis=0).sum()),
            "mismatches_vs_plain": int((got != plain).any(axis=0).sum()),
            "max_abs_err": int(np.abs(got.astype(np.int64)
                                      - plain.astype(np.int64)).max()),
            "ms": cuda_ms(fn, 20), "plain_ms": cuda_ms(pfn, 1)})
    emit(out)
    for k in out["kernels"]:
        if k["mismatches_vs_int"] or k["mismatches_vs_plain"]:
            raise AssertionError(f"ladder {k['name']} mismatches: {k}")
    return out


def phase_kernel(torch, dev) -> dict:
    """The CUDA verify vs the plain PyTorch verify on the card, B=1024."""
    import numpy as np

    from tpubft_torch import testing
    from tpubft_torch.crypto import scalar
    from tpubft_torch.ops import ed25519 as ops
    from tpubft_torch.ops import ed25519_cuda as kc
    b, n = 1024, 1024 - 64                     # 64 zero padding lanes
    items = testing.ed25519_corpus(n, seed=7)
    prep = ops.prepare_batch(items)
    args = ops.to_tensors(ops._pad_rows(prep, n, b), dev)
    got = kc.verify(*args).cpu().numpy()
    plain = ops.plain_verify_kernel(*args).cpu().numpy()
    host = np.array([scalar.ed25519_verify(pk, m, s) for m, s, pk in items])
    final = got[:n] & prep.host_valid
    out = {"phase": "kernel", "batch": b, "items": n,
           "raw_mismatches": int((got != plain).sum()),
           "max_abs_err": int(np.abs(got.astype(np.int64)
                                     - plain.astype(np.int64)).max()),
           "host_mismatches": int((final != host).sum()),
           "valid": int(host.sum()),
           "kernel_accepts_host_rejected": int((got[:n]
                                                & ~prep.host_valid).sum())}
    emit(out)
    if out["raw_mismatches"] or out["host_mismatches"]:
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


def phase_rate(torch, dev, sm_clock_mhz: float, smi: str) -> dict:
    """Kernel time at B = 256, 1024, 16384; host prepare time; the plain
    version's time at 1024."""
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
    for b in (256, 1024, 16384):
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
    out = {"phase": "rate", "card": smi,
           "clocks_sm_now": nvidia_smi("clocks.sm,power.draw"),
           "rows": rows}
    emit(out)
    if not all(r["all_valid"] for r in rows):
        raise AssertionError("rate corpus did not verify")
    return out


def phase_kernels(torch, dev, plane, kernel, sm_clock_mhz) -> dict:
    """Every kernel of the main path, timed at the main path's shape (one
    PrePrepare drain of 100 signatures)."""
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
           "ms": cuda_ms(lambda: kc.verify(*args), 20),
           "plain_ms": cuda_ms(lambda: ops.plain_verify_kernel(*args), 1),
           "library_ms": None}
    bound = verify_bound_ms(b, sm_clock_mhz)
    row["bound_ms"] = bound["bound_ms"]
    row["bound_by"] = bound["bound_by"]
    out = {"kernels": [row]}
    emit(out)
    if err:
        raise AssertionError(f"kernel disagrees with plain version: {row}")
    return out


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "tpubft_torch")):
        return fail("the tpubft_torch package is not beside chip_smoke.py")
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: no card")
    sys.path.insert(0, HERE)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    info = phase_device(torch)
    clock = info["clocks_max_sm_mhz"]
    phase_ladder(torch, dev)
    kernel = phase_kernel(torch, dev)
    plane = phase_plane(torch, dev)
    phase_rate(torch, dev, clock, info["nvidia_smi"])
    phase_kernels(torch, dev, plane, kernel, clock)
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
