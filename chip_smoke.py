#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpubft_torch) on one NVIDIA card.

    python3 chip_smoke.py           # every phase, on one card
    python3 chip_smoke.py --mesh    # the device and mesh phases alone

builds the CUDA kernels from the sources in the checkout (one nvcc per
source, all started together) and runs these phases in order, one JSON
line each; any failure exits non-zero:

  device   the card's name, power limit and SM clock, the builds (the
           native BLS engine, netio and kvlog with g++ among them), each BLS kernel's
           registers, stack and spill from ptxas (`bls_msm_ptxas`), and
           from
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
  replica  config 1's own main path: a four-replica in-process cluster
           (testing.InProcessCluster, the counter app) on the card at
           BASELINE config 1's widths, 100 client principals and the
           reference's batching defaults, crypto_backend "cuda"; the
           durability pipeline is off (kept as in the earlier runs); the
           autotuner runs at its default (a poll a second). 100 clients
           send counter writes in a closed loop, one outstanding each,
           until 3,000 have committed,
           within 120 s. Every reply decodes and each client's replies
           increase, the four counters equal the sum of the adds and
           last_executed agrees, the verify kernel was launched on the
           path (launches reset just before the load, read just after),
           nothing degraded and the breaker saw no failure. Printed:
           client commit latency p50/p90/p99, requests per second,
           PrePrepares and requests per PrePrepare, verify launches and
           signatures per launch, the certificate path's launches, and
           the phase's wall time;
  ledger_replica
           config 1 as users deploy it: four replicas of
           testing.InProcessCluster with the SKVBC app over the
           categorized ledger (KeyValueBlockchain on a MemoryDB, device
           hashing), FilePersistentStorage WALs in a temporary
           directory, the durability pipeline on at the reference's
           defaults, state transfer configured as KvbcReplica deploys
           it (from the replica's config: ranges of 64 blocks, 4 in
           flight, a 1 s retry timeout), crypto_backend "cuda", the
           autotuner at its default, 100 client principals, the
           reference's checkpoint and work windows (150 and 300). Load:
           100 closed-loop SkvbcClients write kvbcbench blocks (the nine
           keys of testing.kvbcbench_rows, under each client's key
           prefix, one ledger block a write) until 2,000 writes commit;
           printed: requests/s, commit latency p50/p90/p99, durability
           groups, fsyncs and runs a group, verify launches (counts
           reset just before each stage's load, read just after).
           Read-back: 120 acknowledged keys through SkvbcClient.read
           with the client's reply quorum, each equal to its last
           acknowledged value. Catch-up: replica 3 is down for a second
           load until the cluster's stable checkpoint reaches the work
           window of a replica with empty state; it restarts with an
           empty ledger and a fresh WAL while the load goes on, and must
           fetch at least 256 blocks by state transfer; printed: blocks
           fetched, windows, the window-digest call's ms and the range
           spans' fetch-to-verified ms, SHA-256 launches, failed device
           digest calls, digests.DEGRADED. Fails unless every
           device-sized window took one SHA-256 launch with no host
           fallback allowed, no device digest call failed, a full
           64-block window was digested (kept for the kernels line), and
           replica 3's head block digest equals replica 0's;
  process_cluster
           config 1 as BASELINE.md runs it, one OS process a replica
           over UDP: this process builds every library once (netio with
           g++ among them; the build seconds printed), then
           testing.BftTestNetwork starts four `python -m
           tpubft_torch.apps.skvbc_replica` processes on the card (the
           SKVBC ledger in memory, ReplicaConfig's defaults but
           device_min_verify_batch 4, so that the primary's PrePrepare
           batches of about 5 requests reach the card; each process's
           start seconds printed), each serving the thin-replica read
           tier on its `--trs-port`. A ThinReplicaClient in a process
           of its own (python -m
           tpubft_torch.tools.trs_follow, f=1, replica 3's server first,
           so its first data source) subscribes from block 1 as 32
           closed-loop SkvbcClients write kvbcbench blocks until 1,000
           commit; 120 keys read back; the four last_executed equal;
           within 30 s the
           stream has delivered every block up to the cluster's last,
           each acknowledged write's keys and values at its block, none
           missing or twice. Replica 3 is SIGKILLed, 300 more writes
           commit and the load goes on until the stable checkpoint is
           past an empty replica's work window (the client's generation
           must rise: it rotated to another data source); replica 3
           restarts empty under the load until it has fetched 256 blocks
           by state transfer, then its last_executed must reach the
           others'. The stream is checked again to the last block and
           replica 0's server gives an anchor at or past the stable
           checkpoint under f+1 signed checkpoints; each process's
           `thinreplica` counters show pushed runs and no overflow.
           After these four stop, a second network of four starts for
           the read tier's proofs (its SKVBC state in the BLOCK_MERKLE
           category, 4 clients, checkpoint windows of 5: a cut printed
           under `reduced`, ROADMAP C.12); one-key writes go on until
           replica 0's anchor covers 21 of them; then 20 verified reads
           of acknowledged keys equal their last values, one historical
           read at an earlier block its value there, an absent key
           None; its proofs at least 21 in all, no overflow. The `trs`
           step's own waits and reads take at most 15 s (the proof
           network's start and stop are timed apart). From every
           process (its metrics and
           diagnostics servers): signatures dispatched to the device, no
           degraded verify, health healthy with every breaker closed,
           verify section calls, SHA-256 calls in the restarted one, no
           netio fallback, the wrappers' launches and the CUDA memory it
           holds. Printed: requests/s and commit latency p50/p90/p99
           beside the ledger_replica phase's, the catch-up seconds and
           blocks fetched, and under `trs` the blocks streamed, the
           steady delivery lag from acknowledgement p50/p99 and apart
           from it the rotation's gap (each beside its limit), the
           generations, the anchor block, the verified reads' round trip
           p50/p99 with the proof ledger's blocks, and the seconds;
  tls_cluster
           BASELINE config 5 as benchmarks/bench_e2e.py:87-90 and
           :248-300 run it: first, on this machine, the port's TLS
           material (comm/_der.py, no `cryptography`) without and with a
           password, two TlsTcpCommunication endpoints exchanging a
           message each way on each, and ssl.OPENSSL_VERSION; then four
           `skvbc_replica` processes from
           testing.BftTestNetwork(transport="tls") on the card, f=1,
           threshold-bls certificates, ecdsa-p256 clients, the
           view-change timeout at 3,000 ms, device_min_verify_batch 4 (as
           process_cluster), every other setting at ReplicaConfig()'s
           defaults. 16 closed-loop SkvbcClients write kvbcbench blocks
           for 60 s while a storm thread pauses the current primary
           (SIGSTOP, the largest view the replicas report, modulo 4)
           every 4 s for the timeout plus 1 s; then 60 acknowledged keys
           are read back and the four last_executed must agree. Fails
           unless every process reports a view of at least 3, writes
           committed in every storm cycle, P-256 RLC and Ed25519 verify
           launches (summed over the processes) above 0, health healthy
           with every breaker closed and no verify degraded. Printed:
           requests/s, commit latency p50/p90/p99, each storm cycle
           (view, primary, writes committed), each process's view and
           launches, each replica's last views entered (`status get
           views`: slots re-proposed, ms to the first execution), each
           step's seconds;
  persistent_cluster
           config 1 as BASELINE.md's process rows deploy it, on
           persistent ledgers: four `skvbc_replica` processes from
           testing.BftTestNetwork(db_dir=...) on the card over UDP, each
           with its own kvlog (the port's NativeDB over native/kvlog.cpp)
           in a temporary directory, ReplicaConfig()'s defaults but
           device_min_verify_batch 4 (as process_cluster), 16 closed-loop
           SkvbcClients. Prints the DB directory's filesystem type and
           4 KiB write + fsync probes there; 600 writes commit and 120
           acknowledged keys read back; replica 3 is SIGKILLed, the load
           goes on until the others' stable checkpoint is more than the
           work window past it, and it restarts on its own file under
           the load: its first metrics read must be its last_executed
           from before the kill, it catches up by state transfer (SHA-256
           section calls) fetching no block it kept, and the four agree;
           then all four are SIGKILLed at once and restarted on their
           files: each comes back at its last_executed, the sampled keys
           and every client's last write read back, 200 more writes
           commit; after stop_all every kvlog opens under the port's
           blockchain holding exactly the acknowledged writes, blocks
           equal raw bytes in the four files. Every process: signatures
           dispatched to the card, nothing degraded, healthy, no netio
           fallback. Beside the four, one read-only replica process
           (`apps.ro_replica --device cuda`, id 4) archives over SigV4 to
           the port's testing.S3TestServer: once replica 3 is down and
           the stable checkpoint is at 300 or past it, the RO has
           transferred and archived up to it (its full windows digested
           by the SHA-256 kernel, device_digest_batches > 0, host digests
           only for partial windows), answers one signed READ_ONLY read
           with the acknowledged value and ignores a forged one; after
           stop_all every archived object equals replica 0's raw block
           and digest. Printed beside process_cluster's in-memory rate:
           the load's rate and latency, each restart's seconds to up,
           the catch-up, the file sizes, the RO's anchor, blocks fetched
           and archived, archive wait and read round trip;
  v4_cluster
           config 1 on the v4 ledger engine (`skvbc_replica
           --kvbc-version v4`), as persistent_cluster runs it (four UDP
           processes on their kvlog files, 16 clients, the reference's
           windows 150 and 300, device_min_verify_batch 4): 600 writes
           and 120 keys read back; replica 3 SIGKILLed and left behind
           until the stable checkpoint is past the work window; the
           port's snapshot CLI (`tools.snapshot --kvbc-version v4`)
           creates a snapshot of its file, verifies it and restores it
           into a fresh file that takes the kvlog's place; replica 3
           restarts on it under load and fetches only the gap past the
           snapshot's head (SHA-256 section calls); after stop_all the
           four files open under the port's v4 engine with equal raw
           blocks and digests. Printed: the load's rate and latency
           beside persistent_cluster's, the snapshot's entries, bytes and
           the CLI's seconds a command, blocks fetched, catch-up
           seconds, each process's verify launches;
  bls_plane
           BLS certificates on the card: config 2's keys (n=7 f=2 c=0,
           threshold-bls, threshold 5) and 64 slots through
           consensus.collectors.CombineBatcher into
           CudaBlsThresholdVerifier.combine_batch (one flush of 320
           shares, past the default TPUBFT_MSM_CROSSOVER_K of 128: one
           bls_msm launch), two slots with a bad share; the same under
           multisig-bls (all-ones scalars); config 4's shape (n=1000,
           threshold 667): one CudaBlsThresholdAccumulator combine and
           one batch_scalar_mul of its 667 shares. Every certificate
           byte-equal to the native host engine's and verified; launch
           counts reset just before, read just after; fails if the
           native engine did not answer;
  bls_ledger_replica
           BASELINE config 2 as users deploy it: the ledger_replica
           phase's cluster at n=7, f=2 with threshold-bls certificates
           and crypto_backend "cuda"; 100 closed-loop clients until 1,000
           kvbcbench writes commit, 120 keys read back. Printed: commit
           latency, requests/s, certificate flushes and how many reached
           the MSM kernel at the default crossover, verify launches, the
           native engine's pairing checks and the calls and seconds of
           its pairing checks, MSMs and decompressions;
  ecdsa_plane
           ECDSA client signatures through the normal entry points:
           config 1's keys with its 100 client principals signing, a
           third each, with Ed25519, secp256k1 (config 3's client curve)
           and P-256 (config 5's); 8 PrePrepares of 100 requests (about
           3% forged) through BatchVerifier over
           SigManager(batch_fn=crypto.cuda.verify_batch_mixed) at the
           default ECDSA crossover (crypto/cuda.CARD_ECDSA_CROSSOVER).
           Every verdict equals the host scalar engines'; RLC launches
           and bisection launches per curve (reset just before, read
           just after), each curve's group launched, nothing
           degraded, no breaker failure; each PrePrepare's ms; each
           PrePrepare's ECDSA groups also through the per-item verify
           kernel (ops/ecdsa.verify_batch), equal to the host engines';
  ecdsa_ledger_replica
           BASELINE config 3 as benchmarks/bench_e2e.py:76-86 defines
           it: 31 replicas (f=10) of the ledger_replica phase's cluster,
           threshold-bls certificates, secp256k1 clients, the view-change
           timer at 30 s, the fast-path timeout at 5 s, concurrency 1,
           crypto_backend "cuda", the autotuner and every other setting
           at its default (device_min_verify_batch 32
           gates the Ed25519 items; the ECDSA groups ride the RLC kernel
           from crypto/cuda.ecdsa_crossover's lanes on).
           16 closed-loop clients write kvbcbench blocks until 300 commit
           or 150 s pass (then the writes are cut, never the replicas,
           and the cut printed), then 60 acknowledged keys are read back.
           Printed: commit latency p50/p90/p99, requests/s, PrePrepares,
           RLC launches and lanes a launch, the SigManagers'
           ecdsa_batched_host and degraded counts, certificate flushes,
           the phase's wall time. Fails unless the RLC kernel was
           launched, every key reads back its last acknowledged value,
           the 31 ledgers agree at their common head and nothing
           degraded;
  offload  the verified offload tier: two helper processes on
           127.0.0.1 (python -m tpubft_torch.offload.helper), one honest
           and one liar (wrong-on-curve), the pool configured as a
           replica configures it from offload_helpers. The bls_plane's
           64-slot threshold flush (320 shares) and multisig flush, clean,
           with offload off, honest and lying: equal certificates (and
           equal to the host classes'), the honest leases verified with
           no MSM launch, the liar costing one local re-run (one bls_msm
           launch), quarantined and shown in the health payload's
           offload section; the flush with two bad slots, off and honest:
           equal, one re-run, nobody quarantined. The ecdsa_plane's 8
           PrePrepares through SigManager, off, honest and lying: equal
           verdicts, RLC launches per curve on each route (honest: one
           re-fold a curve group, no bisection), lease and soundness
           microseconds. The helpers are stopped, and gone, at the end;
  mesh     the mesh tier (parallel/sharding.py): (a) on this card's
           default inventory one slot, no mesh, no device.chip* breaker,
           and the routed verify, digest, MSM and RLC equal to the
           single-device route in bytes and launches; (b) 4 virtual
           slots on the card (sharding.set_virtual_devices): verify 256
           (every 5th forged), sha256_batch 256 and sha256_batch_mixed
           256 of mixed sizes, config 4's 1000-point msm, msm_batch at
           S=64 K=16 and rlc_verify_batch of 128 secp256k1 and 128 P-256
           items (3% forged), each against the one-slot route and the
           host engines, the verify and digest routes against their
           plain versions on the card, the MSM kernel against its plain
           version on slot 0's shard of each MSM route, with launches a
           kernel (one a slot), the bls_msm_combine launches, the
           `.shard` profile rows and each route's ms on the 4 slots of
           ONE card (no multi-card time) beside the one-slot route's;
           bls_msm_combine against its plain version and timed; (c)
           slot 2 faulted in a flood of verifies and RLC flushes: only
           slot 2 evicted, exact verdicts, the device breaker closed,
           the health payload's mesh.evicted [2], then readmitted after
           its cooldown; (d) config 1's counter cluster (the replica
           phase) on the 4 slots until 1,000 writes commit, with
           crypto_shard_count registered and mesh_sharded_verifies on
           every replica; (e) graft_entry.dryrun_multichip(4); and the
           liveness probe's device time, read-back time and bound;
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
           two in-process clusters and the replica processes of configs
           1 and 5 and of config 1 on persistent ledgers, the ladder,
           the ledger replica's and the restarted replica process's
           catch-ups and the state-transfer digests; the verify and
           SHA-256 rows split them by path), its match against the plain
           version, its device time (`ms`, a CUDA graph) and host enqueue
           time (`host_ms`), its bound and the plain version's time;
           SHA-256 timed on a 64-block window that the ledger replica's
           catch-up digested, also with its chain floor, and matched
           against its plain version there, on the digest phase's two
           windows and on a 1024-node Merkle level; bls_msm at config 2's
           flush (S=64, K=5) and config 4's combine (S=1, K=667) and
           bls_mul at 667 lanes, each against its plain version and the
           native engine, with the host half's time and the native host
           Pippenger's as a yardstick, the kernel's own multiplies and
           its chain floor (the steps of its longest chain at the cycles
           of this run's clock64 probe, tools/bls_msm_probe.py) beside
           the bound; ecdsa_rlc for secp256k1 at the config-3 cluster's
           median lanes a launch and at B = 128, for P-256 at B = 128,
           and ecdsa_verify for both curves at B = 128
           (tools/ecdsa_probe.measure: a seeded corpus with a forged item
           and two crafted wrap-case lanes), each against its plain
           version on the card (the fold's value word for word, verdicts
           and x), with the field products the function needs and the
           kernel's own beside the bound, its chain floor (its longest
           chain at the cycles of this run's clock64 probe,
           ops/ecdsa_cuda.probe), and the host engine's time on the same
           items (scalar.ecdsa_verify_batch) as the yardstick that
           decides the crossover; bls_msm_combine at the mesh
           phase's S=64 D=4 partials (config 4's S=1 D=4 beside it),
           its launches the mesh phase's sharded MSM routes;
  timing   each phase's wall seconds;
  done     the script's wall time from the first phase on.

Every phase runs under a ceiling (PHASE_CEILING_S: three times its
seconds in a recorded run, at least 90 s) and the whole run under
RUN_CEILING_S (1,140 s): past one, the Watchdog prints the phase, its
seconds and its ceiling, dumps every thread's stack and the replica
processes' log tails, kills the processes the run started and exits 1.
A phase run below its full depth prints what it cut under `reduced`.

Every cluster phase runs the autotuner at its default (a poll a second)
and prints its report (tuner_report): polls, decisions, replica 0's knob
values, the knobs that moved and where, the last five decisions (knob,
old, new, source) and where the process-wide ECDSA crossover ended; the
crossover override is cleared after each cluster. The bls_msm and
ecdsa_rlc rows of the kernels line count the offload phase's launches as
a path of their own.

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
            # each BLS kernel's and point formula's registers, stack and
            # spill, as ptxas reported them
            "bls_msm_ptxas": _build.ptxas_functions(
                _build.ptxas_report.get("bls12_381_msm", "")),
            "ecdsa_ptxas": _build.ptxas_functions(
                _build.ptxas_report.get("ecdsa", "")),
            "sha256_sass_loop": dict(loop.most_common()),
            "sha256_sass_loop_int32": sha256_cuda.int32_ops(loop),
            "sha256_ops_per_compression": sha256_cuda.OPS_PER_COMPRESSION,
            "sha256_round_cycles": sha256_cuda.ROUND_CYCLES}
    emit(info)
    return info


def build_all() -> dict:
    """Build every kernel library at once, one nvcc per source in its own
    thread, and the host libraries with g++; -> {library: seconds}. A
    failed build raises."""
    from tpubft_torch.crypto import bls_native
    from tpubft_torch.ops import (_build, bls12_381_cuda, bringup_cuda,
                                  ecdsa_cuda, ed25519_cuda, sha256_cuda)

    def native():
        # the host BLS engine, g++ into ops/_build/; the pure-Python
        # fallback is not enough for this run
        if not bls_native.available():
            raise RuntimeError("the native BLS12-381 engine did not load: "
                               f"{bls_native.load_error}")
    return _build.build_parallel({
        "ed25519_verify": ed25519_cuda.library,
        "sha256": sha256_cuda.library, "bringup": bringup_cuda.library,
        "fe_inv": bringup_cuda.fe_inv_library,
        "bls12_381_msm": bls12_381_cuda.library,
        "ecdsa": ecdsa_cuda.library, "bls12381_native": native,
        # the UDP transport's sendmmsg/recvmmsg library and the storage
        # engine that --db-dir opens, g++
        "netio": lambda: _build.load_host("netio"),
        "kvlog": lambda: _build.load_host("kvlog")})


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
    from tpubft_torch.ops import (bls12_381_cuda, bringup_cuda, ecdsa,
                                  ecdsa_cuda, ed25519_cuda, sha256_cuda)
    for mod in (bringup_cuda, ed25519_cuda, sha256_cuda, bls12_381_cuda,
                ecdsa_cuda):
        mod.reset_launches()
    ecdsa.reset_counts()


def all_launches() -> dict:
    from tpubft_torch.ops import (bls12_381_cuda, bringup_cuda, ecdsa_cuda,
                                  ed25519_cuda, sha256_cuda)
    return {**ed25519_cuda.LAUNCHES, **bringup_cuda.LAUNCHES,
            **sha256_cuda.LAUNCHES, **bls12_381_cuda.LAUNCHES,
            **ecdsa_cuda.LAUNCHES}


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


REPLICA_CONFIG = dict(
    # BASELINE config 1's widths; the batching values are the reference's
    # defaults, written out so the phase prints what it ran
    threshold_scheme="adaptive", replica_sig_scheme="ed25519",
    client_sig_scheme="ed25519", max_num_of_requests_in_batch=100,
    batch_flush_period_ms=7, verify_batch_size=256,
    verify_batch_flush_us=200, device_min_verify_batch=32,
    work_window_size=300, crypto_backend="cuda",
    # the counter phase keeps the durability pipeline off, so that its
    # numbers stay comparable with the earlier runs PERF.md keeps (the
    # ledger_replica phase runs it); the autotuner runs at its default
    durability_pipeline=False)


def percentile(sorted_ms, q: float) -> float:
    return sorted_ms[min(len(sorted_ms) - 1,
                         int(round(q * (len(sorted_ms) - 1))))]


def _reduced(fn, **run) -> dict:
    """The arguments of phase `fn` that this run sets apart from their
    defaults, the phase's full depth: {name: {"default": d, "run": v}};
    each phase prints it under `reduced`."""
    import inspect
    params = inspect.signature(fn).parameters
    return {k: {"default": params[k].default, "run": v}
            for k, v in run.items() if v != params[k].default}


class _ClosedLoop:
    """`n` clients in a closed loop, one write outstanding each, until
    `until(commits)` holds or `budget_s` has passed. `write(idx)` sends
    client idx's next write and returns once it has committed (it raises
    if the write failed). Records each commit's latency."""

    def __init__(self, n: int, write):
        self.n = n
        self.write = write
        self.errors = []

    def run(self, until, budget_s: float) -> dict:
        import threading
        lock = threading.Lock()
        lat_ms = []
        stop = threading.Event()

        def drive(idx: int) -> None:
            try:
                while not stop.is_set():
                    t0 = time.perf_counter()
                    self.write(idx)
                    ms = (time.perf_counter() - t0) * 1e3
                    with lock:
                        lat_ms.append(ms)
                        if until(len(lat_ms)):
                            stop.set()
            except Exception as exc:  # noqa: BLE001 — reported by caller
                self.errors.append(f"client {idx}: "
                                   f"{type(exc).__name__}: {exc}")
                stop.set()

        t0 = time.monotonic()
        threads = [threading.Thread(target=drive, args=(i,), daemon=True)
                   for i in range(self.n)]
        for t in threads:
            t.start()
        deadline = t0 + budget_s
        while not stop.is_set() and time.monotonic() < deadline:
            stop.wait(0.05)
            with lock:
                if until(len(lat_ms)):
                    stop.set()
        stop.set()
        for t in threads:
            t.join(max(1.0, deadline + 30 - time.monotonic()))
        load_s = time.monotonic() - t0
        lat = sorted(lat_ms)
        return {"committed": len(lat), "load_s": load_s,
                "requests_per_s": len(lat) / load_s,
                "commit_latency_ms": {
                    "p50": percentile(lat, 0.50),
                    "p90": percentile(lat, 0.90),
                    "p99": percentile(lat, 0.99), "max": lat[-1]}
                if lat else None,
                "budget_s": budget_s,
                "timed_out": not until(len(lat))}


class _SigManagerCount:
    """Counts SigManager's device batches: while open,
    crypto.cuda.verify_batch_mixed is wrapped, and a replica built then
    keeps the wrapper for its life (it takes the function when it is
    built). Verify launches outside these calls are the certificate
    path's (the multisig verifier). The count attributes launches only."""

    def __enter__(self):
        from tpubft_torch.crypto import cuda as crypto_cuda
        self._mod = crypto_cuda
        self._real = real = crypto_cuda.verify_batch_mixed
        self.calls = 0

        def counted(items):
            self.calls += 1
            return real(items)
        crypto_cuda.verify_batch_mixed = counted
        return self

    def __exit__(self, *exc) -> None:
        self._mod.verify_batch_mixed = self._real


def device_health(reps, br0: dict) -> dict:
    """What the replicas' verifiers answered on the host instead of the
    card, and the device breaker against its snapshot `br0`."""
    from tpubft_torch.ops.dispatch import device_breaker
    br1 = device_breaker().snapshot()
    return {"sig_degraded": [r.sig.degraded_verifies.value for r in reps],
            # batches under device_min_verify_batch verify on the host by
            # design (the reference's rule); runtime fallbacks are
            # `degraded`
            "host_small_batch_verifies": [r.sig.scalar_fallbacks.value
                                          for r in reps],
            "multisig_degraded": [getattr(v, "degraded", 0)
                                  for r in reps for v in (
                                      r.slow_verifier, r.thr_verifier,
                                      r.opt_verifier)],
            "breaker": br1["state"],
            "breaker_failures": br1["failures"] - br0["failures"],
            "breaker_fast_fails": br1["fast_fails"] - br0["fast_fails"]}


def tuner_report(reps, last: int = 5, clear: bool = True) -> dict:
    """The replicas' autotuners after a load: polls and decisions summed
    over the replicas, replica 0's final knob values, which knobs moved
    on any replica (with each replica's final value), the last `last`
    decisions of the cluster (knob, old, new, source), and where the
    process-wide ECDSA crossover ended (every replica's
    `ecdsa_crossover_b` knob writes it; the last write wins). The
    crossover override is then cleared (unless `clear` is false), so
    that later phases start from the default again, as a fresh process
    would."""
    from tpubft_torch.crypto import cuda as crypto_cuda
    tuners = [r.tuning for r in reps]
    if not reps[0].cfg.autotune_enabled:
        # turned off by the caller (tools/tuner_ab.py's other arm)
        return {"replicas_tuned": 0, "enabled": False}
    if any(t is None for t in tuners):
        raise AssertionError("a replica was built without its tuner")
    snaps = [t.registry.snapshot() for t in tuners]
    moved = sorted({n for s in snaps for n, k in s.items() if k["changes"]})
    decisions = sorted(((d["ts"], r.id, d) for r in reps
                        for d in r.tuning.decisions(limit=256)),
                       key=lambda x: (x[0], x[1]))
    out = {"interval_ms": reps[0].cfg.autotune_interval_ms,
           "cooldown_ms": reps[0].cfg.autotune_cooldown_ms,
           "replicas_tuned": len(tuners),
           "polls": sum(t.m_polls.value for t in tuners),
           "decisions": sum(t.m_steps.value for t in tuners),
           "degraded_resets": sum(t.m_resets.value for t in tuners),
           "knobs_r0": {n: k["value"] for n, k in snaps[0].items()},
           "knobs_moved": {n: [s[n]["value"] for s in snaps if n in s]
                           for n in moved},
           "last_decisions": [
               {"rid": rid, "knob": d["knob"], "old": d["old"],
                "new": d["new"], "source": d["source"]}
               for _ts, rid, d in decisions[-last:]],
           "ecdsa_crossover_end": crypto_cuda.ecdsa_crossover()}
    if clear:
        crypto_cuda.set_ecdsa_crossover(None)
    return out


def tuner_problems(t: dict) -> list:
    if t["replicas_tuned"] and t["polls"] < t["replicas_tuned"]:
        return [f"the tuners polled {t['polls']} times over "
                f"{t['replicas_tuned']} replicas"]
    return []


def device_health_problems(h: dict) -> list:
    problems = []
    if any(h["sig_degraded"]) or any(h["multisig_degraded"]):
        problems.append("a verify degraded or fell back to the host")
    if h["breaker_failures"] or h["breaker_fast_fails"] \
            or h["breaker"] != "closed":
        problems.append(f"device breaker {h['breaker']}, "
                        f"{h['breaker_failures']} failures")
    return problems


def phase_replica(torch, dev, clients: int = 100, target: int = 3000,
                  budget_s: float = 120.0, label: str = "replica") -> dict:
    """Config 1's own entry points: a four-replica in-process cluster
    (testing.InProcessCluster over the loopback bus) with the counter
    app, driven by `clients` BftClients in a closed loop (one write
    outstanding each) until `target` requests have committed. Every
    reply is checked, the four replicas must agree, and the verify
    kernel must have carried the path with nothing degraded. `label`
    names the phase in the lines it prints (the mesh phase runs it on
    four slots)."""
    import numpy as np

    from tpubft_torch.apps import counter
    from tpubft_torch.ops import ed25519_cuda as kc
    from tpubft_torch.ops.dispatch import device_breaker
    from tpubft_torch.testing import InProcessCluster
    from tpubft_torch.utils import flight

    cfg = dict(REPLICA_CONFIG)
    t_phase = time.monotonic()
    with _SigManagerCount() as sig:
        cluster = InProcessCluster(f=1, c=0, num_clients=clients,
                                   seed=b"chip-smoke-replica",
                                   cfg_overrides=cfg)
    rep0 = cluster.replicas[0]
    assert rep0.keys.threshold_scheme == "multisig-ed25519", \
        rep0.keys.threshold_scheme
    reduced = _reduced(phase_replica, target=target)
    emit({"phase": label, "step": "config", "n": cluster.n, "f": 1,
          "c": 0, "clients": clients, "target_requests": target,
          "budget_s": budget_s, "reduced": reduced,
          "scheme": rep0.keys.threshold_scheme, "config": cfg,
          "durability_pipeline": rep0.cfg.durability_pipeline,
          "autotune_enabled": rep0.cfg.autotune_enabled,
          "crypto_backend": rep0.crypto_backend})
    rng = np.random.default_rng(3)
    deltas = rng.integers(1, 10, size=(clients, 4 * target // clients + 64))
    per_client = {i: [] for i in range(clients)}
    bft_clients = []

    def write(idx: int) -> None:
        got = per_client[idx]
        delta = int(deltas[idx][len(got)])
        raw = bft_clients[idx].send_write(counter.encode_add(delta),
                                          timeout_ms=int(budget_s * 1000))
        got.append((delta, counter.decode_reply(raw)))

    breaker = device_breaker()
    loop = _ClosedLoop(clients, write)
    try:
        cluster.start()
        bft_clients += [cluster.client(i) for i in range(clients)]
        for c in bft_clients:
            c.start()
        breaker.reset()
        br0 = breaker.snapshot()
        flight.kernel_profiler().reset()
        sig.calls = 0
        kc.reset_launches()
        load = loop.run(lambda n: n >= target, budget_s)
        launches = kc.LAUNCHES["ed25519_verify"]
        sig_launches = sig.calls
        profiles = flight.kernel_profiler().snapshot()
        profile = profiles.get("ed25519") or {}
        shard_profile = profiles.get("ed25519.shard")
        reps = list(cluster.replicas.values())
        sharded = [r.sig.mesh_sharded_verifies.value for r in reps]
        health = device_health(reps, br0)
        # every committed write executes on all four replicas
        done = sum(len(v) for v in per_client.values())
        settle = time.monotonic() + 30
        while time.monotonic() < settle and not (
                len({r.last_executed for r in reps}) == 1
                and all(h.value == cluster.handlers[0].value
                        for h in cluster.handlers.values())):
            time.sleep(0.05)
        adds = sum(d for v in per_client.values() for d, _ in v)
        monotone = all(all(b[1] > a[1] for a, b in zip(v, v[1:]))
                       for v in per_client.values())
        values = [cluster.handlers[r].value for r in range(cluster.n)]
        last_exec = [r.last_executed for r in reps]
        primary = cluster.metric(0, "counters", "sent_preprepares")
        executed = cluster.metric(0, "counters", "executed_requests")
        slow_commits = sum(cluster.metric(r, "counters", "slow_path_commits")
                           for r in range(cluster.n))
        fast_commits = sum(cluster.metric(r, "counters", "fast_path_commits")
                           for r in range(cluster.n))
        tuner = tuner_report(reps)
    finally:
        cluster.stop()
    out = {"phase": label, "committed": done, "reduced": reduced,
           "load_s": load["load_s"], "requests_per_s": done / load["load_s"],
           "commit_latency_ms": load["commit_latency_ms"],
           "preprepares": primary, "executed_requests": executed,
           "requests_per_preprepare": executed / primary if primary else 0,
           "slow_path_commits": slow_commits,
           "fast_path_commits": fast_commits,
           "verify_launches": launches,
           "sigmanager_launches": sig_launches,
           "certificate_launches": launches - sig_launches,
           "signatures_per_launch": profile.get("batch_avg"),
           "profile": profile, "shard_profile": shard_profile,
           "mesh_sharded_verifies": sharded,
           "counter_values": values, "sum_of_adds": adds,
           "last_executed": last_exec, "replies_increase": monotone,
           **health, "tuner": tuner,
           "errors": loop.errors[:5],
           "wall_s": time.monotonic() - t_phase}
    emit(out)
    problems = tuner_problems(tuner)
    if loop.errors:
        problems.append(f"{len(loop.errors)} clients failed: "
                        f"{loop.errors[:3]}")
    if done < target:
        problems.append(f"{done} of {target} requests committed in "
                        f"{budget_s} s")
    if not monotone:
        problems.append("a client's replies did not increase")
    if values != [adds] * cluster.n:
        problems.append(f"counters {values} != the sum of adds {adds}")
    if len(set(last_exec)) != 1:
        problems.append(f"last_executed differs: {last_exec}")
    if launches < 1:
        problems.append("the verify kernel was not launched on the path")
    problems += device_health_problems(health)
    if problems:
        raise AssertionError("; ".join(problems))
    return out


LEDGER_REPLICA_CONFIG = dict(
    REPLICA_CONFIG,
    # the reference's defaults for the ledger replica: the durability
    # pipeline on at its group shape, the checkpoint and work windows,
    # and state transfer's ranges of 64 blocks, 4 in flight
    durability_pipeline=True, durability_group_max=8,
    durability_window_us=1000, checkpoint_window_size=150,
    work_window_size=300, state_transfer_batch_blocks=64,
    st_window_ranges=4, st_device_digest_threshold=16)


class _KvbcbenchWrites:
    """Client idx's writes for _ClosedLoop: each one kvbcbench block's
    nine keys and values (testing.kvbcbench_rows: eight versioned keys
    and the Merkle key; SkvbcHandler keeps a write's whole writeset in
    its one versioned category) under the client's own key prefix, each
    value naming the write. Keeps, per key, the value of its last
    acknowledged write."""

    def __init__(self, skvbc_clients, rows, timeout_ms: int):
        self.clients = skvbc_clients
        self.rows = rows
        self.timeout_ms = timeout_ms
        self.acked = {}
        self.next_write = [0] * len(skvbc_clients)
        # a list to append (block, writeset, acknowledged at) to, or None
        self.log = None
        # send the writes flagged PRE_PROCESS (the replicas pre-execute
        # them where pre-execution is on)
        self.pre_process = False

    def __call__(self, idx: int) -> None:
        j = self.next_write[idx]
        prefix = b"c%03d/" % idx
        ws = [(prefix + key, value + b"/w%d" % j)
              for _cat, key, value, _t in self.rows[j % len(self.rows)]]
        reply = self.clients[idx].write(ws, timeout_ms=self.timeout_ms,
                                        pre_process=self.pre_process)
        if not reply.success:
            raise AssertionError(f"write rejected: {reply}")
        self.next_write[idx] += 1
        self.acked.update(ws)
        if self.log is not None:
            self.log.append((reply.latest_block, ws, time.monotonic()))


def _durability_totals(reps) -> dict:
    groups = sum(r.durability.m_groups.value for r in reps)
    runs = sum(r.durability.m_runs.value for r in reps)
    return {"groups": groups, "runs": runs,
            "fsyncs": sum(r.durability.m_fsyncs.value for r in reps),
            "fsync_ms": sum(r.durability.m_fsync_us.value
                            for r in reps) / 1e3,
            "runs_per_group": runs / groups if groups else 0.0,
            "replies_signed": sum(r.durability.m_signed.value
                                  for r in reps)}


def _durability_delta(after: dict, before: dict) -> dict:
    out = {k: after[k] - before[k] for k in after if k != "runs_per_group"}
    out["runs_per_group"] = (out["runs"] / out["groups"]
                             if out["groups"] else 0.0)
    return out


def phase_ledger_replica(torch, dev, clients: int = 100,
                         target: int = 2000, reads: int = 120,
                         min_fetched: int = 256,
                         checkpoint_window: int = 150,
                         work_window: int = 300,
                         budget_s: float = 600.0) -> dict:
    """Config 1 as users deploy it: four replicas of testing.
    InProcessCluster running the SKVBC app over the categorized ledger
    (KeyValueBlockchain on a MemoryDB, device hashing), with file WALs,
    the durability pipeline on and state transfer configured as
    KvbcReplica deploys it, on the card. Three stages: a closed-loop load
    of kvbcbench blocks until `target` writes commit; a read-back of
    `reads` acknowledged keys with the client's reply quorum; and a
    catch-up: replica 3 is down for a second load until the cluster's
    stable checkpoint is past the work window of a replica with empty
    state, then restarts with empty state and fetches the ledger by
    state transfer, whose window digests go through the SHA-256 kernel.
    Launch counts are reset just before each stage's load and read just
    after it. Returns the phase's line and, under "window_raws", one
    full window the catch-up digested (for the kernels line)."""
    import shutil
    import tempfile

    import numpy as np

    from tpubft_torch import testing
    from tpubft_torch.apps import skvbc
    from tpubft_torch.consensus.persistent import FilePersistentStorage
    from tpubft_torch.kvbc import KeyValueBlockchain
    from tpubft_torch.ops import ed25519_cuda as kc
    from tpubft_torch.ops import sha256_cuda
    from tpubft_torch.ops.dispatch import device_breaker
    from tpubft_torch.statetransfer import digests
    from tpubft_torch.storage import MemoryDB
    from tpubft_torch.testing import InProcessCluster
    from tpubft_torch.utils.tracing import get_tracer

    cfg = dict(LEDGER_REPLICA_CONFIG,
               checkpoint_window_size=checkpoint_window,
               work_window_size=work_window)
    reduced = {k: v for k, v in (("checkpoint_window_size",
                                  checkpoint_window),
                                 ("work_window_size", work_window))
               if v != LEDGER_REPLICA_CONFIG[k]}
    t_phase = time.monotonic()
    wal_dir = tempfile.mkdtemp(prefix="chip-smoke-wal-")
    incarnation = {}

    def storage_factory(r):
        # a replica restarted "with empty state" gets a fresh WAL
        gen = incarnation.get(r, 0)
        return FilePersistentStorage(
            os.path.join(wal_dir, f"r{r}-{gen}.wal"))

    def handler_factory(_r=None):
        return skvbc.SkvbcHandler(KeyValueBlockchain(MemoryDB()))

    # every window the lagging replica digests, timed around the seam;
    # the first full-size one is kept for the kernels line
    real_window = digests.window_digests
    windows = []
    full_window = []

    def timed_window(raws, use_device=True, threshold=16, device=None,
                     degrade=True):
        t0 = time.perf_counter()
        try:
            return real_window(raws, use_device, threshold, device, degrade)
        finally:
            windows.append({"blocks": len(raws), "use_device": use_device,
                            "degrade": degrade,
                            "ms": (time.perf_counter() - t0) * 1e3})
            if not full_window and len(raws) == cfg[
                    "state_transfer_batch_blocks"]:
                full_window.extend(raws)
    spans = []
    recording = [False]

    def export(span):
        if recording[0] and span.name == "st_range":
            spans.append((span.tags.get("outcome"),
                          span.duration_s * 1e3))
    get_tracer().add_exporter(export)

    with _SigManagerCount() as sig:
        cluster = InProcessCluster(
            f=1, c=0, num_clients=clients, seed=b"chip-smoke-ledger",
            handler_factory=handler_factory,
            storage_factory=storage_factory, cfg_overrides=cfg)
    rep0 = cluster.replicas[0]
    emit({"phase": "ledger_replica", "step": "config", "n": cluster.n,
          "f": 1, "c": 0, "clients": clients, "target_requests": target,
          "read_back": reads, "min_fetched_blocks": min_fetched,
          "config": cfg, "reduced": reduced,
          "scheme": rep0.keys.threshold_scheme,
          "durability_pipeline": rep0.durability is not None,
          "autotune_enabled": rep0.cfg.autotune_enabled,
          "crypto_backend": rep0.crypto_backend,
          "device_hashing": rep0.handler.blockchain._use_device,
          "st_config": vars(rep0.state_transfer.cfg),
          "wal": "FilePersistentStorage"})
    breaker = device_breaker()
    problems = []
    out = {"phase": "ledger_replica", "config": {
        "checkpoint_window_size": checkpoint_window,
        "work_window_size": work_window, "clients": clients},
        "reduced": reduced}
    try:
        cluster.start()
        bft = [cluster.client(i) for i in range(clients)]
        for c in bft:
            c.start()
        kvs = [skvbc.SkvbcClient(c) for c in bft]
        writes = _KvbcbenchWrites(kvs, testing.kvbcbench_rows(64),
                                  timeout_ms=int(budget_s * 1000 / 4))
        loop = _ClosedLoop(clients, writes)
        reps = list(cluster.replicas.values())

        # ---- load ----
        breaker.reset()
        br0 = breaker.snapshot()
        dur0 = _durability_totals(reps)
        sig.calls = 0
        reset_all_launches()
        load = loop.run(lambda n: n >= target, budget_s=budget_s / 4)
        load["verify_launches"] = kc.LAUNCHES["ed25519_verify"]
        load["sigmanager_launches"] = sig.calls
        load["sha256_launches"] = sha256_cuda.LAUNCHES["sha256"]
        load["durability"] = _durability_delta(_durability_totals(reps),
                                               dur0)
        load["preprepares"] = cluster.metric(0, "counters",
                                             "sent_preprepares")
        load["head_block"] = rep0.handler.blockchain.last_block_id
        load["last_stable"] = rep0.last_stable
        out["load"] = load
        emit({"phase": "ledger_replica", "step": "load", **load})
        if loop.errors:
            raise AssertionError(f"load: {loop.errors[:3]}")
        if load["committed"] < target:
            raise AssertionError(f"load: {load['committed']} of {target} "
                                 "writes committed")

        # ---- read-back ----
        rng = np.random.default_rng(9)
        keys = sorted(writes.acked)
        sample = [keys[i] for i in rng.choice(len(keys), size=min(
            reads, len(keys)), replace=False)]
        t0 = time.monotonic()
        got = {}
        for i in range(0, len(sample), 10):
            got.update(kvs[i // 10 % clients].read(sample[i:i + 10],
                                                    timeout_ms=60000))
        wrong = [k for k in sample if got.get(k) != writes.acked[k]]
        out["read_back"] = {"keys": len(sample), "wrong": len(wrong),
                            "reads": -(-len(sample) // 10),
                            "s": time.monotonic() - t0,
                            "quorum": "byzantine_safe (f+1 matching)"}
        emit({"phase": "ledger_replica", "step": "read_back",
              **out["read_back"]})
        if len(sample) < reads or wrong:
            raise AssertionError(f"read-back: {len(wrong)} of "
                                 f"{len(sample)} keys wrong: {wrong[:3]}")

        # ---- catch-up ----
        cluster.kill(3)
        up = [cluster.replicas[r] for r in (0, 1, 2)]
        killed_at = reps[3].last_executed
        reset_all_launches()
        behind = loop.run(
            lambda n: min(r.last_stable for r in up) >= work_window,
            budget_s=budget_s / 3)
        behind["verify_launches"] = kc.LAUNCHES["ed25519_verify"]
        behind["last_stable"] = [r.last_stable for r in up]
        behind["replica3_last_executed"] = killed_at
        out["behind"] = behind
        emit({"phase": "ledger_replica", "step": "behind", **behind})
        if loop.errors or behind["timed_out"]:
            raise AssertionError(f"second load: {loop.errors[:3]} "
                                 f"stable {behind['last_stable']}")
        incarnation[3] = 1
        digests.window_digests = timed_window
        digests.DEGRADED = 0
        reset_all_launches()
        recording[0] = True
        t_restart = time.monotonic()
        rep3 = cluster.restart(3)
        st = rep3.state_transfer

        def caught_up(_n):
            # a transfer completed: replica 3 adopted a checkpoint past
            # the work window it restarted with
            c = st.metrics.snapshot()["counters"]
            return (c["blocks_fetched"] >= min_fetched
                    and not st.is_fetching
                    and rep3.last_executed >= work_window)
        during = loop.run(caught_up, budget_s=budget_s / 3)
        catch_up_s = time.monotonic() - t_restart
        recording[0] = False
        digests.window_digests = real_window
        sha_launches = sha256_cuda.LAUNCHES["sha256"]
        verify_during = kc.LAUNCHES["ed25519_verify"]
        counters = st.metrics.snapshot()["counters"]
        h0 = rep0.handler.blockchain
        h3 = rep3.handler.blockchain
        head = h3.last_block_id
        verified = sorted(ms for outcome, ms in spans
                          if outcome == "verified")
        win_ms = sorted(w["ms"] for w in windows)
        threshold = st.cfg.device_digest_threshold
        catch = {
            "load_during": during, "catch_up_s": catch_up_s,
            "blocks_fetched": counters["blocks_fetched"],
            "bytes_fetched": counters["bytes_fetched"],
            "windows": len(windows),
            "blocks_per_window": sorted({w["blocks"] for w in windows}),
            "windows_on_device": counters["device_digest_batches"],
            "windows_on_host": sum(1 for w in windows
                                   if w["blocks"] < threshold
                                   or not w["use_device"]),
            "scalar_digests": counters["scalar_digests"],
            "device_digest_failures": counters["device_digest_failures"],
            "windows_allowed_to_degrade": sum(1 for w in windows
                                              if w["degrade"]),
            "window_digest_ms": {
                "p50": percentile(win_ms, 0.5),
                "p90": percentile(win_ms, 0.9), "max": win_ms[-1]}
            if win_ms else None,
            "range_fetch_to_verified_ms": {
                "p50": percentile(verified, 0.5),
                "p90": percentile(verified, 0.9), "max": verified[-1]}
            if verified else None,
            "ranges_requeued": counters["ranges_requeued"],
            "source_failovers": counters["source_failovers"],
            "st_blocks_per_sec_gauge": cluster.metric(
                3, "gauges", "st_blocks_per_sec",
                component="state_transfer"),
            "sha256_launches": sha_launches,
            "verify_launches": verify_during,
            "degraded": digests.DEGRADED,
            "replica3_head": head, "replica0_head": h0.last_block_id,
            "head_digest_equal": bool(head) and h3.block_digest(head)
            == h0.block_digest(head),
            "replica3_last_executed": rep3.last_executed,
            "stable": [r.last_stable for r in up]}
        out["catch_up"] = catch
        emit({"phase": "ledger_replica", "step": "catch_up", **catch})
        if loop.errors or during["timed_out"]:
            problems.append(f"catch-up: {loop.errors[:3]}, counters "
                            f"{counters}, replica 3 at "
                            f"{rep3.last_executed}")
        if catch["blocks_fetched"] < min_fetched:
            problems.append(f"{catch['blocks_fetched']} blocks fetched, "
                            f"fewer than {min_fetched}")
        if sha_launches < 1 or sha_launches != catch["windows_on_device"]:
            problems.append(f"{sha_launches} SHA-256 launches for "
                            f"{catch['windows_on_device']} device windows")
        if catch["windows_on_host"] != sum(1 for w in windows
                                           if w["blocks"] < threshold):
            problems.append("a window of the device threshold or more "
                            "was digested on the host")
        if catch["degraded"] or catch["device_digest_failures"] \
                or catch["windows_allowed_to_degrade"]:
            problems.append(f"{catch['degraded']} windows degraded to "
                            f"hashlib, {catch['device_digest_failures']} "
                            "device digest calls failed")
        if not full_window:
            problems.append("no window of state_transfer_batch_blocks "
                            "blocks was digested")
        if not catch["head_digest_equal"]:
            problems.append("replica 3's head digest differs from "
                            "replica 0's")
        # the three replicas that stayed up agree
        heads = [cluster.handlers[r].blockchain for r in (0, 1, 2)]
        settle = time.monotonic() + 30
        while time.monotonic() < settle and len(
                {b.last_block_id for b in heads}) != 1:
            time.sleep(0.05)
        common = min(b.last_block_id for b in heads)
        out["replicas_agree"] = len({b.block_digest(common)
                                     for b in heads}) == 1
        if not out["replicas_agree"]:
            problems.append("replicas 0-2 differ at their common head")
        health = device_health(list(cluster.replicas.values()), br0)
        out.update(health)
        problems += device_health_problems(health)
        if load["verify_launches"] < 1:
            problems.append("the verify kernel was not launched on "
                            "admission")
        out["tuner"] = tuner_report(list(cluster.replicas.values()))
        problems += tuner_problems(out["tuner"])
    finally:
        recording[0] = False
        digests.window_digests = real_window
        cluster.stop()
        shutil.rmtree(wal_dir, ignore_errors=True)
    out["verify_launches"] = (out["load"]["verify_launches"]
                              + out["behind"]["verify_launches"]
                              + out["catch_up"]["verify_launches"])
    out["sha256_launches"] = out["catch_up"]["sha256_launches"]
    out["wall_s"] = time.monotonic() - t_phase
    emit(out)
    if problems:
        raise AssertionError("; ".join(problems))
    out["window_raws"] = list(full_window)
    return out


class _Every:
    """`pred` re-read at most every `period_s` (it polls the replica
    processes); the last answer is returned in between."""

    def __init__(self, pred, period_s: float = 0.25):
        self.pred = pred
        self.period_s = period_s
        self.at = 0.0
        self.last = False

    def __call__(self, _n=None) -> bool:
        now = time.monotonic()
        if now - self.at >= self.period_s:
            self.at = now
            self.last = bool(self.pred())
        return self.last


def _equal_last_executed(net, replicas, timeout: float) -> list:
    """Wait until the replicas' last_executed agree; -> the values. On
    the deadline raise with the values last read."""
    seen = []

    def same():
        seen[:] = [net.last_executed(r) for r in replicas]
        return None not in seen and len(set(seen)) == 1
    try:
        net.wait_for(same, timeout=timeout)
    except TimeoutError:
        raise AssertionError(f"last_executed never agreed: {seen}")
    return list(seen)


def _replica_report(net, r: int) -> dict:
    """Replica r's metrics and its `kernels`, `device` and `health`
    statuses, read over its UDP metrics and diagnostics servers."""
    snap = net.metrics(r).snapshot(timeout=5.0) or {}
    comps = snap.get("components", {})
    sig = comps.get("signature_manager", {}).get("counters", {})
    st = comps.get("state_transfer", {}).get("counters", {})

    def status(name):
        text = net.status(r, name)
        return json.loads(text) if text else {}
    kernels = status("kernels")
    devinfo = status("device")
    health = status("health")
    gauges = comps.get("replica", {}).get("gauges", {})
    return {
        "last_executed": gauges.get("last_executed_seq"),
        "view": gauges.get("view"),
        "sigs_device_dispatched": sig.get("sigs_device_dispatched"),
        "degraded_verifies": sig.get("degraded_verifies"),
        "scalar_fallbacks": sig.get("scalar_fallbacks"),
        "netio_fallbacks": comps.get("udp", {}).get("counters", {}).get(
            "netio_fallbacks"),
        "blocks_fetched": st.get("blocks_fetched"),
        "device_digest_batches": st.get("device_digest_batches"),
        "section_calls": {k: v["calls"] for k, v in kernels.items()},
        "section_ms": {k: v["total_ms"] for k, v in kernels.items()},
        "launches": {k: v for k, v in devinfo.get("launches", {}).items()
                     if v},
        "rlc_launches_by_curve": {
            c: v["rlc_launches"] for c, v in devinfo.get(
                "ecdsa_rlc_by_curve", {}).items() if v["rlc_launches"]},
        "device": devinfo.get("device"),
        "memory_reserved": devinfo.get("memory_reserved"),
        "health": health.get("verdict"),
        "open_breakers": sorted(k for k, b in health.get(
            "breakers", {}).items() if b.get("state") != "closed")}


def _read_back(kvs, writes, keys, timeout_ms: int = 30000) -> list:
    """Read `keys` back, ten a read, over the clients in turn -> the keys
    whose value is not the one last acknowledged."""
    got = {}
    for i in range(0, len(keys), 10):
        got.update(kvs[i // 10 % len(kvs)].read(keys[i:i + 10],
                                                 timeout_ms=timeout_ms))
    return [k for k in keys if got.get(k) != writes.acked[k]]


def _sampled_keys(writes, reads: int, seed: int) -> list:
    """`reads` of the acknowledged keys, chosen by `seed`."""
    import numpy as np
    keys = sorted(writes.acked)
    rng = np.random.default_rng(seed)
    return [keys[i] for i in rng.choice(len(keys), size=min(
        reads, len(keys)), replace=False)]


class _ProcessCluster:
    """The steps the process cluster phases share, over a
    testing.BftTestNetwork of replica processes on the card and
    `clients` closed-loop kvbcbench SkvbcClients in this process. Each
    step records its numbers in `out` under `phase`'s lines; a step
    whose load fails raises, and checks that can wait until the end go
    to `problems`."""

    def __init__(self, phase: str, net, clients: int, out: dict):
        self.phase, self.net, self.out = phase, net, out
        self.clients = clients
        self.problems = []

    def start(self) -> None:
        """Build every library a replica loads once in this process
        (netio must load), start the replica processes, and make the
        clients and their closed loop."""
        from tpubft_torch import testing
        from tpubft_torch.comm import udp
        from tpubft_torch.testing.network import build_libraries
        out, net = self.out, self.net
        self.fallbacks0 = udp.FALLBACKS.value
        t0 = time.monotonic()
        out["build_s"] = build_libraries("cuda")
        out["build_wall_s"] = time.monotonic() - t0
        if udp._load_netio() is None:
            raise AssertionError(f"netio did not load: {udp.load_error}")
        t0 = time.monotonic()
        net.start_all(timeout=120)
        out["start_wall_s"] = time.monotonic() - t0
        out["start_s"] = dict(net.start_s)
        emit({"phase": self.phase, "step": "up",
              **{k: out[k] for k in ("build_s", "build_wall_s",
                                     "start_wall_s", "start_s")}})
        self.kvs = [net.skvbc_client(i) for i in range(self.clients)]
        self.writes = _KvbcbenchWrites(self.kvs, testing.kvbcbench_rows(64),
                                       timeout_ms=30000)
        self.loop = _ClosedLoop(self.clients, self.writes)

    def read_back(self, keys) -> list:
        return _read_back(self.kvs, self.writes, keys)

    def load(self, target: int, reads: int, seed: int,
             budget_s: float) -> list:
        """Load until `target` writes commit (`out["load"]`), read back
        `reads` acknowledged keys chosen by `seed` (`out["read_back"]`)
        and wait for the four last_executed to agree; raises if any of
        it fails. -> the agreed last_executed."""
        load = self.loop.run(lambda n: n >= target, budget_s=budget_s)
        self.out["load"] = load
        emit({"phase": self.phase, "step": "load", **load})
        if self.loop.errors or load["committed"] < target:
            raise AssertionError(f"load: {load['committed']} of {target} "
                                 f"writes committed, {self.loop.errors[:3]}")
        self.sample = _sampled_keys(self.writes, reads, seed)
        wrong = self.read_back(self.sample)
        self.out["read_back"] = {"keys": len(self.sample),
                                 "wrong": len(wrong)}
        if len(self.sample) < reads or wrong:
            raise AssertionError(f"read-back: {len(wrong)} of "
                                 f"{len(self.sample)} keys wrong")
        return _equal_last_executed(self.net, range(self.net.n), timeout=30)

    def kill_behind(self, r: int, min_stable: int, min_writes: int,
                    budget_s: float) -> dict:
        """SIGKILL replica r and load the others until `min_writes` more
        writes commit and their stable checkpoint reaches `min_stable`
        (`out["behind"]`, with the stable checkpoint last read); raises
        if the load fails."""
        net, loop = self.net, self.loop
        net.kill_replica(r)
        up = [x for x in range(net.n) if x != r]
        seen = [0]

        def stable_past():
            st = [net.metrics(x).get("replica", "gauges",
                                     "last_stable_seq") for x in up]
            if None in st:
                return False
            seen[0] = min(st)
            return seen[0] >= min_stable
        past = _Every(stable_past)
        behind = loop.run(lambda n: n >= min_writes and past(),
                          budget_s=budget_s)
        behind["stable"] = seen[0]
        self.out["behind"] = behind
        emit({"phase": self.phase, "step": "behind", **behind})
        if loop.errors or behind["timed_out"]:
            raise AssertionError(f"second load: {behind['committed']} "
                                 f"writes, stable {seen[0]}, "
                                 f"{loop.errors[:3]}")
        return behind

    def restart_under_load(self, r: int, min_fetched: int, min_seq: int,
                           budget_s: float) -> dict:
        """Start replica r again (on its own file where the network has a
        `db_dir`, else empty) while the load goes on in a thread, until
        it has fetched `min_fetched` blocks by state transfer and
        executed up to `min_seq`; then wait for the four last_executed
        to agree. -> the load's numbers, the last_executed of r's first
        metrics answer and the seconds to it, the catch-up seconds and
        the agreed last_executed. A load that fails is a problem."""
        import threading
        net, loop = self.net, self.loop

        def caught_up():
            m = net.metrics(r)
            got = m.get("state_transfer", "counters", "blocks_fetched",
                        timeout=0.3)
            le = m.get("replica", "gauges", "last_executed_seq",
                       timeout=0.3)
            return (got or 0) >= min_fetched and (le or 0) >= min_seq
        during = {}
        thread = threading.Thread(target=lambda: during.update(loop.run(
            _Every(caught_up), budget_s=budget_s)))
        t0 = time.monotonic()
        thread.start()
        try:
            net.start_replica(r)
            first_le, up_s = net.first_answer(r)
        finally:
            thread.join()
        le = _equal_last_executed(net, range(net.n), timeout=60)
        if loop.errors or during.get("timed_out", True):
            self.problems.append(f"catch-up: {loop.errors[:3]}, {during}")
        return {"load_during": during, "first_read_last_executed": first_le,
                "up_s": up_s, "catch_up_s": time.monotonic() - t0,
                "last_executed": le}

    def check_processes(self, reports: dict, earlier=()) -> None:
        """Every process in `reports` (_replica_report): signatures
        dispatched to the device, no verify degraded, health healthy with
        every breaker closed, a verify device section, no netio fallback.
        The verify and SHA-256 launches are summed over `reports` and
        the `earlier` reports of processes since killed, and must be
        above 0."""
        problems = self.problems
        for r, rep in reports.items():
            if not rep["sigs_device_dispatched"]:
                problems.append(f"replica {r}: no signature reached the "
                                "device")
            if rep["degraded_verifies"]:
                problems.append(f"replica {r}: {rep['degraded_verifies']} "
                                "verifies degraded")
            if rep["health"] != "healthy" or rep["open_breakers"]:
                problems.append(f"replica {r}: health {rep['health']}, "
                                f"open breakers {rep['open_breakers']}")
            if not rep["section_calls"].get("ed25519"):
                problems.append(f"replica {r}: no verify device section")
            if rep["netio_fallbacks"] != 0:
                problems.append(f"replica {r}: {rep['netio_fallbacks']} "
                                "netio fallbacks")
        procs = list(earlier) + list(reports.values())
        out = self.out
        out["verify_launches"] = sum(p["launches"].get("ed25519_verify", 0)
                                     for p in procs)
        out["sha256_launches"] = sum(p["launches"].get("sha256", 0)
                                     for p in procs)
        if out["verify_launches"] < 1 or out["sha256_launches"] < 1:
            problems.append(f"launches: verify {out['verify_launches']}, "
                            f"sha256 {out['sha256_launches']}")

    def finish(self, t_phase: float) -> dict:
        """After stop_all: this process's UDP transports must not have
        fallen back to the scalar path. Prints `out`; raises with every
        problem."""
        from tpubft_torch.comm import udp
        out = self.out
        out["netio_fallbacks_parent"] = udp.FALLBACKS.value - self.fallbacks0
        if out["netio_fallbacks_parent"]:
            self.problems.append("this process's UDP transports fell back "
                                 "to the scalar path")
        out["wall_s"] = time.monotonic() - t_phase
        emit(out)
        if self.problems:
            raise AssertionError("; ".join(self.problems))
        return out


class _TrsCheck:
    """The thin-replica read tier over a process network's replicas, each
    serving on `net.trs_base + r` (`--trs-port`). The stream is followed
    by `python -m tpubft_torch.tools.trs_follow` in a process of its own
    (its ThinReplicaClient's threads stay off this process, which drives
    the load), with replica `first`'s server first, so that replica is
    its first data source; it writes each delivered block, and each
    rotation, to a file this object reads. The anchor and the verified
    reads go through a ThinReplicaClient here (f = net.f, the cluster's
    keys as its checkpoint verifier). `writes.log` collects the
    acknowledged writes (block, writeset, time). `seconds` counts what
    this object adds to a phase: its waits, reads and set-up."""

    def __init__(self, net, writes, first: int):
        from tpubft_torch.consensus.keys import ClusterKeys
        from tpubft_torch.thinreplica import (ThinReplicaClient,
                                              keys_cert_verifier)
        t0 = time.monotonic()
        self.net = net
        self.writes = writes
        writes.log = []
        self.order = [first] + [r for r in range(net.n) if r != first]
        self.endpoints = [("127.0.0.1", net.trs_base + r)
                          for r in self.order]
        keys = ClusterKeys.generate(net._node_cfg(), net.num_clients,
                                    seed=net.seed.encode())
        self.client = ThinReplicaClient(
            self.endpoints, f_val=net.f,
            cert_verifier=keys_cert_verifier(keys))
        self.follower = None
        self.stream_path = None
        self._offset = 0
        self.delivered = {}   # block -> (kv, delivered at)
        self.duplicates = []
        self.generation = 0
        self.generation_t = {}   # generation -> when the follower entered it
        self.seconds = time.monotonic() - t0

    def subscribe(self, stream_path: str) -> None:
        """Start the follower, subscribed from block 1, writing to
        `stream_path`."""
        from tpubft_torch.apps.simple_test import child_env
        t0 = time.monotonic()
        self.stream_path = stream_path
        argv = [sys.executable, "-m", "tpubft_torch.tools.trs_follow",
                "--f", str(self.net.f), "--out", stream_path,
                "--exit-on-stdin-eof"]
        for host, port in self.endpoints:
            argv += ["--endpoint", f"{host}:{port}"]
        self.follower = subprocess.Popen(
            argv, stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL, cwd=HERE, env=child_env())
        self.seconds += time.monotonic() - t0

    def _read(self) -> None:
        """Take in the follower's lines written since the last read."""
        if self.stream_path is None or not os.path.exists(self.stream_path):
            return
        with open(self.stream_path, "rb") as f:
            f.seek(self._offset)
            data = f.read()
        end = data.rfind(b"\n") + 1
        self._offset += end
        for line in data[:end].splitlines():
            rec = json.loads(line)
            if "generation" in rec:
                self.generation = rec["generation"]
                self.generation_t[self.generation] = rec["t"]
                continue
            if rec["block"] in self.delivered:
                self.duplicates.append(rec["block"])
            self.delivered[rec["block"]] = (
                {bytes.fromhex(k): bytes.fromhex(v) for k, v in rec["kv"]},
                rec["t"])

    def _contiguous(self) -> int:
        """The highest block b with every block 1..b delivered."""
        self._read()
        b = 0
        while b + 1 in self.delivered:
            b += 1
        return b

    def streamed(self, kv_client, bound_s: float = 30.0,
                 killed_at: float = None) -> dict:
        """Wait (at most `bound_s`) until every block up to the cluster's
        last block is delivered; every acknowledged write's keys and
        values must be at its block, none missing or delivered twice.
        -> blocks, the steady delivery lag from acknowledgement (ms, p50
        and p99), the generations and the seconds waited. Where the data
        source was SIGKILLed at `killed_at` (time.monotonic()), the
        writes acknowledged from then until the follower's next
        generation are the rotation's, apart from the steady lag: the
        seconds from the kill to that generation and their largest lag
        (`rotation`)."""
        t0 = time.monotonic()
        head = kv_client.get_last_block(timeout_ms=30000)
        while self._contiguous() < head:
            if time.monotonic() - t0 > bound_s:
                raise AssertionError(
                    f"trs: blocks 1..{self._contiguous()} of {head} "
                    f"delivered after {bound_s} s (generation "
                    f"{self.generation}, follower exit "
                    f"{self.follower.poll()})")
            time.sleep(0.02)
        waited = time.monotonic() - t0
        rotated_at = None
        if killed_at is not None:
            rotated_at = min((t for t in self.generation_t.values()
                              if t >= killed_at), default=None)
        lags, rotation, wrong = [], [], []
        for block, ws, acked_at in list(self.writes.log):
            kv, at = self.delivered.get(block, ({}, None))
            if at is None or any(kv.get(k) != v for k, v in ws):
                wrong.append(block)
            elif rotated_at is not None \
                    and killed_at <= acked_at <= rotated_at:
                rotation.append((at - acked_at) * 1e3)
            else:
                lags.append((at - acked_at) * 1e3)
        if self.duplicates or wrong:
            raise AssertionError(f"trs: blocks delivered twice "
                                 f"{self.duplicates[:5]}, writes not at "
                                 f"their block {wrong[:5]}")
        self.seconds += time.monotonic() - t0
        lags.sort()
        out = {"head": head, "blocks_streamed": len(self.delivered),
               "writes_checked": len(lags) + len(rotation),
               "delivery_lag_ms": {"p50": percentile(lags, 0.5),
                                   "p99": percentile(lags, 0.99),
                                   "writes": len(lags)} if lags else None,
               "generations": self.generation,
               "wait_s": waited}
        if rotated_at is not None:
            out["rotation"] = {
                "kill_to_next_generation_ms": (rotated_at - killed_at) * 1e3,
                "writes": len(rotation),
                "max_lag_ms": max(rotation, default=None)}
        return out

    def rotated(self, generation: int, bound_s: float = 15.0) -> int:
        """Wait (at most `bound_s`) until the follower's client has left
        the generation it was in when its data source died. -> the
        generation."""
        t0 = time.monotonic()
        self._read()
        while self.generation <= generation:
            self._read()
            if time.monotonic() - t0 > bound_s:
                raise AssertionError(f"trs: still in generation "
                                     f"{generation} {bound_s} s after its "
                                     "data source died")
            time.sleep(0.02)
        self.seconds += time.monotonic() - t0
        return self.generation

    def anchor(self, server_replica: int) -> dict:
        """From replica `server_replica`'s server: fetch and verify the
        checkpoint anchor (f+1 signed checkpoints over the digest its
        block row hashes to), which must be at or past the stable
        checkpoint read just before."""
        t0 = time.monotonic()
        stable = self.net.metrics(server_replica).get(
            "replica", "gauges", "last_stable_seq")
        block = self.client.fetch_anchor(
            server=self.order.index(server_replica))
        seq = self.client._anchor_seq
        self.seconds += time.monotonic() - t0
        if not block or seq < (stable or 0):
            raise AssertionError(f"trs: anchor {block} at checkpoint {seq}, "
                                 f"the stable checkpoint {stable}")
        return {"anchor_block": block, "anchor_checkpoint": seq,
                "stable_checkpoint": stable}

    def anchored_reads(self, server_replica: int, reads: int = 20,
                       seed: int = 21) -> dict:
        """The anchor (`anchor`) from replica `server_replica`'s server,
        then `reads` verified reads of acknowledged keys last written at
        or below the anchored block (each its last acknowledged value),
        one historical read at an earlier block (that block's value) and
        an absent key (None). The SKVBC state must be in its BLOCK_MERKLE
        category (`--merkle`)."""
        import numpy as np
        out = self.anchor(server_replica)
        t0 = time.monotonic()
        server = self.order.index(server_replica)
        block = out["anchor_block"]
        last = {}
        for b, ws, _t in sorted(self.writes.log, key=lambda e: e[0]):
            for k, v in ws:
                last[k] = (b, v)
        under = sorted(k for k, (b, _v) in last.items() if b <= block)
        rng = np.random.default_rng(seed)
        keys = [under[i] for i in rng.choice(len(under), size=min(
            reads, len(under)), replace=False)]
        # the historical read: a key last written within 40 blocks below
        # the anchor, read at that earlier block
        near = [k for k in under if block - 40 <= last[k][0] < block]
        rtt, wrong = [], []
        for k in keys:
            t = time.perf_counter()
            got = self.client.verified_read("kv", k, server=server)
            rtt.append((time.perf_counter() - t) * 1e3)
            if got != last[k][1]:
                wrong.append(k)
        hist = None
        if near:
            k = near[0]
            t = time.perf_counter()
            got = self.client.verified_read("kv", k, block_id=last[k][0],
                                            server=server)
            rtt.append((time.perf_counter() - t) * 1e3)
            hist = {"block": last[k][0], "equal": got == last[k][1]}
        t = time.perf_counter()
        absent = self.client.verified_read("kv", b"trs/absent",
                                           server=server)
        rtt.append((time.perf_counter() - t) * 1e3)
        self.seconds += time.monotonic() - t0
        rtt.sort()
        out.update(reads=len(keys), wrong=len(wrong), historical=hist,
                   absent_is_none=absent is None,
                   read_ms={"p50": percentile(rtt, 0.5),
                            "p99": percentile(rtt, 0.99)})
        if len(keys) < reads or wrong or not hist or not hist["equal"] \
                or absent is not None:
            raise AssertionError(f"trs: anchored reads {out}")
        return out

    def metrics(self, replicas) -> dict:
        """The `thinreplica` component of each replica process: pushed
        runs above 0 on each, proofs summed, no overflow."""
        t0 = time.monotonic()
        per = {}
        for r in replicas:
            m = self.net.metrics(r)
            per[r] = {k: m.get("thinreplica", "counters", k) or 0 for k in (
                "trs_pushed_runs", "trs_proofs", "trs_overflows",
                "trs_dropped_subscribers")}
        self.seconds += time.monotonic() - t0
        return per

    def stop(self) -> None:
        self.client.stop()
        if self.follower is not None and self.follower.poll() is None:
            self.follower.terminate()
            try:
                self.follower.wait(10)
            except subprocess.TimeoutExpired:
                self.follower.kill()
                self.follower.wait()


# Where the read tier's verified reads run: a network apart from config
# 1's, cut to what a BLOCK_MERKLE ledger in MemoryDB can take (ROADMAP
# C.12: a block writes a node row for each level of each key's path, and
# MemoryDB keeps its keys sorted by insertion, so a block's cost grows
# with the ledger). Printed under process_cluster's `reduced`.
TRS_PROOF_NETWORK = {"clients": 4, "checkpoint_window": 5,
                     "work_window": 10, "keys_a_write": 1}


def _trs_proof_network(net_cls, log_dir: str):
    """The network for the read tier's proofs (TRS_PROOF_NETWORK): four
    replica processes on the card with the SKVBC state in its
    BLOCK_MERKLE category (`--merkle`), checkpoint windows of 5 so an
    anchor forms after a few writes."""
    cut = TRS_PROOF_NETWORK
    return net_cls(f=1, num_clients=cut["clients"],
                   seed="chip-smoke-trs-proofs", device="cuda",
                   log_dir=log_dir, merkle=True,
                   checkpoint_window=cut["checkpoint_window"],
                   work_window=cut["work_window"])


def _trs_proven_reads(net, reads: int = 20, bound_s: float = 30.0) -> dict:
    """On `net` (started, BLOCK_MERKLE state): its clients write one key
    each a write, in a closed loop, until replica 0's anchor covers
    `reads` + 1 acknowledged keys (at most `bound_s`); then
    `_TrsCheck.anchored_reads`, the ledger's last block and every
    process's `thinreplica` counters."""
    kvs = [net.skvbc_client(i) for i in range(net.num_clients)]
    rows = [[("kv", b"k%d" % b, b"v%d" % b, "block_merkle")]
            for b in range(64)]
    writes = _KvbcbenchWrites(kvs, rows, timeout_ms=30000)
    trs = _TrsCheck(net, writes, first=3)
    loop = _ClosedLoop(len(kvs), writes)
    t0 = time.monotonic()
    try:
        while True:
            loop.run(lambda n: n >= 8, budget_s=bound_s)
            if loop.errors:
                raise AssertionError(f"trs proofs: {loop.errors[:3]}")
            block = trs.client.fetch_anchor(server=trs.order.index(0))
            if block and sum(1 for b, _ws, _t in writes.log
                             if b <= block) > reads:
                break
            if time.monotonic() - t0 > bound_s:
                raise AssertionError(f"trs proofs: anchor {block} after "
                                     f"{len(writes.log)} writes")
        out = trs.anchored_reads(server_replica=0, reads=reads)
        out["writes"] = len(writes.log)
        out["ledger_blocks"] = kvs[0].get_last_block(timeout_ms=30000)
        out["metrics"] = trs.metrics(range(net.n))
        return out
    finally:
        trs.stop()


def phase_process_cluster(torch, dev, ledger_replica: dict,
                          clients: int = 32, target: int = 1000,
                          reads: int = 120, behind: int = 300,
                          min_fetched: int = 256,
                          device_min_verify_batch: int = 4,
                          budget_s: float = 150.0,
                          thin_replica: bool = True) -> dict:
    """Config 1 as BASELINE.md runs it ("simpleTest 4-replica (f=1)
    UDP"): four replica OS processes (python -m
    tpubft_torch.apps.skvbc_replica, the SKVBC ledger in memory, every
    setting at ReplicaConfig's default on the card but
    `device_min_verify_batch`) started by
    testing.BftTestNetwork over UDP on localhost, after this process
    built every library once (the build seconds printed, netio among
    them). `clients` closed-loop SkvbcClients in this process write
    kvbcbench blocks until `target` commit; `reads` acknowledged keys
    are read back; all four last_executed must agree. Replica 3 is then
    SIGKILLed, `behind` more writes commit on the other three and the
    load goes on until their stable checkpoint is past the work window of
    a replica with empty state; replica 3 restarts empty while the load
    goes on (the reference's harness catches a restarted replica up
    only under load) until it has fetched `min_fetched` blocks by state
    transfer, then the load stops and its last_executed must reach the
    others'. Read from every process over its metrics and diagnostics
    servers: sigs_device_dispatched > 0, degraded_verifies 0, health
    healthy with every breaker closed, the verify section's calls > 0,
    SHA-256's > 0 in the restarted replica, no netio fallback (nor in
    this process), each wrapper's launches and the CUDA memory each
    process holds. Printed beside the in-process ledger_replica phase's
    rate and latency from the same run.

    The thin-replica read tier rides the same processes (`_TrsCheck`,
    replica 3 the first data source of its follower process): the stream
    from block 1 through the load, the SIGKILL (the client rotates) and
    the catch-up, every acknowledged write at its block; the anchor, with
    the cluster's keys as the checkpoint verifier, at the end. Its
    verified reads run after this network has stopped, on a second one
    (`_trs_proof_network`, `_trs_proven_reads`) whose SKVBC state is in
    the BLOCK_MERKLE category the proofs need, cut to TRS_PROOF_NETWORK
    (printed under `reduced`). With `thin_replica` False there is no
    follower and no proof network (each replica still serves on its
    `--trs-port`): tools/cluster_ab.py's A/B of what the follower costs
    config 1's load.

    `device_min_verify_batch` is 4, not ReplicaConfig's 32 (the
    reference's TPU crossover): with 32 clients a PrePrepare holds about
    5 requests, and at 32 the primary verified every signature on the
    host (PERF.md §7: on an H100, 0 signatures dispatched on replica 0
    and 104.6 requests/s; at 4, 280.4)."""
    import shutil
    import tempfile

    from tpubft_torch.testing.network import BftTestNetwork

    t_phase = time.monotonic()
    log_dir = tempfile.mkdtemp(prefix="chip-smoke-procs-")
    net = BftTestNetwork(f=1, num_clients=clients, seed="chip-smoke-procs",
                         device="cuda", log_dir=log_dir,
                         device_min_verify_batch=device_min_verify_batch)
    out = {"phase": "process_cluster", "n": net.n, "f": 1,
           "clients": clients, "transport": net.transport,
           "crypto_backend": net.crypto_backend,
           "checkpoint_window": net.checkpoint_window,
           "work_window": net.work_window,
           "device_min_verify_batch": device_min_verify_batch,
           "thin_replica": thin_replica}
    cl = _ProcessCluster("process_cluster", net, clients, out)
    trs = None
    try:
        cl.start()
        if thin_replica:
            trs = _TrsCheck(net, cl.writes, first=3)
            trs.subscribe(os.path.join(log_dir, "stream.jsonl"))
        out["last_executed_after_load"] = cl.load(
            target, reads, seed=9, budget_s=budget_s / 3)
        if trs is not None:
            emit({"phase": "process_cluster", "step": "trs_stream",
                  **trs.streamed(cl.kvs[0])})
            trs._read()
            generation = trs.generation
        # replica 3's counts die with it: read them first
        before_kill = _replica_report(net, 3)
        killed_at = time.monotonic()
        cl.kill_behind(3, min_stable=net.work_window, min_writes=behind,
                       budget_s=budget_s / 3)
        if trs is not None:
            rotated_to = trs.rotated(generation)
        catch_up = cl.restart_under_load(3, min_fetched=min_fetched,
                                         min_seq=net.work_window,
                                         budget_s=budget_s / 3)
        if trs is not None:
            stream = trs.streamed(cl.kvs[0], killed_at=killed_at)
            anchor = trs.anchor(server_replica=0)
            trs_metrics = trs.metrics(range(net.n))
            trs.stop()
        reports = {r: _replica_report(net, r) for r in range(net.n)}
        catch_up.update(restart_start_s=catch_up.pop("up_s"),
                        blocks_fetched=reports[3]["blocks_fetched"],
                        device_digest_windows=reports[3][
                            "device_digest_batches"])
        out["catch_up"] = catch_up
        emit({"phase": "process_cluster", "step": "catch_up", **catch_up})
        out["replica3_before_kill"] = before_kill
        out["replicas"] = reports
        cl.check_processes(reports, earlier=[before_kill])
        if not reports[3]["section_calls"].get("sha256"):
            cl.problems.append("the restarted replica ran no SHA-256 "
                               "section")
        if (reports[3]["blocks_fetched"] or 0) < min_fetched:
            cl.problems.append(f"replica 3 fetched "
                               f"{reports[3]['blocks_fetched']} blocks, "
                               f"fewer than {min_fetched}")
    finally:
        if trs is not None:
            trs.stop()
        net.stop_all()
        shutil.rmtree(log_dir, ignore_errors=True)
    if trs is not None:
        out["trs"] = _trs_step(trs, stream, rotated_to, anchor, trs_metrics,
                               BftTestNetwork, cl.problems)
        out["reduced"] = {"trs_proof_network": {
            "default": "config 1's network",
            "run": {**TRS_PROOF_NETWORK,
                    "ledger_blocks": out["trs"]["proofs"]["ledger_blocks"]}}}
    inproc = ledger_replica["load"]
    out["beside_in_process"] = {
        "process_requests_per_s": out["load"]["requests_per_s"],
        "process_commit_latency_ms": out["load"]["commit_latency_ms"],
        "in_process_requests_per_s": inproc["requests_per_s"],
        "in_process_commit_latency_ms": inproc["commit_latency_ms"],
        "in_process_clients": ledger_replica["config"]["clients"]}
    return cl.finish(t_phase)


def _trs_step(trs, stream: dict, rotated_to: int, anchor: dict,
              trs_metrics: dict, net_cls, problems: list) -> dict:
    """process_cluster's `trs` step once config 1's network has stopped:
    the verified reads on the proof network (started, read and stopped
    here), then the step's line. `step_s` is what the check adds on its
    own (its waits and reads on both networks); the proof network's
    start and stop are timed apart (`proof_network_s`). The steady
    delivery lag and the rotation's gap are each printed beside their
    limit (PERF.md §2): the client's 250 ms first retry, and its stall
    timeout plus a second to reconnect. Problems go to `problems`."""
    import shutil
    import tempfile

    from tpubft_torch.thinreplica import ThinReplicaClient
    proof_dir = tempfile.mkdtemp(prefix="chip-smoke-trs-")
    proof_net = _trs_proof_network(net_cls, proof_dir)
    t0 = time.monotonic()
    try:
        proof_net.start_all(timeout=120)
        t1 = time.monotonic()
        proofs = _trs_proven_reads(proof_net)
        t2 = time.monotonic()
    finally:
        proof_net.stop_all()
        shutil.rmtree(proof_dir, ignore_errors=True)
    step_s = trs.seconds + t2 - t1
    lag, rotation = stream["delivery_lag_ms"], stream.get("rotation", {})
    rotation_limit_ms = (ThinReplicaClient.STALL_TIMEOUT_S + 1.0) * 1e3
    out = {
        "blocks_streamed": stream["blocks_streamed"],
        "writes_checked": stream["writes_checked"],
        "delivery_lag_ms": {**lag, "limit_p99": 250.0,
                            "met": lag["p99"] < 250.0} if lag else None,
        "rotation": {**rotation, "limit_ms": rotation_limit_ms,
                     "met": (rotation.get("max_lag_ms") or 0.0)
                     < rotation_limit_ms},
        "generations": stream["generations"],
        "generation_after_kill": rotated_to,
        "first_data_source": trs.order[0], **anchor,
        "metrics": trs_metrics,
        "proofs": {k: proofs[k] for k in (
            "anchor_block", "anchor_checkpoint", "stable_checkpoint",
            "writes", "ledger_blocks", "reads", "wrong", "historical",
            "absent_is_none", "metrics")},
        # on the proof network's ledger, not config 1's (`reduced`)
        "verified_read_ms": {**proofs["read_ms"],
                             "ledger_blocks": proofs["ledger_blocks"]},
        "proof_network_s": {"start": t1 - t0, "reads": t2 - t1,
                            "stop": time.monotonic() - t2},
        "step_s": step_s}
    emit({"phase": "process_cluster", "step": "trs", **out})
    pm = proofs["metrics"]
    if any(m["trs_pushed_runs"] < 1 for m in trs_metrics.values()) \
            or sum(m["trs_proofs"] for m in pm.values()) < 21 \
            or any(m["trs_overflows"] for m in list(
                trs_metrics.values()) + list(pm.values())):
        problems.append(f"trs metrics: {trs_metrics}, proof network {pm}")
    if step_s > 15.0:
        problems.append(f"the trs step took {step_s:.1f} s")
    return out


_BLOCK_CRYPTOGRAPHY = """
import json, sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name == "cryptography" or name.startswith("cryptography."):
            raise ModuleNotFoundError("blocked: " + name)
sys.meta_path.insert(0, _Block())
sys.path.insert(0, sys.argv[1])
import chip_smoke
out = chip_smoke._tls_handshakes()
assert not [m for m in sys.modules if m.split(".")[0] == "cryptography"]
print(json.dumps(out))
"""


def _tls_handshakes_without_cryptography() -> dict:
    """_tls_handshakes in a child process in which every `cryptography`
    import raises, whether or not this machine has the package."""
    proc = subprocess.run([sys.executable, "-c", _BLOCK_CRYPTOGRAPHY, HERE],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise AssertionError("TLS handshakes with `cryptography` blocked "
                             f"failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _tls_handshakes() -> dict:
    """TLS material written by the port on this machine (no
    `cryptography` needed), without and with a password: two
    TlsTcpCommunication endpoints exchange one message each way on each.
    -> {"plain": ms, "password": ms} (material to both deliveries)."""
    import shutil
    import socket
    import tempfile
    import threading

    from tpubft_torch.comm.tls import (TlsConfig, TlsTcpCommunication,
                                       generate_tls_material)

    class Sink:
        def __init__(self):
            self.got = threading.Event()

        def on_connection_status_changed(self, *_):
            pass

        def on_new_message(self, sender, data):
            self.got.set()

    out = {}
    for name, password in (("plain", None), ("password", "chip-smoke-pw")):
        d = tempfile.mkdtemp(prefix="chip-smoke-tls-material-")
        socks = [socket.socket() for _ in range(2)]
        for s in socks:
            s.bind(("127.0.0.1", 0))
        eps = {i: ("127.0.0.1", s.getsockname()[1])
               for i, s in enumerate(socks)}
        for s in socks:
            s.close()
        t0 = time.monotonic()
        nodes = []
        try:
            generate_tls_material(d, [0, 1], password=password)
            for i in (0, 1):
                nodes.append(TlsTcpCommunication(TlsConfig(
                    self_id=i, endpoints=eps, certs_dir=d,
                    key_password=password)))
            sinks = [Sink(), Sink()]
            for n, sk in zip(nodes, sinks):
                n.start(sk)
            nodes[1].send(0, b"1->0")
            nodes[0].send(1, b"0->1")
            if not all(sk.got.wait(30) for sk in sinks):
                raise AssertionError(f"TLS endpoints ({name} key) did not "
                                     "exchange a message both ways")
            out[name] = (time.monotonic() - t0) * 1e3
        finally:
            for n in nodes:
                n.stop()
            shutil.rmtree(d, ignore_errors=True)
    return out


class _Storm:
    """Config 5's view-change storm (benchmarks/bench_e2e.py:248-264):
    every `period_s` the current primary (the largest view the live
    replicas report, modulo n) is paused with SIGSTOP for the
    view-change timeout plus 1 s, then resumed. Each cycle records the
    view and primary at its pause and the writes committed by then
    (`committed()`); `timeline` holds [seconds, largest view, writes
    committed] every half second where either changed."""

    def __init__(self, net, committed, period_s: float):
        import threading
        self.net = net
        self.committed = committed
        self.period_s = period_s
        self.cycles = []
        self.timeline = []
        self.errors = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._sampler = threading.Thread(target=self._sample, daemon=True)
        self._t0 = time.monotonic()

    def _sample(self) -> None:
        net = self.net
        while not self._stop.wait(0.5):
            views = [net.metrics(r).get("replica", "gauges", "view",
                                        timeout=0.2)
                     for r in range(net.n) if r not in net.paused]
            row = [max((v for v in views if v is not None), default=None),
                   self.committed()]
            if not self.timeline or self.timeline[-1][1:] != row:
                self.timeline.append([round(time.monotonic() - self._t0,
                                            1)] + row)

    def _run(self) -> None:
        net = self.net
        try:
            while not self._stop.wait(self.period_s):
                views = [net.current_view(r) for r in range(net.n)]
                view = max((v for v in views if v is not None), default=0)
                r = view % net.n
                self.cycles.append({
                    "t_s": time.monotonic() - self._t0, "view": view,
                    "primary": r, "committed_at_pause": self.committed()})
                net.pause_replica(r)
                try:
                    self._stop.wait(net.view_change_timeout_ms / 1000.0
                                    + 1.0)
                finally:
                    net.resume_replica(r)
        except Exception as exc:  # noqa: BLE001 — reported by the phase
            self.errors.append(f"{type(exc).__name__}: {exc}")

    def start(self) -> "_Storm":
        self._thread.start()
        self._sampler.start()
        return self

    def stop(self) -> list:
        """Stop the storm (the paused replica resumed); -> the cycles,
        each with the writes committed until the next cycle's pause (or
        the storm's stop). A second call returns them as they were."""
        if self._stop.is_set():
            return self.cycles
        self._stop.set()
        self._thread.join(30)
        self._sampler.join(5)
        end = self.committed()
        for i, c in enumerate(self.cycles):
            nxt = (self.cycles[i + 1]["committed_at_pause"]
                   if i + 1 < len(self.cycles) else end)
            c["committed_in_cycle"] = nxt - c["committed_at_pause"]
        return self.cycles


def _proc_cpu_s(pid: int) -> float:
    """User plus system CPU seconds of process `pid` (/proc/<pid>/stat);
    -1.0 where it cannot be read."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) / os.sysconf(
            "SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return -1.0


def _slot_stages(net, r: int) -> dict:
    """Replica r's per-slot stage times (`status get slots`: admission
    wait, dispatch, prepare, commit, execution, reply; ms p50 and mean
    over its completed slots)."""
    text = net.status(r, "slots")
    stages = json.loads(text)["summary"].get("stages", {}) if text else {}
    return {k: {"p50_ms": v["p50_ms"], "avg_ms": v["avg_ms"]}
            for k, v in stages.items() if v["count"]}


def _view_entries(net) -> dict:
    """Each replica's last views entered (`status get views`: the view,
    the slots its primary re-proposed, ms from entry to the first
    execution there, null if none came) and, over all of them, the
    entries that executed nothing and the largest time to a first
    execution."""
    by_replica = {}
    for r in range(net.n):
        text = net.status(r, "views")
        by_replica[r] = [{k: e[k] for k in ("view", "reproposed",
                                            "first_exec_ms")}
                         for e in (json.loads(text) if text else [])]
    times = [e["first_exec_ms"] for es in by_replica.values() for e in es
             if e["first_exec_ms"] is not None]
    return {"by_replica": by_replica,
            "without_execution": sum(e["first_exec_ms"] is None
                                     for es in by_replica.values()
                                     for e in es),
            "max_first_exec_ms": max(times, default=None)}


def _print_log_tails(log_dir: str, lines: int = 60) -> None:
    """The last `lines` lines of each replica process's log, to stderr
    (a failed cluster phase's diagnosis)."""
    _print_log_tails_of(log_dir, os.listdir(log_dir), lines)


def _print_log_tails_of(log_dir: str, names, lines: int = 60) -> None:
    for name in sorted(names):
        try:
            with open(os.path.join(log_dir, name), errors="replace") as f:
                tail = f.readlines()[-lines:]
        except OSError:
            continue
        print(f"---- {name} ----\n" + "".join(tail), file=sys.stderr,
              flush=True)


def phase_tls_cluster(torch, dev, clients: int = 16, load_s: float = 60.0,
                      period_s: float = 4.0,
                      view_change_timeout_ms: int = 3000,
                      device_min_verify_batch: int = 4, reads: int = 60,
                      min_view_changes: int = 3) -> dict:
    """BASELINE config 5 as benchmarks/bench_e2e.py:87-90 and :248-300
    run it ("Mixed ECDSA-P256 client auth + BLS threshold, TLS
    transport, view-change storm"): four replica OS processes from
    testing.BftTestNetwork(transport="tls") on the card, f=1,
    threshold-bls certificates, ecdsa-p256 clients, the view-change
    timeout at 3,000 ms, `device_min_verify_batch` 4 (as
    process_cluster, for the same reason), every other setting at
    ReplicaConfig()'s defaults, the tuner among them. First, on this
    machine, the port's TLS material without and with a password and
    two TlsTcpCommunication endpoints exchanging a message both ways on
    each (OpenSSL loads the port's PBES2 keys; `ssl.OPENSSL_VERSION`
    printed). Then `clients` closed-loop SkvbcClients write kvbcbench
    blocks for `load_s` while _Storm pauses the current primary every
    `period_s` for the timeout plus 1 s; then the storm stops, `reads`
    acknowledged keys are read back and the four last_executed must
    agree. Read from every process, failing if one is missing: its
    view at least `min_view_changes`, P-256 RLC launches and Ed25519
    verify launches (each summed over the processes) above 0, health
    healthy with every breaker closed, no verify degraded; and writes
    committed in every storm cycle."""
    import importlib.util
    import shutil
    import ssl
    import tempfile

    from tpubft_torch import testing
    from tpubft_torch.testing.network import BftTestNetwork, build_libraries

    t_phase = time.monotonic()
    out = {"phase": "tls_cluster", "n": 4, "f": 1, "clients": clients,
           "transport": "tls", "threshold_scheme": "threshold-bls",
           "client_sig_scheme": "ecdsa-p256",
           "view_change_timeout_ms": view_change_timeout_ms,
           "storm_period_s": period_s,
           "device_min_verify_batch": device_min_verify_batch,
           "openssl": ssl.OPENSSL_VERSION,
           "cryptography_installed":
               importlib.util.find_spec("cryptography") is not None}
    steps = out["steps_s"] = {}
    t0 = time.monotonic()
    out["handshake_ms"] = _tls_handshakes_without_cryptography()
    steps["handshakes"] = time.monotonic() - t0
    emit({"phase": "tls_cluster", "step": "handshakes",
          **{k: out[k] for k in ("openssl", "cryptography_installed",
                                 "handshake_ms")}})

    problems = []
    log_dir = tempfile.mkdtemp(prefix="chip-smoke-tls-")
    t0 = time.monotonic()
    net = BftTestNetwork(f=1, num_clients=clients, seed="chip-smoke-tls",
                         device="cuda", transport="tls",
                         threshold_scheme="threshold-bls",
                         client_sig_scheme="ecdsa-p256",
                         view_change_timeout_ms=view_change_timeout_ms,
                         device_min_verify_batch=device_min_verify_batch,
                         log_dir=log_dir)
    steps["material"] = time.monotonic() - t0
    storm = None
    try:
        t0 = time.monotonic()
        out["build_s"] = build_libraries("cuda")
        steps["build"] = time.monotonic() - t0
        t0 = time.monotonic()
        net.start_all(timeout=120)
        steps["start"] = time.monotonic() - t0
        out["start_s"] = dict(net.start_s)
        emit({"phase": "tls_cluster", "step": "up", "steps_s": steps,
              "start_s": out["start_s"]})
        kvs = [net.skvbc_client(i) for i in range(clients)]
        writes = _KvbcbenchWrites(kvs, testing.kvbcbench_rows(64),
                                  timeout_ms=60000)
        loop = _ClosedLoop(clients, writes)

        # ---- load under the storm ----
        t0 = time.monotonic()
        cpu0 = {r: _proc_cpu_s(p.pid) for r, p in net.procs.items()}
        storm = _Storm(net, lambda: sum(writes.next_write),
                       period_s).start()
        load = loop.run(lambda n: False, budget_s=load_s)
        cycles = storm.stop()
        steps["load"] = time.monotonic() - t0
        # each replica process's CPU seconds over the load: near 1 a
        # second of load, its interpreter is the bottleneck
        out["cpu_s_per_load_s"] = {
            r: (_proc_cpu_s(p.pid) - cpu0[r]) / steps["load"]
            for r, p in net.procs.items()}
        load.pop("timed_out")
        out["load"] = load
        out["storm"] = {"cycles": cycles, "timeline": storm.timeline,
                        "errors": storm.errors}
        emit({"phase": "tls_cluster", "step": "load", **load,
              "storm": out["storm"]})
        if loop.errors or storm.errors:
            raise AssertionError(f"load: {loop.errors[:3]}, storm: "
                                 f"{storm.errors}")
        halted = [c for c in cycles if c["committed_in_cycle"] < 1]
        if len(cycles) < min_view_changes or halted:
            problems.append(f"storm: {len(cycles)} cycles, no write "
                            f"committed in {halted}")

        # ---- read-back, agreement ----
        t0 = time.monotonic()
        sample = _sampled_keys(writes, reads, seed=5)
        wrong = _read_back(kvs, writes, sample, timeout_ms=60000)
        out["read_back"] = {"keys": len(sample), "wrong": len(wrong)}
        if len(sample) < reads or wrong:
            problems.append(f"read-back: {len(wrong)} of {len(sample)} "
                            "keys wrong")
        out["last_executed"] = _equal_last_executed(net, range(net.n),
                                                    timeout=60)
        steps["read_back"] = time.monotonic() - t0

        # ---- what each process ran ----
        reports = {r: _replica_report(net, r) for r in range(net.n)}
        for r, rep in reports.items():
            rep["slot_stages"] = _slot_stages(net, r)
        out["replicas"] = reports
        out["view_entries"] = _view_entries(net)
        for r, rep in reports.items():
            if rep["view"] is None or rep["view"] < min_view_changes:
                problems.append(f"replica {r}: view {rep['view']}, fewer "
                                f"than {min_view_changes} view changes")
            if rep["degraded_verifies"] != 0:
                problems.append(f"replica {r}: degraded verifies "
                                f"{rep['degraded_verifies']}")
            if rep["health"] != "healthy" or rep["open_breakers"]:
                problems.append(f"replica {r}: health {rep['health']}, "
                                f"open breakers {rep['open_breakers']}")
        out["views"] = [rep["view"] for rep in reports.values()]
        out["launches_by_process"] = {
            r: {"ed25519_verify": rep["launches"].get("ed25519_verify", 0),
                "ecdsa_rlc_p256": rep["rlc_launches_by_curve"].get(
                    "secp256r1", 0),
                "bls_msm": rep["launches"].get("bls_msm", 0),
                "sha256": rep["launches"].get("sha256", 0)}
            for r, rep in reports.items()}
        out["verify_launches"] = sum(v["ed25519_verify"] for v in
                                     out["launches_by_process"].values())
        out["rlc_p256_launches"] = sum(v["ecdsa_rlc_p256"] for v in
                                       out["launches_by_process"].values())
        if out["verify_launches"] < 1 or out["rlc_p256_launches"] < 1:
            problems.append(f"launches: verify {out['verify_launches']}, "
                            f"P-256 RLC {out['rlc_p256_launches']}")
    finally:
        if storm is not None:
            storm.stop()
        net.stop_all()
        if problems or sys.exc_info()[0] is not None:
            _print_log_tails(log_dir)
        shutil.rmtree(log_dir, ignore_errors=True)
    out["wall_s"] = time.monotonic() - t_phase
    emit(out)
    if problems:
        raise AssertionError("; ".join(problems))
    return out


def _fs_type(path: str) -> dict:
    """The filesystem that holds `path`: the longest mount point of
    /proc/mounts above its real path, with its type and device."""
    real = os.path.realpath(path)
    best = {"mount": None, "type": None, "device": None}
    with open("/proc/mounts") as f:
        for line in f:
            dev, mnt, fstype = line.split()[:3]
            mnt = mnt.replace("\\040", " ")
            if (real == mnt or real.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) >= len(best["mount"] or ""):
                best = {"mount": mnt, "type": fstype, "device": dev}
    return best


def _fsync_probe_ms(path: str, reps: int = 5) -> list:
    """`reps` times: one 4 KiB os.write and os.fsync of a new file in
    directory `path` -> the ms each took (on tmpfs an fsync costs
    nothing)."""
    out = []
    for i in range(reps):
        name = os.path.join(path, f"fsync-probe-{i}")
        fd = os.open(name, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            t0 = time.perf_counter()
            os.write(fd, b"\xa5" * 4096)
            os.fsync(fd)
            out.append((time.perf_counter() - t0) * 1e3)
        finally:
            os.close(fd)
            os.unlink(name)
    return out


def _ro_read(net, cid: int, rid: int, key: bytes, forged: bool,
             timeout: float = 10.0):
    """One READ_ONLY request for `key` from client `cid` straight to the
    read-only replica `rid` over the network's transport, signed with the
    client's key (or a zero signature where `forged`) -> (the value its
    reply carries or None without a reply, the round-trip ms)."""
    import threading

    from tpubft_torch.apps import skvbc
    from tpubft_torch.apps.simple_test import endpoint_table
    from tpubft_torch.comm.interfaces import IReceiver
    from tpubft_torch.consensus import messages as m
    from tpubft_torch.consensus.keys import ClusterKeys
    from tpubft_torch.crypto.cpu import Ed25519Signer
    keys = ClusterKeys.generate(net._node_cfg(), net.num_clients,
                                seed=net.seed.encode()).for_node(cid)
    req = m.ClientRequestMsg(
        sender_id=cid, req_seq_num=int(time.time() * 1e6),
        flags=int(m.RequestFlag.READ_ONLY),
        request=skvbc.pack(skvbc.ReadRequest(read_version=skvbc.READ_LATEST,
                                             keys=[key])),
        cid=f"ro-read-{cid}", signature=bytes(64))
    if not forged:
        req.signature = Ed25519Signer.generate(
            seed=keys.my_sign_seed).sign(req.signed_payload())
    got = threading.Event()
    replies = []

    class _Sink(IReceiver):
        def on_new_message(self, sender, data):
            if sender == rid:
                replies.append(data)
                got.set()
    comm = net._make_comm(cid, endpoint_table(
        net.base_port, net.n + net.num_ro, net.num_clients))
    comm.start(_Sink())
    try:
        t0 = time.perf_counter()
        comm.send(rid, req.pack())
        got.wait(timeout)
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        comm.stop()
    if not replies:
        return None, ms
    reply = m.unpack(replies[0])
    return dict(skvbc.unpack(reply.reply).reads).get(key), ms


def _ro_follows(net, rid: int, up, min_anchor: int, timeout: float) -> dict:
    """Wait until the read-only replica `rid` has transferred and
    archived up to the last stable checkpoint of the replicas `up` (the
    load stopped: no checkpoint comes after it), at `min_anchor` or past
    it; -> its gauges then. Raises on the deadline."""
    gauges = {}

    def archived():
        stable = [net.metrics(r).get("replica", "gauges", "last_stable_seq")
                  for r in up]
        g = (net.metrics(rid).snapshot(timeout=1.0) or {}).get(
            "components", {}).get("ro_replica", {}).get("gauges", {})
        gauges.clear()
        gauges.update(g, cluster_stable=stable)
        if None in stable:
            return False
        anchor = g.get("last_anchor_seq", 0)
        return (anchor >= max(min_anchor, max(stable))
                and g.get("transferred_seq") == anchor
                and g.get("archived_to") == g.get("last_block") > 0)
    try:
        net.wait_for(archived, timeout=timeout, poll=0.1)
    except TimeoutError:
        raise AssertionError(f"the RO archive never reached the cluster's "
                             f"stable checkpoint: {gauges}")
    return dict(gauges)


def _ro_report(net, rid: int, gauges: dict, checkpoint_window: int,
               problems: list) -> dict:
    """The read-only replica's state transfer, archive and device work,
    read over its metrics and diagnostics servers (it runs no consensus:
    no health section); its problems go to `problems`."""
    from tpubft_torch.utils.config import ReplicaConfig
    snap = net.metrics(rid).snapshot(timeout=5.0) or {}
    comps = snap.get("components", {})
    st = comps.get("state_transfer", {})
    counters = st.get("counters", {})
    devinfo = json.loads(net.status(rid, "device"))
    kernels = json.loads(net.status(rid, "kernels"))
    ro = {"anchor_seq": gauges["last_anchor_seq"],
          "last_block": gauges["last_block"],
          "archived_to": gauges["archived_to"],
          "blocks_fetched": counters.get("blocks_fetched"),
          "device_digest_batches": counters.get("device_digest_batches"),
          "scalar_digests": counters.get("scalar_digests"),
          "device_digest_failures": counters.get("device_digest_failures"),
          "st_blocks_per_sec_gauge": st.get("gauges", {}).get(
              "st_blocks_per_sec"),
          "launches": {k: v for k, v in devinfo["launches"].items() if v},
          "section_calls": {k: v["calls"] for k, v in kernels.items()},
          "device": devinfo["device"],
          "memory_reserved": devinfo["memory_reserved"],
          "netio_fallbacks": comps.get("udp", {}).get("counters", {}).get(
              "netio_fallbacks")}
    ro["sha256_launches"] = ro["launches"].get("sha256", 0)
    # the RO's state transfer hashes a window below this many blocks on
    # the host: at most one partial window a transfer, one a checkpoint
    threshold = ReplicaConfig().st_device_digest_threshold
    transfers = max(1, gauges["last_anchor_seq"] // checkpoint_window)
    if not ro["device_digest_batches"]:
        problems.append("the RO digested no window on the card")
    if (ro["scalar_digests"] or 0) >= threshold * transfers:
        problems.append(f"the RO hashed {ro['scalar_digests']} blocks on "
                        "the host")
    if ro["sha256_launches"] < (ro["device_digest_batches"] or 1):
        problems.append(f"RO sha256 launches {ro['launches']}")
    if ro["device_digest_failures"] or ro["netio_fallbacks"]:
        problems.append(f"RO: {ro['device_digest_failures']} device digest "
                        f"failures, {ro['netio_fallbacks']} netio fallbacks")
    if not str(ro["device"]).startswith("cuda"):
        problems.append(f"the RO ran on {ro['device']}")
    return ro


def _ro_audit(audit, db_path: str, key: bytes, value, last_block: int,
              problems: list) -> dict:
    """The archive in the object store `audit` against the replica's
    kvlog at `db_path` (ReadOnlyReplica.verify_archive's checks): every
    `blocks/` object is the replica's raw block, its `digests/` object
    that block's digest and the SHA-256 of the object, the blocks
    contiguous from 1; and the RO's answer `value` for `key` is the
    replica's as of `last_block`."""
    import hashlib

    from tpubft_torch.kvbc import create_blockchain
    from tpubft_torch.kvbc.readonly import digest_key
    from tpubft_torch.storage.native import NativeDB
    keys = list(audit.list("blocks/"))
    ok = bad = 0
    db = NativeDB(db_path)
    try:
        bc = create_blockchain(db, use_device_hashing=False)
        for k in keys:
            b = int(k.split("/")[1])
            raw, dig = audit.get(k), audit.get(digest_key(b))
            if (raw is None or dig is None or raw != bc.get_raw_block(b)
                    or dig != bc.block_digest(b)
                    or hashlib.sha256(raw).digest() != dig):
                bad += 1
            else:
                ok += 1
        head = bc.last_block_id
        want = bc.get_versioned("kv", key, last_block)
    finally:
        db.close()
    if value != want:
        problems.append(f"RO read {value!r} for {key!r}, the replica's "
                        f"ledger {want!r} at block {last_block}")
    if bad or ok < last_block or ok == 0 or keys != [
            f"blocks/{b:020d}" for b in range(1, len(keys) + 1)]:
        problems.append(f"archive audit: {ok} verified, {bad} failed, "
                        f"{len(keys)} objects")
    return {"objects": len(keys), "verified": ok, "failures": bad,
            "replica0_head": head, "read_equal_to_acknowledged":
                value == want}


def _preexec_counts(net, replicas) -> dict:
    """Each replica's pre-execution counters (its `preexec` metrics
    component), its SigManager's verifies dispatched to the device and
    verified on the host, and its verify kernel's launches, read over its
    metrics and diagnostics servers."""
    out = {}
    for r in replicas:
        snap = net.metrics(r).snapshot(timeout=5.0) or {}
        comps = snap.get("components", {})
        pre = comps.get("preexec", {}).get("counters", {})
        sig = comps.get("signature_manager", {}).get("counters", {})
        launches = json.loads(net.status(r, "device") or "{}").get(
            "launches", {})
        out[r] = {**{k: pre.get("preexec_" + k, 0) for k in (
                      "sessions", "agreed", "fallbacks", "conflicts",
                      "applied")},
                  "device_verifies": sig.get("sigs_device_dispatched", 0),
                  "host_verifies": sig.get("scalar_fallbacks", 0),
                  "verify_launches": launches.get("ed25519_verify", 0)}
    return out


def _preexec_step(cl, writes_n: int, reads: int, seed: int,
                  budget_s: float) -> dict:
    """Pre-execution on `cl`'s replica processes (started with
    --pre-execution). The closed-loop clients write `writes_n` kvbcbench
    writes flagged PRE_PROCESS (each executed speculatively by the
    replicas, f+1 signed result digests collected by the primary, the
    wrapper ordered and applied at commit); `reads` of their keys, chosen
    by `seed`, read back. Then client 0's conflict triple on a fresh key
    (tests/test_apollo_extended.py:131-146), all three pre-executed: a
    write, a conditional write at its block (succeeds), a stale one at
    the same block (fails: a conflict at commit, ordered normally in its
    slot), and the read returns the second's value. The four
    last_executed agree. Checked on the counters' growth over the step,
    read from every process just before and just after it: sessions and
    agreements (summed: the primary holds them) at least the writes
    sent, none expired (sessions = agreed + fallbacks), one conflict in
    each replica; the verify launches (`total["verify_launches"]`, which
    the caller holds above 0 on the card) and the SigManagers' device
    and host verifies beside them. -> the step's numbers, with
    `blocks_beside_loop`, the blocks the triple added, and the agreed
    `last_executed`. A load that fails raises; the rest are problems."""
    net, writes, problems = cl.net, cl.writes, cl.problems
    before = _preexec_counts(net, range(net.n))
    writes.pre_process, writes.log = True, []
    try:
        load = cl.loop.run(lambda n: n >= writes_n, budget_s=budget_s)
    finally:
        writes.pre_process = False
        logged, writes.log = writes.log, None
    if cl.loop.errors or load["committed"] < writes_n:
        raise AssertionError(f"pre-executed load: {load['committed']} of "
                             f"{writes_n} writes, {cl.loop.errors[:3]}")
    import numpy as np
    keys = sorted({k for _b, ws, _t in logged for k, _v in ws})
    rng = np.random.default_rng(seed)
    sample = [keys[i] for i in rng.choice(len(keys), size=min(
        reads, len(keys)), replace=False)]
    wrong = cl.read_back(sample)
    kv, key = cl.kvs[0], b"preexec/acct"
    triple = [kv.write([(key, b"100")], pre_process=True,
                       timeout_ms=30000)]
    v1 = triple[0].latest_block
    for value in (b"90", b"80"):
        triple.append(kv.write([(key, value)], readset=[key],
                               read_version=v1, pre_process=True,
                               timeout_ms=30000))
    read = kv.read([key], timeout_ms=30000)
    le = _equal_last_executed(net, range(net.n), timeout=30)
    after = _preexec_counts(net, range(net.n))
    grew = {r: {k: after[r][k] - before[r][k] for k in after[r]}
            for r in after}
    total = {k: sum(g[k] for g in grew.values()) for k in grew[0]}
    sent = len(logged) + len(triple)
    out = {"writes_sent": sent, "load": load,
           "read_back": {"keys": len(sample), "wrong": len(wrong)},
           "triple": [t.success for t in triple],
           "triple_read": {k.decode(): v.decode() for k, v in read.items()},
           "grew": grew, "total": total,
           "expired": (total["sessions"] - total["agreed"]
                       - total["fallbacks"]),
           "blocks_beside_loop": sum(t.success for t in triple),
           "last_executed": le}
    if len(sample) < min(reads, len(keys)) or wrong:
        problems.append(f"pre-executed read-back: {len(wrong)} of "
                        f"{len(sample)} keys wrong")
    if out["triple"] != [True, True, False] or read != {key: b"90"}:
        problems.append(f"conflict triple: {out['triple']}, read {read}")
    if total["sessions"] < sent or total["agreed"] < sent:
        problems.append(f"pre-execution: {total['sessions']} sessions, "
                        f"{total['agreed']} agreed for {sent} writes")
    if out["expired"]:
        problems.append(f"{out['expired']} pre-execution sessions expired")
    if any(g["conflicts"] != 1 for g in grew.values()):
        problems.append("pre-execution conflicts: "
                        f"{[g['conflicts'] for g in grew.values()]}")
    return out


def phase_persistent_cluster(torch, dev, process_cluster=None,
                             clients: int = 16, target: int = 600,
                             reads: int = 120, more: int = 200,
                             preexec_writes: int = 320,
                             device_min_verify_batch: int = 4,
                             checkpoint_window: int = 150,
                             work_window: int = 300, min_anchor: int = 300,
                             budget_s: float = 150.0) -> dict:
    """Config 1 as BASELINE.md's process rows deploy it, on persistent
    ledgers (benchmarks/bench_e2e.py:284-287 runs them with db_dir),
    with one read-only replica archiving the chain: four replica OS
    processes over UDP from testing.BftTestNetwork(db_dir=..., num_ro=1)
    on the card, each with its own kvlog (replica-<id>.kvlog, the port's
    NativeDB over native/kvlog.cpp) in a temporary directory, every
    setting at ReplicaConfig()'s defaults (db_sync_writes off, the
    consensus-metadata families fsynced) but `device_min_verify_batch`
    4, as process_cluster and for its reason, and pre-execution on
    (`--pre-execution`, as tests/test_apollo_extended.py:124-146 runs
    it). `clients` closed-loop SkvbcClients in this process write
    kvbcbench blocks. Beside them one
    `python -m tpubft_torch.apps.ro_replica --device cuda` process (id
    4, BftTestNetwork.start_ro_replica) archives over SigV4 to the
    port's testing.S3TestServer, started in this process (the secret in
    the RO's environment, never on its command line).

    1. Where the files live: the DB directory's filesystem type
       (/proc/mounts) and the ms of 4 KiB write + fsync probes there.
    2. Load until `target` writes commit; `reads` acknowledged keys
       chosen by the seed read back; the four last_executed agree. These
       writes are not flagged PRE_PROCESS: the preprocessor never sees
       them.
    2b. Pre-execution (`_preexec_step`): `preexec_writes` writes flagged
       PRE_PROCESS from the same clients, every one acknowledged, a
       seeded sample read back; client 0's conflict triple (success,
       success, failure; the read gives the second's value); sessions
       and agreements summed over the four processes at least the
       writes sent, none expired, one conflict in each replica, and the
       verify kernel launched during the step (its launches and the
       SigManagers' host verifies printed; the rate and latency printed
       beside the first load's).
    3. Replica 3 is SIGKILLed; the load goes on until the others'
       stable checkpoint is more than the work window past replica 3's
       last_executed (and at `min_anchor` or past it).
    4. The read-only replica (anchored on f+1 matching signed
       checkpoints, fetching each anchor's blocks by state transfer,
       its full windows digested on the card) has transferred and
       archived up to that stable checkpoint. One signed READ_ONLY
       request, from a client id that is not writing, for a key of
       client 0's first write: the RO answers it with the value
       acknowledged as of its last block (read from replica 0's file
       after the run) and `served_reads` is 1; a forged read (a zero
       signature) gets no answer and `served_reads` stays 1. Its
       state_transfer `device_digest_batches` > 0, `scalar_digests`
       below the device threshold a transfer, its SHA-256 launches at
       least its device windows, no device digest failure, no netio
       fallback. The RO stops here (no checkpoint forms while the load
       is stopped, so it is idle).
    5. Replica 3 restarts on its own file while the load goes on. Its
       first metrics read must be its last_executed from before the
       kill (not 0); it catches up by state transfer (its SHA-256
       section has calls); it fetches no block it kept: at most the
       blocks committed since the kill (within the gap plus one
       checkpoint window, and well below the others' height, which an
       empty restart would fetch); the four last_executed agree.
    6. The load stops; all four replica processes are SIGKILLed at once
       and restarted on their files: each first reads back its
       last_executed from before; every sampled acknowledged key and
       the last acknowledged write of every client read back; `more`
       writes commit; the four last_executed agree.
    7. After stop_all this process opens each kvlog file with the port's
       NativeDB under the port's blockchain (testing.network.
       ledger_files): every ledger holds exactly the acknowledged writes
       (the pre-executed ones and the triple's two successes among them)
       and blocks 1..min(last block id) are equal raw bytes in the four
       files. An independent S3ObjectStore lists the archive: every
       object equals replica 0's raw block and digest (0 failures).
    8. From every replica process (metrics and diagnostics servers), as
       process_cluster reads them: signatures dispatched to the device,
       no degraded verify, health healthy with every breaker closed, a
       verify device section, no netio fallback, each wrapper's
       launches and the CUDA memory it holds.

    Printed beside process_cluster's in-memory rate (same run): the
    first load's rate and latency, each restart's seconds to up,
    replica 3's recovered last_executed, blocks fetched and catch-up
    seconds, and the file sizes; under `ro_replica` the anchor seq, the
    blocks fetched and archived, the seconds from the load's end until
    the archive reached the anchor, the device digest batches and the
    read's round-trip ms. The verify and SHA-256 launches are summed
    over every replica process before each kill and at the end; the
    RO's SHA-256 launches apart."""
    import shutil
    import signal
    import tempfile

    import numpy as np

    from tpubft_torch.storage.s3 import S3ObjectStore
    from tpubft_torch.testing.network import BftTestNetwork, ledger_files
    from tpubft_torch.testing.s3server import S3TestServer

    t_phase = time.monotonic()
    db_dir = tempfile.mkdtemp(prefix="chip-smoke-persist-")
    ak, sk = "chip-smoke-ak", "chip-smoke-sk"
    s3 = S3TestServer(access_key=ak, secret_key=sk).start()
    try:
        out = {"phase": "persistent_cluster", "n": 4, "f": 1,
               "clients": clients, "transport": "udp",
               "checkpoint_window": checkpoint_window,
               "work_window": work_window,
               "device_min_verify_batch": device_min_verify_batch,
               "num_ro": 1, "archive": "s3 (SigV4)",
               "min_anchor": min_anchor,
               "db_fs": _fs_type(db_dir),
               "fsync_probe_ms": _fsync_probe_ms(db_dir)}
        emit({"phase": "persistent_cluster", "step": "files",
              "db_fs": out["db_fs"],
              "fsync_probe_ms": out["fsync_probe_ms"]})
        log_dir = os.path.join(db_dir, "logs")
        # one client principal more than write: the read-only request's
        net = BftTestNetwork(f=1, num_clients=clients + 1, num_ro=1,
                             seed="chip-smoke-persist", device="cuda",
                             db_dir=db_dir, log_dir=log_dir,
                             checkpoint_window=checkpoint_window,
                             work_window=work_window,
                             device_min_verify_batch=device_min_verify_batch,
                             pre_execution=True)
        cl = _ProcessCluster("persistent_cluster", net, clients, out)
        problems, earlier = cl.problems, []
        steps = out["steps_s"] = {}
        try:
            t0 = time.monotonic()
            cl.start()
            rid = net.start_ro_replica(
                0, extra_args=["--s3-endpoint", s3.endpoint,
                               "--s3-bucket", "archive",
                               "--s3-access-key", ak],
                extra_env={"TPUBFT_S3_SECRET": sk})
            steps["start"] = time.monotonic() - t0   # the RO comes up

            # ---- 2. load, read-back ----
            t0 = time.monotonic()
            cl.load(target, reads, seed=13, budget_s=budget_s * 0.15)
            steps["load"] = time.monotonic() - t0
            writes = cl.writes

            # ---- 2b. pre-execution ----
            t0 = time.monotonic()
            pre = out["preexec"] = _preexec_step(
                cl, preexec_writes, reads, seed=17, budget_s=budget_s * 0.2)
            steps["preexec"] = time.monotonic() - t0
            pre["first_load"] = {k: out["load"][k] for k in (
                "requests_per_s", "commit_latency_ms")}
            emit({"phase": "persistent_cluster", "step": "preexec", **pre})
            if pre["total"]["verify_launches"] < 1:
                problems.append("no verify launch during the pre-executed "
                                "load")
            # the blocks of writes made apart from the closed loop
            blocks_beside = pre["blocks_beside_loop"]
            le = pre["last_executed"]
            blocks_at_kill = sum(writes.next_write) + blocks_beside
            earlier.append(_replica_report(net, 3))   # its counts die with it

            # ---- 3. replica 3 crashes ----
            t0 = time.monotonic()
            behind = cl.kill_behind(
                3, min_stable=max(le[3] + net.work_window + 1, min_anchor),
                min_writes=0, budget_s=budget_s * 0.4)
            steps["behind"] = time.monotonic() - t0

            # ---- 4. the read-only replica ----
            t0 = time.monotonic()
            net.wait_for_replicas_up(replicas=[rid], timeout=120)
            gauges = _ro_follows(net, rid, (0, 1, 2), min_anchor,
                                 timeout=budget_s * 0.3)
            steps["ro_archive_wait"] = time.monotonic() - t0
            # a key of client 0's first write: on the RO's chain, which
            # ends at its anchor's block
            ro_key = b"c000/" + writes.rows[0][0][1]
            reader = net.n + net.num_ro + clients    # never writes
            value, read_ms = _ro_read(net, reader, rid, ro_key,
                                      forged=False)
            served = net.metrics(rid).get("ro_replica", "counters",
                                          "served_reads")
            forged_value, _ = _ro_read(net, reader, rid, ro_key,
                                       forged=True, timeout=1.0)
            served_after = net.metrics(rid).get("ro_replica", "counters",
                                                "served_reads")
            ro = out["ro_replica"] = _ro_report(net, rid, gauges,
                                                checkpoint_window, problems)
            ro.update(archive_wait_s=steps["ro_archive_wait"],
                      read={"key": ro_key.decode(),
                            "round_trip_ms": read_ms,
                            "served_reads": served,
                            "forged_answered": forged_value is not None,
                            "served_reads_after_forged": served_after})
            net.kill_replica(rid)
            emit({"phase": "persistent_cluster", "step": "ro_replica",
                  **ro})
            if value is None or served != 1:
                problems.append(f"RO read: {value!r} for {ro_key!r}, "
                                f"served_reads {served}")
            if forged_value is not None or served_after != 1:
                problems.append(f"the RO answered a forged read "
                                f"({served_after} served)")

            # ---- 5. replica 3 restarts on its own file ----
            one = cl.restart_under_load(3, min_fetched=1,
                                        min_seq=behind["stable"],
                                        budget_s=budget_s * 0.3)
            steps["restart_one"] = one["catch_up_s"]
            rep3 = _replica_report(net, 3)
            height = sum(writes.next_write) + blocks_beside
            fetched = rep3["blocks_fetched"] or 0
            # writes per sequence number so far: one checkpoint window's
            # blocks
            window_blocks = int(np.ceil(checkpoint_window * height
                                        / max(1, one["last_executed"][0])))
            one.update(last_executed_before_kill=le[3],
                       blocks_fetched=fetched, blocks_at_kill=blocks_at_kill,
                       height_after=height, gap_blocks=height - blocks_at_kill,
                       window_blocks=window_blocks,
                       device_digest_windows=rep3["device_digest_batches"],
                       sha256_section_calls=rep3["section_calls"].get(
                           "sha256"))
            out["restart_one"] = one
            emit({"phase": "persistent_cluster", "step": "restart_one",
                  **one})
            first_le = one["first_read_last_executed"]
            if first_le != le[3] or not first_le:
                problems.append(f"replica 3 came back at last_executed "
                                f"{first_le}, not its {le[3]}")
            if not rep3["section_calls"].get("sha256"):
                problems.append("replica 3 ran no SHA-256 section")
            # it links onto the chain it kept: at most the blocks committed
            # since the kill (within the gap plus a window, and well below
            # the others' height, which an empty restart would fetch)
            if not 0 < fetched <= height - blocks_at_kill:
                problems.append(f"replica 3 fetched {fetched} blocks: the "
                                f"gap was {height - blocks_at_kill} of "
                                f"{height}")

            # ---- 6. the whole cluster crashes ----
            t0 = time.monotonic()
            earlier += [_replica_report(net, r) for r in range(4)]
            le_before = _equal_last_executed(net, range(4), timeout=30)
            for r in range(4):
                net.procs[r].send_signal(signal.SIGKILL)
            for r in range(4):
                net.kill_replica(r)
            for r in range(4):
                net.start_replica(r)
            firsts = {r: net.first_answer(r) for r in range(4)}
            steps["restart_all"] = time.monotonic() - t0
            lasts = [b"c%03d/" % i + key for i in range(clients)
                     if writes.next_write[i]
                     for _c, key, _v, _t in writes.rows[
                         (writes.next_write[i] - 1) % len(writes.rows)]]
            wrong_sample = cl.read_back(cl.sample)
            wrong_last = cl.read_back(lasts)
            t0 = time.monotonic()
            after = cl.loop.run(lambda n: n >= more,
                                budget_s=budget_s * 0.15)
            steps["after"] = time.monotonic() - t0
            le_end = _equal_last_executed(net, range(4), timeout=60)
            out["restart_all"] = {
                "last_executed_before": le_before,
                "first_read_last_executed": {r: v[0] for r, v in
                                             firsts.items()},
                "up_s": {r: v[1] for r, v in firsts.items()},
                "read_back": {"sampled": len(cl.sample),
                              "sampled_wrong": len(wrong_sample),
                              "clients_last_write_keys": len(lasts),
                              "last_write_wrong": len(wrong_last)},
                "load_after": after, "last_executed": le_end}
            emit({"phase": "persistent_cluster", "step": "restart_all",
                  **out["restart_all"]})
            if [v[0] for v in firsts.values()] != le_before:
                problems.append(f"the cluster came back at "
                                f"{[v[0] for v in firsts.values()]}, not "
                                f"{le_before}")
            if wrong_sample or wrong_last:
                problems.append(f"after the crash {len(wrong_sample)} "
                                f"sampled and {len(wrong_last)} last-write "
                                "keys wrong")
            if cl.loop.errors or after["committed"] < more:
                problems.append(f"after the crash {after['committed']} of "
                                f"{more} writes, {cl.loop.errors[:3]}")

            # ---- 8. what each process ran ----
            reports = {r: _replica_report(net, r) for r in range(4)}
            out["replicas"] = reports
            cl.check_processes(reports, earlier=earlier)
        finally:
            net.stop_all()
            if problems or sys.exc_info()[0] is not None:
                _print_log_tails(log_dir)

        # ---- 7. the files and the archive ----
        files = ledger_files(db_dir, range(4))
        out["files"] = files
        acked = sum(writes.next_write) + blocks_beside
        if set(files["last_block_id"].values()) != {acked}:
            problems.append(f"ledgers hold {files['last_block_id']} "
                            f"blocks, {acked} writes were acknowledged")
        if files["first_unequal_block"] is not None:
            problems.append(f"block {files['first_unequal_block']} differs "
                            "between the replicas' files")
        ro["audit"] = _ro_audit(
            S3ObjectStore(s3.endpoint, "archive", access_key=ak,
                          secret_key=sk),
            os.path.join(db_dir, "replica-0.kvlog"), ro_key, value,
            ro["last_block"], problems)
        emit({"phase": "persistent_cluster", "step": "ro_audit",
              **ro["audit"]})
    finally:
        s3.stop()
        shutil.rmtree(db_dir, ignore_errors=True)
    if process_cluster is not None:
        out["beside_in_memory"] = {
            "persistent_requests_per_s": out["load"]["requests_per_s"],
            "persistent_commit_latency_ms": out["load"][
                "commit_latency_ms"],
            "in_memory_requests_per_s": process_cluster["load"][
                "requests_per_s"],
            "in_memory_commit_latency_ms": process_cluster["load"][
                "commit_latency_ms"],
            "in_memory_clients": process_cluster["clients"]}
    return cl.finish(t_phase)


def _snapshot_cli(*argv) -> tuple:
    """One command of the port's snapshot CLI (python -m
    tpubft_torch.tools.snapshot ... --kvbc-version v4) -> (its JSON line,
    its seconds); raises if it fails."""
    from tpubft_torch.apps.simple_test import child_env
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "tpubft_torch.tools.snapshot", *argv,
         "--kvbc-version", "v4"], capture_output=True, text=True,
        timeout=300, cwd=HERE, env=child_env())
    s = time.monotonic() - t0
    if out.returncode != 0:
        raise AssertionError(f"snapshot {argv[0]}: exit {out.returncode}: "
                             f"{out.stdout[-400:]} {out.stderr[-800:]}")
    return json.loads(out.stdout.strip().splitlines()[-1]), s


def phase_v4_cluster(torch, dev, persistent_cluster=None,
                     clients: int = 16, target: int = 600,
                     reads: int = 120, device_min_verify_batch: int = 4,
                     checkpoint_window: int = 150, work_window: int = 300,
                     budget_s: float = 150.0) -> dict:
    """Config 1 on the v4 ledger engine (--kvbc-version v4), with snapshot
    provisioning: persistent_cluster's four replica processes on their
    own kvlog files, over UDP on the card, `clients` closed-loop
    SkvbcClients writing kvbcbench blocks, device_min_verify_batch 4,
    the checkpoint and work windows at their defaults.

    1. Load until `target` writes commit; `reads` acknowledged keys
       chosen by the seed read back; the four last_executed agree.
    2. Replica 3 is SIGKILLed; the load goes on until the others' stable
       checkpoint is more than the work window past replica 3's
       last_executed.
    3. The port's snapshot CLI (python -m tpubft_torch.tools.snapshot
       --kvbc-version v4) on replica 3's file: `create`, then `verify`
       ("ok": true) and `restore` into a fresh file ("digest_ok": true)
       side by side (both only read the snapshot), the restored file
       taking the kvlog's place.
    4. Replica 3 restarts on the provisioned ledger while the load goes
       on. The snapshot leaves out the consensus metadata, so it starts
       at last_executed 0 with the snapshot's blocks; it catches up by
       state transfer (its SHA-256 section has calls), fetching only the
       gap: no more blocks than were committed after the snapshot's head,
       and fewer than the others' height. The four last_executed agree
       and every sampled key reads back.
    5. After stop_all the four files open under the port's v4 engine
       (testing.network.ledger_files): every block's raw bytes and digest
       equal in the four, up to the shortest head, which holds every
       acknowledged write.
    6. From every process, as process_cluster reads them: signatures
       dispatched to the card, no degraded verify, health healthy with
       every breaker closed, a verify device section, no netio fallback,
       each wrapper's launches (the verify launches of each process are
       printed).

    Printed: requests/s and commit latency p50/p90/p99 (beside
    persistent_cluster's on the categorized engine), the snapshot's
    entries and bytes and the CLI's seconds a command, the blocks
    fetched and the catch-up seconds, each step's seconds."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from tpubft_torch.testing.network import BftTestNetwork, ledger_files

    t_phase = time.monotonic()
    db_dir = tempfile.mkdtemp(prefix="chip-smoke-v4-")
    try:
        out = {"phase": "v4_cluster", "n": 4, "f": 1, "clients": clients,
               "transport": "udp", "kvbc_version": "v4",
               "checkpoint_window": checkpoint_window,
               "work_window": work_window,
               "device_min_verify_batch": device_min_verify_batch}
        log_dir = os.path.join(db_dir, "logs")
        net = BftTestNetwork(f=1, num_clients=clients, seed="chip-smoke-v4",
                             device="cuda", db_dir=db_dir, log_dir=log_dir,
                             checkpoint_window=checkpoint_window,
                             work_window=work_window,
                             device_min_verify_batch=device_min_verify_batch,
                             kvbc_version="v4")
        cl = _ProcessCluster("v4_cluster", net, clients, out)
        problems, earlier = cl.problems, []
        steps = out["steps_s"] = {}
        try:
            t0 = time.monotonic()
            cl.start()
            steps["start"] = time.monotonic() - t0

            # ---- 1. load, read-back ----
            t0 = time.monotonic()
            le = cl.load(target, reads, seed=17, budget_s=budget_s * 0.15)
            steps["load"] = time.monotonic() - t0
            writes = cl.writes
            earlier.append(_replica_report(net, 3))   # its counts die with it

            # ---- 2. replica 3 crashes and falls behind ----
            t0 = time.monotonic()
            behind = cl.kill_behind(3, min_stable=le[3] + net.work_window + 1,
                                    min_writes=0, budget_s=budget_s * 0.4)
            steps["behind"] = time.monotonic() - t0

            # ---- 3. snapshot provisioning ----
            path = os.path.join(db_dir, "replica-3.kvlog")
            snap = os.path.join(db_dir, "replica-3.snap")
            made, create_s = _snapshot_cli("create", path, snap)
            with ThreadPoolExecutor(2) as pool:
                verifying = pool.submit(_snapshot_cli, "verify", snap)
                restoring = pool.submit(_snapshot_cli, "restore", snap,
                                        path + ".provisioned")
                checked, verify_s = verifying.result()
                restored, restore_s = restoring.result()
            out["snapshot"] = {
                "head_block": made["head_block"], "entries": made["entries"],
                "bytes": os.path.getsize(snap),
                "kvlog_bytes": os.path.getsize(path + ".provisioned"),
                "verify_ok": checked["ok"],
                "digest_ok": restored["digest_ok"],
                "cli_s": {"create": create_s, "verify": verify_s,
                          "restore": restore_s}}
            emit({"phase": "v4_cluster", "step": "snapshot",
                  **out["snapshot"]})
            if checked["ok"] is not True or restored["digest_ok"] is not True:
                raise AssertionError(f"snapshot: verify {checked}, restore "
                                     f"{restored}")
            os.replace(path + ".provisioned", path)

            # ---- 4. restart on the provisioned ledger ----
            one = cl.restart_under_load(3, min_fetched=1,
                                        min_seq=behind["stable"],
                                        budget_s=budget_s * 0.3)
            steps["restart"] = one["catch_up_s"]
            rep3 = _replica_report(net, 3)
            height = sum(writes.next_write)
            fetched = rep3["blocks_fetched"] or 0
            wrong = cl.read_back(cl.sample)
            one.update(snapshot_head_block=made["head_block"],
                       blocks_fetched=fetched, height_after=height,
                       gap_blocks=height - made["head_block"],
                       device_digest_windows=rep3["device_digest_batches"],
                       sha256_section_calls=rep3["section_calls"].get(
                           "sha256"),
                       read_back={"keys": len(cl.sample),
                                  "wrong": len(wrong)})
            out["restart"] = one
            emit({"phase": "v4_cluster", "step": "restart", **one})
            if one["first_read_last_executed"] != 0:
                problems.append(f"the provisioned replica 3 came back at "
                                f"{one['first_read_last_executed']}, not 0")
            if not rep3["section_calls"].get("sha256"):
                problems.append("replica 3 ran no SHA-256 section")
            if not 0 < fetched <= height - made["head_block"] \
                    or fetched >= height:
                problems.append(f"replica 3 fetched {fetched} blocks: the "
                                f"gap was {height - made['head_block']} of "
                                f"{height}")
            if wrong:
                problems.append(f"{len(wrong)} sampled keys read back wrong "
                                "after the restart")

            # ---- 6. what each process ran ----
            reports = {r: _replica_report(net, r) for r in range(4)}
            out["replicas"] = reports
            out["verify_launches_by_process"] = {
                r: rep["launches"].get("ed25519_verify", 0)
                for r, rep in reports.items()}
            cl.check_processes(reports, earlier=earlier)
        finally:
            net.stop_all()
            if problems or sys.exc_info()[0] is not None:
                _print_log_tails(log_dir)

        # ---- 5. the files themselves ----
        files = ledger_files(db_dir, range(4), version="v4")
        out["files"] = files
        acked = sum(writes.next_write)
        if min(files["last_block_id"].values()) != acked:
            problems.append(f"ledgers hold {files['last_block_id']} "
                            f"blocks, {acked} writes were acknowledged")
        if files["first_unequal_block"] is not None:
            problems.append(f"block {files['first_unequal_block']} differs "
                            "between the replicas' files")
    finally:
        shutil.rmtree(db_dir, ignore_errors=True)
    if persistent_cluster is not None:
        out["beside_categorized"] = {
            "v4_requests_per_s": out["load"]["requests_per_s"],
            "v4_commit_latency_ms": out["load"]["commit_latency_ms"],
            "categorized_requests_per_s": persistent_cluster["load"][
                "requests_per_s"],
            "categorized_commit_latency_ms": persistent_cluster["load"][
                "commit_latency_ms"]}
    return cl.finish(t_phase)


BLS_SLOTS = 64


def _bls_flush(verifier, jobs, max_batch: int = BLS_SLOTS,
               flush_us: int = 1_000_000) -> tuple:
    """The jobs' slots through consensus.collectors.CombineBatcher, as a
    replica's fused combine plane drains them: one ShareCollector a slot,
    submitted together; -> (CombineResults by slot, flush sizes). The
    window is long so that the 64 slots make one flush of
    combine_batch_max."""
    import threading

    from tpubft_torch.consensus.collectors import (CombineBatcher,
                                                   ShareCollector)
    results, flushes = {}, []
    done = threading.Event()

    def post(res):
        results[res.seq_num] = res
        if len(results) == len(jobs):
            done.set()
    cb = CombineBatcher(post, flush_us=flush_us, max_batch=max_batch,
                        on_flush=flushes.append)
    try:
        for seq, (d, shares) in enumerate(jobs):
            c = ShareCollector(0, seq, "commit", d, verifier)
            c.shares = dict(shares)
            cb.submit(c, dict(shares))
        if not done.wait(600):
            raise AssertionError(f"{len(results)} of {len(jobs)} slots "
                                 "came back from the combine plane")
    finally:
        cb.stop()
    return [results[s] for s in range(len(jobs))], flushes


def _bls_jobs(signers, threshold: int, slots: int, bad_slots, seed: int):
    """`slots` certificate slots of `threshold` shares each (signer sets
    rotating over the cluster); in each of `bad_slots` one share signs
    another message."""
    import hashlib
    n = len(signers)
    jobs = []
    for s in range(slots):
        d = hashlib.sha256(b"bls-slot-%d-%d" % (seed, s)).digest()
        ids = [(s + i) % n + 1 for i in range(threshold)]
        shares = {i: signers[i].sign_share(d) for i in ids}
        if s in bad_slots:
            shares[ids[1]] = signers[ids[1]].sign_share(b"forged" + d)
        jobs.append((d, shares))
    return jobs


def phase_bls_plane(torch, dev, slots: int = BLS_SLOTS) -> dict:
    """BLS certificates on the card through the user entry points:
    config 2's keys (n=7 f=2 c=0, threshold-bls, threshold 5) and 64
    slots through CombineBatcher -> CudaBlsThresholdVerifier.combine_batch
    (320 shares, one fused flush past the default crossover of 128, so
    one bls_msm launch), two slots with a bad share; the same under
    multisig-bls (all-ones scalars); config 4's shape (n=1000 f=333,
    threshold 667): one CudaBlsThresholdAccumulator combine (msm_kernel,
    S=1) and one batch_scalar_mul of its 667 shares. Every certificate
    byte-equal to the native host engine's (combine_shares / g1_msm) and
    verified; launch counts reset just before these paths, read after."""
    import random

    from tpubft_torch.consensus import keys as K
    from tpubft_torch.crypto import bls12381 as bls
    from tpubft_torch.crypto import bls_native
    from tpubft_torch.crypto import cuda as crypto_cuda
    from tpubft_torch.crypto import systems
    from tpubft_torch.crypto.interfaces import Cryptosystem
    from tpubft_torch.ops import bls12_381 as bops
    from tpubft_torch.ops import bls12_381_cuda as bc
    from tpubft_torch.ops.dispatch import device_breaker
    from tpubft_torch.utils.config import ReplicaConfig

    t_phase = time.monotonic()
    crossover = crypto_cuda.msm_crossover_k()
    cfg = ReplicaConfig(f_val=2, c_val=0, threshold_scheme="threshold-bls")
    t0 = time.monotonic()
    ck = K.ClusterKeys.generate(cfg, num_clients=0, seed=b"chip-smoke-bls")
    keygen_s = time.monotonic() - t0
    system = ck.slow_path_system
    k = system.threshold_
    assert (ck.n, ck.threshold_scheme, k) == (7, "threshold-bls", 5), \
        (ck.n, ck.threshold_scheme, k)
    signers = {r + 1: ck.threshold_signer(system, r) for r in range(ck.n)}
    bad_slots = (7, 40)
    jobs = _bls_jobs(signers, k, slots, bad_slots, seed=2)
    ms_sys = Cryptosystem("multisig-bls", k, ck.n, seed=b"chip-smoke-ms")
    ms_signers = {i: ms_sys.create_threshold_signer(i)
                  for i in range(1, ck.n + 1)}
    ms_jobs = _bls_jobs(ms_signers, k, slots, bad_slots, seed=3)
    # config 4's shape
    t0 = time.monotonic()
    big = Cryptosystem("threshold-bls", 667, 1000, seed=b"chip-smoke-c4")
    big_keygen_s = time.monotonic() - t0
    d4 = bytes(range(32))
    rng = random.Random(4)
    ids4 = sorted(rng.sample(range(1, 1001), 667))
    shares4 = {i: big.create_threshold_signer(i).sign_share(d4)
               for i in ids4}
    pts4 = [bls.g1_decompress(shares4[i]) for i in ids4]
    coeffs4 = bls.lagrange_coeffs_at_zero(ids4)

    thr_v = ck.threshold_verifier(system, backend="cuda")
    ms_v = crypto_cuda.make_threshold_verifier(
        "multisig-bls", k, ck.n, ms_sys.public_key, ms_sys.share_public_keys)
    big_v = crypto_cuda.make_threshold_verifier(
        "threshold-bls", 667, 1000, big.public_key, big.share_public_keys)
    host_thr = system.create_threshold_verifier()
    host_ms = ms_sys.create_threshold_verifier()
    breaker = device_breaker()
    breaker.reset()
    br0 = breaker.snapshot()
    bls_native.reset_counts()
    bc.reset_launches()
    steps = {}
    t0 = time.monotonic()
    thr_res, thr_flushes = _bls_flush(thr_v, jobs)
    steps["threshold_flush_ms"] = (time.monotonic() - t0) * 1e3
    thr_launches = bc.LAUNCHES["bls_msm"]
    t0 = time.monotonic()
    ms_res, ms_flushes = _bls_flush(ms_v, ms_jobs)
    steps["multisig_flush_ms"] = (time.monotonic() - t0) * 1e3
    ms_launches = bc.LAUNCHES["bls_msm"] - thr_launches
    acc = big_v.new_accumulator(False)
    acc.set_expected_digest(d4)
    for i in ids4:
        acc.add(i, shares4[i])
    t0 = time.monotonic()
    cert4 = acc.get_full_signed_data()
    steps["config4_combine_ms"] = (time.monotonic() - t0) * 1e3
    t0 = time.monotonic()
    muls = bops.batch_scalar_mul(pts4, coeffs4)
    steps["config4_scalar_mul_ms"] = (time.monotonic() - t0) * 1e3
    launches = dict(bc.LAUNCHES)
    br1 = breaker.snapshot()

    # the host engine's answers, byte for byte
    def thr_cert(d, shares):
        ids = sorted(shares)[:k]
        return bls.g1_compress(bls.combine_shares(
            ids, [bls.g1_decompress(shares[i]) for i in ids]))
    problems = []
    for name, res, jb, host_v in (("threshold", thr_res, jobs, host_thr),
                                  ("multisig", ms_res, ms_jobs, host_ms)):
        want = host_v.combine_batch(jb)
        got = [(r.ok, r.combined_sig, r.bad_shares) for r in res]
        if got != want:
            problems.append(f"{name} combine differs from the host classes")
        for s, ((d, shares), r) in enumerate(zip(jb, res)):
            if s in bad_slots:
                if r.ok or len(r.bad_shares) != 1:
                    problems.append(f"{name} slot {s}: {r.ok} "
                                    f"{r.bad_shares}")
                continue
            ids = sorted(shares)
            cert = thr_cert(d, shares) if name == "threshold" else \
                systems.pack_agg_cert(ids, bls.g1_msm(
                    [bls.g1_decompress(shares[i]) for i in ids],
                    [1] * len(ids)))
            if not r.ok or r.combined_sig != cert:
                problems.append(f"{name} slot {s} certificate differs from "
                                "the native engine's")
    certs = [(d, r.combined_sig) for (d, _), r in zip(jobs, thr_res)
             if r.ok]
    ms_certs = [(d, r.combined_sig) for (d, _), r in zip(ms_jobs, ms_res)
                if r.ok]
    verified = (all(thr_v.verify_batch_certs(certs))
                and all(ms_v.verify_batch_certs(ms_certs))
                and thr_v.verify(*certs[0]) and ms_v.verify(*ms_certs[0]))
    want4 = bls.g1_compress(bls.combine_shares(ids4, pts4))
    want_muls = [bls.g1_mul(p, c) for p, c in zip(pts4, coeffs4)]
    out = {"phase": "bls_plane", "n": ck.n, "f": ck.f, "c": ck.c,
           "scheme": ck.threshold_scheme, "threshold": k, "slots": slots,
           "shares_per_flush": slots * k, "bad_slots": list(bad_slots),
           "msm_crossover_k": crossover, "keygen_s": keygen_s,
           "config4": {"n": 1000, "f": 333, "threshold": 667,
                       "keygen_s": big_keygen_s},
           "steps": steps, "launches": launches,
           "launches_by_path": {"threshold_flush": thr_launches,
                                "multisig_flush": ms_launches,
                                "config4_combine": launches["bls_msm"]
                                - thr_launches - ms_launches,
                                "config4_scalar_mul": launches["bls_mul"]},
           "flush_sizes": {"threshold": thr_flushes,
                           "multisig": ms_flushes},
           "device_combines": [thr_v.device_combines, ms_v.device_combines,
                               big_v.device_combines],
           "host_combines": [thr_v.host_combines, ms_v.host_combines,
                             big_v.host_combines],
           "certs_verified": verified,
           "config4_cert_equal": cert4 == want4,
           "config4_cert_verified": big_v.verify(d4, cert4),
           "scalar_mul_mismatches": sum(g != w for g, w in
                                        zip(muls, want_muls)),
           "native_pairing_checks": bls_native.COUNTS["pairing_checks"],
           "native_fallbacks": bls_native.COUNTS["fallbacks"],
           "breaker": br1["state"],
           "breaker_failures": br1["failures"] - br0["failures"],
           "wall_s": time.monotonic() - t_phase}
    emit(out)
    if thr_flushes != [slots] or ms_flushes != [slots]:
        problems.append(f"flushes {thr_flushes} {ms_flushes}, not one of "
                        f"{slots} slots")
    if thr_launches != 1 or ms_launches != 1 \
            or launches["bls_msm"] != 3 or launches["bls_mul"] != 1:
        problems.append(f"launches {out['launches_by_path']}")
    if any(out["host_combines"]):
        problems.append(f"host combines {out['host_combines']}")
    if not verified or not out["config4_cert_equal"] \
            or not out["config4_cert_verified"]:
        problems.append("a certificate differs from the native engine's "
                        "or did not verify")
    if out["scalar_mul_mismatches"]:
        problems.append(f"{out['scalar_mul_mismatches']} scalar-mul "
                        "results differ from the native engine's")
    if out["native_fallbacks"]:
        problems.append(f"{out['native_fallbacks']} pure-Python answers: "
                        f"the native engine did not load "
                        f"({bls_native.load_error})")
    if out["breaker_failures"] or out["breaker"] != "closed":
        problems.append(f"device breaker {out['breaker']}")
    if problems:
        raise AssertionError("; ".join(problems))
    # config 2's keys and signers for the offload phase
    out["offload_inputs"] = {"system": system, "k": k, "signers": signers,
                             "ms_sys": ms_sys, "ms_signers": ms_signers,
                             "bad_jobs": jobs}
    out["segments"] = {
        "flush": [(ids_pts, bls.lagrange_coeffs_at_zero(ids))
                  for ids, ids_pts in (
                      (sorted(sh)[:k], [bls.g1_decompress(sh[i])
                                        for i in sorted(sh)[:k]])
                      for _, sh in jobs)],
        "config4": [(pts4, coeffs4)],
        "scalar_mul": (pts4, coeffs4)}
    return out


BLS_LEDGER_CONFIG = dict(
    LEDGER_REPLICA_CONFIG,
    # BASELINE config 2: simpleKVBC, 7 replicas (f=2), BLS threshold
    # certificates; everything else as the config-1 ledger replica
    threshold_scheme="threshold-bls")


class _Timed:
    """While open, each named function attribute of `owner` is wrapped to
    count its calls and sum their wall time (for where the host time of a
    phase goes; the native engine's calls run outside the interpreter
    lock, so their sums may overlap)."""

    def __init__(self, owner, *names):
        self.owner, self.names = owner, names
        self.calls = {n: 0 for n in names}
        self.s = {n: 0.0 for n in names}

    def __enter__(self):
        import threading
        lock = threading.Lock()
        self.real = {n: getattr(self.owner, n) for n in self.names}

        def wrap(name, fn):
            def timed(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    with lock:
                        self.calls[name] += 1
                        self.s[name] += time.perf_counter() - t0
            return timed
        for n, fn in self.real.items():
            setattr(self.owner, n, wrap(n, fn))
        return self

    def __exit__(self, *exc) -> None:
        for n, fn in self.real.items():
            setattr(self.owner, n, fn)

    def snapshot(self) -> dict:
        return {n: {"calls": self.calls[n], "s": self.s[n]}
                for n in self.names}


def _bls_combines(reps) -> dict:
    """Certificate combines on the MSM kernel and on the host engine,
    over every replica's BLS verifiers."""
    vs = [v for r in reps for v in (r.slow_verifier, r.thr_verifier,
                                     r.opt_verifier)]
    return {"device": sum(getattr(v, "device_combines", 0) for v in vs),
            "host": sum(getattr(v, "host_combines", 0) for v in vs)}


def phase_bls_ledger_replica(torch, dev, clients: int = 100,
                             target: int = 1000, reads: int = 120,
                             budget_s: float = 120.0) -> dict:
    """BASELINE config 2 as users deploy it (BASELINE.md:30,
    "simpleKVBC 7-replica (f=2), BLS threshold"): seven replicas of
    testing.InProcessCluster (f=2, c=0) with threshold-bls certificates,
    crypto_backend "cuda", the SKVBC app over the categorized ledger,
    file WALs, the durability pipeline at its defaults and state transfer
    as KvbcReplica configures it, the autotuner at its default. 100
    closed-loop clients write kvbcbench blocks until `target` commit,
    then `reads` keys are read back. Printed: commit latency, requests/s,
    certificate flushes and how many reached the MSM kernel at the
    default crossover, verify and MSM launches, the native engine's
    pairing checks."""
    import shutil
    import tempfile

    import numpy as np

    from tpubft_torch import testing
    from tpubft_torch.apps import skvbc
    from tpubft_torch.consensus.persistent import FilePersistentStorage
    from tpubft_torch.crypto import bls_native
    from tpubft_torch.crypto import cuda as crypto_cuda
    from tpubft_torch.kvbc import KeyValueBlockchain
    from tpubft_torch.ops import bls12_381_cuda as bc
    from tpubft_torch.ops import ed25519_cuda as kc
    from tpubft_torch.ops.dispatch import device_breaker
    from tpubft_torch.storage import MemoryDB
    from tpubft_torch.testing import InProcessCluster

    cfg = dict(BLS_LEDGER_CONFIG)
    t_phase = time.monotonic()
    wal_dir = tempfile.mkdtemp(prefix="chip-smoke-bls-wal-")

    def storage_factory(r):
        return FilePersistentStorage(os.path.join(wal_dir, f"r{r}.wal"))

    def handler_factory(_r=None):
        return skvbc.SkvbcHandler(KeyValueBlockchain(MemoryDB()))

    with _SigManagerCount() as sig:
        cluster = InProcessCluster(
            f=2, c=0, num_clients=clients, seed=b"chip-smoke-bls-ledger",
            handler_factory=handler_factory,
            storage_factory=storage_factory, cfg_overrides=cfg)
    rep0 = cluster.replicas[0]
    emit({"phase": "bls_ledger_replica", "step": "config", "n": cluster.n,
          "f": 2, "c": 0, "clients": clients, "target_requests": target,
          "read_back": reads, "budget_s": budget_s, "config": cfg,
          "scheme": rep0.keys.threshold_scheme,
          "thr_verifier": type(rep0.thr_verifier).__name__,
          "msm_crossover_k": crypto_cuda.msm_crossover_k(),
          "durability_pipeline": rep0.durability is not None,
          "autotune_enabled": rep0.cfg.autotune_enabled,
          "crypto_backend": rep0.crypto_backend,
          "st_config": vars(rep0.state_transfer.cfg),
          "wal": "FilePersistentStorage"})
    if rep0.keys.threshold_scheme != "threshold-bls":
        raise AssertionError(f"scheme {rep0.keys.threshold_scheme}")
    breaker = device_breaker()
    problems = []
    try:
        cluster.start()
        bft = [cluster.client(i) for i in range(clients)]
        for c in bft:
            c.start()
        kvs = [skvbc.SkvbcClient(c) for c in bft]
        writes = _KvbcbenchWrites(kvs, testing.kvbcbench_rows(64),
                                  timeout_ms=int(budget_s * 1000))
        loop = _ClosedLoop(clients, writes)
        reps = list(cluster.replicas.values())
        breaker.reset()
        br0 = breaker.snapshot()
        comb0 = _bls_combines(reps)
        bls_native.reset_counts()
        sig.calls = 0
        reset_all_launches()
        with _Timed(bls_native, "pairing_check", "g1_msm", "g1_decompress"
                    ) as native_t, _Timed(
                crypto_cuda.CudaBlsThresholdVerifier, "combine_batch",
                "verify_batch_certs") as cert_t:
            load = loop.run(lambda n: n >= target, budget_s=budget_s)
        comb = {k: v - comb0[k] for k, v in _bls_combines(reps).items()}
        load.update({
            "verify_launches": kc.LAUNCHES["ed25519_verify"],
            "sigmanager_launches": sig.calls,
            "bls_msm_launches": bc.LAUNCHES["bls_msm"],
            "certificate_flushes": comb["device"] + comb["host"],
            "flushes_on_msm_kernel": comb["device"],
            "flushes_on_host_engine": comb["host"],
            "native_pairing_checks": bls_native.COUNTS["pairing_checks"],
            "native_fallbacks": bls_native.COUNTS["fallbacks"],
            # host time in the certificate path, all seven replicas
            "native_calls": native_t.snapshot(),
            "threshold_verifier_calls": cert_t.snapshot(),
            "preprepares": cluster.metric(0, "counters",
                                          "sent_preprepares"),
            "head_block": rep0.handler.blockchain.last_block_id})
        emit({"phase": "bls_ledger_replica", "step": "load", **load})
        if loop.errors or load["committed"] < target:
            raise AssertionError(f"load: {load['committed']} of {target} "
                                 f"writes, {loop.errors[:3]}")
        rng = np.random.default_rng(10)
        keys = sorted(writes.acked)
        sample = [keys[i] for i in rng.choice(len(keys), size=min(
            reads, len(keys)), replace=False)]
        got = {}
        for i in range(0, len(sample), 10):
            got.update(kvs[i // 10 % clients].read(sample[i:i + 10],
                                                    timeout_ms=60000))
        wrong = [k for k in sample if got.get(k) != writes.acked[k]]
        read_back = {"keys": len(sample), "wrong": len(wrong)}
        heads = [cluster.handlers[r].blockchain for r in range(cluster.n)]
        settle = time.monotonic() + 30
        while time.monotonic() < settle and len(
                {b.last_block_id for b in heads}) != 1:
            time.sleep(0.05)
        common = min(b.last_block_id for b in heads)
        agree = len({b.block_digest(common) for b in heads}) == 1
        health = device_health(reps, br0)
        tuner = tuner_report(reps)
    finally:
        cluster.stop()
        shutil.rmtree(wal_dir, ignore_errors=True)
    out = {"phase": "bls_ledger_replica", "load": load,
           "read_back": read_back, "replicas_agree": agree, **health,
           "tuner": tuner, "wall_s": time.monotonic() - t_phase}
    emit(out)
    problems += tuner_problems(tuner)
    if len(sample) < reads or wrong:
        problems.append(f"read-back: {len(wrong)} of {len(sample)} wrong")
    if not agree:
        problems.append("replicas differ at their common head")
    if load["verify_launches"] < 1:
        problems.append("the verify kernel was not launched")
    if load["native_fallbacks"]:
        problems.append("the native BLS engine did not answer "
                        f"({bls_native.load_error})")
    if not load["certificate_flushes"]:
        problems.append("no BLS certificate was combined")
    problems += device_health_problems(health)
    if problems:
        raise AssertionError("; ".join(problems))
    return out



ECDSA_PLANE_SCHEMES = ("ed25519", "ecdsa-secp256k1", "ecdsa-p256")
CURVE_OF = {"ecdsa-secp256k1": "secp256k1", "ecdsa-p256": "secp256r1"}


def _mixed_client_keys(node_keys, schemes: dict, client_pubkeys: dict):
    """A node's ClusterKeys whose client principals sign with the scheme
    `schemes` names for each (BASELINE configs 1, 3 and 5 mixed in one
    SigManager), with those clients' public keys."""
    import dataclasses

    from tpubft_torch.consensus.keys import ClusterKeys

    class MixedKeys(ClusterKeys):
        def scheme_of(self, node: int) -> str:
            return schemes.get(node) or super().scheme_of(node)

    mk = MixedKeys(**{f.name: getattr(node_keys, f.name)
                      for f in dataclasses.fields(ClusterKeys)})
    mk.client_pubkeys = dict(client_pubkeys)
    mk._seed = node_keys._seed
    return mk


class _RlcBatches:
    """While open, records the lanes of every RLC launch by curve
    (ops/ecdsa._rlc_launch is wrapped; rlc_verify_batch looks it up at
    each call)."""

    def __enter__(self):
        import threading

        from tpubft_torch.ops import ecdsa as ops_ecdsa
        self._mod = ops_ecdsa
        self._real = real = ops_ecdsa._rlc_launch
        self.lanes = {c: [] for c in ops_ecdsa.CURVES}
        lock = threading.Lock()

        def recorded(curve_name, prep, idxs, dev, bisection=False):
            with lock:
                self.lanes[curve_name].append(len(idxs))
            return real(curve_name, prep, idxs, dev, bisection)
        ops_ecdsa._rlc_launch = recorded
        return self

    def __exit__(self, *exc) -> None:
        self._mod._rlc_launch = self._real


def phase_ecdsa_plane(torch, dev, num_pp: int = 8) -> dict:
    """ECDSA client signatures through the normal entry points: config
    1's keys with its 100 client principals signing, about a third each,
    with Ed25519, secp256k1 (config 3's client curve) and P-256 (config
    5's); 8 PrePrepares of 100 requests (about 3% forged) through
    BatchVerifier over SigManager(batch_fn=crypto.cuda.verify_batch_mixed)
    at the default ECDSA crossover (crypto/cuda.CARD_ECDSA_CROSSOVER),
    against the host scalar engines' verdicts; each PrePrepare's ECDSA
    groups also through the per-item verify kernel
    (ops/ecdsa.verify_batch, the RLC path's oracle). RLC launches and
    bisection launches counted per curve (reset just before, read just
    after)."""
    import numpy as np

    from tpubft_torch.consensus import keys as K
    from tpubft_torch.consensus.sig_manager import BatchVerifier, SigManager
    from tpubft_torch.crypto import cuda as crypto_cuda
    from tpubft_torch.crypto.cpu import make_signer
    from tpubft_torch.ops import ecdsa as ops_ecdsa
    from tpubft_torch.ops import ecdsa_cuda as ec
    from tpubft_torch.ops import ed25519_cuda as kc
    from tpubft_torch.ops.dispatch import device_breaker
    from tpubft_torch.utils.config import ReplicaConfig

    seed = b"chip-smoke-ecdsa-plane"
    cfg = ReplicaConfig(f_val=1, c_val=0, threshold_scheme="adaptive")
    ck = K.ClusterKeys.generate(cfg, num_clients=100, seed=seed)
    first_client = cfg.n_val + cfg.num_ro_replicas
    clients = list(range(first_client, first_client + 100))
    schemes = {cl: ECDSA_PLANE_SCHEMES[i % 3]
               for i, cl in enumerate(clients)}
    signers = {cl: make_signer(schemes[cl],
                               seed=K._derive_seed(seed, "client", cl))
               for cl in clients}
    mk = _mixed_client_keys(
        ck.for_node(0), schemes,
        {**ck.client_pubkeys, **{cl: s.public_bytes()
                                 for cl, s in signers.items()}})
    rng = np.random.default_rng(12)
    batch = cfg.max_num_of_requests_in_batch
    forged = set(rng.choice(num_pp * batch, size=num_pp * batch * 3 // 100,
                            replace=False).tolist())
    t0 = time.monotonic()
    pps = []
    for p in range(num_pp):
        reqs = []
        for r in range(batch):
            cl = clients[r % len(clients)]
            msg = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
            sig = signers[cl].sign(msg)
            if p * batch + r in forged:
                msg = b"forged" + msg[6:]
            reqs.append((cl, msg, sig))
        pps.append(reqs)
    sign_s = time.monotonic() - t0

    host_sm = SigManager(mk)
    t_host = time.monotonic()
    want_pp = [host_sm.verify_batch(reqs) for reqs in pps]
    host_s = time.monotonic() - t_host

    breaker = device_breaker()
    breaker.reset()
    br0 = breaker.snapshot()
    reset_all_launches()
    sm = SigManager(mk, batch_fn=crypto_cuda.verify_batch_mixed,
                    device_min_batch=cfg.device_min_verify_batch)
    bv = BatchVerifier(sm, batch_size=cfg.verify_batch_size,
                       flush_us=cfg.verify_batch_flush_us)
    steps, got_pp = [], []
    with _RlcBatches() as rlc_lanes:
        try:
            for reqs in pps:
                before = {c: dict(v) for c, v in ops_ecdsa.COUNTS.items()}
                ed0 = kc.LAUNCHES["ed25519_verify"]
                t_step = time.monotonic()
                pend = [bv.submit(cl, m, s) for cl, m, s in reqs]
                got_pp.append([v.result(timeout=300) for v in pend])
                steps.append({
                    "ms": (time.monotonic() - t_step) * 1e3,
                    "ed25519_launches": kc.LAUNCHES["ed25519_verify"] - ed0,
                    **{f"{c}_{k}": ops_ecdsa.COUNTS[c][k] - before[c][k]
                       for c in ops_ecdsa.CURVES
                       for k in ("rlc_launches", "bisection_launches")}})
        finally:
            bv.stop()
    launches = dict(ec.LAUNCHES)
    counts = {c: dict(v) for c, v in ops_ecdsa.COUNTS.items()}
    br1 = breaker.snapshot()
    # the per-item verify kernel on the same groups: the oracle
    oracle_mismatches = 0
    oracle_launches = {c: 0 for c in ops_ecdsa.CURVES}
    t_o = time.monotonic()
    for reqs, want in zip(pps, want_pp):
        for scheme, curve in CURVE_OF.items():
            idx = [i for i, (cl, _, _) in enumerate(reqs)
                   if schemes[cl] == scheme]
            v0 = ec.LAUNCHES["ecdsa_verify"]
            got = ops_ecdsa.verify_batch(
                curve, [(reqs[i][1], reqs[i][2], mk.client_pubkeys[reqs[i][0]])
                        for i in idx])
            oracle_launches[curve] += ec.LAUNCHES["ecdsa_verify"] - v0
            oracle_mismatches += sum(bool(g) != want[i]
                                     for g, i in zip(got, idx))
    oracle_s = time.monotonic() - t_o
    counters = sm.metrics.snapshot()["counters"]
    out = {"phase": "ecdsa_plane", "clients": len(clients),
           "schemes": {s: sum(v == s for v in schemes.values())
                       for s in ECDSA_PLANE_SCHEMES},
           "preprepares": num_pp, "requests_per_pp": batch,
           "forged": len(forged), "sign_s": sign_s,
           "host_scalar_s": host_s,
           "ecdsa_crossover": crypto_cuda.ecdsa_crossover(),
           "steps": steps, "launches": launches, "counts": counts,
           "rlc_lanes": rlc_lanes.lanes,
           "verdicts_equal": got_pp == want_pp,
           "accepted": sum(map(sum, got_pp)),
           "verify_oracle_launches": oracle_launches,
           "verify_oracle_mismatches": oracle_mismatches,
           "verify_oracle_s": oracle_s,
           "degraded_verifies": counters["degraded_verifies"],
           "scalar_fallbacks": counters["scalar_fallbacks"],
           "ecdsa_batched_host": counters["ecdsa_batched_host"],
           "breaker": br1["state"],
           "breaker_failures": br1["failures"] - br0["failures"],
           "breaker_fast_fails": br1["fast_fails"] - br0["fast_fails"]}
    emit(out)
    problems = []
    if not out["verdicts_equal"]:
        problems.append("PrePrepare verdicts differ from the host engines")
    if oracle_mismatches:
        problems.append(f"{oracle_mismatches} per-item kernel verdicts "
                        "differ from the host engines")
    for c in ops_ecdsa.CURVES:
        if oracle_launches[c] < 1:
            problems.append(f"the per-item verify kernel was not launched "
                            f"for {c}")
        if counts[c]["rlc_launches"] < 1:
            problems.append(f"no RLC launch for {c}")
        if counts[c]["bisection_launches"] < 1:
            problems.append(f"no bisection launch for {c} (forged items)")
    if launches["ecdsa_rlc"] != sum(c["rlc_launches"]
                                    for c in counts.values()):
        problems.append("RLC launches on the card differ from the path's")
    if out["degraded_verifies"] or out["scalar_fallbacks"] \
            or out["ecdsa_batched_host"]:
        problems.append("the device path degraded or fell back to the host")
    if out["breaker_failures"] or out["breaker_fast_fails"] \
            or out["breaker"] != "closed":
        problems.append(f"device breaker {out['breaker']}, "
                        f"{out['breaker_failures']} failures")
    if problems:
        raise AssertionError("; ".join(problems))
    # the same PrePrepares and verdicts for the offload phase
    out["offload_inputs"] = {"keys": mk, "pps": pps, "want": want_pp}
    return out


ECDSA_LEDGER_CONFIG = dict(
    LEDGER_REPLICA_CONFIG,
    # BASELINE config 3 as benchmarks/bench_e2e.py:76-86 defines it:
    # simpleKVBC, 31 replicas (f=10), BLS threshold certificates,
    # secp256k1 client signatures, and its three overrides
    threshold_scheme="threshold-bls", client_sig_scheme="ecdsa-secp256k1",
    view_change_timer_ms=30000, fast_path_timeout_ms=5000,
    concurrency_level=1)


def phase_ecdsa_ledger_replica(torch, dev, clients: int = 16,
                               target: int = 300, reads: int = 60,
                               budget_s: float = 150.0, f: int = 10
                               ) -> dict:
    """BASELINE config 3 as the reference runs it (benchmarks/bench_e2e.py
    CONFIGS[3], recorded in process with 16 clients,
    benchmarks/RESULTS.md:78): 31 replicas of testing.InProcessCluster
    (f=10, c=0), threshold-bls certificates, secp256k1 clients,
    crypto_backend "cuda", the SKVBC app over the categorized ledger,
    file WALs, the durability pipeline and state transfer at their
    defaults, the autotuner at its default. 16 closed-loop clients
    write kvbcbench blocks until `target` commit or `budget_s` passes
    (then the writes are cut, never the replicas, and the cut printed),
    then `reads` acknowledged keys are read back. Printed: commit
    latency, requests/s, PrePrepares, RLC launches and lanes a launch,
    the SigManagers' ecdsa_batched_host and degraded_verifies,
    certificate flushes, the phase's wall time."""
    import shutil
    import statistics
    import tempfile

    import numpy as np

    from tpubft_torch import testing
    from tpubft_torch.apps import skvbc
    from tpubft_torch.consensus.persistent import FilePersistentStorage
    from tpubft_torch.crypto import cuda as crypto_cuda
    from tpubft_torch.kvbc import KeyValueBlockchain
    from tpubft_torch.ops import ecdsa as ops_ecdsa
    from tpubft_torch.ops import ecdsa_cuda as ec
    from tpubft_torch.ops import ed25519_cuda as kc
    from tpubft_torch.ops.dispatch import device_breaker
    from tpubft_torch.storage import MemoryDB
    from tpubft_torch.testing import InProcessCluster

    cfg = dict(ECDSA_LEDGER_CONFIG)
    t_phase = time.monotonic()
    wal_dir = tempfile.mkdtemp(prefix="chip-smoke-ecdsa-wal-")

    def storage_factory(r):
        return FilePersistentStorage(os.path.join(wal_dir, f"r{r}.wal"))

    def handler_factory(_r=None):
        return skvbc.SkvbcHandler(KeyValueBlockchain(MemoryDB()))

    cluster = InProcessCluster(
        f=f, c=0, num_clients=clients, seed=b"chip-smoke-ecdsa-ledger",
        handler_factory=handler_factory, storage_factory=storage_factory,
        cfg_overrides=cfg)
    rep0 = cluster.replicas[0]
    emit({"phase": "ecdsa_ledger_replica", "step": "config", "n": cluster.n,
          "f": f, "c": 0, "clients": clients, "target_requests": target,
          "read_back": reads, "budget_s": budget_s, "config": cfg,
          "reduced": _reduced(phase_ecdsa_ledger_replica, target=target),
          "scheme": rep0.keys.threshold_scheme,
          "client_scheme": rep0.keys.client_sig_scheme,
          "ecdsa_crossover": crypto_cuda.ecdsa_crossover(),
          "durability_pipeline": rep0.durability is not None,
          "crypto_backend": rep0.crypto_backend,
          "setup_s": time.monotonic() - t_phase})
    if cluster.n != 3 * f + 1 \
            or rep0.keys.client_sig_scheme != "ecdsa-secp256k1":
        raise AssertionError(f"n={cluster.n}, clients "
                             f"{rep0.keys.client_sig_scheme}")
    breaker = device_breaker()
    problems = []
    try:
        cluster.start()
        bft = [cluster.client(i) for i in range(clients)]
        for c in bft:
            c.start()
        kvs = [skvbc.SkvbcClient(c) for c in bft]
        writes = _KvbcbenchWrites(kvs, testing.kvbcbench_rows(64),
                                  timeout_ms=int(budget_s * 1000))
        loop = _ClosedLoop(clients, writes)
        reps = list(cluster.replicas.values())
        breaker.reset()
        br0 = breaker.snapshot()
        comb0 = _bls_combines(reps)
        host0 = sum(r.sig.ecdsa_batched_host.value for r in reps)
        reset_all_launches()
        with _RlcBatches() as rlc_lanes:
            load = loop.run(lambda n: n >= target, budget_s=budget_s)
        comb = {k: v - comb0[k] for k, v in _bls_combines(reps).items()}
        lanes = rlc_lanes.lanes["secp256k1"]
        load.update({
            "rlc_launches": ec.LAUNCHES["ecdsa_rlc"],
            "rlc_bisection_launches":
                ops_ecdsa.COUNTS["secp256k1"]["bisection_launches"],
            "rlc_lanes_per_launch": (sum(lanes) / len(lanes)
                                     if lanes else 0.0),
            "rlc_median_lanes": (statistics.median_low(lanes)
                                 if lanes else 0),
            "rlc_lanes_max": max(lanes, default=0),
            "verify_launches": kc.LAUNCHES["ed25519_verify"],
            "ecdsa_batched_host": sum(r.sig.ecdsa_batched_host.value
                                      for r in reps) - host0,
            "certificate_flushes": comb["device"] + comb["host"],
            "flushes_on_msm_kernel": comb["device"],
            "preprepares": cluster.metric(0, "counters",
                                          "sent_preprepares"),
            "head_block": rep0.handler.blockchain.last_block_id})
        if load["committed"] < target:
            load["cut"] = {"target": target, "committed": load["committed"],
                           "reason": f"{budget_s} s budget"}
        # the tuners as the load left them, before the read-back
        load["tuner"] = tuner_report(reps, clear=False)
        emit({"phase": "ecdsa_ledger_replica", "step": "load", **load})
        if loop.errors or load["committed"] < 1:
            raise AssertionError(f"load: {load['committed']} writes, "
                                 f"{loop.errors[:3]}")
        rng = np.random.default_rng(13)
        keys = sorted(writes.acked)
        sample = [keys[i] for i in rng.choice(len(keys), size=min(
            reads, len(keys)), replace=False)]
        got = {}
        for i in range(0, len(sample), 10):
            got.update(kvs[i // 10 % clients].read(sample[i:i + 10],
                                                    timeout_ms=60000))
        wrong = [k for k in sample if got.get(k) != writes.acked[k]]
        read_back = {"keys": len(sample), "wrong": len(wrong)}
        heads = [cluster.handlers[r].blockchain for r in range(cluster.n)]
        settle = time.monotonic() + 30
        while time.monotonic() < settle and len(
                {b.last_block_id for b in heads}) != 1:
            time.sleep(0.05)
        common = min(b.last_block_id for b in heads)
        agree = len({b.block_digest(common) for b in heads}) == 1
        health = device_health(reps, br0)
        tuner = tuner_report(reps)
    finally:
        cluster.stop()
        shutil.rmtree(wal_dir, ignore_errors=True)
    out = {"phase": "ecdsa_ledger_replica", "load": load,
           "reduced": _reduced(phase_ecdsa_ledger_replica, target=target),
           "rlc_lanes": lanes, "read_back": read_back,
           "replicas_agree": agree, "common_head": common, **health,
           "tuner": tuner, "wall_s": time.monotonic() - t_phase}
    emit(out)
    problems += tuner_problems(tuner)
    if len(sample) < min(reads, load["committed"]) or wrong:
        problems.append(f"read-back: {len(wrong)} of {len(sample)} wrong")
    if not agree:
        problems.append("replicas differ at their common head")
    if load["rlc_launches"] < 1:
        problems.append("the RLC kernel was not launched")
    problems += device_health_problems(health)
    if problems:
        raise AssertionError("; ".join(problems))
    return out


OFFLOAD_LEASE_TIMEOUT_MS = 60000


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _Helpers:
    """Offload helpers as subprocesses on 127.0.0.1 (`python -m
    tpubft_torch.offload.helper --port P --id ID --strategy S`), each
    with no card visible; stopped (terminated, then killed) on exit."""

    def __init__(self, specs):
        self.specs = specs
        self.procs, self.ports, self.logs = {}, {}, {}

    def __enter__(self):
        import socket
        import tempfile
        env = dict(os.environ, PYTHONPATH=HERE, CUDA_VISIBLE_DEVICES="")
        for hid, strategy in self.specs:
            port = _free_port()
            log = tempfile.TemporaryFile()
            self.ports[hid], self.logs[hid] = port, log
            self.procs[hid] = subprocess.Popen(
                [sys.executable, "-m", "tpubft_torch.offload.helper",
                 "--port", str(port), "--id", hid, "--strategy", strategy,
                 "--log-level", "WARNING"], cwd=HERE, env=env,
                stdout=subprocess.DEVNULL, stderr=log)
        try:
            deadline = time.monotonic() + 120
            for hid, port in self.ports.items():
                while True:
                    try:
                        socket.create_connection(("127.0.0.1", port),
                                                 1).close()
                        break
                    except OSError:
                        if self.procs[hid].poll() is not None:
                            raise AssertionError(
                                f"helper {hid} exited: {self.log_tail(hid)}")
                        if time.monotonic() > deadline:
                            raise AssertionError(
                                f"helper {hid} never listened")
                        time.sleep(0.1)
        except BaseException:
            self.__exit__()
            raise
        return self

    def log_tail(self, hid) -> str:
        log = self.logs[hid]
        log.seek(0)
        return log.read()[-2000:].decode(errors="replace")

    def __exit__(self, *exc) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.terminate()
        for p in self.procs.values():
            try:
                p.wait(10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(10)
        for log in self.logs.values():
            log.close()

    def gone(self) -> bool:
        return all(p.poll() is not None for p in self.procs.values())


def phase_offload(torch, dev, bls_plane, ecdsa_plane) -> dict:
    """The verified offload tier (tpubft_torch/offload/) on the card's
    paths: two helper processes on 127.0.0.1, one honest and one liar
    (`wrong-on-curve`: valid subgroup points that are not the answer;
    for ECDSA the first verdict flipped). Each route configures the
    process-wide pool as a replica does from `offload_helpers` (one
    helper, a 60 s lease deadline; "off" leaves it disabled).
    (a) config 2's 64-slot threshold flush (320 shares) and the
    multisig-bls flush through CombineBatcher, with offload off, the
    honest helper and the liar: equal certificates; the honest leases
    verified with no MSM launch, the liar costing one local re-run (one
    bls_msm launch), quarantined and shown in the health payload's
    offload section; and the bls_plane's flush with two bad slots,
    offload off and honest: equal, the honest helper NOT quarantined
    (the failed check is the shares', found by the one re-run).
    (b) the ecdsa_plane's 8 PrePrepares (3% forged) through SigManager
    (batch_fn = crypto.cuda.verify_batch_mixed): off, honest, liar; the
    verdicts equal the host engines'; RLC launches per curve on each
    route (honest: one re-fold a curve group, no bisection); lease and
    soundness microseconds. Launch counts reset just before each run,
    read just after. The helpers are stopped, and gone, at the end."""
    import json as _json

    from tpubft_torch.consensus.health import HealthMonitor
    from tpubft_torch.consensus.sig_manager import SigManager
    from tpubft_torch.crypto import cuda as crypto_cuda
    from tpubft_torch.diagnostics import get_registrar
    from tpubft_torch.offload import pool as off
    from tpubft_torch.ops import bls12_381_cuda as bc
    from tpubft_torch.ops import ecdsa as ops_ecdsa
    from tpubft_torch.ops import ecdsa_cuda as ec
    from tpubft_torch.ops.dispatch import device_breaker, offload_pool
    from tpubft_torch.utils.config import ReplicaConfig
    from tpubft_torch.utils.metrics import Aggregator

    t_phase = time.monotonic()
    bi = bls_plane["offload_inputs"]
    k, system = bi["k"], bi["system"]
    n = len(bi["signers"])
    clean = _bls_jobs(bi["signers"], k, BLS_SLOTS, (), seed=5)
    ms_clean = _bls_jobs(bi["ms_signers"], k, BLS_SLOTS, (), seed=6)
    host_thr = system.create_threshold_verifier()
    host_ms = bi["ms_sys"].create_threshold_verifier()
    ei = ecdsa_plane["offload_inputs"]
    cfg = ReplicaConfig()
    breaker = device_breaker()
    breaker.reset()
    br0 = breaker.snapshot()
    problems = []
    out = {"phase": "offload", "helpers": {"honest": "honest",
                                           "liar": "wrong-on-curve"},
           "lease_timeout_ms": OFFLOAD_LEASE_TIMEOUT_MS}

    def route(name):
        off.reset_offload_pool()
        if name == "off":
            return None
        pool = offload_pool()
        pool.configure(enabled=True,
                       lease_timeout_ms=OFFLOAD_LEASE_TIMEOUT_MS,
                       max_inflight=cfg.offload_max_inflight)
        pool.add_endpoint(name, "127.0.0.1", helpers.ports[name])
        return pool

    def pool_view(pool):
        if pool is None:
            return None
        s = pool.snapshot()
        return {"quarantined": s["quarantined"],
                "lease_us_total": s["lease_us_total"],
                "lease_items_total": s["lease_items_total"],
                "soundness_us_total": s["soundness_us_total"],
                **s["counters"]}

    with _Helpers((("honest", "honest"),
                   ("liar", "wrong-on-curve"))) as helpers:
        try:
            # (a) BLS certificates
            bls_runs, certs = {}, {}
            runs = [(kind, r, jobs) for kind, jobs in (
                ("threshold", clean), ("multisig", ms_clean))
                for r in ("off", "honest", "liar")]
            runs += [("threshold_bad_slots", r, bi["bad_jobs"])
                     for r in ("off", "honest")]
            for kind, r, jobs in runs:
                v = (crypto_cuda.make_threshold_verifier(
                    "multisig-bls", k, n, bi["ms_sys"].public_key,
                    bi["ms_sys"].share_public_keys)
                    if kind == "multisig" else
                    crypto_cuda.make_threshold_verifier(
                        "threshold-bls", k, n, system.public_key,
                        system.share_public_keys))
                pool = route(r)
                reset_all_launches()
                t0 = time.monotonic()
                res, flushes = _bls_flush(v, jobs)
                ms = (time.monotonic() - t0) * 1e3
                certs[(kind, r)] = [(x.ok, x.combined_sig, x.bad_shares)
                                    for x in res]
                run = {"flush_ms": ms, "flushes": flushes,
                       "bls_msm_launches": bc.LAUNCHES["bls_msm"],
                       "device_combines": v.device_combines,
                       "pool": pool_view(pool)}
                if r == "liar":
                    h = HealthMonitor("offload-phase", Aggregator()).verdict()
                    run["health"] = {"verdict": h["verdict"],
                                     "offload": h.get("offload"),
                                     "helper_breaker": h["breakers"].get(
                                         "helper.liar", {}).get("state")}
                bls_runs[f"{kind}_{r}"] = run
            off.reset_offload_pool()
            out["bls"] = bls_runs
            for kind, host_v, jobs in (("threshold", host_thr, clean),
                                       ("multisig", host_ms, ms_clean)):
                want = host_v.combine_batch(jobs)
                if any(certs[(kind, r)] != want
                       for r in ("off", "honest", "liar")):
                    problems.append(f"{kind}: certificates differ between "
                                    "the routes or from the host engine")
                if not all(ok for ok, _, _ in want):
                    problems.append(f"{kind}: a clean slot failed")
                o, h, li = (bls_runs[f"{kind}_{r}"]
                            for r in ("off", "honest", "liar"))
                if o["bls_msm_launches"] != 1:
                    problems.append(f"{kind} off: {o['bls_msm_launches']} "
                                    "MSM launches, not 1")
                if h["bls_msm_launches"] != 0 \
                        or h["pool"]["lease_verified"] != 1 \
                        or h["pool"]["quarantined"]:
                    problems.append(f"{kind} honest: {h}")
                if li["bls_msm_launches"] != 1 \
                        or li["pool"]["lease_rejected"] != 1 \
                        or li["pool"]["quarantined"] != ["liar"] \
                        or (li["health"]["offload"] or {}).get(
                            "quarantined") != ["liar"] \
                        or li["health"]["verdict"] != "degraded":
                    problems.append(f"{kind} liar: {li}")
            bo, bh = (bls_runs[f"threshold_bad_slots_{r}"]
                      for r in ("off", "honest"))
            if certs[("threshold_bad_slots", "off")] \
                    != certs[("threshold_bad_slots", "honest")]:
                problems.append("bad slots: certificates differ with the "
                                "honest helper")
            if bh["pool"]["quarantined"] or bh["pool"]["lease_rejected"] != 1 \
                    or bh["bls_msm_launches"] != 1:
                problems.append(f"bad slots, honest helper: {bh}")

            # (b) ECDSA verdicts
            ecdsa_runs = {}
            verdicts = {}
            for r in ("off", "honest", "liar"):
                # a fresh SigManager a route: it remembers what it verified
                sm = SigManager(ei["keys"],
                                batch_fn=crypto_cuda.verify_batch_mixed,
                                device_min_batch=cfg.device_min_verify_batch)
                pool = route(r)
                reset_all_launches()
                got, steps_ms = [], []
                for reqs in ei["pps"]:
                    t0 = time.monotonic()
                    got.append(sm.verify_batch(reqs))
                    steps_ms.append((time.monotonic() - t0) * 1e3)
                verdicts[r] = got
                view = pool_view(pool)
                run = {"pp_ms": steps_ms,
                       "rlc_launches": {c: ops_ecdsa.COUNTS[c]["rlc_launches"]
                                        for c in ops_ecdsa.CURVES},
                       "bisection_launches": {
                           c: ops_ecdsa.COUNTS[c]["bisection_launches"]
                           for c in ops_ecdsa.CURVES},
                       "ecdsa_rlc_launches": ec.LAUNCHES["ecdsa_rlc"],
                       "pool": view}
                if view and view["lease_issued"]:
                    run["lease_us_per_lease"] = (view["lease_us_total"]
                                                 / view["lease_issued"])
                    run["soundness_us_per_lease"] = (
                        view["soundness_us_total"] / view["lease_issued"])
                ecdsa_runs[r] = run
            off.reset_offload_pool()
            reg = get_registrar()
            out["ecdsa"] = ecdsa_runs
            out["histograms_us"] = {
                name: reg.histogram_snapshot(name)
                for name in ("off_lease_us", "off_soundness_us")}
            groups = len(ei["pps"])
            if any(verdicts[r] != ei["want"] for r in verdicts):
                problems.append("ECDSA verdicts differ between the routes "
                                "or from the host engines")
            o, h, li = (ecdsa_runs[r] for r in ("off", "honest", "liar"))
            for c in ops_ecdsa.CURVES:
                if h["rlc_launches"][c] != groups \
                        or h["bisection_launches"][c]:
                    problems.append(f"ECDSA honest {c}: "
                                    f"{h['rlc_launches'][c]} re-folds for "
                                    f"{groups} groups")
                if o["rlc_launches"][c] < groups \
                        or not o["bisection_launches"][c]:
                    problems.append(f"ECDSA off {c}: {o['rlc_launches']}")
            if h["pool"]["lease_verified"] != 2 * groups \
                    or h["pool"]["quarantined"]:
                problems.append(f"ECDSA honest: {h['pool']}")
            if li["pool"]["quarantined"] != ["liar"] \
                    or li["pool"]["lease_rejected"] != 1 \
                    or li["pool"]["lease_issued"] != 1:
                problems.append(f"ECDSA liar: {li['pool']}")
            for r, run in ecdsa_runs.items():
                if run["ecdsa_rlc_launches"] != sum(
                        run["rlc_launches"].values()):
                    problems.append(f"ECDSA {r}: card launches differ from "
                                    "the path's")
        finally:
            off.reset_offload_pool()
            out["helper_logs"] = {hid: helpers.log_tail(hid)[-300:]
                                  for hid in helpers.procs}
    br1 = breaker.snapshot()
    out.update({"helpers_gone": helpers.gone(),
                "breaker": br1["state"],
                "breaker_failures": br1["failures"] - br0["failures"],
                "wall_s": time.monotonic() - t_phase})
    out["launches_by_path"] = {
        "bls_msm": sum(run["bls_msm_launches"]
                       for run in out["bls"].values()),
        **{f"ecdsa_rlc_{c}": sum(run["rlc_launches"][c]
                                 for run in out["ecdsa"].values())
           for c in ops_ecdsa.CURVES}}
    emit(_json.loads(_json.dumps(out, default=str)))
    if not out["helpers_gone"]:
        problems.append("a helper process outlived the phase")
    if out["breaker_failures"] or out["breaker"] != "closed":
        problems.append(f"device breaker {out['breaker']}")
    if problems:
        raise AssertionError("; ".join(problems))
    return out


def ecdsa_kernel_rows(torch, dev, ecdsa_plane, ecdsa_ledger, offload,
                      tls_cluster, sm_clock_mhz) -> list:
    """The ECDSA kernels at their paths' shapes
    (tools/ecdsa_probe.measure): ecdsa_rlc for secp256k1 at the config-3
    cluster's median lanes a launch and at B = 128, for P-256 at B = 128;
    ecdsa_verify for both curves at B = 128. Each on a seeded corpus
    with a forged item and the two crafted wrap-case lanes, against its
    plain version on the card (the fold's value word for word on the
    batch with forged lanes, verdicts and x), its device time by CUDA
    graph on the clean lanes, host issue time, the plain version's time,
    the bound from the products and squarings the function needs on
    these scalars at its cheapest (ops/ecdsa_cuda.field_ops: GLV, G's
    fixed-base tables, width-w NAF) beside the kernel's own products,
    and as the yardstick that decides
    the crossover the host engine (scalar.ecdsa_verify_batch, warm
    combs) on the same items; no PyTorch call computes this
    (library_ms null). Beside the bound, the chain floor: the kernel's
    longest chain (ops/ecdsa_cuda.kernel_counts: its doublings,
    additions, mixed additions and single products on the slowest
    lane's [u2]Q thread, its join and end) at the cycles of this run's
    clock64 probe (ops/ecdsa_cuda.probe) and the SM clock."""
    from tpubft_torch.ops import ecdsa_cuda as ec
    from tpubft_torch.tools import ecdsa_probe
    probes = {c: ec.probe(c, dev) for c in ("secp256k1", "secp256r1")}
    median = max(1, ecdsa_ledger["load"]["rlc_median_lanes"])
    plane = ecdsa_plane["counts"]
    cases = {("secp256k1", median): None, ("secp256k1", 128): None,
             ("secp256r1", 128): None}
    for curve, b in cases:
        # the verify rows are the B = 128 ones: the median's plain
        # verify (seconds of op-by-op PyTorch) is left out
        cases[(curve, b)] = ecdsa_probe.measure(curve, b, dev, seed=b,
                                                plain_verify=b == 128)
    src = "tpubft_torch/ops/csrc/ecdsa.cu"
    rows = []

    def bound(ops, nbytes):
        return work_bound_ms(ops, nbytes, sm_clock_mhz)
    for curve, b in cases:
        m = cases[(curve, b)]
        by_path = {"ecdsa_plane": plane[curve]["rlc_launches"],
                   # off, the honest helper's re-folds, the liar's run
                   "offload": offload["launches_by_path"][
                       f"ecdsa_rlc_{curve}"]}
        if curve == "secp256k1":
            by_path["ecdsa_ledger_replica"] = ecdsa_ledger["load"][
                "rlc_launches"]
        else:
            # config 5's four replica processes (P-256 clients)
            by_path["tls_cluster"] = tls_cluster["rlc_p256_launches"]
        bd = bound(m["ops"], m["bytes"])
        rows.append({
            "name": "ecdsa_rlc", "route": "cuda", "source": src,
            "replaces": "tpubft/ops/ecdsa.py:304 (make_rlc_kernel; "
                        "rlc_fold_body :267-300)",
            "curve": curve, "batch": b, "lanes": m["lanes"],
            "shape": ("config 3 cluster's median lanes a launch"
                      if b == median and curve == "secp256k1"
                      and b != 128 else f"B={b}"),
            "path": "ECDSA client signatures (SigManager -> "
                    "verify_batch_mixed -> rlc_verify_batch)",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": m["rlc_mismatches"] + int(m["clean_nonzero"])
            + int(not m["fold_nonzero"]),
            "ms": m["rlc_ms"], "host_ms": m["rlc_host_ms"],
            "plain_ms": m["rlc_plain_ms"], "host_prep_ms": m["prep_ms"],
            "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
            "ops": bd["ops"], "bytes": bd["bytes"],
            "field_muls": m["field_muls"], "field_sqrs": m["field_sqrs"],
            "kernel_field_muls": m["kernel_field_muls"],
            "kernel_chain": m["kernel_chain"],
            "chain_floor_ms": ec.chain_floor_ms(
                m["kernel_chain"], probes[curve], sm_clock_mhz),
            "probe": probes[curve],
            "library_ms": None,
            "host_engine_ms": m["host_engine_ms"],
            "host_engine_cold_ms": m["host_engine_cold_ms"]})
    for curve in ("secp256k1", "secp256r1"):
        m = cases[(curve, 128)]
        bd = bound(m["verify_ops"], m["verify_bytes"])
        rows.append({
            "name": "ecdsa_verify", "route": "cuda", "source": src,
            "replaces": "tpubft/ops/ecdsa.py:172 "
                        "(make_verify_kernel.<locals>.kernel, :169-184)",
            "curve": curve, "batch": 128, "lanes": m["lanes"],
            "path": "ops/ecdsa.verify_batch: ecdsa_plane's per-item "
                    "oracle (no user path)",
            "launches": ecdsa_plane["verify_oracle_launches"][curve],
            "launches_by_path": {"ecdsa_plane_oracle":
                                 ecdsa_plane["verify_oracle_launches"][curve]},
            "max_abs_err": m["verify_mismatches"]
            + m["verify_host_mismatches"],
            "host_mismatches": m["verify_host_mismatches"],
            "ms": m["verify_ms"], "host_ms": m["verify_host_ms"],
            "plain_ms": m["verify_plain_ms"],
            "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
            "ops": bd["ops"], "bytes": bd["bytes"],
            "field_muls": m["verify_field_muls"],
            "field_sqrs": m["verify_field_sqrs"],
            "kernel_field_muls": m["verify_kernel_field_muls"],
            "kernel_chain": m["verify_kernel_chain"],
            "chain_floor_ms": ec.chain_floor_ms(
                m["verify_kernel_chain"], probes[curve], sm_clock_mhz),
            "library_ms": None,
            "host_engine_ms": m["host_engine_ms"]})
    return rows


MESH_SLOTS = 4


def _mesh_inputs():
    """The mesh phase's seeded inputs: 256 Ed25519 items, every 5th
    forged; 256 Merkle messages and 256 blocks of mixed sizes; config
    4's 1000-point MSM; 64 segments of 16 Lagrange-weighted shares; 128
    secp256k1 and 128 P-256 items, 3% forged."""
    import random

    import numpy as np

    from tpubft_torch import testing
    from tpubft_torch.crypto import bls12381 as bls
    from tpubft_torch.crypto import cpu
    signer = cpu.Ed25519Signer.generate(seed=b"chip-smoke-mesh")
    pk = signer.public_bytes()
    ed = []
    for i in range(256):
        m = b"mesh-%d" % i
        sig = signer.sign(m)
        if i % 5 == 0:
            sig = sig[:8] + bytes([sig[8] ^ 1]) + sig[9:]
        ed.append((m, sig, pk))
    rng = np.random.default_rng(15)
    sizes = [0, 1, 55, 56, 63, 64, 119, 120, 300, 1000, 4400]
    mixed = [rng.bytes(sizes[i % len(sizes)]) for i in range(256)]
    r = random.Random(15)
    base = [bls.g1_mul(bls.G1_GEN, r.randrange(1, bls.R)) for _ in range(64)]
    pts = [bls.g1_mul(bls.G1_GEN, 3 + i) for i in range(1000)]
    ks = [r.randrange(bls.R) for _ in range(1000)]
    segs = []
    for j in range(64):
        width = 16 - j % 2
        ids = list(range(1 + j % 7, 1 + j % 7 + width))
        segs.append(([base[(i + j) % 64] for i in range(width)],
                     bls.lagrange_coeffs_at_zero(ids)))
    forged = (7, 40, 99, 120)
    ecdsa = {c: testing.ecdsa_corpus(c, 128, seed=15, forged=forged)
             for c in ("secp256k1", "secp256r1")}
    return {"ed25519": ed, "merkle": merkle_messages(256, seed=15),
            "mixed": mixed, "msm": (pts, ks), "segments": segs,
            "ecdsa": ecdsa}


def _mesh_route_calls(inp) -> dict:
    """Every routed entry point on the phase's inputs, called without a
    device (the mesh consults its plan): name -> a call giving its
    answer as plain values."""
    from tpubft_torch.ops import bls12_381 as bops
    from tpubft_torch.ops import ecdsa as eops
    from tpubft_torch.ops import ed25519 as ops
    from tpubft_torch.ops import sha256 as sha
    calls = {
        "ed25519": lambda: ops.verify_batch(inp["ed25519"]).tolist(),
        "sha256": lambda: sha.sha256_batch(inp["merkle"]),
        "sha256_mixed": lambda: sha.sha256_batch_mixed(inp["mixed"]),
        "msm": lambda: bops.msm(*inp["msm"]),
        "msm_batch": lambda: bops.msm_batch(inp["segments"])}
    for c, items in inp["ecdsa"].items():
        calls[f"rlc_{c}"] = (lambda c=c, items=items:
                             eops.rlc_verify_batch(c, items).tolist())
    return calls


def _mesh_routes(inp) -> dict:
    return {name: call() for name, call in _mesh_route_calls(inp).items()}


def _mesh_route_bounds(inp, sm_clock_mhz: float) -> dict:
    """Each route's bound (work_bound_ms): the work its function needs
    on the phase's inputs, however it is sharded."""
    from tpubft_torch.ops import bls12_381 as bops
    from tpubft_torch.ops import bls12_381_cuda as bc
    from tpubft_torch.ops import ecdsa as eops
    from tpubft_torch.ops import ecdsa_cuda as ec
    from tpubft_torch.ops import sha256_cuda
    out = {"ed25519": verify_bound_ms(len(inp["ed25519"]), sm_clock_mhz)}
    for name, msgs in (("sha256", inp["merkle"]),
                       ("sha256_mixed", inp["mixed"])):
        out[name] = work_bound_ms(*sha256_cuda.work([len(m) for m in msgs]),
                                  sm_clock_mhz)
    for name, segs in (("msm", [inp["msm"]]),
                       ("msm_batch", inp["segments"])):
        h = bops.prepare_msm_batch(segs)
        out[name] = work_bound_ms(*bc.work(h[0], h[3], True), sm_clock_mhz)
    for c, items in inp["ecdsa"].items():
        rp = eops.prepare_rlc_batch(c, items)
        out[f"rlc_{c}"] = work_bound_ms(*ec.work(
            c, rp.u1, rp.u2, rp.host_valid, rp.wrap_ok), sm_clock_mhz)
    return {k: {"bound_ms": v["bound_ms"], "bound_by": v["bound_by"]}
            for k, v in out.items()}


def _route_ms(torch, fn, reps: int = 3) -> float:
    """Median host-clock ms of a routed call (its read-back included)."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return sorted(out)[len(out) // 2]


def phase_mesh(torch, dev, sm_clock_mhz: float,
               cluster_writes: int = 1000) -> dict:
    """The mesh tier (parallel/sharding.py) on the card.
    (a) the default inventory on this host: one slot, no mesh
    (`mesh_plan().mesh is None`), no `device.chip*` breaker; a 256-item
    verify, 256-message digests, a K=64 MSM and a 128-item RLC give the
    same bytes and launches as the single-device route (`device=`).
    (b) MESH_SLOTS virtual slots on cuda:0
    (sharding.set_virtual_devices; on a host with several cards, as
    `--mesh` runs it, the cards themselves): every routed entry point at sizes
    past its gate (verify 256, every 5th forged; sha256_batch 256 and
    sha256_batch_mixed 256 of mixed sizes; msm of config 4's 1000
    points; msm_batch S=64 K=16; rlc_verify_batch of 128 secp256k1 and
    128 P-256 items, 3% forged) against the one-slot route and the host
    engines (scalar, hashlib, the native BLS engine), the verify and
    SHA-256 routes against their plain versions on the card too, and the
    MSM kernel against its plain version on slot 0's shard of each MSM
    route (one plain call over both); launches per kernel (one a slot), the
    bls_msm_combine launches and the `.shard` profile rows; each route's
    ms on 4 slots of ONE card (they share its SMs: no multi-card time)
    beside the one-slot route's; bls_msm_combine against its plain
    version and timed (the kernels line's row).
    (c) slot 2 faulted in the middle of a flood of verifies and RLC
    flushes: exactly slot 2 evicted, 3 slots left, exact verdicts, the
    device breaker closed, the health payload's mesh.evicted == [2];
    cleared, it is readmitted after its cooldown (waited on state).
    (d) config 1's four-replica cluster (the replica phase) on the 4
    slots until `cluster_writes` writes commit: crypto_shard_count
    registered, mesh_sharded_verifies > 0 on every replica.
    (e) graft_entry.dryrun_multichip(4)."""
    import numpy as np

    from tpubft_torch import graft_entry
    from tpubft_torch.consensus.health import HealthMonitor
    from tpubft_torch.crypto import bls12381 as bls
    from tpubft_torch.crypto import scalar
    from tpubft_torch.ops import bls12_381 as bops
    from tpubft_torch.ops import bls12_381_cuda as bc
    from tpubft_torch.ops import dispatch
    from tpubft_torch.ops import ecdsa as eops
    from tpubft_torch.ops import ed25519 as ops
    from tpubft_torch.ops import sha256 as sha
    from tpubft_torch.parallel import sharding
    from tpubft_torch.utils import breaker as breaker_mod
    from tpubft_torch.utils import flight
    from tpubft_torch.utils.metrics import Aggregator
    import hashlib

    t_phase = time.monotonic()
    inp = _mesh_inputs()
    problems = []
    cards = torch.cuda.device_count()
    slots = cards if cards > 1 else MESH_SLOTS
    sick = min(2, slots - 1)
    out = {"phase": "mesh", "slots": slots, "cards": cards,
           "reduced": _reduced(phase_mesh, cluster_writes=cluster_writes),
           "note": "one card: all slots share it, so no time here is a "
                   "multi-card time" if cards == 1 else
                   "one slot a card"}

    # (a) the default inventory
    plan = dispatch.mesh_plan()
    chips = sorted(breaker_mod.prefixed("device.chip"))
    a_in = {"ed25519": inp["ed25519"], "sha": inp["merkle"],
            "msm": (inp["msm"][0][:64], inp["msm"][1][:64]),
            "rlc": inp["ecdsa"]["secp256k1"]}

    def one_call(device):
        reset_all_launches()
        got = (ops.verify_batch(a_in["ed25519"], device).tolist(),
               sha.sha256_batch(a_in["sha"], device),
               bops.msm(*a_in["msm"], device),
               eops.rlc_verify_batch("secp256k1", a_in["rlc"],
                                     device).tolist())
        return got, {k: v for k, v in all_launches().items() if v}
    routed, routed_l = one_call(None)
    pinned, pinned_l = one_call(dev)
    out["default"] = {"slots": plan.n, "mesh_is_none": plan.mesh is None,
                      "chip_breakers": chips, "launches": routed_l,
                      "equal_to_single_device": routed == pinned,
                      "launches_equal": routed_l == pinned_l}
    emit({"phase": "mesh", "step": "default", **out["default"]})
    # the liveness probe (sharding._probe_fn, a torch expression on 16
    # int32, no kernel of the port): its device time by graph, a probe
    # with its read-back on the host's clock (median of 20), and the
    # bound of its work: 64 bytes in and an 8-byte sum out, 16
    # multiplies, 16 additions and 15 for the sum
    x = torch.arange(16, dtype=torch.int32, device=dev)
    roundtrip = []
    for _ in range(20):
        t0 = time.perf_counter()
        int(sharding._probe_fn(x))
        roundtrip.append((time.perf_counter() - t0) * 1e3)
    out["probe"] = {"ms": graph_ms(lambda: sharding._probe_fn(x), 20),
                    "roundtrip_ms": sorted(roundtrip)[10],
                    **work_bound_ms(47, 72, sm_clock_mhz)}
    emit({"phase": "mesh", "step": "probe", **out["probe"]})
    if cards == 1 and (plan.n != 1 or plan.mesh is not None or chips):
        problems.append(f"default inventory: {out['default']}")
    if cards > 1 and plan.n != cards:
        problems.append(f"{cards} cards, a plan of {plan.n} slots")
    if routed != pinned or (cards == 1 and routed_l != pinned_l):
        problems.append("the one-slot route differs from the "
                        "single-device route")

    # the host engines' answers
    host = {"ed25519": [scalar.ed25519_verify(pk, m, s)
                        for m, s, pk in inp["ed25519"]],
            "sha256": [hashlib.sha256(m).digest() for m in inp["merkle"]],
            "sha256_mixed": [hashlib.sha256(m).digest()
                             for m in inp["mixed"]],
            "msm": bls.g1_msm(*inp["msm"]),
            "msm_batch": [bls.g1_msm(p, k) for p, k in inp["segments"]],
            **{f"rlc_{c}": scalar.ecdsa_verify_batch(
                [(pk, m, sg) for m, sg, pk in items], c)
                for c, items in inp["ecdsa"].items()}}
    mgr = dispatch.crypto_mesh()
    mgr.set_shard_count(1)
    one_slot = _mesh_routes(inp)
    one_ms = {k: _route_ms(torch, f)
              for k, f in _mesh_route_calls(inp).items()}

    mgr.set_shard_count(0)
    if cards == 1:
        sharding.set_virtual_devices(MESH_SLOTS, dev)
    try:
        # (b) every route on 4 slots
        plan = dispatch.mesh_plan()
        flight.kernel_profiler().reset()
        reset_all_launches()
        four = _mesh_routes(inp)
        launches = {k: v for k, v in all_launches().items() if v}
        shard_rows = {k: v for k, v in
                      flight.kernel_profiler().snapshot().items()
                      if k.endswith(".shard")}
        # the plain versions on the card over the same inputs
        prep = ops.prepare_batch(inp["ed25519"])
        plain_ed = (ops.plain_verify_kernel(*ops.to_tensors(
            ops._pad_rows(prep, 256, 256), dev)).cpu().numpy()
            & prep.host_valid).tolist()
        plain_sha = {}
        for name in ("merkle", "mixed"):
            blob, offs = sha.pack(inp[name])
            raw = sha.plain_sha256_raw(*sha.to_device(blob, offs, dev))
            raw = raw.cpu().numpy().tobytes()
            plain_sha[name] = [raw[i:i + 32] for i in range(0, len(raw), 32)]

        def affine(xyz):
            cols = [c.cpu().numpy() for c in xyz]
            return [bops._to_affine_host(*(c[:, j] for c in cols))
                    for j in range(cols[0].shape[1])]
        # each curve's first shard folded by the kernel and by its plain
        # version, word for word
        from tpubft_torch.ops import ecdsa_cuda as ec
        rlc_fold_err = {}
        for c, items in inp["ecdsa"].items():
            rp = eops.prepare_rlc_batch(c, items)
            cols = eops.to_tensors(eops.rlc_columns(rp, range(32)), dev)
            rlc_fold_err[c] = int((ec.rlc(c, *cols).long()
                                   - eops.rlc_fold_plain(c, *cols).long())
                                  .abs().max())
        checks = {
            "ed25519": four["ed25519"] == one_slot["ed25519"]
            == host["ed25519"] == plain_ed,
            "sha256": four["sha256"] == one_slot["sha256"] == host["sha256"]
            == plain_sha["merkle"],
            "sha256_mixed": four["sha256_mixed"] == one_slot["sha256_mixed"]
            == host["sha256_mixed"] == plain_sha["mixed"],
            "msm": four["msm"] == one_slot["msm"] == host["msm"],
            "msm_batch": four["msm_batch"] == one_slot["msm_batch"]
            == host["msm_batch"],
            **{k: four[k] == one_slot[k] == host[k]
               for k in four if k.startswith("rlc_")},
            "rlc_fold_vs_plain": not any(rlc_fold_err.values())}
        # the combine kernel at the two MSM routes' shapes: the slots'
        # partials of config 4's MSM (S=1, D=4) and of the S=64 flush
        combine_rows = []
        # slot 0's shard of each MSM route, its kernel's partials, for
        # one plain call over both below
        slot0_segs, slot0_kernel = [], []
        for label, segs in (("S=64 D=4", inp["segments"]),
                            ("S=1 D=4", [inp["msm"]])):
            kw = max(len(p) for p, _ in segs)
            kmax = sharding.shard_rows(kw, slots) * slots
            rows = kmax // slots
            slot0_segs += [(list(p)[:rows], list(k)[:rows]) for p, k in segs]
            hostw = bops.prepare_msm_batch(
                [(list(p) + [None] * (kmax - len(p)),
                  list(k) + [0] * (kmax - len(p))) for p, k in segs])
            cols = [sharding._cols(a, a.ndim - 1, slots, j)
                    for j in range(slots) for a in hostw]
            parts = [bc.msm(*bops.to_tensors(cols[4 * j:4 * j + 4], dev))
                     for j in range(slots)]
            slot0_kernel += affine(parts[0])
            x, y, z = (torch.stack([p[c] for p in parts], -1).contiguous()
                       for c in range(3))
            got = affine(bc.combine(x, y, z))
            t0 = time.perf_counter()
            want = affine(bops.plain_combine(x, y, z))
            plain_ms = (time.perf_counter() - t0) * 1e3
            s_, d_ = int(x.shape[1]), int(x.shape[2])
            bound = work_bound_ms(*bc.combine_work(s_, d_), sm_clock_mhz)
            combine_rows.append({
                "shape": label, "max_abs_err": sum(
                    g != w for g, w in zip(got, want)),
                "ms": graph_ms(lambda: bc.combine(x, y, z), 20),
                "host_ms": cuda_ms(lambda: bc.combine(x, y, z), 20),
                "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
                "bound_by": bound["bound_by"], "ops": bound["ops"],
                "bytes": bound["bytes"]})
        # the MSM kernel against its plain version at the mesh routes'
        # shapes: slot 0's shard of each (64 segments of 4 points, one of
        # 256) in one plain call, the narrower lanes padded with the
        # identity (the plain ladder's time hardly grows with its lanes)
        t0 = time.perf_counter()
        slot0_plain = affine(bops.plain_msm_batch_kernel(*bops.to_tensors(
            bops.prepare_msm_batch(slot0_segs), dev)))
        plain_slot0_ms = (time.perf_counter() - t0) * 1e3
        checks["msm_slot0_vs_plain"] = slot0_kernel == slot0_plain
        mesh_ms = {k: _route_ms(torch, f)
                   for k, f in _mesh_route_calls(inp).items()}
        out["routes"] = {
            "route_bounds": _mesh_route_bounds(inp, sm_clock_mhz),
            "plan_slots": plan.n, "launches": launches,
            "shard_profile": shard_rows, "checks": checks,
            "rlc_fold_max_abs_err": rlc_fold_err,
            "msm_slot0_segments": len(slot0_segs),
            "plain_msm_slot0_ms": plain_slot0_ms,
            "route_ms_mesh": mesh_ms,
            "route_ms_one_slot": one_ms, "combine": combine_rows}
        emit({"phase": "mesh", "step": "routes", **out["routes"]})
        if plan.n != slots:
            problems.append(f"the plan has {plan.n} slots")
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            problems.append(f"mesh routes disagree: {bad}")
        for k in ("ed25519_verify", "sha256", "bls_msm"):
            if launches.get(k, 0) < slots:
                problems.append(f"{k} launched {launches.get(k, 0)} times")
        if launches.get("bls_msm_combine", 0) < 2:
            problems.append("bls_msm_combine not launched on the MSM routes")
        if any(r["max_abs_err"] for r in combine_rows):
            problems.append("bls_msm_combine disagrees with its plain version")
        for k in ("ed25519.shard", "sha256.shard", "bls_msm.shard",
                  "ecdsa.shard"):
            if k not in shard_rows:
                problems.append(f"no {k} profile row")
        out["combine_launches"] = launches.get("bls_msm_combine", 0)
        out["combine_rows"] = combine_rows

        # (c) slot 2 evicted in the middle of a flood, then readmitted
        br = dispatch.device_breaker()
        br.reset()
        br0 = br.snapshot()
        ev0 = mgr.snapshot()["evictions"]
        flood_ok = True
        for i in range(6):
            if i == 2:
                sharding.inject_chip_fault(sick)
            flood_ok &= ops.verify_batch(inp["ed25519"]).tolist() \
                == host["ed25519"]
            flood_ok &= eops.rlc_verify_batch(
                "secp256k1", inp["ecdsa"]["secp256k1"]).tolist() \
                == host["rlc_secp256k1"]
        snap = mgr.snapshot()
        health = HealthMonitor("mesh-phase", Aggregator()).verdict()
        evict = {"verdicts_exact": flood_ok,
                 "sick_slot": sick,
                 "sick_breaker": mgr.chip_breaker(sick).state,
                 "plan_slots": dispatch.mesh_plan().n,
                 "evictions": snap["evictions"] - ev0,
                 "last_rebalance_ms": snap["last_rebalance_ms"],
                 "device_breaker": br.state,
                 "device_breaker_failures":
                     br.snapshot()["failures"] - br0["failures"],
                 "health_mesh": health.get("mesh")}
        sharding.clear_chip_faults()
        t0 = time.monotonic()
        while dispatch.mesh_plan().n < slots \
                and time.monotonic() - t0 < 60:
            time.sleep(0.02)
        evict["readmitted_after_s"] = time.monotonic() - t0
        evict["plan_slots_after"] = dispatch.mesh_plan().n
        evict["readmits"] = mgr.snapshot()["readmits"]
        out["eviction"] = evict
        emit({"phase": "mesh", "step": "eviction", **evict})
        if not flood_ok or evict["sick_breaker"] == "closed" \
                or evict["plan_slots"] != slots - 1 \
                or evict["evictions"] != 1 or br.state != "closed" \
                or evict["device_breaker_failures"] \
                or (evict["health_mesh"] or {}).get("evicted") != [sick] \
                or evict["plan_slots_after"] != slots:
            problems.append(f"eviction: {evict}")

        # (d) config 1's cluster on the slots
        rep = phase_replica(torch, dev, target=cluster_writes,
                            label="mesh_replica")
        knobs = rep["tuner"].get("knobs_r0", {})
        cluster = {k: rep[k] for k in (
            "committed", "requests_per_s", "commit_latency_ms",
            "mesh_sharded_verifies", "verify_launches", "shard_profile")}
        cluster["crypto_shard_count"] = knobs.get("crypto_shard_count")
        out["cluster"] = cluster
        if cluster["crypto_shard_count"] is None:
            problems.append("crypto_shard_count is not registered")
        if not all(v > 0 for v in cluster["mesh_sharded_verifies"]):
            problems.append("a replica counted no sharded verify")

        # (e) the graft entry's dry run
        t0 = time.monotonic()
        graft_entry.dryrun_multichip(slots)
        out["dryrun_s"] = time.monotonic() - t0
    finally:
        sharding.clear_chip_faults()
        sharding.set_virtual_devices(None)
        mgr.reset()
    out["wall_s"] = time.monotonic() - t_phase
    emit({k: v for k, v in out.items()
          if k not in ("routes", "eviction", "default", "combine_rows")})
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


def phase_kernels(torch, dev, plane, replica, ledger_replica,
                  process_cluster, tls_cluster, persistent_cluster,
                  v4_cluster, kernel, ladder, ledger, digest, bls_plane,
                  bls_ledger, ecdsa_plane, ecdsa_ledger, offload, mesh,
                  sm_clock_mhz) -> dict:
    """Every kernel, timed at its path's shape: the verify kernel at one
    PrePrepare drain of 100 signatures, the ladder kernels at the ladder's
    1024 lanes, SHA-256 at a state-transfer window of 64 raw blocks that
    the ledger replica's catch-up digested."""
    import numpy as np

    from tpubft_torch import testing
    from tpubft_torch.ops import ed25519 as ops
    from tpubft_torch.ops import ed25519_cuda as kc
    # each sub-step's wall seconds, printed in the line
    steps_s = {}
    t_step = time.monotonic()
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
           # the main path's runs: the plane, the two in-process
           # clusters and the replica processes (configs 1 and 5, config
           # 1 on persistent ledgers and on the v4 engine)
           "launches": plane["launches"]["ed25519_verify"]
           + replica["verify_launches"] + ledger_replica["verify_launches"]
           + process_cluster["verify_launches"]
           + tls_cluster["verify_launches"]
           + persistent_cluster["verify_launches"]
           + v4_cluster["verify_launches"],
           "launches_by_path": {
               "plane": plane["launches"]["ed25519_verify"],
               "replica": replica["verify_launches"],
               "ledger_replica": ledger_replica["verify_launches"],
               "process_cluster": process_cluster["verify_launches"],
               "tls_cluster": tls_cluster["verify_launches"],
               "persistent_cluster": persistent_cluster["verify_launches"],
               "v4_cluster": v4_cluster["verify_launches"],
               "ladder": next(r["launches"] for r in ladder["rungs"]
                              if r["kernel"] == "ed25519_verify")},
           "replica_signatures_per_launch":
               replica["signatures_per_launch"],
           "max_abs_err": err, "batch": b,
           "host_ms": cuda_ms(lambda: kc.verify(*args), 20),
           "ms": graph_ms(lambda: kc.verify(*args), 20),
           # the match's call above warmed the plain version up
           "plain_ms": cuda_ms(lambda: ops.plain_verify_kernel(*args), 1,
                               warmup=0),
           "library_ms": None,
           "critical_path_steps": kc.critical_path_steps()["total"]}
    bound = verify_bound_ms(b, sm_clock_mhz)
    for k in ("bound_ms", "bound_by", "executed_ops", "ops"):
        row[k] = bound[k]
    rows = [row]

    def step(name):
        nonlocal t_step
        now = time.monotonic()
        steps_s[name] = now - t_step
        t_step = now
    step("ed25519_verify")
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
    step("ladder_rows")
    rows.append(sha256_kernel_row(torch, dev, ledger_replica,
                                  process_cluster, persistent_cluster,
                                  v4_cluster, ledger, digest, sm_clock_mhz))
    step("sha256")
    rows += bls_kernel_rows(torch, dev, bls_plane, bls_ledger, offload,
                            sm_clock_mhz)
    step("bls")
    rows += ecdsa_kernel_rows(torch, dev, ecdsa_plane, ecdsa_ledger, offload,
                              tls_cluster, sm_clock_mhz)
    step("ecdsa")
    rows.append(combine_kernel_row(mesh))
    step("combine")
    emit({"phase": "kernels", "steps_s": steps_s})
    out = {"kernels": rows}
    emit(out)
    bad = [r["name"] for r in rows if r["max_abs_err"]]
    if bad:
        raise AssertionError(f"kernels disagree with plain versions: {bad}")
    bad = [r["name"] for r in rows if r.get("native_mismatches")]
    if bad:
        raise AssertionError(f"kernels disagree with the host engine: {bad}")
    idle = sorted({r["name"] for r in rows if r["launches"] < 1
                   and r.get("path", "").startswith(("config", "batch",
                                                     "ECDSA", "ops/ecdsa"))})
    if idle:
        raise AssertionError(f"kernels not launched on their path: {idle}")
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


def sha256_kernel_row(torch, dev, ledger_replica, process_cluster,
                      persistent_cluster, v4_cluster, ledger, digest,
                      sm_clock_mhz) -> dict:
    """The SHA-256 kernel at the shape the main path launched it: one
    full window (64 raw blocks) that the ledger replica's catch-up
    digested, timed and held against its plain version there; also
    against the plain version on the digest phase's first window, its
    mixed window and a 1024-node Merkle level. Launches are the ledger
    replica's catch-up windows, the restarted replica processes' (empty
    in process_cluster, on their kvlog files in persistent_cluster, on a
    snapshot-provisioned v4 ledger in v4_cluster), the read-only replica
    process's fetched windows (in persistent_cluster) and the digest
    phase's (the migrate-chunk ledger launched none), the stress
    ledger's beside them."""
    import hashlib

    from tpubft_torch.ops import sha256 as sha
    from tpubft_torch.ops import sha256_cuda
    window = ledger_replica["window_raws"]
    first, mixed = digest["window_raws"]
    errs, inputs = {}, {}
    for name, msgs in (("digest_window", first),
                       ("mixed_window", mixed),
                       ("merkle_level_1024", merkle_messages(1024, seed=8)),
                       ("catch_up_window", window)):
        data, offs, host = inputs[name] = sha256_inputs(msgs, dev)
        got = sha256_cuda.sha256_raw(data, offs, host)
        plain = sha.plain_sha256_raw(data, offs)
        errs[name] = int((got.int() - plain.int()).abs().max())
    t0 = time.perf_counter()
    for r in window:
        hashlib.sha256(r).digest()
    hashlib_ms = (time.perf_counter() - t0) * 1e3

    def call():
        return sha256_cuda.sha256_raw(data, offs, host)
    lengths = [len(r) for r in window]
    bound = work_bound_ms(*sha256_cuda.work(lengths), sm_clock_mhz)
    return {"name": "sha256", "route": "cuda",
            "source": "tpubft_torch/ops/csrc/sha256.cu",
            "replaces": "tpubft/ops/sha256.py:82 (and :178)",
            "launches": ledger_replica["sha256_launches"]
            + process_cluster["sha256_launches"]
            + persistent_cluster["sha256_launches"]
            + v4_cluster["sha256_launches"]
            + persistent_cluster["ro_replica"]["sha256_launches"]
            + digest["launches"]
            + ledger["migrate_chunks"]["sha256_launches"],
            "launches_by_path": {
                "ledger_replica_catch_up": ledger_replica["sha256_launches"],
                "process_cluster_catch_up":
                    process_cluster["sha256_launches"],
                "persistent_cluster": persistent_cluster["sha256_launches"],
                "v4_cluster": v4_cluster["sha256_launches"],
                "ro_replica": persistent_cluster["ro_replica"][
                    "sha256_launches"],
                "digest": digest["launches"],
                "migrate_chunks": ledger["migrate_chunks"]["sha256_launches"]},
            "stress_launches": ledger["stress"]["sha256_launches"],
            "max_abs_err": max(errs.values()), "max_abs_err_by_input": errs,
            "batch": len(window), "bytes_in": sum(lengths),
            "compressions": int(sum(sha.blocks_needed(n) for n in lengths)),
            "host_ms": cuda_ms(call, 50),
            "ms": graph_ms(call, 50),
            "digest_window_ms": graph_ms(
                lambda: sha256_cuda.sha256_raw(*inputs["digest_window"]), 20),
            "mixed_window_ms": graph_ms(
                lambda: sha256_cuda.sha256_raw(*inputs["mixed_window"]), 20),
            "mixed_window_chain_floor_ms": sha256_cuda.chain_floor_ms(
                [len(r) for r in mixed], sm_clock_mhz),
            "plain_ms": cuda_ms(lambda: sha.plain_sha256_raw(data, offs), 1,
                                warmup=0),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "ops": bound["ops"], "bytes": bound["bytes"],
            "chain_floor_ms": sha256_cuda.chain_floor_ms(lengths,
                                                         sm_clock_mhz),
            "round_cycles": sha256_cuda.ROUND_CYCLES,
            "library_ms": None,
            "hashlib_host_ms": hashlib_ms,
            "path": "state-transfer digests (ledger replica catch-up)"}


def combine_kernel_row(mesh) -> dict:
    """bls_msm_combine at the mesh phase's S=64 flush shape (its 4
    slots' partials), with the config-4 shape beside it; launches are the
    mesh phase's sharded MSM routes."""
    flush, config4 = mesh["combine_rows"]
    return {"name": "bls_msm_combine", "route": "cuda",
            "source": "tpubft_torch/ops/csrc/bls12_381_msm.cu",
            "replaces": "tpubft/parallel/sharding.py:80-85 (all_gather + "
                        "msm_reduce; :219-223)",
            "path": "mesh: sharded msm / msm_batch on 4 slots of one card",
            "launches": mesh["combine_launches"],
            **{k: flush[k] for k in ("shape", "max_abs_err", "ms",
                                     "host_ms", "plain_ms", "bound_ms",
                                     "bound_by", "ops", "bytes")},
            "max_abs_err": flush["max_abs_err"] + config4["max_abs_err"],
            "config4": config4, "library_ms": None}


def bls_kernel_rows(torch, dev, bls_plane, bls_ledger, offload,
                    sm_clock_mhz) -> list:
    """The BLS kernels at their paths' shapes: bls_msm at config 2's
    flush (S=64 segments of K=5 Lagrange-weighted shares, the plane's
    threshold flush) and at config 4's combine (S=1, K=667), bls_mul at
    667 lanes. Each against its plain version on the card (mismatching
    affine points) and the native host engine, its device time by CUDA
    graph, host issue time, the host half's time apart from the launch,
    its bound from the field multiplies these scalars need (the cheapest
    of Straus and Pippenger, signed, with or without the GLV split), the
    kernel's own multiplies (`kernel_field_muls`) and its chain floor:
    the steps of its longest dependent chain (two products side by side
    a step) at the cycles that this run's clock64 probe read for the
    lanes an element the launch took; and the native host Pippenger's
    time as a yardstick (no PyTorch call computes a G1 MSM)."""
    from tpubft_torch.crypto import bls12381 as bls
    from tpubft_torch.ops import bls12_381 as bops
    from tpubft_torch.ops import bls12_381_cuda as bc
    lp = bls_plane["launches_by_path"]
    seg = bls_plane["segments"]
    probe = bc.probe(dev, bc.LANES)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ledger_launches = bls_ledger["load"]["bls_msm_launches"]
    cases = (
        ("bls_msm", "S=64 K=5", seg["flush"],
         {"bls_plane_threshold_flush": lp["threshold_flush"],
          "bls_plane_multisig_flush": lp["multisig_flush"],
          "bls_ledger_replica": ledger_launches,
          # offload off, the liar's one re-run, the bad slots' re-run
          "offload": offload["launches_by_path"]["bls_msm"]},
         "config 2's fused certificate flush (CombineBatcher)"),
        ("bls_msm", "S=1 K=667", seg["config4"],
         {"bls_plane_config4_combine": lp["config4_combine"]},
         "config 4's combine (CudaBlsThresholdAccumulator)"),
        ("bls_mul", "B=667", seg["scalar_mul"],
         {"bls_plane_config4_scalar_mul": lp["config4_scalar_mul"]},
         "batch_scalar_mul of config 4's shares"))
    rows = []
    for name, shape, data, by_path, path in cases:
        reduce = name == "bls_msm"
        t0 = time.perf_counter()
        host = (bops.prepare_msm_batch(data) if reduce
                else bops._prep_msm(*data))
        prep_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        args = bops.to_tensors(host, dev)
        torch.cuda.synchronize()
        copy_ms = (time.perf_counter() - t0) * 1e3
        kern = bc.msm if reduce else bc.scalar_mul
        plain = (bops.plain_msm_batch_kernel if reduce
                 else bops.plain_scalar_mul_kernel)

        def affine(xyz):
            cols = [c.cpu().numpy() for c in xyz]
            return [bops._to_affine_host(*(c[:, j] for c in cols))
                    for j in range(cols[0].shape[1])]
        got = affine(kern(*args))
        t0 = time.perf_counter()
        want_plain = affine(plain(*args))
        plain_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        if reduce:
            native = [bls.g1_msm(p, k) for p, k in data]
        else:
            native = [bls.g1_mul(p, k) for p, k in zip(*data)]
        native_ms = (time.perf_counter() - t0) * 1e3
        bound = work_bound_ms(*bc.work(host[0], host[3], reduce),
                              sm_clock_mhz)
        s, k = host[3].shape if reduce else (host[3].size, 1)
        counts = bc.kernel_counts(s, k, sms)
        rows.append({
            "name": name, "route": "cuda",
            "source": "tpubft_torch/ops/csrc/bls12_381_msm.cu",
            "replaces": ("tpubft/ops/bls12_381.py:137 (msm_batch_kernel; "
                         "msm_kernel :46)" if reduce else
                         "tpubft/ops/bls12_381.py:241 "
                         "(batch_scalar_mul's kernel)"),
            "shape": shape, "path": path,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": sum(g != w for g, w in zip(got, want_plain)),
            "native_mismatches": sum(g != w for g, w in zip(got, native)),
            "results": len(got), "lanes": int(host[3].size),
            "ms": graph_ms(lambda: kern(*args), 3, replays=3),
            "host_ms": cuda_ms(lambda: kern(*args), 3),
            "host_prep_ms": prep_ms, "copy_in_ms": copy_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "ops": bound["ops"], "bytes": bound["bytes"],
            "field_muls": bound["ops"] // bc.OPS_PER_FIELD_MUL,
            "kernel_field_muls": counts["field_muls"],
            "chain_steps": counts["chain_steps"],
            "chain_floor_ms": bc.chain_floor_ms(
                counts["chain_steps"], probe, sm_clock_mhz),
            "cycles_per_field_mul": probe["cycles_per_field_mul"],
            "cycles_per_mul_pair": probe["cycles_per_mul_pair"],
            "cycles_per_dbl": probe["cycles_per_dbl"],
            "lanes_per_element": bc.LANES, "plan": counts["plan"],
            "library_ms": None, "native_host_ms": native_ms})
    return rows


# Each phase's ceiling in seconds: three times its seconds in the
# `timing` line of the recorded run that PERF.md §6 names as their
# source (this script from a git archive on an H100 80GB HBM3 at 700 W,
# `done` at 918.5 s), and at least 90 s. The phases not named there took
# 25.9 s or less, so 90 s. The whole run's ceiling keeps it under the
# 1,200 s limit.
CALL11_PHASE_S = {"ledger_replica": 190.8, "kernels": 92.3,
                  "persistent_cluster": 89.2, "tls_cluster": 83.1,
                  "v4_cluster": 81.1, "mesh": 70.0,
                  "ecdsa_ledger_replica": 69.6, "process_cluster": 48.9,
                  "bls_ledger_replica": 32.7, "replica": 30.6}
PHASES = ("device", "ladder", "kernel", "plane", "replica",
          "ledger_replica", "process_cluster", "tls_cluster",
          "persistent_cluster", "v4_cluster", "bls_plane",
          "bls_ledger_replica", "ecdsa_plane", "ecdsa_ledger_replica",
          "offload", "mesh", "ledger", "digest", "rate", "kernels")
PHASE_CEILING_S = {p: round(max(90.0, 3 * CALL11_PHASE_S.get(p, 0.0)), 1)
                   for p in PHASES}
RUN_CEILING_S = 1140.0
# main()'s cuts of depth: in-process config 1 at smaller checkpoint and
# work windows (the process phases run 150/300), fewer writes where
# another phase drives the same path.
SMOKE_CUTS = {"replica_target": 1000, "ledger_checkpoint_window": 50,
              "ledger_work_window": 100, "ecdsa_ledger_target": 150,
              "mesh_cluster_writes": 300}


def _child_pids(root: int) -> list:
    """Every live descendant of process `root`, from /proc."""
    parents = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # the fields after the command's closing parenthesis
        parents.setdefault(int(stat.rsplit(")", 1)[1].split()[1]),
                           []).append(int(d))
    out, todo = [], [root]
    while todo:
        kids = parents.get(todo.pop(), [])
        out += kids
        todo += kids
    return out


class Watchdog:
    """Holds every phase to its ceiling and the whole run to its own. A
    thread checks every `poll_s`; when the phase in progress (or the
    run) passes its ceiling it prints {"phase", "error": "over its
    ceiling", "elapsed_s", "ceiling_s"}, dumps every thread's stack
    (faulthandler), prints the tails of the replica processes' logs
    (the `chip-smoke-*` directories under the temporary directory),
    kills every process this one started, and exits 1. It never skips a
    phase: the run ends there."""

    def __init__(self, ceilings=None, run_ceiling_s: float = RUN_CEILING_S,
                 poll_s: float = 0.5):
        import threading
        self.ceilings = dict(PHASE_CEILING_S if ceilings is None
                             else ceilings)
        self.run_ceiling_s = run_ceiling_s
        self.poll_s = poll_s
        self.t_run = time.monotonic()
        self.phase, self.t_phase = "device", self.t_run
        self.phase_s = {}
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="chip-smoke-watchdog")

    def start(self) -> "Watchdog":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._done.set()

    def timed(self, name, fn, *args):
        """Run phase `name`, `fn(*args)`, under its ceiling; its wall
        seconds go to `phase_s`."""
        self.phase, self.t_phase = name, time.monotonic()
        try:
            return fn(*args)
        finally:
            self.phase_s[name] = time.monotonic() - self.t_phase

    def _watch(self) -> None:
        while not self._done.wait(self.poll_s):
            now = time.monotonic()
            phase, t_phase = self.phase, self.t_phase
            ceiling = self.ceilings.get(phase, 90.0)
            if now - t_phase > ceiling:
                self._fire(phase, now - t_phase, ceiling)
            elif now - self.t_run > self.run_ceiling_s:
                self._fire("run", now - self.t_run, self.run_ceiling_s)

    def _fire(self, phase: str, elapsed: float, ceiling: float) -> None:
        import faulthandler
        import signal
        import tempfile
        emit({"phase": phase, "error": "over its ceiling",
              "elapsed_s": elapsed, "ceiling_s": ceiling,
              "in_phase": self.phase, "phase_s": self.phase_s})
        sys.stdout.flush()
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        tmp = tempfile.gettempdir()
        for d in sorted(os.listdir(tmp)):
            path = os.path.join(tmp, d)
            if d.startswith("chip-smoke-") and os.path.isdir(path):
                for sub, _dirs, files in os.walk(path):
                    if any(f.endswith(".log") for f in files):
                        print(f"==== {sub} ====", file=sys.stderr)
                        _print_log_tails_of(sub, [f for f in files
                                                  if f.endswith(".log")])
        for pid in _child_pids(os.getpid()):
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        fail(f"phase {phase} over its ceiling of {ceiling:g} s")
        sys.stderr.flush()
        os._exit(1)


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "tpubft_torch")):
        return fail("the tpubft_torch package is not beside chip_smoke.py")
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: no card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    watchdog = Watchdog().start()
    t_start = watchdog.t_run
    # each phase's wall seconds, printed before `done`
    phase_s = watchdog.phase_s
    timed = watchdog.timed
    info = timed("device", phase_device, torch)
    clock = info["clocks_max_sm_mhz"]
    if sys.argv[1:] == ["--mesh"]:
        # the mesh phase alone: over the host's cards where it has
        # several, else over virtual slots of the one card
        timed("mesh", phase_mesh, torch, dev, clock)
        watchdog.stop()
        emit({"phase": "done", "wall_s": time.monotonic() - t_start})
        print(info["nvidia_smi"], flush=True)
        return 0
    ladder = timed("ladder", phase_ladder, torch, dev, clock)
    kernel = timed("kernel", phase_kernel, torch, dev)
    plane = timed("plane", phase_plane, torch, dev)
    # The cuts of depth (each printed under its phase's `reduced`; PERF.md
    # §4 has their seconds before and after). The deployment's settings
    # still run whole elsewhere: config 1's windows 150/300 in the
    # process phases, config 3 at n=31 with its timers.
    replica = timed("replica", lambda: phase_replica(
        torch, dev, target=SMOKE_CUTS["replica_target"]))
    ledger_replica = timed("ledger_replica", lambda: phase_ledger_replica(
        torch, dev, checkpoint_window=SMOKE_CUTS["ledger_checkpoint_window"],
        work_window=SMOKE_CUTS["ledger_work_window"]))
    process_cluster = timed("process_cluster", phase_process_cluster,
                            torch, dev, ledger_replica)
    tls_cluster = timed("tls_cluster", phase_tls_cluster, torch, dev)
    persistent_cluster = timed("persistent_cluster",
                               phase_persistent_cluster, torch, dev,
                               process_cluster)
    v4_cluster = timed("v4_cluster", phase_v4_cluster, torch, dev,
                       persistent_cluster)
    bls_plane = timed("bls_plane", phase_bls_plane, torch, dev)
    bls_ledger = timed("bls_ledger_replica", phase_bls_ledger_replica,
                       torch, dev)
    ecdsa_plane = timed("ecdsa_plane", phase_ecdsa_plane, torch, dev)
    ecdsa_ledger = timed("ecdsa_ledger_replica", lambda: (
        phase_ecdsa_ledger_replica(
            torch, dev, target=SMOKE_CUTS["ecdsa_ledger_target"])))
    offload = timed("offload", phase_offload, torch, dev, bls_plane,
                    ecdsa_plane)
    mesh = timed("mesh", lambda: phase_mesh(
        torch, dev, clock,
        cluster_writes=SMOKE_CUTS["mesh_cluster_writes"]))
    ledger = timed("ledger", phase_ledger, torch, dev)
    digest = timed("digest", phase_digest, torch, dev, ledger.pop("raws"))
    timed("rate", phase_rate, torch, dev, clock, info["nvidia_smi"])
    timed("kernels", phase_kernels, torch, dev, plane, replica,
          ledger_replica, process_cluster, tls_cluster, persistent_cluster,
          v4_cluster, kernel, ladder, ledger, digest, bls_plane, bls_ledger,
          ecdsa_plane, ecdsa_ledger, offload, mesh, clock)
    emit({"phase": "timing", "phase_s": phase_s,
          "ceiling_s": watchdog.ceilings, "run_ceiling_s": RUN_CEILING_S})
    watchdog.stop()
    emit({"phase": "done", "wall_s": time.monotonic() - t_start})
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
