"""The replica: SBFT protocol state machine (slow path first).

Rebuild of the reference's ReplicaImp
(concord-bft bftengine/src/bftengine/ReplicaImp.{hpp,cpp}): message
handlers per MsgCode (onMessage<ClientRequestMsg> :397,
onMessage<PrePrepareMsg> :1047, tryToSendPrePrepareMsg :657,
sendPreparePartial :1373, sendCommitPartial :1399,
executeNextCommittedRequests :5720), driven by the single dispatcher
thread; threshold combine/verify jobs run on the collector pool and
re-enter as internal msgs, exactly the reference's
CollectorOfThresholdSignatures round trip.

Commit flow implemented here (slow path, the PBFT-like 2-round core):
  ClientRequest → [primary] batch → PrePrepare
  → every replica sends PreparePartial (threshold share) to the collector
  → collector combines 2f+c+1 shares → PrepareFull broadcast → prepared
  → every replica sends CommitPartial → collector → CommitFull → committed
  → execute in seqnum order → ClientReply
Fast-path (PartialCommitProof/FullCommitProof) arrives in the fast-path
module; this replica already persists + window-manages for it.
"""
from __future__ import annotations

import abc
import collections
import json
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from tpubft_torch.comm.interfaces import ICommunication, IReceiver
from tpubft_torch.consensus import messages as m
from tpubft_torch.consensus.aggregation import overlay_for
from tpubft_torch.consensus.clients_manager import ClientsManager
from tpubft_torch.consensus.collectors import (ByzTelemetry, CollectorPool,
                                         CombineResult, ShareCollector)
from tpubft_torch.consensus.controller import CommitPathController
from tpubft_torch.consensus.epoch import EpochManager
from tpubft_torch.consensus.incoming import Dispatcher, IncomingMsgsStorage
from tpubft_torch.consensus.keys import ClusterKeys
from tpubft_torch.consensus.persistent import (InMemoryPersistentStorage,
                                         PersistentStorage,
                                         restore_replica_state)
from tpubft_torch.consensus.replicas_info import ReplicasInfo
from tpubft_torch.consensus.seq_num_info import ActiveWindow, SeqNumInfo
from tpubft_torch.consensus.sig_manager import SigManager
from tpubft_torch.consensus.view_change import (CERT_COMMIT, CERT_FAST_OPT,
                                          CERT_FAST_THR, CERT_PREPARE,
                                          CERT_SIGNED, Restriction,
                                          ViewChangeState,
                                          build_certificates,
                                          compute_restrictions, pack_cert,
                                          pack_restriction, unpack_cert,
                                          unpack_restriction,
                                          validate_certificate)
from tpubft_torch.crypto.digest import digest as sha256
# hot-loop imports hoisted to module scope: the execution path used to
# re-run these per request per slot (function-level `import` still pays
# a sys.modules lookup + binding on every execution)
from tpubft_torch.diagnostics import TimeRecorder
from tpubft_torch.testing.crashpoints import crashpoint
from tpubft_torch.testing.slowdown import PHASE_EXECUTE
from tpubft_torch.utils import flight
from tpubft_torch.utils.config import ReplicaConfig
from tpubft_torch.utils.logging import get_logger, mdc_scope
from tpubft_torch.utils.metrics import Aggregator, Component
from tpubft_torch.utils.racecheck import make_lock

log = get_logger("replica")


def share_digest(kind: str, epoch: int, view: int, seq_num: int,
                 pp_digest: bytes) -> bytes:
    """Domain-separated digest each threshold share signs: 'prepare' and
    'commit' rounds must not be cross-replayable (the reference separates
    them by message type inside the signed blob). The reconfiguration ERA
    is bound into the signed bytes, so the era gate on Prepare/Commit
    shares and FullCommitProof no longer rests on the unauthenticated
    `epoch` wire field — a share signed in a dead era can never combine
    into (or validate as) a certificate for the current one."""
    return sha256(kind.encode() + b"|"
                  + struct.pack("<QQQ", epoch, view, seq_num) + pp_digest)


class IRequestsHandler(abc.ABC):
    """Execution upcall (reference IRequestsHandler.hpp / RequestHandler)."""

    @abc.abstractmethod
    def execute(self, client_id: int, req_seq: int, flags: int,
                request: bytes) -> bytes: ...

    def read(self, client_id: int, request: bytes) -> bytes:
        """Read-only query — must not mutate state."""
        return b""

    def state_digest(self) -> bytes:
        """Digest of app state for checkpoint agreement."""
        return b"\x00" * 32

    # ---- pre-execution (reference IRequestsHandler PRE_PROCESS flag) ----
    def pre_execute(self, client_id: int, req_seq: int,
                    request: bytes) -> Optional[bytes]:
        """Speculative, side-effect-free execution. The returned bytes
        must be DETERMINISTIC across replicas regardless of their current
        state height (they are hashed for f+1 agreement). None =
        unsupported → the request falls back to normal ordering."""
        return None

    def apply_pre_executed(self, client_id: int, req_seq: int, flags: int,
                           original_request: bytes,
                           result: bytes) -> bytes:
        """Commit a pre-executed result, re-checking conflicts against
        current state. Default: execute the original normally."""
        return self.execute(client_id, req_seq, flags, original_request)

    def pre_exec_conflicted(self, client_id: int, req_seq: int,
                            original_request: bytes,
                            result: bytes) -> bool:
        """Commit-time conflict check for a pre-executed result: True
        when the result's read set is stale against CURRENT state (it
        was computed over an older snapshot) — the replica then falls
        back to ordering the original request normally in the same
        slot. Must be side-effect free. Default: never conflicted."""
        return False


class Replica(IReceiver):
    def __init__(self, cfg: ReplicaConfig, keys: ClusterKeys,
                 comm: ICommunication, handler: IRequestsHandler,
                 storage: Optional[PersistentStorage] = None,
                 aggregator: Optional[Aggregator] = None,
                 reserved_pages=None):
        cfg.validate()
        self.cfg = cfg
        self.id = cfg.replica_id
        self.info = ReplicasInfo.from_config(cfg)
        self.keys = keys
        self.comm = comm
        self.handler = handler
        self.storage = storage or InMemoryPersistentStorage()
        self.aggregator = aggregator or Aggregator()

        # crypto backend selection (the project's north star: the same
        # plugin boundaries the reference routes to CPU crypto —
        # SigManager.cpp:197, IThresholdVerifier.h:23 — route to the
        # batched CUDA kernels when crypto_backend == "cuda"; "auto"
        # means "cuda", with no probe and no CPU fallback)
        # --- degradation plane: device circuit breaker + health
        # watchdog (utils/breaker.py + consensus/health.py). The breaker
        # is process-wide (one accelerator per process); every replica
        # pushes its config — last writer wins, and all replicas of one
        # process share the verdicts, which matches sharing the device.
        from tpubft_torch.consensus.health import HealthMonitor
        from tpubft_torch.ops.dispatch import device_breaker
        device_breaker().configure(
            failure_threshold=cfg.breaker_failure_threshold,
            cooldown_s=cfg.breaker_cooldown_ms / 1e3,
            latency_slo_s=cfg.breaker_latency_slo_ms / 1e3,
            max_cooldown_s=cfg.breaker_cooldown_ms / 1e3 * 16)
        # --- verified crypto-offload tier (tpubft/offload/): lease the
        # heavy MSM/combine work to untrusted helper processes; every
        # returned result passes the constant-size soundness check
        # on-replica before it can influence any verdict. The pool is
        # process-wide like the device breaker (helpers serve the
        # process, not one replica); endpoint list is additive so
        # in-process tests can pre-register InprocHelper transports.
        if cfg.offload_enabled:
            from tpubft_torch.ops.dispatch import offload_pool
            pool = offload_pool()
            pool.configure(enabled=True,
                           lease_timeout_ms=cfg.offload_lease_timeout_ms,
                           max_inflight=cfg.offload_max_inflight)
            for ep in filter(None, cfg.offload_helpers.split(",")):
                hid, addr = ep.split("=", 1)
                host, port = addr.rsplit(":", 1)
                pool.add_endpoint(hid.strip(), host.strip(), int(port))
        self.health = HealthMonitor(f"replica{cfg.replica_id}",
                                    self.aggregator,
                                    poll_s=cfg.health_poll_ms / 1e3)
        self.health.register_probe(
            "dispatcher", cfg.health_stall_ms / 1e3,
            detail_fn=lambda: {
                "external_q": self.incoming.external_depth,
                "internal_q": self.incoming.internal_depth})

        from tpubft_torch.crypto.backend import resolve_backend
        backend = self.crypto_backend = resolve_backend(cfg.crypto_backend)
        # write the RESOLVED backend back: every later consumer of the
        # config (device hashing in kvbc, the startup log, metrics) must
        # see "cpu"/"cuda", never the unresolved "auto"
        cfg.crypto_backend = backend
        batch_fn = None
        # Port divergence (reference replica.py:185-194): "cuda" routes
        # the cross-principal batches to crypto/cuda.verify_batch_mixed.
        # default_device() raises device.NoDevice here, when the replica
        # is built, if there is no card and the caller did not ask for
        # the CPU (rather than later, inside a worker thread).
        if backend == "cuda":
            from tpubft_torch import device as _device
            from tpubft_torch.crypto import cuda as cuda_backend
            _device.default_device()
            batch_fn = cuda_backend.verify_batch_mixed
        # singleton verifies stay on the CPU verifiers even with the CUDA
        # backend (latency-critical, can't amortize a dispatch); batches
        # of >= device_min_verify_batch ride the device kernel (ECDSA
        # items: crypto/cuda.ecdsa_crossover decides, in SigManager)
        self.sig = SigManager(
            keys, self.aggregator,
            alias_fn=lambda p: (self.info.owner_of_internal_client(p)
                                if self.info.is_internal_client(p) else p),
            grace_seq_window=cfg.work_window_size,
            batch_fn=batch_fn,
            device_min_batch=cfg.device_min_verify_batch)
        # threshold machinery per commit path (CryptoManager.hpp:109-111):
        # slow = 2f+c+1, fast-with-threshold = 3f+c+1, optimistic = n.
        # Port divergence (reference replica.py:208-219): "cuda" reaches
        # the port's ClusterKeys.threshold_verifier, which builds
        # crypto/cuda.CudaMultisigEd25519Verifier.
        min_dev = cfg.device_min_verify_batch
        self.slow_signer = keys.threshold_signer(keys.slow_path_system,
                                                 self.id)
        self.slow_verifier = keys.threshold_verifier(keys.slow_path_system,
                                                     backend, min_dev)
        self.thr_signer = keys.threshold_signer(keys.commit_path_system,
                                                self.id)
        self.thr_verifier = keys.threshold_verifier(keys.commit_path_system,
                                                    backend, min_dev)
        self.opt_signer = keys.threshold_signer(keys.optimistic_system,
                                                self.id)
        self.opt_verifier = keys.threshold_verifier(keys.optimistic_system,
                                                    backend, min_dev)
        self.controller = CommitPathController(cfg.f_val, cfg.c_val)

        # --- share-aggregation overlay (consensus/aggregation.py) ---
        # Active only when the RESOLVED threshold scheme supports partial
        # aggregation (multisig-bls: unweighted G1 sums compose; Shamir
        # shares cannot — interfaces.IThresholdAccumulator.add_partial).
        # A pinned incompatible scheme degrades to "off" rather than
        # refusing to start; config.validate rejects the loud cases.
        self._agg_mode = (cfg.share_aggregation
                          if getattr(keys, "threshold_scheme", "")
                          == "multisig-bls" else "off")
        self._agg_fanout = max(2, cfg.agg_fanout)
        # interior-node banking: (view, seq, kind, digest) -> {entry_key:
        # raw 48B share | 56B partial}, entry keys 1-based (signer id for
        # raw, forwarding child + 1 for partials) — the same keying the
        # root's ShareCollector uses, so bad-entry isolation composes
        self._agg_buffers: Dict[tuple, Dict[int, bytes]] = {}
        self._agg_buffer_born: Dict[tuple, float] = {}
        # membership snapshot of the last flush per buffer: flushes are
        # CUMULATIVE — a buffer re-flushes (as a superset partial that
        # supersedes the previous one upstream) whenever new members
        # arrived, so an early age-based flush never strands the
        # children that were still in flight
        self._agg_flushed: Dict[tuple, frozenset] = {}
        # leaf/interior liveness floor: (view, seq, kind) -> (deadline,
        # share msg, collector id); on parent timeout the original share
        # re-sends DIRECT to the collector — aggregation can delay a
        # slot by at most agg_parent_timeout_ms, never lose it
        self._agg_fallback: Dict[tuple, tuple] = {}
        # parent id -> view in which its edge proved dead: shares route
        # around a sick parent for the rest of that view (the overlay
        # reshuffles at the view change, which implicitly pardons it)
        self._agg_sick: Dict[int, int] = {}

        # --- protocol state (dispatcher-thread only) ---
        st, window_msgs = restore_replica_state(self.storage)
        self.view = st.last_view
        self.last_executed = st.last_executed_seq
        self.last_stable = st.last_stable_seq
        self.primary_next_seq = max(st.last_executed_seq,
                                    st.last_stable_seq) + 1
        self.window: ActiveWindow[SeqNumInfo] = ActiveWindow(
            cfg.work_window_size, SeqNumInfo)
        self.window.advance(st.last_stable_seq)
        # bounded client table (million-principal shape): resident
        # records LRU-capped at client_table_max, cold clients demand-
        # paged back from their reply-ring reserved pages (the pager
        # replays the per-client restart rule). 0 = legacy unbounded
        # table with eager boot restore.
        self.clients = ClientsManager(
            self.info.all_client_ids(),
            max_resident=cfg.client_table_max,
            pager=(self._page_in_client
                   if cfg.client_table_max > 0 else None))
        self.pending_requests: List[m.ClientRequestMsg] = []
        self.checkpoints: Dict[int, Dict[int, m.CheckpointMsg]] = {}
        # highest checkpoint seq stored per sender (memory bound: the
        # checkpoints dict holds at most one message per replica)
        self._ck_latest_seq: Dict[int, int] = {}
        # quorum-certified checkpoints ahead of us: seq -> state digest
        # (the trust anchor handed to state transfer)
        self.certified_checkpoints: Dict[int, bytes] = {}

        # --- view change state (ViewsManager equivalent) ---
        self.vc = ViewChangeState(self.info.complaint_quorum,
                                  self.info.view_change_quorum)
        self.in_view_change = st.in_view_change
        # restore the in-flight target too: a crash after vc.persist must
        # resume the SAME view change (start() retransmits the rebuilt
        # ViewChangeMsg — peers may be counting this replica toward the
        # view-change quorum)
        self.pending_view: Optional[int] = (
            st.pending_view if st.in_view_change and st.pending_view
            else None)
        # safety state surviving crashes mid-view-change (the reference
        # persists view-change descriptors, PersistentStorageDescriptors):
        # restrictions = what the current view's primary must re-propose;
        # carried_certs = evidence from earlier views, keyed by
        # (seq, is_signed_element) — a threshold cert and our own SIGNED
        # report can coexist for one seqnum
        self.restrictions: Dict[int, Restriction] = {
            r.seq_num: r for r in map(unpack_restriction, st.restrictions)}
        self.carried_certs: Dict[tuple, m.PreparedCertificate] = {}
        for raw in st.carried_certs:
            cert = unpack_cert(raw)
            self.carried_certs[(cert.seq_num, cert.kind == CERT_SIGNED)] = cert
        # pp_digest -> packed PrePrepare for every digest-only certificate
        # we hold evidence for: certs travel without bodies (the VERDICT's
        # O(batch x window) ViewChangeMsg fix), so bodies live here to
        # resolve our own restrictions and answer peers' fetches
        self.vc_bodies: Dict[bytes, bytes] = {}
        for raw in st.carried_bodies:
            pp = m.unpack(raw)
            self.vc_bodies[pp.digest()] = raw
        # (new_view, restrictions, missing pp_digest set) when view entry
        # is blocked on fetching restricted batch bodies
        self._pending_entry: Optional[tuple] = None
        self._my_vc_msg: Optional[m.ViewChangeMsg] = None
        # proof of the view we're in, kept for status-driven retransmission
        # to lagging peers (reference: RetransmissionsManager + status)
        self._entered_view_proof: Optional[tuple] = None
        self._complained_views: set = set()
        self._vc_started_at = 0.0
        self._last_progress = time.monotonic()
        # the view in which last_executed last advanced and the slots
        # the view we are in re-proposed (_no_progress_factor); the last
        # views entered, each with its time to its first execution
        # (`status get views`)
        self._progress_view = self.view
        self._reproposed = 0
        self._view_entries: collections.deque = collections.deque(maxlen=32)
        self._forwarded: Dict[tuple, float] = {}   # (client, req_seq) -> time
        # client -> (head req_seq of last relayed batch, relay time):
        # backup batch-relay suppression (see _dispatch_external)
        self._batch_relayed: Dict[int, Tuple[int, float]] = {}
        self._ck_asked: Dict[int, float] = {}      # AskForCheckpoint rate
        self._self_ck_latest: Optional[m.CheckpointMsg] = None

        # --- pipeline ---
        self.incoming = IncomingMsgsStorage()
        self.dispatcher = Dispatcher(self.incoming, name=f"replica-{self.id}",
                                     thread_mdc={"r": self.id})
        comm_flush = getattr(comm, "flush", None)
        if comm_flush is not None:
            # batched-send transports hold the dispatcher's datagrams and
            # put them on the wire in one syscall per iteration
            self.dispatcher.set_post_hook(comm_flush)
        self.dispatcher.set_external_handler(self._on_external)
        self.dispatcher.register_internal("combine", self._on_combine_result)
        self.dispatcher.register_internal("pp_verified", self._on_pp_verified)
        self.dispatcher.register_internal("cert_verified",
                                          self._on_cert_verified)
        if self._agg_mode != "off":
            # interior-node partials re-enter from the collector pool
            # (the sum job) exactly like combine verdicts do
            self.dispatcher.register_internal("agg_partial",
                                              self._on_agg_partials)
            self.dispatcher.add_timer(max(cfg.agg_flush_ms, 5) / 1000.0,
                                      self._agg_flush_tick)
            self.dispatcher.add_timer(
                cfg.agg_parent_timeout_ms / 1000.0 / 2,
                self._agg_fallback_tick)
        self.dispatcher.add_timer(cfg.batch_flush_period_ms / 1000.0,
                                  self._try_send_pre_prepare)
        # a new primary's executed slots: (view, to re-propose, sent)
        self._reproposals: Tuple[int, List[int], List[int]] = (0, [], [])
        self.dispatcher.add_timer(0.005, self._pump_reproposals)
        self.dispatcher.add_timer(cfg.fast_path_timeout_ms / 1000.0 / 4,
                                  self._check_fast_path_timeouts)
        self.dispatcher.add_timer(cfg.view_change_timer_ms / 1000.0 / 4,
                                  self._check_view_change_timer)
        self.dispatcher.add_timer(cfg.status_report_timer_ms / 1000.0,
                                  self._send_status)
        # dispatcher liveness beat: fires every loop iteration it is due
        # (messages AND idle timeouts both reach the timer pass), so the
        # beat age is the consensus thread's tick age
        self.dispatcher.add_timer(0.2,
                                  lambda: self.health.beat("dispatcher"))
        # fused cross-slot combine plane: due collectors across seqnums
        # and kinds drain into ONE combine_batch call per flush (BLS:
        # one segmented multi-MSM launch + one RLC pairing check for
        # the whole batch) instead of one combine job per slot
        # per-origin Byzantine evidence rollup (bad shares identified by
        # the combine plane, deferred-cert failures from the async
        # verify path) — surfaced via `status get health` and flight
        # dumps so a repeat offender is attributable, not just counted
        self.byz_telemetry = ByzTelemetry()
        self.health.register_info_section("byzantine",
                                          self.byz_telemetry.snapshot)
        flight.register_dump_provider(f"byzantine.r{self.id}",
                                      self.byz_telemetry.snapshot)
        # wire-visible capability advertisement:
        # peers' CAP_* bitmaps as recorded off their status beacons, so
        # a mixed cluster (some replicas running the optimistic reply
        # plane, some not) is detectable from any one replica's health
        # payload. Observability only — nothing negotiates off this.
        self.peer_capabilities: Dict[int, int] = {}
        self.health.register_info_section(
            "capabilities",
            lambda: {"self": self._my_capabilities(),
                     "peers": dict(self.peer_capabilities)})
        self.collector_pool = CollectorPool(
            lambda res: self.incoming.push_internal("combine", res),
            fused=cfg.fused_combine,
            flush_us=cfg.combine_flush_us,
            max_batch=cfg.combine_batch_max,
            on_flush=self._on_combine_flush,
            rid=self.id)
        # cross-seqnum combined-cert verification batcher: certs arriving
        # within a flush window verify in ONE aggregated check per
        # verifier (BLS: single RLC'd pairing check)
        from tpubft_torch.consensus.collectors import CertBatchVerifier
        self.cert_batcher = CertBatchVerifier(
            lambda cookie, ok: self.incoming.push_internal(
                "cert_verified", (cookie[0], cookie[1], ok)),
            flush_us=cfg.verify_batch_flush_us)
        # admission verification batcher: ClientRequest signature checks
        # leave the dispatcher thread and verify in cross-request batches
        # (ONE device dispatch per flush window with the CUDA backend) —
        # under a client flood the primary's dispatcher is no longer the
        # serial per-sig bottleneck (reference: RequestThreadPool role in
        # onMessage<ClientRequestMsg>, ReplicaImp.cpp:397)
        self.req_batcher = None
        self._req_verifying: set = set()
        if cfg.async_verification:
            from tpubft_torch.consensus.sig_manager import BatchVerifier
            self.req_batcher = BatchVerifier(
                self.sig, batch_size=cfg.verify_batch_size,
                flush_us=cfg.verify_batch_flush_us)
            self.dispatcher.register_internal("req_verified",
                                              self._on_req_verified)
        # admission plane (transport → dispatcher): workers parse and
        # verify every external message off the dispatcher, coalescing
        # the drain's signatures into one verify_batch; the dispatcher
        # receives AdmittedMsg objects and its handlers consult the
        # attached verdict instead of re-verifying (admission.py docs).
        # 0 workers = legacy inline path (raw bytes to the dispatcher).
        self.admission = None
        if cfg.admission_workers > 0:
            from tpubft_torch.consensus.admission import AdmissionPipeline
            self.admission = AdmissionPipeline(
                sig=self.sig, info=self.info,
                sink=self.incoming.push_external_obj,
                epoch_fn=lambda: self.epoch_mgr.self_epoch,
                view_fn=lambda: self.view,
                stable_fn=lambda: self.last_stable,
                workers=cfg.admission_workers,
                drain_max=cfg.admission_drain_max,
                aggregator=self.aggregator,
                name=f"admission-{self.id}",
                ckpt_window=cfg.checkpoint_window_size,
                high_watermark=cfg.admission_high_watermark,
                low_watermark=cfg.admission_low_watermark,
                beat_fn=lambda: self.health.beat("admission"),
                rid=cfg.replica_id,
                shard_by_key=cfg.admission_key_sharding)
            self.dispatcher.set_admitted_handler(self._on_admitted)
            self.health.register_probe(
                "admission", cfg.health_stall_ms / 1e3,
                busy_fn=lambda: self.admission.depth > 0,
                detail_fn=lambda: {"depth": self.admission.depth,
                                   "shedding": self.admission.shedding})
            self.health.register_degraded_flag(
                "admission_shedding", lambda: self.admission.shedding)

        # retransmissions (reference RetransmissionsManager +
        # sendRetransmittableMsgToReplica, ReplicaImp.cpp:2531)
        self.retrans = None
        if cfg.retransmissions_enabled:
            from tpubft_torch.consensus.retransmissions import \
                RetransmissionsManager
            self.retrans = RetransmissionsManager(
                comm, min_timeout_ms=cfg.retransmission_timer_ms // 2 or 10,
                max_timeout_ms=cfg.retransmission_timer_ms * 20)
            self.dispatcher.add_timer(
                cfg.retransmission_timer_ms / 1000.0, self._retrans_tick)
            self.dispatcher.add_timer(
                cfg.retransmission_timer_ms * 4 / 1000.0,
                self._check_missing_data)
        # ReqMissingData bookkeeping: seq -> (first_noticed, asks_sent)
        self._missing_since: Dict[int, list] = {}
        # restart-ready votes per wedge point (ReplicaRestartReadyMsg);
        # keyed by point so a later re-wedge starts a fresh election
        self._restart_announced: Optional[int] = None
        self._my_restart_vote: Optional[m.ReplicaRestartReadyMsg] = None
        self._restart_votes: Dict[int, set] = {}

        # --- metrics (names mirror the reference's replica component) ---
        self.metrics = Component("replica", self.aggregator)
        self.m_executed = self.metrics.register_counter("executed_requests")
        self.m_preprepares = self.metrics.register_counter("sent_preprepares")
        self.m_fast_commits = self.metrics.register_counter("fast_path_commits")
        self.m_slow_commits = self.metrics.register_counter("slow_path_commits")
        self.m_slow_starts = self.metrics.register_counter("slow_path_starts")
        self.m_view = self.metrics.register_gauge("view")
        self.m_last_executed = self.metrics.register_gauge("last_executed_seq")
        self.m_last_stable = self.metrics.register_gauge("last_stable_seq")
        self.m_retransmitted = self.metrics.register_gauge(
            "retransmitted_total")
        self.m_epoch = self.metrics.register_gauge("epoch")
        self.m_epoch_dropped = self.metrics.register_counter(
            "epoch_mismatch_dropped")
        # execution-lane observability: queue depth (committed slots not
        # yet applied), runs completed, and slots coalesced into runs
        self.m_exec_lane_depth = self.metrics.register_gauge(
            "exec_lane_depth")
        self.m_exec_runs = self.metrics.register_counter("exec_runs")
        self.m_exec_run_slots = self.metrics.register_counter(
            "exec_run_slots")
        # speculative execution: sealed runs (executed ahead of their
        # commit certificate and made durable at commit), abort events
        # (view change / barrier / digest surprise — the overlay was
        # discarded and the slots re-executed post-commit), and the last
        # sealed run's reclaimed combine-window overlap
        self.m_exec_spec_runs = self.metrics.register_counter(
            "exec_spec_runs")
        self.m_exec_spec_aborts = self.metrics.register_counter(
            "exec_spec_aborts")
        self.m_exec_spec_overlap = self.metrics.register_gauge(
            "exec_spec_overlap_ms")
        # optimistic reply plane: slots released to the client-visible
        # path on a structurally-valid commit cert before its pairing
        # verify landed, and deferred verifies that came back BAD on a
        # slot already released (poisons the plane for the view)
        self.m_opt_replies = self.metrics.register_counter(
            "optimistic_releases")
        self.m_cert_async_fails = self.metrics.register_counter(
            "cert_async_failures")
        # fused combine plane: flushes drained and slots combined —
        # combined_slots / combine_batches is the amortization factor
        # (the `status get kernels` bls_msm batch stats show the same
        # win device-side); the autotuner's flush-window sensor
        self.m_combine_batches = self.metrics.register_counter(
            "combine_batches")
        self.m_combined_slots = self.metrics.register_counter(
            "combined_slots")
        # aggregation overlay: Prepare/Commit share datagrams RECEIVED
        # from peers (raw shares + climbing partials; fast-path shares
        # excluded — they never aggregate), the fan-in bench_scaling
        # --agg-ab reads at the hottest replica; partials forwarded up the
        # tree, partials absorbed at the root, and parent-timeout
        # fallbacks (each one is a direct re-send, the liveness floor)
        self.m_share_msgs_rcvd = self.metrics.register_counter(
            "share_msgs_received")
        self.m_agg_forwarded = self.metrics.register_counter(
            "agg_partials_forwarded")
        self.m_agg_absorbed = self.metrics.register_counter(
            "agg_partials_absorbed")
        self.m_agg_fallbacks = self.metrics.register_counter(
            "agg_fallbacks")
        # external-queue backpressure drops (IncomingMsgsStorage bound),
        # refreshed by the status timer — paired with the admission
        # component's counters for the full ingest picture
        self.m_dropped_external = self.metrics.register_gauge(
            "dropped_external")
        # a recovered replica must REPORT its recovered position — these
        # gauges otherwise read 0 until the next execution, making an
        # idle-after-restart replica look like it lost its state
        self.m_view.set(self.view)
        self.m_last_executed.set(self.last_executed)
        self.m_last_stable.set(self.last_stable)

        # state transfer (attached by the kvbc layer via set_state_transfer;
        # reference: ReplicaForStateTransfer owning an IStateTransfer)
        self.state_transfer = None

        # pre-execution (reference src/preprocessor/, gated on config).
        # The `preexec` metrics component exists whenever the plane can
        # be exercised — conflict/fallback counters tick from the
        # execution path even on replicas that only APPLY pre-executed
        # results
        self.preexec_metrics = Component("preexec", self.aggregator)
        self.m_preexec_conflicts = self.preexec_metrics.register_counter(
            "preexec_conflicts")
        self.m_preexec_applied = self.preexec_metrics.register_counter(
            "preexec_applied")
        self.preprocessor = None
        if cfg.pre_execution_enabled:
            from tpubft_torch.preprocessor import PreProcessor
            self.preprocessor = PreProcessor(
                self, num_threads=cfg.preexec_threads)

        # thin-replica read tier (reference thin-replica-server, gated
        # on config): reads/subscriptions served off the consensus path,
        # fed once per sealed run from the ledger commit stream, with
        # the f+1-signed checkpoint anchor published from
        # _store_checkpoint so clients can digest-verify every read.
        # The anchor snapshot crosses threads (dispatcher publishes,
        # thin-replica handler threads serve) — guarded by _trs_mu.
        self.thin_replica = None
        self._trs_mu = make_lock("trs.anchor")
        self._trs_anchor: Optional[tuple] = None
        # state_digest -> ledger height at our own checkpoint boundaries
        # (bounded; resolves a certified digest to a servable block row)
        self._ckpt_blocks: Dict[bytes, int] = {}
        if cfg.thin_replica_enabled:
            self.attach_thin_replica(port=cfg.thin_replica_port)

        # reserved pages + the subsystems riding them (internal client,
        # key exchange, time service, cron)
        from tpubft_torch.ccron import CronTable, TicksGenerator
        from tpubft_torch.consensus.internal import (InternalBFTClient,
                                               KeyExchangeManager,
                                               TimeServiceManager)
        from tpubft_torch.consensus.reserved_pages import (ReservedPages,
                                                     ReservedPagesClient)
        if reserved_pages is None:
            from tpubft_torch.storage.memorydb import MemoryDB
            reserved_pages = ReservedPages(MemoryDB())
        self.res_pages = reserved_pages
        self.internal_client = InternalBFTClient(self)
        self.key_exchange = KeyExchangeManager(
            self, ReservedPagesClient(self.res_pages,
                                      KeyExchangeManager.CATEGORY))
        self.time_service = TimeServiceManager(
            ReservedPagesClient(self.res_pages, TimeServiceManager.CATEGORY),
            max_skew_ms=cfg.time_max_skew_ms)
        if cfg.time_service_enabled:
            # replica time voting: broadcast our signed clock reading and
            # bound the primary against the cluster's median. 2f+1 clocks
            # (incl. self) so the median is bracketed by honest values
            # even with f faulty opinions present.
            self.time_service.opinion_quorum = 2 * cfg.f_val + 1
            self.dispatcher.add_timer(1.0, self._broadcast_time_opinion)
        from tpubft_torch.consensus.control import ControlStateManager
        self.control = ControlStateManager(
            ReservedPagesClient(self.res_pages,
                                ControlStateManager.CATEGORY))
        self.epoch_mgr = EpochManager(
            ReservedPagesClient(self.res_pages, EpochManager.CATEGORY))
        self.m_epoch.set(self.epoch_mgr.boot_adopt(self.last_executed))
        self.reconfig = None  # ReconfigurationDispatcher (kvbc wiring)
        self.cron_table = CronTable(
            ReservedPagesClient(self.res_pages, CronTable.CATEGORY))
        self.ticks_generator = TicksGenerator(self, self.cron_table)
        self.dispatcher.add_timer(0.25, self.ticks_generator.poll)
        self.key_exchange.load_from_pages()
        self._load_client_replies_from_pages()

        # diagnostics (reference: Registrar status handlers + per-stage
        # histograms, diagnostics.h / performance_handler.h)
        from tpubft_torch.diagnostics import get_registrar
        self._diag = get_registrar()
        self._h_execute = self._diag.histogram(f"replica{self.id}.execute")
        self._h_verify = self._diag.histogram(f"replica{self.id}.verify")
        # run-shape histograms: slots per execution run and the coalesced
        # commit's duration (ms → recorded in µs like the others)
        self._h_exec_run_len = self._diag.histogram(
            f"replica{self.id}.exec_run_len")
        self._h_exec_commit_ms = self._diag.histogram(
            f"replica{self.id}.exec_commit_ms")
        # per-sealed-run reclaimed overlap (ms → recorded in µs)
        self._h_spec_overlap = self._diag.histogram(
            f"replica{self.id}.exec_spec_overlap_ms")
        # slots per fused combine flush (1 = no cross-slot amortization)
        self._h_combine_batch = self._diag.histogram(
            f"replica{self.id}.combine_batch_size", unit="slots")
        self._diag.register_status(
            f"replica{self.id}",
            lambda: (f"view={self.view} last_executed={self.last_executed} "
                     f"last_stable={self.last_stable} "
                     f"in_view_change={self.in_view_change} "
                     f"{self.control.status()}"))
        # aggregate degradation verdict (`status get health`): probes +
        # breaker snapshots + shed flags as JSON. The bare "health" key
        # is the one-replica-per-process operator entry; in-process
        # clusters also get the per-replica key.
        self._diag.register_status(f"replica{self.id}.health",
                                   self.health.render)
        self._diag.register_status("health", self.health.render)
        # the last views entered: slots re-proposed, ms to the first
        # execution (null until it comes), seconds since entry; the bare
        # key as "health"'s
        for key in (f"replica{self.id}.views", "views"):
            self._diag.register_status(key, lambda: json.dumps([
                dict(e, t=round(time.monotonic() - e["t"], 3))
                for e in list(self._view_entries)]))
        # flight recorder surfaces (`status get flight|slots|kernels`)
        flight.install_diagnostics(self._diag)
        from tpubft_torch.testing.slowdown import get_slowdown_manager
        self._slowdown = get_slowdown_manager()

        # --- execution lane (post-commit pipelining off the dispatcher;
        # reference: post-execution separation + block accumulation) ---
        self.exec_lane = None
        # highest seq handed to the lane (or executed inline via the
        # lane's barrier path); dispatcher-thread only
        self._exec_enqueued = self.last_executed
        # speculatively-submitted slots whose commit certificate has not
        # confirmed yet, in seq order; dispatcher-thread only
        self._spec_inflight: List[int] = []
        # --- optimistic reply plane ---
        # replies go out on a STRUCTURALLY-valid commit cert while the
        # pairing verify runs behind; requires async verification (the
        # deferred check IS the async job) and is reply-visibility only
        self._opt_replies = bool(cfg.optimistic_replies
                                 and cfg.async_verification)
        # a deferred verify that fails on an already-released slot
        # poisons the plane until the next view change (forged certs
        # mean an active equivocator — stop trusting structure alone)
        self._opt_poisoned = False
        # contiguous frontier of slots whose commit certificate has
        # VERIFIED (not just structurally accepted): in optimistic mode
        # the persisted last_executed watermark is clamped to this, so a
        # restart never resumes past evidence that was still in flight
        self._verified_upto = self.last_executed
        # speculation needs a rollback substrate: the lane, an
        # accumulation-capable ledger behind the handler (handlers
        # without one — e.g. the counter app — apply irreversibly during
        # execution), and the time service off (its agreed-time page
        # writes bypass the staged pages batch)
        _bc = getattr(handler, "blockchain", None)
        self._spec_enabled = bool(
            cfg.speculative_execution and cfg.execution_lane
            and not cfg.time_service_enabled
            and _bc is not None and hasattr(_bc, "begin_accumulation"))
        self.durability = None
        if cfg.execution_lane:
            from tpubft_torch.consensus.execution import ExecutionLane
            self.exec_lane = ExecutionLane(
                self, cfg.execution_max_accumulation,
                cfg.checkpoint_window_size)
            self.dispatcher.register_internal("exec_done",
                                              self._apply_exec_runs)
            # stall threshold = the drain barrier's budget: a lane that
            # would time out a view-change/ST drain is reported by the
            # watchdog with stacks + depths, not discovered by a human
            self.health.register_probe(
                "exec_lane", cfg.execution_drain_timeout_ms / 1e3,
                busy_fn=lambda: not self.exec_lane.idle(),
                detail_fn=lambda: {"depth": self.exec_lane.depth})
        # --- group-commit durability pipeline (durability/):
        # the lane seals runs, a dedicated io thread group-commits
        # them across runs (one concatenated apply + one fsync per
        # group) and publishes the durability watermark that gates
        # replies / last_executed / the reply cache. The ledger (when
        # the handler has one with the accumulation bracket) installs
        # the pending-read overlay so sealed-but-unapplied runs stay
        # observable process-wide; reserved pages sharing the ledger
        # DB rebind onto the same view so folded reply pages are too.
        if cfg.execution_lane and cfg.durability_pipeline:
            from tpubft_torch.durability import DurabilityPipeline
            self.durability = DurabilityPipeline(
                self, group_max=cfg.durability_group_max,
                window_us=cfg.durability_window_us)
            _bc = getattr(handler, "blockchain", None)
            if _bc is not None and hasattr(_bc, "attach_durability"):
                view = _bc.attach_durability(
                    self.durability.pending,
                    drain_fn=self.durability.drain)
                if self.res_pages.shares_db(view.base):
                    self.res_pages.rebind(view)
            # watermark-lag stall probe: busy while sealed runs await
            # their group fsync; a disk that stops landing groups is
            # reported with the same budget as the lane's drain barrier
            self.health.register_probe(
                "durability", cfg.execution_drain_timeout_ms / 1e3,
                busy_fn=lambda: self.durability.lag > 0,
                detail_fn=lambda: {"lag": self.durability.lag,
                                   "wm": self.durability.watermark})
            self._diag.register_status(f"replica{self.id}.durability",
                                       self.durability.render)
            self._diag.register_status("durability",
                                       self.durability.render)

        # --- closed-loop autotuner (tpubft/tuning/): drives the perf
        # knobs above (flush windows, batch caps, accumulation depth,
        # admission watermarks, ECDSA crossover) from the telemetry
        # plane, backing everything off to the configured defaults
        # whenever health leaves `healthy` or a breaker opens. The
        # ReplicaConfig fields seed the knob registry; after this point
        # the registry — not the frozen dataclass — owns the values.
        self.tuning = None
        if cfg.autotune_enabled:
            from tpubft_torch.tuning import build_replica_tuning
            self.tuning = build_replica_tuning(self, cfg)
            self._diag.register_status(f"replica{self.id}.tuning",
                                       self.tuning.render)
            self._diag.register_status("tuning", self.tuning.render)

        # assigned BEFORE the restore replay: _restore_window can reach
        # _execute_committed, whose pipeline retrigger reads _running
        self._running = False
        self._restore_window(window_msgs)

    def _page_in_client(self, client: int):
        """Demand pager for the bounded client table: rebuild ONE
        client's record from its reply-ring pages + oversize marker —
        the same rule `_load_client_replies_from_pages` applies to every
        client at boot, including the restore seal, so an evict/reload
        cycle is a single-client restart. Cost is proportional to the
        pages that EXIST for this client (one bounded range scan): a
        never-seen principal pages in for O(log store)."""
        from tpubft_torch.consensus.clients_manager import (
            REPLY_CACHE_PER_CLIENT as _RING, _ClientInfo)
        info = _ClientInfo()
        found = []
        for _slot, raw in self.res_pages.scan(
                "clientreplies", client * _RING, (client + 1) * _RING):
            if not raw or raw[:1] != b"\x00":
                continue
            try:
                reply = m.unpack(raw[1:])
            except m.MsgError:
                continue
            if isinstance(reply, m.ClientReplyMsg):
                # re-personalize the canonical page form
                reply.sender_id = self.id
                reply.current_primary = self.primary
                found.append(reply)
        # oldest-first insertion so later live evictions age correctly
        for reply in sorted(found, key=lambda r: r.req_seq_num):
            info.replies[reply.req_seq_num] = reply
            if reply.req_seq_num > info.last_executed_req:
                info.last_executed_req = reply.req_seq_num
        raw = self.res_pages.load("clients", client)
        if raw and raw[:1] == b"\x01":
            # oversize-reply marker: at-most-once state only
            seq = int.from_bytes(raw[1:9], "big")
            info.replies.setdefault(seq, None)
            if seq > info.last_executed_req:
                info.last_executed_req = seq
        # the restore seal (clients_manager.seal_restore): the persisted
        # ring is bounded, so anything at or below the watermark that
        # did not come back may have executed-and-evicted — refuse it
        if info.last_executed_req > info.evicted_high:
            info.evicted_high = info.last_executed_req
        return info

    def _load_client_replies_from_pages(self) -> None:
        """Seed the at-most-once table + reply cache from reserved pages
        (reference: ClientsManager loadInfoFromReservedPages)."""
        if self.cfg.client_table_max > 0:
            # paged client table: records are demand-built one client at
            # a time by _page_in_client under the same rules, so "reload
            # everything" (boot, ST page install) is just dropping
            # whatever is resident — never an O(clients) eager scan
            self.clients.invalidate_all()
            return
        from tpubft_torch.consensus.clients_manager import \
            REPLY_CACHE_PER_CLIENT as _RING
        from tpubft_torch.consensus.reserved_pages import ReservedPagesClient
        pages = ReservedPagesClient(self.res_pages, "clients")
        ring = ReservedPagesClient(self.res_pages, "clientreplies")

        def seed(client: int, raw: bytes) -> None:
            try:
                reply = m.unpack(raw[1:])
            except m.MsgError:
                return
            if isinstance(reply, m.ClientReplyMsg):
                # re-personalize the canonical page form
                reply.sender_id = self.id
                reply.current_primary = self.primary
                self.clients.on_request_executed(client, reply.req_seq_num,
                                                 reply)

        for c in self.info.all_client_ids():
            # the reply ring first (recent batch elements) ...
            for slot in range(_RING):
                raw = ring.load(index=c * _RING + slot)
                if raw and raw[:1] == b"\x00":
                    seed(c, raw)
            # ... then the newest-reply/at-most-once marker page, which
            # also carries the authoritative last-executed watermark
            raw = pages.load(index=c)
            if not raw:
                continue
            if raw[:1] == b"\x01":
                # oversize-reply marker: at-most-once state only
                self.clients.note_executed(c, int.from_bytes(raw[1:9],
                                                             "big"))
            else:
                seed(c, raw)
        for c in self.info.all_client_ids():
            # the persisted ring is bounded: seqs below the watermark that
            # didn't come back may have executed-and-evicted — refuse them
            self.clients.seal_restore(c)

    # ------------------------------------------------------------------
    # state transfer wiring (ReplicaForStateTransfer equivalent)
    # ------------------------------------------------------------------
    def set_state_transfer(self, st) -> None:
        self.state_transfer = st
        st.bind(
            send_fn=lambda dest, payload: self.comm.send(
                dest, m.StateTransferMsg(sender_id=self.id,
                                         payload=payload).pack()),
            complete_fn=self._on_transfer_complete,
            replica_ids=list(self.info.replica_ids),
            f_val=self.cfg.f_val)
        self.dispatcher.add_timer(0.2, st.tick)
        # fetch-plane progress pulse: busy only while fetching; the
        # last-activity pulse (sends/receives) replaces thread beats —
        # ST runs on the dispatcher, this watches its *progress*
        self.health.register_probe(
            "state_transfer",
            max(self.cfg.health_stall_ms, self.cfg.st_stall_timeout_ms) / 1e3,
            busy_fn=lambda: st.is_fetching,
            last_fn=lambda: st.last_activity,
            detail_fn=lambda: {"state": st.state})
        self._st_stall_mark = (self.last_executed, time.monotonic())
        self.dispatcher.add_timer(
            max(self.cfg.st_stall_timeout_ms / 4000.0, 0.25),
            self._check_st_stall)

    def _check_st_stall(self) -> None:
        """Dead-zone guard: a certified checkpoint is ahead of us but not
        far enough for the immediate window trigger, and ordering has made
        no progress (peers GC'd the needed commits) — fetch state."""
        seq, t = self._st_stall_mark
        now = time.monotonic()
        if self.last_executed != seq:
            self._st_stall_mark = (self.last_executed, now)
            return
        ahead = [s for s in self.certified_checkpoints
                 if s > self.last_executed]
        if not ahead:
            return
        if now - t > self.cfg.st_stall_timeout_ms / 1000.0:
            self._st_stall_mark = (self.last_executed, now)
            self._start_state_transfer(max(ahead))

    def _start_state_transfer(self, min_seq: int) -> None:
        """Fetch state toward a certified checkpoint at or past
        `min_seq`. Port divergence (reference replica.py:904 and :3344
        call start_collecting alone): the speculation is aborted first.
        The transfer links its blocks under the staging lock, which an
        open speculative accumulation holds until its commit arrives;
        a replica far enough behind to transfer never gets that commit
        (the peers have collected the slot behind their stable
        checkpoint), so the link deferred forever and the replica never
        caught up. The aborted slots re-execute from their committed
        bodies, or are superseded by the transferred checkpoint."""
        self._abort_speculation("state-transfer")
        self.state_transfer.start_collecting(
            min_seq, dict(self.certified_checkpoints))

    def _on_transfer_complete(self, seq: int, state_digest: bytes) -> None:
        """onTransferringComplete (IStateTransfer.hpp:113): jump forward to
        the transferred checkpoint and resume normal operation."""
        # apply (not discard) any in-flight execution first: those slots
        # are committed and their effects are part of the state the
        # transferred checkpoint extends — and the page reload below must
        # not race the lane's page writes. A lane that cannot drain means
        # adopting now would race it: skip; the stall checker re-triggers
        # a transfer while the certified checkpoints stay ahead.
        if not self._drain_exec_lane():
            log.error("transfer-complete deferred: execution lane did "
                      "not drain")
            return
        if seq <= self.last_executed:
            return
        self.last_executed = seq
        self.m_last_executed.set(seq)
        self.primary_next_seq = max(self.primary_next_seq, seq + 1)
        with self._tran() as st:
            st.last_executed_seq = seq
        self._on_seq_stable(seq, state_digest)
        # reserved pages were just installed: adopt everything riding them
        self.key_exchange.load_from_pages()
        self.time_service.reload()
        self.cron_table.reload()
        self.control.reload()
        self._load_client_replies_from_pages()
        # the fetched pages may carry a bumped epoch (we missed a
        # reconfiguration): adopt it if the transferred checkpoint is
        # past the era boundary, or every peer message gets dropped by
        # the era gate while we keep stamping a dead epoch
        self.m_epoch.set(self.epoch_mgr.boot_adopt(seq))
        self._note_progress()
        # adoption done: re-arm execution for any slots committed beyond
        # the transferred checkpoint (the pre-adoption drain deliberately
        # did not re-pump)
        self._execute_committed()

    def set_reconfiguration(self, dispatcher) -> None:
        """Attach the reconfiguration handler chain (kvbc wiring)."""
        self.reconfig = dispatcher

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self.comm.start(self)
        # crash between entering a view as primary and finishing the
        # re-proposals: restrictions were persisted, PrePrepares were not —
        # re-issue any that the restored window is missing
        if self.is_primary and not self.in_view_change and self.restrictions \
                and any(self.window.in_window(s)
                        and (self.window.peek(s) is None
                             or self.window.peek(s).pre_prepare is None)
                        for s in self.restrictions):
            self.incoming.push_internal("repropose", None)
        self.dispatcher.register_internal("repropose",
                                          lambda _: self._repropose())
        # crash between persisting view-change intent (vc.persist seam)
        # and the change completing: resume it — rebuild and retransmit
        # our ViewChangeMsg from the persisted evidence (peers may need
        # it to reach the view-change quorum). Runs on the dispatcher so
        # it serializes with incoming view-change traffic.
        self.dispatcher.register_internal("resume_vc",
                                          self._resume_view_change)
        if self.in_view_change and (self.pending_view or 0) > self.view:
            self.incoming.push_internal("resume_vc", None)
        if self.durability is not None:
            self.durability.start()     # before the lane: seals flow in
        if self.exec_lane is not None:
            self.exec_lane.start()
        if self.admission is not None:
            self.admission.start()
        if self.thin_replica is not None:
            self.thin_replica.start()
        self.health.start()
        if self.tuning is not None:
            self.tuning.start()
        self.dispatcher.start()
        # reference replica.py:993: cfg.crypto_backend holds the
        # resolved name ("cuda" or "cpu", never "auto") since __init__
        with mdc_scope(r=self.id):       # start() runs on the caller thread
            log.info("replica up: n=%d f=%d c=%d view=%d primary=%d "
                     "backend=%s", self.info.n, self.cfg.f_val,
                     self.cfg.c_val, self.view, self.primary,
                     self.cfg.crypto_backend)
        if self.cfg.key_exchange_on_start:
            # sendInitialKey (BFTEngine start path, ReplicaImp.cpp:4622)
            self.key_exchange.initiate()

    def stop(self) -> None:
        self._running = False
        with mdc_scope(r=self.id):
            log.info("replica stopping: last_executed=%d last_stable=%d",
                     self.last_executed, self.last_stable)
        if self.exec_lane is not None:
            # no drain: pending slots are committed state that recovery
            # replays — stop is crash-equivalent for the lane
            self.exec_lane.stop()
        if self.durability is not None:
            # after the lane (its last seal must be accepted): a clean
            # stop flushes sealed runs to disk — whatever a wedged disk
            # leaves behind is the crash case recovery already replays
            self.durability.stop()
        if self.admission is not None:
            self.admission.stop()
        if self.thin_replica is not None:
            self.thin_replica.stop()
        if self.tuning is not None:
            if self.cfg.autotune_seed_file:
                # clean shutdown: write the converged operating point
                # back to the seed file so the next boot of this host
                # starts warm; crash paths never get here,
                # so a half-tuned episode cannot poison the seed
                self.tuning.write_seed(self.cfg.autotune_seed_file)
            self.tuning.stop()
        self.health.stop()
        self.dispatcher.stop()
        self.collector_pool.shutdown()
        self.cert_batcher.stop()
        if self.req_batcher is not None:
            self.req_batcher.stop()
        if self.preprocessor:
            self.preprocessor.shutdown()
        self.comm.stop()

    # ------------------------------------------------------------------
    # thin-replica serving plane
    # ------------------------------------------------------------------
    def attach_thin_replica(self, port: int = 0,
                            host: str = "127.0.0.1"):
        """Create (idempotently) the thin-replica server over the
        handler's ledger, wired to the commit stream and this replica's
        quorum-signed checkpoint anchor. Started by start() (or
        immediately when the replica is already running)."""
        if self.thin_replica is not None:
            return self.thin_replica
        bc = getattr(self.handler, "blockchain", None)
        if bc is None:
            log.warning("thin_replica_enabled but the handler has no "
                        "blockchain — read tier inactive")
            return None
        from tpubft_torch.thinreplica import ThinReplicaServer
        self.thin_replica = ThinReplicaServer(
            bc, host=host, port=port,
            sub_buffer=self.cfg.thin_replica_sub_buffer,
            aggregator=self.aggregator,
            anchor_fn=self.thin_replica_anchor)
        # __init__-time attach runs before _running exists; start()
        # brings the server up then
        if getattr(self, "_running", False):
            self.thin_replica.start()
        return self.thin_replica

    def thin_replica_anchor(self) -> Optional[tuple]:
        """(ckpt_seq, block_id, [packed CheckpointMsg...]) snapshot for
        the thin-replica server — called from its handler threads; the
        dispatcher publishes via _publish_trs_anchor."""
        with self._trs_mu:
            return self._trs_anchor

    def _publish_trs_anchor(self, seq: int, block_id: int,
                            certs: tuple) -> None:
        with self._trs_mu:
            cur = self._trs_anchor
            if cur is None or seq > cur[0]:
                self._trs_anchor = (seq, block_id, certs)

    @property
    def is_primary(self) -> bool:
        return self.info.primary_of_view(self.view) == self.id

    @property
    def primary(self) -> int:
        return self.info.primary_of_view(self.view)

    # ------------------------------------------------------------------
    # transport upcall (any thread) → admission plane or queue
    # ------------------------------------------------------------------
    def on_new_message(self, sender: int, data: bytes) -> None:
        if self.admission is not None:
            self.admission.submit(sender, data)
        else:
            self.incoming.push_external(sender, data)

    def on_new_messages(self, msgs) -> None:
        """Burst upcall from batch-receiving transports (udp recvmmsg):
        the whole drain enters the admission queue in one call."""
        if self.admission is not None:
            self.admission.submit_burst(msgs)
        else:
            for sender, data in msgs:
                self.incoming.push_external(sender, data)

    # ------------------------------------------------------------------
    # dispatch (dispatcher thread)
    # ------------------------------------------------------------------
    def _on_external(self, sender: int, raw: bytes) -> None:
        """Legacy/inline path (admission_workers=0, and direct
        push_external callers): parse on the dispatcher, then dispatch."""
        try:
            msg = m.unpack(raw)
        except m.MsgError:
            log.debug("unparseable message from %d (%d bytes)", sender,
                      len(raw))
            return
        # scoped MDC (reference SCOPED_MDC_SEQ_NUM, ReplicaImp.cpp:1067):
        # every line logged while handling this message carries its
        # consensus coordinates
        with mdc_scope(v=self.view,
                       s=getattr(msg, "seq_num", None) or "-"):
            self._dispatch_external(sender, msg)

    def _on_admitted(self, adm) -> None:
        """Admission-plane path: the message arrives parsed with its
        signature verdict attached — the dispatcher only runs the
        stateful gates and mutates protocol state."""
        with mdc_scope(v=self.view,
                       s=getattr(adm.msg, "seq_num", None) or "-"):
            self._dispatch_external(adm.sender, adm.msg)

    @property
    def epoch(self) -> int:
        """The reconfiguration era this replica stamps on (and requires
        of) protocol messages (reference EpochManager selfEpochNumber)."""
        return self.epoch_mgr.self_epoch

    def _share_digest(self, kind: str, view: int, seq_num: int,
                      pp_digest: bytes) -> bytes:
        """share_digest bound to OUR current era — every share signed or
        validated by this replica (including certificate validation
        during view change) authenticates the epoch instead of trusting
        the wire field."""
        return share_digest(kind, self.epoch, view, seq_num, pp_digest)

    def _dispatch_external(self, sender: int, msg) -> None:
        # flight recorder: handler-entry event — the bounded, fixed-size
        # telemetry the hot path is allowed (check_hotpath forbids
        # span/f-string observability here)
        flight.record(flight.EV_DISPATCH,
                      seq=getattr(msg, "seq_num", 0) or 0,
                      view=self.view, arg=int(getattr(msg, "CODE", 0)))
        # era gate (reference: per-message epochNum checks, e.g.
        # PrePrepareMsg.cpp:91, ReplicaImp.cpp:2313): traffic from an
        # older reconfiguration era is dead — drop it before any handler.
        # A HIGHER-epoch checkpoint is the one exception: it is evidence
        # this replica missed a reconfiguration, and checkpoints drive
        # state-transfer catch-up (which also carries the new epoch page).
        msg_epoch = getattr(msg, "epoch", None)
        if msg_epoch is not None and msg_epoch != self.epoch_mgr.self_epoch:
            if not (isinstance(msg, m.CheckpointMsg)
                    and msg_epoch > self.epoch_mgr.self_epoch):
                self.m_epoch_dropped.inc()
                return
        if isinstance(msg, m.ClientRequestMsg):
            # accepted from the client itself OR forwarded by a replica;
            # either way the client's own signature is verified next
            if msg.sender_id != sender and not self.info.is_replica(sender):
                return
            self._on_client_request(msg)
            return
        if isinstance(msg, m.ClientBatchRequestMsg):
            # one wire message, several individually-signed requests
            # (reference ClientBatchRequestMsg::checkElements): every
            # element must decode to a ClientRequestMsg from the SAME
            # client; each then takes the normal admission path, where
            # the async plane verifies them as one device batch
            if msg.sender_id != sender and not self.info.is_replica(sender):
                return
            # unknown principals drop here, BEFORE the relay/suppression
            # path: a byzantine replica streaming fabricated sender_ids
            # must not grow _batch_relayed or mint amplified relays
            if not self.clients.is_valid_client(msg.sender_id):
                return
            # admission attaches the surviving parsed elements (forged
            # elements already dropped, each survivor pre-verified); the
            # legacy path parses them here via the helper
            inners = getattr(msg, "_adm_inners", None)
            if inners is None:
                inners = self._parse_batch_inners(msg)
                if inners is None:
                    return          # malformed element: drop whole batch
            # backup: relay the BATCH as one wire message (exploding it
            # into per-element forwards would defeat the transport
            # amortization); elements below run with relay suppressed
            # and still arm the liveness clock individually post-verify.
            # Retransmissions re-relay at most once per suppression
            # window — _forwarded can't dedup here (entries appear only
            # post-verify and are popped at execution, so a client
            # retrying lost replies would otherwise trigger an
            # (n-1)x-amplified re-relay of the largest message type on
            # every retry).
            # The suppression MAP is keyed on the principal alone so it
            # stays bounded by the client count (keying entries on any
            # element-derived value would let a spoofer mint unbounded
            # keys). The per-client record is (head req_seq, time): a
            # relay fires when the batch head's req_seq ADVANCES past
            # the last relayed one — a client pipelining faster than
            # 1 batch/s still gets backup relay for each new batch —
            # while a re-presented head (client retransmit of the same
            # batch) is still rate-bounded to one relay per second
            # (ADVICE r5). Seq advance happens pre-verify (head_seq is
            # attacker-influencable), but that mints no amplification:
            # each received batch yields at most ONE relay of the same
            # bytes to one destination (the primary), so a flooder gets
            # exactly the 1:1 traffic it could send the primary directly
            # — the old 1/s cap only obscured the origin, it did not
            # reduce attacker power.
            if inners and not self.is_primary and not self.in_view_change:
                now = time.monotonic()
                head_seq = inners[0].req_seq_num
                last = self._batch_relayed.get(msg.sender_id)
                if last is None or head_seq > last[0] \
                        or now - last[1] > 1.0:
                    self._batch_relayed[msg.sender_id] = (head_seq, now)
                    self.comm.send(self.primary, msg.pack())
            for inner in inners:
                self._on_client_request(inner, relay=False)
            return
        # Anti-spoofing: sender_id must match the transport sender —
        # EXCEPT for messages carrying their own end-to-end signature
        # (replica sig or threshold combined sig, verified in their
        # handlers): those are relay-safe, and the gap-resend +
        # ReqMissingData flows forward them on the original's behalf.
        # (m.RELAY_SAFE is shared with the admission plane's pre-drop,
        # so the two gates can never disagree.)
        if not isinstance(msg, m.RELAY_SAFE) \
                and getattr(msg, "sender_id", sender) != sender:
            return                              # sender spoofing: drop
        # view-change & checkpoint msgs flow even mid-view-change; normal
        # ordering msgs are frozen until the new view starts (reference
        # ReplicaImp gates handlers on currentViewIsActive())
        if isinstance(msg, m.ReplicaAsksToLeaveViewMsg):
            self._on_ask_to_leave_view(msg)
            return
        if isinstance(msg, m.ViewChangeMsg):
            self._on_view_change(msg)
            return
        if isinstance(msg, m.NewViewMsg):
            self._on_new_view(msg)
            return
        if isinstance(msg, m.CheckpointMsg):
            self._on_checkpoint(msg)
            return
        if isinstance(msg, m.TimeOpinionMsg):
            self._on_time_opinion(sender, msg)
            return
        if isinstance(msg, m.ReplicaStatusMsg):
            if self.info.is_replica(sender):
                self._on_replica_status(msg)
            return
        if isinstance(msg, m.SimpleAckMsg):
            if self.retrans is not None and self.info.is_replica(sender):
                self.retrans.on_ack(sender, msg.acked_msg_code, msg.seq_num,
                                    time.monotonic())
            return
        if isinstance(msg, m.ReqMissingDataMsg):
            if self.info.is_replica(sender):
                self._on_req_missing_data(sender, msg)
            return
        if isinstance(msg, m.ReqViewPrePrepareMsg):
            if self.info.is_replica(sender):
                self._on_req_view_pp(sender, msg)
            return
        if isinstance(msg, m.ReplicaRestartReadyMsg):
            if self.info.is_replica(msg.sender_id):
                self._on_restart_ready(msg)
            return
        if isinstance(msg, m.StateTransferMsg):
            # ST flows even mid-view-change (reference handles it in
            # ReplicaForStateTransfer below the view gate); read-only
            # replicas are legitimate ST destinations (ReadOnlyReplica)
            if self.state_transfer is not None \
                    and (self.info.is_replica(sender)
                         or self.info.is_ro_replica(sender)):
                self.state_transfer.handle_message(sender, msg.payload)
            return
        if isinstance(msg, m.PreProcessRequestMsg):
            if self.preprocessor and self.info.is_replica(sender):
                self.preprocessor.on_preprocess_request(sender, msg)
            return
        if isinstance(msg, m.PreProcessReplyMsg):
            if self.preprocessor and self.info.is_replica(sender):
                self.preprocessor.on_preprocess_reply(sender, msg)
            return
        if isinstance(msg, m.PreProcessBatchRequestMsg):
            if self.preprocessor and self.info.is_replica(sender):
                self.preprocessor.on_preprocess_batch_request(sender, msg)
            return
        if isinstance(msg, m.PreProcessBatchReplyMsg):
            if self.preprocessor and self.info.is_replica(sender):
                self.preprocessor.on_preprocess_batch_reply(sender, msg)
            return
        if isinstance(msg, m.AskForCheckpointMsg):
            # reference ReplicaImp::onMessage<AskForCheckpointMsg>: resend
            # our latest self checkpoint to the asker (RO replicas poll
            # this so a late joiner doesn't wait a whole window).
            # Rate-bounded per asker: unsigned request, bounded reply.
            if not (self.info.is_replica(sender)
                    or sender in self.info.ro_replica_ids):
                return
            now = time.monotonic()
            if now - self._ck_asked.get(sender, 0.0) < 2.0:
                return
            self._ck_asked[sender] = now
            if self._self_ck_latest is not None:
                self.comm.send(sender, self._self_ck_latest.pack())
            return
        if isinstance(msg, m.PrePrepareMsg) and self._pending_entry \
                and self._try_resolve_body(msg):
            return                  # old-view body answering our fetch
        if self.in_view_change:
            return
        if isinstance(msg, m.PrePrepareMsg):
            self._on_pre_prepare(msg)
        elif isinstance(msg, m.PreparePartialMsg):
            self._on_share(msg, "prepare")
        elif isinstance(msg, m.PrepareFullMsg):
            self._on_prepare_full(msg)
        elif isinstance(msg, m.CommitPartialMsg):
            self._on_share(msg, "commit")
        elif isinstance(msg, m.CommitFullMsg):
            self._on_commit_full(msg)
        elif isinstance(msg, m.PartialCommitProofMsg):
            self._on_share(msg, "fast")
        elif isinstance(msg, m.AggregateShareMsg):
            self._on_agg_share(msg)
        elif isinstance(msg, m.FullCommitProofMsg):
            self._on_full_commit_proof(msg)
        elif isinstance(msg, m.StartSlowCommitMsg):
            self._on_start_slow_commit(msg)

    # ------------------------------------------------------------------
    # client requests (ReplicaImp.cpp:397)
    # ------------------------------------------------------------------
    def _on_client_request(self, req: m.ClientRequestMsg,
                           relay: bool = True) -> None:
        """Recorded entry. The per-request span this used to allocate
        is gone — a span per message is exactly the hot-path telemetry
        the flight recorder replaces (check_hotpath now forbids it);
        the trace still joins end-to-end because _accept_pre_prepare's
        consensus_slot span parents on the first request's cid."""
        flight.record(flight.EV_CLIENT_REQ, seq=req.req_seq_num,
                      arg=req.sender_id)
        self._handle_client_request(req, relay=relay)

    def _handle_client_request(self, req: m.ClientRequestMsg,
                               relay: bool = True) -> None:
        client = req.sender_id
        if not self.clients.is_valid_client(client):
            return
        # flag/topology gates — the ONE predicate shared with the
        # admission plane's pre-verify drop (an admission-side drop is
        # final, so the two must never disagree): INTERNAL/principal
        # correspondence, ordered RECONFIG from the operator only
        # (read-only RECONFIG is open to any valid client — per-command
        # authorization happens at execution), no wire-minted
        # HAS_PRE_PROCESSED
        if not m.client_request_admissible(req, self.info):
            return
        if not req.flags & m.RequestFlag.READ_ONLY:
            if not self.is_primary or self.in_view_change:
                # backup: forward FIRST, unverified — forwarding is cheap
                # and not a commitment (the primary verifies); the verify
                # below is paid ONCE per request, only to arm the
                # dead-primary liveness clock honestly (complaints must
                # never be armed by forged floods)
                if (client, req.req_seq_num) in self._forwarded:
                    return        # already forwarded + liveness armed
                if not self.in_view_change and relay:
                    # relay=False when this element arrived inside a
                    # ClientBatchRequestMsg the dispatcher already
                    # relayed whole
                    self.comm.send(self.primary, req.pack())
            else:
                # primary fast drop BEFORE paying for verification: a
                # pending or already-executed request needs no new
                # signature work (the retransmission path — reference
                # ClientsManager duplicate handling). Resending a cached
                # reply unverified is bounded, client-addressed traffic.
                if not self.clients.can_become_pending(client,
                                                       req.req_seq_num):
                    cached = self.clients.cached_reply(client,
                                                       req.req_seq_num)
                    if cached is not None:
                        self.comm.send(client, cached.pack())
                    return
        if getattr(req, "_adm_verified", None) is True:
            # admission plane already verified the client signature in a
            # coalesced per-drain batch (failed verdicts never reach the
            # dispatcher) — go straight to the stateful tail
            self._post_admission(req)
            return
        if self.req_batcher is not None:
            # async plane: the signature check leaves the dispatcher and
            # verifies in a cross-request batch; the verdict re-enters as
            # the "req_verified" internal message and the post-admission
            # logic (which re-reads mutable state) runs then
            key = (client, req.req_seq_num, int(req.flags))
            if key in self._req_verifying:
                return            # retransmission of an in-flight verify
            self._req_verifying.add(key)
            self.req_batcher.submit_nowait(
                client, req.signed_payload(), req.signature,
                lambda ok, _req=req: self.incoming.push_internal(
                    "req_verified", (_req, ok)))
            return
        if not self._verify_client_sig(req):
            return
        self._post_admission(req)

    def _retrans_tick(self) -> None:
        self.retrans.tick(time.monotonic())
        self.m_retransmitted.set(self.retrans.total_retransmitted)

    def _on_req_verified(self, payload) -> None:
        """Admission-batch verdict (dispatcher thread)."""
        req, ok = payload
        self._req_verifying.discard(
            (req.sender_id, req.req_seq_num, int(req.flags)))
        if not ok:
            return
        self._post_admission(req)

    def _post_admission(self, req: m.ClientRequestMsg) -> None:
        """Everything after the client-signature check. With the async
        plane the world may have moved since the request arrived (view
        change, reply cached) — all state reads happen here, not before
        the verify."""
        client = req.sender_id
        if req.flags & m.RequestFlag.READ_ONLY:
            # replied directly — MUST NOT advance the client's
            # last-executed counter (that would make _execute_committed
            # skip a committed write with a lower req_seq: divergence)
            if req.flags & m.RequestFlag.RECONFIG:
                # non-ordered operator command (reference: the operator's
                # direct/bft=false path — how unwedge reaches a cluster
                # that can no longer order anything)
                if self.reconfig is None:
                    return
                payload = self.reconfig.execute(self, req,
                                                self.last_executed,
                                                direct=True)
            else:
                payload = self.handler.read(client, req.request)
            reply = m.ClientReplyMsg(
                sender_id=self.id, req_seq_num=req.req_seq_num,
                current_primary=self.primary, reply=payload,
                replica_specific_info=b"")
            if self._opt_replies:
                # optimistic plane: reads need the same per-replica
                # vouching as writes — a strict client accepts nothing
                # short of f+1 matching SIGNED replies
                reply.signature = self.sig.sign(reply.signed_payload())
            self.comm.send(client, reply.pack())
            return
        cached = self.clients.cached_reply(client, req.req_seq_num)
        if cached is not None:
            self.comm.send(client, cached.pack())
            return
        if not self.is_primary or self.in_view_change:
            # the forward itself happened at arrival (pre-verify); here —
            # with the signature now checked — arm the dead-primary
            # liveness clock. First-sighting timestamp only:
            # retransmissions must not reset it or the complaint never
            # fires.
            self._forwarded.setdefault((client, req.req_seq_num),
                                       time.monotonic())
            return
        if req.flags & m.RequestFlag.PRE_PROCESS and self.preprocessor:
            # optimistic pre-execution path (PreProcessor, SURVEY §3.5)
            self.preprocessor.on_client_request(req)
            return
        # PRE_PROCESS without a preprocessor: order normally (the flag
        # must stay — it is covered by the client's signature)
        self._admit_request(req)

    def _admit_request(self, req: m.ClientRequestMsg) -> None:
        """Primary: queue a request for batching (tail of
        onMessage<ClientRequestMsg>). Also the entry point for the
        preprocessor's ordered PreProcessResult wrappers."""
        if not self.clients.can_become_pending(req.sender_id,
                                               req.req_seq_num):
            return
        self.clients.add_pending(req.sender_id, req.req_seq_num, req.cid)
        self.pending_requests.append(req)
        self._try_send_pre_prepare()

    # ------------------------------------------------------------------
    # primary: batching + PrePrepare (ReplicaImp.cpp:657,865)
    # ------------------------------------------------------------------
    def _try_send_pre_prepare(self) -> None:
        if not self._running or not self.is_primary or self.in_view_change:
            return
        # wedge fill: an idle cluster must still REACH the agreed stop
        # point, so the primary proposes empty batches up to it
        # (reference: noop fill toward the super-stable checkpoint)
        wedge_fill = (self.control.wedge_point is not None
                      and self.primary_next_seq <= self.control.wedge_point)
        if not self.pending_requests and not wedge_fill:
            return
        # pipeline gate (reference ReplicaImp::tryToSendPrePrepareMsg /
        # concurrencyLevel): cap proposed-but-not-executed slots. Under
        # load this is what creates real batches — requests arriving
        # while the pipeline is full accumulate and ship together when a
        # slot completes (execution re-triggers this), instead of every
        # request paying a full consensus slot of per-replica crypto.
        # At light load nothing is in flight and proposal is immediate.
        in_flight = (self.primary_next_seq - 1) - self.last_executed
        if in_flight >= max(1, self.cfg.concurrency_level):
            return
        seq = self.primary_next_seq
        if seq > self.last_stable + self.cfg.work_window_size:
            return                              # window full: wait for stability
        if self.control.blocks_ordering(seq):
            return                              # wedged (ControlStateManager)
        batch = self.pending_requests[:self.cfg.max_num_of_requests_in_batch]
        self.pending_requests = self.pending_requests[len(batch):]
        raw_reqs = [r.pack() for r in batch]
        pp = m.PrePrepareMsg(
            sender_id=self.id, view=self.view, seq_num=seq,
            epoch=self.epoch,
            first_path=int(self.controller.current_path),
            time=(self.time_service.primary_stamp()
                  if self.cfg.time_service_enabled
                  else int(time.time() * 1e6)),
            requests_digest=m.PrePrepareMsg.compute_requests_digest(raw_reqs),
            requests=raw_reqs, signature=b"")
        pp.signature = self.sig.sign(pp.signed_payload())
        self.primary_next_seq = seq + 1
        self.m_preprepares.inc()
        self._broadcast_tracked(pp)             # backups ack receipt
        self._accept_pre_prepare(pp)            # primary processes its own

    # ------------------------------------------------------------------
    # PrePrepare (ReplicaImp.cpp:1047)
    # ------------------------------------------------------------------
    def _pp_acceptable_now(self, pp: m.PrePrepareMsg) -> bool:
        """Structural acceptance checks that depend on CURRENT protocol
        state — run at arrival AND re-run when the async client-sig
        verdict lands (the view/window may have moved while the batch was
        on a worker). Content checks (parse, per-request validity, time
        bound) run at arrival only: message content cannot change."""
        if pp.view != self.view or pp.sender_id != self.primary \
                or self.in_view_change:
            return False
        if not self.window.in_window(pp.seq_num) \
                or pp.seq_num <= self.last_stable:
            return False
        if self.window.get(pp.seq_num).pre_prepare is not None:
            return False                        # already have it
        if self.control.blocks_ordering(pp.seq_num):
            return False                        # wedged: nothing past stop
        # view-change safety: a seqnum certified as possibly-committed in
        # an earlier view may ONLY be re-proposed with the same batch
        # (ViewChangeSafetyLogic restrictions)
        restr = self.restrictions.get(pp.seq_num)
        return restr is None or pp.requests_digest == restr.requests_digest

    def _on_pre_prepare(self, pp: m.PrePrepareMsg) -> None:
        # slot-stage anchor: adm_wait ends / dispatch begins here
        flight.record(flight.EV_PP_DISPATCH, seq=pp.seq_num,
                      view=pp.view)
        if pp.view == self.view and pp.sender_id == self.primary \
                and self.window.in_window(pp.seq_num):
            # receipt ack, duplicates included (retransmission tracking
            # keys on receipt, not acceptance)
            self._ack(pp.sender_id, int(pp.CODE), pp.seq_num)
        if not self._pp_acceptable_now(pp):
            return
        info = self.window.get(pp.seq_num)
        if info.pp_verifying is not None:
            # a duplicate arriving during the async-verify window must not
            # repay the inline sig check + request validation below
            return
        # admission verdict: True = the replica signature AND every
        # embedded client signature verified in the plane's coalesced
        # batch; False = that batch FAILED (the message was admitted
        # only so _try_resolve_body could consume a digest-authenticated
        # old-view body — as a live proposal it dies here); None =
        # legacy path, verify inline/async below
        adm_ok = getattr(pp, "_adm_verified", None)
        if adm_ok is False:
            log.warning("PrePrepare rejected by admission signature "
                        "batch (sender=%d)", pp.sender_id)
            return
        if adm_ok is None and not self._verify_replica_msg(
                pp, seq=pp.seq_num):
            log.warning("PrePrepare replica-signature check failed "
                        "(sender=%d)", pp.sender_id)
            return
        # Every embedded client request is verified before signing shares
        # over the batch — a byzantine primary must not be able to smuggle
        # forged client operations (reference: per-request verification
        # via RequestThreadPool, ReplicaImp.cpp onMessage<PrePrepareMsg>).
        # Structural checks run here on the dispatcher; the signature
        # batch itself verifies on a background worker (one device
        # dispatch with the CUDA backend) and re-enters as "pp_verified".
        try:
            reqs = pp.client_requests()
        except m.MsgError:
            return
        for r in reqs:
            if r.flags & m.RequestFlag.HAS_PRE_PROCESSED:
                from tpubft_torch.preprocessor.preprocessor import (
                    validate_preprocessed_request)
                if not validate_preprocessed_request(self, r):
                    return
            if not self.clients.is_valid_client(r.sender_id):
                return
            # a byzantine primary must not smuggle INTERNAL-flagged ops
            # from external principals (or strip the flag from real ones)
            if bool(r.flags & m.RequestFlag.INTERNAL) \
                    != self.info.is_internal_client(r.sender_id):
                return
            if r.flags & m.RequestFlag.RECONFIG \
                    and r.sender_id != self.info.operator_id:
                return
        # time service: bound the primary's stamp (reference
        # TimeServiceManager::hasTimeRequest). Gap-fill PrePrepares
        # (empty, time=0) and restricted re-proposals (old stamp, content
        # already certified) are exempt or view change could never finish.
        if (self.cfg.time_service_enabled and reqs
                and pp.seq_num not in self.restrictions
                and not self.time_service.validate(pp.time)):
            return
        # pre-executed wrappers carry their own proof set (original client
        # sig + f+1 replica result sigs) instead of a wrapper signature
        if adm_ok is None:
            items = [(r.sender_id, r.signed_payload(), r.signature)
                     for r in reqs
                     if not r.flags & m.RequestFlag.HAS_PRE_PROCESSED]
            if items and self.cfg.async_verification:
                info.pp_verifying = pp          # guarded at entry above
                self.collector_pool.submit(
                    lambda: self._bg_verify_pp(pp, items))
                return
            if items and not self._verify_req_items(items, pp.seq_num):
                return
        self._accept_pre_prepare(pp)

    # ---- inline verification fallbacks (admission-off path) ----
    # Kept OUT of the hot-path handlers on purpose: tools/check_hotpath.py
    # forbids direct unpack/verify call sites inside the dispatcher's
    # admitted-message handlers, so any new inline crypto must route
    # through these seams (and stay skippable when a verdict is attached).
    def _verify_replica_msg(self, msg, seq=None, view_scoped=False) -> bool:
        """One replica-signed message, on the dispatcher (legacy path)."""
        return self.sig.verify(msg.sender_id, msg.signed_payload(),
                               msg.signature, seq=seq,
                               view_scoped=view_scoped)

    def _verify_client_sig(self, req: m.ClientRequestMsg) -> bool:
        return self.sig.verify(req.sender_id, req.signed_payload(),
                               req.signature)

    def _verify_req_items(self, items, seq: int) -> bool:
        """Inline embedded-request batch check (async_verification off)."""
        with TimeRecorder(self._h_verify):
            return all(self.sig.verify_batch(items, seq=seq))

    def _parse_batch_inners(self, msg: m.ClientBatchRequestMsg):
        """Legacy-path ClientBatch element parse (admission attaches
        pre-parsed survivors as `_adm_inners`); None = malformed batch."""
        return m.parse_batch_elements(msg)

    def _bg_verify_pp(self, pp: m.PrePrepareMsg, items) -> None:
        """Worker-thread body: one verify_batch call (one device dispatch
        on the CUDA backend), verdict re-enters the dispatcher."""
        from tpubft_torch.diagnostics import TimeRecorder
        try:
            with TimeRecorder(self._h_verify):
                ok = all(self.sig.verify_batch(items, seq=pp.seq_num))
        except Exception:  # noqa: BLE001 — job failure = verify failure
            log.exception("client-sig batch job raised for seq %d",
                          pp.seq_num)
            ok = False
        self.incoming.push_internal("pp_verified", (pp, ok))

    def _on_pp_verified(self, payload) -> None:
        """Async client-sig batch verdict (dispatcher thread). The world
        may have moved while the batch was on the worker: re-run the
        cheap structural checks before accepting."""
        pp, ok = payload
        if not self.window.in_window(pp.seq_num):
            return
        info = self.window.peek(pp.seq_num)
        if info is not None and info.pp_verifying is pp:
            # identity check: a verdict for a message the view change
            # dropped must not clear a NEWER message's in-flight guard
            info.pp_verifying = None
        if not ok:
            log.warning("client-signature batch rejected for seq %d "
                        "(byzantine primary or forged request)", pp.seq_num)
            return
        if info is None:
            return
        if not self._pp_acceptable_now(pp):
            return
        self._accept_pre_prepare(pp)

    def _accept_pre_prepare(self, pp: m.PrePrepareMsg) -> None:
        flight.record(flight.EV_PP_ACCEPT, seq=pp.seq_num, view=pp.view)
        info = self.window.get(pp.seq_num)
        info.pre_prepare = pp
        info.commit_path = pp.first_path
        info.received_at = time.monotonic()
        # consensus-slot span: accept → executed, joined to the first
        # request's trace (reference: per-stage child spans carrying the
        # PrePrepare's span context, ReplicaImp.cpp:1070)
        from tpubft_torch.utils.tracing import SpanContext, get_tracer
        parent = None
        try:
            reqs = pp.client_requests()
            if reqs:
                parent = SpanContext.parse(reqs[0].cid or "")
        except m.MsgError:
            pass
        info.span = get_tracer().start_span("consensus_slot", parent=parent)
        info.span.set_tag("r", self.id).set_tag("seq", pp.seq_num) \
            .set_tag("view", pp.view).set_tag("path", pp.first_path)
        with self._tran() as st:
            st.seq(pp.seq_num).pre_prepare = pp.pack()
        if pp.first_path == int(m.CommitPath.SLOW):
            info.slow_started = True
            self._send_prepare_partial(info)
        else:
            self._send_partial_commit_proof(info)
        self._drain_early_shares(info)
        self._drain_early_certs(info)
        # speculation starts HERE on every path: the
        # combine window opens at acceptance and the overlay covers the
        # whole prepare+commit round. After the early-evidence drains: a
        # slot that just committed from buffered certs takes the normal
        # path instead.
        self._pump_speculation()

    # ------------------------------------------------------------------
    # slow path: shares → collectors (ReplicaImp.cpp:1373,1399)
    # ------------------------------------------------------------------
    def _send_prepare_partial(self, info: SeqNumInfo) -> None:
        pp = info.pre_prepare
        d = self._share_digest("prepare", self.view, pp.seq_num, pp.digest())
        share = self.slow_signer.sign_share(d)
        msg = m.PreparePartialMsg(sender_id=self.id, view=self.view,
                                  seq_num=pp.seq_num, digest=d, sig=share,
                                  epoch=self.epoch)
        self._route_share(msg, "prepare")

    def _send_commit_partial(self, info: SeqNumInfo) -> None:
        pp = info.pre_prepare
        d = self._share_digest("commit", self.view, pp.seq_num, pp.digest())
        share = self.slow_signer.sign_share(d)
        msg = m.CommitPartialMsg(sender_id=self.id, view=self.view,
                                 seq_num=pp.seq_num, digest=d, sig=share,
                                 epoch=self.epoch)
        self._route_share(msg, "commit")

    # ------------------------------------------------------------------
    # share-aggregation overlay (consensus/aggregation.py): slow-path
    # shares climb a view-seeded tree rooted at the collector, each hop
    # folding its subtree into ONE 56-byte partial — the collector's
    # fan-in drops from O(n) datagrams per slot to O(fanout) at every
    # node (arXiv 1911.04698 rebuilt on the collector-centric flow)
    # ------------------------------------------------------------------
    def _overlay(self, view: int, seq_num: int, root: int):
        return overlay_for(self._agg_mode, self.cfg.n_val, self._agg_fanout,
                           root, view, seq_num, self.cfg.agg_rotate_seqs)

    def _route_share(self, msg, kind: str) -> None:
        """Send a slow-path share toward its collector: direct when
        aggregation is off (byte-identical to the historical path), via
        the overlay when on — banked locally if this node is interior,
        else to the overlay parent. Every non-direct route arms the
        parent-timeout fallback."""
        collector_id = self.info.collector_for(self.view, msg.seq_num)
        if collector_id == self.id:
            self._on_share(msg, kind)
            return
        if self._agg_mode != "off":
            ov = self._overlay(self.view, msg.seq_num, collector_id)
            if ov.is_interior(self.id):
                # our own share joins our subtree's next flush
                self._agg_absorb(self.id, self.view, msg.seq_num, kind,
                                 msg.digest, msg.sig)
                up = ov.parent_of(self.id)
                self._agg_arm_fallback(msg, kind, collector_id,
                                       -1 if up is None else up)
                return
            parent = ov.parent_of(self.id)
            if parent is not None and parent != collector_id:
                if not self._agg_parent_sick(parent):
                    self._send_tracked(parent, msg)
                    self._agg_arm_fallback(msg, kind, collector_id, parent)
                    return
                # sick parent: fall through to the direct send — one
                # timeout already proved this edge dead, later slots
                # must not re-pay it
            # depth-1 leaf: the overlay edge IS the direct send
        self._send_tracked(collector_id, msg)

    def _agg_parent_sick(self, parent: int) -> bool:
        """A parent that ate a share until the fallback timeout is
        routed AROUND (direct to the collector) for the rest of the
        view: the overlay reshuffles at the next view change (and per
        rotation window in gossip mode), so sickness is view-scoped —
        without this memory every slot behind a dead interior node
        pays the full parent timeout again."""
        entry = self._agg_sick.get(parent)
        return entry is not None and entry == self.view

    def _agg_arm_fallback(self, msg, kind: str, collector_id: int,
                          parent: int = -1) -> None:
        self._agg_fallback[(self.view, msg.seq_num, kind)] = (
            time.monotonic() + self.cfg.agg_parent_timeout_ms / 1e3,
            msg, collector_id, parent)

    def _agg_absorb(self, sender: int, view: int, seq_num: int, kind: str,
                    digest: bytes, blob: bytes) -> None:
        """Interior node: bank a child's raw share or subtree partial
        for the next flush (dispatcher thread; no crypto here — decode
        and summation happen on the collector-pool worker). The digest
        is part of the buffer key, so shares over a wrong digest
        self-segregate instead of poisoning the honest buffer."""
        key = (view, seq_num, kind, digest)
        buf = self._agg_buffers.get(key)
        if buf is None:
            buf = self._agg_buffers[key] = {}
        cur = buf.get(sender + 1)
        if cur is None or self._agg_weight(blob) > self._agg_weight(cur):
            # a child's cumulative re-flush supersedes its earlier,
            # thinner partial (raw shares always weigh 1, so they never
            # displace anything)
            buf[sender + 1] = blob
            # quiescence debounce: every growth re-arms the age clock,
            # so the age-based flush fires only once the trickle of
            # child arrivals PAUSES (a full subtree still flushes
            # immediately via the weight test) — without this, a slow
            # host flushes one thin partial per arrival window and the
            # overlay's fan-in win evaporates
            self._agg_buffer_born[key] = time.monotonic()

    def _agg_weight(self, blob: bytes) -> int:
        """Contributor count of a banked entry, dispatcher-cheap: the
        bitmap prefix for partials, 1 for raw shares."""
        # reached only with share aggregation (multisig-bls keys)
        from tpubft_torch.crypto.systems import AGG_CERT_LEN
        if len(blob) == AGG_CERT_LEN:
            (bm,) = struct.unpack_from("<Q", blob, 0)
            return max(bin(bm).count("1"), 1)
        return 1

    def _agg_flush_tick(self) -> None:
        """Dispatcher timer: flush buffers whose subtree is complete or
        that have been QUIESCENT for agg_flush_ms (the age clock re-arms
        on every arrival, see _agg_absorb). One collector-pool job per tick
        sums EVERY due buffer in one device launch
        (BlsMultisigVerifier.aggregate_partials → msm_batch).

        Flushes are cumulative: the buffer is kept (not popped) and
        re-flushes when membership grew, so a child share that arrives
        AFTER the age-based flush still climbs the overlay — as a
        superset partial that supersedes the earlier one at the parent
        (weight-based replacement) instead of being silently lost to
        the first-flush-wins entry key."""
        if not self._agg_buffers:
            return
        now = time.monotonic()
        age_s = self.cfg.agg_flush_ms / 1e3
        due = []
        for key in list(self._agg_buffers):
            view, seq_num, kind, _digest = key
            if view != self.view or self.in_view_change \
                    or seq_num <= self.last_stable \
                    or not self.window.in_window(seq_num):
                del self._agg_buffers[key]
                self._agg_buffer_born.pop(key, None)
                self._agg_flushed.pop(key, None)
                continue
            members = frozenset(self._agg_buffers[key])
            if members == self._agg_flushed.get(key):
                continue                  # nothing new since last flush
            collector_id = self.info.collector_for(view, seq_num)
            ov = self._overlay(view, seq_num, collector_id)
            expected = len(ov.subtree_ids(self.id))
            weight = sum(self._agg_weight(b)
                         for b in self._agg_buffers[key].values())
            if weight >= expected \
                    or now - self._agg_buffer_born[key] >= age_s:
                due.append(key)
                self._agg_flushed[key] = members
                # re-arm the age window so late stragglers batch up
                # instead of one flush per arrival
                self._agg_buffer_born[key] = now
        if not due:
            return
        snapshot = [(key, dict(self._agg_buffers[key])) for key in due]
        self.collector_pool.submit(lambda: self._agg_combine_job(snapshot))

    def _agg_combine_job(self, snapshot) -> None:
        """Collector-pool worker: decode banked entries (accumulator
        `add` semantics — malformed/overlapping entries dropped
        deterministically) and fold each buffer into one packed partial;
        all sums ride ONE segmented multi-MSM launch. Results re-enter
        the dispatcher as "agg_partial"."""
        try:
            jobs, keys = [], []
            for key, entries in snapshot:
                decoded = self.slow_verifier._decode_job_entries(entries)
                ids: List[int] = []
                pts = []
                for k in sorted(decoded):
                    eids, pt = decoded[k]
                    ids.extend(eids)
                    pts.append(pt)
                if pts:
                    jobs.append((sorted(ids), pts))
                    keys.append(key)
            if not jobs:
                return
            partials = self.slow_verifier.aggregate_partials(jobs)
            self.incoming.push_internal("agg_partial",
                                        list(zip(keys, partials)))
        except Exception:  # noqa: BLE001 — fallback covers a lost flush
            log.exception("agg combine job failed")

    def _on_agg_partials(self, payload) -> None:
        """Flushed partials (dispatcher thread): pack each into an
        AggregateShareMsg and send it one hop up the overlay."""
        for (view, seq_num, kind, digest), partial in payload:
            if view != self.view or self.in_view_change \
                    or seq_num <= self.last_stable:
                continue
            collector_id = self.info.collector_for(view, seq_num)
            if collector_id == self.id:
                continue                    # we became collector mid-flush
            ov = self._overlay(view, seq_num, collector_id)
            parent = ov.parent_of(self.id)
            if parent is None:
                continue
            if parent != collector_id and self._agg_parent_sick(parent):
                parent = collector_id    # route the partial AROUND the
                #                          dead hop; the root absorbs it
            flight.record(flight.EV_AGG_FORWARD, seq=seq_num, view=view,
                          arg=self._agg_weight(partial))
            self.m_agg_forwarded.inc()
            self._send_tracked(parent, m.AggregateShareMsg(
                sender_id=self.id, view=view, seq_num=seq_num,
                kind=0 if kind == "prepare" else 1,
                digest=digest, agg=partial, epoch=self.epoch))

    def _on_agg_share(self, msg: m.AggregateShareMsg) -> None:
        """A partial aggregate climbing the overlay: banked again if this
        node is an interior hop, fed into the slot's ShareCollector at
        the root — keyed by the forwarding child, so a forged partial
        bisects to exactly that child's subtree (contributor bitmap) and
        the bad-share pop in _on_combine_result drops the whole subtree
        in one move."""
        if self._agg_mode == "off":
            return
        if msg.view != self.view or not self.info.is_replica(msg.sender_id):
            return
        if self.in_view_change:
            return
        if not self.window.in_window(msg.seq_num) \
                or msg.seq_num <= self.last_stable:
            return
        self.m_share_msgs_rcvd.inc()
        self._ack(msg.sender_id, int(msg.CODE), msg.seq_num)
        kind = "prepare" if msg.kind == 0 else "commit"
        if self.info.collector_for(self.view, msg.seq_num) != self.id:
            self._agg_absorb(msg.sender_id, msg.view, msg.seq_num, kind,
                             msg.digest, msg.agg)
            return
        info = self.window.get(msg.seq_num)
        if info.pre_prepare is None:
            # PP not accepted yet: park beside early raw shares, drained
            # through _drain_early_shares under the "agg" pseudo-kind
            info.early_shares.setdefault("agg", []).append(msg)
            if not info.first_evidence_at:
                info.first_evidence_at = time.monotonic()
            return
        collector = self._collector(info, kind)
        if collector is None or msg.digest != collector.digest:
            return
        flight.record(flight.EV_AGG_ROOT, seq=msg.seq_num, view=msg.view,
                      arg=self._agg_weight(msg.agg))
        self.m_agg_absorbed.inc()
        if collector.add_share(msg.sender_id, msg.agg):
            self.collector_pool.maybe_launch(collector)

    def _agg_fallback_tick(self) -> None:
        """Dispatcher timer: any share still waiting on the overlay past
        its parent timeout re-sends DIRECT to the collector, and the
        parent that ate it is marked sick for the rest of the view
        (_agg_parent_sick) so later slots route around it immediately.
        The liveness floor is exactly the no-aggregation path — a dead
        or byzantine interior node costs ONE timeout per view, never a
        view change."""
        if not self._agg_fallback:
            return
        now = time.monotonic()
        for key in list(self._agg_fallback):
            view, seq_num, kind = key
            deadline, msg, collector_id, parent = self._agg_fallback[key]
            info = (self.window.peek(seq_num)
                    if self.window.in_window(seq_num) else None)
            done = (view != self.view or self.in_view_change
                    or seq_num <= self.last_stable
                    or (info is not None
                        and (info.committed
                             or (kind == "prepare" and info.prepared))))
            if done:
                del self._agg_fallback[key]
                continue
            if now < deadline:
                continue
            del self._agg_fallback[key]
            if parent >= 0 and view == self.view \
                    and self.retrans is not None \
                    and (self.retrans.is_pending(parent, int(msg.CODE),
                                                 msg.seq_num)
                         or self.retrans.is_pending(
                             parent, int(m.AggregateShareMsg.CODE),
                             msg.seq_num)):
                # unacked after the whole parent window: the EDGE is
                # dead, not just the slot slow — route around it for
                # the rest of the view (leaves track their raw share,
                # interior hops their forwarded partial)
                self._agg_sick[parent] = view
            flight.record(flight.EV_AGG_FALLBACK, seq=seq_num, view=view,
                          arg=0 if kind == "prepare" else 1)
            self.m_agg_fallbacks.inc()
            if collector_id == self.id:
                self._on_share(msg, kind)
            else:
                self._send_tracked(collector_id, msg)

    def _fast_tools(self, path: int):
        """(signer, verifier, domain-tag) for a fast commit path."""
        if path == int(m.CommitPath.OPTIMISTIC_FAST):
            return self.opt_signer, self.opt_verifier, "fast0"
        return self.thr_signer, self.thr_verifier, "fast1"

    def _send_partial_commit_proof(self, info: SeqNumInfo) -> None:
        """Fast path share (reference sendPartialProof ReplicaImp.cpp:1319)."""
        pp = info.pre_prepare
        signer, _, tag = self._fast_tools(pp.first_path)
        d = self._share_digest(tag, self.view, pp.seq_num, pp.digest())
        msg = m.PartialCommitProofMsg(sender_id=self.id, view=self.view,
                                      epoch=self.epoch,
                                      seq_num=pp.seq_num, digest=d,
                                      sig=signer.sign_share(d),
                                      path=pp.first_path)
        collector_id = self.info.collector_for(self.view, pp.seq_num)
        if collector_id == self.id:
            self._on_share(msg, "fast")
        else:
            self._send_tracked(collector_id, msg)

    def _on_share(self, msg: m.PreparePartialMsg, kind: str) -> None:
        """Collector side: accumulate a threshold share
        (CollectorOfThresholdSignatures::addMsgWithPartialSignature)."""
        if msg.view != self.view or not self.info.is_replica(msg.sender_id):
            return
        if self.in_view_change:
            # ordering in this view is frozen and _on_combine_result
            # discards results while the change is in flight: a share
            # accepted here can only launch combines that cannot land.
            # Under a breaker-OPEN + view-change storm those combines run
            # on the scalar fallback — stale-view shares were burning the
            # exact CPU the degraded cluster needs to finish the change.
            return
        if not self.window.in_window(msg.seq_num) \
                or msg.seq_num <= self.last_stable:
            return
        if kind != "fast" and msg.sender_id != self.id:
            # Prepare/Commit share fan-in only (the aggregation overlay's
            # target metric) — fast-path shares are always one direct
            # datagram to the collector and never aggregate
            self.m_share_msgs_rcvd.inc()
        # receipt ack (duplicates too — the sender may have missed the
        # first ack; retransmission keys on receipt, not on usefulness)
        self._ack(msg.sender_id, int(msg.CODE), msg.seq_num)
        if self._agg_mode != "off" and kind != "fast" \
                and msg.sender_id != self.id \
                and self.info.collector_for(self.view, msg.seq_num) != self.id:
            # interior overlay hop: bank the child's raw share for the
            # next flush (no PrePrepare needed — the digest keys the
            # buffer, and only the root resolves digests to collectors)
            self._agg_absorb(msg.sender_id, msg.view, msg.seq_num, kind,
                             msg.digest, msg.sig)
            return
        info = self.window.get(msg.seq_num)
        if info.pre_prepare is None:
            info.early_shares.setdefault(kind, []).append(msg)
            if not info.first_evidence_at:
                info.first_evidence_at = time.monotonic()
            return
        if kind == "fast" and msg.path != info.pre_prepare.first_path:
            return                              # share for the wrong path
        collector = self._collector(info, kind)
        if collector is None or msg.digest != collector.digest:
            return                              # share over a wrong digest
        if collector.add_share(msg.sender_id, msg.sig):
            self.collector_pool.maybe_launch(collector)

    def _collector(self, info: SeqNumInfo, kind: str) -> Optional[ShareCollector]:
        pp = info.pre_prepare
        if pp is None:
            return None
        attr = f"{kind}_collector"
        col = getattr(info, attr)
        if col is None:
            if kind == "fast":
                _, verifier, tag = self._fast_tools(pp.first_path)
            else:
                verifier, tag = self.slow_verifier, kind
            d = self._share_digest(tag, self.view, pp.seq_num, pp.digest())
            col = ShareCollector(self.view, pp.seq_num, kind, d, verifier)
            setattr(info, attr, col)
        return col

    def _drain_early_shares(self, info: SeqNumInfo) -> None:
        for kind, msgs in list(info.early_shares.items()):
            info.early_shares[kind] = []
            for msg in msgs:
                if kind == "agg":
                    self._on_agg_share(msg)
                else:
                    self._on_share(msg, kind)

    # ------------------------------------------------------------------
    # combine results (internal msg; reference onInternalMsg :1517)
    # ------------------------------------------------------------------
    def _on_combine_flush(self, n_slots: int) -> None:
        """Fused combine flush drained (combine-batch thread): batch
        stats only — locked counters/histogram, no protocol state."""
        self.m_combine_batches.inc()
        self.m_combined_slots.inc(n_slots)
        self._h_combine_batch.record(n_slots)

    def _on_combine_result(self, res: CombineResult) -> None:
        # the verdict's state flip happens HERE, dispatcher-side, on the
        # exact collector the job ran for — combine workers/batchers
        # never write collector state (it would race ready_for_job on
        # this thread). Unconditional: even a stale verdict (view
        # changed, window slid) must clear its own collector's
        # job_launched, or an outlived collector could wedge.
        if res.collector is not None:
            res.collector.on_result(res)
        if res.view != self.view or not self.window.in_window(res.seq_num) \
                or self.in_view_change:
            return
        info = self.window.peek(res.seq_num)
        if info is None or info.pre_prepare is None:
            return
        if not res.ok:
            log.warning("combine failed kind=%s seq=%d bad_shares=%s",
                        res.kind, res.seq_num, res.bad_shares)
            # bad shares identified: drop them, then retry if an honest
            # quorum is still present (or when the next share arrives)
            col = getattr(info, f"{res.kind}_collector", None)
            if col is not None:
                for sid in res.bad_shares:
                    col.shares.pop(sid, None)
                    # signer ids are 1-based; origin replica is sid-1
                    self.byz_telemetry.bad_share(sid - 1)
                self.collector_pool.maybe_launch(col)
            return
        pp = info.pre_prepare
        if res.kind == "fast":
            _, _, tag = self._fast_tools(pp.first_path)
            d = self._share_digest(tag, self.view, pp.seq_num, pp.digest())
            full = m.FullCommitProofMsg(sender_id=self.id, view=self.view,
                                        seq_num=res.seq_num, digest=d,
                                        sig=res.combined_sig,
                                        epoch=self.epoch)
            self._broadcast_tracked(full)
            self._accept_full_commit_proof(full)
            return
        d = self._share_digest(res.kind, self.view, pp.seq_num, pp.digest())
        if res.kind == "prepare":
            full = m.PrepareFullMsg(sender_id=self.id, view=self.view,
                                    seq_num=res.seq_num, digest=d,
                                    sig=res.combined_sig,
                                    epoch=self.epoch)
            self._broadcast_tracked(full)
            self._accept_prepare_full(full)
        elif res.kind == "commit":
            full = m.CommitFullMsg(sender_id=self.id, view=self.view,
                                   epoch=self.epoch,
                                   seq_num=res.seq_num, digest=d,
                                   sig=res.combined_sig)
            self._broadcast_tracked(full)
            self._accept_commit_full(full)

    # ------------------------------------------------------------------
    # full certificates
    # ------------------------------------------------------------------
    def _cert_tools(self, msg, kind: str):
        """(verifier, expected digest) for a full-certificate message
        against CURRENT state, "early" when the PrePrepare isn't accepted
        yet, or None when the message can't be valid."""
        if msg.view != self.view or not self.window.in_window(msg.seq_num) \
                or msg.seq_num <= self.last_stable:
            return None
        info = self.window.peek(msg.seq_num)
        if info is None or info.pre_prepare is None:
            return "early"
        if kind == "fast":
            _, verifier, tag = self._fast_tools(info.pre_prepare.first_path)
        else:
            verifier, tag = self.slow_verifier, kind
        d = self._share_digest(tag, self.view, msg.seq_num,
                               info.pre_prepare.digest())
        if msg.digest != d:
            return None
        return verifier, d

    def _handle_full_cert(self, msg, kind: str) -> None:
        """Common path for PrepareFull / CommitFull / FullCommitProof:
        structural checks on the dispatcher, the threshold verification as
        a background job re-entering as "cert_verified" (reference:
        CombinedSigVerificationJob, CollectorOfThresholdSignatures.hpp:409)."""
        tools = self._cert_tools(msg, kind)
        if tools is None:
            return
        self._ack(msg.sender_id, int(msg.CODE), msg.seq_num)
        if tools == "early":
            # PP not here yet (possibly still in async verification):
            # buffer per (kind, sender), drained on PP acceptance — one
            # slot per sender, so a byzantine peer's spam only ever
            # displaces its own buffered certs, never the collector's
            if self.info.is_replica(msg.sender_id):
                info = self.window.get(msg.seq_num)
                info.early_certs[(kind, msg.sender_id)] = msg
                if not info.first_evidence_at:
                    info.first_evidence_at = time.monotonic()
            return
        info = self.window.get(msg.seq_num)
        if info.committed or (kind == "prepare" and info.prepared):
            return
        verifier, d = tools
        # --- optimistic release: the structural check above
        # bound this cert to OUR accepted PrePrepare's digest; on the
        # slow path a VERIFIED prepare certificate (2f+c+1) already
        # vouches for the batch. Release the slot to the client-visible
        # path now and let the pairing verify land behind — a later BAD
        # verdict poisons the plane (see _on_cert_verified) but commits
        # still gate last_executed persistence (_apply_exec_runs clamp).
        if self._opt_replies and self.cfg.async_verification \
                and not self._opt_poisoned and not info.opt_committed \
                and kind != "prepare" \
                and (kind == "fast" or info.prepared):
            info.opt_committed = True
            info.opt_committed_ns = time.monotonic_ns()
            flight.record(flight.EV_OPT_REPLY, seq=msg.seq_num,
                          view=msg.view, arg=1 if kind == "fast" else 0)
            self.m_opt_replies.inc()
            self._execute_committed()
        if not self.cfg.async_verification:
            if self._verify_cert_inline(verifier, d, msg.sig):
                self._accept_cert(msg, kind)
            return
        if kind in info.cert_verifying:
            # a same-kind job is in flight (possibly over a forged cert):
            # park this one per sender and retry when that verdict lands,
            # so a forgery can't shadow the genuine certificate
            if self.info.is_replica(msg.sender_id):
                info.cert_pending[(kind, msg.sender_id)] = msg
            return
        info.cert_verifying[kind] = msg
        from tpubft_torch.crypto.interfaces import IThresholdVerifier
        if type(verifier).verify_batch_certs \
                is not IThresholdVerifier.verify_batch_certs:
            # backend has a real aggregated check (BLS RLC pairing):
            # batch across seqnums/kinds
            self.cert_batcher.submit(verifier, d, msg.sig, (msg, kind))
            return
        self.collector_pool.submit(
            lambda: self._bg_verify_cert(verifier, d, msg, kind))

    def _bg_verify_cert(self, verifier, d: bytes, msg, kind: str) -> None:
        """Worker-thread combined-cert check; verdict re-enters the
        dispatcher as "cert_verified"."""
        try:
            ok = verifier.verify(d, msg.sig)
        except Exception:  # noqa: BLE001
            log.exception("cert verify job raised (kind=%s seq=%d)",
                          kind, msg.seq_num)
            ok = False
        self.incoming.push_internal("cert_verified", (msg, kind, ok))

    def _verify_cert_inline(self, verifier, d: bytes, sig: bytes) -> bool:
        """Inline combined-cert check (async_verification=False debug)."""
        return verifier.verify(d, sig)

    def _on_cert_verified(self, payload) -> None:
        """Async combined-cert verdict (dispatcher thread)."""
        msg, kind, ok = payload
        if not self.window.in_window(msg.seq_num):
            return
        info = self.window.peek(msg.seq_num)
        if info is not None and info.cert_verifying.get(kind) is msg:
            del info.cert_verifying[kind]
        if ok:
            # re-validate vs current state: view change may have reset the
            # window entry, or a different PP may sit there now — the
            # digest re-check binds the cert to the PP it actually covers
            tools = self._cert_tools(msg, kind)
            if tools is not None and tools != "early":
                self._accept_cert(msg, kind)
        else:
            # per-origin evidence: a cert that failed the DEFERRED check
            # passed the structural one, so its sender forged or relayed
            # a bad combined signature — attributable, count it
            self.byz_telemetry.deferred_cert_failure(msg.sender_id)
        if not ok and (info is not None and info.opt_committed
                       and not info.committed and kind != "prepare"):
            # the deferred pairing check FAILED on a slot we already
            # released optimistically: an actively-forging peer slipped a
            # structurally-valid cert past us. The reply the client got
            # is still backed by a verified prepare quorum / matching
            # f+1 replies client-side, but stop trusting structure alone
            # until the view changes away from whoever is forging
            self._opt_poisoned = True
            self.m_cert_async_fails.inc()
            log.error("deferred cert verify FAILED on optimistically "
                      "released slot %d (kind=%s) — optimistic plane "
                      "poisoned until next view change", msg.seq_num, kind)
        # certs parked while this job was in flight get their turn now
        # (one may be the genuine one if this verdict was a forgery's);
        # the first re-handled becomes the next in-flight job, the rest
        # re-park into their per-sender slots
        if info is not None:
            parked = [(k, pmsg) for (k, _), pmsg in
                      list(info.cert_pending.items()) if k == kind]
            for key in [key for key in info.cert_pending if key[0] == kind]:
                del info.cert_pending[key]
            for k, pmsg in parked:
                if info.committed or (k == "prepare" and info.prepared):
                    break
                self._handle_full_cert(pmsg, k)

    def _accept_cert(self, msg, kind: str) -> None:
        if kind == "prepare":
            self._accept_prepare_full(msg)
        elif kind == "commit":
            self._accept_commit_full(msg)
        else:
            self._accept_full_commit_proof(msg)

    def _drain_early_certs(self, info: SeqNumInfo) -> None:
        certs, info.early_certs = info.early_certs, {}
        for (kind, _sender), msg in certs.items():
            self._handle_full_cert(msg, kind)

    def _on_prepare_full(self, msg: m.PrepareFullMsg) -> None:
        self._handle_full_cert(msg, "prepare")

    def _accept_prepare_full(self, msg: m.PrepareFullMsg) -> None:
        info = self.window.get(msg.seq_num)
        if info.prepared:
            return
        flight.record(flight.EV_PREPARED, seq=msg.seq_num, view=msg.view)
        info.prepare_full = msg
        info.prepared = True
        with self._tran() as st:
            st.seq(msg.seq_num).prepare_full = msg.pack()
        self._send_commit_partial(info)
        # speculation normally started at PP acceptance;
        # this re-pump catches slots that could not speculate then
        # (e.g. ordered behind a barrier batch that has since drained)
        self._pump_speculation()

    def _on_commit_full(self, msg: m.CommitFullMsg) -> None:
        self._handle_full_cert(msg, "commit")

    def _note_cert_verified(self, info: SeqNumInfo) -> None:
        """Async-certificate bookkeeping (optimistic mode): the slot's
        commit certificate finished its deferred pairing verify. Records
        how long the certificate trailed the optimistic release and
        advances the verified frontier that clamps the persisted
        last_executed watermark (min of two monotone counters)."""
        if not self._opt_replies:
            return
        if info.opt_committed:
            lag_us = max(
                0, (time.monotonic_ns() - info.opt_committed_ns) // 1000)
            flight.record(flight.EV_CERT_ASYNC_DONE, seq=info.seq_num,
                          view=self.view)
            flight.record(flight.EV_CERT_ASYNC_LAG, seq=info.seq_num,
                          view=self.view, arg=lag_us)
        # contiguous walk: committed ⇒ verified (commits only flip via
        # _accept_cert after the verify verdict / stable checkpoint)
        v = max(self._verified_upto, self.last_stable)
        while True:
            nxt = self.window.peek(v + 1)
            if nxt is None or not nxt.committed:
                break
            v += 1
        self._verified_upto = v

    def _accept_commit_full(self, msg: m.CommitFullMsg) -> None:
        info = self.window.get(msg.seq_num)
        if info.committed:
            return
        flight.record(flight.EV_COMMITTED, seq=msg.seq_num,
                      view=msg.view, arg=0)
        info.commit_full = msg
        info.committed = True
        self.m_slow_commits.inc()
        self._note_cert_verified(info)
        if self.is_primary and info.pre_prepare is not None:
            if info.pre_prepare.first_path != int(m.CommitPath.SLOW):
                self.controller.on_slow_fallback(msg.seq_num)
            else:
                self.controller.on_slow_path_commit(msg.seq_num)
        with self._tran() as st:
            st.seq(msg.seq_num).commit_full = msg.pack()
        self._execute_committed()

    # ------------------------------------------------------------------
    # fast path: full proof + demotion (ReplicaImp.cpp:1468,1284)
    # ------------------------------------------------------------------
    def _on_full_commit_proof(self, msg: m.FullCommitProofMsg) -> None:
        self._handle_full_cert(msg, "fast")

    def _accept_full_commit_proof(self, msg: m.FullCommitProofMsg) -> None:
        info = self.window.get(msg.seq_num)
        if info.committed:
            return
        flight.record(flight.EV_COMMITTED, seq=msg.seq_num,
                      view=msg.view, arg=1)
        info.full_commit_proof = msg
        info.committed = True
        self.m_fast_commits.inc()
        self._note_cert_verified(info)
        if self.is_primary:
            self.controller.on_fast_path_commit(msg.seq_num)
        with self._tran() as st:
            st.seq(msg.seq_num).full_commit_proof = msg.pack()
        self._execute_committed()

    def _check_fast_path_timeouts(self) -> None:
        """Primary: demote stuck fast-path seqnums to the slow path
        (reference's controller timeout → StartSlowCommitMsg)."""
        if not self.is_primary:
            return
        now = time.monotonic()
        timeout_s = self.cfg.fast_path_timeout_ms / 1e3
        for seq, info in list(self.window.items()):
            if (info.pre_prepare is not None and not info.committed
                    and not info.slow_started
                    and info.pre_prepare.first_path != int(m.CommitPath.SLOW)
                    and now - info.received_at > timeout_s):
                ssc = m.StartSlowCommitMsg(sender_id=self.id, view=self.view,
                                           seq_num=seq, epoch=self.epoch)
                self._broadcast(ssc)
                self._start_slow_path(info)

    def _on_start_slow_commit(self, msg: m.StartSlowCommitMsg) -> None:
        if msg.view != self.view or msg.sender_id != self.primary:
            return
        if not self.window.in_window(msg.seq_num):
            return
        info = self.window.peek(msg.seq_num)
        if info is None or info.pre_prepare is None:
            return
        self._start_slow_path(info)

    def _start_slow_path(self, info: SeqNumInfo) -> None:
        if info.slow_started or info.committed:
            return
        info.slow_started = True
        self.m_slow_starts.inc()
        with self._tran() as st:
            st.seq(info.seq_num).slow_started = True
        self._send_prepare_partial(info)

    # ------------------------------------------------------------------
    # execution (ReplicaImp.cpp:5720,5364 + the execution lane)
    # ------------------------------------------------------------------
    def _execute_committed(self) -> None:
        """Committed slots became executable. With the execution lane the
        dispatcher only ENQUEUES them (execution + the coalesced commit
        happen on the lane thread); the legacy inline path runs when the
        lane is off — and during __init__'s restore replay, which happens
        before any thread besides the caller exists."""
        if self.exec_lane is not None and self._running:
            self._pump_execution_lane()
        else:
            self._execute_committed_inline()

    def _execute_committed_inline(self) -> None:
        while True:
            nxt = self.last_executed + 1
            if not self.window.in_window(nxt):
                return
            if self.control.blocks_ordering(nxt):
                # wedged: execution halts at the agreed cut; announce
                # readiness for the operator's restart proof
                self._maybe_announce_restart_ready()
                return
            info = self.window.peek(nxt)
            if info is None or not info.committed or info.executed:
                return
            self._execute_one_slot(nxt, info)

    def _execute_one_slot(self, nxt: int, info: SeqNumInfo) -> None:
        """Inline per-slot execution + apply (the pre-lane path, kept for
        execution_lane=off, restore replay, and lane barrier batches —
        INTERNAL/RECONFIG requests mutate dispatcher-owned subsystems)."""
        for req in info.pre_prepare.client_requests():
            # at-most-once: a request already executed for this client
            # must not re-execute (replay inside a later batch). This
            # is a membership test — requests execute out of seq order,
            # so a lower seqnum is not evidence of a replay.
            if self.clients.was_executed(req.sender_id, req.req_seq_num):
                cached = self.clients.cached_reply(req.sender_id,
                                                   req.req_seq_num)
                if cached is not None:
                    self.comm.send(req.sender_id, cached.pack())
                continue
            if self._slowdown.enabled:
                self._slowdown.delay(PHASE_EXECUTE)
            reply = self._execute_request(req, nxt)
            self.m_executed.inc()
            self._send_reply(req.sender_id, req.req_seq_num, reply)
        if self.cfg.time_service_enabled and info.pre_prepare.time:
            self.time_service.on_executed(info.pre_prepare.time)
        info.executed = True
        info.exec_submitted = False
        if getattr(info, "span", None) is not None:
            info.span.set_tag("committed_path", info.commit_path)
            info.span.finish()
            info.span = None
        self.last_executed = nxt
        self._exec_enqueued = max(self._exec_enqueued, nxt)
        self.m_last_executed.set(nxt)
        self._note_progress()
        with self._tran() as st:
            st.last_executed_seq = nxt
        # inline path: apply and reply complete together on the
        # dispatcher — both slot-stage anchors land here
        flight.record(flight.EV_EXEC_APPLY, seq=nxt, arg=1)
        flight.record(flight.EV_REPLY, seq=nxt)
        if nxt % self.cfg.checkpoint_window_size == 0:
            self._send_checkpoint(nxt)
        # a slot just left the pipeline: the primary proposes the
        # batch that accumulated behind the concurrency gate NOW
        # rather than waiting for the next flush-timer tick
        self._try_send_pre_prepare()

    def _execute_request(self, req: m.ClientRequestMsg, seq: int) -> bytes:
        """One ordered request against the state machine. Runs on the
        dispatcher (inline path, barrier batches) or the execution lane
        (plain + pre-processed requests — the handler is the only state
        those branches touch)."""
        if req.flags & m.RequestFlag.INTERNAL:
            return self._execute_internal_request(req, seq)
        if req.flags & m.RequestFlag.RECONFIG:
            return (self.reconfig.execute(self, req, seq)
                    if self.reconfig is not None else b"")
        if req.flags & m.RequestFlag.HAS_PRE_PROCESSED:
            from tpubft_torch.preprocessor.preprocessor import (
                unpack_preprocessed)
            try:
                orig, result = unpack_preprocessed(req.request)
            except Exception:  # noqa: BLE001 — malformed wrapper
                return b""
            # conflict detection at commit (reference verifyWriteCommand
            # at execution): re-validate the pre-executed result's
            # read-set version watermark against CURRENT state — the
            # speculation ran against an older snapshot. On conflict the
            # request falls back to NORMAL ORDERING: the original
            # request executes in this same committed slot (identical
            # total-order position, so ledgers stay byte-identical with
            # a pure-ordering run), and the flight event + counter make
            # the conflict rate observable for tuning.
            try:
                conflicted = self.handler.pre_exec_conflicted(
                    orig.sender_id, orig.req_seq_num, orig.request,
                    result)
            except Exception:  # noqa: BLE001 — advisory check only
                conflicted = False
            if conflicted:
                flight.record(flight.EV_PREEXEC_CONFLICT, seq=seq)
                self.m_preexec_conflicts.inc()
                return self.handler.execute(
                    orig.sender_id, orig.req_seq_num, orig.flags,
                    orig.request)
            self.m_preexec_applied.inc()
            return self.handler.apply_pre_executed(
                orig.sender_id, orig.req_seq_num, orig.flags,
                orig.request, result)
        with TimeRecorder(self._h_execute):
            return self.handler.execute(req.sender_id, req.req_seq_num,
                                        req.flags, req.request)

    # ---- execution lane plumbing (dispatcher side) ----
    @staticmethod
    def _batch_needs_dispatcher(pp: m.PrePrepareMsg) -> bool:
        """Barrier batches: INTERNAL (key exchange, cron) and RECONFIG
        (wedge, prune, epoch) requests mutate dispatcher-owned subsystems
        and must execute inline — the lane drains first so seq order is
        preserved around them."""
        try:
            reqs = pp.client_requests()
        except m.MsgError:           # parsed at acceptance; defensive
            return True
        return any(r.flags & (m.RequestFlag.INTERNAL
                              | m.RequestFlag.RECONFIG) for r in reqs)

    def _pump_execution_lane(self) -> None:
        """Hand every next consecutive committed slot to the lane (or
        execute barrier batches inline after draining it). Speculatively
        submitted slots whose commit just landed are CONFIRMED instead
        of resubmitted — the lane seals their already-executed run."""
        # phase 0: confirm commits for speculative submissions, strictly
        # in seq order (the lane's seal requires the whole run)
        while self._spec_inflight:
            nxt = self._spec_inflight[0]
            info = self.window.peek(nxt)
            if info is None or info.pre_prepare is None:
                # the slot vanished without a view-change abort —
                # defensive: discard the speculation and fall through to
                # the committed path
                self._abort_speculation("window-moved")
                break
            if not info.committed \
                    and not (self._opt_replies and info.opt_committed):
                break
            if self.exec_lane.confirm(nxt, info.pre_prepare.digest()):
                self._spec_inflight.pop(0)
                info.spec_submitted = False
                info.exec_submitted = True    # now normal lane work
            else:
                # speculated digest is not the committed one (or the
                # lane lost the slot): discard everything speculative;
                # the loop below resubmits the committed slots in order
                self._abort_speculation("digest-mismatch")
                break
        while True:
            nxt = max(self._exec_enqueued, self.last_executed) + 1
            if not self.window.in_window(nxt):
                break
            if self.control.blocks_ordering(nxt):
                # wedged: the announcement fires once the lane's applied
                # runs bring last_executed to the stop point (the applier
                # re-checks); calling here covers the already-drained case
                self._maybe_announce_restart_ready()
                break
            info = self.window.peek(nxt)
            if info is None or info.executed \
                    or info.exec_submitted or info.spec_submitted:
                break
            if not info.committed \
                    and not (self._opt_replies and info.opt_committed):
                break
            if self._batch_needs_dispatcher(info.pre_prepare):
                # barrier batches (INTERNAL/RECONFIG) mutate
                # dispatcher-owned subsystems irreversibly: they wait
                # for the VERIFIED commit even under optimistic replies
                if not info.committed:
                    break
                if self._spec_inflight:
                    # speculative slots ahead of the barrier are still
                    # awaiting their commits: the barrier cannot run yet
                    # anyway (last_executed lags) — draining now would
                    # only waste their speculation
                    break
                if not self._drain_exec_lane():
                    break               # lane stuck; retried on next event
                if self.last_executed != nxt - 1:
                    break               # world moved during the drain
                self._execute_one_slot(nxt, info)
                continue
            info.exec_submitted = True
            flight.record(flight.EV_EXEC_ENQ, seq=nxt, view=self.view)
            try:
                self.exec_lane.submit(nxt, info.pre_prepare)
            except BaseException:
                # a failed handoff must not strand the slot as
                # "submitted": clear the guard so the next commit event
                # (or timer) retries it
                info.exec_submitted = False
                raise
            self._exec_enqueued = nxt
        # newly-consecutive prepared/accepted slots may speculate now
        self._pump_speculation()

    def _pump_speculation(self) -> None:
        """Hand every next consecutive NOT-yet-committed slot to the
        lane as SPECULATIVE at PrePrepare ACCEPTANCE — on every path
        (previously the slow path waited for its
        prepare-quorum). The overlay now covers the whole
        prepare+commit window; abort safety is unchanged (the overlay
        is never durable and the seal still requires the committed
        digest to confirm). Replies and last_executed stay strictly
        post-commit — post-release under optimistic replies, where the
        structural cert + verified prepare quorum stand in. Barrier
        batches (INTERNAL/RECONFIG) never speculate."""
        if not self._spec_enabled or self.exec_lane is None \
                or not self._running or self.in_view_change:
            return
        if self.state_transfer is not None \
                and self.state_transfer.is_fetching:
            # Port divergence (reference replica.py:2710-2712): no new
            # speculation while a transfer is in progress; its link
            # would defer behind the accumulation (_start_state_transfer)
            return
        while True:
            nxt = max(self._exec_enqueued, self.last_executed) + 1
            if not self.window.in_window(nxt) \
                    or self.control.blocks_ordering(nxt):
                return
            info = self.window.peek(nxt)
            if info is None or info.pre_prepare is None or info.executed \
                    or info.committed or info.exec_submitted \
                    or info.spec_submitted:
                return
            pp = info.pre_prepare
            if not info.prepared \
                    and pp.first_path == int(m.CommitPath.SLOW):
                return              # slow path: wait for prepare-quorum
            if self._batch_needs_dispatcher(pp):
                return
            info.spec_submitted = True
            flight.record(flight.EV_SPEC_ENQ, seq=nxt, view=self.view)
            try:
                self.exec_lane.submit(nxt, pp, speculative=True)
            except BaseException:
                info.spec_submitted = False
                raise
            self._spec_inflight.append(nxt)
            self._exec_enqueued = nxt

    def _abort_speculation(self, cause: str) -> None:
        """Discard all speculative work (dispatcher thread): the lane
        aborts its open overlay, pending speculative entries (and any
        committed entries queued BEHIND them — order must hold) come
        back, and the submission bookkeeping rolls back so the normal
        committed path re-executes each slot from its committed
        PrePrepare once the certificate is in hand."""
        if self.exec_lane is None:
            return
        if not self._spec_inflight and not self.exec_lane.speculating:
            return
        removed = set(self.exec_lane.abort_speculation())
        removed.update(self._spec_inflight)
        self._spec_inflight = []
        if not removed:
            return
        self.m_exec_spec_aborts.inc()
        log.info("speculation aborted (%s): slots %s re-execute from "
                 "their committed bodies", cause, sorted(removed))
        for seq in sorted(removed):
            flight.record(flight.EV_SPEC_ABORT, seq=seq)
            info = self.window.peek(seq)
            if info is not None and not info.executed:
                info.exec_submitted = False
                info.spec_submitted = False
        self._exec_enqueued = min(self._exec_enqueued, min(removed) - 1)

    def _drain_exec_lane(self, timeout: Optional[float] = None) -> bool:
        """Dispatcher-side barrier: wait until the lane applied every
        submitted slot, then integrate the completed runs NOW (the
        level-triggered wakeup may still be queued behind us). Used
        before view-change send, view entry, state-transfer adoption,
        wedge/barrier execution. The default budget is
        ReplicaConfig.execution_drain_timeout_ms — the same threshold
        the health watchdog holds the lane's progress to, so a drain
        that would time out is independently reported as a stall."""
        if self.exec_lane is None:
            return True
        # speculative work cannot drain (it waits on commit certificates
        # only this thread can confirm, and the barrier callers are
        # about to invalidate it anyway): abort it first — the slots
        # re-execute from their committed bodies through the normal path
        self._abort_speculation("drain")
        if timeout is None:
            timeout = self.cfg.execution_drain_timeout_ms / 1e3
        deadline = time.monotonic() + timeout
        ok = self.exec_lane.drain(timeout)
        if not ok:
            log.warning("execution lane failed to drain in %.0fs "
                        "(depth=%d)", timeout, self.exec_lane.depth)
        if ok and self.durability is not None:
            # the lane drained = every run SEALED; the barrier callers
            # need them DURABLE and integrated (last_executed current,
            # pending overlay empty) before wiping the window / writing
            # the ledger directly — flush-and-wait the group pipeline
            # on the REMAINING budget (one barrier, one deadline)
            remaining = max(0.05, deadline - time.monotonic())
            ok = self.durability.drain(remaining)
            if not ok:
                log.warning("durability pipeline failed to drain in "
                            "%.1fs (lag=%d)", remaining,
                            self.durability.lag)
        # apply WITHOUT the trailing re-pump: refilling the lane here
        # would defeat the barrier (the caller is about to wipe the
        # window / adopt transferred state); newly-unblocked slots are
        # picked up by the next commit/apply event
        self._apply_exec_runs(repump=False)
        return ok and self.exec_lane.idle() \
            and (self.durability is None or self.durability.idle())

    def record_exec_run(self, run_len: int, commit_ms: float) -> None:
        """Lane-thread metrics hook (Counter/Gauge/histograms are
        thread-safe): one completed run of `run_len` slots whose
        coalesced durable apply took `commit_ms`."""
        self.m_exec_runs.inc()
        self.m_exec_run_slots.inc(run_len)
        self._h_exec_run_len.record(run_len)
        self._h_exec_commit_ms.record(commit_ms)

    def record_spec_seal(self, run_len: int, overlap_ms: float) -> None:
        """Lane-thread metrics hook: one SPECULATIVE run of `run_len`
        slots sealed at commit after overlapping `overlap_ms` of its
        threshold-combine window with execution."""
        self.m_exec_spec_runs.inc()
        self.m_exec_spec_overlap.set(int(overlap_ms))
        self._h_spec_overlap.record(overlap_ms)

    def _apply_exec_runs(self, _payload=None, repump: bool = True) -> None:
        """Integrate durably-applied runs (dispatcher thread): advance
        last_executed (only now — after the durable apply), persist the
        watermark, send the run's replies (riding the transport batcher
        via the dispatcher post-hook), finish spans, fire checkpoints
        computed at the run boundary, and re-arm the proposal pipeline."""
        if self.exec_lane is None:
            return
        runs = self.exec_lane.pop_completed()
        if not runs:
            return
        for run in runs:
            for seq in range(run.first, run.last + 1):
                info = self.window.peek(seq)
                if info is None:
                    continue
                info.executed = True
                info.exec_submitted = False
                info.spec_submitted = False
                if getattr(info, "span", None) is not None:
                    info.span.set_tag("committed_path", info.commit_path)
                    info.span.finish()
                    info.span = None
            for key in run.reply_keys:
                self._forwarded.pop(key, None)
            # replies already on the wire when the durability pipeline
            # released them as the group-boundary burst —
            # sending again here would duplicate every reply datagram
            if not getattr(run, "replies_sent", False):
                for client, raw in run.replies:
                    self.comm.send(client, raw)
            self.m_executed.inc(run.n_requests)
            if run.last > self.last_executed:
                self.last_executed = run.last
                self.m_last_executed.set(run.last)
            self._note_progress()
            # slot integrated + replies on the wire: the `reply` stage
            # ends here (the lane recorded EV_EXEC_APPLY at its apply/
            # seal; with the durability pipeline the group-fsync wait
            # shows up in this stage), finalizing each slot's record
            for seq in range(run.first, run.last + 1):
                flight.record(flight.EV_REPLY, seq=seq)
            if run.checkpoint is not None:
                seq, state_digest, pages_digest, height = run.checkpoint
                self._send_checkpoint(seq, state_digest=state_digest,
                                      pages_digest=pages_digest,
                                      block_id=height)
        # ONE metadata watermark persist per integration event — the
        # synchronous consensus-metadata fsync (the carve-out) now
        # covers every run the event delivered instead of paying the
        # disk once per run; with the durability pipeline the runs
        # integrate in group-sized batches, so the dispatcher's fsync
        # rate drops by the group factor too
        with self._tran() as st:
            if self._opt_replies:
                # optimistic mode: never persist past the verified-commit
                # frontier — a restart must not resume from a watermark
                # supported only by structurally-accepted (unverified)
                # certificates. Re-executing the durable-but-unpersisted
                # tail is replay-safe: the reply ring's at-most-once
                # dedup skips it (min of two monotones stays monotone)
                self._verified_upto = max(self._verified_upto,
                                          self.last_stable)
                st.last_executed_seq = min(self.last_executed,
                                           self._verified_upto)
            else:
                st.last_executed_seq = self.last_executed
        crashpoint("meta.watermark", rid=self.id)
        self._maybe_announce_restart_ready()
        self._try_send_pre_prepare()
        if repump:
            # a barrier batch may have been waiting behind these runs
            self._pump_execution_lane()

    def _execute_internal_request(self, req: m.ClientRequestMsg,
                                  seq: int = 0) -> bytes:
        """Ordered consensus-internal operation (key exchange, cron tick)
        — executed identically on every replica."""
        from tpubft_torch.consensus import internal as iops
        try:
            op = iops.unpack_op(req.request)
        except Exception:
            return b""
        if isinstance(op, iops.KeyExchangeOp):
            # only the replica owning the internal client may rotate its key
            if self.info.internal_client_of(op.replica_id) == req.sender_id:
                self.key_exchange.on_executed(op, seq)
                return b"ok"
            return b""
        if isinstance(op, iops.TickOp):
            self.cron_table.on_tick(op)
            return b"ok"
        return b""

    def _build_reply(self, client: int, req_seq: int, payload: bytes,
                     pages_batch=None, defer_sign: bool = False):
        """Build an executed request's reply + stage its persisted
        canonical form. Returns (reply_msg, wire_bytes_or_None) — the
        caller records it in the ClientsManager (immediately on the
        inline path; AFTER the durable commit on the execution lane, so
        an aborted run can retry without the at-most-once state claiming
        its requests already executed). `pages_batch` stages the page
        write into a caller-owned WriteBatch (the lane's
        one-batch-per-run path) instead of a direct put.

        The reply RING is the single canonical persisted location — one
        slot per req_seq mod window, so every element of a recently
        executed batch stays regenerable across crash/ST, and the
        restore watermark is the ring's newest seq. (An earlier layout
        ALSO wrote each reply to the per-client "clients" page; that
        write was fully shadowed by the ring — same canonical bytes,
        newest-seq watermark derivable from the ring — so it is gone:
        one page write per request instead of two, digest-deterministic
        across replicas because every replica runs the same rule.) The
        "clients" page now carries only the oversize-reply marker, the
        one record the bounded ring cannot hold."""
        reply = m.ClientReplyMsg(sender_id=self.id, req_seq_num=req_seq,
                                 current_primary=self.primary, reply=payload,
                                 replica_specific_info=b"")
        if self._opt_replies and not defer_sign:
            # optimistic replies: the client can no longer lean on the
            # certificate, so each replica vouches individually — f+1
            # MATCHING SIGNED replies is the client's acceptance rule.
            # sign() is thread-safe (pure signer + counter), so the
            # execution lane may call this off the dispatcher. With
            # `defer_sign` (execution lane + durability pipeline) the
            # signature is batched per sealed GROUP on the io thread
            # instead — the reply cannot leave before the group fsync,
            # so deferring to that boundary is free; external replies
            # then return wire=None and ride CompletedRun.unsigned
            reply.signature = self.sig.sign(reply.signed_payload())
        # at-most-once state rides reserved pages so it survives crashes
        # AND state transfer (reference keeps client replies in res pages).
        # Persist a CANONICAL form — per-replica fields (sender, primary)
        # zeroed — or the pages digest would differ across replicas and no
        # checkpoint certificate could ever form.
        canonical = b"\x00" + m.ClientReplyMsg(
            sender_id=0, req_seq_num=req_seq, current_primary=0,
            reply=payload, replica_specific_info=b"").pack()
        from tpubft_torch.consensus.reserved_pages import PAGE_SIZE

        def save(category: str, index: int, data: bytes) -> None:
            if pages_batch is not None:
                self.res_pages.stage_save(pages_batch, category, index,
                                          data)
            else:
                self.res_pages.save(category, index, data)

        if len(canonical) > PAGE_SIZE:
            # reply too big for its page: keep the at-most-once marker so
            # a crash/ST never re-executes, even though the cached reply
            # is lost (the client re-reads; reference paginates large
            # replies)
            save("clients", client, b"\x01" + req_seq.to_bytes(8, "big"))
        else:
            from tpubft_torch.consensus.clients_manager import \
                REPLY_CACHE_PER_CLIENT as _RING
            save("clientreplies", client * _RING + req_seq % _RING,
                 canonical)
        if self.info.is_internal_client(client) \
                or (defer_sign and self._opt_replies):
            # internal replies are consumed in-process (never packed);
            # deferred external replies pack AFTER the group sign
            return reply, None
        return reply, reply.pack()

    def _send_reply(self, client: int, req_seq: int, payload: bytes) -> None:
        """Inline-path reply (dispatcher thread): record + send now."""
        reply, wire = self._build_reply(client, req_seq, payload)
        self.clients.on_request_executed(client, req_seq, reply)
        self._forwarded.pop((client, req_seq), None)
        if wire is not None:
            self.comm.send(client, wire)

    # ------------------------------------------------------------------
    # status beacons + gap retransmission (reference ReplicaStatusMsg +
    # RetransmissionsManager / ReqMissingData duties)
    # ------------------------------------------------------------------
    def _send_status(self) -> None:
        if not self._running:
            return
        self.m_dropped_external.set(self.incoming.dropped_external)
        if self.admission is not None:
            self.admission.adm_queue_depth.set(self.admission.depth)
        status = m.ReplicaStatusMsg(
            sender_id=self.id, view=self.view,
            last_stable_seq=self.last_stable,
            last_executed_seq=self.last_executed,
            in_view_change=self.in_view_change,
            capabilities=self._my_capabilities())
        self._broadcast(status)
        # restart votes are liveness-critical for the n/n proof: keep
        # re-announcing until the proof forms (peers may have been
        # lagging or lossy when the first broadcast went out)
        if self._my_restart_vote is not None \
                and not self.control.restart_proof \
                and self.control.wedge_point is not None:
            self._broadcast(self._my_restart_vote)

    MAX_GAP_RESEND = 8

    def _my_capabilities(self) -> int:
        """CAP_* bitmap this replica advertises on status beacons.
        Clients can already infer CAP_OPT_REPLIES from the wire (an
        optimistic reply carries a signature before the combine check
        lands); this makes the same fact peer-visible and auditable."""
        caps = 0
        if self._opt_replies:
            caps |= m.CAP_OPT_REPLIES
        if self.cfg.offload_enabled:
            caps |= m.CAP_OFFLOAD
        return caps

    def _on_replica_status(self, msg: m.ReplicaStatusMsg) -> None:
        """A peer is behind: push it what it's missing. Status is
        advisory/unsigned — worst case a spoofed one costs a bounded
        retransmission, never state."""
        peer = msg.sender_id
        if peer == self.id:
            return
        # record the peer's advertised capability bitmap (advisory,
        # like the rest of the beacon — mixed-cluster detection only)
        self.peer_capabilities[peer] = msg.capabilities
        # (a) peer in an older view: resend the proof of ours so it can
        # enter (NewViewMsg + the ViewChangeMsgs it references)
        if msg.view < self.view and self._entered_view_proof is not None:
            nv, vcs = self._entered_view_proof
            for vc in vcs:
                self.comm.send(peer, vc.pack())
            self.comm.send(peer, nv.pack())
            return
        if msg.view != self.view:
            return
        # (b) same view, peer's execution lags inside our window: resend
        # PrePrepare + commit certificate from persisted state
        if msg.last_executed_seq >= self.last_executed:
            return
        st = self.storage.load()
        first = msg.last_executed_seq + 1
        for seq in range(first, min(self.last_executed,
                                    first + self.MAX_GAP_RESEND - 1) + 1):
            entry = st.seq_states.get(seq)
            if entry is None or entry.pre_prepare is None:
                continue
            self.comm.send(peer, entry.pre_prepare)
            if entry.full_commit_proof is not None:
                self.comm.send(peer, entry.full_commit_proof)
            elif entry.commit_full is not None:
                if entry.prepare_full is not None:
                    self.comm.send(peer, entry.prepare_full)
                self.comm.send(peer, entry.commit_full)

    # ------------------------------------------------------------------
    # missing-data flow (reference ReqMissingDataMsg + tryToSendReqMissing)
    # ------------------------------------------------------------------
    def _check_missing_data(self) -> None:
        """Evidence without a PrePrepare (buffered shares/certs) that has
        aged past the retransmission horizon: explicitly ask for the PP —
        first the primary, then everyone (the primary may be the one
        withholding it)."""
        if not self._running or self.in_view_change:
            return
        now = time.monotonic()
        grace = self.cfg.retransmission_timer_ms * 8 / 1000.0
        for seq, info in list(self.window.items()):
            if info.pre_prepare is not None or info.pp_verifying is not None:
                self._missing_since.pop(seq, None)
                continue
            if not info.early_shares and not info.early_certs:
                continue
            if not info.first_evidence_at \
                    or now - info.first_evidence_at < grace:
                continue
            entry = self._missing_since.setdefault(seq, [0.0, 0])
            if entry[1] and now - entry[0] < grace:
                continue                      # asked recently: wait
            entry[0] = now
            entry[1] += 1
            req = m.ReqMissingDataMsg(sender_id=self.id, view=self.view,
                                      seq_num=seq, missing=1)
            log.info("requesting missing PrePrepare for seq %d "
                     "(attempt %d)", seq, entry[1])
            if entry[1] == 1:
                self.comm.send(self.primary, req.pack())
            else:
                self._broadcast(req)

    def _on_req_missing_data(self, sender: int,
                             msg: m.ReqMissingDataMsg) -> None:
        """Serve a peer's explicit gap request from live window state or
        persisted metadata (reference handleReqMissingDataMsg). Unsigned
        like status — a spoofed request costs a bounded resend."""
        if msg.view != self.view or sender == self.id:
            return
        info = self.window.peek(msg.seq_num)
        pieces = []
        if info is not None and info.pre_prepare is not None:
            if msg.missing & 1:
                pieces.append(info.pre_prepare.pack())
            if msg.missing & 2 and info.prepare_full is not None:
                pieces.append(info.prepare_full.pack())
            if msg.missing & 4 and info.commit_full is not None:
                pieces.append(info.commit_full.pack())
            if msg.missing & 8 and info.full_commit_proof is not None:
                pieces.append(info.full_commit_proof.pack())
        else:
            entry = self.storage.load().seq_states.get(msg.seq_num)
            if entry is not None:
                for want, raw in ((1, entry.pre_prepare),
                                  (2, entry.prepare_full),
                                  (4, entry.commit_full),
                                  (8, entry.full_commit_proof)):
                    if msg.missing & want and raw is not None:
                        pieces.append(raw)
        for raw in pieces:
            self.comm.send(sender, raw)

    # ------------------------------------------------------------------
    # restart-readiness at the wedge point (ReplicaRestartReadyMsg)
    # ------------------------------------------------------------------
    def _maybe_announce_restart_ready(self) -> None:
        """Wedged at the agreed stop point: broadcast a signed readiness
        vote; a 2f+c+1 certificate of these is the restart proof the
        operator's wrapper waits for (reference ReplicaRestartReadyMsg →
        ReplicasRestartReadyProofMsg flow)."""
        point = self.control.wedge_point
        if point is None or self._restart_announced == point \
                or self.last_executed < point:
            return
        self._restart_announced = point
        msg = m.ReplicaRestartReadyMsg(
            sender_id=self.id, seq_num=point,
            reason=0, signature=b"", epoch=self.epoch)
        msg.signature = self.sig.sign(msg.signed_payload())
        self._my_restart_vote = msg
        log.info("wedged at %d: announcing restart readiness", point)
        self._broadcast(msg)
        self._on_restart_ready(msg)

    def _on_restart_ready(self, msg: m.ReplicaRestartReadyMsg) -> None:
        """Collect signed readiness votes. Votes arriving BEFORE this
        replica reaches (or even learns of) the wedge point are buffered —
        a lagging replica must still be able to complete its proof later.
        Bounded: at most 4 candidate points, highest kept."""
        votes = self._restart_votes.get(msg.seq_num)
        if votes is None:
            if len(self._restart_votes) >= 4:
                lowest = min(self._restart_votes)
                if msg.seq_num <= lowest:
                    return
                del self._restart_votes[lowest]
            votes = self._restart_votes[msg.seq_num] = set()
        if msg.sender_id in votes:
            return
        if getattr(msg, "_adm_verified", None) is None \
                and not self._verify_replica_msg(msg, seq=msg.seq_num):
            return
        votes.add(msg.sender_id)
        # super-stable n/n proof (the reference's AddRemoveWithWedge
        # semantics): EVERY replica finished executing to the stop point,
        # so a restart loses no execution anywhere
        if (self.control.wedge_point == msg.seq_num
                and len(votes) >= self.info.n
                and not self.control.restart_proof):
            log.info("restart proof complete at wedge point %d "
                     "(%d/%d votes)", msg.seq_num, len(votes), self.info.n)
            self.control.restart_proof = True

    def unwedge(self) -> None:
        """Operator unwedge: clear control state AND the restart election
        (a later re-wedge — even at the same point — starts fresh)."""
        self.control.unwedge()
        self._restart_announced = None
        self._my_restart_vote = None
        self._restart_votes.clear()

    # ------------------------------------------------------------------
    # checkpointing (ReplicaImp.cpp:2280,3274,3439)
    # ------------------------------------------------------------------
    def _send_checkpoint(self, seq: int,
                         state_digest: Optional[bytes] = None,
                         pages_digest: Optional[bytes] = None,
                         block_id: Optional[int] = None) -> None:
        """Broadcast our checkpoint for `seq`. The digests may be passed
        in by the execution lane, which snapshots them AT the run
        boundary (before the next run mutates state) — computing them
        here would race the executor. The inline path computes them now
        (nothing executes concurrently there). `block_id` is the ledger
        height the state digest binds — remembered so the thin-replica
        anchor can resolve a certified digest to a servable block."""
        if state_digest is None:
            state_digest = self.handler.state_digest()
            bc = getattr(self.handler, "blockchain", None)
            if bc is not None and block_id is None:
                block_id = bc.last_block_id   # inline path: same thread
            if self.state_transfer is not None:
                # snapshot NOW — this is the state the cert will bind
                self.state_transfer.on_checkpoint_created(seq, state_digest)
        if pages_digest is None:
            pages_digest = self.res_pages.digest()
        if block_id is not None:
            self._ckpt_blocks[state_digest] = block_id
            while len(self._ckpt_blocks) > 8:
                del self._ckpt_blocks[next(iter(self._ckpt_blocks))]
        ck = m.CheckpointMsg(sender_id=self.id, seq_num=seq,
                             state_digest=state_digest,
                             is_stable=False, epoch=self.epoch,
                             res_pages_digest=pages_digest,
                             signature=b"")
        ck.signature = self.sig.sign(ck.signed_payload())
        self._broadcast(ck)
        # read-only replicas feed on checkpoint certificates too (their
        # state-transfer trust anchors — reference: RO replicas receive
        # the same CheckpointMsg traffic)
        raw = ck.pack()
        for ro in self.info.ro_replica_ids:
            self.comm.send(ro, raw)
        self._store_checkpoint(ck)

    def _broadcast_time_opinion(self) -> None:
        if not self._running:
            return
        op = m.TimeOpinionMsg(sender_id=self.id,
                              t_ms=int(time.time() * 1000),
                              signature=b"", epoch=self.epoch)
        op.signature = self.sig.sign(op.signed_payload())
        self._broadcast(op)

    def _on_time_opinion(self, sender: int, msg: m.TimeOpinionMsg) -> None:
        # transport binding: opinions are live clock readings, never
        # relayed on another's behalf — a peer re-broadcasting someone
        # else's (validly signed, old) opinion is exactly the replay
        # vector the monotonicity check in add_opinion also closes
        if not self.cfg.time_service_enabled \
                or msg.sender_id != sender \
                or not self.info.is_replica(msg.sender_id) \
                or msg.sender_id == self.id:
            return
        if getattr(msg, "_adm_verified", None) is None \
                and not self._verify_replica_msg(msg):
            return
        self.time_service.add_opinion(msg.sender_id, msg.t_ms)

    def _on_checkpoint(self, ck: m.CheckpointMsg) -> None:
        if not self.info.is_replica(ck.sender_id):
            return
        if ck.seq_num <= self.last_stable:
            return
        # only checkpoint-window multiples are real checkpoints (honest
        # replicas checkpoint exactly there); arbitrary seq_nums would let
        # one key mint unbounded distinct slots
        if ck.seq_num % self.cfg.checkpoint_window_size != 0:
            return
        # monotone per sender: we keep each replica's HIGHEST checkpoint
        # only, so total storage is bounded at n messages — no horizon
        # needed, and a replica arbitrarily far behind still learns about
        # far-future checkpoints (its state-transfer trigger)
        if ck.seq_num < self._ck_latest_seq.get(ck.sender_id, 0):
            return
        if getattr(ck, "_adm_verified", None) is None \
                and not self._verify_replica_msg(ck, seq=ck.seq_num):
            return
        self._store_checkpoint(ck)

    def _store_checkpoint(self, ck: m.CheckpointMsg) -> None:
        # evict the sender's previous (lower) checkpoint: one live slot
        # per sender bounds memory; honest replicas only move forward
        prev = self._ck_latest_seq.get(ck.sender_id)
        if prev is not None and prev != ck.seq_num:
            old_slot = self.checkpoints.get(prev)
            if old_slot is not None:
                old_slot.pop(ck.sender_id, None)
                if not old_slot:
                    self.checkpoints.pop(prev, None)
        self._ck_latest_seq[ck.sender_id] = ck.seq_num
        slot = self.checkpoints.setdefault(ck.seq_num, {})
        slot[ck.sender_id] = ck
        if ck.sender_id == self.id:
            # retained past stability GC: AskForCheckpoint answers with
            # this (reference checkpointsLog keeps the last stable's
            # selfCheckpointMsg)
            self._self_ck_latest = ck
        matching = sum(1 for other in slot.values()
                       if other.state_digest == ck.state_digest
                       and other.res_pages_digest == ck.res_pages_digest)
        # thin-replica anchor: f+1 matching SIGNED digests — at least
        # one honest replica vouches — and we know which ledger height
        # the digest binds (our own checkpoint at that state). Publish
        # the cert set for untrusted thin-replica clients to verify.
        if matching >= self.info.st_anchor_quorum \
                and self.thin_replica is not None:
            height = self._ckpt_blocks.get(ck.state_digest)
            if height is not None:
                certs = tuple(
                    other.pack() for other in slot.values()
                    if other.state_digest == ck.state_digest
                    and other.res_pages_digest == ck.res_pages_digest)
                self._publish_trs_anchor(ck.seq_num, height, certs)
        if matching >= self.info.st_anchor_quorum \
                and ck.seq_num > self.last_executed:
            # f+1 matching signed digests = at least one honest vouches:
            # a valid trust anchor state transfer may fetch toward (ST
            # sub-messages are unauthenticated; safety comes from the
            # digest chain ending at a certificate-backed digest)
            self.certified_checkpoints[ck.seq_num] = (ck.state_digest,
                                                      ck.res_pages_digest)
            if len(self.certified_checkpoints) > 32:
                del self.certified_checkpoints[
                    min(self.certified_checkpoints)]
            if (self.state_transfer is not None
                    and ck.seq_num >= self.last_executed
                    + self.cfg.work_window_size):
                # hopelessly behind: fetch state now (BCStateTran trigger,
                # reference startCollectingState on checkpoint beyond
                # window)
                log.info("lagging by >window (ckpt %d vs executed %d): "
                         "starting state transfer", ck.seq_num,
                         self.last_executed)
                self._start_state_transfer(ck.seq_num)
        # stability needs the full 2f+c+1 certificate (reference
        # CheckpointInfo.hpp): guarantees f+1 honest replicas hold this
        # checkpoint before we GC the window behind it
        if matching < self.info.checkpoint_quorum:
            return
        if ck.seq_num <= self.last_executed:
            self._on_seq_stable(ck.seq_num, ck.state_digest)

    def _on_seq_stable(self, seq: int,
                       state_digest: Optional[bytes] = None) -> None:
        """onSeqNumIsStable: slide the work window, GC old state."""
        if seq <= self.last_stable:
            return
        crashpoint("ckpt.stable", rid=self.id)
        log.debug("checkpoint stable at seq %d", seq)
        # checkpoint-era key expiry (reference CryptoManager per-era keys)
        self.sig.on_stable(seq)
        if self.retrans is not None:
            self.retrans.gc_stable(seq)
        for s in [s for s in self._missing_since if s <= seq]:
            del self._missing_since[s]
        if self.state_transfer is not None:
            self.state_transfer.on_checkpoint_stable(
                seq, state_digest if state_digest is not None
                else self.handler.state_digest())
        self.last_stable = seq
        self.m_last_stable.set(seq)
        self.window.advance(seq)
        for s in [s for s in self.checkpoints if s <= seq]:
            del self.checkpoints[s]
        for r in [r for r, s in self._ck_latest_seq.items() if s <= seq]:
            del self._ck_latest_seq[r]
        for s in [s for s in self.certified_checkpoints if s <= seq]:
            del self.certified_checkpoints[s]
        for key in [k for k in self.carried_certs if k[0] <= seq]:
            del self.carried_certs[key]
        for s in [s for s in self.restrictions if s <= seq]:
            del self.restrictions[s]
        # bodies are only needed while a cert references them
        live = {c.pp_digest for c in self.carried_certs.values()}
        for d in [d for d in self.vc_bodies if d not in live]:
            del self.vc_bodies[d]
        # a view entry parked on bodies for now-stable seqnums must not
        # wedge: those batches already executed cluster-wide (and peers
        # have pruned the bodies), so they need no re-proposal — drop them
        # and enter if nothing else is missing
        if self._pending_entry is not None:
            new_view, restrictions, missing = self._pending_entry
            stale = [s for s, r in restrictions.items()
                     if s <= seq and not r.resolved]
            for s in stale:
                missing.discard(restrictions[s].pp_digest)
                del restrictions[s]
            if stale and not missing:
                self._pending_entry = None
                self._enter_view(new_view, restrictions)
        with self._tran() as st:
            st.last_stable_seq = seq
            for s in [s for s in st.seq_states if s <= seq]:
                del st.seq_states[s]
            st.restrictions = [pack_restriction(r)
                               for r in self.restrictions.values()]
            st.carried_certs = [pack_cert(c)
                                for c in self.carried_certs.values()]
            st.carried_bodies = list(self.vc_bodies.values())

    # ------------------------------------------------------------------
    # view change (ReplicaImp.cpp:3771,544,2900,2978,3094 + ViewsManager)
    # ------------------------------------------------------------------
    def _verifier_for_cert_kind(self, kind: int):
        if kind in (CERT_PREPARE, CERT_COMMIT):
            return self.slow_verifier
        if kind == CERT_FAST_OPT:
            return self.opt_verifier
        if kind == CERT_FAST_THR:
            return self.thr_verifier
        return None

    def _check_view_change_timer(self) -> None:
        """Liveness watchdog: no progress while work is in flight, or a
        view change that never completes, triggers a complaint about the
        stuck view (reference viewChangeTimerMillisec → askToLeaveView)."""
        if not self._running:
            return
        now = time.monotonic()
        timeout = self.cfg.view_change_timer_ms / 1e3
        if self.in_view_change:
            if self._pending_entry is not None \
                    and now - self._vc_started_at > timeout / 4:
                # entry parked on missing bodies: re-fetch aggressively
                # (the escalation below still fires if nothing arrives)
                self._fetch_missing_bodies()
            if now - self._vc_started_at > timeout:
                self._vc_started_at = now
                # escalate AND retransmit: UDP may have dropped our
                # complaint or ViewChangeMsg; a one-shot broadcast could
                # wedge the cluster forever
                self._complain(self.pending_view or self.view, force=True)
                if self._my_vc_msg is not None \
                        and self._my_vc_msg.new_view == self.pending_view:
                    self._broadcast(self._my_vc_msg)
            return
        in_flight = any(info.pre_prepare is not None and not info.committed
                        for _, info in self.window.items())
        # forwarded-but-unexecuted client requests are work the primary owes
        # us; executed or abandoned entries are GC'd
        for key in [k for k, t in self._forwarded.items()
                    if self.clients.was_executed(k[0], k[1])
                    or now - t > 4 * timeout]:
            del self._forwarded[key]
        if in_flight or self.pending_requests or self._forwarded:
            if now - self._last_progress > \
                    timeout * self._no_progress_factor():
                self._complain(self.view)
        else:
            self._last_progress = now           # idle: reset the clock

    # the doubling stops at 2**3
    NO_PROGRESS_BACKOFF_MAX_EXP = 3

    def _no_progress_factor(self) -> float:
        """Factor on the no-progress timeout of the view we are in. 1
        once it has executed. Before that, 1 plus the slots its primary
        re-proposed over the checkpoint window (at most 2), doubled for
        each view entered before it since one executed (PBFT's backoff,
        Castro and Liskov, OSDI 1999, section 4.5.2; capped at
        2**NO_PROGRESS_BACKOFF_MAX_EXP). Port divergence (reference
        replica.py `_check_view_change_timer`, a fixed timeout): a new
        primary re-proposes every slot since the last stable checkpoint
        before the view can execute anything new, so with a fixed
        timeout a view entered late in a checkpoint window is deposed
        while it re-proposes, and so is the next one, which re-proposes
        the same slots: a cascade of views that order nothing (ROADMAP
        C.8, seen on the card under config 5's storm). Progress is
        still `last_executed` advancing; a view with nothing to
        re-propose after one that executed is given the timeout as
        before."""
        unproductive = self.view - self._progress_view
        if unproductive <= 0:
            return 1.0
        work = 1.0 + min(self._reproposed
                         / self.cfg.checkpoint_window_size, 1.0)
        return work * 2 ** min(unproductive - 1,
                               self.NO_PROGRESS_BACKOFF_MAX_EXP)

    def _note_progress(self) -> None:
        """last_executed advanced (or a transfer completed): restart the
        no-progress clock; the first time in a view, record the view's
        time from entry to its first execution."""
        now = time.monotonic()
        self._last_progress = now
        self._progress_view = self.view
        if self._view_entries:
            e = self._view_entries[-1]
            if e["view"] == self.view and e["first_exec_ms"] is None:
                e["first_exec_ms"] = round((now - e["t"]) * 1e3, 1)

    def _complain(self, view: int, reason: int = 0,
                  force: bool = False) -> None:
        """Broadcast a signed view-change complaint for `view` (complaints
        about the pending view escalate a failed view change). `force`
        retransmits an already-issued complaint."""
        first = view not in self._complained_views
        if not first and not force:
            return
        if first:
            log.warning("no progress: complaining about view %d "
                        "(primary=%d)", view, self.info.primary_of_view(view))
        self._complained_views.add(view)
        msg = m.ReplicaAsksToLeaveViewMsg(sender_id=self.id, view=view,
                                          reason=reason, signature=b"",
                                          epoch=self.epoch)
        msg.signature = self.sig.sign(msg.signed_payload())
        if first:
            self.vc.add_complaint(msg)
        self._broadcast(msg)
        if first:
            self._maybe_start_view_change()

    def _on_ask_to_leave_view(self, msg: m.ReplicaAsksToLeaveViewMsg) -> None:
        if not self.info.is_replica(msg.sender_id) or msg.view < self.view:
            return
        if getattr(msg, "_adm_verified", None) is None \
                and not self._verify_replica_msg(msg, view_scoped=True):
            return
        self.vc.add_complaint(msg)
        # adopt: quorum-minus-me complaints for a view I'm stuck in too
        self._maybe_start_view_change()

    def _maybe_start_view_change(self) -> None:
        for v in sorted(self.vc.complaints):
            if v >= self.view and self.vc.has_complaint_quorum(v):
                self._start_view_change(v + 1)

    def _start_view_change(self, target: int) -> None:
        if target <= self.view:
            return
        if self.in_view_change and self.pending_view is not None \
                and target <= self.pending_view:
            return
        # the execution lane drains BEFORE the view-change message is
        # built: last_executed must reflect every applied run, and the
        # window must not be harvested/wiped under a run in flight. A
        # stuck lane defers our participation — the view-change timer's
        # escalation path re-attempts (peers can proceed without us)
        if not self._drain_exec_lane():
            log.error("view change to %d deferred: execution lane did "
                      "not drain", target)
            return
        self.in_view_change = True
        self.pending_view = target
        self._pending_entry = None      # a parked entry for a lower view
                                        # is superseded by this change
        self._vc_started_at = time.monotonic()
        # harvest evidence: current window + evidence carried from earlier
        # views (a cert or signed report must survive cascading view
        # changes or a committed request could be lost)
        self._harvest_evidence()
        certs = sorted(self.carried_certs.values(),
                       key=lambda c: (c.seq_num, c.kind))
        vc = m.ViewChangeMsg(sender_id=self.id, new_view=target,
                             last_stable_seq=self.last_stable,
                             prepared=certs, signature=b"",
                             epoch=self.epoch)
        vc.signature = self.sig.sign(vc.signed_payload())
        self._my_vc_msg = vc
        self.vc.add_view_change(vc)
        with self._tran() as st:
            st.in_view_change = True
            st.pending_view = target
            st.carried_certs = [pack_cert(c) for c in certs]
            st.carried_bodies = list(self.vc_bodies.values())
        crashpoint("vc.persist", rid=self.id)
        self._broadcast(vc)
        self._try_complete_view_change(target)

    def _resume_view_change(self, _payload=None) -> None:
        """Crash recovery mid-view-change: in_view_change/pending_view
        were persisted (the vc.persist seam) but the change never
        completed. Rebuild the ViewChangeMsg from the persisted evidence
        and retransmit. The rebuild is deterministic over persisted state
        (carried_certs, last_stable), so peers that already hold our
        pre-crash message see an identical digest — a NewViewMsg formed
        from either copy resolves."""
        target = self.pending_view or 0
        if not self.in_view_change or target <= self.view:
            return
        if self._my_vc_msg is not None:
            return                        # already rebuilt/resumed
        self._vc_started_at = time.monotonic()
        certs = sorted(self.carried_certs.values(),
                       key=lambda c: (c.seq_num, c.kind))
        vc = m.ViewChangeMsg(sender_id=self.id, new_view=target,
                             last_stable_seq=self.last_stable,
                             prepared=certs, signature=b"",
                             epoch=self.epoch)
        vc.signature = self.sig.sign(vc.signed_payload())
        self._my_vc_msg = vc
        self.vc.add_view_change(vc)
        log.info("resuming view change to %d after restart "
                 "(%d carried certs)", target, len(certs))
        self._broadcast(vc)
        self._try_complete_view_change(target)

    def _harvest_evidence(self) -> None:
        """Merge the window's current certs/reports into carried_certs
        (keyed by (seq, is_signed_element); higher view wins); retain the
        batch bodies locally (certs are digest-only on the wire)."""
        certs, bodies = build_certificates(self.window.items(),
                                           self.last_stable,
                                           lambda pp: pp.first_path)
        self.vc_bodies.update(bodies)
        for c in certs:
            key = (c.seq_num, c.kind == CERT_SIGNED)
            cur = self.carried_certs.get(key)
            if cur is None or c.view > cur.view:
                self.carried_certs[key] = c

    def _on_view_change(self, msg: m.ViewChangeMsg) -> None:
        if not self.info.is_replica(msg.sender_id) \
                or msg.new_view <= self.view:
            return
        if getattr(msg, "_adm_verified", None) is None \
                and not self._verify_replica_msg(msg, view_scoped=True):
            return
        self.vc.add_view_change(msg)
        # f+1 replicas already moving to a higher view ⇒ join them
        # (reference computeCorrectRelevantViewNumbers)
        if self.vc.view_change_count(msg.new_view) \
                >= self.info.complaint_quorum:
            self._start_view_change(msg.new_view)
        self._try_complete_view_change(msg.new_view)

    def _try_complete_view_change(self, new_view: int) -> None:
        """New primary: form NewViewMsg once the quorum is in. Backup:
        enter once a pending NewViewMsg resolves."""
        if new_view <= self.view:
            return
        if self._pending_entry is not None \
                and self._pending_entry[0] == new_view:
            # entry already parked on body fetches: the restriction set is
            # FIXED (the primary must not re-form a different NewViewMsg
            # from late ViewChangeMsgs — backups matched the first one and
            # would diverge on the re-proposal set)
            return
        if self.info.primary_of_view(new_view) == self.id:
            if not self.vc.has_view_change_quorum(new_view):
                return
            quorum = self.vc.quorum_for_new_view(new_view)
            nv = m.NewViewMsg(
                sender_id=self.id, new_view=new_view, epoch=self.epoch,
                view_change_digests=[
                    m.ReplicaDigest(replica=vc.sender_id, digest=vc.digest())
                    for vc in quorum],
                signature=b"")
            nv.signature = self.sig.sign(nv.signed_payload())
            # rebroadcast the quorum's ViewChangeMsgs first so every backup
            # can resolve the NewView digests without a fetch round
            for vc in quorum:
                if vc.sender_id != self.id:
                    self._broadcast(vc)
            self._broadcast(nv)
            restrictions = compute_restrictions(
                quorum, self._share_digest, self._verifier_for_cert_kind,
                self.info.f + self.info.c + 1)
            self._entered_view_proof = (nv, list(quorum))
            self._resolve_and_enter(new_view, restrictions)
        else:
            nv = self.vc.pending_new_view
            if nv is None or nv.new_view != new_view:
                return
            matched = self.vc.match_new_view(nv)
            if matched is None:
                return                          # still missing VC msgs
            restrictions = compute_restrictions(
                matched, self._share_digest, self._verifier_for_cert_kind,
                self.info.f + self.info.c + 1)
            self._entered_view_proof = (nv, list(matched))
            self._resolve_and_enter(new_view, restrictions)

    # ------------------------------------------------------------------
    # restricted-batch body resolution (reference addPotentiallyMissingPP,
    # ReplicaImp.cpp:1078 — ViewChangeMsgs carry digests; bodies are
    # fetched before the view activates)
    # ------------------------------------------------------------------
    def _resolve_and_enter(self, new_view: int,
                           restrictions: Dict[int, Restriction]) -> None:
        """Fill each restriction's batch body from local evidence; if any
        is missing, park the entry and fetch (the view is entered when the
        last body arrives — reference ViewsManager obtainMissingInfo)."""
        # harvest first so our own window's PrePrepares can resolve
        self._harvest_evidence()
        missing = set()
        for r in restrictions.values():
            if r.resolved:
                continue
            body = self.vc_bodies.get(r.pp_digest)
            if body is None or not r.resolve(body):
                missing.add(r.pp_digest)
        if not missing:
            self._pending_entry = None
            self._enter_view(new_view, restrictions)
            return
        self._pending_entry = (new_view, restrictions, missing)
        log.info("view %d entry blocked on %d missing batch bodies — "
                 "fetching", new_view, len(missing))
        self._fetch_missing_bodies()

    def _fetch_missing_bodies(self) -> None:
        if self._pending_entry is None:
            return
        new_view, restrictions, missing = self._pending_entry
        by_digest = {r.pp_digest: r for r in restrictions.values()}
        for d in missing:
            r = by_digest[d]
            req = m.ReqViewPrePrepareMsg(sender_id=self.id,
                                         new_view=new_view,
                                         seq_num=r.seq_num, pp_digest=d)
            self._broadcast(req)

    def _on_req_view_pp(self, sender: int,
                        msg: m.ReqViewPrePrepareMsg) -> None:
        """Serve a peer's restricted-body fetch from harvested evidence or
        the live window. The response is the raw packed original
        PrePrepare — authenticated at the requester by digest."""
        body = self.vc_bodies.get(msg.pp_digest)
        if body is None:
            info = self.window.peek(msg.seq_num)
            if info is not None and info.pre_prepare is not None \
                    and info.pre_prepare.digest() == msg.pp_digest:
                body = info.pre_prepare.pack()
        if body is not None:
            self.comm.send(sender, body)

    def _try_resolve_body(self, pp: m.PrePrepareMsg) -> bool:
        """A PrePrepare arriving while entry is parked: if it is a body we
        are fetching, adopt it (digest check inside resolve) and enter the
        view once complete. Returns True iff consumed."""
        if self._pending_entry is None:
            return False
        new_view, restrictions, missing = self._pending_entry
        d = pp.digest()
        if d not in missing:
            return False
        r = next(x for x in restrictions.values() if x.pp_digest == d)
        if not r.resolve(pp.pack()):
            return False
        self.vc_bodies[d] = r.pre_prepare
        missing.discard(d)
        log.info("resolved restricted batch body for seq %d "
                 "(%d still missing)", r.seq_num, len(missing))
        if not missing:
            self._pending_entry = None
            self._enter_view(new_view, restrictions)
        return True

    def _on_new_view(self, msg: m.NewViewMsg) -> None:
        if msg.new_view <= self.view:
            return
        if msg.sender_id != self.info.primary_of_view(msg.new_view):
            return
        if getattr(msg, "_adm_verified", None) is None \
                and not self._verify_replica_msg(msg, view_scoped=True):
            return
        self.vc.pending_new_view = msg
        self._try_complete_view_change(msg.new_view)

    def _enter_view(self, new_view: int,
                    restrictions: Dict[int, Restriction]) -> None:
        """tryToEnterView: adopt the new view, wipe in-flight state, apply
        re-proposal restrictions; the new primary re-proposes."""
        if new_view <= self.view:
            return
        # a backup can enter a view it never complained about (NewViewMsg
        # arriving with the quorum's ViewChangeMsgs): the lane must be
        # empty before the window wipe below drops slots it references.
        # A stuck lane defers entry — peers' NewView/status retransmits
        # re-trigger it
        if not self._drain_exec_lane():
            log.error("entry into view %d deferred: execution lane did "
                      "not drain", new_view)
            return
        # evidence was harvested by _resolve_and_enter in this same view
        # change (ordering msgs are frozen, so the window cannot have
        # gained certs since) — carried_certs already holds the strongest
        # local certs before the window wipe below
        self.view = new_view
        self.in_view_change = False
        self.pending_view = None
        self._pending_entry = None
        # the forger (if any) that poisoned the optimistic plane is the
        # old view's problem; the new view starts trusting again
        self._opt_poisoned = False
        self.restrictions = restrictions
        self.m_view.set(new_view)
        log.info("entered view %d (primary=%d, %d restricted seqnums)",
                 new_view, self.primary, len(restrictions))
        if self.retrans is not None:
            # ordering messages of older views are dead letters
            self.retrans.clear_view(new_view)
        self._missing_since.clear()
        # purge complaints ABOUT the view we just entered too: complaint
        # quorums accumulated while the view change was forming must not
        # depose the fresh primary; if it really is unhealthy, complaints
        # re-accumulate via the escalation retransmit
        self.vc.gc_below(new_view + 1)
        # wipe all in-flight entries; consensus for uncommitted seqnums
        # restarts in the new view under the restrictions
        for seq, _ in list(self.window.items()):
            self.window.drop(seq)
        self.clients.clear_pending()
        self.pending_requests = []
        # reset liveness clocks: the new primary gets a full timeout before
        # anyone complains about the view we just entered
        now = time.monotonic()
        self._last_progress = now
        self._forwarded = {k: now for k in self._forwarded}
        self._reproposed = max(max(restrictions, default=self.last_stable)
                               - self.last_stable, 0)
        self._view_entries.append({
            "view": new_view, "reproposed": self._reproposed,
            "restricted": len(restrictions), "t": now,
            "first_exec_ms": None})
        with self._tran() as st:
            st.last_view = new_view
            st.in_view_change = False
            st.pending_view = 0
            st.seq_states.clear()
            st.restrictions = [pack_restriction(r)
                               for r in restrictions.values()]
            st.carried_certs = [pack_cert(c)
                                for c in self.carried_certs.values()]
            st.carried_bodies = list(self.vc_bodies.values())
        crashpoint("vc.enter", rid=self.id)
        if self.is_primary:
            self._repropose()

    # executed slots a new primary keeps re-proposed but uncommitted
    REPROPOSE_IN_FLIGHT = 8

    def _repropose(self) -> None:
        """New primary: re-issue PrePrepares for every restricted seqnum
        (same batch, slow path — safest after a view change) and fill gaps
        below the highest certified seqnum with empty batches.

        Port divergence (reference replica.py `_repropose`, every slot
        ascending from the stable checkpoint in one loop): the slots past
        this replica's last execution go out here, the ones it has
        executed (the highest first) from a dispatcher timer with at
        most REPROPOSE_IN_FLIGHT of them uncommitted (_pump_reproposals).
        In one loop, the first slots' prepare and commit rounds, and the
        new requests', waited at every replica behind up to a checkpoint
        window of PrePrepares that most replicas have executed, and the
        view was deposed before it executed anything new (ROADMAP C.8).
        The messages and the slots are the same."""
        base = self.last_stable
        max_cert = max(self.restrictions, default=base)
        self.primary_next_seq = max(max_cert, self.last_executed, base) + 1
        split = min(max(self.last_executed, base), max_cert)
        for seq in range(split + 1, max_cert + 1):
            self._repropose_seq(seq)
        # the highest first: a replica a few slots behind needs those
        self._reproposals = (self.view, list(range(split, base, -1)), [])
        self._pump_reproposals()

    def _pump_reproposals(self) -> None:
        """Dispatcher timer: re-propose this primary's next executed
        slots (_repropose) while fewer than REPROPOSE_IN_FLIGHT of those
        sent are uncommitted; the rest are dropped once the view is left,
        and each as it falls behind the stable checkpoint."""
        view, seqs, sent = self._reproposals
        if not seqs:
            return
        if view != self.view or self.in_view_change \
                or not self.is_primary:
            self._reproposals = (view, [], [])
            return
        sent = [q for q in sent if q > self.last_stable
                and not self.window.get(q).committed]
        room = self.REPROPOSE_IN_FLIGHT - len(sent)
        chunk = [q for q in seqs[:max(room, 0)]
                 if q > self.last_stable and self.window.in_window(q)]
        self._reproposals = (view, seqs[max(room, 0):], sent + chunk)
        for seq in chunk:
            self._repropose_seq(seq)

    def _repropose_seq(self, seq: int) -> None:
        existing = self.window.peek(seq)
        if existing is not None and existing.pre_prepare is not None:
            # already (re)proposed before a crash — rebroadcast the
            # SAME message; a fresh timestamp would change the digest
            # and strand backups' shares on the old one
            self._broadcast(existing.pre_prepare)
            return
        restr = self.restrictions.get(seq)
        if restr is not None:
            old = m.unpack(restr.pre_prepare)
            requests, pp_time = old.requests, old.time
        else:
            requests, pp_time = [], 0
        pp = m.PrePrepareMsg(
            sender_id=self.id, view=self.view, seq_num=seq,
            epoch=self.epoch,
            first_path=int(m.CommitPath.SLOW), time=pp_time,
            requests_digest=m.PrePrepareMsg.compute_requests_digest(
                requests),
            requests=requests, signature=b"")
        pp.signature = self.sig.sign(pp.signed_payload())
        self._broadcast(pp)
        self._accept_pre_prepare(pp)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _broadcast(self, msg) -> None:
        raw = msg.pack()
        for r in self.info.other_replicas(self.id):
            self.comm.send(r, raw)

    # ---- retransmission plumbing (RetransmissionsManager consumers) ----

    def _send_tracked(self, dest: int, msg) -> None:
        """Send + register for ack-tracked retransmission."""
        raw = msg.pack()
        self.comm.send(dest, raw)
        if self.retrans is not None and dest != self.id:
            self.retrans.track(dest, int(msg.CODE), msg.seq_num, self.view,
                               raw, time.monotonic())

    def _broadcast_tracked(self, msg) -> None:
        raw = msg.pack()
        now = time.monotonic()
        for r in self.info.other_replicas(self.id):
            self.comm.send(r, raw)
            if self.retrans is not None:
                self.retrans.track(r, int(msg.CODE), msg.seq_num, self.view,
                                   raw, now)

    def _ack(self, dest: int, code: int, seq: int) -> None:
        """Ack receipt of a retransmittable message (SimpleAckMsg)."""
        if self.retrans is None or dest == self.id:
            return
        self.comm.send(dest, m.SimpleAckMsg(
            sender_id=self.id, seq_num=seq, view=self.view,
            acked_msg_code=code, epoch=self.epoch).pack())

    def _tran(self):
        storage = self.storage

        class _Ctx:
            def __enter__(self_inner):
                return storage.begin_write_tran()

            def __exit__(self_inner, *exc):
                storage.end_write_tran()
                return False
        return _Ctx()

    def _restore_window(self, window_msgs: Dict[int, dict]) -> None:
        """Seed in-flight state from persisted metadata (ReplicaLoader)."""
        for seq, row in sorted(window_msgs.items()):
            if not self.window.in_window(seq):
                continue
            info = self.window.get(seq)
            pp = row.get("pre_prepare")
            if pp is not None and pp.view == self.view:
                info.pre_prepare = pp
                info.commit_path = pp.first_path
                info.received_at = time.monotonic()  # fresh fast-path clock
            pf = row.get("prepare_full")
            if pf is not None and info.pre_prepare is not None:
                info.prepare_full = pf
                info.prepared = True
            cf = row.get("commit_full")
            if cf is not None and info.pre_prepare is not None:
                info.commit_full = cf
                info.committed = True
            fcp = row.get("full_commit_proof")
            if fcp is not None and info.pre_prepare is not None:
                info.full_commit_proof = fcp
                info.committed = True
            info.slow_started = row.get("slow_started", False)
        # re-execute anything committed-but-unexecuted (recoverRequests)
        self._execute_committed()
