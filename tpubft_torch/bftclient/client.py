"""BFT client: signed requests + reply quorum matching.

Rebuild of the reference's bftclient
(concord-bft client/bftclient/include/bftclient/bft_client.h:36
Client::send; quorums.h:45-46 LinearizableQuorum = 2f+c+1,
ByzantineSafeQuorum = f+1; src/matcher.cpp Matcher): the client signs a
ClientRequestMsg, sends writes PRIMARY-FIRST (broadcasting to all
replicas on retry and for read-only requests), retransmits on a timer,
and returns once enough replies agree byte-for-byte (replica-specific
info excluded from matching, as in the reference's RSI handling). The
primary hint is a majority vote over each write's reply quorum.
"""
from __future__ import annotations

import enum
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from tpubft_torch.comm.interfaces import ICommunication, IReceiver
from tpubft_torch.consensus import messages as m
from tpubft_torch.consensus.keys import ClusterKeys
from tpubft_torch.consensus.replicas_info import ReplicasInfo
from tpubft_torch.utils.racecheck import make_lock


class Quorum(enum.Enum):
    LINEARIZABLE = "linearizable"       # 2f + c + 1
    BYZANTINE_SAFE = "byzantine_safe"   # f + 1
    ALL = "all"                         # n


@dataclass
class ClientConfig:
    client_id: int
    f_val: int = 1
    c_val: int = 0
    # adaptive retransmission: the FIRST retry fires after
    # retry_timeout_ms; subsequent retries back off with decorrelated
    # jitter (AWS-style: next = uniform(base, prev * 3), capped at
    # retry_max_ms), so an overloaded cluster sees a client's retry
    # pressure FALL over a request's lifetime instead of compounding at
    # a fixed cadence — and concurrent clients decorrelate instead of
    # retransmitting in lockstep. retry_max_ms <= retry_timeout_ms
    # degenerates to the old fixed cadence.
    retry_timeout_ms: int = 250
    retry_max_ms: int = 2000
    request_timeout_ms: int = 10000
    # optimistic-reply contract: a SIGNED reply is verified
    # against the sender's ed25519 key and dropped on mismatch, always.
    # With require_signed_replies the client additionally ignores
    # UNSIGNED replies — the strict mode for clusters known to run
    # optimistic_replies, where an unsigned reply can only come from a
    # replica that skipped the vouching step (or an impersonator)
    require_signed_replies: bool = False


def decorrelated_backoff(base_s: float, cap_s: float, prev_s: float,
                         rng: Optional[random.Random] = None) -> float:
    """Next retry delay: uniform(base, prev*3) capped — decorrelated
    jitter (pure helper; the client threads each call it with their own
    state, tests call it directly)."""
    r = (rng or random).uniform(base_s, max(base_s, prev_s * 3))
    return min(max(cap_s, base_s), r)


class TimeoutError_(Exception):
    pass


class BftClient(IReceiver):
    def __init__(self, cfg: ClientConfig, keys: ClusterKeys,
                 comm: ICommunication):
        self.cfg = cfg
        self.info = ReplicasInfo(n=3 * cfg.f_val + 2 * cfg.c_val + 1,
                                 f=cfg.f_val, c=cfg.c_val)
        self.keys = keys
        self.comm = comm
        self._signer = keys.my_signer()
        self._req_seq = int(time.time() * 1e6)  # monotonic across restarts
        self._lock = make_lock("bftclient")
        self._batch_lock = make_lock("bftclient.batch")  # one outstanding batch
        self._replies: Dict[int, Dict[int, m.ClientReplyMsg]] = {}
        self._done: Dict[int, threading.Event] = {}
        self._result: Dict[int, m.ClientReplyMsg] = {}
        self._quorum_needed: Dict[int, int] = {}
        self._primary_hint = 0      # learned from replies' current_primary
        self._started = False
        # per-replica reply verifiers, built lazily (optimistic replies:
        # f+1 MATCHING SIGNED replies is the acceptance rule — each
        # signature must check out before the reply may count)
        self._verifiers: Dict[int, object] = {}

    def start(self) -> None:
        if not self._started:
            self.comm.start(self)
            self._started = True

    def stop(self) -> None:
        self.comm.stop()
        self._started = False

    # ---- transport upcall ----
    def on_new_message(self, sender: int, data: bytes) -> None:
        try:
            msg = m.unpack(data)
        except m.MsgError:
            return
        if not isinstance(msg, m.ClientReplyMsg) or msg.sender_id != sender:
            return
        if msg.signature:
            # optimistic reply: no certificate backs it, the replica's
            # own signature does — verify before it may count toward
            # the matching quorum (a forged/garbled one is dropped,
            # never cached: the honest replica's real reply must not be
            # shadowed by a same-sender forgery)
            try:
                v = self._verifiers.get(sender)
                if v is None:
                    v = self._verifiers[sender] = \
                        self.keys.verifier_of(sender)
                if not v.verify(msg.signed_payload(), msg.signature):
                    return
            except Exception:  # noqa: BLE001 — bad sig == drop
                return
        elif self.cfg.require_signed_replies:
            return
        with self._lock:
            needed = self._quorum_needed.get(msg.req_seq_num)
            if needed is None:
                return
            slot = self._replies.setdefault(msg.req_seq_num, {})
            slot[sender] = msg
            matching = [r for r in slot.values()
                        if r.matching_digest() == msg.matching_digest()]
            if len(matching) >= needed:
                self._result[msg.req_seq_num] = msg
                self._done[msg.req_seq_num].set()
                # primary hint: majority vote over the QUORUM's replies —
                # a single byzantine reply must not steer future sends at
                # a dead node (one slow first-send per write, forever)
                votes: Dict[int, int] = {}
                for r in matching:
                    if 0 <= r.current_primary < self.info.n:
                        votes[r.current_primary] = \
                            votes.get(r.current_primary, 0) + 1
                if votes:
                    self._primary_hint = max(votes, key=votes.get)

    # ---- API ----
    def quorum_size(self, q: Quorum) -> int:
        if q is Quorum.LINEARIZABLE:
            return self.info.slow_quorum
        if q is Quorum.BYZANTINE_SAFE:
            return self.info.f + 1
        return self.info.n

    def send_write(self, request: bytes,
                   quorum: Quorum = Quorum.LINEARIZABLE,
                   timeout_ms: Optional[int] = None,
                   pre_process: bool = False) -> bytes:
        return self._send(request,
                          flags=(int(m.RequestFlag.PRE_PROCESS)
                                 if pre_process else 0),
                          quorum=quorum, timeout_ms=timeout_ms)

    def send_read(self, request: bytes,
                  quorum: Quorum = Quorum.BYZANTINE_SAFE,
                  timeout_ms: Optional[int] = None) -> bytes:
        return self._send(request, flags=int(m.RequestFlag.READ_ONLY),
                          quorum=quorum, timeout_ms=timeout_ms)

    def send_write_batch(self, requests: List[bytes],
                         quorum: Quorum = Quorum.LINEARIZABLE,
                         timeout_ms: Optional[int] = None,
                         pre_process: bool = False) -> List[bytes]:
        """Several writes in ONE wire message (reference preprocessor
        ClientBatchRequestMsg): each element is its own individually
        signed ClientRequestMsg with its own req_seq/quorum tracking;
        the batch is a transport + admission-verify optimization (the
        replica verifies all elements in one cross-request device
        batch). Returns the replies in order; raises TimeoutError if any
        element misses quorum within the deadline."""
        if not requests:
            return []
        if len(requests) > m.ClientBatchRequestMsg.MAX_BATCH:
            raise ValueError(
                f"batch of {len(requests)} > "
                f"{m.ClientBatchRequestMsg.MAX_BATCH}")
        if any(not p for p in requests):
            # an empty element would fail ClientRequestMsg.validate on
            # every replica and silently poison the WHOLE batch into a
            # timeout — reject it here where the caller can see why
            raise ValueError("empty request payload in batch")
        self.start()
        # one outstanding batch per client: replicas cache replies for
        # retransmission recovery in a bounded per-client window
        # (clients_manager.REPLY_CACHE_PER_CLIENT); concurrent batches
        # from one principal could evict each other's replies and
        # strand a retransmission
        with self._batch_lock:
            from tpubft_torch.utils.tracing import get_tracer
            span = get_tracer().start_span("client_send_batch")
            span.set_tag("client", self.cfg.client_id) \
                .set_tag("count", len(requests))
            flags = (int(m.RequestFlag.PRE_PROCESS)
                     if pre_process else 0)
            with self._lock:
                reqs = [self._new_request_locked(payload, flags,
                                                 span.context.serialize(),
                                                 quorum)
                        for payload in requests]
            for req in reqs:
                req.signature = self._signer.sign(req.signed_payload())
            batch = m.ClientBatchRequestMsg(
                sender_id=self.cfg.client_id, cid=span.context.serialize(),
                requests=[r.pack() for r in reqs], signature=b"")
            try:
                missed = self._drive_quorum(
                    batch.pack(), [r.req_seq_num for r in reqs],
                    read_only=False, timeout_ms=timeout_ms)
                if missed:
                    raise TimeoutError_(
                        f"client {self.cfg.client_id} batch: "
                        f"{len(missed)}/{len(reqs)} elements missed quorum")
                return [self._result[r.req_seq_num].reply for r in reqs]
            finally:
                span.finish()
                self._forget([r.req_seq_num for r in reqs])

    def _send(self, request: bytes, flags: int, quorum: Quorum,
              timeout_ms: Optional[int]) -> bytes:
        self.start()
        # the cid carries a serialized span context so the request's trace
        # joins across every replica (reference: spanContext inside
        # ClientRequestMsg; OpenTracing.hpp)
        from tpubft_torch.utils.tracing import get_tracer
        span = get_tracer().start_span("client_send")
        with self._lock:
            req = self._new_request_locked(request, flags,
                                           span.context.serialize(),
                                           quorum)
        req_seq = req.req_seq_num
        span.set_tag("client", self.cfg.client_id).set_tag("req_seq",
                                                           req_seq)
        req.signature = self._signer.sign(req.signed_payload())
        try:
            missed = self._drive_quorum(
                req.pack(), [req_seq],
                read_only=bool(flags & int(m.RequestFlag.READ_ONLY)),
                timeout_ms=timeout_ms)
            if missed:
                raise TimeoutError_(
                    f"client {self.cfg.client_id} req {req_seq}: no "
                    f"quorum within "
                    f"{timeout_ms or self.cfg.request_timeout_ms}ms")
            return self._result[req_seq].reply
        finally:
            span.finish()
            self._forget([req_seq])

    # ---- shared request machinery (single + batch paths) ----
    def _new_request_locked(self, payload: bytes, flags: int, cid: str,
                            quorum: Quorum) -> m.ClientRequestMsg:
        """Allocate a req_seq and its quorum tracking (caller holds
        _lock and signs afterwards)."""
        self._req_seq += 1
        rs = self._req_seq
        self._done[rs] = threading.Event()
        self._quorum_needed[rs] = self.quorum_size(quorum)
        return m.ClientRequestMsg(sender_id=self.cfg.client_id,
                                  req_seq_num=rs, flags=flags,
                                  request=payload, cid=cid, signature=b"")

    def _retry_targets(self, pending: set) -> List[int]:
        """Replicas still owing a reply for at least one pending seq —
        the broadcast-amplification fix: a retransmission tick must not
        re-send to replicas whose reply for every pending seq already
        arrived; they would just re-serve their reply cache while the
        cluster is presumably overloaded. Write-path only: a write reply
        is the committed execution result (final once sent), whereas a
        read-only reply is computed fresh from local state — a replica
        whose first read answer was stale must be re-asked so its
        converged state can complete the f+1 matching quorum."""
        with self._lock:
            owing = [r for r in self.info.replica_ids
                     if any(r not in self._replies.get(rs, ())
                            for rs in pending)]
        return owing or list(self.info.replica_ids)

    def _drive_quorum(self, raw: bytes, seqs: List[int], read_only: bool,
                      timeout_ms: Optional[int]) -> set:
        """Send `raw` and wait for quorum on every seq in `seqs`;
        returns the seqs that missed quorum (empty = success).

        Happy path: the primary alone orders writes (reference bftclient
        sends to the primary first and broadcasts only on retry) —
        backups pay nothing per write unless the primary is slow or has
        moved; only worth it when the budget allows at least one
        broadcast retry after a wrong-hint miss. Read-only requests
        always broadcast: each replica answers from local state and the
        client needs f+1 matching replies from DISTINCT replicas.

        Retries back off exponentially with decorrelated jitter (see
        ClientConfig.retry_timeout_ms/retry_max_ms); write retries
        additionally target only the replicas that have not yet replied
        for the still-pending seqs — under overload a client's pressure
        on the cluster falls with every tick instead of compounding at
        a fixed broadcast cadence."""
        deadline = time.monotonic() + (timeout_ms
                                       or self.cfg.request_timeout_ms) / 1e3
        base_s = self.cfg.retry_timeout_ms / 1e3
        cap_s = max(self.cfg.retry_max_ms / 1e3, base_s)
        delay_s = base_s
        first = True
        pending = set(seqs)
        while time.monotonic() < deadline and pending:
            if (first and not read_only
                    and deadline - time.monotonic() > 2 * base_s):
                targets = [self._primary_hint]
            elif first or read_only:
                # reads re-broadcast every tick: replies are computed
                # from CURRENT local state, so a replica whose earlier
                # answer was stale may hold the quorum-completing value
                # now (see _retry_targets)
                targets = list(self.info.replica_ids)
            else:
                targets = self._retry_targets(pending)
            for r in targets:
                self.comm.send(r, raw)
            if not first:
                delay_s = decorrelated_backoff(base_s, cap_s, delay_s)
            wait_until = min(deadline, time.monotonic()
                             + (base_s if first else delay_s))
            first = False
            for rs in sorted(pending):
                if not self._done[rs].wait(
                        timeout=max(0.0, wait_until - time.monotonic())):
                    break
            pending = {rs for rs in pending
                       if not self._done[rs].is_set()}
        return pending

    def _forget(self, seqs: List[int]) -> None:
        with self._lock:
            for rs in seqs:
                self._done.pop(rs, None)
                self._replies.pop(rs, None)
                self._result.pop(rs, None)
                self._quorum_needed.pop(rs, None)
