"""PreProcessor protocol logic (port of tpubft/preprocessor/preprocessor.py).
See package docstring."""
from __future__ import annotations

import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from tpubft_torch.consensus import messages as m
from tpubft_torch.utils import flight
from tpubft_torch.utils import serialize as ser


@dataclass
class _Session:
    """Primary-side state for one in-flight pre-execution
    (reference RequestProcessingState)."""
    original: m.ClientRequestMsg
    retry_id: int
    started: float
    last_broadcast: float = 0.0
    my_result: Optional[bytes] = None
    # replica -> (digest, sig) of agreeing replies
    replies: Dict[int, Tuple[bytes, bytes]] = field(default_factory=dict)
    done: bool = False


class PreProcessor:
    """Attached to a Replica when cfg.pre_execution_enabled. All methods
    except the pool callbacks run on the dispatcher thread."""

    SESSION_TIMEOUT_S = 10.0

    def __init__(self, replica, num_threads: int = 4) -> None:
        self.replica = replica
        self._pool = ThreadPoolExecutor(max_workers=num_threads,
                                        thread_name_prefix="preexec")
        self._sessions: Dict[Tuple[int, int], _Session] = {}
        # backup-side reply cache: (client, req_seq, retry_id) -> packed
        # PreProcessReplyMsg — rebroadcasts must not re-execute the app.
        # Bounded LRU (the SigManager verify-memo discipline): real
        # client traffic over millions of principals must not grow it
        # without bound; hits refresh recency, inserts evict the oldest.
        self._reply_cache: "OrderedDict[Tuple[int, int, int], bytes]" = \
            OrderedDict()
        self._reply_cache_max = max(
            1, getattr(replica.cfg, "preexec_reply_cache_max", 512))
        # metrics ride the replica's `preexec` component (conflict /
        # apply counters already live there, ticked by the exec path)
        comp = replica.preexec_metrics
        self.m_sessions = comp.register_counter("preexec_sessions")
        self.m_agreed = comp.register_counter("preexec_agreed")
        self.m_fallbacks = comp.register_counter("preexec_fallbacks")
        self.m_cache_hits = comp.register_counter(
            "preexec_reply_cache_hits")
        self.m_cache_evictions = comp.register_counter(
            "preexec_reply_cache_evictions")
        self._retry_counter = 0
        # primary-side broadcast micro-batching: sessions created while
        # one external message is being handled (e.g. the elements of a
        # ClientBatchRequestMsg) group into ONE PreProcessBatchRequestMsg
        # per client, flushed via the internal queue (which drains only
        # after the current external message completes)
        self._pending_broadcast: list = []
        self._batch_counter = 0
        # backup-side reply folding: (primary, batch_id) -> group state
        self._reply_groups: Dict[Tuple[int, int], dict] = {}
        replica.dispatcher.register_internal("preexec", self._on_internal)
        replica.dispatcher.add_timer(1.0, self._expire_sessions)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False)

    # ---- bounded reply cache (dispatcher-thread only) ----
    def _cache_get(self, key: Tuple[int, int, int]) -> Optional[bytes]:
        raw = self._reply_cache.get(key)
        if raw is not None:
            self._reply_cache.move_to_end(key)
            self.m_cache_hits.inc()
        return raw

    def _cache_put(self, key: Tuple[int, int, int], raw: bytes) -> None:
        self._reply_cache[key] = raw
        self._reply_cache.move_to_end(key)
        while len(self._reply_cache) > self._reply_cache_max:
            self._reply_cache.popitem(last=False)
            self.m_cache_evictions.inc()

    # ------------------------------------------------------------------
    # primary side
    # ------------------------------------------------------------------
    REBROADCAST_PERIOD_S = 1.0

    def on_client_request(self, req: m.ClientRequestMsg) -> None:
        """Primary receives a PRE_PROCESS request
        (onClientPreProcessRequestMsg)."""
        key = (req.sender_id, req.req_seq_num)
        sess = self._sessions.get(key)
        if sess is not None:
            # client retransmission: the original broadcast may have been
            # lost — re-send the PreProcessRequest (bounded rate) so a
            # stuck session can still reach its reply quorum
            now = time.monotonic()
            if now - sess.last_broadcast >= self.REBROADCAST_PERIOD_S:
                sess.last_broadcast = now
                self._broadcast_request(sess)
            return
        if not self.replica.clients.can_become_pending(*key):
            return
        self._retry_counter += 1
        sess = _Session(original=req, retry_id=self._retry_counter,
                        started=time.monotonic(),
                        last_broadcast=time.monotonic())
        self._sessions[key] = sess
        self.m_sessions.inc()
        # defer the broadcast to the flush point: sessions created while
        # this dispatcher turn runs (a client batch admits its elements
        # in one loop) ship as ONE grouped wire message per client
        if not self._pending_broadcast:
            self.replica.incoming.push_internal(
                "preexec", ("flush", None, 0, False, None, None))
        self._pending_broadcast.append(sess)
        self._launch(req, sess.retry_id, primary=True)

    def _packed_request(self, sess: _Session) -> bytes:
        return m.PreProcessRequestMsg(
            sender_id=self.replica.id, client_id=sess.original.sender_id,
            req_seq_num=sess.original.req_seq_num, retry_id=sess.retry_id,
            request=sess.original.pack()).pack()

    def _broadcast_request(self, sess: _Session) -> None:
        raw = self._packed_request(sess)
        for r in self.replica.info.other_replicas(self.replica.id):
            self.replica.comm.send(r, raw)

    def _flush_broadcasts(self) -> None:
        """Group pending sessions per client into PreProcessBatchRequestMsg
        (singletons go out as plain PreProcessRequestMsg)."""
        pending, self._pending_broadcast = self._pending_broadcast, []
        by_client: Dict[int, list] = {}
        for sess in pending:
            if sess.done:
                continue
            by_client.setdefault(sess.original.sender_id, []).append(sess)
        cap = m.ClientBatchRequestMsg.MAX_BATCH
        for client, group in by_client.items():
            if len(group) == 1:
                self._broadcast_request(group[0])
                continue
            for i in range(0, len(group), cap):
                chunk = group[i:i + cap]
                self._batch_counter += 1
                msg = m.PreProcessBatchRequestMsg(
                    sender_id=self.replica.id, client_id=client,
                    batch_id=self._batch_counter,
                    requests=[self._packed_request(s) for s in chunk])
                raw = msg.pack()
                for r in self.replica.info.other_replicas(self.replica.id):
                    self.replica.comm.send(r, raw)

    def _launch(self, req: m.ClientRequestMsg, retry_id: int,
                primary: bool, reply_to: Optional[int] = None,
                group: Optional[Tuple[int, int]] = None) -> None:
        """Run handler.pre_execute on the pool; result re-enters the
        dispatcher as an internal msg (launchAsyncReqPreProcessingJob)."""
        handler = self.replica.handler
        flight.record(flight.EV_PREEXEC_LAUNCH, seq=req.req_seq_num,
                      arg=retry_id)

        def job():
            try:
                result = handler.pre_execute(req.sender_id, req.req_seq_num,
                                             req.request)
            except Exception:
                result = None
            self.replica.incoming.push_internal(
                "preexec", ("done", req, retry_id, primary, reply_to,
                            result, group))
        self._pool.submit(job)

    def _on_internal(self, item) -> None:
        kind, req, retry_id, primary, reply_to, result = item[:6]
        group = item[6] if len(item) > 6 else None
        if kind == "flush":
            self._flush_broadcasts()
            return
        key = (req.sender_id, req.req_seq_num)
        if primary:
            sess = self._sessions.get(key)
            if sess is None or sess.retry_id != retry_id or sess.done:
                return
            if result is None:
                # unsupported/failed: fall back to normal ordering with
                # the request untouched (flags are client-signed)
                sess.done = True
                del self._sessions[key]
                self.m_fallbacks.inc()
                self.replica._admit_request(req)
                return
            sess.my_result = result
            digest = m.preexec_digest(key[0], key[1], req.pack(), result)
            sig = self.replica.sig.sign(digest)
            sess.replies[self.replica.id] = (digest, sig)
            self._maybe_finish(key)
        else:
            # backup: sign our digest and reply to the primary
            if result is None:
                status, digest, sig = 1, b"", b""
            else:
                digest = m.preexec_digest(key[0], key[1], req.pack(), result)
                sig = self.replica.sig.sign(digest)
                status = 0
            reply = m.PreProcessReplyMsg(
                sender_id=self.replica.id, client_id=key[0],
                req_seq_num=key[1], retry_id=retry_id,
                result_digest=digest, status=status, signature=sig)
            raw = reply.pack()
            self._cache_put((key[0], key[1], retry_id), raw)
            if group is not None:
                self._fold_group_reply(group, raw, reply_to)
            else:
                self.replica.comm.send(reply_to, raw)

    def _send_group_reply(self, batch_id: int, st: dict) -> None:
        msg = m.PreProcessBatchReplyMsg(
            sender_id=self.replica.id, client_id=st["client"],
            batch_id=batch_id, replies=st["got"])
        self.replica.comm.send(st["reply_to"], msg.pack())

    def _fold_group_reply(self, group: Tuple[int, int], raw_reply: bytes,
                          reply_to: Optional[int]) -> None:
        """Collect a batch element's reply; when the whole group is in,
        send ONE PreProcessBatchReplyMsg to the primary."""
        st = self._reply_groups.get(group)
        if st is None:
            # group expired (a slow sibling element) — the reply is still
            # wanted: fall back to a direct single send so the primary's
            # session can complete its quorum
            if reply_to is not None:
                self.replica.comm.send(reply_to, raw_reply)
            return
        st["got"].append(raw_reply)
        if len(st["got"]) >= st["expect"]:
            del self._reply_groups[group]
            self._send_group_reply(group[1], st)

    # ------------------------------------------------------------------
    # backup side
    # ------------------------------------------------------------------
    def _element_request(self, msg: m.PreProcessRequestMsg
                         ) -> Optional[m.ClientRequestMsg]:
        """Shared element validation for single + batched requests."""
        try:
            req = m.unpack(msg.request)
        except m.MsgError:
            return None
        if not isinstance(req, m.ClientRequestMsg) \
                or req.sender_id != msg.client_id \
                or req.req_seq_num != msg.req_seq_num:
            return None
        if not self.replica.sig.verify(req.sender_id, req.signed_payload(),
                                       req.signature):
            return None
        return req

    def on_preprocess_request(self, sender: int,
                              msg: m.PreProcessRequestMsg) -> None:
        if sender != self.replica.primary:
            return
        cached = self._cache_get((msg.client_id, msg.req_seq_num,
                                  msg.retry_id))
        if cached is not None:
            self.replica.comm.send(sender, cached)
            return
        req = self._element_request(msg)
        if req is None:
            return
        self._launch(req, msg.retry_id, primary=False, reply_to=sender)

    def on_preprocess_batch_request(self, sender: int,
                                    msg: m.PreProcessBatchRequestMsg) -> None:
        """A grouped preprocess request: launch every valid element, fold
        all replies into one PreProcessBatchReplyMsg (reference
        PreProcessBatchRequestMsg handling)."""
        if sender != self.replica.primary:
            return
        elements = []
        for raw in msg.requests:
            try:
                ppr = m.unpack(raw)
            except m.MsgError:
                return
            if not isinstance(ppr, m.PreProcessRequestMsg) \
                    or ppr.client_id != msg.client_id:
                return                  # malformed group: drop whole
            elements.append(ppr)
        group = (sender, msg.batch_id)
        if group in self._reply_groups:
            return                      # duplicate batch delivery
        cached_raws, todo = [], []
        for ppr in elements:
            cached = self._cache_get((ppr.client_id, ppr.req_seq_num,
                                      ppr.retry_id))
            if cached is not None:
                cached_raws.append(cached)
                continue
            req = self._element_request(ppr)
            if req is not None:
                todo.append((req, ppr.retry_id))
            # invalid elements simply produce no reply: the primary's
            # per-element session rebroadcast covers the gap
        if not cached_raws and not todo:
            return
        st = {"expect": len(cached_raws) + len(todo),
              "got": list(cached_raws), "reply_to": sender,
              "client": msg.client_id, "started": time.monotonic()}
        if not todo:
            # everything cached: fold-and-send immediately
            self._send_group_reply(msg.batch_id, st)
            return
        self._reply_groups[group] = st
        for req, retry_id in todo:
            self._launch(req, retry_id, primary=False, reply_to=sender,
                         group=group)

    def on_preprocess_batch_reply(self, sender: int,
                                  msg: m.PreProcessBatchReplyMsg) -> None:
        """Primary unfolds a grouped reply into per-element handling."""
        for raw in msg.replies:
            try:
                rep = m.unpack(raw)
            except m.MsgError:
                return
            if not isinstance(rep, m.PreProcessReplyMsg) \
                    or rep.sender_id != sender \
                    or rep.client_id != msg.client_id:
                return
            self.on_preprocess_reply(sender, rep)

    def on_preprocess_reply(self, sender: int,
                            msg: m.PreProcessReplyMsg) -> None:
        key = (msg.client_id, msg.req_seq_num)
        sess = self._sessions.get(key)
        if sess is None or sess.retry_id != msg.retry_id or sess.done:
            return
        if msg.status != 0:
            return
        if not self.replica.sig.verify(sender, msg.result_digest,
                                       msg.signature):
            return
        sess.replies[sender] = (msg.result_digest, msg.signature)
        self._maybe_finish(key)

    # ------------------------------------------------------------------
    def _maybe_finish(self, key) -> None:
        """f+1 matching digests (incl. our own) → order the result
        (reference: RequestProcessingState::definePreProcessingConsensusResult)."""
        sess = self._sessions.get(key)
        if sess is None or sess.my_result is None or sess.done:
            return
        my_digest = sess.replies.get(self.replica.id, (None, None))[0]
        agreeing = [(r, sig) for r, (d, sig) in sess.replies.items()
                    if d == my_digest]
        quorum = self.replica.info.f + 1
        if len(agreeing) < quorum:
            return
        sess.done = True
        del self._sessions[key]
        self.m_agreed.inc()
        flight.record(flight.EV_PREEXEC_AGREE, seq=key[1],
                      arg=len(agreeing))
        envelope = m.PreProcessResult(
            original=sess.original.pack(), result=sess.my_result,
            signatures=sorted(agreeing)[:quorum])
        wrapper = m.ClientRequestMsg(
            sender_id=sess.original.sender_id,
            req_seq_num=sess.original.req_seq_num,
            flags=(sess.original.flags
                   & ~int(m.RequestFlag.PRE_PROCESS))
            | int(m.RequestFlag.HAS_PRE_PROCESSED),
            request=ser.encode_msg(envelope),
            cid=sess.original.cid, signature=b"")
        self.replica._admit_request(wrapper)

    def _expire_sessions(self) -> None:
        now = time.monotonic()
        for key in [k for k, s in self._sessions.items()
                    if now - s.started > self.SESSION_TIMEOUT_S]:
            del self._sessions[key]
        # a reply group whose elements never all complete (handler wedge)
        # must not leak — and its partial replies are still useful, so
        # flush what arrived before dropping
        for g in [g for g, st in self._reply_groups.items()
                  if now - st["started"] > self.SESSION_TIMEOUT_S]:
            st = self._reply_groups.pop(g)
            if st["got"]:
                self._send_group_reply(g[1], st)


def validate_preprocessed_request(replica, req: m.ClientRequestMsg) -> bool:
    """Validation of an ordered PreProcessResult wrapper, used by backups
    inside PrePrepare batch validation (reference
    PreProcessResultMsg::validatePreProcessResultSignatures): the embedded
    original must carry a valid client signature, and f+1 distinct
    replicas must have signed the (request, result) binding."""
    try:
        env = ser.decode_msg(req.request, m.PreProcessResult)
        orig = m.unpack(env.original)
    except Exception:
        return False
    if not isinstance(orig, m.ClientRequestMsg):
        return False
    if orig.sender_id != req.sender_id \
            or orig.req_seq_num != req.req_seq_num:
        return False
    if not orig.flags & m.RequestFlag.PRE_PROCESS:
        return False
    if not replica.sig.verify(orig.sender_id, orig.signed_payload(),
                              orig.signature):
        return False
    digest = m.preexec_digest(orig.sender_id, orig.req_seq_num,
                              env.original, env.result)
    seen = set()
    for replica_id, sig in env.signatures:
        if replica_id in seen or not replica.info.is_replica(replica_id):
            continue
        if replica.sig.verify(replica_id, digest, sig):
            seen.add(replica_id)
    return len(seen) >= replica.info.f + 1


def unpack_preprocessed(request: bytes):
    """-> (original ClientRequestMsg, result bytes)."""
    env = ser.decode_msg(request, m.PreProcessResult)
    return m.unpack(env.original), env.result
