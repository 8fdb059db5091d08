"""Per-client bookkeeping: pending requests + reply cache.

Rebuild of the reference's ClientsManager
(concord-bft bftengine/src/bftengine/ClientsManager.cpp): tracks the
highest executed request seqnum per client (for at-most-once execution),
the pending (not yet committed) request, and caches the last reply so a
retransmitted request gets the cached answer instead of re-execution.

Million-principal shape: resident state is a bounded LRU over the
reserved-pages machinery. `max_resident` caps how many `_ClientInfo`
records stay in memory; a cold client's record is demand-paged back from
its reply-ring pages through the `pager` callback (the replica wires
`Replica._page_in_client`, which replays the same restore rule as a
restart: ring membership + the oversize marker, sealed with the
evict/reload floor). Eviction never loses at-most-once state because the
reply ring IS the canonical record — execution persists every reply page
before the in-memory table learns about it — so evict→reload is
indistinguishable from a crash→restart for that one client, the
semantics every restore test already pins down. Clients with in-flight
(pending) requests are pinned resident: pending is memory-only state,
and an active client is by definition hot.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Optional

from tpubft_torch.consensus.messages import ClientBatchRequestMsg, ClientReplyMsg
from tpubft_torch.utils.racecheck import make_lock

# replies kept per client for retransmission recovery. Must cover a full
# client batch PLUS interleaved single writes: every element of an
# executed batch has to stay regenerable until the client stops
# retransmitting it (reference keeps per-request reply slots in reserved
# pages, bounded by the client batching limit). The client enforces one
# outstanding batch per principal (bftclient._batch_lock), so 2× the
# batch bound covers a retransmitting batch alongside a full batch's
# worth of other traffic from the same principal.
REPLY_CACHE_PER_CLIENT = 2 * ClientBatchRequestMsg.MAX_BATCH


# in-flight (admitted, not yet executed) requests tracked per client.
# Multiple pending seqs are first-class (reference ClientsManager
# requestsInfo map, bounded by maxNumOfRequestsInBatch): a batch's 64
# elements plus interleaved singles may all be in flight, and they can
# ARRIVE out of seq order (a later-allocated single can beat a batch to
# the primary), so membership — not ordering — is the dedup test.
MAX_PENDING_PER_CLIENT = 2 * ClientBatchRequestMsg.MAX_BATCH

# how many LRU candidates one insert will pass over looking for an
# evictable (pending-free) record before letting the table temporarily
# exceed its bound — an O(1) cap so a burst of active clients degrades
# to a slightly-over-budget table, never an O(resident) scan per insert
_EVICT_SCAN_MAX = 8


@dataclass
class _ClientInfo:
    # newest executed seq. NOT a dedup watermark (see replies below) — it
    # exists only to seal the post-restore floor: reserved pages persist a
    # bounded reply ring, so after a restart/state transfer anything at or
    # below this that is absent from the ring may have executed and been
    # forgotten, and must be refused (seal_restore).
    last_executed_req: int = -1
    # req_seq -> reply (None = executed with oversize/absent reply). This
    # map IS the at-most-once record: requests execute out of seq order
    # (multi-pending + pre-exec sessions complete independently), so dedup
    # is membership here, never a seqnum watermark (reference
    # ClientsManager.cpp:455 canBecomePending checks requestsInfo/
    # repliesInfo membership for the same reason).
    replies: "OrderedDict[int, Optional[ClientReplyMsg]]" = field(
        default_factory=OrderedDict)
    # highest req_seq ever evicted from the bounded replies map: a seq at
    # or below this may have executed and been forgotten, so it must be
    # refused (can't prove it isn't a replay). Only eviction — never
    # execution — advances this.
    evicted_high: int = -1
    pending: "OrderedDict[int, str]" = field(
        default_factory=OrderedDict)      # req_seq -> cid


class ClientsManager:
    """Admission runs on the dispatcher thread; execution results arrive
    from the execution lane's thread — the compound read-modify-write
    paths (admission check vs. reply-cache eviction) are guarded by one
    small lock (instrumented under TPUBFT_THREADCHECK)."""

    def __init__(self, client_ids, max_resident: int = 0,
                 pager: Optional[Callable[[int], _ClientInfo]] = None
                 ) -> None:
        # the id universe: a `range` for production topologies (contiguous
        # by construction — ReplicasInfo.all_client_ids — so membership is
        # O(1) with O(1) memory even at 1M principals), any container with
        # `in` otherwise (unit tests pass small lists)
        self._universe = client_ids if isinstance(client_ids, range) \
            else frozenset(client_ids)
        # 0 = unbounded: every touched client stays resident (the legacy
        # test-cluster shape, and the right answer when no pager exists)
        self._max_resident = max_resident if pager is not None else 0
        self._pager = pager
        self._clients: "OrderedDict[int, _ClientInfo]" = OrderedDict()
        if self._pager is None:
            # eager population keeps the legacy O(clients)-resident shape
            # for pager-less tables (unit tests, tiny topologies); a
            # paged table starts empty and demand-pages
            for c in self._universe:
                self._clients[c] = _ClientInfo()
        self._mu = make_lock("clients_manager")
        # table telemetry (racy reads fine — monotone counters)
        self.table_hits = 0
        self.table_misses = 0
        self.table_evictions = 0

    # ---- resident-table mechanics ----
    @property
    def resident_count(self) -> int:
        return len(self._clients)

    @property
    def max_resident(self) -> int:
        return self._max_resident

    def set_max_resident(self, n: int) -> None:
        """Autotuner actuator (client_table_max knob): retune the resident
        bound live; shrinking evicts down on the next inserts rather than
        synchronously (bounded work per operation)."""
        if self._pager is not None:
            self._max_resident = max(0, n)

    def invalidate_all(self) -> None:
        """Drop every pageable resident record (state transfer installed a
        new page set under us — resident state may describe dead pages).
        Pending is memory-only and the caller (view/ST machinery) clears
        it separately; unbounded tables keep their records because no
        pager could rebuild them."""
        if self._pager is None:
            return
        with self._mu:
            self._clients.clear()

    def _resident(self, client_id: int) -> Optional[_ClientInfo]:
        """Resident record for `client_id`, demand-paging it in (and LRU-
        evicting past the bound) as needed. Caller holds self._mu. None
        for ids outside the universe."""
        info = self._clients.get(client_id)
        if info is not None:
            self._clients.move_to_end(client_id)
            self.table_hits += 1
            return info
        if client_id not in self._universe:
            return None
        self.table_misses += 1
        info = self._pager(client_id) if self._pager is not None \
            else _ClientInfo()
        self._clients[client_id] = info
        if self._max_resident:
            scanned = 0
            while len(self._clients) > self._max_resident \
                    and scanned < _EVICT_SCAN_MAX:
                victim, vinfo = next(iter(self._clients.items()))
                scanned += 1
                if vinfo.pending:
                    # pinned: in-flight requests are memory-only state —
                    # rotate it to the MRU end and try the next candidate
                    self._clients.move_to_end(victim)
                    continue
                # safe to drop: every executed reply was persisted to its
                # ring page BEFORE this table learned of it, so the pager
                # rebuilds an equivalent (restart-sealed) record
                del self._clients[victim]
                self.table_evictions += 1
        return info

    def is_valid_client(self, client_id: int) -> bool:
        return client_id in self._universe

    # ---- request admission (primary + all replicas) ----
    def can_become_pending(self, client_id: int, req_seq: int) -> bool:
        with self._mu:
            info = self._resident(client_id)
            if info is None:
                return False
            if self._executed(info, req_seq):
                return False                   # already executed (dup)
            if req_seq in info.pending:
                return False                   # already in flight
            if len(info.pending) >= MAX_PENDING_PER_CLIENT:
                return False                   # per-client flood bound
            return True

    @staticmethod
    def _executed(info: _ClientInfo, req_seq: int) -> bool:
        return req_seq in info.replies or req_seq <= info.evicted_high

    def was_executed(self, client_id: int, req_seq: int) -> bool:
        """At-most-once membership test: True if this request executed (or
        its record aged out of the bounded cache, which must be treated as
        executed). A lower seq than the newest execution is NOT evidence
        of a dup — requests complete out of order."""
        with self._mu:
            info = self._resident(client_id)
            if info is None:
                return False
            return self._executed(info, req_seq)

    def add_pending(self, client_id: int, req_seq: int, cid: str = "") -> None:
        with self._mu:
            info = self._resident(client_id)
            if info is not None:
                info.pending[req_seq] = cid

    def has_pending(self, client_id: int) -> bool:
        # resident-only read: a non-resident client cannot have pending
        # requests (records with pending are pinned against eviction)
        info = self._clients.get(client_id)
        return bool(info is not None and info.pending)

    # ---- execution results ----
    def on_request_executed(self, client_id: int, req_seq: int,
                            reply: Optional[ClientReplyMsg]) -> None:
        with self._mu:
            info = self._resident(client_id)
            if info is None:
                return
            if req_seq > info.last_executed_req:
                info.last_executed_req = req_seq
            info.replies[req_seq] = reply
            while len(info.replies) > REPLY_CACHE_PER_CLIENT:
                seq, _ = info.replies.popitem(last=False)  # evict oldest
                if seq > info.evicted_high:
                    info.evicted_high = seq
            info.pending.pop(req_seq, None)

    def note_executed(self, client_id: int, req_seq: int) -> None:
        """Record execution without a cached reply (oversize reply marker
        loaded from reserved pages). Keeps a None entry in the replies map
        so the at-most-once membership test still covers the request."""
        self.on_request_executed(client_id, req_seq, None)

    def cached_reply(self, client_id: int,
                     req_seq: int) -> Optional[ClientReplyMsg]:
        """Reply for a retransmitted already-executed request (reference
        stores per-request reply slots in reserved pages; we keep a
        bounded per-client map so every element of an executed batch
        stays regenerable, not just the newest request). None for both
        never-executed and oversize-reply entries."""
        with self._mu:
            info = self._resident(client_id)
            if info is None:
                return None
            return info.replies.get(req_seq)

    def seal_restore(self, client_id: int) -> None:
        """Call after seeding this client from reserved pages (restart or
        completed state transfer): the persisted reply ring is bounded, so
        any seq at or below the persisted newest-executed watermark that
        did not make it back into the ring may have executed and been
        evicted — refuse it. Without this seal, a restart would reopen the
        at-most-once window for old validly-signed requests. The demand
        pager applies the same seal to every record it rebuilds (an
        evict/reload cycle is a single-client restart)."""
        info = self._clients.get(client_id)
        if info is not None and info.last_executed_req > info.evicted_high:
            info.evicted_high = info.last_executed_req

    def clear_pending(self) -> None:
        """View change: in-flight requests are abandoned; clients will
        retransmit and the new primary re-admits them."""
        with self._mu:
            for info in self._clients.values():
                info.pending.clear()
