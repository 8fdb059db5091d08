"""BCStateTran-equivalent: the state-transfer protocol state machine (a
copy of tpubft/statetransfer/manager.py).

Rebuild of concord-bft bftengine/src/bcstatetransfer/BCStateTran.cpp
(destination fetch loop + source serving) with RVBManager's duties folded
into the RangeValidationTree and a SourceSelector grown into a per-source
scoreboard. Runs entirely on the consensus dispatcher thread
(handle_message + tick), so no internal locking is needed — mirroring the
reference's single-threaded ST handler invoked from the replica loop.

Flow (SURVEY §3.4), destination side PIPELINED:
  lag detected → AskForCheckpointSummaries (all replicas) → f+1 matching
  summaries = agreed target (seq, digest, last_block, rvt_root) → the
  span [head+1, target] is split into ranges of `fetch_batch_blocks`
  blocks and up to `window_ranges` ranges are kept in flight at once,
  each assigned to a different live source (aggregated-gossip insight:
  spread dissemination cost over the quorum, not one link). Ranges
  complete OUT OF ORDER; a completed range's leaf digests are hashed as
  ONE device batch (ops/sha256, hashlib below the cutoff / without a
  device), its RVT proofs checked per window, and its blocks staged in
  one WriteBatch; the contiguous staged prefix links in one atomic
  batch. A stalled or lying source is charged on its scoreboard and only
  ITS range is re-assigned to the next-best source — in-flight ranges on
  other sources survive. head == target → verify digest →
  on_transfer_complete upcall into consensus.
  source: answers summaries from its latest stable checkpoint; streams
  chunked ItemData with RVT proofs; RejectFetching when pruned/behind.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from tpubft_torch.kvbc.blockchain import BlockchainError, KeyValueBlockchain
from tpubft_torch.statetransfer import digests
from tpubft_torch.statetransfer import messages as stm
from tpubft_torch.statetransfer.rvt import RangeValidationTree, RvtProof
from tpubft_torch.testing.crashpoints import crashpoint
from tpubft_torch.utils import serialize as ser
from tpubft_torch.utils.metrics import Aggregator, Component, Meter
from tpubft_torch.utils.tracing import Span, get_tracer

_META_FAMILY = b"st.meta"
_K_STABLE = b"stable"

# destination states
_IDLE = "idle"
_SUMMARIES = "summaries"
_FETCHING = "fetching"
_RESPAGES = "respages"


@dataclass
class StConfig:
    fetch_batch_blocks: int = 16        # blocks per range
    max_chunk_bytes: int = 24 * 1024
    retry_timeout_s: float = 1.0
    # concurrent ranges in flight (1 = the old stop-and-wait loop)
    window_ranges: int = 4
    # a completed window with >= this many blocks hashes its leaf digests
    # through the batched device kernel (ops/sha256); smaller windows and
    # no-device runs stay on hashlib
    device_digest_threshold: int = 16
    # None = follow the blockchain's use_device_hashing; explicit
    # True/False overrides (tests, CPU-only deployments)
    use_device_digests: Optional[bool] = None
    # plausibility ceiling for byzantine chunk metadata: chunks are only
    # buffered while total_chunks and the range's cumulative payload stay
    # under what this block-size bound allows — a lying source gets
    # punished instead of streaming unbounded data into reassembly
    max_block_bytes: int = 64 << 20

    @classmethod
    def for_replica(cls, cfg, use_device_digests: Optional[bool] = None
                    ) -> "StConfig":
        """The shape a replica's config asks for: ranges of
        `state_transfer_batch_blocks` blocks, `st_window_ranges` in
        flight, the device cutoff `st_device_digest_threshold`."""
        # Port divergence (reference kvbc/replica.py:98-102, which builds
        # this inline): one builder for KvbcReplica and the in-process
        # cluster, so both run the deployed configuration
        return cls(fetch_batch_blocks=cfg.state_transfer_batch_blocks,
                   max_chunk_bytes=cfg.max_block_chunk_bytes,
                   window_ranges=cfg.st_window_ranges,
                   device_digest_threshold=cfg.st_device_digest_threshold,
                   use_device_digests=use_device_digests)


@dataclass
class _SourceStats:
    failures: int = 0           # consecutive — cleared when a range LINKS
    outstanding: int = 0        # ranges currently assigned
    bytes: int = 0
    first_byte_at: float = 0.0
    last_byte_at: float = 0.0
    abandoned: bool = False

    def rate(self) -> float:
        dt = self.last_byte_at - self.first_byte_at
        return self.bytes / dt if dt > 0 else 0.0


class SourceSelector:
    """Per-source scoreboard (reference: bcstatetransfer/SourceSelector.hpp
    grown for the pipelined fetch loop): bytes/sec, outstanding ranges,
    and a consecutive-failure budget per candidate. pick() returns the
    best usable source, preferring ones with no range in flight so the
    window stripes across the quorum; RETRY_BUDGET consecutive failures
    abandon a source; when every candidate is abandoned pick() returns
    None and the manager restarts from checkpoint summaries."""

    RETRY_BUDGET = 3

    def __init__(self) -> None:
        self._stats: Dict[int, _SourceStats] = {}

    def reset(self, candidates: List[int]) -> None:
        self._stats = {c: _SourceStats() for c in candidates}

    def live(self) -> List[int]:
        return [s for s, st in sorted(self._stats.items())
                if not st.abandoned]

    def stats(self, src: int) -> Optional[_SourceStats]:
        return self._stats.get(src)

    def pick(self, avoid: Optional[set] = None) -> Optional[int]:
        """Best live source: fewest outstanding ranges first (stripe the
        window), then measured throughput, then fewest failures. `avoid`
        is a soft preference — only honored while other candidates
        remain (fewer live sources than window slots is legal: sources
        then serve several ranges)."""
        live = self.live()
        if not live:
            return None
        pool = [s for s in live if s not in (avoid or ())] or live
        return min(pool, key=lambda s: (self._stats[s].outstanding,
                                        -self._stats[s].rate(),
                                        self._stats[s].failures, s))

    def note_bytes(self, src: int, n: int) -> None:
        st = self._stats.get(src)
        if st is None:
            return
        now = time.monotonic()
        if st.first_byte_at == 0.0:
            st.first_byte_at = now
        st.last_byte_at = now
        st.bytes += n

    def note_success(self, src: int) -> None:
        """A range served by `src` verified AND linked: clear its
        consecutive failures so sporadic timeouts across a long transfer
        don't accumulate into abandonment (reference SourceSelector
        resets the retry counter on successful replies). Deliberately NOT
        called at verify time — a lying agreed group makes every source's
        blocks verify then fail linking, and clearing at verify would
        livelock instead of exhausting into a summaries restart."""
        st = self._stats.get(src)
        if st is not None:
            st.failures = 0

    def fail(self, src: int) -> None:
        """Charge one failure (stall, corrupt data, reject, link
        mismatch); the source is abandoned once its budget is spent."""
        st = self._stats.get(src)
        if st is None:
            return
        st.failures += 1
        if st.failures >= self.RETRY_BUDGET:
            st.abandoned = True

    def inc_outstanding(self, src: int) -> None:
        st = self._stats.get(src)
        if st is not None:
            st.outstanding += 1

    def dec_outstanding(self, src: int) -> None:
        st = self._stats.get(src)
        if st is not None and st.outstanding > 0:
            st.outstanding -= 1


@dataclass
class _Range:
    """One in-flight block range [lo, hi] assigned to one source."""
    msg_id: int
    lo: int
    hi: int
    source: int
    last_activity: float
    chunks: Dict[int, Dict[int, bytes]] = field(default_factory=dict)
    totals: Dict[int, int] = field(default_factory=dict)
    proofs: Dict[int, RvtProof] = field(default_factory=dict)
    raws: Dict[int, bytes] = field(default_factory=dict)
    bytes_rcvd: int = 0
    span: Optional[Span] = None

    @property
    def n_blocks(self) -> int:
        return self.hi - self.lo + 1


class StateTransferManager:
    def __init__(self, replica_id: int, blockchain: KeyValueBlockchain,
                 cfg: Optional[StConfig] = None,
                 reserved_pages=None,
                 aggregator: Optional[Aggregator] = None) -> None:
        self.id = replica_id
        self.bc = blockchain
        self.cfg = cfg or StConfig()
        self._db = blockchain._db
        self.rvt = RangeValidationTree(self._db)
        self.sources = SourceSelector()
        self.pages = reserved_pages  # ReservedPages (set via bind/replica)
        if self.cfg.use_device_digests is None:
            self._use_device = bool(getattr(blockchain, "_use_device",
                                            False))
        else:
            self._use_device = self.cfg.use_device_digests

        # observability (st_blocks_per_sec, st_bytes_per_sec,
        # inflight_ranges, source_failovers + spans per range)
        self.metrics = Component("state_transfer", aggregator)
        self.m_blocks = self.metrics.register_counter("blocks_fetched")
        self.m_bytes = self.metrics.register_counter("bytes_fetched")
        self.m_failovers = self.metrics.register_counter("source_failovers")
        self.m_device_batches = self.metrics.register_counter(
            "device_digest_batches")
        self.m_scalar_digests = self.metrics.register_counter(
            "scalar_digests")
        self.m_requeued = self.metrics.register_counter("ranges_requeued")
        # windows whose device digest call raised (port only; see
        # _complete_range)
        self.m_device_failures = self.metrics.register_counter(
            "device_digest_failures")
        self.m_inflight = self.metrics.register_gauge("inflight_ranges")
        self.m_blocks_rate = self.metrics.register_gauge("st_blocks_per_sec")
        self.m_bytes_rate = self.metrics.register_gauge("st_bytes_per_sec")
        self._blocks_meter = Meter()
        self._bytes_meter = Meter()

        # wiring (bind() before start)
        self._send: Callable[[int, bytes], None] = lambda d, p: None
        self._complete: Callable[[int, bytes], None] = lambda s, d: None
        self._replica_ids: List[int] = []
        self._quorum = 1  # f+1

        # source-side stable checkpoint info, persisted across restarts
        raw = self._db.get(_K_STABLE, _META_FAMILY)
        self._stable: Optional[Tuple[int, bytes, int]] = None
        self._serving_pages: list = []
        if raw:
            seq = int.from_bytes(raw[:8], "big")
            last_block = int.from_bytes(raw[8:16], "big")
            self._stable = (seq, raw[16:48], last_block)
            snap = self._load_snapshot(seq)
            if snap is not None and snap[1] == self._stable[1]:
                self._serving_pages = snap[2]

        # destination-side state
        self.state = _IDLE
        self._msg_id = 0
        self._summaries: Dict[int, stm.CheckpointSummary] = {}
        self._agreed: Optional[stm.CheckpointSummary] = None
        self._min_seq = 0
        self._certified: Dict[int, bytes] = {}  # seq -> certified digest
        self._ranges: Dict[int, _Range] = {}    # msg_id -> in-flight range
        self._requeue: List[Tuple[int, int]] = []
        self._next_lo = 0
        self._staged_src: Dict[int, int] = {}   # staged block -> source
        self._refilling = False
        self._refill_more = False
        self._transfer_span: Optional[Span] = None
        self._page_chunks: Dict[int, list] = {}
        self._page_total = 0
        self._pages_src: Optional[int] = None
        self._last_activity = 0.0

    # ------------------------------------------------------------------
    # wiring
    # ------------------------------------------------------------------
    def bind(self, send_fn: Callable[[int, bytes], None],
             complete_fn: Callable[[int, bytes], None],
             replica_ids: List[int], f_val: int) -> None:
        self._send = send_fn
        self._complete = complete_fn
        self._replica_ids = [r for r in replica_ids if r != self.id]
        self._quorum = f_val + 1

    @property
    def is_fetching(self) -> bool:
        return self.state != _IDLE

    @property
    def last_activity(self) -> float:
        """Monotonic timestamp of the fetch plane's last send/receive —
        the health watchdog's progress pulse while `is_fetching`."""
        return self._last_activity

    # ------------------------------------------------------------------
    # consensus upcalls (dispatcher thread)
    # ------------------------------------------------------------------
    def on_checkpoint_created(self, seq: int, state_digest: bytes) -> None:
        """Called at the moment the replica sends its CheckpointMsg for
        `seq` — i.e. right after executing seq, when live state EQUALS the
        digests being certified. Snapshot what a certificate would bind:
        last_block and the reserved pages. The cluster keeps executing
        while the certificate forms, so serving live state instead would
        livelock every destination (digests never match the certificate)."""
        pages = self.pages.all_pages() if self.pages is not None else []
        buf = bytearray()
        buf += self.bc.last_block_id.to_bytes(8, "big")
        buf += state_digest
        ser.write_uvarint(buf, len(pages))
        for k, v in pages:
            ser.write_bytes(buf, k)
            ser.write_bytes(buf, v)
        self._db.put(b"snap" + seq.to_bytes(8, "big"), bytes(buf),
                     _META_FAMILY)
        # GC old snapshots (keep the last few in-flight checkpoints)
        for k, _ in list(self._db.range_iter(_META_FAMILY, start=b"snap")):
            if k.startswith(b"snap") and len(k) == 12 \
                    and int.from_bytes(k[4:], "big") + 4 < seq:
                self._db.delete(k, _META_FAMILY)

    def _load_snapshot(self, seq: int):
        raw = self._db.get(b"snap" + seq.to_bytes(8, "big"), _META_FAMILY)
        if raw is None:
            return None
        mv = memoryview(raw)
        last_block = int.from_bytes(mv[:8], "big")
        state_digest = bytes(mv[8:40])
        n, off = ser.read_uvarint(mv, 40)
        pages = []
        for _ in range(n):
            k, off = ser.read_bytes(mv, off)
            v, off = ser.read_bytes(mv, off)
            pages.append((k, v))
        return last_block, state_digest, pages

    def on_checkpoint_stable(self, seq: int, state_digest: bytes) -> None:
        """A certificate formed for checkpoint `seq`: promote the snapshot
        taken at creation time to the serving point
        (RVBManager::setNewSourceCheckpoint duty) and grow the RVT."""
        snap = self._load_snapshot(seq)
        if snap is None or snap[1] != state_digest:
            # no matching snapshot (e.g. we just state-transferred in):
            # live state IS the certified state right now
            snap = (self.bc.last_block_id, state_digest,
                    self.pages.all_pages() if self.pages is not None else [])
        last_block, _, pages = snap
        try:
            self.rvt.sync_to(self.bc)
        except BlockchainError:
            return  # digest gap (shouldn't happen); keep old serving point
        self._stable = (seq, state_digest, last_block)
        self._serving_pages = pages
        self._db.put(
            _K_STABLE,
            seq.to_bytes(8, "big") + last_block.to_bytes(8, "big")
            + state_digest, _META_FAMILY)

    def start_collecting(self, min_checkpoint_seq: int,
                         certified: Optional[Dict[int, bytes]] = None
                         ) -> None:
        """Lag detected by consensus — begin (or retarget) a transfer.
        `certified` maps checkpoint seq -> signature-quorum-verified state
        digest; ST sub-messages are unauthenticated, so summaries are only
        accepted when they match one of these anchors (an attacker who can
        spoof sender ids still cannot steer us to a state whose head
        digest isn't certificate-backed)."""
        if certified:
            self._certified.update(certified)
        if self.state == _FETCHING:
            return
        self._min_seq = max(self._min_seq, min_checkpoint_seq)
        if self.state == _SUMMARIES:
            return
        from tpubft_torch.utils.logging import get_logger
        get_logger("statetransfer").info(
            "starting state transfer toward checkpoint >= %d", self._min_seq)
        self.state = _SUMMARIES
        self._summaries.clear()
        self._agreed = None
        self._transfer_span = get_tracer().start_span(
            "state_transfer", tags={"r": self.id, "min_seq": self._min_seq})
        self._ask_summaries()

    def tick(self) -> None:
        if self.state == _IDLE:
            return
        now = time.monotonic()
        if self.state == _FETCHING:
            # per-range stall detection: only the stalled range's source
            # is charged and only that range re-assigned — other in-flight
            # ranges keep streaming
            stalled = [rng for rng in list(self._ranges.values())
                       if now - rng.last_activity >= self.cfg.retry_timeout_s]
            for rng in stalled:
                if rng.msg_id in self._ranges:      # not dropped meanwhile
                    self._punish_range(rng, "stalled")
            # a link deferred by an open speculative accumulation
            # (link_st_chain returns without adopting while the exec
            # lane holds the staging lock) leaves a contiguous staged
            # block waiting — retry it here once the speculation
            # resolved, or the transfer would wedge on already-verified
            # blocks
            if self._staged_src \
                    and self.bc.has_st_block(self.bc.last_block_id + 1):
                self._try_link()
            self._refill_ranges()
            self._update_rates()
            return
        if now - self._last_activity < self.cfg.retry_timeout_s:
            return
        if self.state == _SUMMARIES:
            self._ask_summaries()
        elif self.state == _RESPAGES:
            if self._pages_src is not None:
                self.sources.fail(self._pages_src)
                self.m_failovers.inc()
            self._request_res_pages()

    def _update_rates(self) -> None:
        self.m_blocks_rate.set(int(self._blocks_meter.rate()))
        self.m_bytes_rate.set(int(self._bytes_meter.rate()))

    # ------------------------------------------------------------------
    # message dispatch
    # ------------------------------------------------------------------
    def handle_message(self, sender: int, payload: bytes) -> None:
        try:
            msg = stm.unpack(payload)
        except ser.SerializeError:
            return
        if isinstance(msg, stm.AskForCheckpointSummaries):
            self._on_ask_summaries(sender, msg)
        elif isinstance(msg, stm.CheckpointSummary):
            self._on_summary(sender, msg)
        elif isinstance(msg, stm.FetchBlocks):
            self._on_fetch_blocks(sender, msg)
        elif isinstance(msg, stm.ItemData):
            self._on_item_data(sender, msg)
        elif isinstance(msg, stm.RejectFetching):
            self._on_reject(sender, msg)
        elif isinstance(msg, stm.FetchResPages):
            self._on_fetch_res_pages(sender, msg)
        elif isinstance(msg, stm.ResPagesData):
            self._on_res_pages_data(sender, msg)

    # ------------------------------------------------------------------
    # source side
    # ------------------------------------------------------------------
    def _on_ask_summaries(self, sender: int,
                          msg: stm.AskForCheckpointSummaries) -> None:
        if self._stable is None:
            return
        seq, digest, last_block = self._stable
        if seq < msg.min_checkpoint_seq or last_block == 0:
            return
        try:
            root = self.rvt.root(last_block)
        except ValueError:
            return
        from tpubft_torch.consensus.reserved_pages import ReservedPages
        self._send(sender, stm.pack(stm.CheckpointSummary(
            reply_to=msg.msg_id, checkpoint_seq=seq, state_digest=digest,
            last_block=last_block, rvt_root=root,
            res_pages_digest=(ReservedPages.digest_of(self._serving_pages)
                              if self.pages is not None else b""))))

    def _on_fetch_res_pages(self, sender: int,
                            msg: stm.FetchResPages) -> None:
        all_pages = self._serving_pages
        groups: List[list] = [[]]
        size = 0
        for k, v in all_pages:
            if size + len(k) + len(v) > self.cfg.max_chunk_bytes \
                    and groups[-1]:
                groups.append([])
                size = 0
            groups[-1].append((k, v))
            size += len(k) + len(v)
        for ci, group in enumerate(groups):
            self._send(sender, stm.pack(stm.ResPagesData(
                reply_to=msg.msg_id, chunk_idx=ci,
                total_chunks=len(groups), pages=group)))

    def _on_fetch_blocks(self, sender: int, msg: stm.FetchBlocks) -> None:
        if (self._stable is None or msg.from_block > msg.to_block
                or msg.from_block < 1
                or msg.to_block > msg.target_last_block
                or msg.target_last_block > self._stable[2]
                or msg.to_block - msg.from_block
                >= 4 * self.cfg.fetch_batch_blocks):
            self._send(sender, stm.pack(stm.RejectFetching(
                reply_to=msg.msg_id, reason="range unavailable")))
            return
        if msg.from_block < self.bc.genesis_block_id:
            self._send(sender, stm.pack(stm.RejectFetching(
                reply_to=msg.msg_id, reason="pruned")))
            return
        # prove at the requester's agreed leaf count, NOT our own stable
        # point — ours may have advanced past the agreed summary mid-transfer
        rvt_leaves = msg.target_last_block
        for bid in range(msg.from_block, msg.to_block + 1):
            raw = self.bc.get_raw_block(bid)
            if raw is None:
                self._send(sender, stm.pack(stm.RejectFetching(
                    reply_to=msg.msg_id, reason=f"missing {bid}")))
                return
            proof = self.rvt.prove(bid - 1, rvt_leaves)
            chunks = [raw[i:i + self.cfg.max_chunk_bytes]
                      for i in range(0, len(raw), self.cfg.max_chunk_bytes)] \
                or [b""]
            for ci, chunk in enumerate(chunks):
                self._send(sender, stm.pack(stm.ItemData(
                    reply_to=msg.msg_id, block_id=bid, chunk_idx=ci,
                    total_chunks=len(chunks), payload=chunk, proof=proof,
                    last_in_response=(bid == msg.to_block
                                      and ci == len(chunks) - 1))))

    # ------------------------------------------------------------------
    # destination side — summaries
    # ------------------------------------------------------------------
    def _ask_summaries(self) -> None:
        self._msg_id += 1
        self._last_activity = time.monotonic()
        ask = stm.pack(stm.AskForCheckpointSummaries(
            msg_id=self._msg_id, min_checkpoint_seq=self._min_seq))
        for r in self._replica_ids:
            self._send(r, ask)

    def _on_summary(self, sender: int, msg: stm.CheckpointSummary) -> None:
        if self.state != _SUMMARIES or msg.reply_to != self._msg_id:
            return
        if msg.checkpoint_seq < self._min_seq or msg.last_block == 0:
            return
        if sender not in self._replica_ids:
            return
        # only certificate-anchored targets are acceptable
        if self._certified.get(msg.checkpoint_seq) \
                != (msg.state_digest, msg.res_pages_digest):
            return
        self._summaries[sender] = msg
        groups: Dict[tuple, List[int]] = {}
        for r, s in self._summaries.items():
            groups.setdefault(s.key(), []).append(r)
        for key, senders in groups.items():
            if len(senders) >= self._quorum:
                self._agreed = next(s for s in self._summaries.values()
                                    if s.key() == key)
                self.sources.reset(sorted(senders))
                self.state = _FETCHING
                self._ranges.clear()
                self._requeue.clear()
                self._staged_src.clear()
                self._next_lo = self.bc.last_block_id + 1
                self._refill_ranges()
                return

    # ------------------------------------------------------------------
    # destination side — the pipelined fetch window
    # ------------------------------------------------------------------
    def _restart_from_summaries(self) -> None:
        """No usable sources left (or agreed digest mismatch) — drop all
        in-flight state and start over from checkpoint summaries."""
        for rng in list(self._ranges.values()):
            self._drop_range(rng, "aborted")
        self._requeue.clear()
        self._staged_src.clear()
        self.state = _SUMMARIES
        self._summaries.clear()
        self._agreed = None
        self._ask_summaries()

    def _refill_ranges(self) -> None:
        """Keep up to `window_ranges` ranges in flight, preferring a
        distinct source per range. Re-entrant-safe: over a synchronous
        transport every send can complete a whole range inline, which
        would otherwise recurse one stack level per range."""
        if self.state != _FETCHING:
            return
        if self._refilling:
            self._refill_more = True
            return
        self._refilling = True
        try:
            while True:
                self._refill_more = False
                if self.state != _FETCHING:
                    break
                assert self._agreed is not None
                target = self._agreed.last_block
                if (not self._ranges and not self._requeue
                        and self._next_lo > target):
                    # everything fetched; _finish validates the head (the
                    # staged suffix links as its prefix arrives, so a
                    # clean run is fully linked here). Over a synchronous
                    # transport _finish may restart the transfer inline —
                    # the outer loop re-checks instead of returning.
                    self._finish()
                else:
                    while (len(self._ranges) < self.cfg.window_ranges
                           and self.state == _FETCHING):
                        span: Optional[Tuple[int, int]] = None
                        if self._requeue:
                            span = self._requeue.pop(0)
                        elif self._next_lo <= target:
                            lo = self._next_lo
                            hi = min(lo + self.cfg.fetch_batch_blocks - 1,
                                     target)
                            span = (lo, hi)
                            self._next_lo = hi + 1
                        if span is None:
                            break
                        busy = {r.source for r in self._ranges.values()}
                        src = self.sources.pick(avoid=busy)
                        if src is None:
                            self._restart_from_summaries()
                            break
                        self._send_fetch(span, src)      # may re-enter
                if not self._refill_more:
                    break
        finally:
            self._refilling = False

    def _send_fetch(self, span: Tuple[int, int], src: int) -> None:
        assert self._agreed is not None
        self._msg_id += 1
        now = time.monotonic()
        rng = _Range(msg_id=self._msg_id, lo=span[0], hi=span[1],
                     source=src, last_activity=now)
        parent = (self._transfer_span.context
                  if self._transfer_span is not None else None)
        rng.span = get_tracer().start_span(
            "st_range", parent=parent,
            tags={"lo": rng.lo, "hi": rng.hi, "source": src})
        self._ranges[rng.msg_id] = rng
        self.sources.inc_outstanding(src)
        self.m_inflight.set(len(self._ranges))
        self._last_activity = now
        self._send(src, stm.pack(stm.FetchBlocks(
            msg_id=rng.msg_id, from_block=rng.lo, to_block=rng.hi,
            target_last_block=self._agreed.last_block)))

    def _drop_range(self, rng: _Range, outcome: str) -> None:
        self._ranges.pop(rng.msg_id, None)
        self.sources.dec_outstanding(rng.source)
        self.m_inflight.set(len(self._ranges))
        if rng.span is not None:
            rng.span.set_tag("outcome", outcome)
            rng.span.finish()
            rng.span = None

    def _punish_range(self, rng: _Range, reason: str) -> None:
        """Bad or stalled range: charge ONLY the serving source, re-queue
        the span for the next-best source. Other in-flight ranges are
        untouched; source exhaustion falls back to summaries (in
        _refill_ranges)."""
        self._drop_range(rng, reason)
        self.sources.fail(rng.source)
        self.m_failovers.inc()
        self.m_requeued.inc()
        self._requeue.append((rng.lo, rng.hi))
        self._refill_ranges()

    def _on_item_data(self, sender: int, msg: stm.ItemData) -> None:
        if self.state != _FETCHING or self._agreed is None:
            return
        rng = self._ranges.get(msg.reply_to)
        if rng is None or sender != rng.source:
            return
        if not rng.lo <= msg.block_id <= rng.hi:
            return
        if not 0 <= msg.chunk_idx < msg.total_chunks:
            return
        if msg.block_id in rng.raws:
            return                              # duplicate, already whole
        # plausibility caps BEFORE buffering anything: reassembly and RVT
        # checks only run once all claimed chunks arrive, so an uncapped
        # total_chunks (or endless payload stream) would let a byzantine
        # source grow rng.chunks without bound while each chunk refreshes
        # the stall timer. Chunks smaller than 4 KiB only arise as a
        # block's tail, so max_block_bytes/4Ki bounds any honest count.
        if msg.total_chunks > self.cfg.max_block_bytes // 4096 + 1:
            self._punish_range(rng, "implausible chunk count")
            return
        if rng.bytes_rcvd + len(msg.payload) \
                > rng.n_blocks * self.cfg.max_block_bytes:
            self._punish_range(rng, "range overweight")
            return
        # a source flipping total_chunks or the proof between chunks of
        # the SAME block is malformed — don't let it confuse reassembly
        prev_total = rng.totals.get(msg.block_id)
        if prev_total is not None and msg.total_chunks != prev_total:
            self._punish_range(rng, "chunk-total flip")
            return
        prev_proof = rng.proofs.get(msg.block_id)
        if prev_proof is not None and msg.proof != prev_proof:
            self._punish_range(rng, "proof flip")
            return
        now = time.monotonic()
        rng.last_activity = now
        self._last_activity = now
        rng.totals[msg.block_id] = msg.total_chunks
        rng.proofs[msg.block_id] = msg.proof
        parts = rng.chunks.setdefault(msg.block_id, {})
        if msg.chunk_idx not in parts:
            rng.bytes_rcvd += len(msg.payload)
        parts[msg.chunk_idx] = msg.payload
        self.sources.note_bytes(sender, len(msg.payload))
        self.m_bytes.inc(len(msg.payload))
        self._bytes_meter.mark(len(msg.payload))
        if len(parts) == msg.total_chunks:
            rng.raws[msg.block_id] = b"".join(parts[i]
                                              for i in range(msg.total_chunks))
            del rng.chunks[msg.block_id]
            if len(rng.raws) == rng.n_blocks:
                self._complete_range(rng)

    def _window_digests(self, raws: List[bytes]) -> List[bytes]:
        """Leaf digests for a completed window: one batched device call
        (ops/sha256) above the cutoff, hashlib otherwise."""
        # Port divergence (reference manager.py:704-718, which catches
        # every Exception into hashlib): the window goes through
        # statetransfer/digests.window_digests with no fallback, so a
        # device replica never hashes a window of the cutoff or more on
        # the host; every error of the device call raises to
        # _complete_range.
        out = digests.window_digests(
            raws, use_device=self._use_device,
            threshold=self.cfg.device_digest_threshold, degrade=False)
        if self._use_device and len(raws) >= self.cfg.device_digest_threshold:
            self.m_device_batches.inc()
        else:
            self.m_scalar_digests.inc(len(raws))
        return out

    def _complete_range(self, rng: _Range) -> None:
        """All blocks of a range reassembled: verify the whole window —
        leaf digests in one batch, RVT proofs per block — then stage it
        in one WriteBatch and link whatever prefix became contiguous."""
        assert self._agreed is not None
        raws = [rng.raws[b] for b in range(rng.lo, rng.hi + 1)]
        try:
            leaves = self._window_digests(raws)
        except RuntimeError:
            # Port divergence (reference manager.py:726, where the
            # digests cannot fail): the device failed the window, not
            # its source. The range is dropped uncharged and re-queued
            # for the next tick, the failure is counted, and the error
            # goes on to the dispatcher, which logs it.
            self.m_device_failures.inc()
            self._drop_range(rng, "device digest failed")
            self._requeue.append((rng.lo, rng.hi))
            raise
        if not RangeValidationTree.verify_window(
                self._agreed.rvt_root, rng.lo - 1, self._agreed.last_block,
                leaves, [rng.proofs[b] for b in range(rng.lo, rng.hi + 1)]):
            self._punish_range(rng, "rvt mismatch")
            return
        crashpoint("st.window_adopt", rid=self.id)
        self.bc.add_raw_st_blocks(rng.raws)
        for b in rng.raws:
            self._staged_src[b] = rng.source
        if rng.span is not None:
            rng.span.set_tag("bytes", sum(len(r) for r in raws))
        self.m_blocks.inc(rng.n_blocks)
        self._blocks_meter.mark(rng.n_blocks)
        self._drop_range(rng, "verified")
        self._try_link()
        self._update_rates()
        self._refill_ranges()

    def _try_link(self) -> None:
        """Adopt the contiguous staged prefix (one atomic WriteBatch in
        the blockchain). A link failure after RVT verification means the
        block's CONTENT doesn't re-execute to its recorded digests —
        charge the source that served it and re-fetch just that block."""
        try:
            self.bc.link_st_chain()
        except Exception:  # noqa: BLE001 — any staged-block defect
            failed = self.bc.last_block_id + 1
            src = self._staged_src.pop(failed, None)
            if src is not None:
                self.sources.fail(src)
                self.m_failovers.inc()
            self.m_requeued.inc()
            self._requeue.append((failed, failed))
        # linked blocks: clear blame AND credit their sources (see
        # SourceSelector.note_success for why credit waits for the link)
        linked = [b for b in self._staged_src
                  if b <= self.bc.last_block_id]
        for b in linked:
            self.sources.note_success(self._staged_src.pop(b))

    def _on_reject(self, sender: int, msg: stm.RejectFetching) -> None:
        if self.state != _FETCHING:
            return
        rng = self._ranges.get(msg.reply_to)
        if rng is None or sender != rng.source:
            return
        self._punish_range(rng, f"rejected: {msg.reason}")

    def _finish(self) -> None:
        assert self._agreed is not None
        agreed = self._agreed
        if self.bc.last_block_id != agreed.last_block \
                or self.bc.state_digest() != agreed.state_digest:
            # chain incomplete or digest mismatch — the agreed group lied
            # or we hit a bug; restart from scratch
            self._restart_from_summaries()
            return
        # reserved pages next (reference: FetchResPagesMsg after blocks)
        if self.pages is not None \
                and self.pages.digest() != agreed.res_pages_digest:
            self.state = _RESPAGES
            self._request_res_pages()
            return
        self._complete_transfer()

    # ------------------------------------------------------------------
    # destination side — reserved pages
    # ------------------------------------------------------------------
    def _request_res_pages(self) -> None:
        self._last_activity = time.monotonic()
        src = self.sources.pick()
        if src is None:
            self._restart_from_summaries()
            return
        self._pages_src = src
        self._msg_id += 1
        self._page_chunks.clear()
        self._send(src, stm.pack(stm.FetchResPages(msg_id=self._msg_id)))

    def _on_res_pages_data(self, sender: int, msg: stm.ResPagesData) -> None:
        if (self.state != _RESPAGES or self._agreed is None
                or sender != self._pages_src
                or msg.reply_to != self._msg_id
                or not 0 <= msg.chunk_idx < msg.total_chunks):
            return
        # a source switching total_chunks mid-response is malformed
        if self._page_chunks and msg.total_chunks != self._page_total:
            self._fail_res_pages()
            return
        self._page_total = msg.total_chunks
        self._last_activity = time.monotonic()
        self._page_chunks[msg.chunk_idx] = msg.pages
        if any(ci not in self._page_chunks
               for ci in range(msg.total_chunks)):
            return
        pages = [kv for ci in range(msg.total_chunks)
                 for kv in self._page_chunks[ci]]
        from tpubft_torch.consensus.reserved_pages import ReservedPages
        if ReservedPages.digest_of(pages) != self._agreed.res_pages_digest:
            self._fail_res_pages()
            return
        self.pages.replace_all(pages)
        self._complete_transfer()

    def _fail_res_pages(self) -> None:
        self._page_chunks.clear()
        if self._pages_src is not None:
            self.sources.fail(self._pages_src)
            self.m_failovers.inc()
        self._request_res_pages()

    def _complete_transfer(self) -> None:
        agreed = self._agreed
        from tpubft_torch.utils.logging import get_logger
        get_logger("statetransfer").info(
            "state transfer complete at checkpoint %d", agreed.checkpoint_seq)
        self.state = _IDLE
        self._agreed = None
        self._summaries.clear()
        self._page_chunks.clear()
        self._pages_src = None
        self._staged_src.clear()
        self._update_rates()
        if self._transfer_span is not None:
            self._transfer_span.set_tag("checkpoint", agreed.checkpoint_seq)
            self._transfer_span.set_tag("last_block", self.bc.last_block_id)
            self._transfer_span.finish()
            self._transfer_span = None
        self._certified = {s: d for s, d in self._certified.items()
                           if s > agreed.checkpoint_seq}
        # we are now a valid source for this checkpoint
        self.on_checkpoint_stable(agreed.checkpoint_seq, agreed.state_digest)
        self._complete(agreed.checkpoint_seq, agreed.state_digest)
