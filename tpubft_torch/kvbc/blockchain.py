"""Categorized key-value blockchain (port of tpubft/kvbc/blockchain.py).

The reference's rebuild of concord-bft's categorized KeyValueBlockchain:
blocks are maps category→updates, chained by parent digest; per-category
state digests (the Merkle root for block_merkle categories) feed the
block digest, which is what consensus checkpoints sign. Also carries the
v4-style `st_chain` staging area so state transfer can land blocks out
of order and link them with integrity checks, and the execution lane's
block accumulation. A copy of the reference's code: the only device work
is the Merkle level hashing of kvbc/sparse_merkle.py, which `add_blocks`
batches across every block of a bulk ingest (one SHA-256 launch per tree
level).
"""
from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from tpubft_torch.kvbc import categories as cat
from tpubft_torch.kvbc.sparse_merkle import SparseMerkleTree
from tpubft_torch.storage.interfaces import IDBClient, WriteBatch, fkey
from tpubft_torch.utils import serialize as ser
from tpubft_torch.utils.racecheck import make_lock

_BLOCKS = b"blk.blocks"
_MISC = b"blk.misc"
_ST = b"blk.st"

_K_LAST = b"last"
_K_GENESIS = b"genesis"


class BlockchainError(Exception):
    pass


@dataclass
class Block:
    block_id: int
    parent_digest: bytes
    category_digests: Dict[str, bytes] = field(default_factory=dict)
    updates_blob: bytes = b""

    SPEC = [("block_id", "u64"), ("parent_digest", "bytes"),
            ("category_digests", ("map", "str", "bytes")),
            ("updates_blob", "bytes")]

    def digest(self) -> bytes:
        return hashlib.sha256(ser.encode_msg(self)).digest()


def _bid(block_id: int) -> bytes:
    return block_id.to_bytes(8, "big")


class _MirroredBatch(WriteBatch):
    """WriteBatch that mirrors every op into an overlay dict (physical
    key -> value-or-None) so staging reads made later in the SAME batch
    observe earlier staged writes (read-your-writes for batched ST
    linking)."""

    def __init__(self, overlay: Dict[bytes, Optional[bytes]]) -> None:
        super().__init__()
        self._overlay = overlay

    def put(self, key: bytes, value: bytes,
            family: bytes = b"default") -> "WriteBatch":
        self._overlay[fkey(family, key)] = bytes(value)
        return super().put(key, value, family)

    def delete(self, key: bytes,
               family: bytes = b"default") -> "WriteBatch":
        self._overlay[fkey(family, key)] = None
        return super().delete(key, family)


class _StagedReadView(IDBClient):
    """Read view over (overlay, base db) used while linking several
    staged blocks into one WriteBatch: block N+1's staging must see block
    N's pending writes (parent block row, merkle nodes, immutable-rewrite
    checks) before anything hits the real DB. Every staging read in both
    ledger engines is a point `get`; mutations during staging go through
    the shared batch, never this view."""

    def __init__(self, base: IDBClient,
                 overlay: Dict[bytes, Optional[bytes]]) -> None:
        self._base = base
        self._overlay = overlay

    def get(self, key: bytes, family: bytes = b"default"):
        pk = fkey(family, key)
        if pk in self._overlay:
            return self._overlay[pk]
        return self._base.get(key, family)

    def write(self, batch: WriteBatch) -> None:
        raise BlockchainError("staged read view is read-only")

    def range_iter(self, family: bytes = b"default", start=None, end=None):
        # staging never range-scans; reads that do (proof serving) run
        # outside the link path, against the committed base
        return self._base.range_iter(family, start, end)

    def close(self) -> None:  # pragma: no cover - never owned
        pass


class _SpecOverlayView(IDBClient):
    """Thread-routed staged-read view for SPECULATIVE accumulations: the
    executor thread that owns the speculation reads its own staged
    writes through the overlay (read-your-writes), while every OTHER
    thread — read-only queries on the dispatcher, proof serving, status
    handlers — keeps reading the committed base. A speculative run may
    abort; its overlay must never be observable outside the thread that
    can roll it back."""

    def __init__(self, base: IDBClient, view: "_StagedReadView",
                 owner_ident: int) -> None:
        self._base = base
        self._view = view
        self._owner = owner_ident

    def get(self, key: bytes, family: bytes = b"default"):
        if threading.get_ident() == self._owner:
            return self._view.get(key, family)
        return self._base.get(key, family)

    def write(self, batch: WriteBatch) -> None:
        raise BlockchainError("staged read view is read-only")

    def range_iter(self, family: bytes = b"default", start=None, end=None):
        return self._base.range_iter(family, start, end)

    def close(self) -> None:  # pragma: no cover - never owned
        pass


def raw_base(db):
    """Unwrap a durability `_PendingView` to the raw backing store —
    THE one idiom for 'give me the db the io thread writes/fsyncs'
    (the execution lane's sync targets, the test cluster's shared-pages
    wiring, and this module's own seal path all route through here)."""
    return db.base if isinstance(db, _PendingView) else db


class _PendingView(IDBClient):
    """Permanently-installed read view over (durability-pending overlay,
    base db) — the group-commit pipeline's visibility layer. The
    execution lane seals each run's WriteBatch into the
    `durability.PendingStore` instead of writing the base; every reader
    on every thread (execution staging, dispatcher queries, proof
    serving, thin-replica handlers, pages digests) consults the overlay
    first, so the LOGICAL head is what the process observes while the
    io thread lands the bytes behind it. Point gets are lock-free
    overlay lookups; range scans merge the (bounded, seal-queue-sized)
    pending keys into the base iteration so versioned reads and digest
    walks see sealed state too. Writes forward to the base — direct
    writers (ST staging, metadata, link segments) never ride the
    pipeline, and the order-sensitive ones take `_pending_barrier`
    first."""

    def __init__(self, base: IDBClient, store) -> None:
        self._base = base
        self._store = store

    @property
    def base(self) -> IDBClient:
        return self._base

    def get(self, key: bytes, family: bytes = b"default"):
        ent = self._store.lookup(fkey(family, key))
        if ent is not None:
            return ent[1]
        return self._base.get(key, family)

    def write(self, batch: WriteBatch) -> None:
        self._base.write(batch)

    # no sync()/write_group() forwards on purpose: the io thread holds
    # the RAW base (SealedRun.db) — the group boundary never routes
    # through the read view, and the fsync-seam lint keeps it that way

    def range_iter(self, family: bytes = b"default", start=None, end=None):
        from tpubft_torch.storage.interfaces import family_upper_bound
        lo = fkey(family, start if start is not None else b"")
        hi = (fkey(family, end) if end is not None
              else family_upper_bound(family))
        pend = self._store.snapshot_range(lo, hi)
        if not pend:
            yield from self._base.range_iter(family, start, end)
            return
        prefix = 1 + len(family)
        pi = 0
        for k, v in self._base.range_iter(family, start, end):
            while pi < len(pend) and pend[pi][0][prefix:] < k:
                pk, pv = pend[pi]
                pi += 1
                if pv is not None:
                    yield pk[prefix:], pv
            if pi < len(pend) and pend[pi][0][prefix:] == k:
                pk, pv = pend[pi]
                pi += 1
                if pv is not None:      # pending overwrite wins; a
                    yield pk[prefix:], pv   # pending delete hides the row
                continue
            yield k, v
        while pi < len(pend):
            pk, pv = pend[pi]
            pi += 1
            if pv is not None:
                yield pk[prefix:], pv

    def scan_all(self):
        # whole-state walks (snapshot tools, ST streaming) run on
        # drained paths — served from the base
        return self._base.scan_all()

    def close(self) -> None:
        self._base.close()


@dataclass
class _Accumulation:
    """In-flight execution-run accumulation: the shared mirrored batch
    plus what end/abort need to finish or roll back."""
    master: "_MirroredBatch"
    base_last: int
    notifications: List[Tuple[int, "cat.BlockUpdates"]] = field(
        default_factory=list)
    # speculative accumulations stay open across the commit-combine
    # window: their staged reads are visible only to `owner` (the
    # executor thread), and link_st_chain DEFERS instead of blocking on
    # the staging lock they hold (the dispatcher must stay free to
    # seal or abort them)
    speculative: bool = False
    owner: int = 0


class BlockStoreMixin:
    """Shared block-store + ST-staging + pruning plumbing for both ledger
    engines (categorized and v4 — they differ only in keyspace names and
    how a block's updates are staged). Engines set the class attributes
    `_F_BLOCKS`/`_F_MISC`/`_F_ST` and implement `_stage_block(wb,
    block_id, updates) -> Block`; the mixin provides everything keyed off
    the shared block format."""

    _F_BLOCKS: bytes
    _F_MISC: bytes
    _F_ST: bytes

    # blocks adopted per atomic commit inside link_st_chain: bounds the
    # in-memory batch + overlay when a huge staged suffix becomes
    # linkable at once (a slow front range can back the whole rest of a
    # transfer up behind it), and keeps one kvlog record well under the
    # engine's u32 payload limit. Class attribute so tests can shrink it.
    LINK_SEGMENT_BLOCKS = 256

    def _load_head(self) -> None:
        last = self._db.get(_K_LAST, self._F_MISC)
        self._last = int.from_bytes(last, "big") if last else 0
        gen = self._db.get(_K_GENESIS, self._F_MISC)
        self._genesis = int.from_bytes(gen, "big") if gen else 0
        self._listeners: List[Callable[[int, "cat.BlockUpdates"],
                                       None]] = []
        # run listeners see one call per ATOMIC COMMIT (a coalesced
        # execution run, a bulk add_blocks, a link segment) with the
        # whole batch of (block_id, updates) — the thin-replica feed
        # pays one publish hop per sealed run, not one per block
        self._run_listeners: List[Callable[
            [List[Tuple[int, "cat.BlockUpdates"]]], None]] = []
        # serializes the two users of the staged-read redirect — the
        # execution lane's block accumulation (executor thread) and
        # state-transfer linking (dispatcher thread). Held across
        # begin_accumulation..end/abort and for each link_st_chain
        # segment loop.
        self._staging_mu = make_lock("kvbc.staging")
        self._accum: Optional[_Accumulation] = None
        # group-commit durability (durability/): the pending
        # overlay store + drain hook, installed by attach_durability;
        # _deferred stages exactly one sealed-run handoff between
        # end_accumulation(defer=True) and take_deferred() — both on
        # the executor thread
        self._pending_store = None
        self._pending_drain = None
        self._deferred = None

    # ---- group-commit durability wiring ----
    def attach_durability(self, store, drain_fn=None) -> "_PendingView":
        """Install the sealed-not-yet-applied read overlay: self._db
        becomes a `_PendingView` over (store, base) so every reader
        observes sealed runs before the io thread lands them.
        `drain_fn(timeout) -> bool` is the pipeline's flush-and-wait
        barrier — the direct-write paths call it, because overlay
        emptiness alone cannot see an applied-but-unsynced group parked
        for an fsync retry. Must run before any accumulation (replica
        wiring time); re-attach (a fresh pipeline over a reused ledger)
        swaps the store."""
        if self._accum is not None:
            raise BlockchainError("attach_durability during accumulation")
        view = _PendingView(raw_base(self._db), store)
        self._db = view
        self._pending_store = store
        self._pending_drain = drain_fn
        self._deferred = None
        # cached merkle trees read through the same view
        for t in getattr(self, "_trees", {}).values():
            t._db = view
        return view

    @property
    def durability_attached(self) -> bool:
        return self._pending_store is not None

    def take_deferred(self):
        """(run_no, master batch, raw base db) of the run just sealed
        by end_accumulation(defer=True) — consumed immediately by the
        executor thread, which hands it to the durability pipeline."""
        d, self._deferred = self._deferred, None
        return d

    def _pending_barrier(self, timeout: float = 30.0) -> None:
        """Direct-write order barrier: bulk ingest, ST link segments
        and pruning write the base db straight — they must never
        interleave with sealed run batches the io thread has not
        DURABLY retired (a group that applied, failed its fsync and
        was requeued for retry would re-apply an OLDER head over
        theirs — overlay emptiness alone cannot see that state, so the
        barrier is the pipeline's own flush-and-wait). These paths
        already run behind the replica's drain discipline; the wait
        here is the loud backstop, and a disk too wedged to drain
        fails the write rather than corrupting the head."""
        store = self._pending_store
        if store is None:
            return
        drain = self._pending_drain
        ok = True
        if drain is not None:
            try:
                ok = bool(drain(timeout))
            except Exception:  # noqa: BLE001 — treat as not drained
                ok = False
        if not ok or not store.wait_empty(
                timeout if drain is None else 1.0):
            raise BlockchainError(
                "durability pipeline failed to drain before a direct "
                "ledger write (sealed runs still pending)")

    # ---- properties ----
    @property
    def last_block_id(self) -> int:
        # a SPECULATIVE accumulation's head bump is private to its
        # executor thread, exactly like its staged reads: every other
        # thread sees the committed head (a non-owner observing the
        # speculative head would try to read blocks that may abort)
        acc = self._accum
        if acc is not None and acc.speculative \
                and threading.get_ident() != acc.owner:
            return acc.base_last
        return self._last

    @property
    def speculation_open(self) -> bool:
        acc = self._accum
        return acc is not None and acc.speculative

    @property
    def genesis_block_id(self) -> int:
        return self._genesis

    # ---- commit-stream listeners (thin-replica publishing; reference:
    # kvbc Replica feeds SubUpdateBuffers from the commit path) ----
    def add_listener(self,
                     fn: Callable[[int, "cat.BlockUpdates"], None]) -> None:
        self._listeners.append(fn)

    def add_run_listener(self, fn: Callable[
            [List[Tuple[int, "cat.BlockUpdates"]]], None]) -> None:
        """Commit-stream listener at RUN granularity: `fn(items)` fires
        once per atomic commit with every (block_id, updates) it sealed,
        in order. A single add_block is a run of one."""
        self._run_listeners.append(fn)

    def _notify(self, block_id: int, updates: "cat.BlockUpdates") -> None:
        self._notify_run([(block_id, updates)])

    def _notify_run(self,
                    items: List[Tuple[int, "cat.BlockUpdates"]]) -> None:
        if not items:
            return
        for fn in self._run_listeners:
            try:
                fn(items)
            except Exception:  # noqa: BLE001 — listeners must not break commit
                pass
        for block_id, updates in items:
            for fn in self._listeners:
                try:
                    fn(block_id, updates)
                except Exception:  # noqa: BLE001 — see above
                    pass

    # ---- write path ----
    def add_block(self, updates: "cat.BlockUpdates") -> int:
        acc = self._accum
        if acc is not None:
            # accumulation mode (execution lane): stage into the shared
            # master batch; reads during staging go through the
            # read-your-writes overlay, so block N+1 sees block N's
            # pending rows. Nothing touches the DB until
            # end_accumulation commits the whole run atomically.
            block_id = self._last + 1
            self._stage_block(acc.master, block_id, updates)
            self._last = block_id
            acc.notifications.append((block_id, updates))
            return block_id
        block_id = self._last + 1
        wb = WriteBatch()
        self._stage_block(wb, block_id, updates)
        self._db.write(wb)
        self._last = block_id
        if self._genesis == 0:
            self._genesis = 1
        self._notify(block_id, updates)
        return block_id

    # ---- block accumulation (execution-lane run commit) ----
    def begin_accumulation(self, speculative: bool = False) -> None:
        """Enter accumulation mode: subsequent add_block calls stage into
        ONE shared WriteBatch (committed by end_accumulation) instead of
        one DB write per block. Reads made while accumulating — the
        handler's read-your-writes during execution, read-only queries —
        observe the staged blocks through the overlay view. Takes the
        staging lock; the caller MUST reach end/abort_accumulation.

        `speculative=True` (the execution lane's pre-commit runs): the
        overlay + head bump are visible ONLY to the calling thread — a
        speculative run may abort, so other threads (read-only queries,
        proof serving) keep reading the committed base until
        end_accumulation makes the run durable; link_st_chain defers
        instead of blocking while the speculation holds the lock."""
        self._staging_mu.acquire()
        try:
            if self._accum is not None:
                raise BlockchainError("accumulation already active")
            overlay: Dict[bytes, Optional[bytes]] = {}
            view = _StagedReadView(self._db, overlay)
            install = view
            if speculative:
                install = _SpecOverlayView(self._db, view,
                                           threading.get_ident())
            self._accum = _Accumulation(master=_MirroredBatch(overlay),
                                        base_last=self._last,
                                        speculative=speculative,
                                        owner=threading.get_ident())
            self._begin_staged_reads_locked(install)
        except BaseException:
            self._accum = None
            self._staging_mu.release()
            raise

    def end_accumulation(self, extra: Optional[WriteBatch] = None,
                         defer: bool = False) -> int:
        """Commit the accumulated run in one atomic WriteBatch. `extra`
        ops (e.g. the run's reserved-pages/reply rows when they live in
        the same DB) ride the same batch, making apply atomic across
        ledger and reply state. Returns the new head.

        Default mode writes the BASE db while the staged-read view is
        still installed: unsynchronized readers (read-only queries on
        the dispatcher) see the staged values through the overlay right
        up to the moment the same values are durably in the base — no
        torn window where a key's new value momentarily vanishes. A
        failed write rolls the head back (abort semantics) so a retry
        re-stages from the pre-run state instead of double-appending.

        `defer=True` (the durability pipeline's seal path, requires
        attach_durability): nothing touches the base here — the run's
        overlay merges into the pending store BEFORE the staged view
        uninstalls (readers hand over from overlay to pending with no
        torn window, the same invariant as the direct write), and the
        batch is stashed for `take_deferred()`; the pipeline's io
        thread applies it as part of a concatenated group write and
        fsyncs once per group."""
        acc = self._accum
        if acc is None:
            raise BlockchainError("no accumulation active")
        store = self._pending_store if defer else None
        if defer and store is None:
            raise BlockchainError("defer=True without attach_durability")
        try:
            if extra is not None:
                acc.master.ops.extend(extra.ops)
                if store is not None:
                    # extra ops bypassed the mirrored batch: fold them
                    # into the overlay so the pending store carries the
                    # WHOLE run (reply pages included), not just the
                    # staged ledger rows
                    for k, v in extra.ops:
                        acc.master._overlay[k] = v
            if acc.master.ops:
                if store is not None:
                    run_no = store.stage(acc.master._overlay)
                    self._deferred = (run_no, acc.master,
                                      raw_base(self._base_db))
                else:
                    self._base_db.write(acc.master)
        except BaseException:
            self._accum = None
            self._end_staged_reads_locked()
            self._last = acc.base_last
            self._staging_mu.release()
            raise
        self._accum = None
        self._end_staged_reads_locked()
        if self._last and self._genesis == 0:
            self._genesis = 1
        self._staging_mu.release()
        self._notify_run(acc.notifications)
        return self._last

    def abort_accumulation(self) -> None:
        """Drop the staged run (run execution failed): the head rolls
        back to where begin_accumulation found it, nothing was written."""
        acc = self._accum
        if acc is None:
            return
        try:
            self._accum = None
            self._end_staged_reads_locked()
            self._last = acc.base_last
        finally:
            self._staging_mu.release()

    def add_blocks(self, updates_list: List["cat.BlockUpdates"]) -> int:
        """Append N blocks in ONE atomic WriteBatch (the bulk form of
        add_block — engines may override with batched hashing)."""
        if not updates_list:
            return self._last
        self.begin_accumulation()
        try:
            for bu in updates_list:
                self.add_block(bu)
        except BaseException:
            self.abort_accumulation()
            raise
        return self.end_accumulation()

    def _put_block_row(self, wb: WriteBatch, block_id: int,
                       block: "Block") -> None:
        """Tail shared by every engine's _stage_block."""
        wb.put(_bid(block_id), ser.encode_msg(block), self._F_BLOCKS)
        wb.put(_K_LAST, _bid(block_id), self._F_MISC)
        if block_id == 1:
            wb.put(_K_GENESIS, _bid(1), self._F_MISC)

    # ---- read path ----
    def get_block(self, block_id: int) -> Optional["Block"]:
        raw = self._db.get(_bid(block_id), self._F_BLOCKS)
        return ser.decode_msg(raw, Block) if raw is not None else None

    def get_raw_block(self, block_id: int) -> Optional[bytes]:
        return self._db.get(_bid(block_id), self._F_BLOCKS)

    def block_digest(self, block_id: int) -> bytes:
        if block_id == 0:
            return b""
        blk = self.get_block(block_id)
        if blk is None:
            raise BlockchainError(f"missing block {block_id}")
        return blk.digest()

    def state_digest(self) -> bytes:
        """Digest of the whole chain head — what checkpoint certificates
        sign (reference: kv_blockchain state hash). Routed head: a
        non-owner thread asking during an open speculation digests the
        committed chain, not the private overlay."""
        last = self.last_block_id
        return self.block_digest(last) if last else b"\x00" * 32

    # ---- pruning (reference: deleteBlocksUntil / pruning_handler) ----
    def delete_blocks_until(self, until_block_id: int) -> int:
        """Delete block bodies in [genesis, until); latest state is kept.
        Returns the new genesis id."""
        if until_block_id > self._last:
            raise BlockchainError("cannot prune the chain head")
        start = self._genesis if self._genesis else 1
        if until_block_id <= start:
            return self._genesis
        self._pending_barrier()   # direct write: sealed runs land first
        wb = WriteBatch()
        for bid in range(start, until_block_id):
            wb.delete(_bid(bid), self._F_BLOCKS)
        wb.put(_K_GENESIS, _bid(until_block_id), self._F_MISC)
        self._db.write(wb)
        self._genesis = until_block_id
        return self._genesis

    # ---- state-transfer staging (reference v4 st_chain) ----
    # comparisons use the routed `last_block_id`, not `self._last`: the
    # ST plane runs on the dispatcher, which must not observe a
    # speculative head bump (it would silently skip staging real blocks
    # in the speculated range)
    def _durable_db(self) -> IDBClient:
        """The writable committed-base DB. While an accumulation is open
        `self._db` is a read-only staged view; direct writes that are
        NOT part of the accumulation (ST staging rows — a disjoint
        keyspace) must target the base. Racy read of `_db` is safe:
        both branches point at a valid writable base."""
        db = self._db
        if isinstance(db, (_StagedReadView, _SpecOverlayView)):
            return self._base_db
        return db

    def add_raw_st_block(self, block_id: int, raw: bytes) -> None:
        if block_id <= self.last_block_id:
            return
        self._durable_db().put(_bid(block_id), raw, self._F_ST)

    def add_raw_st_blocks(self, blocks: Dict[int, bytes]) -> int:
        """Stage a whole verified window of raw blocks in ONE WriteBatch
        (vs one put per block) — the adoption path of the pipelined state
        transfer. Returns the number of blocks actually staged."""
        wb = WriteBatch()
        n = 0
        head = self.last_block_id
        for block_id in sorted(blocks):
            if block_id <= head:
                continue
            wb.put(_bid(block_id), blocks[block_id], self._F_ST)
            n += 1
        if n:
            self._durable_db().write(wb)
        return n

    def has_st_block(self, block_id: int) -> bool:
        return self._db.has(_bid(block_id), self._F_ST)

    # hooks for read-your-writes during batched linking; the categorized
    # engine overrides them to rebind its cached merkle trees too.
    # `_locked`: every caller holds `kvbc.staging` — lexically
    # (link_st_chain, add_blocks) or across the accumulation bracket
    # (begin/end/abort_accumulation)
    def _begin_staged_reads_locked(self, view: "_StagedReadView") -> None:
        self._base_db = self._db
        self._db = view

    def _end_staged_reads_locked(self) -> None:
        self._db = self._base_db

    def _acquire_staging_for_link(self, timeout: float = 5.0) -> bool:
        """Take the staging lock for a link segment — or DEFER when the
        current holder is a speculative accumulation (only the caller's
        own thread can resolve it; see link_st_chain docstring). A
        non-speculative holder (a normal execution run mid-commit) is
        brief: wait it out within `timeout`."""
        deadline = time.monotonic() + timeout
        while True:
            if self._staging_mu.acquire(timeout=0.05):
                return True
            acc = self._accum       # racy read; deferring is always safe
            if acc is not None and acc.speculative:
                return False
            if time.monotonic() >= deadline:
                return False

    def link_st_chain(self) -> int:
        """Adopt ALL contiguous staged blocks after the head as one
        write_group of per-block batches (one engine record per segment
        on NativeDB), re-executing their updates and verifying
        recorded digests so a Byzantine source can't inject state.

        Staging block N+1 must read state block N just wrote (parent
        block row, merkle nodes, immutable-rewrite checks), so the loop
        stages against a read-your-writes overlay and commits once per
        LINK_SEGMENT_BLOCKS-sized segment of the contiguous prefix
        instead of once per block (bounding batch memory on huge
        suffixes). On a bad staged block the verified prefix before it
        still commits, the bad row is dropped (so retries can re-fetch
        from another source instead of wedging on the same bytes), and
        the error propagates. Returns the new head.

        SPECULATION COMPOSITION: a speculative accumulation holds the
        staging lock for the whole commit-combine window, and only the
        dispatcher — the thread calling THIS function — can seal or
        abort it. Blocking here would deadlock, so the lock acquisition
        defers (returns the current head, nothing linked) whenever the
        holder is speculative; the ST manager retries on its next
        tick/window, after the speculation resolved."""
        nxt: Optional[int] = None
        prev_digest = b""
        bad: Optional[int] = None
        error: Optional[BaseException] = None

        def commit(wbs: List[WriteBatch],
                   adopted: List[Tuple[int, "cat.BlockUpdates"]]) -> None:
            if bad is not None:
                wbs.append(WriteBatch().delete(_bid(bad), self._F_ST))
            group = [wb for wb in wbs if wb.ops]
            if group:
                # per-block batches ride the group-commit apply seam:
                # ONE concatenated engine record / CRC / fsync per
                # segment on a backend that overrides write_group
                # instead of re-copying
                # every block's ops into a master batch here. The
                # durability pending view exposes no write_group on
                # purpose — unwrap to the raw base for the group apply.
                getattr(self._db, "base", self._db).write_group(group)
            if adopted:
                self._last = adopted[-1][0]
                if self._genesis == 0:
                    self._genesis = 1
                self._notify_run(adopted)

        while error is None:
            # one segment at a time under the staging lock: the
            # execution lane's accumulation shares the staged-read
            # redirect and must never interleave with linking. The head
            # snapshot happens under the lock too — an accumulation in
            # another thread moves self._db and self._last.
            if not self._acquire_staging_for_link():
                break                 # speculation open: defer, no link
            try:
                # the segment commit writes the base directly: sealed
                # runs must land before it (ST adoption drained the
                # pipeline already; this is the loud backstop)
                self._pending_barrier()
            except BaseException:
                self._staging_mu.release()
                raise
            base_db = self._db
            if nxt is None:
                nxt = self._last + 1
                prev_digest = (self.block_digest(self._last)
                               if self._last else b"")
            overlay: Dict[bytes, Optional[bytes]] = {}
            view = _StagedReadView(base_db, overlay)
            wbs: List[WriteBatch] = []
            adopted: List[Tuple[int, "cat.BlockUpdates"]] = []
            self._begin_staged_reads_locked(view)
            try:
                while len(adopted) < self.LINK_SEGMENT_BLOCKS:
                    raw = base_db.get(_bid(nxt), self._F_ST)
                    if raw is None:
                        break
                    wb = _MirroredBatch(overlay)
                    try:
                        blk = ser.decode_msg(raw, Block)
                        if blk.block_id != nxt:
                            raise BlockchainError(
                                f"staged block id mismatch: "
                                f"{blk.block_id} != {nxt}")
                        if blk.parent_digest != prev_digest:
                            raise BlockchainError(
                                f"parent digest mismatch at {nxt}")
                        updates = cat.decode_block_updates(blk.updates_blob)
                        rebuilt = self._stage_block(wb, nxt, updates)
                        if rebuilt.category_digests != blk.category_digests:
                            raise BlockchainError(
                                f"category digest mismatch at {nxt}")
                    except Exception as e:  # noqa: BLE001 — commit prefix
                        bad, error = nxt, e
                        break
                    wb.delete(_bid(nxt), self._F_ST)
                    wbs.append(wb)
                    adopted.append((nxt, updates))
                    prev_digest = blk.digest()
                    nxt += 1
            finally:
                try:
                    self._end_staged_reads_locked()
                    commit(wbs, adopted)      # still under the lock: the
                    # segment's adoption (head + db write) must land
                    # before an accumulation can slot blocks after it
                finally:
                    self._staging_mu.release()
            if len(adopted) < self.LINK_SEGMENT_BLOCKS:
                break               # ran out of staged blocks (or hit bad)
        if error is not None:
            raise error
        return self.last_block_id   # routed: a deferred link must not
        # leak the speculation's private head bump to the ST caller


class KeyValueBlockchain(BlockStoreMixin):
    _F_BLOCKS = _BLOCKS
    _F_MISC = _MISC
    _F_ST = _ST

    def __init__(self, db: IDBClient, use_device_hashing: bool = True) -> None:
        self._db = db
        self._use_device = use_device_hashing
        self._trees: Dict[str, SparseMerkleTree] = {}
        self._load_head()

    def _tree(self, category: str) -> SparseMerkleTree:
        t = self._trees.get(category)
        if t is None:
            t = SparseMerkleTree(self._db, family=f"smt.{category}".encode(),
                                 use_device=self._use_device)
            self._trees[category] = t
        return t

    # batched-link read redirection must cover the cached merkle trees:
    # a block's update reads sibling nodes the previous block in the same
    # batch may have written
    def _begin_staged_reads_locked(self, view) -> None:
        super()._begin_staged_reads_locked(view)
        for t in self._trees.values():
            t._db = view

    def _end_staged_reads_locked(self) -> None:
        super()._end_staged_reads_locked()
        # trees created during staging bound to the view; rebind all
        for t in self._trees.values():
            t._db = self._db

    def _stage_block(self, wb: WriteBatch, block_id: int,
                     updates: cat.BlockUpdates) -> Block:
        digests: Dict[str, bytes] = {}
        for name in sorted(updates.categories):
            cat_type, cu = updates.categories[name]
            digests[name] = cat.stage_category(
                self._db, wb, name, cat_type, cu, block_id, self._tree)
        parent = self.block_digest(block_id - 1) if block_id > 1 else b""
        block = Block(block_id=block_id, parent_digest=parent,
                      category_digests=digests,
                      updates_blob=cat.encode_block_updates(updates))
        self._put_block_row(wb, block_id, block)
        return block

    def add_blocks(self, updates_list: List[cat.BlockUpdates]) -> int:
        """Bulk append with cross-block merkle batching: N blocks land in
        ONE WriteBatch, and every block_merkle category's node rehashing
        for the whole run happens level-wise — one `ops/sha256` call per
        tree level spanning ALL blocks' changed nodes
        (SparseMerkleTree.update_batches) — instead of N independent
        per-block host walks. Per-block roots, archive rows, and the
        block rows themselves are byte-identical to N add_block calls."""
        if not updates_list:
            return self._last
        if len(updates_list) == 1:
            return self.add_block(updates_list[0])
        with self._staging_mu:
            if self._accum is not None:
                raise BlockchainError("add_blocks inside accumulation")
            self._pending_barrier()   # bulk ingest writes the base direct
            first = self._last + 1
            overlay: Dict[bytes, Optional[bytes]] = {}
            view = _StagedReadView(self._db, overlay)
            master = _MirroredBatch(overlay)
            self._begin_staged_reads_locked(view)
            try:
                # phase 1: all merkle categories, level-synchronous
                # across the whole run
                merkle: Dict[str, List[Dict[bytes, Optional[bytes]]]] = {}
                for i, bu in enumerate(updates_list):
                    for name, (ct, cu) in bu.categories.items():
                        if ct != cat.BLOCK_MERKLE:
                            continue
                        per_block = merkle.setdefault(
                            name, [{} for _ in updates_list])
                        per_block[i] = {
                            k: (hashlib.sha256(v).digest()
                                if v is not None else None)
                            for k, v in cu.kv.items()}
                roots: Dict[str, List[bytes]] = {}
                for name, per_block in merkle.items():
                    master.put(name.encode(), b"", cat.SMT_REGISTRY_FAMILY)
                    roots[name] = self._tree(name).update_batches(
                        per_block, batch=master, first_version=first)
                # phase 2: per-block data rows + chained block rows
                prev = (self.block_digest(self._last)
                        if self._last else b"")
                last_notified: List[Tuple[int, cat.BlockUpdates]] = []
                for i, bu in enumerate(updates_list):
                    bid = first + i
                    digests: Dict[str, bytes] = {}
                    for name in sorted(bu.categories):
                        ct, cu = bu.categories[name]
                        if ct == cat.BLOCK_MERKLE:
                            digests[name] = roots[name][i]
                            cat.stage_merkle_data(master, name, cu, bid)
                        else:
                            digests[name] = cat.stage_category(
                                self._db, master, name, ct, cu, bid,
                                self._tree)
                    block = Block(block_id=bid, parent_digest=prev,
                                  category_digests=digests,
                                  updates_blob=cat.encode_block_updates(bu))
                    self._put_block_row(master, bid, block)
                    prev = block.digest()
                    last_notified.append((bid, bu))
                # write to the BASE while the view is still installed —
                # same no-torn-window rule as end_accumulation
                self._base_db.write(master)
            finally:
                self._end_staged_reads_locked()
            self._last = first + len(updates_list) - 1
            if self._genesis == 0:
                self._genesis = 1
        self._notify_run(last_notified)
        return self._last

    # ---- categorized reads ----
    def get_latest(self, category: str, key: bytes,
                   cat_type: str = cat.VERSIONED_KV
                   ) -> Optional[Tuple[int, bytes]]:
        return cat.get_latest(self._db, category, cat_type, key)

    def get_versioned(self, category: str, key: bytes,
                      block_id: int) -> Optional[bytes]:
        return cat.get_versioned(self._db, category, key, block_id)

    def prove(self, category: str, key: bytes):
        """Merkle proof for a block_merkle-category key (latest state)."""
        return self._tree(category).prove(key)

    def merkle_root(self, category: str) -> bytes:
        return self._tree(category).root()

    # ---- versioned proofs (reference tree.cpp serves historical
    # versions; roots are anchored in each block's category digests) ----
    def prove_at(self, category: str, key: bytes, block_id: int):
        """Merkle proof for the key AS OF `block_id` (any retained
        block). Verify against `merkle_root_at(category, block_id)`."""
        return self._tree(category).prove_at(key, block_id)

    def merkle_root_at(self, category: str,
                       block_id: int) -> Optional[bytes]:
        """The category's root at a block — read from the BLOCK ROW (the
        agreed chain), not the tree, so a verifier checks proofs against
        consensus-certified state."""
        blk = self.get_block(block_id)
        if blk is not None and category in blk.category_digests:
            return blk.category_digests[category]
        # the category may not have been touched at exactly block_id:
        # its root there is the newest tree version ≤ block_id
        return self._tree(category).root_at(block_id)

    def merkle_value_hash_at(self, category: str, key: bytes,
                             block_id: int) -> Optional[bytes]:
        return self._tree(category).get_value_hash_at(key, block_id)

    def delete_blocks_until(self, until_block_id: int) -> int:
        """Prune block bodies AND the merkle archives' stale nodes: a
        proof can only be asked against a retained block's root, so
        archive rows superseded before the new genesis are garbage
        (reference stale-node GC on pruning). Categories come from the
        durable registry — the in-memory tree cache forgets categories
        untouched since the last restart."""
        genesis = super().delete_blocks_until(until_block_id)
        for name_b, _ in self._db.range_iter(cat.SMT_REGISTRY_FAMILY):
            self._tree(name_b.decode()).prune_versions(genesis)
        return genesis
