"""Read-only replica: state-transfer-only node with ledger archival
(port of tpubft/kvbc/readonly.py).

Rebuild of the reference's ReadOnlyReplica
(concord-bft bftengine/src/bftengine/ReadOnlyReplica.cpp on top of
ReplicaForStateTransfer.cpp) plus its object-store archival duty
(storage/src/s3/, tested by bftengine/tests/s3): a node with id in
[n, n+num_ro) that

  * holds NO voting keys and signs nothing — it cannot affect safety;
  * listens to the cluster's signed CheckpointMsgs; f+1 matching
    (seq, state digest) pairs form a TRUST ANCHOR (at least one honest
    signer vouches), which triggers/targets state transfer;
  * fetches blocks + reserved pages through the same BCStateTran-role
    StateTransferManager the live replicas use (destination side only);
  * archives every fetched block to an object store with per-object
    integrity digests (ledger backup/DR: the reference's RO replica
    writes the chain to S3);
  * serves READ_ONLY client requests from its local state — a cheap
    read offload that never touches consensus.

The message surface is deliberately tiny: CheckpointMsg,
StateTransferMsg, read-only ClientRequestMsg. Everything else is
dropped (a byzantine peer cannot make an RO replica do anything but
bounded verification work).

Port divergence (reference readonly.py:80-81, apps/ro_replica.py:105,
which hash every fetched block on the host): the replica takes a
`device`. On a CUDA device its ledger and its state transfer route their
digests as a live replica's do on the card (kvbc/replica.py): each
fetched window of `st_device_digest_threshold` blocks or more is
digested in one SHA-256 launch, with no host fallback. On the CPU it
hashes on the host, as the reference does. SHA-256 is SHA-256: the
staged chain, the archive objects and their digests are the same bytes
either way.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Set, Tuple

from tpubft_torch import device as _device
from tpubft_torch.comm.interfaces import ICommunication, IReceiver
from tpubft_torch.consensus import messages as m
from tpubft_torch.consensus.incoming import Dispatcher, IncomingMsgsStorage
from tpubft_torch.consensus.keys import ClusterKeys
from tpubft_torch.consensus.replicas_info import ReplicasInfo
from tpubft_torch.consensus.reserved_pages import ReservedPages
from tpubft_torch.consensus.sig_manager import SigManager
from tpubft_torch.kvbc.blockchain import KeyValueBlockchain
from tpubft_torch.statetransfer import StateTransferManager
from tpubft_torch.statetransfer.manager import StConfig
from tpubft_torch.storage.interfaces import IDBClient
from tpubft_torch.storage.memorydb import MemoryDB
from tpubft_torch.storage.objectstore import IObjectStore
from tpubft_torch.utils.config import ReplicaConfig
from tpubft_torch.utils.logging import get_logger, mdc_scope
from tpubft_torch.utils.metrics import Aggregator, Component

log = get_logger("ro_replica")

_K_ARCHIVED = b"ro.archived_to"


def archive_key(block_id: int) -> str:
    """Object-store key for an archived raw block (zero-padded so
    lexicographic list order == block order)."""
    return f"blocks/{block_id:020d}"


def digest_key(block_id: int) -> str:
    return f"digests/{block_id:020d}"


class ReadOnlyReplica(IReceiver):
    def __init__(self, cfg: ReplicaConfig, keys: ClusterKeys,
                 comm: ICommunication,
                 db: Optional[IDBClient] = None,
                 object_store: Optional[IObjectStore] = None,
                 handler_factory=None,
                 aggregator: Optional[Aggregator] = None,
                 st_cfg: Optional[StConfig] = None,
                 device: Optional[_device.DeviceLike] = None) -> None:
        self.cfg = cfg
        self.id = cfg.replica_id
        self.info = ReplicasInfo.from_config(cfg)
        assert self.info.n <= self.id < self.info.first_client_id, \
            "read-only replica ids live in [n, n + num_ro_replicas)"
        self.comm = comm
        self.db = db or MemoryDB()
        self.store = object_store
        self.aggregator = aggregator or Aggregator()
        # Port divergence (see the module docstring): digests on the card
        # where the replica runs on one. The transfer follows the
        # ledger's choice unless st_cfg sets use_device_digests.
        self.device = _device.resolve(device)
        self.blockchain = KeyValueBlockchain(
            self.db, use_device_hashing=self.device.type == "cuda")
        if st_cfg is None:
            st_cfg = StConfig(
                device_digest_threshold=cfg.st_device_digest_threshold)
        if handler_factory is None:
            from tpubft_torch.apps.skvbc import SkvbcHandler
            handler_factory = SkvbcHandler
        self.handler = handler_factory(self.blockchain)
        # verification only — an RO replica never signs anything
        self.sig = SigManager(keys, self.aggregator,
                              grace_seq_window=cfg.work_window_size)

        self.pages = ReservedPages(self.db)
        self.state_transfer = StateTransferManager(
            self.id, self.blockchain, st_cfg,
            reserved_pages=self.pages, aggregator=self.aggregator)
        self.state_transfer.bind(
            send_fn=lambda dest, payload: self.comm.send(
                dest, m.StateTransferMsg(sender_id=self.id,
                                         payload=payload).pack()),
            complete_fn=self._on_transfer_complete,
            replica_ids=list(self.info.replica_ids), f_val=cfg.f_val)

        # checkpoint trust anchors: seq -> (state, pages digest) -> voters.
        # Bounded like the live replica's checkpoint store: one MONOTONE
        # slot per sender (a key can only vote forward) and a cap on
        # distinct candidate seqs / certified anchors — a single byzantine
        # key can never grow memory without bound
        self._ck_votes: Dict[int, Dict[Tuple[bytes, bytes], Set[int]]] = {}
        self._ck_sender_latest: Dict[int, int] = {}
        self._certified: Dict[int, Tuple[bytes, bytes]] = {}
        self.last_anchor = 0
        self._last_anchor_time = 0.0     # monotonic time of last anchor
        self._last_ask = 0.0

        self.incoming = IncomingMsgsStorage()
        self.dispatcher = Dispatcher(self.incoming,
                                     name=f"ro-replica-{self.id}",
                                     thread_mdc={"r": self.id})
        self.dispatcher.set_external_handler(self._on_external)
        self.dispatcher.add_timer(st_cfg.retry_timeout_s / 2, self._tick)

        self.metrics = Component("ro_replica", self.aggregator)
        self.m_anchor = self.metrics.register_gauge("last_anchor_seq")
        self.m_blocks = self.metrics.register_gauge("last_block")
        self.m_archived = self.metrics.register_gauge("archived_to")
        # port addition: the checkpoint seq of the last completed
        # transfer, so an observer can tell the archive reached the
        # anchor (last_anchor_seq moves when a transfer starts)
        self.m_transferred = self.metrics.register_gauge("transferred_seq")
        self.m_reads = self.metrics.register_counter("served_reads")
        self._running = False

    # ---- lifecycle ----
    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self.comm.start(self)
        self.dispatcher.start()
        with mdc_scope(r=self.id):
            log.info("read-only replica up (n=%d, archived_to=%d)",
                     self.info.n, self.archived_to)

    def stop(self) -> None:
        self._running = False
        self.dispatcher.stop()
        self.comm.stop()

    # ---- transport upcall ----
    def on_new_message(self, sender: int, data: bytes) -> None:
        self.incoming.push_external(sender, data)

    # ---- dispatch (RO surface: checkpoints, ST, read-only requests) ----
    def _on_external(self, sender: int, raw: bytes) -> None:
        try:
            msg = m.unpack(raw)
        except m.MsgError:
            return
        if isinstance(msg, m.CheckpointMsg):
            if self.info.is_replica(msg.sender_id):
                self._on_checkpoint(msg)
        elif isinstance(msg, m.StateTransferMsg):
            if self.info.is_replica(sender):
                self.state_transfer.handle_message(sender, msg.payload)
        elif isinstance(msg, m.ClientRequestMsg):
            self._on_client_request(sender, msg)

    def _on_checkpoint(self, ck: m.CheckpointMsg) -> None:
        """f+1 matching signed checkpoint digests = a trust anchor the
        fetch can be validated against (the RO replica trusts no single
        peer; reference RO replica waits for a checkpoint certificate)."""
        if ck.seq_num <= self.last_anchor:
            return
        if ck.seq_num % self.cfg.checkpoint_window_size != 0:
            return
        # monotone per sender BEFORE the signature check: bounds both
        # memory and verification work under replayed/duplicate spam
        if ck.seq_num <= self._ck_sender_latest.get(ck.sender_id, 0):
            return
        if not self.sig.verify(ck.sender_id, ck.signed_payload(),
                               ck.signature, seq=ck.seq_num):
            return
        self._ck_sender_latest[ck.sender_id] = ck.seq_num
        if ck.seq_num not in self._ck_votes and len(self._ck_votes) >= 8:
            del self._ck_votes[min(self._ck_votes)]
        digests = self._ck_votes.setdefault(ck.seq_num, {})
        # the anchor binds BOTH digests the summaries will be checked
        # against (state + reserved pages), like the live replicas'
        # certified_checkpoints map
        pair = (ck.state_digest, ck.res_pages_digest)
        voters = digests.setdefault(pair, set())
        voters.add(ck.sender_id)
        if len(voters) < self.info.st_anchor_quorum:
            return
        self.last_anchor = ck.seq_num
        self._last_anchor_time = time.monotonic()
        self.m_anchor.set(ck.seq_num)
        self._certified[ck.seq_num] = pair
        if len(self._certified) > 32:
            del self._certified[min(self._certified)]
        for s in [s for s in self._ck_votes if s <= ck.seq_num]:
            del self._ck_votes[s]
        log.info("checkpoint anchor at seq %d: fetching", ck.seq_num)
        self.state_transfer.start_collecting(ck.seq_num,
                                             dict(self._certified))

    def _on_client_request(self, sender: int, req: m.ClientRequestMsg) -> None:
        """READ ONLY serving — the whole point of the replica variant:
        reads scale out without touching the voting set."""
        if not req.flags & m.RequestFlag.READ_ONLY:
            return
        if req.flags & (m.RequestFlag.RECONFIG | m.RequestFlag.INTERNAL):
            return
        if not self.info.is_client(req.sender_id) \
                or req.sender_id != sender:
            return
        if not self.sig.verify(req.sender_id, req.signed_payload(),
                               req.signature):
            return
        payload = self.handler.read(req.sender_id, req.request)
        self.m_reads.inc()
        self.comm.send(sender, m.ClientReplyMsg(
            sender_id=self.id, req_seq_num=req.req_seq_num,
            # "unknown": an RO replica tracks no view. Out-of-range on
            # purpose — clients must never take this as a primary hint
            # (their 0 <= x < n filter rejects it)
            current_primary=0xFFFFFFFF, reply=payload,
            replica_specific_info=b"ro").pack())

    # ---- state transfer completion -> archival ----
    @property
    def archived_to(self) -> int:
        raw = self.db.get(_K_ARCHIVED)
        return int.from_bytes(raw, "big") if raw else 0

    def _on_transfer_complete(self, seq: int, state_digest: bytes) -> None:
        log.info("state transfer complete at checkpoint %d (blocks=%d)",
                 seq, self.blockchain.last_block_id)
        self.m_blocks.set(self.blockchain.last_block_id)
        # the cluster may have rotated signing keys since we anchored:
        # adopt them from the fetched reserved pages, or every future
        # CheckpointMsg from a rotated replica would fail verification
        # (the live replica's post-ST key_exchange.load_from_pages())
        from tpubft_torch.consensus.internal import KeyExchangeManager
        from tpubft_torch.consensus.reserved_pages import ReservedPagesClient
        keyex = ReservedPagesClient(self.pages, KeyExchangeManager.CATEGORY)
        for r in self.info.replica_ids:
            pk = keyex.load(index=r)
            if pk:
                self.sig.set_replica_key(r, pk, rotation_seq=seq)
        self._archive_new_blocks()
        self.m_transferred.set(seq)
        # an anchor that formed while this fetch was in flight would
        # otherwise strand us one checkpoint behind until new traffic
        if self.last_anchor > seq:
            self.state_transfer.start_collecting(self.last_anchor,
                                                 dict(self._certified))

    def _archive_new_blocks(self) -> None:
        """Append newly fetched blocks to the object store. Every object
        carries its own integrity digest; the ledger digest chain is
        additionally stored so an auditor can verify linkage offline."""
        if self.store is None:
            return
        start = self.archived_to + 1
        last = self.blockchain.last_block_id
        for bid in range(start, last + 1):
            raw = self.blockchain.get_raw_block(bid)
            if raw is None:
                break
            self.store.put(archive_key(bid), raw)
            self.store.put(digest_key(bid),
                           self.blockchain.block_digest(bid))
            self.db.put(_K_ARCHIVED, bid.to_bytes(8, "big"))
        self.m_archived.set(self.archived_to)

    # ---- periodic ----
    ASK_CHECKPOINT_PERIOD_S = 10.0

    def _tick(self) -> None:
        if not self._running:
            return
        self.state_transfer.tick()
        # poll for checkpoints when anchors aren't arriving on their own
        # (reference ReadOnlyReplica sends AskForCheckpointMsg on a
        # timer): a late joiner must not wait a whole checkpoint window
        # for the cluster's next broadcast
        now = time.monotonic()
        if now - self._last_anchor_time > self.ASK_CHECKPOINT_PERIOD_S \
                and now - self._last_ask > self.ASK_CHECKPOINT_PERIOD_S:
            self._last_ask = now
            ask = m.AskForCheckpointMsg(sender_id=self.id).pack()
            for r in range(self.info.n):
                self.comm.send(r, ask)

    # ---- audit helper (reference object_store integrity check tool) ----
    def verify_archive(self) -> Tuple[int, int]:
        """(verified_blocks, failures): re-read every archived object and
        check integrity + digest linkage against the stored digests."""
        if self.store is None:
            return (0, 0)
        import hashlib
        ok = bad = 0
        for key in self.store.list("blocks/"):
            bid = int(key.split("/")[1])
            raw = self.store.get(key)
            dig = self.store.get(digest_key(bid))
            if raw is None or dig is None:
                bad += 1
            elif hashlib.sha256(raw).digest() != dig:
                # Block.digest() is sha256 over the serialized block
                bad += 1
            else:
                ok += 1
        return ok, bad
