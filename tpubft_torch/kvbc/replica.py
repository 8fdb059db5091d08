"""KvbcReplica — the process object wiring consensus + ledger + storage
(port of tpubft/kvbc/replica.py).

Rebuild of `concord::kvbc::Replica` (concord-bft kvbc/include/Replica.h:42,
src/Replica.cpp): owns the DB backend, the categorized blockchain, the
consensus engine (whose persistent metadata lands in the same DB via
DBPersistentStorage), and the command handler that executes ordered
requests against the blockchain. The same inversion as the reference:
this object sits *above* the consensus engine it creates while also
implementing its execution upcall.

The port diverges from the reference in two places, each marked where
it sits: device hashing follows `crypto_backend == "cuda"`, and no
reconfiguration dispatcher is attached (A.9). A thin-replica port
attaches the read tier's server as the reference does.
"""
from __future__ import annotations

from typing import Optional

from tpubft_torch.comm.interfaces import ICommunication
from tpubft_torch.consensus.keys import ClusterKeys
from tpubft_torch.consensus.replica import IRequestsHandler, Replica
from tpubft_torch.kvbc.blockchain import KeyValueBlockchain
from tpubft_torch.storage.factory import open_db
from tpubft_torch.storage.metadata import DBPersistentStorage
from tpubft_torch.utils.config import ReplicaConfig
from tpubft_torch.utils.metrics import Aggregator


class KvbcReplica:
    def __init__(self, cfg: ReplicaConfig, keys: ClusterKeys,
                 comm: ICommunication,
                 db_path: Optional[str] = None,
                 handler_factory=None,
                 aggregator: Optional[Aggregator] = None,
                 use_device_hashing: Optional[bool] = None,
                 thin_replica_port: Optional[int] = None) -> None:
        from tpubft_torch.storage.metadata import CONSENSUS_META_FAMILIES
        self.db = open_db(
            db_path,
            sync_writes=getattr(cfg, "db_sync_writes", False),
            sync_families=(CONSENSUS_META_FAMILIES
                           if getattr(cfg, "db_sync_metadata", True)
                           else ()))
        from tpubft_torch.kvbc import create_blockchain
        # resolve "auto" BEFORE the hashing decision below reads it (the
        # consensus Replica performs the same write-back; both orderings
        # must agree)
        from tpubft_torch.crypto.backend import resolve_backend
        cfg.crypto_backend = resolve_backend(cfg.crypto_backend)
        if use_device_hashing is None:
            # device-backed crypto implies device-backed bulk hashing —
            # Merkle levels and block digests ride the batched SHA-256
            # kernel alongside the signature kernels. Port divergence
            # (reference replica.py:68, `== "tpu"`): the port's device
            # backend is "cuda".
            use_device_hashing = cfg.crypto_backend == "cuda"
        self.blockchain = create_blockchain(
            self.db, version=getattr(cfg, "kvbc_version", "categorized"),
            use_device_hashing=use_device_hashing)
        if handler_factory is None:
            from tpubft_torch.apps.skvbc import SkvbcHandler
            handler_factory = SkvbcHandler
        self.handler: IRequestsHandler = handler_factory(self.blockchain)
        from tpubft_torch.consensus.reserved_pages import ReservedPages
        # pages share the LEDGER's DB on purpose: the execution lane
        # folds each run's reply-ring/marker pages into the ledger's
        # accumulated WriteBatch (ReservedPages.shares_db), so a run's
        # durable apply is atomic across blocks and at-most-once state —
        # a crash can never see blocks without their reply markers or
        # vice versa. Splitting pages into their own DB silently
        # downgrades that to two ordered batches.
        pages = ReservedPages(self.db)
        if thin_replica_port is not None:
            # the CLI port must win over cfg.thin_replica_port even
            # when thin_replica_enabled makes the Replica constructor
            # attach the server itself
            cfg.thin_replica_port = thin_replica_port
        self.replica = Replica(cfg, keys, comm, self.handler,
                               storage=DBPersistentStorage(self.db),
                               aggregator=aggregator,
                               reserved_pages=pages)
        from tpubft_torch.statetransfer import StateTransferManager
        from tpubft_torch.statetransfer.manager import StConfig
        self.state_transfer = StateTransferManager(
            cfg.replica_id, self.blockchain,
            StConfig.for_replica(cfg, use_device_digests=use_device_hashing),
            reserved_pages=pages, aggregator=aggregator)
        self.replica.set_state_transfer(self.state_transfer)
        # Port divergence (reference replica.py:105-110): no
        # reconfiguration dispatcher is attached (ROADMAP A.9); RECONFIG
        # requests execute to an empty reply, as in the port's cluster.

        # thin-replica read tier: the consensus Replica owns the server
        # (commit-stream feed + signed checkpoint anchor + metrics live
        # there). The explicit port arg (process CLI --trs-port) wins:
        # it is written into cfg BEFORE the Replica constructor runs
        # (see above), so a thin_replica_enabled config attaches at the
        # CLI port; without the knob, attach explicitly here.
        if thin_replica_port is not None \
                and self.replica.thin_replica is None:
            self.replica.attach_thin_replica(port=thin_replica_port)
        self.thin_replica_server = self.replica.thin_replica

    def start(self) -> None:
        self.replica.start()

    def stop(self) -> None:
        self.replica.stop()
        self.db.close()
