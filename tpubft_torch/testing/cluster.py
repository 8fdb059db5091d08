"""In-process multi-replica cluster over the loopback bus.

The unit/integration-test equivalent of the reference's in-process
multi-node fixtures (client/bftclient fake_comm.h quorum simulations +
tests/simpleTest in-proc mode): n replicas + clients share one LoopbackBus,
so byzantine hooks (drop/mutate) apply to the whole cluster.

Port of tpubft/testing/cluster.py. It diverges from the reference in
three places, each marked where it sits:

  * a handler with a blockchain is refused: its state-transfer manager
    and shared ledger/pages db come with the ledger replica (ROADMAP
    A.3), so the cluster never imports the ledger for a counter handler;
  * the reconfiguration dispatcher is not wired, and there is no
    operator client (ROADMAP A.9): RECONFIG requests execute to an empty
    reply, as on a reference replica with no dispatcher attached;
  * replicas are built with the port's config, whose planes that are
    not ported yet (durability pipeline, autotuner) must be turned off
    through `cfg_overrides`.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from tpubft_torch.bftclient import BftClient, ClientConfig
from tpubft_torch.comm.loopback import LoopbackBus
from tpubft_torch.consensus.keys import ClusterKeys
from tpubft_torch.consensus.persistent import PersistentStorage
from tpubft_torch.consensus.replica import IRequestsHandler, Replica
from tpubft_torch.utils.config import ReplicaConfig
from tpubft_torch.utils.metrics import Aggregator


class InProcessCluster:
    def __init__(self, f: int = 1, c: int = 0, num_clients: int = 2,
                 handler_factory: Optional[Callable[[], IRequestsHandler]] = None,
                 cfg_overrides: Optional[dict] = None,
                 storage_factory: Optional[Callable[[int], PersistentStorage]] = None,
                 seed: bytes = b"tpubft-test-cluster",
                 byzantine: Optional[Dict[int, str]] = None):
        from tpubft_torch.apps.counter import CounterHandler
        self.handler_factory = handler_factory or CounterHandler
        base_cfg = ReplicaConfig(f_val=f, c_val=c,
                                 num_of_client_proxies=num_clients,
                                 **(cfg_overrides or {}))
        self.n = base_cfg.n_val
        # client ids start after any read-only replicas (reference id
        # convention: replicas, RO replicas, then clients)
        self.first_client_id = base_cfg.n_val + base_cfg.num_ro_replicas
        self.bus = LoopbackBus()
        self.keys = ClusterKeys.generate(base_cfg, num_clients, seed=seed)
        self.aggregators: Dict[int, Aggregator] = {}
        self.handlers: Dict[int, IRequestsHandler] = {}
        self.replicas: Dict[int, Replica] = {}
        self.storage_factory = storage_factory
        # replica_id -> byzantine strategy name (testing/byzantine.py):
        # that replica's transport is wrapped exactly like the tester
        # replica's --strategy flag, signer in hand for re-signing
        # strategies (equivocate)
        self.byzantine = dict(byzantine or {})
        self._pages_dbs: Dict[int, object] = {}
        self._cfg_overrides = cfg_overrides or {}
        self._num_clients = num_clients
        self.f, self.c = f, c
        for r in range(self.n):
            self._make_replica(r)
        self.clients: Dict[int, BftClient] = {}

    def _make_replica(self, r: int) -> Replica:
        cfg = ReplicaConfig(replica_id=r, f_val=self.f, c_val=self.c,
                            num_of_client_proxies=self._num_clients,
                            **self._cfg_overrides)
        agg = self.aggregators[r] = Aggregator()
        try:
            handler = self.handler_factory(r)   # id-aware factories
        except TypeError:
            handler = self.handler_factory()
        self.handlers[r] = handler
        storage = (self.storage_factory(r) if self.storage_factory else None)
        # reserved pages survive an in-process restart (deployed replicas
        # keep them in the ledger db): restart/crash tests must exercise
        # the page reload paths, not silently start from empty pages.
        # Blockchain-backed handlers share the LEDGER's db — the same
        # deliberate wiring as KvbcReplica, so the lane folds reply
        # pages into the run batch (atomic apply, and the durability
        # pipeline's deferred-seal path stays exercised in-process);
        # page persistence across restart then rides the handler db.
        from tpubft_torch.consensus.reserved_pages import ReservedPages
        if getattr(handler, "blockchain", None) is not None:
            # Port divergence (reference cluster.py:75-82, 97-104): the
            # ledger's shared pages db (raw_base) and its state-transfer
            # manager come with the ledger replica
            raise NotImplementedError(
                "InProcessCluster: blockchain-backed handlers need state "
                "transfer, which is not ported to tpubft_torch yet "
                "(ROADMAP A.3)")
        pages = self._pages_dbs.get(r)
        if pages is None:
            from tpubft_torch.storage.memorydb import MemoryDB
            pages = self._pages_dbs[r] = ReservedPages(MemoryDB())
        node_keys = self.keys.for_node(r)
        comm = self.bus.create(r)
        strategy = self.byzantine.get(r)
        if strategy:
            from tpubft_torch.testing.byzantine import strategy_wrapper
            comm = strategy_wrapper(strategy)(
                comm, signer=node_keys.my_signer())
        rep = Replica(cfg, node_keys, comm,
                      handler, storage=storage, aggregator=agg,
                      reserved_pages=pages)
        # Port divergence (reference cluster.py:121-122): no
        # reconfiguration dispatcher is attached (ROADMAP A.9)
        self.replicas[r] = rep
        return rep

    def start(self) -> "InProcessCluster":
        for rep in self.replicas.values():
            rep.start()
        return self

    def stop(self) -> None:
        for cl in self.clients.values():
            cl.stop()
        for rep in self.replicas.values():
            rep.stop()
        self.bus.shutdown()

    # Port divergence (reference cluster.py:124-137): operator_client
    # needs the reconfiguration plane (ROADMAP A.9) and is left out.

    def client(self, idx: int = 0, **cfg_kw) -> BftClient:
        client_id = self.first_client_id + idx
        cl = self.clients.get(client_id)
        if cl is None:
            cfg = ClientConfig(client_id=client_id, f_val=self.f,
                               c_val=self.c, **cfg_kw)
            cl = BftClient(cfg, self.keys.for_node(client_id),
                           self.bus.create(client_id))
            self.clients[client_id] = cl
        return cl

    # ---- fault injection ----
    def kill(self, replica_id: int) -> None:
        self.replicas[replica_id].stop()

    def restart(self, replica_id: int) -> Replica:
        """Stop + recreate from persistent storage (crash recovery)."""
        self.kill(replica_id)
        rep = self._make_replica(replica_id)
        rep.start()
        return rep

    def crash(self, replica_id: int) -> Replica:
        """Crash-recover WITHOUT a clean stop: the old instance is
        abandoned exactly as it stands (its threads may be parked at a
        crashpoint seam), the loopback endpoint is rebound to a new
        replica restored from persistent storage — the in-process analog
        of SIGKILL + restart. Only state that reached storage (or the
        surviving reserved-pages db) is recovered."""
        old = self.replicas.pop(replica_id, None)  # no stop(): it crashed
        if old is not None:
            # mute the abandoned instance's transport (flag flip only —
            # no joins, no clean shutdown): a SIGKILLed process sends
            # nothing, and an old thread that is merely parked (or still
            # running) must not keep emitting with the recovered
            # replica's identity — that would be accidental equivocation
            old.comm.stop()
        rep = self._make_replica(replica_id)      # bus.create() rebinds
        rep.start()
        return rep

    def metric(self, replica_id: int, kind: str, name: str,
               component: str = "replica"):
        return self.aggregators[replica_id].get(component, kind, name)

    def __enter__(self) -> "InProcessCluster":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
