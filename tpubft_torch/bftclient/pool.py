"""Client connection pool + session multiplexer for high-throughput
gateways.

`ClientPool` rebuilds concord-bft client/client_pool/
(concord_client_pool.cpp): a fixed set of BFT client identities checked
out per request, so many application threads can have writes in flight
concurrently (each checkout owns its identity exclusively — the pool is
how the reference scales past one-outstanding-per-identity).

`SessionMux` (million-principal client plane) is the tier
ABOVE that checkout discipline: it fans MANY logical sessions over FEW
wire principals. The replica side prices everything per wire principal
— key material, verify-memo entries, reply-ring pages, admission shard
routing — so a gateway fronting 10k application sessions with 10k wire
principals pays 10k of each, while the mux pays for its handful of wire
identities and shares them. Each logical session keeps its own FIFO
request lane (in-order within the session, concurrent across sessions)
and is PINNED to one wire principal by a stable hash, so a session's
requests always carry the same sender — its replies come from one
reply ring, its signatures hit one warm verify-memo slot, and the
key-sharded admission router lands it on one worker forever. In-flight
fan-in per wire principal is capped under the replica's per-client
pending bound (clients_manager.MAX_PENDING_PER_CLIENT) so the mux can
never trip the replica-side flood gate it is riding."""
from __future__ import annotations

import itertools
import queue
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, List, Optional

from tpubft_torch.bftclient.client import BftClient


class ClientPoolBusy(Exception):
    pass


class ClientPool:
    def __init__(self, clients: List[BftClient],
                 max_workers: Optional[int] = None) -> None:
        if not clients:
            raise ValueError("empty client pool")
        self._clients: "queue.Queue[BftClient]" = queue.Queue()
        for c in clients:
            c.start()
            self._clients.put(c)
        self._all = clients
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers or len(clients),
            thread_name_prefix="client-pool")

    def submit_write(self, request: bytes, timeout_ms: Optional[int] = None,
                     pre_process: bool = False) -> Future:
        """Async write through the next free client identity; raises
        ClientPoolBusy when all identities are in flight
        (reference: SubmitRequest overload behavior)."""
        try:
            client = self._clients.get_nowait()
        except queue.Empty:
            raise ClientPoolBusy("all pool clients in flight") from None

        def run():
            try:
                return client.send_write(request, timeout_ms=timeout_ms,
                                         pre_process=pre_process)
            finally:
                self._clients.put(client)
        return self._pool.submit(run)

    def write(self, request: bytes, timeout_ms: Optional[int] = None,
              pre_process: bool = False) -> bytes:
        return self.submit_write(request, timeout_ms=timeout_ms,
                                 pre_process=pre_process).result()

    def submit_write_batch(self, requests: List[bytes],
                           timeout_ms: Optional[int] = None,
                           pre_process: bool = False) -> Future:
        """Async BATCH through the next free identity — one wire message
        carrying every element (ClientBatchRequestMsg); the gateway-side
        analog of the reference pool's client batching flag
        (concord_client_pool batching configuration)."""
        try:
            client = self._clients.get_nowait()
        except queue.Empty:
            raise ClientPoolBusy("all pool clients in flight") from None

        def run():
            try:
                return client.send_write_batch(requests,
                                               timeout_ms=timeout_ms,
                                               pre_process=pre_process)
            finally:
                self._clients.put(client)
        return self._pool.submit(run)

    def read(self, request: bytes,
             timeout_ms: Optional[int] = None) -> bytes:
        """Read through a checked-out identity (same discipline as
        writes — reads also occupy the identity's in-flight slot)."""
        try:
            client = self._clients.get_nowait()
        except queue.Empty:
            raise ClientPoolBusy("all pool clients in flight") from None
        try:
            return client.send_read(request, timeout_ms=timeout_ms)
        finally:
            self._clients.put(client)

    @property
    def size(self) -> int:
        return len(self._all)

    def stop(self) -> None:
        self._pool.shutdown(wait=True)
        for c in self._all:
            c.stop()


def _session_shard(session_id: int, shards: int) -> int:
    """Stable wire-principal pin for a logical session — the SAME
    Knuth multiplicative mix the replica-side admission router uses
    (admission.shard_of), so a session's placement is deterministic
    across gateway restarts and unrelated to session-id striping."""
    return ((session_id * 2654435761) & 0xFFFFFFFF) % shards


class MuxSession:
    """One logical session over a shared wire principal.

    The session's lane lock serializes ITS requests (per-session FIFO:
    request k+1 is not sent until request k resolved — the ordering an
    application session expects), while the wire client runs many
    sessions' requests concurrently, each on its own req_seq allocated
    from the principal's monotone counter. At-most-once therefore rides
    the wire principal's reply ring exactly as if the session owned the
    principal; what the session gives up is a PRIVATE seq space, which
    only mattered for cross-session ordering nobody is promised."""

    __slots__ = ("session_id", "_client", "_sem", "_lane", "_mux")

    def __init__(self, mux: "SessionMux", session_id: int,
                 client: BftClient, sem: threading.BoundedSemaphore):
        self._mux = mux
        self.session_id = session_id
        self._client = client
        self._sem = sem
        self._lane = threading.Lock()

    @property
    def wire_client_id(self) -> int:
        return self._client.cfg.client_id

    def write(self, request: bytes, timeout_ms: Optional[int] = None,
              pre_process: bool = False) -> bytes:
        with self._lane, self._sem:
            return self._client.send_write(request, timeout_ms=timeout_ms,
                                           pre_process=pre_process)

    def read(self, request: bytes,
             timeout_ms: Optional[int] = None) -> bytes:
        with self._lane, self._sem:
            return self._client.send_read(request, timeout_ms=timeout_ms)

    def write_batch(self, requests: List[bytes],
                    timeout_ms: Optional[int] = None,
                    pre_process: bool = False) -> List[bytes]:
        """Batch on the session's lane. Rides the wire client's
        one-outstanding-batch discipline (BftClient._batch_lock), so
        concurrent sessions' batches on one principal serialize there —
        their single writes do not."""
        with self._lane, self._sem:
            return self._client.send_write_batch(
                requests, timeout_ms=timeout_ms, pre_process=pre_process)


class SessionMux:
    """Fan many logical sessions over few wire principals (see module
    docstring). `session()` hands out session handles; sessions with
    the same id always land the same wire principal."""

    def __init__(self, clients: List[BftClient],
                 max_inflight_per_client: int = 0) -> None:
        if not clients:
            raise ValueError("empty session mux")
        if max_inflight_per_client <= 0:
            # stay under the replica's per-principal pending bound: a
            # full fan-in from one principal must not trip the
            # dispatcher's client-flood gate
            from tpubft_torch.consensus.clients_manager import \
                MAX_PENDING_PER_CLIENT
            max_inflight_per_client = max(1, MAX_PENDING_PER_CLIENT // 2)
        self._clients = list(clients)
        for c in self._clients:
            c.start()
        self._sems = [threading.BoundedSemaphore(max_inflight_per_client)
                      for _ in self._clients]
        self._auto_ids = itertools.count()
        self._mu = threading.Lock()
        self._sessions: dict = {}
        self.max_inflight_per_client = max_inflight_per_client

    def session(self, session_id: Optional[int] = None) -> MuxSession:
        """The handle for `session_id` (allocated when None). Handles
        are cached per id: the same logical session keeps ONE FIFO lane
        no matter how many times it is looked up."""
        with self._mu:
            if session_id is None:
                session_id = next(self._auto_ids)
            s = self._sessions.get(session_id)
            if s is None:
                idx = _session_shard(session_id, len(self._clients))
                s = MuxSession(self, session_id, self._clients[idx],
                               self._sems[idx])
                self._sessions[session_id] = s
            return s

    @property
    def wire_principals(self) -> int:
        return len(self._clients)

    @property
    def sessions_open(self) -> int:
        with self._mu:
            return len(self._sessions)

    def stop(self) -> None:
        for c in self._clients:
            c.stop()
