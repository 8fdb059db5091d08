"""In-process message bus for multi-replica tests.

Plays the role of the reference's client/bftclient/include/bftclient/
fake_comm.h (in-process ICommunication delivering to behavior callbacks) and
of tests/simpleKVBC/TesterReplica/WrapCommunication.cpp (drop/mutate hooks
for byzantine strategies).

Delivery is performed on a single bus thread, which gives tests
deterministic per-message ordering per destination. NOTE: real transports
do NOT guarantee serialized upcalls (TCP delivers from one reader thread
per peer) — receivers must be thread-safe; the replica's incoming-message
queue (the reference's IncomingMsgsStorage) provides the serialization.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Optional

from tpubft_torch.utils.racecheck import make_lock
from tpubft_torch.comm.interfaces import (ConnectionStatus, ICommunication,
                                    IReceiver, NodeNum)

# hook(sender, dest, data) -> data' | None (None = drop the message)
Hook = Callable[[NodeNum, NodeNum, bytes], Optional[bytes]]


class LoopbackBus:
    """Shared medium connecting LoopbackCommunication endpoints."""

    def __init__(self) -> None:
        self._endpoints: Dict[NodeNum, "LoopbackCommunication"] = {}
        self._hooks: list[Hook] = []
        self._q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = make_lock("loopback_bus")
        self._closed = False

    def create(self, node: NodeNum) -> "LoopbackCommunication":
        comm = LoopbackCommunication(self, node)
        with self._lock:
            self._endpoints[node] = comm
        return comm

    def add_hook(self, hook: Hook) -> None:
        """Byzantine/fault-injection hook applied to every message in order;
        returning None drops it, returning bytes replaces the payload."""
        self._hooks.append(hook)

    def post(self, sender: NodeNum, dest: NodeNum, data: bytes) -> None:
        # lock-free fast path: post() runs for EVERY message in the
        # cluster, and the bus lock here was a measurable global hot spot
        # under load; the lock is only taken when the pump looks dead.
        # _closed guards the shutdown race: a post() that observed a live
        # thread while the None sentinel was already queued would be
        # silently dropped, and a post() after shutdown would resurrect
        # the pump — both drop the message instead.
        if self._closed:
            return
        t = self._thread
        if t is None or not t.is_alive():
            self._ensure_thread()
        self._q.put((sender, dest, data))

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._closed:
                return
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._pump, name="loopback-bus", daemon=True)
                self._thread.start()

    def _pump(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            sender, dest, data = item
            for hook in self._hooks:
                out = hook(sender, dest, data)
                if out is None:
                    data = None
                    break
                data = out
            if data is None:
                continue
            with self._lock:
                ep = self._endpoints.get(dest)
            if ep is not None:
                ep._deliver(sender, data)

    def shutdown(self) -> None:
        with self._lock:
            self._closed = True
            t = self._thread
            self._thread = None
        if t is not None and t.is_alive():
            self._q.put(None)
            t.join(timeout=5)


class LoopbackCommunication(ICommunication):
    def __init__(self, bus: LoopbackBus, node: NodeNum):
        self._bus = bus
        self._node = node
        self._receiver: Optional[IReceiver] = None
        self._running = False

    def start(self, receiver: IReceiver) -> None:
        self._receiver = receiver
        self._running = True

    def stop(self) -> None:
        self._running = False

    def is_running(self) -> bool:
        return self._running

    def send(self, dest: NodeNum, data: bytes) -> None:
        if self._running:
            self._bus.post(self._node, dest, data)

    def get_connection_status(self, node: NodeNum) -> ConnectionStatus:
        return ConnectionStatus.CONNECTED

    def _deliver(self, sender: NodeNum, data: bytes) -> None:
        if self._running and self._receiver is not None:
            self._receiver.on_new_message(sender, data)
