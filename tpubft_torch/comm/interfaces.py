"""Abstract transport interface.

Mirrors the reference's communication/include/communication/ICommunication.hpp:
  ICommunication (:42-79) — start/stop, ownership-taking send(NodeNum, bytes),
  broadcast send(set<NodeNum>, bytes), connection status query.
  IReceiver (:26-40) — onNewMessage / onConnectionStatusChanged callbacks.

Node numbering follows the reference convention (ReplicasInfo): replica ids
are 0..n-1, read-only replicas next, then client ids above those.
"""
from __future__ import annotations

import abc
import enum
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Tuple

NodeNum = int

MAX_MESSAGE_SIZE = 64 * 1024  # reference default maxExternalMessageSize


class ConnectionStatus(enum.Enum):
    UNKNOWN = 0
    CONNECTED = 1
    DISCONNECTED = 2


class IReceiver(abc.ABC):
    """Upcall interface; invoked from the transport's receive thread."""

    @abc.abstractmethod
    def on_new_message(self, sender: NodeNum, data: bytes) -> None: ...

    def on_new_messages(self, msgs: "Iterable[Tuple[NodeNum, bytes]]") \
            -> None:
        """Burst upcall: a batch-receiving transport (udp recvmmsg)
        hands one drain's worth of datagrams in a single call, so a
        receiver with its own admission queue can enqueue the burst
        without per-message overhead. Default: per-message delivery."""
        for sender, data in msgs:
            self.on_new_message(sender, data)

    def on_connection_status_changed(self, node: NodeNum,
                                     status: ConnectionStatus) -> None:
        pass


@dataclass
class CommConfig:
    """Endpoint table for socket transports (reference PlainUdpConfig /
    TlsTcpConfig, communication/include/communication/CommDefs.hpp)."""
    self_id: NodeNum
    endpoints: Dict[NodeNum, Tuple[str, int]] = field(default_factory=dict)
    max_message_size: int = MAX_MESSAGE_SIZE
    buffer_capacity: int = 8 * 1024 * 1024


class ICommunication(abc.ABC):
    @abc.abstractmethod
    def start(self, receiver: IReceiver) -> None: ...

    @abc.abstractmethod
    def stop(self) -> None: ...

    @abc.abstractmethod
    def is_running(self) -> bool: ...

    @abc.abstractmethod
    def send(self, dest: NodeNum, data: bytes) -> None:
        """Best-effort async send; must never block the caller on the
        network (reference sends are queued on comm threads)."""

    def broadcast(self, dests: Iterable[NodeNum], data: bytes) -> None:
        for d in dests:
            self.send(d, data)

    def send_burst(self, msgs: "Iterable[Tuple[NodeNum, bytes]]") -> None:
        """Burst send: many (dest, payload) pairs handed to the
        transport in one call, the sending mirror of
        `IReceiver.on_new_messages` — a batching transport (udp
        sendmmsg) can push the whole burst through one syscall. Used by
        the durability pipeline to release a committed group's replies
        as a single wire burst. Default: per-message sends."""
        for dest, data in msgs:
            self.send(dest, data)

    def get_connection_status(self, node: NodeNum) -> ConnectionStatus:
        return ConnectionStatus.UNKNOWN

    @property
    def max_message_size(self) -> int:
        return MAX_MESSAGE_SIZE
