"""TLS multiplex transport: many principals per physical connection
(port of tpubft/comm/multiplex.py; the factory's "tls-mux" runs it over
comm/tls.TlsTcpCommunication).

Rebuild of concord-bft's TlsMultiplexCommunication
(communication/src/TlsMultiplexCommunication.cpp:22-80):
a client process holding many principals (a pool / clientservice with N
proxies) shares ONE mutually-authenticated connection per peer instead
of N, and replicas demultiplex by an endpoint number carried in each
frame. The fd math this buys: a clientservice with 64 proxy principals
against n=7 replicas needs 7 sockets instead of 448; cluster-wide,
replicas accept one connection per client PROCESS, not per principal.

Frame format on a multiplexed link: u32le endpoint | payload.
Routing rules (the reference's TlsMultiplexReceiver::onNewMessage):
  * replica -> replica:  endpoint = destination replica id; the receiver
    checks it names itself and keeps the transport sender.
  * client principal -> replica: endpoint = the SOURCE principal; the
    receiver adopts it as the sender and remembers which carrier
    connection that principal rides (for routing replies back).
  * replica -> client principal: endpoint = the DESTINATION principal;
    the client-side hub routes to that principal's receiver.

Authenticity: the carrier connection is mutually-TLS-authenticated to
the CARRIER's node id; principals multiplexed over it are only accepted
from client-space carriers and only name client-space endpoints (a
client carrier can never inject replica-sourced frames), and every
client request additionally carries its principal's signature, verified
at admission — same trust chain as the reference.
"""
from __future__ import annotations

import struct
from typing import Callable, Dict, Optional

from tpubft_torch.utils.racecheck import make_lock
from tpubft_torch.comm.interfaces import (ConnectionStatus, ICommunication,
                                    IReceiver, NodeNum)

_EP = struct.Struct("<I")


def client_floor(n_val: int, num_ro: int) -> int:
    """First client-space principal id for a topology — the single
    definition every tls-mux call site derives TlsConfig.mux_client_floor
    from (replicas 0..n-1, then RO replicas, then clients/operator)."""
    return n_val + num_ro


class MultiplexTransport(ICommunication):
    """Replica-side (and single-principal-peer) multiplex wrapper: every
    frame on the wire carries the endpoint header; inbound client frames
    re-source to their principal and the principal->carrier route is
    learned for replies."""

    def __init__(self, inner: ICommunication, self_id: int,
                 is_client: Callable[[int], bool]) -> None:
        self._inner = inner
        self._self = self_id
        self._is_client = is_client
        self._carrier_of: Dict[int, int] = {}   # principal -> carrier

    # ---- lifecycle ----
    def start(self, receiver: IReceiver) -> None:
        self._inner.start(_DemuxReceiver(self, receiver))

    def stop(self) -> None:
        self._inner.stop()

    def is_running(self) -> bool:
        return self._inner.is_running()

    @property
    def max_message_size(self) -> int:
        return self._inner.max_message_size - _EP.size

    def get_connection_status(self, node: NodeNum) -> ConnectionStatus:
        if self._is_client(int(node)):
            carrier = self._carrier_of.get(int(node), int(node))
            return self._inner.get_connection_status(carrier)
        return self._inner.get_connection_status(node)

    # ---- sends ----
    def send(self, dest: NodeNum, data: bytes) -> None:
        dest = int(dest)
        frame = _EP.pack(dest) + data
        if self._is_client(dest):
            # reply path: ride the carrier the principal arrived on
            # (falls back to a direct connection for a principal that
            # dialed with its own id — a 1-principal carrier)
            self._inner.send(self._carrier_of.get(dest, dest), frame)
        else:
            self._inner.send(dest, frame)

    # ---- demux (called from _DemuxReceiver) ----
    def _route(self, src: int, data: bytes,
               receiver: IReceiver) -> None:
        if len(data) < _EP.size:
            return
        (ep,) = _EP.unpack_from(data)
        payload = data[_EP.size:]
        if ep == self._self:
            # peer-addressed traffic (replica<->replica, or a client hub
            # receiving from a replica handles this in MultiplexClientHub)
            receiver.on_new_message(src, payload)
            return
        if self._is_client(ep) and self._is_client(src):
            # a principal multiplexed over an authenticated client-space
            # carrier: adopt it as the sender, learn the return route.
            # Route learning is STICKY while the bound carrier is alive —
            # another carrier naming this principal must not redirect its
            # replies (one authenticated-but-malicious client process
            # could otherwise black-hole every other principal's replies
            # with a single forged frame); re-binding is allowed once the
            # old carrier's connection is gone (process restart/migration)
            cur = self._carrier_of.get(ep)
            if (cur is None or cur == src
                    or self._inner.get_connection_status(cur)
                    != ConnectionStatus.CONNECTED):
                self._carrier_of[ep] = src
            receiver.on_new_message(ep, payload)
            return
        # a replica-space endpoint from the wrong carrier, or a client
        # endpoint claimed by a replica carrier: spoofing — drop


class _DemuxReceiver(IReceiver):
    def __init__(self, mux: MultiplexTransport, inner: IReceiver) -> None:
        self._mux = mux
        self._inner = inner

    def on_new_message(self, sender: NodeNum, data: bytes) -> None:
        self._mux._route(int(sender), data, self._inner)

    def on_connection_status_changed(self, node, status) -> None:
        fn = getattr(self._inner, "on_connection_status_changed", None)
        if fn is not None:
            fn(node, status)


class MultiplexClientHub:
    """Client-process side: N principals share the ONE carrier transport
    (the reference clientservice/pool shape). `endpoint(principal)`
    returns an ICommunication facade for that principal; all facades ride
    the same inner connection set."""

    def __init__(self, inner: ICommunication) -> None:
        self._inner = inner
        self._endpoints: Dict[int, _MuxEndpoint] = {}
        self._started = False
        # principals start/stop from their own (application) threads:
        # endpoint registration and the carrier-start claim must be
        # atomic across them
        self._mu = make_lock("mux_hub")

    def endpoint(self, principal: int) -> "_MuxEndpoint":
        with self._mu:
            ep = self._endpoints.get(principal)
            if ep is None:
                ep = self._endpoints[principal] = _MuxEndpoint(
                    self, principal)
            return ep

    def _ensure_started(self) -> None:
        with self._mu:
            if self._started:
                return
            self._started = True
        # the carrier start itself runs outside the claim: it spawns the
        # receive thread, and a racing second principal only needs the
        # claim decided, not the start completed (sends before the
        # carrier is up drop, exactly as before)
        self._inner.start(_HubReceiver(self))

    def _route(self, src: int, data: bytes) -> None:
        if len(data) < _EP.size:
            return
        (ep_id,) = _EP.unpack_from(data)
        ep = self._endpoints.get(ep_id)
        if ep is not None and ep._receiver is not None and ep._running:
            ep._receiver.on_new_message(src, data[_EP.size:])

    def stop(self) -> None:
        # every principal's facade goes down with the shared carrier —
        # is_running() must not report a transport that silently drops
        for ep in list(self._endpoints.values()):
            ep._running = False
        self._inner.stop()
        with self._mu:
            self._started = False


class _HubReceiver(IReceiver):
    def __init__(self, hub: MultiplexClientHub) -> None:
        self._hub = hub

    def on_new_message(self, sender: NodeNum, data: bytes) -> None:
        self._hub._route(int(sender), data)

    def on_connection_status_changed(self, node, status) -> None:
        # snapshot: endpoint() may register a new principal concurrently
        for ep in list(self._hub._endpoints.values()):
            fn = getattr(ep._receiver, "on_connection_status_changed", None)
            if fn is not None:
                fn(node, status)


class _MuxEndpoint(ICommunication):
    """One principal's view of the shared carrier."""

    def __init__(self, hub: MultiplexClientHub, principal: int) -> None:
        self._hub = hub
        self.principal = principal
        self._receiver: Optional[IReceiver] = None
        self._running = False

    def start(self, receiver: IReceiver) -> None:
        self._receiver = receiver
        self._running = True
        self._hub._ensure_started()

    def stop(self) -> None:
        # the shared carrier stays up for the other principals
        self._running = False

    def is_running(self) -> bool:
        return self._running

    @property
    def max_message_size(self) -> int:
        return self._hub._inner.max_message_size - _EP.size

    def get_connection_status(self, node: NodeNum) -> ConnectionStatus:
        return self._hub._inner.get_connection_status(node)

    def send(self, dest: NodeNum, data: bytes) -> None:
        if self._running:
            self._hub._inner.send(dest, _EP.pack(self.principal) + data)
