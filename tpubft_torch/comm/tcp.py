"""Plain TCP transport with length-prefixed framing (port of
tpubft/comm/tcp.py, the same wire and threads).

Rebuild of communication/src/PlainTcpCommunication.cpp: persistent
connections, 4-byte LE length prefix per message, an id handshake on
connect so the acceptor learns the peer's NodeNum, per-peer write queues
drained by a writer thread (the reference's ASIO write queue), lazy
reconnect. One connection per pair: the higher-id node dials, the lower-id
node accepts (the reference connection manager's convention), so
simultaneous first-sends cannot race into crossed half-open connections.

The security hooks `_wrap_outbound`, `_wrap_inbound` and
`_authenticate_inbound` stay identities here; comm/tls.py overrides them.
"""
from __future__ import annotations

import queue
import socket
import struct
import threading
import time
from typing import Dict, Optional

from tpubft_torch.comm.interfaces import (CommConfig, ConnectionStatus,
                                    ICommunication, IReceiver, NodeNum)

_LEN = struct.Struct("<I")
_ID = struct.Struct("<I")
_SEND_DEADLINE_S = 3.0   # per-message connect+write budget before dropping
_HANDSHAKE_DEADLINE_S = 2.0


class _Peer:
    """One peer's connection state.

    Plain TCP runs ONE bidirectional socket per pair (wsock is rsock);
    the TLS transport runs DIRECTIONAL legs — the socket we dialed is
    write-only, the socket the peer dialed into us is read-only — because
    OpenSSL forbids concurrent SSL_read/SSL_write on one SSL object from
    two threads (the reference's ASIO model serializes on a strand
    instead; directional legs are the thread-per-socket equivalent)."""

    def __init__(self, comm: "PlainTcpCommunication", node: NodeNum):
        self.comm = comm
        self.node = node
        self.wsock: Optional[socket.socket] = None   # we write here
        self.rsock: Optional[socket.socket] = None   # we read here
        self.q: "queue.Queue[Optional[bytes]]" = queue.Queue(maxsize=4096)
        self.lock = threading.Lock()
        self.writer = threading.Thread(target=self._write_loop, daemon=True,
                                       name=f"tcp-write-{self.node}")
        self.writer.start()

    @staticmethod
    def _prep(sock: socket.socket) -> None:
        sock.settimeout(None)  # blocking I/O; close() unblocks threads
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        except OSError:
            pass

    def attach(self, sock: socket.socket) -> None:
        """Bidirectional attach (plain TCP). Newest connection wins: a
        fresh inbound leg from an authenticated peer replaces a possibly-
        dead stale socket (a partitioned peer leaves no FIN behind;
        without this, redials would be refused forever)."""
        self._prep(sock)
        with self.lock:
            old_w, self.wsock = self.wsock, sock
            old_r, self.rsock = self.rsock, sock
        for old in {old_w, old_r} - {None}:
            _close(old)
        self._spawn_reader(sock)
        self.comm._notify(self.node, ConnectionStatus.CONNECTED)

    def attach_write(self, sock: socket.socket) -> None:
        """Directional write leg (the connection WE dialed)."""
        self._prep(sock)
        with self.lock:
            old, self.wsock = self.wsock, sock
        if old is not None:
            _close(old)
        self.comm._notify(self.node, ConnectionStatus.CONNECTED)

    def attach_read(self, sock: socket.socket) -> None:
        """Directional read leg (the connection the peer dialed). No
        status notification: connection status tracks WRITEABILITY (can
        we reach the peer), carried by the write leg alone."""
        self._prep(sock)
        with self.lock:
            old, self.rsock = self.rsock, sock
        if old is not None:
            _close(old)
        self._spawn_reader(sock)

    def _spawn_reader(self, sock: socket.socket) -> None:
        threading.Thread(target=self._read_loop, args=(sock,), daemon=True,
                         name=f"tcp-read-{self.node}").start()

    def detach(self, sock: Optional[socket.socket] = None) -> None:
        """Tear down `sock` (or everything). A reader/writer that lost a
        replaced socket must not clobber the replacement. DISCONNECTED is
        notified only when the WRITE leg is lost, matching
        get_connection_status (a dead read leg alone does not make the
        peer unreachable)."""
        closing = []
        lost_write = False
        with self.lock:
            if sock is None:
                closing = [s for s in (self.wsock, self.rsock)
                           if s is not None]
                lost_write = self.wsock is not None
                self.wsock = self.rsock = None
            else:
                if self.wsock is sock:
                    self.wsock = None
                    lost_write = True
                    closing.append(sock)
                if self.rsock is sock:
                    self.rsock = None
                    if sock not in closing:
                        closing.append(sock)
        if not closing:
            return  # already replaced by a newer connection
        for s in closing:
            _close(s)
        if lost_write:
            self.comm._notify(self.node, ConnectionStatus.DISCONNECTED)

    def enqueue(self, data: bytes) -> None:
        try:
            self.q.put_nowait(data)
        except queue.Full:
            pass  # backpressure: drop, like the reference's bounded queues

    def _write_loop(self) -> None:
        while self.comm.is_running():
            try:
                data = self.q.get(timeout=0.2)
            except queue.Empty:
                continue
            if data is None:
                return
            deadline = time.monotonic() + _SEND_DEADLINE_S
            while self.comm.is_running() and time.monotonic() < deadline:
                sock = self.wsock
                if sock is None:
                    # the connector thread (or the peer's) re-establishes
                    time.sleep(0.02)
                    continue
                try:
                    sock.sendall(_LEN.pack(len(data)) + data)
                except OSError:
                    self.detach(sock)
                    continue
                break
            # deadline expired with no connection: message dropped

    def _read_loop(self, sock: socket.socket) -> None:
        while self.comm.is_running():
            if self.rsock is not sock:
                return  # replaced: the new socket has its own reader
            hdr = _recv_exact(sock, _LEN.size)
            if hdr is None:
                self.detach(sock)
                return
            (n,) = _LEN.unpack(hdr)
            if n > self.comm._cfg.max_message_size:
                self.detach(sock)
                return
            body = _recv_exact(sock, n)
            if body is None:
                self.detach(sock)
                return
            self.comm._deliver(self.node, body)


def _close(sock: socket.socket) -> None:
    try:
        sock.close()
    except OSError:
        pass


def _recv_exact(sock: socket.socket, n: int,
                deadline: Optional[float] = None) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        if deadline is not None and time.monotonic() > deadline:
            return None
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            continue
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


class PlainTcpCommunication(ICommunication):
    def __init__(self, config: CommConfig):
        self._cfg = config
        self._receiver: Optional[IReceiver] = None
        self._running = False
        self._peers: Dict[NodeNum, _Peer] = {}
        self._lock = threading.Lock()
        self._server: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._connect_thread: Optional[threading.Thread] = None

    # ---- ICommunication ----

    def start(self, receiver: IReceiver) -> None:
        if self._running:
            return
        self._receiver = receiver
        self._running = True
        host, port = self._cfg.endpoints[self._cfg.self_id]
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(64)
        srv.settimeout(0.2)
        self._server = srv
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"tcp-accept-{self._cfg.self_id}")
        self._accept_thread.start()
        self._connect_thread = threading.Thread(
            target=self._connect_loop, daemon=True,
            name=f"tcp-connect-{self._cfg.self_id}")
        self._connect_thread.start()

    def stop(self) -> None:
        # Graceful: give writer threads a moment to drain queued sends
        # (the reference drains its ASIO write queues on shutdown).
        deadline = time.monotonic() + 1.0
        while time.monotonic() < deadline:
            with self._lock:
                pending = any(not p.q.empty() for p in self._peers.values())
            if not pending:
                break
            time.sleep(0.02)
        self._running = False
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
            self._accept_thread = None
        if self._connect_thread is not None:
            self._connect_thread.join(timeout=5)
            self._connect_thread = None
        if self._server is not None:
            self._server.close()
            self._server = None
        with self._lock:
            peers, self._peers = list(self._peers.values()), {}
        for p in peers:
            p.detach()

    def is_running(self) -> bool:
        return self._running

    def send(self, dest: NodeNum, data: bytes) -> None:
        if not self._running or dest not in self._cfg.endpoints:
            return
        if len(data) > self._cfg.max_message_size:
            return  # oversize: drop here instead of poisoning the connection
        self._peer(dest).enqueue(data)

    def get_connection_status(self, node: NodeNum) -> ConnectionStatus:
        with self._lock:
            p = self._peers.get(node)
        if p is None:
            return ConnectionStatus.UNKNOWN
        return (ConnectionStatus.CONNECTED if p.wsock is not None
                else ConnectionStatus.DISCONNECTED)

    @property
    def max_message_size(self) -> int:
        return self._cfg.max_message_size

    # ---- internals ----

    # True for transports whose connections are one-way (TLS): every node
    # dials its OWN write leg to every peer; inbound legs are read-only
    directional = False

    def _dials(self, node: NodeNum) -> bool:
        """Who initiates: everyone (directional) or the higher id (one
        shared bidirectional connection per pair)."""
        if self.directional:
            return node != self._cfg.self_id
        return self._cfg.self_id > node

    def _connect_loop(self) -> None:
        """Proactively establish + maintain this node's outbound legs
        (the reference maintains the full mesh from startup). Dials run
        on per-peer threads: one byzantine acceptor dribbling handshake
        bytes must not delay redials to every other peer."""
        dialing: set = set()
        dial_lock = threading.Lock()

        def dial_one(node: NodeNum) -> None:
            try:
                self._dial(node)
            finally:
                with dial_lock:
                    dialing.discard(node)

        while self._running:
            for node in self._cfg.endpoints:
                if not self._running:
                    return
                if self._dials(node) and self._peer(node).wsock is None:
                    with dial_lock:
                        if node in dialing:
                            continue
                        dialing.add(node)
                    threading.Thread(target=dial_one, args=(node,),
                                     daemon=True,
                                     name=f"tcp-dial-{node}").start()
            time.sleep(0.25)

    def _peer(self, node: NodeNum) -> _Peer:
        with self._lock:
            p = self._peers.get(node)
            if p is None:
                p = self._peers[node] = _Peer(self, node)
        return p

    # ---- security hooks (identity here; TlsTcpCommunication overrides) ----

    def _wrap_outbound(self, sock: socket.socket,
                       node: NodeNum) -> socket.socket:
        """Post-connect wrap of a dialed socket (TLS handshake + server
        authentication in the TLS transport). Raise OSError to refuse."""
        return sock

    def _wrap_inbound(self, sock: socket.socket) -> socket.socket:
        """Post-accept wrap (TLS handshake). Raise OSError to refuse."""
        return sock

    def _authenticate_inbound(self, sock: socket.socket,
                              peer_id: NodeNum) -> bool:
        """Bind the transport-level identity to the claimed node id (the
        TLS transport checks the certificate pin for `peer_id`)."""
        return True

    def _dial(self, node: NodeNum) -> None:
        addr = self._cfg.endpoints.get(node)
        if addr is None:
            return
        # Port divergence (reference tcp.py:352, socket.create_connection):
        # the dialing socket sets SO_REUSEADDR before its connect. Its
        # local port comes from the kernel's ephemeral range, and a
        # cluster whose listening ports lie in that range (every peer,
        # clients included, dials every peer) could otherwise find a
        # port it has yet to bind held by a live dial: the listener's
        # bind then fails with EADDRINUSE (seen on the card, where a
        # client's TLS listener started after the replicas dialed it)
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.settimeout(1.0)
        try:
            sock.connect(addr)
        except OSError:
            _close(sock)
            return
        # absolute bound on the outbound handshake: a byzantine acceptor
        # dribbling handshake bytes must not stall the connect loop
        raw = sock
        killer = threading.Timer(2 * _HANDSHAKE_DEADLINE_S,
                                 lambda: _close(raw))
        killer.daemon = True
        killer.start()
        try:
            sock = self._wrap_outbound(sock, node)
            sock.sendall(_ID.pack(self._cfg.self_id))
        except OSError:
            _close(sock)
            return
        finally:
            killer.cancel()
        if self.directional:
            self._peer(node).attach_write(sock)
        else:
            self._peer(node).attach(sock)

    # cap on concurrent inbound handshakes: beyond this, new connections
    # are refused outright (bounds the handshake-thread count under a
    # connection flood; legitimate peers redial)
    _MAX_INFLIGHT_HANDSHAKES = 64

    def _accept_loop(self) -> None:
        assert self._server is not None
        inflight = threading.Semaphore(self._MAX_INFLIGHT_HANDSHAKES)
        while self._running:
            try:
                sock, _ = self._server.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            if not inflight.acquire(blocking=False):
                sock.close()
                continue
            # per-connection handshake thread with an ABSOLUTE deadline
            # (a timer closes the socket, aborting a dribbled handshake):
            # one slow/malicious client must not block the accept loop
            threading.Thread(target=self._inbound_handshake,
                             args=(sock, inflight), daemon=True,
                             name="tcp-handshake").start()

    def _inbound_handshake(self, sock: socket.socket, inflight) -> None:
        # pin the RAW socket for the killer: closing the SSL wrapper from
        # the timer thread would race the handshake thread's SSL_read on
        # the same SSL object (closing the raw fd is thread-safe abort)
        raw = sock
        killer = threading.Timer(2 * _HANDSHAKE_DEADLINE_S,
                                 lambda: _close(raw))
        killer.daemon = True
        killer.start()
        try:
            sock.settimeout(_HANDSHAKE_DEADLINE_S)
            sock = self._wrap_inbound(sock)
            sock.settimeout(0.2)
            hdr = _recv_exact(sock, _ID.size,
                              time.monotonic() + _HANDSHAKE_DEADLINE_S)
            if hdr is None:
                _close(sock)
                return
            (peer_id,) = _ID.unpack(hdr)
            if peer_id not in self._cfg.endpoints \
                    or peer_id == self._cfg.self_id:
                _close(sock)  # unknown/spoofed id: refuse
                return
            if not self._authenticate_inbound(sock, peer_id):
                _close(sock)  # transport identity != claimed id: refuse
                return
            killer.cancel()
            if not self._running:
                _close(sock)
                return
            if self.directional:
                self._peer(peer_id).attach_read(sock)
            else:
                self._peer(peer_id).attach(sock)
        except OSError:
            _close(sock)
        finally:
            killer.cancel()
            inflight.release()

    def _deliver(self, sender: NodeNum, data: bytes) -> None:
        if self._running and self._receiver is not None:
            self._receiver.on_new_message(sender, data)

    def _notify(self, node: NodeNum, status: ConnectionStatus) -> None:
        if self._receiver is not None:
            self._receiver.on_connection_status_changed(node, status)
