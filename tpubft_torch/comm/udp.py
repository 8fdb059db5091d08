"""Plain UDP transport — the reference's default (port of
tpubft/comm/udp.py).

Rebuild of communication/src/PlainUDPCommunication.cpp: connectionless
datagrams, one receive thread, sender identified by source endpoint lookup
in the static endpoint table. Messages above the datagram-safe size are
dropped with a metric bump, as in the reference.

Port divergences (reference udp.py:24-37, :193-200): the batched
sendmmsg/recvmmsg plane binds the port's own copy of the native source,
tpubft_torch/native/netio.cpp, built with g++ into ops/_build/ at first
use (ops/_build.load_host); the reference's library is never loaded.
Where it cannot be built the transport still runs on the scalar
sendto/recvfrom paths, as the reference does, but every transport built
so is counted in FALLBACKS (and why in `load_error`), and every batch
re-sent datagram by datagram after net_sendmmsg returned -1 in RESENDS.
Both are counters of the module's `METRICS` component, which a process
registers with its Aggregator to publish them.
"""
from __future__ import annotations

import ctypes
import socket
import threading
from typing import Optional

from tpubft_torch.comm.interfaces import (CommConfig, ConnectionStatus,
                                          ICommunication, IReceiver,
                                          NodeNum)
from tpubft_torch.utils.metrics import Component

# 4-byte LE sender-id prefix (same width as TCP's handshake id); source
# (ip, port) can be rewritten by NAT in odd topologies, so carry the id
# explicitly.
_HDR = 4

METRICS = Component("udp")
FALLBACKS = METRICS.register_counter("netio_fallbacks")
RESENDS = METRICS.register_counter("netio_resends")
load_error: Optional[str] = None


def _load_netio():
    global load_error
    try:
        from tpubft_torch.ops._build import load_host
        lib = load_host("netio")
        lib.net_sendmmsg.restype = ctypes.c_int
        lib.net_sendmmsg.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                     ctypes.c_uint32, ctypes.c_int]
        lib.net_recvmmsg.restype = ctypes.c_int
        lib.net_recvmmsg.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                     ctypes.c_uint32, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_uint32)]
        return lib
    except Exception as exc:  # noqa: BLE001 — transport must work without g++
        load_error = f"{type(exc).__name__}: {exc}"
        return None


class PlainUdpCommunication(ICommunication):
    def __init__(self, config: CommConfig):
        self._cfg = config
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._receiver: Optional[IReceiver] = None
        self._running = False
        # batched-send plane: the consensus dispatcher produces ~10
        # datagrams per ordered op; per-sendto syscall overhead was a top
        # profiler entry. Sends from the flusher thread (the first thread
        # to call flush(), i.e. the dispatcher) buffer here and go out as
        # ONE sendmmsg at iteration end; other threads send immediately.
        self._netio = _load_netio()
        if self._netio is None:
            FALLBACKS.inc()
        self._flush_tid: Optional[int] = None
        self._batch: list = []
        # dest -> packed "ipv4(4, network) + port(2, little-endian)"
        # record prefix. Little-endian is the DEFINED wire order of the
        # netio record (netio.cpp assembles the field byte-by-byte), not
        # an assumption about the host.
        self._addr_pfx = {}
        for node, (host, port) in self._cfg.endpoints.items():
            try:
                self._addr_pfx[node] = (socket.inet_aton(host)
                                        + port.to_bytes(2, "little"))
            except OSError:
                pass  # non-IPv4 endpoint: always takes the sendto path

    def start(self, receiver: IReceiver) -> None:
        if self._running:
            return
        self._receiver = receiver
        host, port = self._cfg.endpoints[self._cfg.self_id]
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                              self._cfg.buffer_capacity)
        self._sock.bind((host, port))
        self._sock.settimeout(0.2)
        self._running = True
        self._thread = threading.Thread(
            target=self._recv_loop, name=f"udp-recv-{self._cfg.self_id}",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def is_running(self) -> bool:
        return self._running

    @property
    def max_message_size(self) -> int:
        return min(self._cfg.max_message_size, 65507 - _HDR)

    def send(self, dest: NodeNum, data: bytes) -> None:
        if not self._running or self._sock is None:
            return
        if len(data) > self.max_message_size:
            return  # oversize datagram: dropped (reference logs + drops)
        pkt = self._cfg.self_id.to_bytes(_HDR, "little") + data
        if (self._flush_tid == threading.get_ident()
                and self._netio is not None):
            pfx = self._addr_pfx.get(dest)
            if pfx is not None:
                self._batch.append(pfx + len(pkt).to_bytes(4, "little")
                                   + pkt)
                if len(self._batch) >= 256:
                    self._drain()       # bound buffered memory
                return
        addr = self._cfg.endpoints.get(dest)
        if addr is None:
            return
        try:
            self._sock.sendto(pkt, addr)
        except OSError:
            pass  # best-effort, like UDP itself

    def send_burst(self, msgs) -> None:
        """Burst send from ANY thread (the durability pipeline's io
        thread releases a committed group's replies here): builds the
        sendmmsg record batch locally — no shared buffer, so it never
        races the flusher thread's `_batch` — and pushes it through the
        same one-syscall path as the dispatcher's flush. Destinations
        without a packed IPv4 prefix (or without netio) fall back to
        per-datagram sendto, same as send()."""
        if not self._running or self._sock is None:
            return
        records: list = []
        for dest, data in msgs:
            if len(data) > self.max_message_size:
                continue  # oversize datagram: dropped (reference drops)
            pkt = self._cfg.self_id.to_bytes(_HDR, "little") + data
            pfx = self._addr_pfx.get(dest)
            if self._netio is not None and pfx is not None:
                records.append(pfx + len(pkt).to_bytes(4, "little") + pkt)
                if len(records) >= 256:
                    self._send_records(records)  # bound buffered memory
                    records = []
                continue
            addr = self._cfg.endpoints.get(dest)
            if addr is None:
                continue
            try:
                self._sock.sendto(pkt, addr)
            except OSError:
                pass  # best-effort, like UDP itself
        if records:
            self._send_records(records)

    def flush(self) -> None:
        """Called by the owning dispatcher at the end of each iteration;
        the first caller becomes the (single) batching thread."""
        if self._flush_tid is None:
            self._flush_tid = threading.get_ident()
        if self._batch:
            self._drain()

    def _drain(self) -> None:
        batch, self._batch = self._batch, []
        self._send_records(batch)

    def _send_records(self, batch: list) -> None:
        if not self._running or self._sock is None:
            return
        blob = b"".join(batch)
        try:
            rc = self._netio.net_sendmmsg(self._sock.fileno(), blob,
                                          len(blob), len(batch))
        except Exception:  # noqa: BLE001 — treat like a malformed buffer
            rc = -1
        if rc < 0:
            # -1 = malformed record buffer (not an exception): the batch
            # must not be silently dropped — re-send per datagram
            RESENDS.inc()
            for rec in batch:
                try:
                    ip = socket.inet_ntoa(rec[:4])
                    port = int.from_bytes(rec[4:6], "little")
                    self._sock.sendto(rec[10:], (ip, port))
                except OSError:
                    pass

    def get_connection_status(self, node: NodeNum) -> ConnectionStatus:
        return (ConnectionStatus.CONNECTED if node in self._cfg.endpoints
                else ConnectionStatus.UNKNOWN)

    # datagrams drained per recvmmsg call (mirrors netio.cpp kMaxBatch)
    RECV_BATCH = 64

    def _recv_loop(self) -> None:
        assert self._sock is not None
        if self._netio is not None:
            self._recv_loop_batched()
        else:
            # fallback path when _netio.so is unavailable (no g++ on the
            # host): one recvfrom syscall per datagram, as the reference
            self._recv_loop_scalar()

    def _recv_loop_scalar(self) -> None:
        while self._running:
            try:
                pkt, _ = self._sock.recvfrom(self._cfg.max_message_size + _HDR)
            except socket.timeout:
                continue
            except OSError:
                return
            msg = self._accept(pkt)
            if msg is not None and self._receiver is not None:
                self._receiver.on_new_message(*msg)

    def _recv_loop_batched(self) -> None:
        """recvmmsg plane: ONE syscall drains a whole burst, and the
        receiver gets it as one on_new_messages upcall (the admission
        pipeline enqueues the burst in one go). Readiness via
        selectors (epoll on Linux) — select(2) would silently fail for
        fds >= FD_SETSIZE on a process with many open files."""
        import selectors
        slot = self._cfg.max_message_size + _HDR
        buf = ctypes.create_string_buffer(slot * self.RECV_BATCH)
        lens = (ctypes.c_uint32 * self.RECV_BATCH)()
        sock0 = self._sock
        sel = selectors.DefaultSelector()
        try:
            sel.register(sock0, selectors.EVENT_READ)
        except (OSError, ValueError):
            sel.close()
            return
        try:
            self._recv_loop_batched_body(sel, buf, lens, slot)
        finally:
            sel.close()

    def _recv_loop_batched_body(self, sel, buf, lens, slot) -> None:
        while self._running:
            sock = self._sock
            if sock is None:
                return
            try:
                ready = sel.select(0.2)
            except (OSError, ValueError):
                if self._running:
                    from tpubft_torch.utils.logging import get_logger
                    get_logger("udp").exception(
                        "receive poll failed; receive thread exiting")
                return
            if not ready:
                continue
            try:
                n = self._netio.net_recvmmsg(sock.fileno(), buf, slot,
                                             self.RECV_BATCH, lens)
            except Exception:  # noqa: BLE001 — treat like a socket error
                n = -1
            if n < 0:
                return
            burst = []
            for i in range(n):
                ln = min(lens[i], slot)
                msg = self._accept(buf[i * slot:i * slot + ln])
                if msg is not None:
                    burst.append(msg)
            if burst and self._receiver is not None:
                self._receiver.on_new_messages(burst)

    def _accept(self, pkt: bytes):
        """Shared per-datagram shape check: (sender, payload) or None."""
        if len(pkt) < _HDR:
            return None
        sender = int.from_bytes(pkt[:_HDR], "little")
        if sender not in self._cfg.endpoints or sender == self._cfg.self_id:
            return None  # unknown/spoofed sender id: drop
        return sender, pkt[_HDR:]
