"""The port's transports (tpubft_torch/comm/) against the reference's:
UDP and TCP behaviour as tests/test_comm.py holds the reference to, the
factory, and the wire bytes — one sendmmsg record blob, one raw datagram
(a port sender and a reference sender to the same raw socket) and one
endpoint exchanging datagrams with the other package's endpoint."""
import socket
import threading
import time

import numpy as np
import pytest

from tpubft.comm import CommConfig as RefCommConfig
from tpubft.comm import PlainUdpCommunication as RefUdp
from tpubft_torch.comm import (CommConfig, LoopbackBus, PlainTcpCommunication,
                               PlainUdpCommunication, create_communication,
                               udp)
from tpubft_torch.comm.interfaces import IReceiver


class Collector(IReceiver):
    def __init__(self):
        self.msgs = []
        self.lock = threading.Lock()

    def on_new_message(self, sender, data):
        with self.lock:
            self.msgs.append((sender, data))

    def wait_for(self, n, timeout=10.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self.lock:
                if len(self.msgs) >= n:
                    return True
            time.sleep(0.01)
        return False


def free_ports(n):
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _pair(cls=PlainUdpCommunication, **kw):
    p0, p1 = free_ports(2)
    eps = {0: ("127.0.0.1", p0), 1: ("127.0.0.1", p1)}
    return (cls(CommConfig(self_id=0, endpoints=eps, **kw)),
            cls(CommConfig(self_id=1, endpoints=eps, **kw)))


def _payloads(seed, n, lo=1, hi=600):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(lo, hi)),
                         dtype=np.uint8).tobytes() for _ in range(n)]


def test_loopback_send_and_broadcast():
    bus = LoopbackBus()
    comms = {i: bus.create(i) for i in range(4)}
    rxs = {i: Collector() for i in range(4)}
    for i in range(4):
        comms[i].start(rxs[i])
    comms[0].send(1, b"hello")
    assert rxs[1].wait_for(1)
    assert rxs[1].msgs == [(0, b"hello")]
    comms[1].broadcast([0, 2, 3], b"bcast")
    for i in (0, 2, 3):
        assert rxs[i].wait_for(1)
        assert rxs[i].msgs[-1] == (1, b"bcast")
    bus.shutdown()


def test_udp_roundtrip():
    c0, c1 = _pair()
    r0, r1 = Collector(), Collector()
    c0.start(r0)
    c1.start(r1)
    try:
        c0.send(1, b"ping")
        assert r1.wait_for(1)
        assert r1.msgs == [(0, b"ping")]
        c1.send(0, b"pong" * 1000)
        assert r0.wait_for(1)
        assert r0.msgs == [(1, b"pong" * 1000)]
    finally:
        c0.stop()
        c1.stop()


def test_udp_oversize_dropped():
    c0, c1 = _pair()
    r1 = Collector()
    c0.start(Collector())
    c1.start(r1)
    try:
        c0.send(1, b"z" * (c0.max_message_size + 1))
        c0.send(1, b"ok")
        assert r1.wait_for(1)
        assert r1.msgs == [(0, b"ok")]
    finally:
        c0.stop()
        c1.stop()


def test_udp_batched_flush_path():
    """The sendmmsg batch plane: the flusher thread's sends buffer and go
    out on flush() through the port's own netio library (built with g++
    on this host: no fallback is counted)."""
    before = udp.FALLBACKS.value
    c0, c1 = _pair()
    assert c0._netio is not None, udp.load_error
    assert udp.FALLBACKS.value == before
    r1 = Collector()
    c0.start(Collector())
    c1.start(r1)
    try:
        c0.flush()                      # register this thread as flusher
        for i in range(20):
            c0.send(1, b"b%03d" % i)
        assert c0._batch, "flusher-thread sends must buffer"
        c0.flush()
        assert r1.wait_for(20)
        assert sorted(d for _, d in r1.msgs) == [b"b%03d" % i
                                                 for i in range(20)]
    finally:
        c0.stop()
        c1.stop()


def test_udp_burst_send_from_another_thread():
    c0, c1 = _pair()
    r1 = Collector()
    c0.start(Collector())
    c1.start(r1)
    try:
        msgs = [(1, b"burst-%d" % i) for i in range(10)]
        t = threading.Thread(target=c0.send_burst, args=(msgs,))
        t.start()
        t.join()
        assert r1.wait_for(10)
        assert sorted(d for _, d in r1.msgs) == sorted(d for _, d in msgs)
    finally:
        c0.stop()
        c1.stop()


def test_udp_sendmmsg_failure_falls_back_to_sendto():
    """A -1 (malformed buffer) return from net_sendmmsg must NOT drop the
    batch: _drain re-sends every record per datagram, and counts it."""
    c0, c1 = _pair()

    class BrokenNetio:
        def net_sendmmsg(self, *a):
            return -1

    c0._netio = BrokenNetio()
    r1 = Collector()
    c0.start(Collector())
    c1.start(r1)
    before = udp.RESENDS.value
    try:
        c0.flush()
        for i in range(5):
            c0.send(1, b"f%d" % i)
        assert c0._batch
        c0.flush()
        assert r1.wait_for(5)
        assert sorted(d for _, d in r1.msgs) == [b"f%d" % i
                                                 for i in range(5)]
        assert udp.RESENDS.value == before + 1
    finally:
        c0.stop()
        c1.stop()


def test_udp_drops_unknown_and_own_sender_ids():
    c0, c1 = _pair()
    r1 = Collector()
    c1.start(r1)
    raw = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        dest = c1._cfg.endpoints[1]
        raw.sendto((7).to_bytes(4, "little") + b"unknown", dest)
        raw.sendto((1).to_bytes(4, "little") + b"own id", dest)
        raw.sendto(b"\x00", dest)
        raw.sendto((0).to_bytes(4, "little") + b"ok", dest)
        assert r1.wait_for(1)
        time.sleep(0.05)
        assert r1.msgs == [(0, b"ok")]
    finally:
        raw.close()
        c1.stop()


def test_tcp_roundtrip_and_large_message():
    big_cap = 256 * 1024
    c0, c1 = _pair(PlainTcpCommunication, max_message_size=big_cap)
    r0, r1 = Collector(), Collector()
    c0.start(r0)
    c1.start(r1)
    try:
        big = bytes(range(256)) * 512  # 128 KiB — far above the UDP limit
        c0.send(1, b"first")
        assert r1.wait_for(1)
        assert r1.msgs == [(0, b"first")]
        # reply flows over the same accepted connection, framed
        c1.send(0, big)
        assert r0.wait_for(1)
        assert r0.msgs[0] == (1, big)
        # oversize beyond the configured cap is dropped without breaking
        # the connection
        c1.send(0, b"z" * (big_cap + 1))
        c1.send(0, b"after-oversize")
        assert r0.wait_for(2)
        assert r0.msgs[1] == (1, b"after-oversize")
    finally:
        c0.stop()
        c1.stop()


def test_tcp_many_messages_in_order():
    c0, c1 = _pair(PlainTcpCommunication)
    r1 = Collector()
    c0.start(Collector())
    c1.start(r1)
    try:
        for i in range(100):
            c0.send(1, b"m%03d" % i)
        assert r1.wait_for(100)
        assert [d for _, d in r1.msgs] == [b"m%03d" % i for i in range(100)]
    finally:
        c0.stop()
        c1.stop()


def test_tcp_wire_is_the_id_handshake_then_length_prefixed_frames():
    """The dialing side (the higher id) sends its id, then each message
    as a 4-byte little-endian length and the bytes."""
    p0, p1 = free_ports(2)
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", p0))
    srv.listen(1)
    srv.settimeout(10)
    eps = {0: ("127.0.0.1", p0), 1: ("127.0.0.1", p1)}
    c1 = PlainTcpCommunication(CommConfig(self_id=1, endpoints=eps))
    c1.start(Collector())
    try:
        c1.send(0, b"abc")
        c1.send(0, b"")
        conn, _ = srv.accept()
        conn.settimeout(10)
        want = ((1).to_bytes(4, "little") + (3).to_bytes(4, "little")
                + b"abc" + (0).to_bytes(4, "little"))
        got = b""
        while len(got) < len(want):
            chunk = conn.recv(64)
            assert chunk
            got += chunk
        assert got == want
        conn.close()
    finally:
        c1.stop()
        srv.close()


def test_factory_builds_udp_and_tcp():
    eps = {0: ("127.0.0.1", 1), 1: ("127.0.0.1", 2)}
    cfg = CommConfig(self_id=0, endpoints=eps)
    assert isinstance(create_communication(cfg), PlainUdpCommunication)
    assert isinstance(create_communication(cfg, "udp"),
                      PlainUdpCommunication)
    assert isinstance(create_communication(cfg, "tcp"),
                      PlainTcpCommunication)
    with pytest.raises(ValueError):
        create_communication(cfg, "carrier-pigeon")


@pytest.mark.parametrize("transport", ["tls", "tls-mux"])
def test_factory_builds_tls(tmp_path, transport):
    """"tls" is the pinned-cert TLS transport; "tls-mux" the endpoint
    multiplexer over it, with the client floor the config names."""
    from tpubft_torch.comm import (MultiplexTransport, TlsConfig,
                                   TlsTcpCommunication)
    from tpubft_torch.comm.tls import generate_tls_material
    generate_tls_material(tmp_path, [0, 1], seed=b"factory")
    cfg = TlsConfig(self_id=0, endpoints={0: ("127.0.0.1", 1),
                                          1: ("127.0.0.1", 2)},
                    certs_dir=str(tmp_path), mux_client_floor=1)
    comm = create_communication(cfg, transport)
    if transport == "tls":
        assert type(comm) is TlsTcpCommunication
        assert comm.directional
    else:
        assert isinstance(comm, MultiplexTransport)
        assert type(comm._inner) is TlsTcpCommunication
        assert comm._is_client(1) and not comm._is_client(0)
    assert type(create_communication(cfg)) is TlsTcpCommunication


@pytest.mark.parametrize("transport, config, error", [
    ("tls", "plain", TypeError), ("tls-mux", "plain", TypeError),
    ("tls-mux", "no-floor", ValueError)])
def test_factory_tls_config_errors(tmp_path, transport, config, error):
    """The reference's TypeError for a TLS transport on a plain config
    and ValueError for tls-mux without a client floor."""
    from tpubft_torch.comm import TlsConfig
    eps = {0: ("127.0.0.1", 1)}
    cfg = (CommConfig(self_id=0, endpoints=eps) if config == "plain"
           else TlsConfig(self_id=0, endpoints=eps, certs_dir=str(tmp_path)))
    with pytest.raises(error):
        create_communication(cfg, transport)


# ---- wire bytes against the reference ----

def _flush_batch(comm, dests, payloads):
    """Start `comm`, make this thread its flusher, buffer one send a
    payload and return the sendmmsg records it would send."""
    comm.start(Collector())
    try:
        comm.flush()
        for d, p in zip(dests, payloads):
            comm.send(d, p)
        return list(comm._batch)
    finally:
        comm._batch = []
        comm.stop()


def test_sendmmsg_record_blob_equals_the_reference():
    p0, p1, p2, p3 = free_ports(4)
    eps = {0: ("127.0.0.1", p0), 1: ("127.0.0.1", p1),
           2: ("127.0.0.1", p2), 3: ("127.0.0.1", p3)}
    rng = np.random.default_rng(16)
    payloads = _payloads(16, 24)
    dests = [int(d) for d in rng.integers(0, 3, len(payloads))]
    port = _flush_batch(PlainUdpCommunication(
        CommConfig(self_id=3, endpoints=eps)), dests, payloads)
    ref = _flush_batch(RefUdp(RefCommConfig(self_id=3, endpoints=eps)),
                       dests, payloads)
    assert len(port) == len(payloads)
    assert b"".join(port) == b"".join(ref)


@pytest.mark.parametrize("path", ["sendto", "sendmmsg"])
def test_raw_datagrams_equal_the_reference(path):
    """A port sender and a reference sender with the same id, each
    through the scalar sendto path or the batched sendmmsg path, to one
    raw socket: the datagrams are equal byte for byte."""
    raw = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    raw.bind(("127.0.0.1", 0))
    raw.settimeout(10)
    pa, pb = free_ports(2)
    target = raw.getsockname()
    payloads = _payloads(7, 8, hi=2000)
    got = {}
    try:
        for name, cls, cfg_cls, own in (
                ("port", PlainUdpCommunication, CommConfig, pa),
                ("ref", RefUdp, RefCommConfig, pb)):
            comm = cls(cfg_cls(self_id=5, endpoints={
                0: target, 5: ("127.0.0.1", own)}))
            comm.start(Collector())
            try:
                if path == "sendmmsg":
                    comm.flush()
                for p in payloads:
                    comm.send(0, p)
                comm.flush()
                got[name] = sorted(raw.recvfrom(65536)[0]
                                   for _ in payloads)
            finally:
                comm.stop()
        assert got["port"] == got["ref"]
        assert got["port"] == sorted((5).to_bytes(4, "little") + p
                                     for p in payloads)
    finally:
        raw.close()


def test_port_and_reference_endpoints_exchange_both_ways():
    p0, p1 = free_ports(2)
    eps = {0: ("127.0.0.1", p0), 1: ("127.0.0.1", p1)}
    port = PlainUdpCommunication(CommConfig(self_id=0, endpoints=eps))
    ref = RefUdp(RefCommConfig(self_id=1, endpoints=eps))
    rp, rr = Collector(), Collector()
    port.start(rp)
    ref.start(rr)
    try:
        out = _payloads(3, 10)
        back = _payloads(4, 10)
        for p in out:
            port.send(1, p)
        ref.flush()                     # the reference's batched path
        for p in back:
            ref.send(0, p)
        ref.flush()
        assert rr.wait_for(len(out)) and rp.wait_for(len(back))
        assert sorted(rr.msgs) == sorted((0, p) for p in out)
        assert sorted(rp.msgs) == sorted((1, p) for p in back)
    finally:
        port.stop()
        ref.stop()
