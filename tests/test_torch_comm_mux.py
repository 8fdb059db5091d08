"""The port's endpoint multiplexer (tpubft_torch/comm/multiplex.py) over
plain TCP, as tests/test_comm_mux.py holds the reference's (routing,
reply learning, the spoof guards), and its frames and routing decisions
against the reference's on the same seeded traffic."""
import struct
import threading
import time

import numpy as np
import pytest

from tpubft.comm import multiplex as ref_mux
from tpubft.comm.interfaces import ConnectionStatus as RefStatus
from tpubft_torch.comm import CommConfig
from tpubft_torch.comm import multiplex as mux
from tpubft_torch.comm.interfaces import ConnectionStatus
from tpubft_torch.comm.tcp import PlainTcpCommunication

from tests.test_torch_comm import free_ports


class _Collector:
    def __init__(self):
        self.got = []
        self.lock = threading.Lock()

    def on_connection_status_changed(self, *_):
        pass

    def on_new_message(self, sender, data):
        with self.lock:
            self.got.append((int(sender), data))

    def wait(self, n, timeout=10.0):
        deadline = time.monotonic() + timeout
        while len(self.got) < n and time.monotonic() < deadline:
            time.sleep(0.02)
        return len(self.got) >= n


def _eps():
    # node 0 = "replica", node 4 = carrier; principals 5,6 ride node 4's
    # connection and have no sockets of their own
    p0, p4 = free_ports(2)
    return {0: ("127.0.0.1", p0), 4: ("127.0.0.1", p4)}


def test_client_floor_matches_the_reference():
    for n, ro in ((4, 0), (7, 1), (31, 2)):
        assert mux.client_floor(n, ro) == ref_mux.client_floor(n, ro)


def test_multiplex_routing_and_reply_learning():
    eps = _eps()
    replica_rx = _Collector()
    replica = mux.MultiplexTransport(
        PlainTcpCommunication(CommConfig(self_id=0, endpoints=eps)),
        self_id=0, is_client=lambda i: i >= 4)
    replica.start(replica_rx)

    hub = mux.MultiplexClientHub(
        PlainTcpCommunication(CommConfig(self_id=4, endpoints=eps)))
    p5, p6 = hub.endpoint(5), hub.endpoint(6)
    rx5, rx6 = _Collector(), _Collector()
    p5.start(rx5)
    p6.start(rx6)
    try:
        # two principals, one carrier: the replica sees each principal
        # as the sender even though the socket belongs to node 4
        p5.send(0, b"from-5")
        p6.send(0, b"from-6")
        assert replica_rx.wait(2)
        assert sorted(replica_rx.got) == [(5, b"from-5"), (6, b"from-6")]
        # replies route back over the LEARNED carrier and land at the
        # right principal's receiver
        replica.send(5, b"to-5")
        replica.send(6, b"to-6")
        assert rx5.wait(1) and rx6.wait(1)
        assert rx5.got == [(0, b"to-5")]
        assert rx6.got == [(0, b"to-6")]
    finally:
        hub.stop()
        replica.stop()
    assert not p5.is_running() and not p6.is_running()


def test_multiplex_spoof_guards():
    eps = _eps()
    replica_rx = _Collector()
    replica = mux.MultiplexTransport(
        PlainTcpCommunication(CommConfig(self_id=0, endpoints=eps)),
        self_id=0, is_client=lambda i: i >= 4)
    replica.start(replica_rx)
    raw = PlainTcpCommunication(CommConfig(self_id=4, endpoints=eps))
    raw.start(_Collector())
    try:
        # a client carrier claiming a REPLICA-space endpoint: dropped
        raw.send(0, struct.pack("<I", 1) + b"spoof-replica")
        # a truncated frame: dropped
        raw.send(0, b"\x05")
        # a legitimate principal frame still flows afterwards
        raw.send(0, struct.pack("<I", 7) + b"ok")
        assert replica_rx.wait(1)
        time.sleep(0.05)
        assert replica_rx.got == [(7, b"ok")]
    finally:
        raw.stop()
        replica.stop()


class _Wire:
    """An inner transport that records what is sent and reports every
    carrier in `alive` as connected (either package's enum)."""

    def __init__(self, status_enum, alive=()):
        self.sent = []
        self.receiver = None
        self.alive = set(alive)
        self.status = status_enum

    def start(self, receiver):
        self.receiver = receiver

    def stop(self):
        pass

    def is_running(self):
        return True

    max_message_size = 1 << 16

    def send(self, dest, data):
        self.sent.append((int(dest), data))

    def get_connection_status(self, node):
        return (self.status.CONNECTED if node in self.alive
                else self.status.DISCONNECTED)


def _drive(pkg, status_enum, seed):
    """Seeded inbound frames from replica and client carriers (some
    spoofed, some truncated, some re-binding a principal), then replies
    to every principal and replica: -> (delivered, sent)."""
    rng = np.random.default_rng(seed)
    wire = _Wire(status_enum, alive={4, 5})
    rx = _Collector()
    t = pkg.MultiplexTransport(wire, self_id=0, is_client=lambda i: i >= 4)
    t.start(rx)
    for _ in range(60):
        src = int(rng.choice([1, 2, 3, 4, 5, 6]))
        kind = rng.integers(0, 4)
        if kind == 0:
            frame = b"\x01\x02"              # truncated
        else:
            ep = int(rng.choice([0, 1, 2, 4, 5, 6, 7, 8]))
            frame = struct.pack("<I", ep) + rng.integers(
                0, 256, int(rng.integers(0, 40)), dtype=np.uint8).tobytes()
        if rng.integers(0, 8) == 0:
            wire.alive ^= {int(rng.choice([4, 5, 6]))}
        wire.receiver.on_new_message(src, frame)
    for dest in range(9):
        t.send(dest, b"reply-%d" % dest)
    return rx.got, wire.sent


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_multiplex_frames_and_routing_equal_the_reference(seed):
    port = _drive(mux, ConnectionStatus, seed)
    ref = _drive(ref_mux, RefStatus, seed)
    assert port == ref
    assert port[0] and port[1]


def test_hub_frames_equal_the_reference():
    port_wire, ref_wire = _Wire(ConnectionStatus), _Wire(RefStatus)
    port_hub = mux.MultiplexClientHub(port_wire)
    ref_hub = ref_mux.MultiplexClientHub(ref_wire)
    for hub in (port_hub, ref_hub):
        for p in (5, 6, 9):
            ep = hub.endpoint(p)
            ep.start(_Collector())
            ep.send(0, b"req-%d" % p)
            ep.send(2, b"")
    assert port_wire.sent == ref_wire.sent
    assert port_wire.sent[0] == (0, struct.pack("<I", 5) + b"req-5")
