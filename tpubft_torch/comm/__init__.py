"""Communication layer — node-addressed async message passing (port of
tpubft/comm/).

Ported: the interfaces (ICommunication, IReceiver), the in-process
loopback bus with its byzantine hooks, UDP datagrams (over the port's
own netio.cpp), length-prefixed TCP, TLS with pinned certificates (its
material written without `cryptography`), the endpoint multiplexer and
the factory.
"""
from tpubft_torch.comm.factory import create_communication
from tpubft_torch.comm.interfaces import (CommConfig, ConnectionStatus,
                                          ICommunication, IReceiver)
from tpubft_torch.comm.loopback import LoopbackBus, LoopbackCommunication
from tpubft_torch.comm.multiplex import (MultiplexClientHub,
                                         MultiplexTransport, client_floor)
from tpubft_torch.comm.tcp import PlainTcpCommunication
from tpubft_torch.comm.tls import TlsConfig, TlsTcpCommunication
from tpubft_torch.comm.udp import PlainUdpCommunication

__all__ = [
    "CommConfig", "ConnectionStatus", "ICommunication", "IReceiver",
    "LoopbackBus", "LoopbackCommunication", "MultiplexClientHub",
    "MultiplexTransport", "PlainTcpCommunication", "PlainUdpCommunication",
    "TlsConfig", "TlsTcpCommunication", "client_floor",
    "create_communication",
]
