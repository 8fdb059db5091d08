"""Communication layer — node-addressed async message passing (port of
tpubft/comm/).

Ported: the interfaces (ICommunication, IReceiver), the in-process
loopback bus with its byzantine hooks, UDP datagrams (over the port's
own netio.cpp), length-prefixed TCP, the endpoint multiplexer and the
factory. TLS is ROADMAP A.9.1b: the factory refuses it.
"""
from tpubft_torch.comm.factory import create_communication
from tpubft_torch.comm.interfaces import (CommConfig, ConnectionStatus,
                                          ICommunication, IReceiver)
from tpubft_torch.comm.loopback import LoopbackBus, LoopbackCommunication
from tpubft_torch.comm.multiplex import (MultiplexClientHub,
                                         MultiplexTransport, client_floor)
from tpubft_torch.comm.tcp import PlainTcpCommunication
from tpubft_torch.comm.udp import PlainUdpCommunication

__all__ = [
    "CommConfig", "ConnectionStatus", "ICommunication", "IReceiver",
    "LoopbackBus", "LoopbackCommunication", "MultiplexClientHub",
    "MultiplexTransport", "PlainTcpCommunication", "PlainUdpCommunication",
    "client_floor", "create_communication",
]
