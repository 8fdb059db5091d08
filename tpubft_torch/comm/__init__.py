"""Communication layer — node-addressed async message passing (port of
tpubft/comm/).

Ported: the interfaces (ICommunication, IReceiver) and the in-process
loopback bus with its byzantine hooks. UDP, TCP, TLS, the multiplexer
and the factory are ROADMAP A.9.
"""
from tpubft_torch.comm.interfaces import (CommConfig, ConnectionStatus,
                                          ICommunication, IReceiver)
from tpubft_torch.comm.loopback import LoopbackBus, LoopbackCommunication

__all__ = [
    "CommConfig", "ConnectionStatus", "ICommunication", "IReceiver",
    "LoopbackBus", "LoopbackCommunication",
]
