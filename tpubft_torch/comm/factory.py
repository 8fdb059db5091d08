"""Transport factory: build an ICommunication from a config (port of
tpubft/comm/factory.py).

Rebuild of the reference's CommFactory
(concord-bft communication/src/CommFactory.cpp — `create` dispatches
on the config struct type: PlainUdpConfig / PlainTcpConfig /
TlsTcpConfig, CommDefs.hpp). Same pattern: a TlsConfig selects the TLS
transport by type; the string form serves flag-driven app wiring
(reference CONCORD_BFT_CMAKE_TRANSPORT selects at build time — here it's
a runtime choice)."""
from __future__ import annotations

from tpubft_torch.comm.interfaces import CommConfig, ICommunication
from tpubft_torch.comm.tcp import PlainTcpCommunication
from tpubft_torch.comm.udp import PlainUdpCommunication


def create_communication(config: CommConfig,
                         transport: str = "") -> ICommunication:
    """Type-dispatch (TlsConfig => TLS) with an optional string override:
    "udp" | "tcp" | "tls" | "tls-mux"."""
    from tpubft_torch.comm.tls import TlsConfig, TlsTcpCommunication
    if transport == "" and isinstance(config, TlsConfig):
        transport = "tls"
    transport = transport or "udp"
    if transport == "udp":
        return PlainUdpCommunication(config)
    if transport == "tcp":
        return PlainTcpCommunication(config)
    if transport == "tls":
        if not isinstance(config, TlsConfig):
            raise TypeError("tls transport needs a TlsConfig "
                            "(certs_dir with node keys/certs)")
        return TlsTcpCommunication(config)
    if transport == "tls-mux":
        # concord-bft TlsMultiplexCommunication: endpoint-numbered frames
        # over the TLS transport so many principals share connections
        if not isinstance(config, TlsConfig):
            raise TypeError("tls-mux transport needs a TlsConfig")
        if config.mux_client_floor is None:
            raise ValueError("tls-mux needs TlsConfig.mux_client_floor "
                             "(first client-space principal id)")
        from tpubft_torch.comm.multiplex import MultiplexTransport
        floor = config.mux_client_floor
        return MultiplexTransport(TlsTcpCommunication(config),
                                  self_id=config.self_id,
                                  is_client=lambda i: i >= floor)
    raise ValueError(f"unknown transport {transport!r}")
