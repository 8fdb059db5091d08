"""Transport factory: build an ICommunication from a config (port of
tpubft/comm/factory.py).

Rebuild of the reference's CommFactory
(concord-bft communication/src/CommFactory.cpp — `create` dispatches
on the config struct type: PlainUdpConfig / PlainTcpConfig /
TlsTcpConfig, CommDefs.hpp). The string form serves flag-driven app
wiring (reference CONCORD_BFT_CMAKE_TRANSPORT selects at build time —
here it's a runtime choice).

Port divergence (reference factory.py:20-46): the TLS transport is not
ported yet (ROADMAP A.9.1b), so "tls", "tls-mux" and a TLS config (one
that carries a `certs_dir`) are refused with NotImplementedError.
"""
from __future__ import annotations

from tpubft_torch.comm.interfaces import CommConfig, ICommunication
from tpubft_torch.comm.tcp import PlainTcpCommunication
from tpubft_torch.comm.udp import PlainUdpCommunication


def create_communication(config: CommConfig,
                         transport: str = "") -> ICommunication:
    """String dispatch: "udp" (the default) | "tcp"."""
    if transport in ("tls", "tls-mux") or hasattr(config, "certs_dir"):
        from tpubft_torch.consensus.replica import _not_ported
        _not_ported(f"transport {transport or 'tls'!r}", "A.9.1b")
    transport = transport or "udp"
    if transport == "udp":
        return PlainUdpCommunication(config)
    if transport == "tcp":
        return PlainTcpCommunication(config)
    raise ValueError(f"unknown transport {transport!r}")
