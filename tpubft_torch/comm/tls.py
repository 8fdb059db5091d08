"""TLS transport with per-node pinned certificates (port of
tpubft/comm/tls.py, the same handshake, pins and wire).

Rebuild of concord-bft's production transport
(communication/src/TlsTCPCommunication.cpp +
AsyncTlsConnection.cpp): TLS over the length-prefixed TCP framing, with
each node presenting its own self-signed certificate and every peer
pinned by certificate — an attacker with network access but no node key
can neither impersonate a replica nor read traffic.

Authentication model (concord-bft AsyncTlsConnection::verifyCertificate):
  * every node has a key + self-signed cert; the cluster's cert set is
    distributed out of band (keygen writes a certs dir per deployment);
  * both sides request and verify the peer certificate against a trust
    bundle of exactly the cluster's certs (each self-signed cert acts as
    its own CA — nothing outside the bundle can handshake at all);
  * the presented certificate is then BOUND to the claimed node id by
    SHA-256 fingerprint pinning: the dialer checks the acceptor's cert
    is node X's cert, the acceptor checks the id sent in the handshake
    matches the cert that authenticated the connection. A valid cluster
    member can therefore not impersonate another member either.

Threading/framing are inherited from PlainTcpCommunication; the hooks
(_wrap_outbound/_wrap_inbound/_authenticate_inbound) insert the TLS
handshake and pin checks. ssl.SSLError subclasses OSError, so the base
transport's error paths handle refused handshakes as dead connections.

Port divergence (reference tls.py:148-194): generate_tls_material writes
the certificates and keys as DER itself (comm/_der.py) over the port's
P-256 signer in crypto/scalar.py and, with a password, PBES2 over the
port's native/aescbc.cpp; no module of the port imports `cryptography`.
The transport itself uses the stdlib `ssl` only, as the reference's does.
"""
from __future__ import annotations

import hashlib
import os
import socket
import ssl
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from tpubft_torch.comm.interfaces import CommConfig, NodeNum
from tpubft_torch.comm.tcp import PlainTcpCommunication
from tpubft_torch.utils.logging import get_logger

log = get_logger("comm.tls")


def cert_path(certs_dir: str, node: NodeNum) -> str:
    return os.path.join(certs_dir, f"node-{node}.crt")


def key_path(certs_dir: str, node: NodeNum) -> str:
    return os.path.join(certs_dir, f"node-{node}.key")


@dataclass
class TlsConfig(CommConfig):
    """CommConfig + certificate material (concord-bft TlsTcpConfig,
    communication/include/communication/CommDefs.hpp). `certs_dir` holds
    node-<id>.crt for every endpoint and this node's node-<self>.key;
    `key_password` decrypts the private key when it was generated
    encrypted-at-rest (keygen --password, the secretsmanager role)."""
    certs_dir: str = ""
    key_password: Optional[str] = None
    # multiplex mode (concord-bft TlsMultiplexConfig): ids at or above this
    # floor are client-space principals that may share carrier
    # connections; None = plain one-connection-per-pair TLS
    mux_client_floor: Optional[int] = None


def _fingerprint(der: bytes) -> bytes:
    return hashlib.sha256(der).digest()


def _load_cert(path: str) -> Tuple[str, bytes]:
    """One read per cert: (PEM text for the trust bundle, DER for the
    pin)."""
    with open(path) as f:
        pem = f.read()
    return pem, ssl.PEM_cert_to_DER_cert(pem)


class TlsTcpCommunication(PlainTcpCommunication):
    # OpenSSL forbids concurrent SSL_read/SSL_write on one SSL object
    # from two threads; directional legs give each SSL socket exactly
    # one I/O thread (see _Peer's docstring)
    directional = True

    def __init__(self, config: TlsConfig):
        super().__init__(config)
        certs_dir = config.certs_dir
        if not certs_dir:
            raise ValueError(
                "TLS transport requires TlsConfig.certs_dir (a directory "
                "with node-<id>.crt for every endpoint and this node's "
                "node-<id>.key; generate with keygen --tls-certs)")
        # trust bundle = exactly the cluster's certs; pin table binds
        # each node id to its certificate fingerprint
        self._pins: Dict[NodeNum, bytes] = {}
        bundle = []
        for node in config.endpoints:
            pem, der = _load_cert(cert_path(certs_dir, node))
            self._pins[node] = _fingerprint(der)
            bundle.append(pem)
        cadata = "".join(bundle)
        own_cert = cert_path(certs_dir, config.self_id)
        own_key = key_path(certs_dir, config.self_id)

        pw = config.key_password
        self._server_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        self._server_ctx.minimum_version = ssl.TLSVersion.TLSv1_3
        self._server_ctx.load_cert_chain(own_cert, own_key, password=pw)
        self._server_ctx.load_verify_locations(cadata=cadata)
        self._server_ctx.verify_mode = ssl.CERT_REQUIRED  # mutual TLS

        self._client_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        self._client_ctx.minimum_version = ssl.TLSVersion.TLSv1_3
        self._client_ctx.load_cert_chain(own_cert, own_key, password=pw)
        self._client_ctx.load_verify_locations(cadata=cadata)
        # identity is the pinned fingerprint, not a DNS name
        self._client_ctx.check_hostname = False
        self._client_ctx.verify_mode = ssl.CERT_REQUIRED

    # ---- hook implementations ----

    def _peer_fp(self, sock: ssl.SSLSocket) -> Optional[bytes]:
        der = sock.getpeercert(binary_form=True)
        return _fingerprint(der) if der else None

    def _wrap_outbound(self, sock: socket.socket,
                       node: NodeNum) -> socket.socket:
        tls = self._client_ctx.wrap_socket(sock)
        if self._peer_fp(tls) != self._pins.get(node):
            log.warning("dialed node %d presented a foreign certificate",
                        node)
            tls.close()
            raise OSError("certificate pin mismatch")
        return tls

    def _wrap_inbound(self, sock: socket.socket) -> socket.socket:
        return self._server_ctx.wrap_socket(sock, server_side=True)

    def _authenticate_inbound(self, sock: socket.socket,
                              peer_id: NodeNum) -> bool:
        ok = (isinstance(sock, ssl.SSLSocket)
              and self._peer_fp(sock) == self._pins.get(peer_id))
        if not ok:
            log.warning("inbound connection claimed id %d but its "
                        "certificate is pinned to a different node", peer_id)
        return ok


def generate_tls_material(certs_dir: str, node_ids,
                          seed: Optional[bytes] = None,
                          password: Optional[str] = None) -> None:
    """Write node-<id>.key / node-<id>.crt for every node (the keygen
    tool's cert role — concord-bft GenerateConcordKeys emits the TLS certs
    alongside the threshold keys). Self-signed ECDSA P-256, CN carries
    the node id. `seed` derives deterministic keys — TESTS ONLY (a TLS
    cert is public, so a derivable key = impersonation); `password`
    encrypts the private keys at rest (secretsmanager role)."""
    from tpubft_torch.comm import _der
    from tpubft_torch.crypto.scalar import (ecdsa_random_private,
                                            ecdsa_seed_to_private)

    os.makedirs(certs_dir, exist_ok=True)
    for node in node_ids:
        if seed is not None:
            # same P-256 seed derivation as the signing keyfiles (the
            # scalar engine owns the formula)
            d = ecdsa_seed_to_private(seed + b"|tls|" + str(node).encode(),
                                      "secp256r1")
        else:
            d = ecdsa_random_private("secp256r1")
        key_pem, cert_pem = _der.tls_material(d, f"tpubft-node-{node}",
                                              password)
        with open(key_path(certs_dir, node), "wb") as f:
            f.write(key_pem)
        with open(cert_path(certs_dir, node), "wb") as f:
            f.write(cert_pem)
