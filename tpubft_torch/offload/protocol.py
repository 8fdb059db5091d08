"""Lease wire protocol for the crypto-offload tier (port of
tpubft/offload/protocol.py; the frames are the reference's byte for
byte, so a port replica leases to a reference helper and back).

Length-prefixed frames (the thinreplica transport idiom: 4-byte LE u32
length, oversize frames rejected) carrying one lease request or
response each. The encodings are deliberately dumb — fixed-width
headers + concatenated compressed points — because the helper must be
implementable without any replica protocol state: it sees points and
scalars, never consensus messages.

Call-site confinement: everything in this module (and the raw socket
plumbing in pool/helper) is tpubft_torch/offload/-only, enforced by an
AST scan (tests/test_torch_offload_seam.py). Crypto call sites reach the
tier through the verified high-level API in `tpubft_torch.offload.pool`.
"""
from __future__ import annotations

import socket
import struct
from typing import List, Optional, Sequence, Tuple

MAX_FRAME = 1 << 22          # same bound as the thinreplica transport

# lease kinds
KIND_BLS_COMBINE = 1         # threshold Lagrange combine, per segment
KIND_BLS_SUM = 2             # multisig unweighted G1 sum, per segment
KIND_ECDSA_RLC = 3           # ECDSA verdict bits, per item

KIND_NAMES = {KIND_BLS_COMBINE: "bls-combine", KIND_BLS_SUM: "bls-sum",
              KIND_ECDSA_RLC: "ecdsa-rlc"}

ST_OK = 0
ST_ERR = 1

G1_LEN = 48                  # compressed G1 point

_CURVE_IDS = {"secp256k1": 0, "secp256r1": 1}
_CURVE_BY_ID = {v: k for k, v in _CURVE_IDS.items()}


class ProtocolError(ValueError):
    """Malformed frame/payload — at the replica side this is evidence
    of a lying helper, not a transport fault."""


# ---------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------

def send_frame(sock: socket.socket, body: bytes) -> None:
    if len(body) > MAX_FRAME:
        raise ProtocolError(f"frame too large ({len(body)} bytes)")
    sock.sendall(struct.pack("<I", len(body)) + body)


def recv_frame(sock: socket.socket) -> Optional[bytes]:
    """One frame, or None on clean EOF. Raises on oversize/truncation
    (socket timeouts propagate as socket.timeout)."""
    hdr = _recv_exact(sock, 4)
    if hdr is None:
        return None
    (n,) = struct.unpack("<I", hdr)
    if n > MAX_FRAME:
        raise ProtocolError(f"oversize frame ({n} bytes)")
    body = _recv_exact(sock, n)
    if body is None:
        raise ProtocolError("truncated frame")
    return body


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


# ---------------------------------------------------------------------
# request / response envelopes
# ---------------------------------------------------------------------

def encode_request(lease_id: int, kind: int, deadline_ms: int,
                   payload: bytes) -> bytes:
    return struct.pack("<QBI", lease_id, kind, deadline_ms) + payload


def decode_request(body: bytes) -> Tuple[int, int, int, bytes]:
    if len(body) < 13:
        raise ProtocolError("short lease request")
    lease_id, kind, deadline_ms = struct.unpack_from("<QBI", body, 0)
    return lease_id, kind, deadline_ms, body[13:]


def encode_response(lease_id: int, status: int, payload: bytes) -> bytes:
    return struct.pack("<QB", lease_id, status) + payload


def decode_response(body: bytes) -> Tuple[int, int, bytes]:
    if len(body) < 9:
        raise ProtocolError("short lease response")
    lease_id, status = struct.unpack_from("<QB", body, 0)
    return lease_id, status, body[9:]


# ---------------------------------------------------------------------
# BLS combine / sum payloads: segments of identified compressed shares
# ---------------------------------------------------------------------

def encode_bls_segments(segments: Sequence[Tuple[Sequence[int],
                                                 Sequence[bytes]]]) -> bytes:
    """[(ids, [48B compressed G1 shares])] — for KIND_BLS_SUM the ids
    still travel (the helper ignores them; keeping one encoding keeps
    the helper dumb)."""
    out = [struct.pack("<I", len(segments))]
    for ids, pts in segments:
        if len(ids) != len(pts):
            raise ProtocolError("ids/points length mismatch")
        out.append(struct.pack("<I", len(ids)))
        out.append(struct.pack(f"<{len(ids)}I", *ids) if ids else b"")
        for p in pts:
            if len(p) != G1_LEN:
                raise ProtocolError("bad G1 share length")
            out.append(p)
    return b"".join(out)


def decode_bls_segments(payload: bytes
                        ) -> List[Tuple[List[int], List[bytes]]]:
    try:
        (nsegs,) = struct.unpack_from("<I", payload, 0)
        off = 4
        segs: List[Tuple[List[int], List[bytes]]] = []
        for _ in range(nsegs):
            (k,) = struct.unpack_from("<I", payload, off)
            off += 4
            ids = list(struct.unpack_from(f"<{k}I", payload, off))
            off += 4 * k
            pts = []
            for _ in range(k):
                pts.append(payload[off:off + G1_LEN])
                off += G1_LEN
                if len(pts[-1]) != G1_LEN:
                    raise ProtocolError("truncated share")
            segs.append((ids, pts))
        if off != len(payload):
            raise ProtocolError("trailing bytes in segments payload")
        return segs
    except struct.error as e:
        raise ProtocolError(str(e)) from e


def encode_points(pts: Sequence[bytes]) -> bytes:
    for p in pts:
        if len(p) != G1_LEN:
            raise ProtocolError("bad G1 point length")
    return b"".join(pts)


def decode_points(payload: bytes, expect: int) -> Optional[List[bytes]]:
    """Fixed-count compressed points; None (not an exception) on a
    shape mismatch — the caller classifies that as a lying helper."""
    if len(payload) != expect * G1_LEN:
        return None
    return [payload[i * G1_LEN:(i + 1) * G1_LEN] for i in range(expect)]


# ---------------------------------------------------------------------
# ECDSA payloads: (digest, sig, pk) items -> verdict bytes
# ---------------------------------------------------------------------

def encode_ecdsa_items(curve: str,
                       items: Sequence[Tuple[bytes, bytes, bytes]]) -> bytes:
    out = [struct.pack("<BI", _CURVE_IDS[curve], len(items))]
    for d, s, pk in items:
        out.append(struct.pack("<III", len(d), len(s), len(pk)))
        out.extend((d, s, pk))
    return b"".join(out)


def decode_ecdsa_items(payload: bytes
                       ) -> Tuple[str, List[Tuple[bytes, bytes, bytes]]]:
    try:
        curve_id, n = struct.unpack_from("<BI", payload, 0)
        curve = _CURVE_BY_ID.get(curve_id)
        if curve is None:
            raise ProtocolError(f"unknown curve id {curve_id}")
        off = 5
        items = []
        for _ in range(n):
            dl, sl, pl = struct.unpack_from("<III", payload, off)
            off += 12
            if off + dl + sl + pl > len(payload):
                raise ProtocolError("truncated ecdsa item")
            d = payload[off:off + dl]; off += dl
            s = payload[off:off + sl]; off += sl
            pk = payload[off:off + pl]; off += pl
            items.append((d, s, pk))
        if off != len(payload):
            raise ProtocolError("trailing bytes in ecdsa payload")
        return curve, items
    except struct.error as e:
        raise ProtocolError(str(e)) from e


def encode_verdicts(bits: Sequence[bool]) -> bytes:
    return bytes(1 if b else 0 for b in bits)


def decode_verdicts(payload: bytes, expect: int) -> Optional[List[bool]]:
    if len(payload) != expect or any(b > 1 for b in payload):
        return None
    return [bool(b) for b in payload]
