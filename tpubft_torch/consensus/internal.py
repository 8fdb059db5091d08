"""Internal BFT client + the consensus-internal operations riding it.

Rebuild of the reference's InternalBFTClient
(concord-bft bftengine/src/bftengine/InternalBFTClient.cpp) and the
subsystems that submit requests through it: KeyExchangeManager
(KeyExchangeManager.cpp — rotates a replica's signing key via an ordered,
self-signed request) and the TimeServiceManager
(TimeServiceManager.hpp — primary-stamped, replica-validated, consensus-
agreed monotonic clock persisted in a reserved page).

Every replica owns one internal client principal (id =
first_client_id + num_clients + replica_id); its requests are signed with
the replica's key and executed by the replica engine itself rather than
the application handler.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from tpubft_torch.consensus import messages as m
from tpubft_torch.consensus.reserved_pages import ReservedPagesClient
from tpubft_torch.crypto.cpu import Ed25519Signer
from tpubft_torch.utils import serialize as ser


# ---------------- internal operation envelope ----------------

@dataclass
class KeyExchangeOp:
    """Replica `replica_id` announces a new signing public key."""
    ID = 1
    replica_id: int = 0
    pubkey: bytes = b""
    generation: int = 0
    SPEC = [("replica_id", "u32"), ("pubkey", "bytes"),
            ("generation", "u64")]


@dataclass
class TickOp:
    """Deterministic cron tick for one component (ccron TickInternalMsg)."""
    ID = 2
    component: str = ""
    tick_seq: int = 0
    SPEC = [("component", "str"), ("tick_seq", "u64")]


_OPS = {cls.ID: cls for cls in (KeyExchangeOp, TickOp)}


def pack_op(op) -> bytes:
    return bytes([op.ID]) + ser.encode_msg(op)


def unpack_op(data: bytes):
    if not data or data[0] not in _OPS:
        raise ser.SerializeError(f"unknown internal op {data[:1]!r}")
    return ser.decode_msg(data[1:], _OPS[data[0]])


# ---------------- internal client ----------------

class InternalBFTClient:
    """Lets the replica submit requests into its own consensus
    (key exchange, cron ticks, reconfiguration)."""

    RETRANSMIT_PERIOD_S = 1.0
    MAX_RETRANSMITS = 30

    def __init__(self, replica) -> None:
        self._replica = replica
        self.client_id = replica.info.internal_client_of(replica.id)
        # req seqnums must survive restarts (at-most-once filtering);
        # wall-clock ms + in-process counter is monotonic enough
        self._req_seq = int(time.time() * 1000)
        self._pending: Dict[int, tuple] = {}  # req_seq -> (raw, sent, tries)
        replica.dispatcher.add_timer(self.RETRANSMIT_PERIOD_S,
                                     self._retransmit_pending)

    def submit(self, payload: bytes,
               flags: int = int(m.RequestFlag.INTERNAL)) -> int:
        self._req_seq += 1
        req = m.ClientRequestMsg(
            sender_id=self.client_id, req_seq_num=self._req_seq,
            flags=flags | int(m.RequestFlag.INTERNAL), request=payload,
            cid=f"int-{self._replica.id}-{self._req_seq}", signature=b"")
        req.signature = self._replica.sig.sign(req.signed_payload())
        raw = req.pack()
        self._pending[self._req_seq] = (raw, time.monotonic(), 0)
        self._broadcast(raw)
        return self._req_seq

    def _broadcast(self, raw: bytes) -> None:
        for r in self._replica.info.other_replicas(self._replica.id):
            self._replica.comm.send(r, raw)
        # self-delivery through the normal external queue
        self._replica.incoming.push_external(self.client_id, raw)

    def _retransmit_pending(self) -> None:
        """Internal requests are not fire-and-forget: keep resending until
        ordered+executed (a one-shot key exchange lost at startup would
        otherwise never happen)."""
        now = time.monotonic()
        clients = self._replica.clients
        for seq in sorted(self._pending):
            raw, sent, tries = self._pending[seq]
            if (clients.was_executed(self.client_id, seq)
                    or tries >= self.MAX_RETRANSMITS):
                del self._pending[seq]
                continue
            if now - sent >= self.RETRANSMIT_PERIOD_S:
                self._pending[seq] = (raw, now, tries + 1)
                self._broadcast(raw)


# ---------------- key exchange ----------------

class KeyExchangeManager:
    """Orders a replica's new signing key through consensus and swaps it
    on execution; exchanged keys persist in reserved pages so state-
    transferred replicas adopt them (reference KeyExchangeManager +
    ClientsPubKeysStore roles)."""

    CATEGORY = "keyex"

    def __init__(self, replica, pages: ReservedPagesClient) -> None:
        self._replica = replica
        self._pages = pages
        self._candidates: Dict[int, Ed25519Signer] = {}  # generation -> key
        self._generation = 0

    def initiate(self) -> int:
        """Generate a candidate key and submit the exchange op
        (sendInitialKey / sendKeyExchange). The rotated-in key keeps the
        cluster's replica signature scheme — verifiers derive theirs from
        it per principal."""
        from tpubft_torch.crypto.cpu import make_signer
        signer = make_signer(self._replica.keys.replica_sig_scheme,
                             seed=os.urandom(32))
        self._generation += 1
        self._candidates[self._generation] = signer
        op = KeyExchangeOp(replica_id=self._replica.id,
                           pubkey=signer.public_bytes(),
                           generation=self._generation)
        self._replica.internal_client.submit(
            pack_op(op), flags=int(m.RequestFlag.KEY_EXCHANGE))
        return self._generation

    def on_executed(self, op: KeyExchangeOp, seq: int = 0) -> None:
        """Ordered on every replica: swap the principal's public key; the
        owner additionally activates its private candidate. `seq` is the
        consensus seqnum the exchange executed at — it scopes the old
        key's grace window (SigManager seq-scoped grace)."""
        from tpubft_torch.utils.logging import get_logger
        get_logger("keyexchange").info(
            "key rotation executed for replica %d at seq %d",
            op.replica_id, seq)
        self._replica.sig.set_replica_key(op.replica_id, op.pubkey,
                                          rotation_seq=seq)
        self._pages.save(op.pubkey, index=op.replica_id)
        if op.replica_id == self._replica.id:
            cand = self._candidates.pop(op.generation, None)
            if cand is not None and cand.public_bytes() == op.pubkey:
                self._replica.sig.set_my_signer(cand)

    def load_from_pages(self) -> None:
        """Startup / post-state-transfer: adopt previously exchanged keys."""
        for r in self._replica.info.replica_ids:
            pk = self._pages.load(index=r)
            if pk:
                self._replica.sig.set_replica_key(r, pk)


# ---------------- time service ----------------

class TimeServiceManager:
    """Consensus-agreed monotonic clock (reference TimeServiceManager +
    TimeServiceResPageClient): the primary stamps each PrePrepare; backups
    bound it against their clock; execution advances the agreed time."""

    CATEGORY = "time"

    # opinions older than this are stale (their holder may be dead; the
    # estimate would drift with the receipt-age extrapolation)
    OPINION_TTL_S = 10.0

    def __init__(self, pages: ReservedPagesClient,
                 max_skew_ms: int = 1000,
                 clock: Callable[[], float] = time.time,
                 mono: Callable[[], float] = time.monotonic) -> None:
        self._pages = pages
        self._clock = clock
        self._mono = mono
        self.max_skew_ms = max_skew_ms
        raw = pages.load()
        self.last_agreed_ms = int.from_bytes(raw, "big") if raw else 0
        self._last_stamp = 0
        # replica time voting: peer id -> (claimed t_ms, receipt mono).
        # quorum = 2f+1 clocks incl. our own: the median of >= 2f+1
        # samples with at most f faulty is BRACKETED by honest clocks —
        # f+1 would let f fresh faulty opinions plus our own clock put
        # the median entirely under attacker control.
        self.opinions: dict = {}
        self.opinion_quorum = 0         # set by the replica (2f+1); 0=off

    def add_opinion(self, replica_id: int, t_ms: int) -> bool:
        """Record a peer's clock reading. Rejects non-monotone values —
        a replayed old (still validly signed) opinion must not replace a
        newer one, or a single faulty replica could re-send the cluster's
        hour-old opinions and drag the median arbitrarily into the past —
        and implausible ones (farther from our clock than any envelope
        could tolerate; such a clock can never contribute a useful vote,
        but unbounded it could steer the median)."""
        prev = self.opinions.get(replica_id)
        if prev is not None and t_ms <= prev[0]:
            return False
        plaus = 10 * self.max_skew_ms + int(self.OPINION_TTL_S * 1000)
        if abs(t_ms - int(self._clock() * 1000)) > plaus:
            return False
        self.opinions[replica_id] = (t_ms, self._mono())
        return True

    def envelope_median_ms(self) -> Optional[int]:
        """The cluster's agreed 'now': median of fresh peer opinions
        (each extrapolated by its receipt age) plus our own clock. None
        until opinion_quorum distinct clocks are represented."""
        if self.opinion_quorum <= 0:
            return None
        now_mono = self._mono()
        estimates = [int(self._clock() * 1000)]
        for t_ms, at in self.opinions.values():
            age = now_mono - at
            if age <= self.OPINION_TTL_S:
                estimates.append(t_ms + int(age * 1000))
        if len(estimates) < self.opinion_quorum:
            return None
        estimates.sort()
        return estimates[len(estimates) // 2]

    def primary_stamp(self) -> int:
        """Strictly increasing across PIPELINED proposals too — two
        PrePrepares stamped in the same millisecond would make backups
        that executed the first reject the second forever."""
        self._last_stamp = max(int(self._clock() * 1000),
                               self.last_agreed_ms + 1,
                               self._last_stamp + 1)
        return self._last_stamp

    def validate(self, t_ms: int) -> bool:
        if t_ms <= self.last_agreed_ms:
            return False
        if t_ms > int(self._clock() * 1000) + self.max_skew_ms:
            return False
        # voting envelope: with f+1 clocks represented, the primary's
        # stamp must also sit within the median's skew bound — a primary
        # whose clock races ahead of the cluster is rejected even by a
        # backup whose own clock races with it
        median = self.envelope_median_ms()
        if median is not None and abs(t_ms - median) > self.max_skew_ms:
            return False
        return True

    def on_executed(self, t_ms: int) -> None:
        if t_ms > self.last_agreed_ms:
            self.last_agreed_ms = t_ms
            self._pages.save(t_ms.to_bytes(8, "big"))

    def reload(self) -> None:
        raw = self._pages.load()
        if raw:
            self.last_agreed_ms = max(self.last_agreed_ms,
                                      int.from_bytes(raw, "big"))
