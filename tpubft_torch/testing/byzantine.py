"""Byzantine strategies — fault-injecting communication wrappers.

Rebuild of the reference's TesterReplica strategy framework
(concord-bft tests/simpleKVBC/TesterReplica/strategy/,
WrapCommunication.cpp): an otherwise-honest replica is wrapped so its
*outgoing* messages are dropped, delayed, corrupted, or misdirected.
Strategies are selected by name (`--strategy` on the tester replica, or
passed to the in-process cluster) so system tests can inject faults
without touching protocol code.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, Iterable, Optional

from tpubft_torch.comm.interfaces import (ConnectionStatus, ICommunication,
                                    IReceiver, NodeNum)


class WrapCommunication(ICommunication):
    """Delegates to an inner transport, routing sends through a mutator:
    mutate(dest, data) -> data | None (None = drop)."""

    def __init__(self, inner: ICommunication,
                 mutate: Callable[[NodeNum, bytes], Optional[bytes]]) -> None:
        self._inner = inner
        self._mutate = mutate

    def start(self, receiver: IReceiver) -> None:
        self._inner.start(receiver)

    def stop(self) -> None:
        self._inner.stop()

    def is_running(self) -> bool:
        return self._inner.is_running()

    def send(self, dest: NodeNum, data: bytes) -> None:
        out = self._mutate(dest, data)
        if out is not None:
            self._inner.send(dest, out)

    def get_connection_status(self, node: NodeNum) -> ConnectionStatus:
        return self._inner.get_connection_status(node)

    @property
    def max_message_size(self) -> int:
        return self._inner.max_message_size

    def flush(self) -> None:
        """Pass the dispatcher's end-of-iteration flush through to a
        batching inner transport (udp sendmmsg plane)."""
        inner_flush = getattr(self._inner, "flush", None)
        if inner_flush is not None:
            inner_flush()


def _msg_code(data: bytes) -> int:
    """Peek the consensus msg code without a full parse (every packed
    consensus message starts with a little-endian u16 MsgCode)."""
    import struct
    return struct.unpack_from("<H", data)[0] if len(data) >= 2 else -1


def _drop_all(dest: NodeNum, data: bytes) -> Optional[bytes]:
    return None


def _silent_preprepare(dest: NodeNum, data: bytes) -> Optional[bytes]:
    from tpubft_torch.consensus.messages import MsgCode
    return None if _msg_code(data) == int(MsgCode.PrePrepare) else data


def _corrupt_shares(dest: NodeNum, data: bytes) -> Optional[bytes]:
    """Flip a byte INSIDE the signature share of every outgoing share
    message — exercises share verification + bad-share isolation. The
    flipped byte must be within `sig`: PartialCommitProofMsg carries a
    trailing path u8 AFTER the signature (messages.py SPEC), so flipping
    the last wire byte would only make the message unparseable (a silent
    replica, not a byzantine share)."""
    from tpubft_torch.consensus.messages import MsgCode
    code = _msg_code(data)
    if code in (int(MsgCode.PreparePartial), int(MsgCode.CommitPartial),
                int(MsgCode.PartialCommitProof)):
        b = bytearray(data)
        # b[-1] is `path` on PartialCommitProof and the sig tail on the
        # others; b[-3] is inside the >=48-byte signature on all three
        b[-3] ^= 0xFF
        return bytes(b)
    return data


class _Equivocate:
    """A genuinely equivocating primary: odd-id destinations receive a
    validly re-signed VARIANT of every outgoing PrePrepare (the batch's
    last request dropped, requests_digest recomputed), even-id
    destinations the original. Both proposals verify, so the backups
    split across two digests for the same (view, seq) — no digest can
    reach a commit quorum and the cluster must view-change away without
    ever committing both. Needs the replica's signer (the in-process
    cluster and the tester replica both have it); without one the
    variant keeps the stale signature and degrades to a wrong-digest
    primary (receivers reject the fork outright)."""

    def __init__(self, signer=None) -> None:
        self._signer = signer

    def __call__(self, dest: NodeNum, data: bytes) -> Optional[bytes]:
        from tpubft_torch.consensus import messages as cm
        if _msg_code(data) != int(cm.MsgCode.PrePrepare) \
                or int(dest) % 2 == 0:
            return data
        try:
            pp = cm.unpack(data)
        except cm.MsgError:
            return data
        reqs = list(pp.requests[:-1])
        fork = cm.PrePrepareMsg(
            sender_id=pp.sender_id, view=pp.view, seq_num=pp.seq_num,
            first_path=pp.first_path, time=pp.time,
            requests_digest=cm.PrePrepareMsg.compute_requests_digest(reqs),
            requests=reqs, signature=pp.signature, epoch=pp.epoch)
        if self._signer is not None:
            fork.signature = self._signer.sign(fork.signed_payload())
        return fork.pack()


def _corrupt_preprepare(dest: NodeNum, data: bytes) -> Optional[bytes]:
    """Wrong-digest primary: every outgoing PrePrepare's requests_digest
    is bit-flipped while the (now stale) signature rides along. Receivers
    must reject it at parse/verify — from the cluster's viewpoint the
    primary proposes garbage and must be view-changed away."""
    from tpubft_torch.consensus import messages as cm
    if _msg_code(data) != int(cm.MsgCode.PrePrepare):
        return data
    try:
        pp = cm.unpack(data)
    except cm.MsgError:
        return data
    bad = bytes([pp.requests_digest[0] ^ 0xFF]) + pp.requests_digest[1:]
    fork = cm.PrePrepareMsg(
        sender_id=pp.sender_id, view=pp.view, seq_num=pp.seq_num,
        first_path=pp.first_path, time=pp.time, requests_digest=bad,
        requests=pp.requests, signature=pp.signature, epoch=pp.epoch)
    return fork.pack()


class _RandomDrop:
    def __init__(self, rate: float, seed: int = 0xBF7) -> None:
        self._rate = rate
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def __call__(self, dest: NodeNum, data: bytes) -> Optional[bytes]:
        with self._lock:
            roll = self._rng.random()
        return None if roll < self._rate else data


class _Delay:
    """Delays every send via one worker thread draining a time-ordered
    queue (send stays non-blocking; stop() cancels pending sends)."""

    def __init__(self, delay_s: float) -> None:
        self._delay = delay_s
        self._inner: Optional[ICommunication] = None
        self._queue: list = []
        self._cv = threading.Condition()
        self._stopped = False
        self._thread: Optional[threading.Thread] = None

    def bind(self, inner: ICommunication) -> None:
        self._inner = inner
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="byz-delay")
        self._thread.start()

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._queue.clear()
            self._cv.notify()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._stopped and (
                        not self._queue
                        or self._queue[0][0] > time.monotonic()):
                    wait = (self._queue[0][0] - time.monotonic()
                            if self._queue else None)
                    self._cv.wait(timeout=wait)
                if self._stopped:
                    return
                _, dest, data = self._queue.pop(0)
            try:
                if self._inner and self._inner.is_running():
                    self._inner.send(dest, data)
            except Exception:
                pass

    def __call__(self, dest: NodeNum, data: bytes) -> Optional[bytes]:
        with self._cv:
            if not self._stopped:
                self._queue.append((time.monotonic() + self._delay,
                                    dest, data))
                self._cv.notify()
        return None


STRATEGIES: Dict[str, Callable[..., Callable]] = {
    # reference strategy analogs (ByzantineStrategy.hpp implementations);
    # every factory takes an optional signer=... (the wrapped replica's
    # own signing key) — only the re-signing strategies use it
    "silent": lambda signer=None: _drop_all,           # mute replica
    "silent-preprepare":
        lambda signer=None: _silent_preprepare,        # primary withholds PP
    "corrupt-shares":
        lambda signer=None: _corrupt_shares,           # bad threshold shares
    "corrupt-preprepare":
        lambda signer=None: _corrupt_preprepare,       # wrong-digest primary
    "equivocate":
        lambda signer=None: _Equivocate(signer),       # two-faced primary
    "drop-20": lambda signer=None: _RandomDrop(0.2),   # lossy links
    "drop-50": lambda signer=None: _RandomDrop(0.5),
}


def strategy_wrapper(name: str) -> Callable[..., ICommunication]:
    """Returns wrap(inner, signer=None): the per-name communication
    wrapper. `signer` is the wrapped replica's own signing key, forwarded
    to strategies that need to re-sign mutated messages (equivocate)."""
    if name.startswith("delay-"):
        delay_ms = int(name.split("-", 1)[1])

        def wrap_delay(inner: ICommunication,
                       signer=None) -> ICommunication:
            d = _Delay(delay_ms / 1000.0)
            d.bind(inner)

            class _DelayedComm(WrapCommunication):
                def stop(self) -> None:
                    d.stop()
                    super().stop()

            return _DelayedComm(inner, d)
        return wrap_delay
    if name not in STRATEGIES:
        raise ValueError(f"unknown byzantine strategy {name!r}; "
                         f"have {sorted(STRATEGIES)} + delay-<ms>")

    def wrap(inner: ICommunication, signer=None) -> ICommunication:
        return WrapCommunication(inner, STRATEGIES[name](signer=signer))
    return wrap
