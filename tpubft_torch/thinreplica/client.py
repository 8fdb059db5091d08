"""ThinReplicaClient — trust-but-verify subscription across servers (port of
tpubft/thinreplica/client.py).

Rebuild of concord-bft client/thin-replica-client/: the client takes
the full update stream from ONE server and update hashes from f OTHER
servers; an update is delivered to the application only once f+1 servers
(data + f hashes) agree on its digest, so no single untrusted server can
forge or reorder state. On mismatch or stall the client rotates its data
source.
"""
from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from tpubft_torch.thinreplica import messages as tm

Endpoint = Tuple[str, int]


def keys_cert_verifier(keys) -> Callable[[int, bytes, bytes], bool]:
    """cert_verifier over ClusterKeys: verify a replica's CheckpointMsg
    signature with its registered public key (cached per replica)."""
    cache: Dict[int, object] = {}

    def verify(replica_id: int, payload: bytes, sig: bytes) -> bool:
        v = cache.get(replica_id)
        if v is None:
            v = cache[replica_id] = keys.verifier_of(replica_id)
        return v.verify(payload, sig)

    return verify


class _Conn:
    def __init__(self, ep: Endpoint, timeout: float = 5.0) -> None:
        self.sock = socket.create_connection(ep, timeout=timeout)

    def send(self, msg) -> None:
        self.sock.sendall(tm.pack(msg))

    def recv(self):
        """Read one frame. A socket timeout with NO bytes read raises
        socket.timeout (idle poll); a timeout mid-frame keeps reading so
        framing never desyncs."""
        hdr = b""
        while len(hdr) < 4:
            try:
                chunk = self.sock.recv(4 - len(hdr))
            except socket.timeout:
                if hdr:
                    continue
                raise
            if not chunk:
                return None
            hdr += chunk
        (n,) = struct.unpack("<I", hdr)
        body = b""
        while len(body) < n:
            try:
                chunk = self.sock.recv(n - len(body))
            except socket.timeout:
                continue
            if not chunk:
                return None
            body += chunk
        return tm.unpack_body(body)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class ThinReplicaClient:
    def __init__(self, endpoints: List[Endpoint], f_val: int,
                 key_prefix: bytes = b"",
                 cert_verifier: Optional[Callable[[int, bytes, bytes],
                                                  bool]] = None) -> None:
        if len(endpoints) < f_val + 1 and cert_verifier is None:
            # the QUORUM paths (read_state / verified_proof / subscribe)
            # compare f+1 servers; the checkpoint-anchored path draws
            # its trust from f+1 SIGNATURES instead and can run against
            # a single untrusted server
            raise ValueError("need at least f+1 thin-replica servers")
        self.endpoints = endpoints
        self.f = f_val
        self.key_prefix = key_prefix
        # (replica_id, signed_payload, signature) -> bool: how this
        # client checks CheckpointMsg signatures for the anchor path
        # (wire it to ClusterKeys.verifier_of / a SigManager); without
        # it only the f+1 cross-server quorum APIs are available
        self.cert_verifier = cert_verifier
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()
        self._pending_data: Dict[int, List[Tuple[bytes, bytes]]] = {}
        # block -> digest -> set of hash-server indexes agreeing
        self._hash_votes: Dict[int, Dict[bytes, set]] = {}
        self._delivered_up_to = 0
        self._callback: Optional[Callable] = None
        self._generation = 0
        self._last_progress = 0.0
        # ---- checkpoint-anchored verified chain (anchor path) ----
        self._anchor_lock = threading.Lock()
        # per-server rpc locks: a slow/dead server must not stall
        # requests riding OTHER servers (failover is the point)
        self._rpc_locks = [threading.Lock() for _ in endpoints]
        self._rpc_conns: Dict[int, _Conn] = {}
        self._digests: Dict[int, bytes] = {}     # verified id -> digest
        self._headers: Dict[int, object] = {}    # verified id -> Block
        self._anchor_high: Optional[int] = None  # newest anchored block
        self._anchor_seq = 0                     # its checkpoint seqnum

    # ---- one-shot state read with hash verification ----
    def read_state(self) -> Dict[bytes, bytes]:
        """ReadState from one server, verified against ReadStateHash from
        f others (reference: initial state hashing)."""
        data_conn = _Conn(self.endpoints[0])
        data_conn.send(tm.ReadStateRequest(key_prefix=self.key_prefix))
        state: Dict[bytes, bytes] = {}
        done: Optional[tm.StateDone] = None
        while True:
            msg = data_conn.recv()
            if msg is None:
                raise ConnectionError("state stream ended early")
            if isinstance(msg, tm.Update):
                state.update(dict(msg.kv))
            elif isinstance(msg, tm.StateDone):
                done = msg
                break
            else:
                raise ConnectionError(f"bad state msg {msg!r}")
        data_conn.close()
        # hash what we RECEIVED — the data server's self-reported digest
        # proves nothing (a forger would ship honest digest + fake data)
        local_digest = tm.update_hash(done.block_id, list(state.items()))
        if not self._collect_votes(
                lambda: tm.ReadStateHashRequest(block_id=done.block_id,
                                                key_prefix=self.key_prefix),
                lambda h: (isinstance(h, tm.StateDone)
                           and h.digest == local_digest
                           and h.block_id == done.block_id)):
            raise ValueError("state hash quorum not reached")
        self._delivered_up_to = done.block_id
        return state

    def _collect_votes(self, make_request, matches) -> bool:
        """The trust kernel shared by every one-shot verification: ask f
        OTHER servers, count those whose reply `matches`; a server
        answering ProtocolError('ahead') is still catching up and gets
        retried until the deadline. True once f votes are in (f+1 total
        with the data server ⇒ at least one honest replica agrees)."""
        if len(self.endpoints) < self.f + 1:
            raise ValueError("quorum path needs f+1 servers")
        votes = 0
        deadline = time.monotonic() + 10
        pending = list(self.endpoints[1:])
        while votes < self.f and pending and time.monotonic() < deadline:
            ep = pending.pop(0)
            try:
                c = _Conn(ep)
                c.send(make_request())
                reply = c.recv()
                c.close()
            except OSError:
                continue
            if matches(reply):
                votes += 1
            elif isinstance(reply, tm.ProtocolError) \
                    and reply.reason == "ahead":
                pending.append(ep)
                time.sleep(0.2)
        return votes >= self.f

    # ---- versioned merkle proof verification ----
    def verified_proof(self, category: str, key: bytes,
                       block_id: int,
                       value: Optional[bytes] = None) -> Optional[bytes]:
        """Prove `key`'s state AS OF `block_id` (reference versioned
        sparse-merkle proofs) without trusting any single server:

        1. fetch proof + root + value hash from the data server,
        2. verify the audit path locally against the root,
        3. require the SAME root for that block from f other servers
           (f+1 total ⇒ at least one honest replica vouches for it),
        4. if the caller supplies the `value` it believes, bind it to
           the proven value hash.

        Returns the proven value hash (None = key absent at that block);
        raises ValueError when verification fails."""
        import hashlib

        from tpubft_torch.kvbc.sparse_merkle import Proof, SparseMerkleTree
        c = _Conn(self.endpoints[0])
        c.send(tm.ReadProofRequest(block_id=block_id, category=category,
                                   key=key))
        reply = c.recv()
        c.close()
        if not isinstance(reply, tm.ProofReply):
            raise ValueError(f"no proof from data server: {reply!r}")
        if block_id and reply.block_id != block_id:
            # a proof for ANOTHER retained block would verify and gather
            # an honest quorum for that block's root — the binding to the
            # asked block is part of what is being proven
            raise ValueError(f"proof is for block {reply.block_id}, "
                             f"asked {block_id}")
        vh = reply.value_hash or None
        if not SparseMerkleTree.verify(
                reply.root, key, vh,
                Proof(bitmap=reply.bitmap, siblings=list(reply.siblings))):
            raise ValueError("audit path does not reach the root")
        if not self._collect_votes(
                lambda: tm.ReadProofRequest(block_id=reply.block_id,
                                            category=category, key=key),
                lambda other: (isinstance(other, tm.ProofReply)
                               and other.block_id == reply.block_id
                               and other.root == reply.root)):
            raise ValueError("proof root quorum not reached")
        if value is not None \
                and hashlib.sha256(value).digest() != (vh or b""):
            raise ValueError("value does not match proven hash")
        return vh

    # ------------------------------------------------------------------
    # checkpoint-anchored reads (the read-scaling serving path)
    #
    # Trust model: ONE AnchorRequest returns f+1 CheckpointMsgs signed
    # by distinct replicas over the same state digest — at least one
    # honest replica vouches, so the digest (and the block row hashing
    # to it) is authentic. From that anchor the parent-digest hash
    # chain authenticates every EARLIER block, and each block row
    # carries its categories' merkle roots; a read then needs only a
    # single untrusted server: proof + value verify locally against the
    # anchored root, no per-read quorum round trips. Later blocks
    # become readable by rolling the anchor forward to a NEWER
    # certificate set (hash chains do not authenticate forward).
    # ------------------------------------------------------------------
    ANCHOR_SCAN_LIMIT = 512      # max backward header walk per read

    def _rpc(self, server: int, msg):
        """Request/reply over a PERSISTENT per-server connection (the
        server pipelines these frames): the read hot path must not pay
        a TCP handshake per read. One reconnect retry on a dead conn."""
        with self._rpc_locks[server]:
            for attempt in (0, 1):
                c = self._rpc_conns.get(server)
                if c is None:
                    c = self._rpc_conns[server] = _Conn(
                        self.endpoints[server])
                try:
                    c.send(msg)
                    reply = c.recv()
                except OSError:
                    reply = None
                if reply is not None:
                    return reply
                c.close()
                self._rpc_conns.pop(server, None)
                if attempt:
                    raise ConnectionError(
                        f"thin-replica server {server} unreachable")

    def fetch_anchor(self, server: int = 0) -> Optional[int]:
        """Fetch + verify the server's newest quorum-signed checkpoint
        anchor. Returns the anchored block id (None if the server has
        no anchor yet — e.g. before the first checkpoint window
        closes). Raises ValueError on any verification failure."""
        import hashlib

        from tpubft_torch.consensus import messages as cm
        from tpubft_torch.kvbc.blockchain import Block
        from tpubft_torch.utils import serialize as ser
        if self.cert_verifier is None:
            raise ValueError("anchor path needs a cert_verifier")
        reply = self._rpc(server, tm.AnchorRequest())
        if isinstance(reply, tm.ProtocolError):
            return None if reply.reason in ("no anchor", "pruned") else \
                self._anchor_fail(f"anchor error: {reply.reason}")
        if not isinstance(reply, tm.AnchorReply):
            self._anchor_fail(f"bad anchor reply: {reply!r}")
        # 1. f+1 valid signatures from DISTINCT replicas over one digest
        digests = set()
        signers = set()
        for raw in reply.certs:
            try:
                ck = cm.unpack(raw)
            except cm.MsgError:
                continue
            if not isinstance(ck, cm.CheckpointMsg) \
                    or ck.seq_num != reply.ckpt_seq \
                    or ck.sender_id in signers:
                continue
            try:
                if not self.cert_verifier(ck.sender_id,
                                          ck.signed_payload(),
                                          ck.signature):
                    continue
            except Exception:  # noqa: BLE001 — unknown signer etc.
                continue
            signers.add(ck.sender_id)
            digests.add(ck.state_digest)
        if len(signers) < self.f + 1 or len(digests) != 1:
            self._anchor_fail(
                f"anchor quorum not reached: {len(signers)} valid "
                f"certs over {len(digests)} digests (need {self.f + 1} "
                f"over 1)")
        state_digest = digests.pop()
        # 2. the block row must HASH to the certified digest
        if hashlib.sha256(reply.block_raw).digest() != state_digest:
            self._anchor_fail("anchor block does not hash to the "
                              "certified state digest")
        blk = ser.decode_msg(reply.block_raw, Block)
        if blk.block_id != reply.block_id:
            self._anchor_fail("anchor block id mismatch")
        # 3. install (monotone; equivocation across anchors is fatal)
        blk.updates_blob = b""      # digest already checked; only
        # parent_digest + category_digests are read from stored headers
        with self._anchor_lock:
            prev = self._digests.get(blk.block_id)
            if prev is not None and prev != state_digest:
                self._anchor_fail(
                    f"anchor equivocation at block {blk.block_id}")
            self._digests[blk.block_id] = state_digest
            self._headers[blk.block_id] = blk
            if self._anchor_high is None \
                    or blk.block_id > self._anchor_high:
                self._anchor_high = blk.block_id
                self._anchor_seq = reply.ckpt_seq
            self._prune_headers_locked()
        return blk.block_id

    def _prune_headers_locked(self) -> None:
        """Bound client memory as the anchor rolls forward: verified
        headers below the scan horizon are droppable — a later
        historical read re-verifies them through the backward walk."""
        horizon = (self._anchor_high or 0) - 2 * self.ANCHOR_SCAN_LIMIT
        if horizon <= 0:
            return
        for b in [b for b in self._digests if b < horizon]:
            del self._digests[b]
            self._headers.pop(b, None)

    @staticmethod
    def _anchor_fail(msg: str) -> None:
        raise ValueError(msg)

    @property
    def anchor_block(self) -> Optional[int]:
        with self._anchor_lock:
            return self._anchor_high

    def _ensure_verified(self, block_id: int, server: int = 0) -> None:
        """Extend the verified header chain BACKWARD to `block_id` by
        walking parent digests down from the nearest verified block
        above it. Caller must hold no lock; takes the anchor lock."""
        import hashlib

        from tpubft_torch.kvbc.blockchain import Block
        from tpubft_torch.utils import serialize as ser
        with self._anchor_lock:
            if block_id in self._headers:
                return
            above = [b for b in self._digests if b > block_id]
            if not above:
                self._anchor_fail(
                    f"block {block_id} is beyond the anchor — "
                    f"fetch_anchor() a newer certificate set first")
            frm = min(above)
        for b in range(frm - 1, block_id - 1, -1):
            with self._anchor_lock:
                if b in self._headers:
                    continue
                want = self._headers[b + 1].parent_digest
            reply = self._rpc(server, tm.BlockRequest(block_id=b))
            if not isinstance(reply, tm.BlockReply) or not reply.raw:
                self._anchor_fail(f"block {b} unavailable from server")
            if hashlib.sha256(reply.raw).digest() != want:
                self._anchor_fail(
                    f"hash chain broken at block {b}: the served row "
                    f"is not the parent of verified block {b + 1}")
            blk = ser.decode_msg(reply.raw, Block)
            if blk.block_id != b:
                self._anchor_fail(f"block id mismatch at {b}")
            blk.updates_blob = b""    # header fields only (see install)
            with self._anchor_lock:
                self._digests[b] = want
                self._headers[b] = blk

    def _root_for(self, category: str, block_id: int,
                  server: int = 0) -> bytes:
        """The category's merkle root AS OF `block_id`, from the
        verified chain: the newest verified block <= block_id whose row
        carries the category's digest (a block not touching the
        category leaves its root where the previous writer put it)."""
        for b in range(block_id, max(0, block_id
                                     - self.ANCHOR_SCAN_LIMIT), -1):
            self._ensure_verified(b, server)
            with self._anchor_lock:
                hdr = self._headers[b]
            root = hdr.category_digests.get(category)
            if root is not None:
                return root
        self._anchor_fail(
            f"no {category!r} root within {self.ANCHOR_SCAN_LIMIT} "
            f"verified blocks at or below {block_id}")

    def verified_read(self, category: str, key: bytes,
                      block_id: Optional[int] = None,
                      server: int = 0) -> Optional[bytes]:
        """Digest-authenticated single-server read: value of `key` as
        of `block_id` (default: the anchor head), proven by a sparse-
        merkle audit path against the ANCHORED root — no per-read
        quorum. Returns the value (None = key absent at that block).
        Raises ValueError on verification failure (forged proof, value,
        or root) and LookupError when the proof verifies but the server
        no longer holds the value bytes at that version (overwritten
        since — retry at a newer anchor)."""
        import hashlib

        from tpubft_torch.kvbc.sparse_merkle import Proof, SparseMerkleTree
        with self._anchor_lock:
            high = self._anchor_high
        if high is None:
            raise ValueError("no anchor: call fetch_anchor() first")
        bid = block_id if block_id else high
        if bid > high:
            self._anchor_fail(
                f"read at {bid} beyond anchor {high}: refresh the "
                f"anchor (hash chains authenticate backward only)")
        reply = self._rpc(server, tm.ReadProofRequest(
            block_id=bid, category=category, key=key))
        if not isinstance(reply, tm.ProofReply) or reply.block_id != bid:
            raise ValueError(f"no proof for block {bid}: {reply!r}")
        root = self._root_for(category, bid, server)
        vh = reply.value_hash or None
        if not SparseMerkleTree.verify(
                root, key, vh,
                Proof(bitmap=reply.bitmap, siblings=list(reply.siblings))):
            raise ValueError("audit path does not reach the anchored "
                             "root")
        if vh is None:
            return None
        if not reply.value or hashlib.sha256(reply.value).digest() != vh:
            if reply.value:
                raise ValueError("served value does not match the "
                                 "proven hash")
            raise LookupError(f"value at block {bid} no longer "
                              f"retrievable (overwritten since)")
        return reply.value

    # ---- live subscription ----
    STALL_TIMEOUT_S = 5.0

    def subscribe(self, callback: Callable[[int, List[Tuple[bytes, bytes]]],
                                           None],
                  start_block: int = 1) -> None:
        """Deliver verified (block_id, kv) updates in order. A stalled or
        lying data source is rotated out by the supervisor (the module's
        trust-but-verify contract)."""
        self._callback = callback
        self._delivered_up_to = max(self._delivered_up_to, start_block - 1)
        self._generation = 0
        self._last_progress = time.monotonic()
        t = threading.Thread(target=self._supervise, daemon=True,
                             name="trc-supervisor")
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        # close without taking the per-server locks: an rpc blocked on
        # a dead server sees its socket close (OSError) and unwinds
        for c in list(self._rpc_conns.values()):
            c.close()
        self._rpc_conns.clear()

    def _supervise(self) -> None:
        """Start a generation of stream threads; rotate the data source
        and restart whenever delivery stalls (mismatch, overflow
        disconnect, dead server)."""
        rotation = 0
        while not self._stop.is_set():
            gen = self._generation
            with self._lock:
                self._pending_data.clear()
                self._hash_votes.clear()
            n = len(self.endpoints)
            data_ep = self.endpoints[rotation % n]
            hash_eps = [self.endpoints[(rotation + 1 + i) % n]
                        for i in range(self.f)]
            threads = [threading.Thread(
                target=self._data_loop, args=(data_ep, gen),
                daemon=True, name="trc-data")]
            threads += [threading.Thread(
                target=self._hash_loop, args=(ep, i, gen),
                daemon=True, name=f"trc-hash-{i}")
                for i, ep in enumerate(hash_eps)]
            for t in threads:
                t.start()
            self._last_progress = time.monotonic()
            while not self._stop.is_set():
                time.sleep(0.25)
                if time.monotonic() - self._last_progress \
                        > self.STALL_TIMEOUT_S:
                    with self._lock:
                        stuck = bool(self._pending_data) \
                            or bool(self._hash_votes)
                    if stuck:
                        break  # rotate away from the current data source
                    self._last_progress = time.monotonic()
            self._generation += 1  # retire this generation's threads
            rotation += 1

    def _data_loop(self, ep: Endpoint, gen: int) -> None:
        try:
            conn = _Conn(ep)
            conn.send(tm.SubscribeRequest(
                block_id=self._delivered_up_to + 1,
                key_prefix=self.key_prefix, hashes_only=False))
            conn.sock.settimeout(1.0)
            while not self._stop.is_set() and self._generation == gen:
                try:
                    msg = conn.recv()
                except socket.timeout:
                    continue
                if msg is None:
                    return
                if isinstance(msg, tm.Update):
                    with self._lock:
                        self._pending_data[msg.block_id] = msg.kv
                    self._try_deliver()
        except OSError:
            return

    def _hash_loop(self, ep: Endpoint, idx: int, gen: int) -> None:
        try:
            conn = _Conn(ep)
            conn.send(tm.SubscribeRequest(
                block_id=self._delivered_up_to + 1,
                key_prefix=self.key_prefix, hashes_only=True))
            conn.sock.settimeout(1.0)
            while not self._stop.is_set() and self._generation == gen:
                try:
                    msg = conn.recv()
                except socket.timeout:
                    continue
                if msg is None:
                    return
                if isinstance(msg, tm.UpdateHash):
                    with self._lock:
                        votes = self._hash_votes.setdefault(msg.block_id, {})
                        votes.setdefault(msg.digest, set()).add(idx)
                    self._try_deliver()
        except OSError:
            return

    def _try_deliver(self) -> None:
        while True:
            with self._lock:
                nxt = self._delivered_up_to + 1
                kv = self._pending_data.get(nxt)
                if kv is None:
                    return
                digest = tm.update_hash(nxt, kv)
                votes = self._hash_votes.get(nxt, {}).get(digest, set())
                if len(votes) < self.f:
                    return
                del self._pending_data[nxt]
                self._hash_votes.pop(nxt, None)
                self._delivered_up_to = nxt
                cb = self._callback
            self._last_progress = time.monotonic()
            if cb is not None:
                cb(nxt, kv)
