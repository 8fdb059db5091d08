"""ThinReplicaServer — serves state reads + live update subscriptions (port of
tpubft/thinreplica/server.py).

Rebuild of the reference's ThinReplicaImpl
(concord-bft thin-replica-server/include/thin-replica-server/
thin_replica_impl.hpp:98) + subscription_buffer.hpp: one TCP listener,
one handler thread per connection; live updates arrive from the
blockchain's commit stream into per-subscriber bounded buffers; history
is read from the chain so a subscriber can start at any block and roll
forward into the live stream without gaps.

Serving-plane wiring (the read-scaling tier):

  * the live feed rides the blockchain's RUN listener — one publish hop
    per sealed execution run (the coalesced durable apply), not one per
    block, so the read tier's cost on the write pipeline stays constant
    as accumulation deepens;
  * every proof request is answered with the block-anchored merkle root
    + audit path; the digest-authenticated trust chain up to f+1 signed
    checkpoint certificates is served via AnchorRequest/BlockRequest
    (`anchor_fn` — wired by the consensus replica). The server remains
    untrusted: clients verify everything;
  * observability: the `thinreplica` metrics component
    (trs_overflows / trs_dropped_subscribers / push + read counters)
    and the trs_subscribe / trs_push / trs_proof flight events.
"""
from __future__ import annotations

import hashlib
import queue
import socket
import struct
import threading
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from tpubft_torch.kvbc import categories as cat
from tpubft_torch.kvbc.blockchain import KeyValueBlockchain
from tpubft_torch.thinreplica import messages as tm
from tpubft_torch.utils import flight
from tpubft_torch.utils.logging import get_logger
from tpubft_torch.utils.metrics import Component
from tpubft_torch.utils.racecheck import make_lock

log = get_logger("thinreplica")


@dataclass
class FilterSpec:
    """kvbc_app_filter equivalent: which updates are client-visible."""
    category: str = "kv"
    key_prefix: bytes = b""

    def filter_updates(self, updates: cat.BlockUpdates
                       ) -> List[Tuple[bytes, bytes]]:
        out = []
        hit = updates.categories.get(self.category)
        if hit is None:
            return out
        _type, cu = hit
        for k in sorted(cu.kv):
            v = cu.kv[k]
            if v is not None and k.startswith(self.key_prefix):
                out.append((k, v))
        return out


class _Subscriber:
    """SubUpdateBuffer: bounded queue of RUNS; overflow drops the
    subscriber (it re-subscribes and catches up from history)."""

    def __init__(self, start_block: int, maxsize: int = 1024) -> None:
        self.q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self.next_block = start_block
        self.dead = False

    def push(self, item) -> bool:
        """True = enqueued; False = buffer full (caller marks dead and
        accounts for the drop — this used to be a silent loss)."""
        try:
            self.q.put_nowait(item)
            return True
        except queue.Full:
            self.dead = True
            return False


class ThinReplicaServer:
    def __init__(self, blockchain: KeyValueBlockchain,
                 filter_spec: Optional[FilterSpec] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 sub_buffer: int = 1024,
                 aggregator=None,
                 anchor_fn: Optional[Callable[[], Optional[tuple]]] = None
                 ) -> None:
        self.bc = blockchain
        self.filter = filter_spec or FilterSpec()
        self._sub_buffer = max(1, sub_buffer)
        # () -> (ckpt_seq, block_id, [packed CheckpointMsg...]) or None;
        # provided by the consensus replica (thread-safe snapshot)
        self._anchor_fn = anchor_fn
        self._subs: List[_Subscriber] = []
        # make_lock (not raw): the subscriber list crosses the commit
        # thread (exec lane / dispatcher) and connection handlers —
        # the lint's static-race pass and the runtime lock-order graph
        # must both see it
        self._subs_lock = make_lock("trs.subs")
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.port = self._sock.getsockname()[1]
        self._running = False
        self._accept_thread: Optional[threading.Thread] = None
        # --- metrics (the serving plane's day-one observability) ---
        self.metrics = Component("thinreplica", aggregator)
        self.m_subscribers = self.metrics.register_gauge("trs_subscribers")
        self.m_pushed_runs = self.metrics.register_counter(
            "trs_pushed_runs")
        self.m_pushed_blocks = self.metrics.register_counter(
            "trs_pushed_blocks")
        self.m_overflows = self.metrics.register_counter("trs_overflows")
        self.m_dropped_subs = self.metrics.register_counter(
            "trs_dropped_subscribers")
        self.m_reads = self.metrics.register_counter("trs_reads")
        self.m_proofs = self.metrics.register_counter("trs_proofs")
        self.m_anchors = self.metrics.register_counter("trs_anchors")
        blockchain.add_run_listener(self._on_run)

    # ---- lifecycle ----
    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._sock.listen(16)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"trs-accept-{self.port}")
        self._accept_thread.start()

    def stop(self) -> None:
        self._running = False
        try:
            self._sock.close()
        except OSError:
            pass

    # ---- commit-path feed (exec-lane / dispatcher thread) ----
    def _on_run(self, items) -> None:
        """One sealed run (N blocks, one atomic commit) → ONE buffer
        push per subscriber. Filtering happens once, here, instead of
        per subscriber."""
        batch = [(bid, self.filter.filter_updates(bu))
                 for bid, bu in items]
        dropped = 0
        with self._subs_lock:
            live = []
            for sub in self._subs:
                if sub.dead:
                    continue
                if not sub.push(batch):
                    # overflow: the subscriber is too slow for the live
                    # stream — drop it (it re-subscribes and catches up
                    # from history) and tell the operator how far behind
                    # it was so buffers can be sized
                    dropped += 1
                    self.m_overflows.inc()
                    log.warning(
                        "trs subscriber overflow: lag=%d blocks "
                        "(next wanted %d, head %d, buffer %d runs); "
                        "dropping — it must re-subscribe",
                        max(0, batch[-1][0] - sub.next_block),
                        sub.next_block, batch[-1][0], self._sub_buffer)
                    continue
                live.append(sub)
            self._subs = live
            self.m_subscribers.set(len(live))
        if dropped:
            self.m_dropped_subs.inc(dropped)
        self.m_pushed_runs.inc()
        self.m_pushed_blocks.inc(len(batch))
        flight.record(flight.EV_TRS_PUSH, seq=batch[-1][0],
                      arg=len(batch))

    # ---- connection handling ----
    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True, name="trs-conn").start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            # request/reply messages PIPELINE on one connection (the
            # read-serving hot path must not pay a TCP handshake per
            # read); streaming requests take the connection over and
            # close it when the stream ends
            while True:
                body = self._read_frame(conn)
                if body is None:
                    return
                req = tm.unpack_body(body)
                if isinstance(req, tm.ReadStateRequest):
                    self._serve_read_state(conn, req.key_prefix)
                    return
                if isinstance(req, tm.SubscribeRequest):
                    self._serve_subscription(conn, req)
                    return
                if isinstance(req, tm.ReadStateHashRequest):
                    self._serve_state_hash(conn, req)
                elif isinstance(req, tm.ReadProofRequest):
                    self._serve_proof(conn, req)
                elif isinstance(req, tm.AnchorRequest):
                    self._serve_anchor(conn)
                elif isinstance(req, tm.BlockRequest):
                    self._serve_block(conn, req)
                else:
                    conn.sendall(tm.pack(
                        tm.ProtocolError(reason="bad request")))
                    return
        except Exception:  # noqa: BLE001 — connection teardown
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _read_frame(conn: socket.socket) -> Optional[bytes]:
        hdr = b""
        while len(hdr) < 4:
            chunk = conn.recv(4 - len(hdr))
            if not chunk:
                return None
            hdr += chunk
        (n,) = struct.unpack("<I", hdr)
        if n > 1 << 22:
            return None
        body = b""
        while len(body) < n:
            chunk = conn.recv(n - len(body))
            if not chunk:
                return None
            body += chunk
        return body

    # ---- ReadState / ReadStateHash ----
    def _state_snapshot(self, key_prefix: bytes
                        ) -> Tuple[int, List[Tuple[bytes, bytes]]]:
        block_id = self.bc.last_block_id
        fam_hits = []
        db = self.bc._db
        fam = cat._fam(self.filter.category, "latest")
        for k, raw in db.range_iter(fam, start=key_prefix):
            if not k.startswith(key_prefix):
                break
            fam_hits.append((k, raw[8:]))
        return block_id, fam_hits

    def _state_at_block(self, key_prefix: bytes, at_block: int
                        ) -> List[Tuple[bytes, bytes]]:
        """Historical state from the versioned_kv history family — lets a
        hash server answer for the DATA server's snapshot height even
        while the cluster keeps committing (reference: block-id'd state
        reads)."""
        db = self.bc._db
        fam = cat._fam(self.filter.category, "hist")
        best: dict = {}
        for k, raw in db.range_iter(fam):
            klen = int.from_bytes(k[:2], "big")
            key = k[2:2 + klen]
            if not key.startswith(key_prefix):
                continue
            block = ~int.from_bytes(k[2 + klen:2 + klen + 8],
                                    "big") & 0xFFFFFFFFFFFFFFFF
            if block > at_block or key in best:
                continue  # hist keys are newest-first per key
            best[key] = None if raw[:1] == b"\x00" else raw[1:]
        return sorted((k, v) for k, v in best.items() if v is not None)

    def _serve_read_state(self, conn: socket.socket,
                          key_prefix: bytes) -> None:
        self.m_reads.inc()
        block_id, kv = self._state_snapshot(key_prefix)
        for pair in kv:
            conn.sendall(tm.pack(tm.Update(block_id=block_id, kv=[pair])))
        conn.sendall(tm.pack(tm.StateDone(
            block_id=block_id, digest=tm.update_hash(block_id, kv))))

    def _serve_state_hash(self, conn: socket.socket,
                          req: tm.ReadStateHashRequest) -> None:
        self.m_reads.inc()
        if req.block_id and req.block_id != self.bc.last_block_id:
            if req.block_id > self.bc.last_block_id:
                conn.sendall(tm.pack(tm.ProtocolError(reason="ahead")))
                return
            kv = self._state_at_block(req.key_prefix, req.block_id)
            conn.sendall(tm.pack(tm.StateDone(
                block_id=req.block_id,
                digest=tm.update_hash(req.block_id, kv))))
            return
        block_id, kv = self._state_snapshot(req.key_prefix)
        conn.sendall(tm.pack(tm.StateDone(
            block_id=block_id, digest=tm.update_hash(block_id, kv))))

    def _serve_proof(self, conn: socket.socket,
                     req: tm.ReadProofRequest) -> None:
        """Versioned merkle proof (reference sparse_merkle historical
        versions): audit path for key@block plus the root anchored in
        that block's category digests. The CLIENT verifies — this server
        is untrusted; the root gains authority from an f+1 cross-server
        match or from the signed checkpoint anchor's hash chain."""
        bid = req.block_id or self.bc.last_block_id
        if bid > self.bc.last_block_id:
            conn.sendall(tm.pack(tm.ProtocolError(reason="ahead")))
            return
        if bid < self.bc.genesis_block_id:
            conn.sendall(tm.pack(tm.ProtocolError(reason="pruned")))
            return
        try:
            proof = self.bc.prove_at(req.category, req.key, bid)
            root = self.bc.merkle_root_at(req.category, bid) or b""
            vh = self.bc.merkle_value_hash_at(req.category, req.key, bid)
        except Exception:  # noqa: BLE001 — malformed request data
            conn.sendall(tm.pack(tm.ProtocolError(reason="bad proof req")))
            return
        # ship the value alongside the proof when the LATEST value still
        # hashes to the proven value_hash (one round trip for
        # read+verify); a key overwritten since `bid` yields proof-only
        value = b""
        if vh:
            hit = self.bc.get_latest(req.category, req.key,
                                     cat_type=cat.BLOCK_MERKLE)
            if hit is not None \
                    and hashlib.sha256(hit[1]).digest() == vh:
                value = hit[1]
        self.m_proofs.inc()
        flight.record(flight.EV_TRS_PROOF, seq=bid)
        conn.sendall(tm.pack(tm.ProofReply(
            block_id=bid, root=root, value_hash=vh or b"",
            bitmap=proof.bitmap, siblings=proof.siblings, value=value)))

    # ---- checkpoint anchor + raw blocks (digest-auth trust chain) ----
    def _serve_anchor(self, conn: socket.socket) -> None:
        anchor = self._anchor_fn() if self._anchor_fn is not None else None
        if anchor is None:
            conn.sendall(tm.pack(tm.ProtocolError(reason="no anchor")))
            return
        ckpt_seq, block_id, certs = anchor
        raw = self.bc.get_raw_block(block_id)
        if raw is None:
            # the anchored block was pruned (or this replica lags its
            # own anchor after a restart): the client falls back to the
            # f+1 root-quorum path until the next checkpoint certifies
            conn.sendall(tm.pack(tm.ProtocolError(reason="pruned")))
            return
        self.m_anchors.inc()
        conn.sendall(tm.pack(tm.AnchorReply(
            ckpt_seq=ckpt_seq, block_id=block_id, block_raw=raw,
            certs=list(certs))))

    def _serve_block(self, conn: socket.socket,
                     req: tm.BlockRequest) -> None:
        raw = (self.bc.get_raw_block(req.block_id)
               if 1 <= req.block_id <= self.bc.last_block_id else None)
        conn.sendall(tm.pack(tm.BlockReply(block_id=req.block_id,
                                           raw=raw or b"")))

    # ---- subscriptions ----
    def _block_kv(self, block_id: int,
                  key_prefix: bytes) -> Optional[List[Tuple[bytes, bytes]]]:
        blk = self.bc.get_block(block_id)
        if blk is None:
            return None
        updates = cat.decode_block_updates(blk.updates_blob)
        kv = self.filter.filter_updates(updates)
        return [(k, v) for k, v in kv if k.startswith(key_prefix)]

    def _serve_subscription(self, conn: socket.socket,
                            req: tm.SubscribeRequest) -> None:
        sub = _Subscriber(start_block=max(req.block_id, 1),
                          maxsize=self._sub_buffer)
        with self._subs_lock:
            self._subs.append(sub)
            self.m_subscribers.set(len(self._subs))
        flight.record(flight.EV_TRS_SUBSCRIBE, seq=sub.next_block)
        try:
            next_block = sub.next_block
            # history first (catch-up), then drain the live buffer;
            # blocks older than genesis are gone (pruned) — resume at it
            next_block = max(next_block, self.bc.genesis_block_id or 1)
            while self._running and not sub.dead:
                if next_block <= self.bc.last_block_id:
                    kv = self._block_kv(next_block, req.key_prefix)
                    if kv is None:
                        break
                    self._emit(conn, req, next_block, kv)
                    next_block += 1
                    sub.next_block = next_block
                    continue
                try:
                    batch = sub.q.get(timeout=0.5)
                except queue.Empty:
                    continue
                for block_id, kv in batch:
                    if block_id < next_block:
                        continue   # already served from history
                    if block_id > next_block:
                        # gap (an earlier run was consumed as history
                        # before we enqueued): the outer loop's history
                        # branch fills it on the next pass
                        break
                    kv = [(k, v) for k, v in kv
                          if k.startswith(req.key_prefix)]
                    self._emit(conn, req, block_id, kv)
                    next_block += 1
                    sub.next_block = next_block
        finally:
            sub.dead = True
            with self._subs_lock:
                if sub in self._subs:
                    self._subs.remove(sub)
                self.m_subscribers.set(len(self._subs))

    def _emit(self, conn: socket.socket, req: tm.SubscribeRequest,
              block_id: int, kv: List[Tuple[bytes, bytes]]) -> None:
        if req.hashes_only:
            conn.sendall(tm.pack(tm.UpdateHash(
                block_id=block_id, digest=tm.update_hash(block_id, kv))))
        else:
            conn.sendall(tm.pack(tm.Update(block_id=block_id, kv=kv)))
