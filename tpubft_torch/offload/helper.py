"""Crypto-offload helper: the non-voting sidecar worker (port of
tpubft/offload/helper.py).

A helper holds NO key material and NO consensus state — it receives
segments of compressed G1 shares (or ECDSA items), does the arithmetic,
and returns points/verdicts. It is never trusted: the replica re-checks
every answer (tpubft_torch/offload/soundness.py), so a helper binary can be
anything from this process to rented burst capacity on somebody else's
accelerator.

`python -m tpubft_torch.offload.helper --port 7700 [--strategy S]`
runs the TCP daemon (length-prefixed frames, one handler thread per
connection); replicas reach it through `offload_helpers="id=host:port"`.
`HelperServer` is the in-process equivalent the tests drive directly.

Byzantine test strategies (`--strategy`, same named-factory pattern as
testing/byzantine.py): every lie the fault-matrix tests need — wrong
point,
wrong-but-on-curve point, stale lease replay, garbage bytes, slow-loris
and crash-mid-lease.
"""
from __future__ import annotations

import argparse
import hashlib
import logging
import socket
import threading
import time
from typing import Callable, Dict, List, Optional

from tpubft_torch.offload import protocol as proto

log = logging.getLogger("tpubft_torch.offload.helper")


class HelperCrashed(Exception):
    """In-process stand-in for a helper dying mid-lease (connection
    drop): the pool classifies it as a transport fault (sick)."""


# ---------------------------------------------------------------------
# honest compute
# ---------------------------------------------------------------------

def compute(kind: int, payload: bytes) -> bytes:
    from tpubft_torch.crypto import bls12381 as bls
    if kind == proto.KIND_BLS_COMBINE:
        segs = proto.decode_bls_segments(payload)
        out = []
        for ids, shares in segs:
            pts = [bls.g1_decompress(p) for p in shares]
            out.append(bls.g1_compress(bls.combine_shares(ids, pts)))
        return proto.encode_points(out)
    if kind == proto.KIND_BLS_SUM:
        segs = proto.decode_bls_segments(payload)
        out = []
        for _ids, shares in segs:
            acc = None
            for p in shares:
                acc = bls.g1_add(acc, bls.g1_decompress(p))
            out.append(bls.g1_compress(acc))
        return proto.encode_points(out)
    if kind == proto.KIND_ECDSA_RLC:
        from tpubft_torch.crypto import scalar as _scalar
        curve, items = proto.decode_ecdsa_items(payload)
        bits = _scalar.ecdsa_verify_batch(
            [(pk, d, s) for d, s, pk in items], curve)
        return proto.encode_verdicts(bits)
    raise proto.ProtocolError(f"unknown lease kind {kind}")


# ---------------------------------------------------------------------
# Byzantine strategies: (lease_id, kind, payload, honest_response) ->
# (response_lease_id, response_payload) — or side effects (sleep/crash)
# ---------------------------------------------------------------------

def _tag_point(seed: bytes) -> bytes:
    """A valid, in-subgroup, wrong G1 point (the hardest lie: it
    decompresses fine and only the pairing check can expose it)."""
    from tpubft_torch.crypto import bls12381 as bls
    return bls.g1_compress(bls.hash_to_g1(b"byzantine-helper" + seed))


def _strategy_honest(server: "HelperServer"):
    return lambda lease_id, kind, payload, resp: (lease_id, resp)


def _strategy_wrong_point(server: "HelperServer"):
    """Bit-flipped points: undecodable 48-byte blobs (for ECDSA leases:
    flipped verdict bits — the analogous wrong-answer shape)."""
    def mutate(lease_id, kind, payload, resp):
        if kind == proto.KIND_ECDSA_RLC:
            return lease_id, bytes(b ^ 1 for b in resp)
        return lease_id, bytes(b ^ 0xFF for b in resp)
    return mutate


def _strategy_wrong_on_curve(server: "HelperServer"):
    """Replace every returned point with a VALID subgroup point that is
    not the answer; for ECDSA, flip only the first verdict."""
    def mutate(lease_id, kind, payload, resp):
        if kind == proto.KIND_ECDSA_RLC:
            if not resp:
                return lease_id, resp
            return lease_id, bytes([resp[0] ^ 1]) + resp[1:]
        n = len(resp) // proto.G1_LEN
        return lease_id, b"".join(
            _tag_point(payload[:32] + bytes([i & 0xFF]))
            for i in range(n))
    return mutate


def _strategy_stale_replay(server: "HelperServer"):
    """Answer every lease after the first with the FIRST lease's full
    response (old lease id + old payload) — the classic replay."""
    def mutate(lease_id, kind, payload, resp):
        if server._replay_cache is None:
            server._replay_cache = (lease_id, resp)
            return lease_id, resp
        return server._replay_cache
    return mutate


def _strategy_garbage(server: "HelperServer"):
    def mutate(lease_id, kind, payload, resp):
        junk = hashlib.sha256(payload or b"junk").digest()
        return lease_id, (junk * (len(resp) // 32 + 2))[:max(len(resp), 7)]
    return mutate


def _strategy_slow_loris(server: "HelperServer"):
    def mutate(lease_id, kind, payload, resp):
        # sleep past any sane deadline; the pool's lease timeout fires
        # first and classifies the helper as sick
        time.sleep(server.slow_s)
        return lease_id, resp
    return mutate


def _strategy_crash(server: "HelperServer"):
    def mutate(lease_id, kind, payload, resp):
        raise HelperCrashed("helper crashed mid-lease")
    return mutate


STRATEGIES: Dict[str, Callable] = {
    "honest": _strategy_honest,
    "wrong-point": _strategy_wrong_point,
    "wrong-on-curve": _strategy_wrong_on_curve,
    "stale-replay": _strategy_stale_replay,
    "garbage": _strategy_garbage,
    "slow-loris": _strategy_slow_loris,
    "crash": _strategy_crash,
}


class HelperServer:
    """One helper's brain: decode lease, compute, apply strategy. The
    in-process pool transport calls `handle()` directly; the TCP daemon
    wraps it in the frame loop."""

    def __init__(self, helper_id: str = "h0",
                 strategy: str = "honest", slow_s: float = 2.0):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown helper strategy {strategy!r} "
                             f"(have: {sorted(STRATEGIES)})")
        self.helper_id = helper_id
        self.strategy_name = strategy
        self.slow_s = slow_s
        self.leases_served = 0
        self._replay_cache: Optional[tuple] = None
        self._mutate = STRATEGIES[strategy](self)

    def set_strategy(self, strategy: str) -> None:
        """Swap behavior mid-run (an honest helper turns liar
        under load — the exact adversary the soundness check exists
        for)."""
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown helper strategy {strategy!r} "
                             f"(have: {sorted(STRATEGIES)})")
        self.strategy_name = strategy
        self._mutate = STRATEGIES[strategy](self)

    def handle(self, request: bytes) -> bytes:
        lease_id, kind, _deadline_ms, payload = proto.decode_request(request)
        self.leases_served += 1
        try:
            resp = compute(kind, payload)
            status = proto.ST_OK
        except HelperCrashed:
            raise
        except Exception as e:  # noqa: BLE001 — an honest helper
            # reports a compute error rather than fabricating bytes
            log.warning("helper %s compute failed: %s", self.helper_id, e)
            resp, status = b"", proto.ST_ERR
        if status == proto.ST_OK:
            lease_id, resp = self._mutate(lease_id, kind, payload, resp)
        return proto.encode_response(lease_id, status, resp)


# ---------------------------------------------------------------------
# TCP daemon
# ---------------------------------------------------------------------

class HelperDaemon:
    def __init__(self, port: int, host: str = "127.0.0.1",
                 helper_id: str = "h0", strategy: str = "honest"):
        self.server = HelperServer(helper_id, strategy)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._running = False
        self._accept_thread: Optional[threading.Thread] = None

    def start(self) -> "HelperDaemon":
        self._running = True
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="offload-helper-accept",
            daemon=True)
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        try:
            self._sock.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             name="offload-helper-conn",
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            while True:
                req = proto.recv_frame(conn)
                if req is None:
                    return
                try:
                    resp = self.server.handle(req)
                except HelperCrashed:
                    return          # drop the connection mid-lease
                proto.send_frame(conn, resp)
        except (OSError, proto.ProtocolError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="tpubft_torch crypto-offload helper daemon (non-voting, "
                    "untrusted — every answer is re-verified on-replica)")
    p.add_argument("--port", type=int, default=7700)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--id", default="h0", help="helper id (breaker name)")
    p.add_argument("--strategy", default="honest",
                   choices=sorted(STRATEGIES),
                   help="byzantine test behavior (default: honest)")
    p.add_argument("--log-level", default="INFO")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = make_parser().parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    daemon = HelperDaemon(args.port, args.host, args.id,
                          args.strategy).start()
    log.info("offload helper %s listening on %s:%d (strategy=%s)",
             args.id, args.host, daemon.port, args.strategy)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        daemon.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
