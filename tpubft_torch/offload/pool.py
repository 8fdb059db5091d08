"""Helper pool: leasing, verification, eviction — the trust boundary
(port of tpubft/offload/pool.py).

The pool is PROCESS-WIDE (like the device breaker and the chip mesh:
all replicas of one process share the helper fleet). Each helper gets a
`helper.<id>` circuit breaker so the health plane enumerates the family
exactly like the mesh's `device.chip<N>` children:

  * transport fault / deadline miss  -> SICK: breaker failure, normal
    cooldown + half-open probe re-admission;
  * failed soundness check, stale lease id, malformed bytes ->
    BYZANTINE: immediate eviction into the quarantine set and a forced
    breaker trip with an effectively-infinite cooldown — NO automatic
    re-admission; `operator_reset(helper_id)` is the only way back.

Lease semantics: deadline + single-retry-then-local. A lease that fails
(either way) re-runs on the local device/host path inside the same
flush, so callers never stall and verdict-producing code paths are
byte-identical with offload on or off.

High-level verified entry points (`combine_via_offload`,
`sum_via_offload`, `ecdsa_via_offload`) are the ONLY sanctioned seam
for crypto call sites — raw `lease()`/frame plumbing is confined to
this package by an AST scan (tests/test_torch_offload_seam.py).
"""
from __future__ import annotations

import logging
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from tpubft_torch.device import NoDevice
from tpubft_torch.offload import protocol as proto
from tpubft_torch.offload import soundness
from tpubft_torch.utils import flight
from tpubft_torch.utils.breaker import BreakerOpen, get_breaker
from tpubft_torch.utils.metrics import Component

log = logging.getLogger("tpubft_torch.offload")

# a quarantined helper's breaker cooldown: ~forever (operator reset
# required; the pool-level quarantine set is the enforcement, the
# breaker state is how `status get health` shows it)
QUARANTINE_COOLDOWN_S = 10 * 365 * 24 * 3600.0


class _ByzantineResponse(Exception):
    """Wire-level lie (stale lease id, ST_ERR abuse, undecodable
    envelope) — distinct from transport faults."""


class HelperTransport:
    """One helper endpoint. `call` returns the raw response payload for
    OUR lease id or raises (_ByzantineResponse / OSError / timeout)."""

    def __init__(self, helper_id: str):
        self.helper_id = helper_id

    def call(self, lease_id: int, kind: int, payload: bytes,
             timeout_s: float) -> bytes:
        raise NotImplementedError

    def close(self) -> None:
        pass


class InprocHelper(HelperTransport):
    """Direct call into a HelperServer — the in-process test
    transport. The deadline is enforced post-hoc (a synchronous call
    can't be interrupted): a slow-loris helper is detected when its
    answer comes back late, which is exactly the sick classification
    the TCP transport's socket timeout produces."""

    def __init__(self, helper_id: str, server):
        super().__init__(helper_id)
        self.server = server

    def call(self, lease_id: int, kind: int, payload: bytes,
             timeout_s: float) -> bytes:
        t0 = time.monotonic()
        req = proto.encode_request(lease_id, kind,
                                   int(timeout_s * 1000), payload)
        try:
            raw = self.server.handle(req)
        except Exception as e:
            raise OSError(f"helper {self.helper_id} dropped the lease: "
                          f"{e}") from e
        if time.monotonic() - t0 > timeout_s:
            raise socket.timeout(
                f"helper {self.helper_id} missed the lease deadline")
        return _check_envelope(raw, lease_id)


class TcpHelper(HelperTransport):
    """Frame transport to a helper daemon; connects lazily, one
    connection per pool (leases are serialized per helper by the
    breaker's perspective anyway — parallelism comes from helper
    COUNT, not per-helper pipelining)."""

    def __init__(self, helper_id: str, host: str, port: int):
        super().__init__(helper_id)
        self.host, self.port = host, port
        self._sock: Optional[socket.socket] = None
        self._mu = threading.Lock()

    def _connect(self, timeout_s: float) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection((self.host, self.port),
                                         timeout=timeout_s)
            self._sock = s
        self._sock.settimeout(timeout_s)
        return self._sock

    def call(self, lease_id: int, kind: int, payload: bytes,
             timeout_s: float) -> bytes:
        with self._mu:
            try:
                s = self._connect(timeout_s)
                proto.send_frame(s, proto.encode_request(
                    lease_id, kind, int(timeout_s * 1000), payload))
                raw = proto.recv_frame(s)
            except (OSError, proto.ProtocolError):
                self.close()
                raise
            if raw is None:
                self.close()
                raise OSError(f"helper {self.helper_id} closed mid-lease")
            return _check_envelope(raw, lease_id)

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


def _check_envelope(raw: bytes, lease_id: int) -> bytes:
    try:
        rid, status, body = proto.decode_response(raw)
    except proto.ProtocolError as e:
        raise _ByzantineResponse(f"undecodable response ({e})") from e
    if rid != lease_id:
        raise _ByzantineResponse(
            f"stale lease replay (got id {rid}, expected {lease_id})")
    if status != proto.ST_OK:
        # an honest helper may legitimately fail to compute (e.g. it
        # can't decode OUR payload — which would be our bug); treat as
        # transport-grade so it degrades, not convicts
        raise OSError("helper reported compute error")
    return body


class HelperPool:
    def __init__(self) -> None:
        self._mu = threading.RLock()
        self._helpers: Dict[str, HelperTransport] = {}
        self._order: List[str] = []
        self._quarantined: set = set()
        self._rr = 0
        self._lease_seq = 0
        self._inflight = 0
        self.enabled = False
        self.routing = True          # the autotuner's actuator
        self.lease_timeout_s = 0.2
        self.max_inflight = 4
        self.metrics = Component("offload")
        self.m_issued = self.metrics.register_counter("lease_issued")
        self.m_verified = self.metrics.register_counter("lease_verified")
        self.m_rejected = self.metrics.register_counter("lease_rejected")
        self.m_evicted = self.metrics.register_counter("helper_evicted")
        self.m_timeouts = self.metrics.register_counter("lease_timeouts")
        self.m_local = self.metrics.register_counter("local_fallbacks")
        self.g_admitted = self.metrics.register_gauge("helpers_admitted")
        # cumulative lease cost (µs + items) — the autotuner's routing
        # policy diffs these across telemetry snapshots to compare
        # leased per-item cost against the local kernel per-item cost
        self.lease_us_total = 0
        self.lease_items_total = 0
        self.soundness_us_total = 0
        self._h_soundness = None
        self._h_lease = None

    # ---- wiring ------------------------------------------------------

    def _hists(self):
        if self._h_soundness is None:
            from tpubft_torch.diagnostics import get_registrar
            self._h_soundness = get_registrar().histogram(
                "off_soundness_us", unit="us")
            self._h_lease = get_registrar().histogram(
                "off_lease_us", unit="us")
        return self._h_soundness, self._h_lease

    def configure(self, enabled: Optional[bool] = None,
                  lease_timeout_ms: Optional[int] = None,
                  max_inflight: Optional[int] = None) -> None:
        with self._mu:
            if enabled is not None:
                self.enabled = bool(enabled)
            if lease_timeout_ms is not None:
                self.lease_timeout_s = max(1, int(lease_timeout_ms)) / 1000.0
            if max_inflight is not None:
                self.max_inflight = max(1, int(max_inflight))

    def add_helper(self, transport: HelperTransport) -> None:
        with self._mu:
            hid = transport.helper_id
            self._helpers[hid] = transport
            if hid not in self._order:
                self._order.append(hid)
            # materialize the breaker so the family is visible in
            # `status get health` from admission, not first failure
            get_breaker(f"helper.{hid}")
            self._refresh_admitted()

    def add_endpoint(self, helper_id: str, host: str, port: int) -> None:
        self.add_helper(TcpHelper(helper_id, host, port))

    def remove_helper(self, helper_id: str) -> None:
        with self._mu:
            t = self._helpers.pop(helper_id, None)
            if t is not None:
                t.close()
            if helper_id in self._order:
                self._order.remove(helper_id)
            self._refresh_admitted()

    def set_routing(self, on: bool) -> None:
        """Autotuner actuator: keep the tier configured but stop (or
        resume) routing work helper-ward."""
        with self._mu:
            self.routing = bool(on)

    def _refresh_admitted(self) -> None:
        self.g_admitted.set(len([h for h in self._order
                                 if h not in self._quarantined]))

    def active(self) -> bool:
        with self._mu:
            return (self.enabled and self.routing
                    and any(h not in self._quarantined
                            for h in self._order))

    # ---- leasing -----------------------------------------------------

    def lease(self, kind: int, payload: bytes,
              n_items: int) -> Optional[Tuple[str, bytes]]:
        """(helper_id, response payload) or None -> run locally. The
        response payload is UNVERIFIED — callers must pass it through a
        soundness check before it can touch a verdict."""
        with self._mu:
            if not (self.enabled and self.routing):
                return None
            if self._inflight >= self.max_inflight:
                self.m_local.inc()
                return None
            self._inflight += 1
        try:
            tried: set = set()
            for _attempt in range(2):       # deadline + single retry
                h = self._pick(tried)
                if h is None:
                    break
                tried.add(h.helper_id)
                br = get_breaker(f"helper.{h.helper_id}")
                with self._mu:
                    self._lease_seq += 1
                    lease_id = self._lease_seq
                self.m_issued.inc()
                flight.record(flight.EV_OFF_LEASE, arg=n_items, view=kind)
                t0 = time.perf_counter()
                try:
                    with br.attempt("lease"):
                        body = h.call(lease_id, kind, payload,
                                      self.lease_timeout_s)
                except BreakerOpen:
                    continue
                except _ByzantineResponse as e:
                    self.report_byzantine(h.helper_id, str(e))
                    continue
                except Exception as e:  # noqa: BLE001 — transport
                    # fault / deadline miss: the breaker recorded the
                    # failure (sick path — cooldown + probe)
                    self.m_timeouts.inc()
                    log.warning("lease to helper %s failed (sick): %s",
                                h.helper_id, e)
                    continue
                dt_us = int((time.perf_counter() - t0) * 1e6)
                self._hists()[1].record(dt_us)
                with self._mu:
                    self.lease_us_total += dt_us
                    self.lease_items_total += max(1, n_items)
                return h.helper_id, body
            self.m_local.inc()
            return None
        finally:
            with self._mu:
                self._inflight -= 1

    def _pick(self, tried: set) -> Optional[HelperTransport]:
        """Round-robin over admitted (non-quarantined, breaker-willing)
        helpers, skipping ones this lease already tried."""
        with self._mu:
            n = len(self._order)
            for i in range(n):
                hid = self._order[(self._rr + i) % n]
                if hid in tried or hid in self._quarantined:
                    continue
                if not get_breaker(f"helper.{hid}").allow():
                    continue
                self._rr = (self._rr + i + 1) % n
                return self._helpers[hid]
            return None

    # ---- verdicts on helpers ----------------------------------------

    def lease_verified(self, helper_id: str, soundness_us: int) -> None:
        self.m_verified.inc()
        self._hists()[0].record(soundness_us)
        with self._mu:
            self.soundness_us_total += soundness_us
        flight.record(flight.EV_OFF_VERIFIED, arg=soundness_us)

    def lease_rejected(self, helper_id: str, soundness_us: int) -> None:
        self.m_rejected.inc()
        self._hists()[0].record(soundness_us)
        with self._mu:
            self.soundness_us_total += soundness_us
        with self._mu:
            ordinal = (self._order.index(helper_id)
                       if helper_id in self._order else -1)
        flight.record(flight.EV_OFF_REJECTED, arg=max(0, ordinal))

    def report_byzantine(self, helper_id: str, reason: str) -> None:
        """Quarantine: the helper lied. No cooldown path back — the
        forced breaker trip keeps `status get health` degraded until an
        operator resets it (a lying helper held out of the pool IS a
        degraded fleet, not a healed one)."""
        with self._mu:
            if helper_id in self._quarantined:
                return
            self._quarantined.add(helper_id)
            self._refresh_admitted()
        get_breaker(f"helper.{helper_id}").trip(
            cooldown_s=QUARANTINE_COOLDOWN_S, cause="byzantine")
        self.m_evicted.inc()
        flight.record(flight.EV_OFF_EVICT, arg=1)
        log.error("helper %s evicted as BYZANTINE (%s) — quarantined, "
                  "operator reset required", helper_id, reason)

    def operator_reset(self, helper_id: str) -> None:
        """The ONE way back in for a quarantined helper."""
        with self._mu:
            self._quarantined.discard(helper_id)
            self._refresh_admitted()
        get_breaker(f"helper.{helper_id}").reset()
        log.warning("helper %s re-admitted by operator reset", helper_id)

    @property
    def quarantined(self) -> set:
        with self._mu:
            return set(self._quarantined)

    # ---- observability ----------------------------------------------

    def snapshot(self) -> Dict:
        with self._mu:
            return {
                "enabled": self.enabled,
                "routing": self.routing,
                "helpers": list(self._order),
                "quarantined": sorted(self._quarantined),
                "max_inflight": self.max_inflight,
                "lease_timeout_ms": int(self.lease_timeout_s * 1000),
                "lease_us_total": self.lease_us_total,
                "lease_items_total": self.lease_items_total,
                "soundness_us_total": self.soundness_us_total,
                "counters": {k: c.value
                             for k, c in self.metrics.counters.items()},
            }

    def reset(self) -> None:
        """Test isolation: drop helpers, quarantine and
        counters; per-helper breakers reset too (they are registry-
        global and would otherwise leak state across scenarios)."""
        with self._mu:
            for t in self._helpers.values():
                t.close()
            for hid in self._order:
                get_breaker(f"helper.{hid}").reset()
            self._helpers.clear()
            self._order.clear()
            self._quarantined.clear()
            self._inflight = 0
            self.enabled = False
            self.routing = True
            self.lease_timeout_s = 0.2
            self.max_inflight = 4
            self.lease_us_total = 0
            self.lease_items_total = 0
            self.soundness_us_total = 0
            for c in self.metrics.counters.values():
                c.value = 0
            self._refresh_admitted()


# ---------------------------------------------------------------------
# process-wide accessor (ops/dispatch.offload_pool() fronts this)
# ---------------------------------------------------------------------
_POOL: Optional[HelperPool] = None
_POOL_MU = threading.Lock()


def get_offload_pool() -> HelperPool:
    global _POOL
    with _POOL_MU:
        if _POOL is None:
            _POOL = HelperPool()
            flight.register_dump_provider(
                "offload", lambda: _POOL.snapshot()
                if _POOL is not None else {})
        return _POOL


def pool_if_active() -> Optional[HelperPool]:
    """The pool iff it exists AND is currently routing work — the hot
    paths' cheap gate (no pool construction on the offload-off path)."""
    p = _POOL
    return p if (p is not None and p.active()) else None


def reset_offload_pool() -> None:
    p = _POOL
    if p is not None:
        p.reset()


# ---------------------------------------------------------------------
# the verified high-level API — what crypto call sites use
# ---------------------------------------------------------------------

def combine_via_offload(segments: Sequence[Tuple[Sequence[int],
                                                 Sequence[object]]],
                        digests: Sequence[bytes], master_pk,
                        local_fn: Callable[[], List]) -> Optional[List]:
    """Lease the threshold Lagrange/MSM combine. Returns the per-
    segment combined points — VERIFIED helper output, or (after a
    failed check) the local re-run's output — or None when no lease
    happened and the caller should run its own path. Callers get
    byte-identical results to `local_fn()` in every case."""
    from tpubft_torch.crypto import bls12381 as bls
    pool = pool_if_active()
    if pool is None:
        return None
    live = [i for i, (ids, _) in enumerate(segments) if ids]
    if not live:
        return None
    try:
        req = proto.encode_bls_segments(
            [(list(segments[i][0]),
              [bls.g1_compress(p) for p in segments[i][1]])
             for i in live])
    except proto.ProtocolError:
        return None
    leased = pool.lease(proto.KIND_BLS_COMBINE, req,
                        sum(len(segments[i][0]) for i in live))
    if leased is None:
        return None
    hid, resp = leased
    t0 = time.perf_counter()
    raw_pts = proto.decode_points(resp, len(live))
    pts = soundness.decompress_points(raw_pts) if raw_pts else None
    ok = pts is not None and soundness.check_bls_combine(
        master_pk, [digests[i] for i in live], pts)
    dt_us = int((time.perf_counter() - t0) * 1e6)
    if ok:
        pool.lease_verified(hid, dt_us)
        out = [None] * len(segments)
        for i, pt in zip(live, pts):
            out[i] = pt
        return out
    # check failed: ONE local re-run disambiguates bad shares from a
    # lying helper (see soundness.py docstring)
    pool.lease_rejected(hid, dt_us)
    local = local_fn()
    if pts is None or any(
            bls.g1_compress(pts[j]) != bls.g1_compress(local[i])
            for j, i in enumerate(live) if local[i] is not None):
        pool.report_byzantine(hid, "bls-combine soundness check failed")
    # helper honest, shares bad: the local (equally failing) points
    # flow to verify_batch_certs -> bad-share identification exactly
    # as with offload off
    return local


def sum_via_offload(segments: Sequence[Sequence[object]],
                    meta: Sequence[Optional[Tuple[bytes, Tuple[int, ...]]]],
                    verifier, local_fn: Callable[[], List]
                    ) -> Optional[List]:
    """Lease the multisig-BLS unweighted sums. meta[i] = (digest,
    contributor ids) per segment (None segments stay local)."""
    from tpubft_torch.crypto import bls12381 as bls
    pool = pool_if_active()
    if pool is None:
        return None
    live = [i for i, pts in enumerate(segments)
            if pts and meta[i] is not None and meta[i][1]]
    if not live:
        return None
    try:
        # ids are a no-op for the unweighted sum — zeros keep the one
        # segment encoding shared with the combine lease
        req = proto.encode_bls_segments(
            [([0] * len(segments[i]),
              [bls.g1_compress(p) for p in segments[i]])
             for i in live])
    except proto.ProtocolError:
        return None
    leased = pool.lease(proto.KIND_BLS_SUM, req,
                        sum(len(segments[i]) for i in live))
    if leased is None:
        return None
    hid, resp = leased
    t0 = time.perf_counter()
    raw_pts = proto.decode_points(resp, len(live))
    pts = soundness.decompress_points(raw_pts) if raw_pts else None
    ok = False
    if pts is not None:
        try:
            check_meta = [(meta[i][0], verifier.agg_pk(list(meta[i][1])))
                          for i in live]
            ok = soundness.check_bls_sum(check_meta, pts)
        except Exception:  # noqa: BLE001 — out-of-range ids etc.:
            ok = False     # treat as unverifiable, fall to local
    dt_us = int((time.perf_counter() - t0) * 1e6)
    if ok:
        pool.lease_verified(hid, dt_us)
        out = [None] * len(segments)
        for i, pt in zip(live, pts):
            out[i] = pt
        return out
    pool.lease_rejected(hid, dt_us)
    local = local_fn()
    if pts is None or any(
            local[i] is not None
            and bls.g1_compress(pts[j]) != bls.g1_compress(local[i])
            for j, i in enumerate(live)):
        pool.report_byzantine(hid, "bls-sum soundness check failed")
    return local


def ecdsa_via_offload(curve: str,
                      items: Sequence[Tuple[bytes, bytes, bytes]],
                      local_fn: Callable[[], List[bool]]
                      ) -> Optional[List[bool]]:
    """Lease the ECDSA verdict storm: the helper returns per-item bits,
    the replica re-folds the accepted subset in ONE launch with its own
    coefficients and host-checks the plausible rejects. The win is
    skipping the bisection descent under forgery floods; a lying
    helper (either direction) is evicted and the whole batch re-runs
    locally."""
    pool = pool_if_active()
    if pool is None:
        return None
    leased = pool.lease(proto.KIND_ECDSA_RLC,
                        proto.encode_ecdsa_items(curve, items), len(items))
    if leased is None:
        return None
    hid, resp = leased
    from tpubft_torch.ops import ecdsa as ops_ecdsa
    t0 = time.perf_counter()
    bits = proto.decode_verdicts(resp, len(items))
    verdicts = None
    if bits is not None:
        try:
            prep = ops_ecdsa.prepare_rlc_batch(curve, items)
            verdicts = soundness.check_ecdsa_verdicts(curve, items,
                                                      prep, bits)
        except NoDevice:
            # port divergence (reference pool.py:579-587 catches every
            # exception): a missing card is a fault of the set-up, not
            # device loss, and must not become a quiet local run
            raise
        except Exception:  # noqa: BLE001 — device loss during the
            # check launch: we cannot verify, so we cannot use the
            # helper's answer; the caller's local path degrades
            # exactly as it would with offload off
            dt_us = int((time.perf_counter() - t0) * 1e6)
            pool.lease_rejected(hid, dt_us)
            return None
    dt_us = int((time.perf_counter() - t0) * 1e6)
    if verdicts is not None:
        pool.lease_verified(hid, dt_us)
        return verdicts
    pool.lease_rejected(hid, dt_us)
    pool.report_byzantine(
        hid, "ecdsa verdict bits failed the re-fold check"
        if bits is not None else "malformed ecdsa verdict payload")
    return local_fn()
