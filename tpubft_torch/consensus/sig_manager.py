"""Per-message signing and verification (port of
tpubft/consensus/sig_manager.py).

Rebuild of concord-bft's SigManager singleton
(bftengine/src/bftengine/SigManager.hpp:32; verifySig SigManager.cpp:197,
sign :240): holds this replica's signer plus a verifier per principal
(replicas + clients), with verified/failed metrics.

Device-first delta: ALL verification flows through one batched plane.
`verify` is a batch of one; `BatchVerifier` coalesces async admission
traffic into fixed-size batches; `verify_batch` front-runs everything
with a bounded LRU memo of already-verified (principal, digest, sig)
triples (retransmissions and view-change re-validation re-present
identical items), then dispatches the residue as per-curve kernel calls
(tpubft_torch.ops.ed25519 / ops.ecdsa via the configured batch_fn,
normally crypto/cuda.verify_batch_mixed) or the per-principal scalar
fallback: `device_min_batch` gates the non-ECDSA items, and the ECDSA
items always go to batch_fn, whose crossover places each curve's
group. Per-path counters (`memo_hits`, `batched_verifies`,
`scalar_fallbacks`) ride the metrics component, with the ECDSA host
tier's (`ecdsa_batched_host`, `pubkey_memo_hits`, `ecdsa_pk_evictions`,
`ecdsa_comb_evictions`, `ecdsa_host_us`, the `sigmgr<id>.ecdsa_host_batch`
histogram) folded from the scalar engine's attributed stats sink.
This takes the per-message sig check off the dispatcher thread, the
reference's RequestThreadPool role. The mesh counter
(`mesh_sharded_verifies`) waits for the mesh tier (ROADMAP A.7).
"""
from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from tpubft_torch.consensus.keys import ClusterKeys
from tpubft_torch.crypto.cpu import ECDSA_CURVES
from tpubft_torch.crypto.interfaces import IVerifier
from tpubft_torch.device import NoDevice
from tpubft_torch.ops.dispatch import BreakerOpen, device_breaker
from tpubft_torch.utils.logging import get_logger
from tpubft_torch.utils.metrics import Aggregator, Component

log = get_logger("sigmgr")


class SigManager:
    def __init__(self, keys: ClusterKeys,
                 aggregator: Optional[Aggregator] = None,
                 verifier_factory: Optional[Callable[[bytes], IVerifier]] = None,
                 alias_fn: Optional[Callable[[int], int]] = None,
                 grace_seq_window: int = 300,
                 batch_fn: Optional[Callable[
                     [Sequence[Tuple[bytes, bytes, bytes]]],
                     List[bool]]] = None,
                 device_min_batch: int = 1,
                 memo_capacity: int = 4096,
                 verifier_cache_max: int = 4096):
        self._keys = keys
        # cross-principal batch backend: [(scheme, pubkey, data, sig)] ->
        # verdicts in ONE dispatch per scheme (the device path; None =
        # per-principal loop)
        self._batch_fn = batch_fn
        # non-ECDSA residues smaller than this verify on the
        # per-principal CPU verifiers — a device dispatch only pays off
        # once it amortizes over enough signatures (SURVEY §7 hard part
        # 6); ECDSA items always reach batch_fn, whose crossover decides
        self.device_min_batch = device_min_batch
        # a superseded key only verifies messages whose consensus seqnum
        # is at most rotation_seq + this window (callers pass the
        # config's work_window_size: everything deeper in flight than the
        # work window cannot order anyway)
        self.grace_seq_window = grace_seq_window
        # own copies: key exchange rotates keys per-replica-process, and the
        # shared ClusterKeys dicts must not leak one node's view to others.
        # Client keys are exempt — rotation never mutates them, so a
        # virtual keyspace (a lazy Mapping deriving 1M principals' keys
        # on demand, the bench_dispatch --principals shape) is kept by
        # reference instead of being materialized into a 1M-entry dict.
        self._replica_pubkeys: Dict[int, bytes] = dict(keys.replica_pubkeys)
        cpk = keys.client_pubkeys
        self._client_pubkeys = dict(cpk) if type(cpk) is dict else cpk
        # rotation grace keys: principal -> (old pubkey, rotated_at)
        self._prev_pubkeys: Dict[int, Tuple[bytes, float]] = {}
        self._signer = keys.my_signer() if keys.my_sign_seed else None
        # bounded verifier cache: touched principals would otherwise pin
        # one IVerifier each forever — O(principals) resident at scale
        self._verifiers: "OrderedDict[int, IVerifier]" = OrderedDict()
        self._verifier_cache_max = max(1, verifier_cache_max)
        self._prev_verifiers: Dict[int, IVerifier] = {}
        # verify() runs on the dispatcher AND on collector-pool workers
        # (async PP batches); key rotation + grace-key expiry mutate the
        # shared dicts, so those sections take this lock
        self._lock = threading.Lock()
        self._verifier_factory = verifier_factory
        # maps alias principals (e.g. internal-client ids) onto the
        # replica principal whose key signs for them
        self._alias = alias_fn or (lambda p: p)
        self.metrics = Component("signature_manager", aggregator)
        self.sigs_verified = self.metrics.register_counter("sigs_verified")
        self.sig_failures = self.metrics.register_counter("sig_failures")
        self.sigs_signed = self.metrics.register_counter("sigs_signed")
        # signatures dispatched through the cross-principal device batch
        # (dispatch count, not verdicts — failures land in sig_failures)
        self.sigs_device_dispatched = self.metrics.register_counter(
            "sigs_device_dispatched")
        # verified-signature memo: bounded LRU of (principal, current
        # pubkey, sha256(data), sig) that already verified under the
        # CURRENT key. Retransmissions and view-change re-validation
        # re-present identical triples; a hit short-circuits the full
        # kernel/scalar cost. Keying on the pubkey makes rotation safe
        # for free: a rotated principal's entries simply stop matching
        # (and sigs accepted only via a grace key are never memoized).
        self._memo: "OrderedDict[Tuple, None]" = OrderedDict()
        self._memo_capacity = memo_capacity
        self._memo_lock = threading.Lock()
        # per-path counters (make the batched plane *the* hot
        # path and prove it) — memo short-circuits, items verified
        # through the coalesced cross-principal batch, and items that
        # fell back to the per-principal scalar loop
        self.memo_hits = self.metrics.register_counter("memo_hits")
        # entries LRU-evicted from the bounded memo. At steady state a
        # high eviction rate alongside a falling memo hit-rate means the
        # live principal population outruns memo_capacity — the signal
        # (with the client-table and comb-cache eviction counters) that
        # distinguishes "cache too small" from "population churned"
        # at million-principal scale (docs/OPERATIONS.md client-plane
        # scaling section)
        self.memo_evictions = self.metrics.register_counter(
            "memo_evictions")
        # per-principal verifier objects LRU-evicted from the bounded
        # cache (re-created on next touch from the pubkey — an eviction
        # costs one verifier construction, never correctness)
        self.verifier_evictions = self.metrics.register_counter(
            "verifier_evictions")
        self.batched_verifies = self.metrics.register_counter(
            "batched_verifies")
        self.scalar_fallbacks = self.metrics.register_counter(
            "scalar_fallbacks")
        # items rerouted device→scalar at RUNTIME (device exception or a
        # tripped circuit breaker) — a nonzero value means the system ran
        # in degraded verification mode; the breaker snapshot says why
        self.degraded_verifies = self.metrics.register_counter(
            "degraded_verifies")
        # ECDSA two-tier sensors (the autotuner's inputs): the device
        # tier's batch stats flow through the kernel profiler
        # (device_section("ecdsa")); the host tier is counted here —
        # items through crypto/scalar.ecdsa_verify_batch (attributed to
        # THIS manager via the thread-local stats sink wrapped around
        # its verification, so every route it takes is covered) and
        # pubkey-decode memo hits (decode + on-curve check paid once per
        # key, not per retransmitted verify)
        self.ecdsa_batched_host = self.metrics.register_counter(
            "ecdsa_batched_host")
        self.pubkey_memo_hits = self.metrics.register_counter(
            "pubkey_memo_hits")
        # bounded-LRU evictions in the scalar engine's per-principal
        # caches (pubkey-decode entries / hot comb tables) attributed to
        # this manager's verifies — read next to pubkey_memo_hits: a
        # high eviction rate with a falling hit-rate means the worker's
        # principal population outruns TPUBFT_ECDSA_PK_CACHE
        self.ecdsa_pk_evictions = self.metrics.register_counter(
            "ecdsa_pk_evictions")
        self.ecdsa_comb_evictions = self.metrics.register_counter(
            "ecdsa_comb_evictions")
        # cumulative wall time the batched host engine spent on THIS
        # manager's items (µs) — with ecdsa_batched_host this yields the
        # host tier's per-item cost, the sensor the autotuner compares
        # against the kernel profiler's `ecdsa` device tier to place
        # the crossover knob
        self.ecdsa_host_us = self.metrics.register_counter(
            "ecdsa_host_us")
        from tpubft_torch.diagnostics import get_registrar
        # replica-scoped so in-process multi-replica topologies don't
        # co-mingle batch-shape samples
        who = "" if keys.my_id is None else keys.my_id
        self._h_ecdsa_host_batch = get_registrar().histogram(
            f"sigmgr{who}.ecdsa_host_batch", unit="items")

    # ---- signing ----
    def sign(self, data: bytes) -> bytes:
        assert self._signer is not None, "no private key on this node"
        self.sigs_signed.inc()
        return self._signer.sign(data)

    def sign_batch(self, datas: Sequence[bytes]) -> List[bytes]:
        """Sign many payloads under this node's key in one call. Signers
        exposing a native batch (the scalar ed25519 engine's lockstep
        comb walk + Montgomery batch inversion) amortize the per-item
        field inversions across the batch; others degrade to a loop.
        The durability pipeline signs each sealed group's reply burst
        through here — one batched sign per group instead of one scalar
        sign per request."""
        assert self._signer is not None, "no private key on this node"
        if not datas:
            return []
        self.sigs_signed.inc(len(datas))
        batch = getattr(self._signer, "sign_batch", None)
        if batch is not None:
            return batch(datas)
        return [self._signer.sign(d) for d in datas]

    @property
    def my_id(self) -> Optional[int]:
        return self._keys.my_id

    # ---- key rotation (KeyExchangeManager upcalls) ----
    # wall-clock backstop used ONLY for rotations without a seqnum
    # context; seq-scoped rotations expire by CHECKPOINT ERA instead —
    # on_stable() drops a superseded key once stability passes its grace
    # window (the reference's per-checkpoint-era CryptoManager lookup,
    # CryptoManager.hpp:109)
    GRACE_WINDOW_S = 30.0

    def set_replica_key(self, replica_id: int, new_pubkey: bytes,
                        rotation_seq: Optional[int] = None) -> None:
        """Swap a replica's public key. The previous key is kept only for
        verifying messages at seqnums ordered before (or immediately
        around) the exchange at `rotation_seq`; verifications that carry
        no seqnum context never fall back to it."""
        with self._lock:
            old = self._replica_pubkeys.get(replica_id)
            if old == new_pubkey:
                return
            if old is not None:
                self._prev_pubkeys[replica_id] = (old, time.monotonic(),
                                                  rotation_seq)
                self._prev_verifiers.pop(replica_id, None)
            self._replica_pubkeys[replica_id] = new_pubkey
            self._verifiers.pop(replica_id, None)

    def set_my_signer(self, signer) -> None:
        self._signer = signer

    def on_stable(self, stable_seq: int) -> None:
        """Checkpoint-era expiry: once stability passes a rotation's
        grace window, nothing signed under the old key can order anymore
        — drop it (callers: replica._on_seq_stable)."""
        with self._lock:
            for p in [p for p, (_, _, rot_seq) in self._prev_pubkeys.items()
                      if rot_seq is not None
                      and stable_seq >= rot_seq + self.grace_seq_window]:
                self._prev_pubkeys.pop(p, None)
                self._prev_verifiers.pop(p, None)

    # ---- verification ----
    def _scheme_of(self, principal: int) -> str:
        """Per-principal signature scheme (reference SigManager builds a
        scheme-specific verifier per principal from the keyfile; BASELINE
        configs 3/5 mix secp256k1 clients with EdDSA replicas)."""
        scheme = getattr(self._keys, "scheme_of", None)
        return scheme(principal) if scheme is not None else "ed25519"

    def _make_verifier(self, pk: bytes, principal: int) -> IVerifier:
        if self._verifier_factory is not None:
            return self._verifier_factory(pk)
        from tpubft_torch.crypto.cpu import make_verifier
        return make_verifier(self._scheme_of(principal), pk)

    def _pubkey_of(self, principal: int) -> Optional[bytes]:
        return (self._replica_pubkeys.get(principal)
                or self._client_pubkeys.get(principal))

    def _verifier(self, principal: int) -> IVerifier:
        # the whole get-or-create holds the lock: a worker thread must not
        # read a pre-rotation pubkey, lose the CPU to the dispatcher's
        # set_replica_key, then cache a verifier for the rotated-away key
        principal = self._alias(principal)
        evicted = 0
        with self._lock:
            v = self._verifiers.get(principal)
            if v is not None:
                self._verifiers.move_to_end(principal)
                return v
            pk = self._pubkey_of(principal)
            if pk is None:
                raise KeyError(f"no public key for principal {principal}")
            v = self._verifiers[principal] = self._make_verifier(
                pk, principal)
            while len(self._verifiers) > self._verifier_cache_max:
                self._verifiers.popitem(last=False)
                evicted += 1
        if evicted:
            self.verifier_evictions.inc(evicted)
        return v

    def _grace_verifier(self, principal: int, seq: Optional[int],
                        view_scoped: bool = False) -> Optional[IVerifier]:
        """Old-key verifier for in-flight consensus messages only: scoped
        to seqnums at most rotation_seq + grace_seq_window, or (for
        view-change-family messages, which carry views not seqnums) to the
        wall-clock window. Verifications with neither context — e.g.
        client requests — never accept a rotated-away key (a compromised
        pre-rotation key must not keep authenticating arbitrary traffic)."""
        principal = self._alias(principal)
        with self._lock:
            entry = self._prev_pubkeys.get(principal)
            if entry is None:
                return None
            pk, rotated_at, rotation_seq = entry
            expired_wallclock = (time.monotonic() - rotated_at
                                 > self.GRACE_WINDOW_S)
            if rotation_seq is None and expired_wallclock:
                # no seqnum scope exists: the wall clock is the only
                # bound, and past it the leaked/old key must stop
                # verifying — that's the point of rotating
                self._prev_pubkeys.pop(principal, None)
                self._prev_verifiers.pop(principal, None)
                return None
            if seq is None:
                # view-change-family messages have no seqnum to scope by,
                # so the wall clock ALWAYS bounds them — a sustained view
                # change (no checkpoints stabilizing, on_stable never
                # firing) must not let a leaked key authenticate
                # view-scoped traffic indefinitely. The entry itself
                # survives for seq-scoped lookups until on_stable.
                if not view_scoped or expired_wallclock:
                    return None
            elif rotation_seq is not None \
                    and seq > rotation_seq + self.grace_seq_window:
                return None
            v = self._prev_verifiers.get(principal)
            if v is None:
                v = self._prev_verifiers[principal] = self._make_verifier(
                    pk, principal)
            return v

    def has_principal(self, principal: int) -> bool:
        return self._pubkey_of(self._alias(principal)) is not None

    # ---- verified-signature memo ----
    # entries are (aliased principal, CURRENT pubkey, sha256(data), sig);
    # keys are built inline in _verify_items from one batched pubkey
    # resolution. No entry exists for unknown principals, and
    # memo_capacity=0 disables the memo (benchmarks measuring the raw
    # engine).
    def _memo_hit(self, key: Tuple) -> bool:
        with self._memo_lock:
            if key in self._memo:
                self._memo.move_to_end(key)
                return True
        return False

    def _memo_add(self, key: Tuple) -> None:
        evicted = 0
        with self._memo_lock:
            self._memo[key] = None
            self._memo.move_to_end(key)
            while len(self._memo) > self._memo_capacity:
                self._memo.popitem(last=False)
                evicted += 1
        if evicted:
            self.memo_evictions.inc(evicted)

    def verify(self, principal: int, data: bytes, sig: bytes,
               seq: Optional[int] = None,
               view_scoped: bool = False) -> bool:
        """Verify one signature — a thin wrapper over the batched plane
        (a batch of one), so every hot-path verify shares the memo and
        the coalescing machinery. `seq` is the consensus seqnum the
        message belongs to, when it has one; `view_scoped` marks
        view-change-family messages (no seqnum, still in-flight protocol
        traffic). One of the two is required for the post-rotation grace
        fallback — verifications without protocol context never accept a
        rotated-away key."""
        return self._verify_items([(principal, data, sig)], seq,
                                  view_scoped)[0]

    def verify_batch(self, items: Sequence[Tuple[int, bytes, bytes]],
                     seq: Optional[int] = None,
                     view_scoped: bool = False) -> List[bool]:
        """Verify [(principal, data, sig)] — the batch-plane entry the
        BatchVerifier/collector workers drain into (kept as the public
        seam: tests and wrappers intercept it to shape the async plane
        without touching inline dispatcher verifies)."""
        return self._verify_items(items, seq, view_scoped)

    def _verify_items(self, items: Sequence[Tuple[int, bytes, bytes]],
                      seq: Optional[int],
                      view_scoped: bool) -> List[bool]:
        """The one verification path: memo short-circuit first, then ONE
        cross-principal dispatch (per-curve kernel calls) when a batch
        backend is configured (CUDA) and the residue is big enough to
        amortize it, otherwise grouped per principal with each verifier
        free to vectorize. Fresh verdicts verified under the current key
        are memoized for retransmit/duplicate traffic."""
        out: List[bool] = [False] * len(items)
        keys: List[Optional[Tuple]] = [None] * len(items)
        pending: List[int] = []
        # ONE lock acquisition resolves every principal's current pubkey;
        # the list feeds both the memo keys and the cross-batch dispatch
        # (per-item locking on a 1000-item admission batch is pure
        # overhead, and dispatch must not see a different key epoch than
        # the memo did)
        aliased = [self._alias(p) for p, _, _ in items]
        with self._lock:
            pks = [self._pubkey_of(a) for a in aliased]
        memo_on = self._memo_capacity > 0
        for i, ((p, data, sig), a, pk) in enumerate(zip(items, aliased,
                                                        pks)):
            key = ((a, pk, hashlib.sha256(data).digest(), bytes(sig))
                   if memo_on and pk is not None else None)
            if key is not None and self._memo_hit(key):
                out[i] = True
                self.memo_hits.inc()
            else:
                keys[i] = key
                pending.append(i)
        if pending:
            from tpubft_torch.crypto import scalar as scalar_engine
            # thread-local attribution scope: the shared module-level
            # scalar engine records ECDSA batch/memo events into THIS
            # manager's sink (verification runs synchronously on this
            # thread), so per-replica metrics stay exact even when
            # several in-process replicas share the engine's caches
            sink = scalar_engine.new_stats_sink()
            with scalar_engine.attribute_stats(sink):
                self._verify_pending(items, pending, out, keys, aliased,
                                     pks, seq, view_scoped)
            self._fold_ecdsa_stats(sink)
        for ok in out:
            (self.sigs_verified if ok else self.sig_failures).inc()
        return out

    def _verify_pending(self, items, pending: List[int], out: List[bool],
                        keys: List[Optional[Tuple]], aliased, pks,
                        seq: Optional[int], view_scoped: bool) -> None:
        """Memo-miss residue: one cross-principal device dispatch when
        configured, else the grouped host path. Successful current-key
        verdicts are memoized.

        Port divergence (reference sig_manager.py:429-430 gates the whole
        residue by device_min_batch): here device_min_batch gates the
        non-ECDSA items alone, and every ECDSA item goes to the batch
        backend, whose crossover (crypto/cuda.ecdsa_crossover) alone
        decides where each curve's group verifies."""
        on_device: List[int] = []
        if self._batch_fn is not None:
            ecdsa = [self._scheme_of(aliased[i]) in ECDSA_CURVES
                     for i in pending]
            enough = len(pending) - sum(ecdsa) >= self.device_min_batch
            on_device = [i for i, e in zip(pending, ecdsa) if e or enough]
        got: Dict[int, Tuple[bool, bool]] = {}
        if on_device:
            dev = self._verify_on_device(items, on_device, aliased, pks,
                                         seq, view_scoped)
            if dev is not None:
                got.update(zip(on_device, zip(*dev)))
        rest = [i for i in pending if i not in got]
        if rest:
            verdicts, via_grace = self._verify_batch_grouped(
                [items[i] for i in rest], seq, view_scoped)
            self.scalar_fallbacks.inc(len(rest))
            got.update(zip(rest, zip(verdicts, via_grace)))
        for i in pending:
            ok, grace = got[i]
            out[i] = ok
            # grace-key acceptances are deliberately NOT memoized:
            # the memo must never outlive the grace window
            if ok and not grace and keys[i] is not None:
                self._memo_add(keys[i])

    def _verify_on_device(self, items, idxs: List[int], aliased, pks,
                          seq: Optional[int], view_scoped: bool
                          ) -> Optional[Tuple[List[bool], List[bool]]]:
        """The items at `idxs` through the batch backend: (verdicts,
        accepted-via-grace-key), or None when the device failed or the
        breaker is open (counted in degraded_verifies; the caller
        verifies them on the host)."""
        if not device_breaker().allow():
            # non-mutating preview: while the breaker is OPEN, skip
            # building the device batch entirely instead of paying
            # list construction + a BreakerOpen round-trip on every
            # degraded verify (attempt() below still guards the
            # admitted path — a lost race just raises as before)
            self.degraded_verifies.inc(len(idxs))
            return None
        try:
            result = self._verify_batch_cross(
                [items[i] for i in idxs], seq, view_scoped,
                aliased=[aliased[i] for i in idxs],
                pks=[pks[i] for i in idxs])
            self.batched_verifies.inc(len(idxs))
            return result
        except BreakerOpen:
            # breaker tripped: fast-fail BEFORE the device — the
            # scalar engines carry the load until the half-open
            # probe re-admits the device
            self.degraded_verifies.inc(len(idxs))
        except NoDevice:
            # no card is a set-up fault, not a loss
            raise
        except RuntimeError:
            # a device failure (a failed launch) must degrade
            # verification, never fail it: the breaker recorded the
            # failure (trip after N consecutive). A BuildError, a
            # wrapper's ValueError and any other error raise.
            log.warning("device verify batch failed (%d items); "
                        "rerouting to scalar engines",
                        len(idxs), exc_info=True)
            self.degraded_verifies.inc(len(idxs))
        return None

    def _fold_ecdsa_stats(self, sink) -> None:
        """Fold this manager's attributed scalar-engine events into its
        metrics component + batch-shape histogram (covers BOTH host
        routes — the grouped fallback and verify_batch_mixed's
        below-crossover ride). The drain is atomic per sink
        (StatsSink.drain swaps under the sink lock), so concurrent
        drains never lose or double-count."""
        stats = sink.drain()
        if stats["host_items"]:
            self.ecdsa_batched_host.inc(stats["host_items"])
        if stats["host_ns"]:
            self.ecdsa_host_us.inc(stats["host_ns"] // 1000)
        if stats["hits"]:
            self.pubkey_memo_hits.inc(stats["hits"])
        if stats["evictions"]:
            self.ecdsa_pk_evictions.inc(stats["evictions"])
        if stats["comb_evictions"]:
            self.ecdsa_comb_evictions.inc(stats["comb_evictions"])
        for size in stats["host_sizes"]:
            self._h_ecdsa_host_batch.record(size)

    def _verify_batch_grouped(self, items: Sequence[Tuple[int, bytes, bytes]],
                              seq: Optional[int], view_scoped: bool
                              ) -> Tuple[List[bool], List[bool]]:
        """Per-principal fallback: group items, let each verifier
        vectorize its group. Returns (verdicts, accepted-via-grace-key)."""
        by_principal: Dict[int, List[int]] = {}
        for i, (p, _, _) in enumerate(items):
            by_principal.setdefault(p, []).append(i)
        out = [False] * len(items)
        via_grace = [False] * len(items)
        for p, idxs in by_principal.items():
            try:
                verifier = self._verifier(p)
            except KeyError:
                continue
            results = verifier.verify_batch(
                [(items[i][1], items[i][2]) for i in idxs])
            grace = self._grace_verifier(p, seq, view_scoped)
            for i, ok in zip(idxs, results):
                if not ok and grace is not None \
                        and grace.verify(items[i][1], items[i][2]):
                    ok = via_grace[i] = True
                out[i] = ok
        return out, via_grace

    def _verify_batch_cross(self, items: Sequence[Tuple[int, bytes, bytes]],
                            seq: Optional[int], view_scoped: bool,
                            aliased: List[int],
                            pks: List[Optional[bytes]]
                            ) -> Tuple[List[bool], List[bool]]:
        """Run the whole batch through the backend in one call (one
        device dispatch per scheme present); failed items retry against
        grace keys. `aliased`/`pks` carry the caller's already-resolved
        principals (resolved under the lock — a worker must not race a
        key rotation into treating the rotated-away key as current).
        Returns (verdicts, accepted-via-grace-key)."""
        entries = []
        keyed = []
        for i, ((p, data, sig), a, pk) in enumerate(zip(items, aliased,
                                                        pks)):
            if pk is not None:
                entries.append((self._scheme_of(a), pk, data, sig))
                keyed.append(i)
        # the device ride runs under the circuit breaker: exceptions and
        # latency-SLO breaches count against the failure budget, an OPEN
        # breaker raises BreakerOpen before building any device work
        # (nested ops-level sections are pass-through — one failure is
        # one failure), and a short/garbage verdict vector classifies as
        # a device failure instead of silently truncating into drops
        with device_breaker().attempt("sig_verify"):
            verdicts = self._batch_fn(entries)
            if len(verdicts) != len(entries):
                raise RuntimeError(
                    f"batch backend returned {len(verdicts)} verdicts "
                    f"for {len(entries)} items")
        # counts only what actually reached the device dispatch
        self.sigs_device_dispatched.inc(len(entries))
        out = [False] * len(items)
        via_grace = [False] * len(items)
        for i, ok in zip(keyed, verdicts):
            if not ok:
                grace = self._grace_verifier(items[i][0], seq, view_scoped)
                if grace is not None and grace.verify(items[i][1],
                                                      items[i][2]):
                    ok = via_grace[i] = True
            out[i] = ok
        return out, via_grace


class PendingVerdict:
    """Future-like handle for one async verification."""
    __slots__ = ("_evt", "_ok")

    def __init__(self) -> None:
        self._evt = threading.Event()
        self._ok: Optional[bool] = None

    def set(self, ok: bool) -> None:
        if self._evt.is_set():
            return                    # first write wins: a late failure
                                      # path must not flip a delivered
                                      # verdict under a woken waiter
        self._ok = ok
        self._evt.set()

    def done(self) -> bool:
        return self._evt.is_set()

    def result(self, timeout: Optional[float] = None) -> bool:
        if not self._evt.wait(timeout):
            raise TimeoutError("verification not complete")
        return bool(self._ok)


class BatchVerifier:
    """Batching dispatcher: accumulates verify requests into fixed-size
    batches with a timeout flush, drains each batch in one
    `SigManager.verify_batch` call on a worker thread.

    This is the device seam: batch dispatch amortizes the host→card round
    trip; batch size/flush window come from
    ReplicaConfig.verify_batch_size / verify_batch_flush_us.
    """

    def __init__(self, sig_manager: SigManager, batch_size: int = 256,
                 flush_us: int = 200):
        from tpubft_torch.utils.batcher import FlushBatcher
        self._sm = sig_manager
        self._batcher = FlushBatcher(
            self._drain, batch_size=batch_size, flush_us=flush_us,
            on_drop=lambda item: item[3](False),  # waiters must not hang
            name="batch-verifier")

    def submit(self, principal: int, data: bytes, sig: bytes) -> PendingVerdict:
        verdict = PendingVerdict()
        self._batcher.submit((principal, data, sig, verdict.set))
        return verdict

    def submit_nowait(self, principal: int, data: bytes, sig: bytes,
                      resolve) -> None:
        """Callback-style submission: `resolve(ok)` fires on the worker
        thread once the batch containing this item drains (False if the
        batch is dropped or the batcher is stopped). This is the
        non-blocking entry the replica's admission path uses — the
        dispatcher thread never waits on a verdict."""
        self._batcher.submit((principal, data, sig, resolve))

    def reconfigure(self, batch_size: int = None,
                    flush_us: int = None) -> None:
        """Autotuner actuator: retune the verify batch cap / flush
        window live (ReplicaConfig seeds the defaults; the knob
        registry owns them after startup)."""
        self._batcher.reconfigure(batch_size=batch_size,
                                  flush_us=flush_us)

    def _drain(self, batch) -> None:
        verdicts = self._sm.verify_batch([(p, d, s) for p, d, s, _ in batch])
        for (_, _, _, resolve), ok in zip(batch, verdicts):
            try:
                resolve(ok)
            except Exception:  # noqa: BLE001 — one bad callback must not
                pass           # fail the whole batch (double-resolving it)

    def stop(self) -> None:
        self._batcher.stop()
