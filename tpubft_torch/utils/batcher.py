"""FlushBatcher — the one batching dispatcher both verification seams use.

Accumulates submitted items and hands the worker thread a whole batch:
flush happens when the batch fills OR the flush window after the first
item elapses (latency-bounded). The wake discipline matters: the worker
is notified on the empty→non-empty transition and on a full batch ONLY —
waking it on every submit would cut the flush window short and collapse
batches to ~2 items under steady arrival (the device/pairing batch then
never amortizes).

Consumers: SigManager.BatchVerifier (cross-message device signature
batches) and collectors.CertBatchVerifier (aggregated combined-cert
pairing checks).
"""
from __future__ import annotations

import threading
from typing import Callable, Generic, List, TypeVar

T = TypeVar("T")


class FlushBatcher(Generic[T]):
    def __init__(self, drain: Callable[[List[T]], None],
                 batch_size: int = 64, flush_us: int = 500,
                 on_drop: Callable[[T], None] = None,
                 name: str = "flush-batcher"):
        self._drain = drain
        self._batch_size = batch_size
        self._flush_s = flush_us / 1e6
        self._on_drop = on_drop
        self._pending: List[T] = []
        self._wake = threading.Condition(threading.Lock())
        self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._thread.start()

    def reconfigure(self, batch_size: int = None,
                    flush_us: int = None) -> None:
        """Live retuning seam (the autotuner's actuator): batch size
        and flush window take effect from the next drain cycle. The
        worker is woken so a SHORTER window applies to the batch
        already accumulating, not after one stale full wait."""
        with self._wake:
            if batch_size is not None:
                self._batch_size = max(1, int(batch_size))
            if flush_us is not None:
                self._flush_s = max(0, int(flush_us)) / 1e6
            self._wake.notify()

    @property
    def batch_size(self) -> int:
        return self._batch_size

    @property
    def flush_us(self) -> int:
        return int(self._flush_s * 1e6)

    def submit(self, item: T) -> None:
        with self._wake:
            if self._running:
                self._pending.append(item)
                if len(self._pending) == 1 \
                        or len(self._pending) >= self._batch_size:
                    self._wake.notify()
                return
        # stopped batcher never drains: resolve the item now (outside
        # the lock — on_drop may re-enter) so no waiter hangs on a
        # PendingVerdict that never settles
        self._drop_one(item)

    def _drop_one(self, item: T) -> None:
        if self._on_drop is None:
            return
        try:
            self._on_drop(item)
        except Exception:  # noqa: BLE001 — one bad callback must not
            pass           # strand the remaining waiters

    def _run(self) -> None:
        import time as _time
        while self._running:
            with self._wake:
                if not self._pending:
                    self._wake.wait(timeout=0.05)
                    continue
                # flush window: wait for the batch to fill; submits
                # during this wait do not re-notify (len > 1). The wait
                # re-checks its deadline on every wakeup, reading the
                # (possibly reconfigured) window and cap fresh — a
                # reconfigure() notify retunes the in-progress wait
                # instead of being mistaken for window expiry, and a
                # SHRUNK window cuts the remaining wait short
                start = _time.monotonic()
                while (self._running and self._pending
                       and len(self._pending) < self._batch_size):
                    remaining = self._flush_s - (_time.monotonic()
                                                 - start)
                    if remaining <= 0:
                        break
                    self._wake.wait(timeout=remaining)
                batch, self._pending = self._pending, []
            try:
                self._drain(batch)
            except Exception:  # noqa: BLE001 — a bad batch must not kill
                from tpubft_torch.utils.logging import get_logger
                get_logger("batcher").exception("drain raised (%s)",
                                                self._thread.name)
                # waiters on the failed batch must still resolve
                for item in batch:
                    self._drop_one(item)

    def stop(self) -> None:
        with self._wake:
            self._running = False
            self._wake.notify()
        self._thread.join(timeout=2)
        # swap the residue under the lock: a wedged worker (join timed
        # out) or a racing submit must not observe a half-drained list
        # or double-resolve items the worker is still posting verdicts on
        with self._wake:
            residue, self._pending = self._pending, []
        for item in residue:
            self._drop_one(item)
