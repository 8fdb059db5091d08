"""Crashpoints — named kill-here hooks threaded through durability seams.

The recovery story of a BFT replica lives in the gaps between durable
writes: a crash *between* the ledger commit and the watermark persist,
or *between* persisting view-change state and broadcasting it, is where
exactly-once replay and view-change resumption are actually decided.
Apollo tortures those gaps with random process kills; random kills land
in the interesting window perhaps once in hundreds of runs. A
crashpoint makes the window a named, addressable place: the process
harness sets ``TPUBFT_CRASHPOINT=<name>`` (optionally ``<name>:<hit>``
to crash on the N-th arrival) and the replica process dies with
``CRASH_EXIT_CODE`` at *exactly* that seam; the recovery drill then
restarts it and asserts the invariants the seam is supposed to protect.

In-process clusters cannot ``os._exit`` (the test would die too), so the
same seams support *arming*: ``arm(name, rid=2)`` registers a callback
fired when replica 2 reaches the seam. The default callback parks the
calling thread forever — from the rest of the process's point of view
that replica stopped executing mid-seam, which is exactly what SIGKILL
looks like from the outside: no finally blocks, no flushes, no clean
shutdown. The drill then recovers from the on-disk state and asserts.

Every seam calls ``crashpoint("<name>", rid=...)``. The registry below
is the single source of truth; ``tools/check_crashpoints.py`` (tier-1)
verifies that every name used at a seam or referenced by a test exists
here, and that every registered name is actually threaded somewhere.
"""
from __future__ import annotations

import os
import threading
from typing import Callable, Dict, Optional, Tuple

# Exit code for an env-triggered crash: distinct from SIGKILL (-9),
# SIGTERM (-15) and python tracebacks (1), so a harness can assert "the
# replica died AT THE SEAM" rather than "the replica died".
CRASH_EXIT_CODE = 173

ENV_VAR = "TPUBFT_CRASHPOINT"

# name -> what crashing here must NOT be able to break (the invariant
# the recovery drill asserts)
REGISTRY: Dict[str, str] = {
    "exec.pre_apply": (
        "execution lane, after request execution, BEFORE the run's "
        "durable apply (ledger commit + reply pages): nothing of the run "
        "is durable — recovery replays the committed suffix from "
        "consensus metadata and re-executes it exactly once"),
    "exec.post_apply": (
        "execution lane, AFTER the run's durable apply but before any "
        "bookkeeping (reply cache, watermark, checkpoint vote): blocks "
        "and at-most-once markers are durable — recovery's replay must "
        "deduplicate against them (no double execution, no duplicate "
        "blocks, no ledger divergence)"),
    "exec.spec_seal": (
        "execution lane, speculative run fully commit-confirmed, BEFORE "
        "its durable apply (the seal's end_accumulation): nothing of "
        "the speculated run is durable — the staged overlay dies with "
        "the process, recovery replays the committed suffix from "
        "consensus metadata and re-executes it exactly once; a crash "
        "EARLIER (mid-speculation, commits not yet in) must leave no "
        "trace at all"),
    "vc.persist": (
        "view change, after persisting in_view_change/pending_view/"
        "evidence but BEFORE broadcasting the ViewChangeMsg: the restart "
        "must resume the view change from storage and retransmit an "
        "equivalent ViewChangeMsg, or a quorum counting on this replica "
        "wedges forever"),
    "vc.enter": (
        "view entry, after persisting the new view + restrictions but "
        "BEFORE the new primary re-proposes: the restart must re-issue "
        "the restricted PrePrepares (Replica.start's repropose path)"),
    "ckpt.stable": (
        "checkpoint stability, BEFORE persisting the window slide: the "
        "restart re-derives stability from peers' checkpoint messages; "
        "nothing already GC'd may be needed again"),
    "st.window_adopt": (
        "state transfer, after a fetched window's digests verified but "
        "BEFORE its blocks are committed to the ledger: recovery "
        "restarts the fetch — a half-adopted window must never leave "
        "blocks the digest chain does not cover"),
    "meta.watermark": (
        "dispatcher, AFTER persisting the last_executed watermark for an "
        "applied run but before replies/checkpoint votes go out: clients "
        "retry into the reply cache; peers' checkpoint quorum proceeds "
        "without our vote"),
    "dur.group_fsync": (
        "durability io thread, after the group's concatenated apply but "
        "BEFORE its fsync and watermark publication: every run of the "
        "group is executed and maybe-on-disk (the OS owns the buffers) "
        "but no reply went out and last_executed never advanced — "
        "recovery replays the committed suffix from consensus metadata "
        "and the reserved-pages at-most-once state deduplicates "
        "whatever did land (exactly-once, no ledger divergence)"),
}

_mu = threading.Lock()
# (name, rid|None) -> [hits_remaining, action]
_armed: Dict[Tuple[str, Optional[int]], list] = {}
_env_spec: Optional[Tuple[str, int]] = None
_env_hits = 0


def _load_env_spec() -> Optional[Tuple[str, int]]:
    raw = os.environ.get(ENV_VAR, "").strip()
    if not raw:
        return None
    name, _, hit = raw.partition(":")
    try:
        return name, max(1, int(hit)) if hit else 1
    except ValueError:
        return name, 1


_park_event = threading.Event()


def park() -> None:
    """Default in-process 'crash': the calling thread stops here and
    runs no further instruction until release_parked() (daemon threads —
    the test process exits fine even if never released). Identical to
    SIGKILL as observed by the on-disk state: whatever was not yet
    durable at the seam never becomes durable."""
    _park_event.wait()


_park_forever = park


def release_parked() -> None:
    """Unstick threads parked by park() — called at drill teardown so a
    parked exec-lane/dispatcher thread can observe its stop flag instead
    of making the owner's stop() eat a full join timeout. Future parks
    use a fresh event."""
    global _park_event
    old, _park_event = _park_event, threading.Event()
    old.set()


def crashpoint(name: str, rid: Optional[int] = None) -> None:
    """Durability-seam hook. No-op unless this exact point was requested
    via env (process mode → os._exit) or arm() (in-process mode)."""
    global _env_spec, _env_hits
    if name not in REGISTRY:
        raise AssertionError(f"unregistered crashpoint {name!r} "
                             f"(add it to crashpoints.REGISTRY)")
    spec = _env_spec if _env_spec is not None else _load_env_spec()
    _env_spec = spec or ("", 0)
    if spec and spec[0] == name:
        with _mu:
            _env_hits += 1
            due = _env_hits == spec[1]
        if due:
            # a real crash: no atexit, no finally, no flush
            os._exit(CRASH_EXIT_CODE)
    if not _armed:
        return
    with _mu:
        ent = _armed.get((name, rid)) or _armed.get((name, None))
        if ent is None or ent[0] <= 0:
            return
        ent[0] -= 1
        action = ent[1]
    (action or _park_forever)()


def arm(name: str, rid: Optional[int] = None, hits: int = 1,
        action: Optional[Callable[[], None]] = None) -> None:
    """In-process mode: fire `action` (default: park the thread forever,
    the SIGKILL analog) the next `hits` times replica `rid` (None = any)
    reaches seam `name`."""
    if name not in REGISTRY:
        raise AssertionError(f"unregistered crashpoint {name!r}")
    with _mu:
        _armed[(name, rid)] = [hits, action]


def disarm_all() -> None:
    with _mu:
        _armed.clear()


def reset_env_cache() -> None:
    """Re-read TPUBFT_CRASHPOINT on next hit (tests mutate the env)."""
    global _env_spec, _env_hits
    with _mu:
        _env_spec = None
        _env_hits = 0
