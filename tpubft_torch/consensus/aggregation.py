"""Share-aggregation overlay: the deterministic tree shares climb.

Rebuilds the aggregation-gossip topology from "Scalable BFT Consensus
Through Aggregated Signature Gossip" (arXiv 1911.04698) on top of this
codebase's collector-centric share flow: the root of the overlay is the
slot's collector (the view's primary — replicas_info.collector_for), so
the finished aggregate lands exactly where the ShareCollector verdict
path already lives; leaves send their Prepare/Commit shares only to
their overlay parent; interior nodes forward 56-byte partial aggregates
(crypto/systems.pack_agg_cert). Per-replica share traffic drops from the
collector's O(n) fan-in to O(fanout) at every node.

Determinism contract: every replica derives the SAME overlay from
(n, fanout, root, view[, gossip salt]) with no wire negotiation — the
permutation is seeded by a hash of those values. The permutation is
rotated per view ("tree" mode) so a slow interior node is never
permanent, and additionally every `agg_rotate_seqs` sequence numbers in
"gossip" mode. `agg_fanout` is therefore a PINNED wire-visible knob
(tuning/wiring.py): per-replica drift would fragment the overlay.
"""
from __future__ import annotations

import hashlib
from functools import lru_cache
from typing import List, Optional, Tuple


class Overlay:
    """One materialized aggregation tree: a heap layout over a seeded
    permutation of the replica ids, root pinned to the collector."""

    def __init__(self, order: Tuple[int, ...], fanout: int):
        self.order = order                  # position -> replica id
        self.fanout = fanout
        self._pos = {r: i for i, r in enumerate(order)}

    @property
    def root(self) -> int:
        return self.order[0]

    def parent_of(self, r: int) -> Optional[int]:
        """Overlay parent of replica r (None for the root)."""
        i = self._pos[r]
        if i == 0:
            return None
        return self.order[(i - 1) // self.fanout]

    def children_of(self, r: int) -> List[int]:
        i = self._pos[r]
        lo = i * self.fanout + 1
        return list(self.order[lo:lo + self.fanout])

    def is_interior(self, r: int) -> bool:
        """Has at least one child (the root counts)."""
        return self._pos[r] * self.fanout + 1 < len(self.order)

    def subtree_ids(self, r: int) -> List[int]:
        """Every replica in r's subtree, r included — the contributor
        set an interior node waits for before flushing early."""
        out, stack = [], [r]
        while stack:
            x = stack.pop()
            out.append(x)
            stack.extend(self.children_of(x))
        return out

    def depth(self) -> int:
        d, i = 0, len(self.order) - 1
        while i > 0:
            i = (i - 1) // self.fanout
            d += 1
        return d


@lru_cache(maxsize=128)
def _build(n: int, fanout: int, root: int, view: int, salt: int) -> Overlay:
    seed = hashlib.sha256(
        b"tpubft-agg-overlay|%d|%d|%d|%d|%d"
        % (n, fanout, root, view, salt)).digest()
    others = sorted(
        (r for r in range(n) if r != root),
        key=lambda r: hashlib.sha256(seed + r.to_bytes(4, "big")).digest())
    return Overlay((root,) + tuple(others), fanout)


def overlay_for(mode: str, n: int, fanout: int, root: int,
                view: int, seq_num: int, rotate_seqs: int) -> Overlay:
    """The overlay governing one (view, seq) slot. "tree": one shape per
    view. "gossip": additionally re-seeded every `rotate_seqs` seqnums,
    so a slow interior node can only delay a bounded run of slots."""
    salt = (seq_num // max(rotate_seqs, 1)) if mode == "gossip" else 0
    return _build(n, min(fanout, n), root, view, salt)
