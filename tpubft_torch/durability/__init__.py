"""Group-commit durability plane — fsync off the execution lane (port of
tpubft/durability/).

The execution lane seals each coalesced run (its ledger WriteBatch +
reply pages + completion record) into a `DurabilityPipeline` and moves
straight on to the next run; a dedicated io thread drains the queue,
applies the sealed batches as ONE concatenated group write, pays ONE
fsync per group, and publishes a monotone durability watermark.
Replies, `last_executed`, and the at-most-once reply cache all advance
off that watermark — never off a per-run fsync. See
docs/OPERATIONS.md "Durability pipeline" (written for the reference; the
port's pipeline is the same code).
"""
from tpubft_torch.durability.pipeline import (DurabilityPipeline, PendingStore,
                                        SealedRun)

__all__ = ["DurabilityPipeline", "PendingStore", "SealedRun"]
