"""Epoch numbering across reconfigurations.

Rebuild of the reference's EpochManager
(concord-bft bftengine/include/bftengine/EpochManager.hpp:21-82): a
monotone era counter that separates message traffic from before and
after a reconfiguration (addRemoveWithWedge / coordinated restart).
Without it, a replica restarted into a new configuration cannot tell
same-view-different-era messages apart.

Two numbers, as in the reference:
- the GLOBAL epoch lives in a reserved page, so it is part of every
  checkpoint certificate and rides state transfer to lagging/new
  replicas;
- the SELF epoch is what this process stamps on (and requires of)
  protocol messages. It is loaded from the global page at boot and only
  re-adopted at boot / state-transfer completion — live replicas keep
  ordering in their current era until the wedge+restart boundary.
"""
from __future__ import annotations

from tpubft_torch.consensus.reserved_pages import ReservedPagesClient


class EpochManager:
    CATEGORY = "epoch"

    def __init__(self, pages: ReservedPagesClient) -> None:
        self._pages = pages
        self.self_epoch = self.global_epoch()

    # page layout: epoch u64 | bump command seq u64 | effective seq u64
    # (the wedge stop point at which the new era begins)
    def _read(self):
        raw = self._pages.load(index=0)
        if not raw or len(raw) < 24:
            return 0, 0, 0
        return (int.from_bytes(raw[0:8], "little"),
                int.from_bytes(raw[8:16], "little"),
                int.from_bytes(raw[16:24], "little"))

    def global_epoch(self) -> int:
        return self._read()[0]

    def bump_global_at(self, cmd_seq: int, effective_seq: int) -> int:
        """Executed inside an ordered reconfiguration command — every
        replica writes the same value at the same seq, so the page digest
        stays part of the agreed state. Keyed on the command's seq to be
        IDEMPOTENT: crash-recovery replays re-execute committed commands,
        and a read-modify-write bump would double-count and diverge this
        replica's page digest from the cluster. The guard is MONOTONE
        (any cmd_seq at or below the stored one is a replay), not an
        equality check: two bump commands in one replayed window would
        otherwise double-bump — the older replay sees the newer stored
        seq, mismatches, and bumps again (ADVICE r5)."""
        epoch, seq, eff = self._read()
        if cmd_seq != 0 and cmd_seq <= seq:
            return epoch                # replay of an already-bumped cmd
        nxt = epoch + 1
        self._pages.save(index=0, data=(nxt.to_bytes(8, "little")
                                        + cmd_seq.to_bytes(8, "little")
                                        + effective_seq.to_bytes(8, "little")))
        return nxt

    def boot_adopt(self, last_executed: int) -> int:
        """Boot: adopt the persisted global era ONLY if this replica
        already executed past the era's effective point (the wedge stop).
        A replica that crashed and rebooted mid-era — after the bump
        command executed but before the wedge boundary — must keep
        speaking the old era with its peers, or it strands itself: their
        traffic fails its gate and its traffic fails theirs."""
        epoch, _seq, eff = self._read()
        if epoch > 0 and last_executed < eff:
            self.self_epoch = epoch - 1
        else:
            self.self_epoch = epoch
        return self.self_epoch

    def adopt_global(self) -> int:
        """Post-state-transfer: the fetched pages are part of a certified
        checkpoint at/past the era boundary — speak the persisted era."""
        self.self_epoch = self.global_epoch()
        return self.self_epoch
