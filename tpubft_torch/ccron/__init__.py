"""ccron — deterministic, consensus-driven cron.

Rebuild of concord-bft ccron/ (ticks_generator.cpp, cron_table.cpp,
periodic_action.cpp): tick requests go through consensus (TickOp via the
internal BFT client), so every replica runs the same actions at the same
sequence point — unlike a wall-clock timer, which would diverge. The
primary's TicksGenerator is merely the pacemaker; determinism comes from
ordering. Last-fired tick per component persists in a reserved page so
ticks are exactly-once across crashes and state transfer.
"""
from tpubft_torch.ccron.cron_table import CronTable
from tpubft_torch.ccron.ticks_generator import TicksGenerator

__all__ = ["CronTable", "TicksGenerator"]
