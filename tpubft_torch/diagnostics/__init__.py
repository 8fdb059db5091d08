"""Diagnostics — in-process status registry + performance histograms +
localhost admin server.

Rebuild of concord-bft diagnostics/ (diagnostics.h:25 Registrar,
performance_handler.h histogram recorders, diagnostics_server.h:14 the
localhost TCP admin server driven by the concord-ctl CLI). Components
register status handlers and histograms; operators query them live over
a line-based TCP protocol (tpubft/tools/ctl.py).
"""
from tpubft_torch.diagnostics.registrar import (PerfHistogram, Registrar,
                                          TimeRecorder, get_registrar)
from tpubft_torch.diagnostics.server import DiagnosticsServer

__all__ = ["Registrar", "PerfHistogram", "TimeRecorder", "get_registrar",
           "DiagnosticsServer"]
