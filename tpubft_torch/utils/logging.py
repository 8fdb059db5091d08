"""Structured logging with consensus MDC context.

Rebuild of the reference's logging layer (concord-bft logging/ —
log4cplus with MDC keys; the SCOPED_MDC_* macros in ReplicaImp.cpp:405,
1067 tag every log line with the replica/seqnum/commit-path it concerns,
so a line is join-able per consensus instance).

Design: stdlib `logging` under the `tpubft_torch.*` namespace plus a
thread-local mapped diagnostic context (MDC). Replica dispatcher threads
pin `replica=<id>` once (sticky); the message-dispatch entry point wraps
each handler call in an `mdc_scope(view=…, seq=…)` so everything logged
inside carries the consensus coordinates without the handlers having to
thread them through — one hook point, exactly the reference's scoped-MDC
pattern.

Quiet by default (WARNING, like any library); processes opt in with
`configure()` or the TPUBFT_LOG env var (e.g. TPUBFT_LOG=debug).
"""
from __future__ import annotations

import logging
import os
import sys
import threading
from typing import Optional

_tls = threading.local()
_MISSING = object()


def mdc() -> dict:
    """This thread's current diagnostic context."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        ctx = _tls.ctx = {}
    return ctx


def set_mdc(**kv) -> None:
    """Sticky context for this thread (e.g. replica=3 at thread start)."""
    mdc().update(kv)


class mdc_scope:
    """Scoped MDC keys (reference SCOPED_MDC_SEQ_NUM etc.): values are
    restored on exit, so nesting works."""

    def __init__(self, **kv):
        self._kv = kv
        self._saved = {}

    def __enter__(self):
        ctx = mdc()
        for k, v in self._kv.items():
            self._saved[k] = ctx.get(k, _MISSING)
            ctx[k] = v
        return self

    def __exit__(self, *exc):
        ctx = mdc()
        for k, old in self._saved.items():
            if old is _MISSING:
                ctx.pop(k, None)
            else:
                ctx[k] = old
        return False


class _MdcFilter(logging.Filter):
    """Injects the rendered MDC into every record as %(mdc)s."""

    def filter(self, record: logging.LogRecord) -> bool:
        ctx = mdc()
        record.mdc = (" ".join(f"{k}={v}" for k, v in ctx.items())
                      if ctx else "-")
        return True


_FORMAT = "%(asctime)s %(levelname).1s [%(mdc)s] %(name)s: %(message)s"
# NOTE: the MDC filter rides on the HANDLER (configure() attaches it) —
# a logger-level filter would not apply to records created on child
# loggers, so handler-level is the only placement that works
_root = logging.getLogger("tpubft_torch")
_configured = False


def get_logger(name: str) -> logging.Logger:
    """Namespaced logger; `name` is the subsystem (e.g. "replica")."""
    return logging.getLogger(f"tpubft_torch.{name}")


def configure(level: Optional[str] = None, stream=None,
              filename: Optional[str] = None) -> None:
    """Attach a handler with the MDC format to the tpubft namespace.
    Level resolution: explicit arg > TPUBFT_LOG env > WARNING."""
    global _configured
    level = level or os.environ.get("TPUBFT_LOG", "warning")
    lvl = getattr(logging, str(level).upper(), logging.WARNING)
    handler: logging.Handler
    if filename:
        handler = logging.FileHandler(filename)
    else:
        handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    handler.addFilter(_MdcFilter())
    # replace, don't stack: configure() may run twice (env-var autoconfig
    # at import + an app's explicit call) and must not duplicate lines
    for old in list(_root.handlers):
        _root.removeHandler(old)
    _root.addHandler(handler)
    _root.setLevel(lvl)
    _root.propagate = False
    _configured = True


# processes that never call configure() still get MDC-tagged lines out of
# TPUBFT_LOG=… without code changes (tests stay silent: default WARNING
# with no env var set emits nothing below warnings)
if os.environ.get("TPUBFT_LOG"):
    configure()
