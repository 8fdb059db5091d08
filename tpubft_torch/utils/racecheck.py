"""Lock construction for the port (counterpart of tpubft/utils/racecheck.py).

Only `make_lock` is ported: every lock of the port is built here so the
lock-order checker and the hold-time accounting of tpubft/utils/racecheck.py can be
dropped in later without touching call sites. Until then it returns a
plain `threading.Lock` / `threading.RLock`.
"""
from __future__ import annotations

import threading


def make_lock(name: str, reentrant: bool = False):
    """Project-wide lock constructor. `name` identifies the lock for the
    lock-order checker once it is ported."""
    del name
    return threading.RLock() if reentrant else threading.Lock()
