"""Namespaced logging (port of tpubft/utils/logging.py).

Loggers live under the stdlib `tpubft_torch.*` namespace, quiet by
default (WARNING, like any library). The reference's mapped diagnostic
context (replica / view / seq tags on every line) waits for the replica
core, whose dispatcher sets it.
"""
from __future__ import annotations

import logging


def get_logger(name: str) -> logging.Logger:
    """Namespaced logger; `name` is the subsystem (e.g. "sigmgr")."""
    return logging.getLogger(f"tpubft_torch.{name}")
