"""Leaf digests of a state-transfer window (port of
tpubft/statetransfer/manager.py::StateTransferManager._window_digests).

A completed window of raw blocks is digested in one batched device call
(ops/sha256.sha256_batch_mixed: block sizes vary, so the masked contract
runs) once it holds `threshold` blocks, and by hashlib below that. As in
the reference, a device call that raises a RuntimeError (a failed
launch, an OPEN breaker) degrades to hashlib with the same digests; here
each such fallback is counted in `DEGRADED` and logged. With
`degrade=False` (the state-transfer manager of a replica) that
RuntimeError raises instead. Anything else (no card at all,
`device.NoDevice`; a wrapper refusing its inputs; a failed build)
raises.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence

import torch

from tpubft_torch.device import NoDevice
from tpubft_torch.ops import sha256 as _sha
from tpubft_torch.utils.logging import get_logger

# the reference's st_device_digest_threshold default
DEVICE_DIGEST_THRESHOLD = 16

# windows whose device call raised and that hashlib answered instead
DEGRADED = 0

_log = get_logger("statetransfer")


def window_digests(raws: Sequence[bytes], use_device: bool = True,
                   threshold: int = DEVICE_DIGEST_THRESHOLD,
                   device: Optional[torch.device] = None,
                   degrade: bool = True) -> List[bytes]:
    """SHA-256 of every raw block of a window, in order."""
    global DEGRADED
    if use_device and len(raws) >= threshold:
        try:
            return _sha.sha256_batch_mixed(raws, device)
        except NoDevice:
            raise
        except RuntimeError as exc:   # device loss degrades, not fails
            if not degrade:
                raise
            DEGRADED += 1
            _log.warning("state-transfer window of %d blocks digested on "
                         "the host: %s", len(raws), exc)
    return [hashlib.sha256(r).digest() for r in raws]
