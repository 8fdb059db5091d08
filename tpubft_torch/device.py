"""Where the port's tensors live.

Every entry point runs on the card unless its caller asks for the CPU,
either per call (`device=`) or process-wide with
`set_default_device("cpu")`, as the tests do. Nothing falls back to the
CPU by itself: without a card and without that request, `default_device`
(and `resolve` for a CUDA device) raises `NoDevice`. The callers that
answer a lost device from the host re-raise it: a card that is not there
is a fault of the set-up, not device loss.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device]

_requested: Optional[torch.device] = None


class NoDevice(RuntimeError):
    """No card, and the caller did not ask for the CPU. A RuntimeError, so
    callers that expect one still hold; every degrade handler of the port
    re-raises it before its `except RuntimeError`."""


def set_default_device(device: Optional[DeviceLike]) -> None:
    """Process-wide default for entry points called without `device=`
    (None restores the card)."""
    global _requested
    _requested = None if device is None else torch.device(device)


def default_device() -> torch.device:
    if _requested is not None:
        return _requested
    _require_card()
    return torch.device("cuda", torch.cuda.current_device())


def _require_card() -> None:
    if not torch.cuda.is_available():
        raise NoDevice(
            "tpubft_torch: no CUDA device is available; pass device='cpu' "
            "or call tpubft_torch.device.set_default_device('cpu') to run "
            "the plain CPU versions")


def resolve(device: Optional[DeviceLike] = None) -> torch.device:
    """An explicit device wins; otherwise the default above. A CUDA
    device without a card raises NoDevice."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda":
        _require_card()
    return dev
