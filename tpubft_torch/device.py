"""Where the port's tensors live.

Every entry point runs on the card unless its caller asks for the CPU,
either per call (`device=`) or process-wide with
`set_default_device("cpu")`, as the tests do. Nothing falls back to the
CPU by itself: without a card and without that request, `default_device`
raises.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device]

_requested: Optional[torch.device] = None


def set_default_device(device: Optional[DeviceLike]) -> None:
    """Process-wide default for entry points called without `device=`
    (None restores the card)."""
    global _requested
    _requested = None if device is None else torch.device(device)


def default_device() -> torch.device:
    if _requested is not None:
        return _requested
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tpubft_torch: no CUDA device is available; pass device='cpu' "
            "or call tpubft_torch.device.set_default_device('cpu') to run "
            "the plain CPU versions")
    return torch.device("cuda", torch.cuda.current_device())


def resolve(device: Optional[DeviceLike] = None) -> torch.device:
    """An explicit device wins; otherwise the default above."""
    return torch.device(device) if device is not None else default_device()
