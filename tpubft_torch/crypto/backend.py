"""Crypto backend resolution: cuda | cpu | auto (port of
tpubft/crypto/backend.py).

The reference selects its crypto engine statically (RELIC/Crypto++ at
build time); here the analogous choice is which side of the plugin
boundary executes — the host verifiers or the batched device kernels.

Port divergence: the reference resolves "auto" by probing for an
accelerator in a subprocess and falls back to "cpu" without one. The
port has no probe and no CPU fallback: "auto" means "cuda", and a run
without a card fails at the device layer (`device.NoDevice`) unless the
caller asked for the CPU (`device.set_default_device("cpu")`) — a
missing card is a fault of the set-up, never a quieter, slower run.
"""
from __future__ import annotations

BACKENDS = ("cuda", "cpu")


def resolve_backend(requested: str) -> str:
    """Map a configured crypto_backend to a concrete one."""
    if requested == "auto":
        return "cuda"
    if requested not in BACKENDS:
        raise ValueError(f"crypto_backend must be cuda|cpu|auto, "
                         f"not {requested!r}")
    return requested
