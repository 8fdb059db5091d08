"""Wrapper of the hand-written Hopper SHA-256 kernel (csrc/sha256.cu), the
port of tpubft/ops/sha256.py::sha256_kernel and ::sha256_kernel_masked.

Built by nvcc at first use (ops/_build.py) and bound with ctypes. The
wrapper checks device, dtype, shape, contiguity and alignment, allocates
its output with torch.empty, launches on the caller's current stream,
raises if cudaGetLastError reports a failed launch, and counts its
launches in `LAUNCHES["sha256"]` (incremented only where the kernel is
launched). There is no fallback: CPU tensors are refused here and take
the plain version through ops/sha256.sha256_kernel.
"""
from __future__ import annotations

import ctypes
import functools
import os
import re
import subprocess
from collections import Counter
from typing import Dict

import torch

from tpubft_torch.ops import _build

LAUNCHES: Dict[str, int] = {"sha256": 0}

SOURCES = ("sha256.cu",)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    lib = _build.load("sha256", SOURCES)
    lib.sha256_launch.argtypes = [_P, _P, _P, _I, _I, _P]
    lib.sha256_launch.restype = _I
    lib.sha256_error_string.argtypes = [_I]
    lib.sha256_error_string.restype = ctypes.c_char_p
    return lib


def _require(t: torch.Tensor, name: str, ndim: int, device) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device}); "
                         "CPU tensors take the plain version")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name} must be int32 (got {t.dtype})")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions "
                         f"(got shape {tuple(t.shape)})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def sha256(words: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """words (B, nb, 16) int32, nblocks (B,) int32 on one card ->
    (B, 8) int32 digest words on that card (not synchronised)."""
    dev = words.device
    _require(words, "words", 3, dev)
    _require(nblocks, "nblocks", 1, dev)
    b, nb = words.shape[0], words.shape[1]
    if words.shape[2] != 16:
        raise ValueError(f"words must have 16 words per block "
                         f"(got shape {tuple(words.shape)})")
    if nblocks.shape[0] != b:
        raise ValueError(f"nblocks has {nblocks.shape[0]} lanes, "
                         f"words {b}")
    if words.data_ptr() % 16:
        raise ValueError("words must be 16-byte aligned")
    lib = library()
    out = torch.empty((b, 8), dtype=torch.int32, device=dev)
    err = lib.sha256_launch(words.data_ptr(), nblocks.data_ptr(),
                            out.data_ptr(), b, nb,
                            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("sha256 CUDA launch failed: "
                           f"{lib.sha256_error_string(err).decode()}")
    LAUNCHES["sha256"] += 1
    return out


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---- what one compression costs, read from the built kernel's SASS ----

_SASS_INSN = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\S*)\s*"
    r"([^;]*);")
# not 32-bit integer work: memory, control flow, the uniform datapath
_NOT_INT32 = ("LD", "ST", "BRA", "BSYNC", "BSSY", "EXIT", "NOP", "U")


def loop_body(sass: str) -> Counter:
    """Opcode counts of the longest loop in `sass` (cuobjdump -sass of one
    kernel): the instructions from a backward branch's target up to the
    branch. In sha256_kernel that is the per-block loop, one compression
    with its four 16-byte loads."""
    insns = [(int(m.group(1), 16), m.group(2), m.group(4))
             for m in _SASS_INSN.finditer(sass)]
    best = (0, 0)
    for addr, op, args in insns:
        if op != "BRA":
            continue
        target = re.match(r"\s*`?\(?(0x[0-9a-f]+)", args)
        if target and int(target.group(1), 16) < addr:
            start = int(target.group(1), 16)
            if addr - start > best[1] - best[0]:
                best = (start, addr)
    if best == (0, 0):
        raise ValueError("no backward branch in the SASS")
    return Counter(op for addr, op, _ in insns
                   if best[0] <= addr <= best[1])


def int32_ops(counts: Counter) -> int:
    """The 32-bit integer instructions among `counts` (SHF, LOP3, IADD3,
    IMAD, ...), leaving out loads, stores, branches and uniform-datapath
    instructions."""
    return sum(n for op, n in counts.items()
               if not op.startswith(_NOT_INT32))


def sass_loop_body() -> Counter:
    """loop_body of the built library, disassembled with the toolkit's
    cuobjdump (beside nvcc). Raises if either is missing."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", library()._name],
                          capture_output=True, text=True, check=True)
    return loop_body(proc.stdout)
