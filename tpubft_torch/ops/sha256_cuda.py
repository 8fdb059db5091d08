"""Wrapper of the hand-written Hopper SHA-256 kernel (csrc/sha256.cu), the
port of tpubft/ops/sha256.py::sha256_kernel and ::sha256_kernel_masked
together with the host padding that fed them.

Contract: `sha256_raw(data, offsets)` takes the concatenated messages as a
CUDA uint8 tensor and an int64 (B+1,) tensor of their boundaries, and
returns (B, 32) uint8 big-endian digests. Built by nvcc at first use
(ops/_build.py) and bound with ctypes. The wrapper checks device, dtype,
shape, contiguity and alignment, allocates its output with torch.empty,
launches on the caller's current stream, raises if cudaGetLastError
reports a failed launch, and counts its launches in `LAUNCHES["sha256"]`
(incremented only where the kernel is launched). There is no fallback:
CPU tensors are refused here and take the plain version through
ops/sha256.sha256_kernel.

Also here: the work SHA-256 needs (`OPS_PER_COMPRESSION`, `work`), the
floor one serial chain sets (`chain_floor_ms`, at `ROUND_CYCLES`), and
the opcode counts of the built kernel's longest loop (`sass_loop_body`),
a diagnostic.
"""
from __future__ import annotations

import ctypes
import functools
import os
import re
import subprocess
from collections import Counter
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from tpubft_torch.ops import _build
from tpubft_torch.ops.sha256 import check_offsets

LAUNCHES: Dict[str, int] = {"sha256": 0}

SOURCES = ("sha256.cu",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

# One compression of FIPS 180-4 in 32-bit operations, each rotate, shift,
# xor, and, not, or and add counted as one:
#   a round: Sigma1(e) 3 rotates + 2 xors; Ch(e,f,g) = (e and f) xor
#     (not e and g) 4; T1 = h + Sigma1 + Ch + K[t] + W[t] 4 adds;
#     Sigma0(a) 5; Maj(a,b,c) = (a and b) xor (a and c) xor (b and c) 5;
#     T2 = Sigma0 + Maj 1; e = d + T1 1; a = T1 + T2 1: 26, times 64;
#   a schedule step W[t] = sigma1(W[t-2]) + W[t-7] + sigma0(W[t-15]) +
#     W[t-16]: each sigma 2 rotates + 1 shift + 2 xors, 3 adds: 13, times
#     48;
#   the 8 adds into the chaining state.
# 64 x 26 + 48 x 13 + 8 = 2,296, whatever a build compiles it to.
OPS_PER_ROUND = 26
OPS_PER_SCHEDULE_STEP = 13
OPS_PER_COMPRESSION = 64 * OPS_PER_ROUND + 48 * OPS_PER_SCHEDULE_STEP + 8

# Cycles one round of the chain warp's loop takes on a lone warp, read
# once from the SASS of csrc/sha256.cu as built for sm_90a by nvcc -O3
# (cuobjdump -sass): the stall counts in the control bits (bits 41-44 of
# each instruction's second encoding word) of the loop over a message's
# blocks, which holds one block's 64 rounds (965 instructions: 384 SHF,
# 259 LOP3, 147 IMAD, 128 IADD3, 16 LDS.128, 5 BAR), summed and divided by
# 64. The compiler's count leaves out waits it cannot see (barriers,
# shared-memory latency): clock64 probes of the chain lane read about 35
# cycles a round on an H100. Set again when the loop changes;
# chain_floor_ms uses it.
ROUND_CYCLES = 30.09


def _compressions(lengths) -> np.ndarray:
    """Compressions per message of these byte lengths (FIPS 180-4)."""
    return (np.asarray(lengths, dtype=np.int64) + 8) // 64 + 1


def work(lengths: Sequence[int]) -> tuple:
    """(operations, bytes) SHA-256 needs for messages of these lengths:
    the compressions at OPS_PER_COMPRESSION each; every message byte and
    offset read once, 32 bytes written a message."""
    lengths = np.asarray(lengths, dtype=np.int64)
    ops = int(_compressions(lengths).sum()) * OPS_PER_COMPRESSION
    nbytes = int(lengths.sum()) + 8 * (len(lengths) + 1) + 32 * len(lengths)
    return ops, nbytes


def chain_floor_ms(lengths: Sequence[int], sm_clock_mhz: float) -> float:
    """The least time the longest message's serial chain takes: its
    compressions x 64 rounds x ROUND_CYCLES at the SM clock."""
    longest = int(_compressions(lengths).max()) if len(lengths) else 0
    return longest * 64 * ROUND_CYCLES / (sm_clock_mhz * 1e3)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    lib = _build.load("sha256", SOURCES)
    lib.sha256_raw_launch.argtypes = [_P, _LL, _P, _P, _I, _P]
    lib.sha256_raw_launch.restype = _I
    lib.sha256_raw_roundtrip.argtypes = [_P, _P, _LL, _LL, _P, _P, _I, _P]
    lib.sha256_raw_roundtrip.restype = _I
    lib.sha256_error_string.argtypes = [_I]
    lib.sha256_error_string.restype = ctypes.c_char_p
    return lib


def _require(t: torch.Tensor, name: str, dtype, device) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device}); "
                         "CPU tensors take the plain version")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} (got {t.dtype})")
    if t.dim() != 1:
        raise ValueError(f"{name} must have 1 dimension "
                         f"(got shape {tuple(t.shape)})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def sha256_raw(data: torch.Tensor, offsets: torch.Tensor,
               host_offsets: Optional[np.ndarray] = None) -> torch.Tensor:
    """data uint8 (N,), offsets int64 (B+1,) on one card -> (B, 32) uint8
    digests on that card (not synchronised).

    The offsets are checked on the host: read back from the card (one
    synchronisation), or, when the caller passes `host_offsets`, the host
    array they were copied from, which is only checked to have B+1
    entries ending at N (the host half builds it by a cumulative sum, and
    a per-call scan would cost more than the launch). The kernel clamps
    every message to the buffer, so no offsets make it read outside it."""
    dev = data.device
    _require(data, "data", torch.uint8, dev)
    _require(offsets, "offsets", torch.int64, dev)
    n = data.numel()
    b = offsets.numel() - 1
    if b < 0:
        raise ValueError("offsets must have B+1 >= 1 entries")
    if host_offsets is None:
        check_offsets(offsets.cpu().numpy(), n)
    elif len(host_offsets) != b + 1 or int(host_offsets[-1]) != n:
        raise ValueError("host_offsets must have B+1 entries ending at "
                         f"len(data) = {n}")
    if data.data_ptr() % 4:
        raise ValueError("data must be 4-byte aligned")
    lib = library()
    out = torch.empty((b, 32), dtype=torch.uint8, device=dev)
    if out.data_ptr() % 16:
        raise ValueError("the digest buffer must be 16-byte aligned")
    err = lib.sha256_raw_launch(data.data_ptr(), n, offsets.data_ptr(),
                                out.data_ptr(), b,
                                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("sha256 CUDA launch failed: "
                           f"{lib.sha256_error_string(err).decode()}")
    LAUNCHES["sha256"] += 1
    return out


def sha256_roundtrip(host_in: torch.Tensor, head: int,
                     host_out: torch.Tensor, batch: int,
                     dev: torch.device) -> None:
    """The host half's device call in one C call: host_in (uint8: `head`
    bytes of int64 offsets, then the message bytes, built by
    ops/sha256.pack, so the offsets need no check) copied to the card,
    the kernel, the (batch, 32) digests copied into host_out, one
    synchronisation. Both host buffers should be pinned (the copies are
    then direct); the host half's are. Raises RuntimeError if a step
    fails."""
    for t, name in ((host_in, "host_in"), (host_out, "host_out")):
        if t.device.type != "cpu" or t.dtype != torch.uint8 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous uint8 host memory")
    n = host_in.numel()
    if not 8 <= head <= n or head % 8 or head // 8 != batch + 1 \
            or host_out.numel() < 32 * batch:
        raise ValueError("host_in must start with batch+1 int64 offsets and "
                         "host_out must hold 32 bytes a message")
    lib = library()
    dev_in = torch.empty(n, dtype=torch.uint8, device=dev)
    dev_out = torch.empty(32 * batch, dtype=torch.uint8, device=dev)
    err = lib.sha256_raw_roundtrip(host_in.data_ptr(), dev_in.data_ptr(), n,
                                   head, dev_out.data_ptr(),
                                   host_out.data_ptr(), batch,
                                   torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("sha256 CUDA round trip failed: "
                           f"{lib.sha256_error_string(err).decode()}")
    if batch:
        LAUNCHES["sha256"] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---- the built kernel's SASS, a diagnostic ----

_SASS_INSN = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\S*)\s*"
    r"([^;]*);")
# not 32-bit integer work: memory, control flow, the uniform datapath
_NOT_INT32 = ("LD", "ST", "BRA", "BSYNC", "BSSY", "EXIT", "NOP", "U")


def loop_body(sass: str) -> Counter:
    """Opcode counts of the longest loop in `sass` (cuobjdump -sass of one
    kernel): the instructions from a backward branch's target up to the
    branch."""
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


@functools.lru_cache(maxsize=1)
def sass() -> str:
    """cuobjdump -sass of the built library (the toolkit's, beside nvcc).
    Raises if either is missing."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", library()._name],
                          capture_output=True, text=True, check=True)
    return proc.stdout


def sass_loop_body() -> Counter:
    """loop_body of the built library."""
    return loop_body(sass())
