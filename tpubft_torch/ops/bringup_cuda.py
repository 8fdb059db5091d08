"""Wrappers of the bring-up kernels (csrc/bringup.cu, csrc/fe_inv.cu) and
their plain PyTorch versions: rungs 0, 1, 3 and 4 of the ladder
(tools/bringup.py), the counterparts of the Pallas rung bodies of
tools/pallas_bringup.py.

  bringup_copy(a)            out = a + BITS[0]          (rung 0, :95)
  fe_carry(a)                f25519.normalize, limb for limb  (rung 1, :99)
  fe_inv(a)                  a^(p-2), inv(0) = 0, canonical limbs
                             (rung 3, :109; its own library; the plain
                             version is tools/bringup._plain_inv)
  fe_table_gather(a, col)    table a..a^4 in shared memory, entry a[0] & 3,
                             times `col`, canonical limbs  (rung 4, :114)

Built by nvcc at first use (ops/_build.py) and bound with ctypes. Each
wrapper checks device, dtype, shape and contiguity, allocates its output
with torch.empty, launches on the caller's current stream, raises if
cudaGetLastError reports a failed launch, and counts its launches in
`LAUNCHES`; fe_inv also counts them by the design the launcher ran
(`FE_INV_LANES`: lanes an element, 4 or 1). There is no fallback: CPU
tensors are refused; the ladder routes them to the plain versions below.

Also here: the work each launch needs (`work`, for the bound), what the
inversion executes (`executed_ops`) and the floor its 265-step chain sets
at a measured number of cycles a step (`chain_floor_ms`;
tools/fe_inv_probe.py reads the cycles with clock64 stamps).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from tpubft_torch.ops import _build
from tpubft_torch.ops import ed25519_cuda as kc
from tpubft_torch.ops import f25519 as F

NL = F.NL

LAUNCHES: Dict[str, int] = {"bringup_copy": 0, "fe_carry": 0,
                            "fe_inv": 0, "fe_table_gather": 0}
# fe_inv's launches by the lanes an element of the kernel launched
FE_INV_LANES: Dict[int, int] = {4: 0, 1: 0}

SOURCES = ("bringup.cu",)
FE_INV_SOURCES = ("fe_inv.cu",)
HEADERS = ("ed25519_field.cuh",)

# the inversion chain: 254 squares and 11 multiplies, each dependent on the
# one before
CHAIN_SQR, CHAIN_MUL = kc._chain_counts(5)
CHAIN_STEPS = CHAIN_SQR + CHAIN_MUL

# what rung 0 adds: the first entry of the radix table (the TPU rung read
# it from its constants table at [0, 0])
COPY_ADDEND = int(F.BITS[0])

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    lib = _build.load("bringup", SOURCES, HEADERS)
    lib.bringup_copy_launch.argtypes = [_P, _P, _I, _I, _P]
    lib.fe_carry_launch.argtypes = [_P, _P, _I, _P]
    lib.fe_table_gather_launch.argtypes = [_P, _P, _P, _I, _P]
    for fn in (lib.bringup_copy_launch, lib.fe_carry_launch,
               lib.fe_table_gather_launch):
        fn.restype = _I
    lib.bringup_error_string.argtypes = [_I]
    lib.bringup_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=1)
def fe_inv_library() -> ctypes.CDLL:
    """Build (first use) and bind the inversion kernel's library."""
    lib = _build.load("fe_inv", FE_INV_SOURCES, HEADERS)
    lib.fe_inv_launch.argtypes = [_P, _P, _I, _I, _P,
                                  ctypes.POINTER(_I), _P]
    lib.fe_inv_launch.restype = _I
    lib.fe_inv_error_string.argtypes = [_I]
    lib.fe_inv_error_string.restype = ctypes.c_char_p
    return lib


def _require(t: torch.Tensor, name: str, shape, device) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device}); "
                         "CPU tensors take the plain version")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name} must be int32 (got {t.dtype})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)} "
                         f"(got {tuple(t.shape)})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _lanes(a: torch.Tensor) -> int:
    n = a.shape[1] if a.dim() == 2 else -1
    _require(a, "a", (NL, n), a.device)
    return n


def _launch(kernel: str, err: int, describe) -> None:
    """Raise on a failed launch (`describe`: the library's error string
    function), else count it."""
    if err != 0:
        raise RuntimeError(f"{kernel} CUDA launch failed: "
                           f"{describe(err).decode()}")
    LAUNCHES[kernel] += 1


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def bringup_copy(a: torch.Tensor) -> torch.Tensor:
    """(24, n) int32 -> a + COPY_ADDEND."""
    n = _lanes(a)
    lib = library()
    out = torch.empty_like(a)
    _launch("bringup_copy",
            lib.bringup_copy_launch(a.data_ptr(), out.data_ptr(), n,
                                    COPY_ADDEND, _stream(a.device)),
            lib.bringup_error_string)
    return out


def fe_carry(a: torch.Tensor) -> torch.Tensor:
    """(24, n) int32 loose limbs -> normalized limbs (f25519.normalize)."""
    n = _lanes(a)
    lib = library()
    out = torch.empty_like(a)
    _launch("fe_carry", lib.fe_carry_launch(a.data_ptr(), out.data_ptr(), n,
                                            _stream(a.device)),
            lib.bringup_error_string)
    return out


def lanes_for(n: int, sms: int) -> int:
    """Lanes an element for fe_inv on a card of `sms` SMs: four while the
    4n threads are at most one warp per SM partition (four a SM), where the
    chain's latency sets the time; one above, where the integer rate does
    and four lanes would execute about twice the instructions."""
    return 4 if n <= 32 * sms else 1


def fe_inv(a: torch.Tensor) -> torch.Tensor:
    """(24, n) tight canonical limbs -> canonical limbs of a^(p-2) mod p
    (inv(0) = 0), on the lanes an element lanes_for picks for this card."""
    n = _lanes(a)
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    return _fe_inv(a, lanes_for(n, sms))


def _fe_inv(a: torch.Tensor, lanes: int,
            stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fe_inv on `lanes` (1 or 4) lanes an element, for the card-only tests
    and tools/fe_inv_probe.py; `stamps`, an int64 (2,) tensor on the same
    card, receives clock64() at the chain's start and end in the first
    element's thread."""
    n = _lanes(a)
    if stamps is not None:
        if stamps.device != a.device or stamps.dtype != torch.int64 \
                or tuple(stamps.shape) != (2,):
            raise ValueError("stamps must be an int64 (2,) tensor on "
                             f"{a.device}")
    if lanes not in (1, 4):
        raise ValueError(f"lanes must be 1 or 4 (got {lanes})")
    lib = fe_inv_library()
    out = torch.empty_like(a)
    launched = ctypes.c_int(0)
    _launch("fe_inv",
            lib.fe_inv_launch(a.data_ptr(), out.data_ptr(), n, lanes,
                              None if stamps is None else stamps.data_ptr(),
                              ctypes.byref(launched), _stream(a.device)),
            lib.fe_inv_error_string)
    if launched.value:
        FE_INV_LANES[launched.value] += 1
    return out


def fe_table_gather(a: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """(24, n) tight canonical limbs, (24,) tight canonical limbs ->
    canonical limbs of a^(1 + (a[0] & 3)) * col mod p."""
    n = _lanes(a)
    _require(col, "col", (NL,), a.device)
    lib = library()
    out = torch.empty_like(a)
    _launch("fe_table_gather",
            lib.fe_table_gather_launch(a.data_ptr(), col.data_ptr(),
                                       out.data_ptr(), n, _stream(a.device)),
            lib.bringup_error_string)
    return out


def reset_launches() -> None:
    for counts in (LAUNCHES, FE_INV_LANES):
        for k in counts:
            counts[k] = 0


# ---- the plain PyTorch versions ----

def plain_copy(a: torch.Tensor) -> torch.Tensor:
    return a + COPY_ADDEND


def plain_carry(a: torch.Tensor) -> torch.Tensor:
    return F.normalize(a)


def plain_table_gather(a: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """The reference rung's table and masked-sum select over the port's
    field, then the product with `col`, canonical."""
    tab = [a]
    for _ in range(3):
        tab.append(F.mul(tab[-1], a))
    idx = a[0] & 3
    sel = sum(torch.where(idx == j, tab[j], torch.zeros_like(a))
              for j in range(4))
    return F.canonical(F.mul(sel, col.reshape(NL, 1).expand_as(a)))


# ---- the work of one launch, for the bound ----

def work(kernel: str, n: int) -> Tuple[int, int]:
    """(32-bit integer operations, bytes moved) of one launch on n lanes,
    each input read once and each output written once. Field multiplies
    count as ed25519_cuda does: a multiply is 100 IMAD.WIDE (two 32-bit
    multiply-adds each) + 9 IMAD, a square 55 + 9."""
    fe_mul_ops, fe_sq_ops = 2 * 100 + 9, 2 * 55 + 9
    limbs = NL * 4 * n
    if kernel == "bringup_copy":
        return NL * n, 2 * limbs
    if kernel == "fe_carry":
        # per pass and limb: shift, and, add; per pass the x19 fold
        return n * 2 * (3 * NL + 2), 2 * limbs
    if kernel == "fe_table_gather":
        return n * 4 * fe_mul_ops, 2 * limbs + NL * 4
    if kernel == "fe_mul":
        return n * fe_mul_ops, 3 * limbs
    if kernel == "fe_inv":
        return (n * (CHAIN_SQR * fe_sq_ops + CHAIN_MUL * fe_mul_ops),
                2 * limbs)
    raise ValueError(f"unknown bring-up kernel {kernel!r}")


def executed_ops(n: int, lanes: int) -> int:
    """32-bit multiply-add equivalents fe_inv executes on n elements (an
    IMAD.WIDE counted as two), for its work efficiency beside `work`. Four
    lanes: every step, square or multiply, is 30 products a lane plus the
    9 x19 weights of the rotated operand. One lane: a square 55 products
    plus its 15 x19 / x38 operands, a multiply 100 plus its 10 x19
    operands. The carry's few x19 pieces are left out."""
    if lanes == 4:
        return n * CHAIN_STEPS * 4 * (2 * 30 + 9)
    if lanes == 1:
        return n * (CHAIN_SQR * (2 * 55 + 15) + CHAIN_MUL * (2 * 100 + 10))
    raise ValueError(f"lanes must be 1 or 4 (got {lanes})")


def chain_floor_ms(n: int, sm_clock_mhz: float, step_cycles: float
                   ) -> float:
    """The least time the inversion's dependent chain takes on any element:
    CHAIN_STEPS x `step_cycles` (cycles a step, as measured) at the SM
    clock (0 for no element)."""
    return CHAIN_STEPS * step_cycles / (sm_clock_mhz * 1e3) if n > 0 else 0.0
