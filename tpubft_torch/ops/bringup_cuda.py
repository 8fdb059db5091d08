"""Wrappers of the bring-up kernels (csrc/bringup.cu) and their plain
PyTorch versions: rungs 0, 1 and 4 of the ladder (tools/bringup.py), the
counterparts of the Pallas rung bodies of tools/pallas_bringup.py.

  bringup_copy(a)            out = a + BITS[0]          (rung 0, :95)
  fe_carry(a)                f25519.normalize, limb for limb  (rung 1, :99)
  fe_table_gather(a, col)    table a..a^4 in shared memory, entry a[0] & 3,
                             times `col`, canonical limbs  (rung 4, :114)

Built by nvcc at first use (ops/_build.py) and bound with ctypes. Each
wrapper checks device, dtype, shape and contiguity, allocates its output
with torch.empty, launches on the caller's current stream, raises if
cudaGetLastError reports a failed launch, and counts its launches in
`LAUNCHES`. There is no fallback: CPU tensors are refused; the ladder
routes them to the plain versions below.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from tpubft_torch.ops import _build
from tpubft_torch.ops import f25519 as F

NL = F.NL

LAUNCHES: Dict[str, int] = {"bringup_copy": 0, "fe_carry": 0,
                            "fe_table_gather": 0}

SOURCES = ("bringup.cu",)
HEADERS = ("ed25519_field.cuh",)

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


def _launch(kernel: str, err: int, lib) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} CUDA launch failed: "
                           f"{lib.bringup_error_string(err).decode()}")
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
                                    COPY_ADDEND, _stream(a.device)), lib)
    return out


def fe_carry(a: torch.Tensor) -> torch.Tensor:
    """(24, n) int32 loose limbs -> normalized limbs (f25519.normalize)."""
    n = _lanes(a)
    lib = library()
    out = torch.empty_like(a)
    _launch("fe_carry", lib.fe_carry_launch(a.data_ptr(), out.data_ptr(), n,
                                            _stream(a.device)), lib)
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
            lib)
    return out


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    from tpubft_torch.ops import ed25519_cuda as kc
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
        sqr, mul = kc._chain_counts(5)
        return n * (sqr * fe_sq_ops + mul * fe_mul_ops), 2 * limbs
    raise ValueError(f"unknown bring-up kernel {kernel!r}")
