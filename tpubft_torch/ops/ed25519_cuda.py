"""Wrapper of the hand-written Hopper Ed25519 verify kernel
(csrc/ed25519_verify.cu), the port of
tpubft/ops/ed25519_pallas.py::verify_kernel.

The library is built by nvcc at first use (ops/_build.py) and bound with
ctypes. Each wrapper checks device, dtype, shape and contiguity, allocates
its output with torch.empty, launches on torch.cuda.current_stream() of
the caller's thread, raises if cudaGetLastError reports a failed launch,
and counts its launches in `LAUNCHES` (a plain integer per kernel,
incremented only where the kernel is launched). There is no fallback: a
build or launch failure raises, and the plain PyTorch version
(ops/ed25519.plain_verify_kernel) is reached only for CPU tensors, by
ops/ed25519.verify_kernel.

`fe_mul` and `fe_inv` launch test kernels built from the verify kernel's
own field functions; chip_smoke's `ladder` phase checks them against
Python-int arithmetic mod p.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List

import torch

from tpubft_torch.ops import _build
from tpubft_torch.ops import f25519 as F

NL = F.NL
WINDOWS = 64

LAUNCHES: Dict[str, int] = {"ed25519_verify": 0, "fe_mul": 0, "fe_inv": 0}

SOURCES = ("ed25519_verify.cu",)
HEADERS = ("ed25519_field.cuh",)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _fe10(x: int) -> List[int]:
    """Canonical limbs of x mod p in the kernel's 26/25-bit radix."""
    x %= F.P
    out = []
    for i in range(10):
        width = 25 if i & 1 else 26
        out.append(x & ((1 << width) - 1))
        x >>= width
    return out


def kernel_constants():
    """(consts (3, 10), btab (16, 3, 10)) int32 tensors on the CPU: D, 2D,
    sqrt(-1) and the base niels table, uploaded to constant memory."""
    from tpubft_torch.ops import ed25519 as ops
    consts = torch.tensor([_fe10(ops.D), _fe10(ops.K2D),
                           _fe10(ops.SQRT_M1)], dtype=torch.int32)
    btab = torch.tensor([[_fe10(v) for v in row]
                         for row in ops._base_niels_ints()],
                        dtype=torch.int32)
    return consts, btab


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (first use) and bind the kernel library."""
    lib = _build.load("ed25519_verify", SOURCES, HEADERS)
    lib.ed25519_upload_consts.argtypes = [_P, _P]
    lib.ed25519_upload_consts.restype = _I
    lib.ed25519_verify_launch.argtypes = [_P] * 7 + [_I, _P]
    lib.ed25519_verify_launch.restype = _I
    lib.ed25519_fe_mul_launch.argtypes = [_P, _P, _P, _I, _P]
    lib.ed25519_fe_mul_launch.restype = _I
    lib.ed25519_fe_inv_launch.argtypes = [_P, _P, _I, _P]
    lib.ed25519_fe_inv_launch.restype = _I
    lib.ed25519_error_string.argtypes = [_I]
    lib.ed25519_error_string.restype = ctypes.c_char_p
    return lib


_uploaded = set()


def _ready(device: torch.device) -> ctypes.CDLL:
    """The library, with its constant tables uploaded on `device`."""
    lib = library()
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _uploaded:
        consts, btab = kernel_constants()
        with torch.cuda.device(idx):
            _check(lib, lib.ed25519_upload_consts(consts.data_ptr(),
                                                  btab.data_ptr()),
                   "constant upload")
        _uploaded.add(idx)
    return lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"ed25519 CUDA {what} failed: "
                           f"{lib.ed25519_error_string(err).decode()}")


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


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def verify(s_win, h_win, a_y, a_sign, r_y, r_sign) -> torch.Tensor:
    """The verify kernel: s_win, h_win (64, B) int32; a_y, r_y (24, B)
    int32 tight canonical limbs; a_sign, r_sign (B,) int32 -> (B,) bool
    on the same device (not synchronised)."""
    if s_win.device.type != "cuda":
        raise ValueError("ed25519_cuda.verify takes CUDA tensors; "
                         f"got {s_win.device}")
    b = s_win.shape[1] if s_win.dim() == 2 else -1
    dev = s_win.device
    for t, name, shape in ((s_win, "s_win", (WINDOWS, b)),
                           (h_win, "h_win", (WINDOWS, b)),
                           (a_y, "a_y", (NL, b)), (a_sign, "a_sign", (b,)),
                           (r_y, "r_y", (NL, b)), (r_sign, "r_sign", (b,))):
        _require(t, name, shape, dev)
    lib = _ready(dev)
    out = torch.empty(b, dtype=torch.bool, device=dev)
    err = lib.ed25519_verify_launch(
        s_win.data_ptr(), h_win.data_ptr(), a_y.data_ptr(),
        a_sign.data_ptr(), r_y.data_ptr(), r_sign.data_ptr(),
        out.data_ptr(), b, _stream(dev))
    _check(lib, err, "verify launch")
    LAUNCHES["ed25519_verify"] += 1
    return out


def fe_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(24, n) tight canonical limbs x2 -> canonical limbs of a*b mod p."""
    n = a.shape[1] if a.dim() == 2 else -1
    _require(a, "a", (NL, n), a.device)
    _require(b, "b", (NL, n), a.device)
    lib = _ready(a.device)
    out = torch.empty_like(a)
    _check(lib, lib.ed25519_fe_mul_launch(a.data_ptr(), b.data_ptr(),
                                          out.data_ptr(), n,
                                          _stream(a.device)),
           "fe_mul launch")
    LAUNCHES["fe_mul"] += 1
    return out


def fe_inv(a: torch.Tensor) -> torch.Tensor:
    """(24, n) tight canonical limbs -> canonical limbs of a^(p-2)."""
    n = a.shape[1] if a.dim() == 2 else -1
    _require(a, "a", (NL, n), a.device)
    lib = _ready(a.device)
    out = torch.empty_like(a)
    _check(lib, lib.ed25519_fe_inv_launch(a.data_ptr(), out.data_ptr(), n,
                                          _stream(a.device)),
           "fe_inv launch")
    LAUNCHES["fe_inv"] += 1
    return out


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---- what one verify costs, from the representation (csrc header) ----

def _chain_counts(tail_sqr: int) -> tuple:
    """(squares, multiplies) of the shared 2^250-1 chain plus its tail."""
    sqr = 1 + 2 + 1 + 5 + 10 + 20 + 10 + 50 + 100 + 50 + tail_sqr
    return sqr, 10 + 1


def field_ops_per_verify() -> Dict[str, int]:
    """Field multiplies and squares one lane of the verify kernel runs
    (fixed: the kernel has no data-dependent control flow beyond the one
    conditional sqrt(-1) multiply, counted as taken)."""
    p58_s, p58_m = _chain_counts(2)
    inv_s, inv_m = _chain_counts(5)
    # decompress: y^2, v^2, v3^2, x^2 squares; y2*d, v^2*v, v3^2*v, u*v7,
    # u*v3, *w, v*x^2, *sqrt(-1), x*y multiplies
    dec_s, dec_m = 4 + p58_s, 9 + p58_m
    table_m = 14 * 9                           # 14 extended adds
    ladder_s = WINDOWS * 4 * 4                 # 4 doublings x 4 squares
    ladder_m = WINDOWS * (4 * 4 + 7 + 9)       # + mixed add + extended add
    comp_s, comp_m = inv_s, inv_m + 2
    return {"sqr": dec_s + ladder_s + comp_s,
            "mul": dec_m + table_m + ladder_m + comp_m}


def imad_per_verify() -> Dict[str, int]:
    """IMAD.WIDE (32x32->64) and IMAD (32-bit, the 19x precomputes) per
    verify: a multiply is 100 + 9, a square 55 + 9."""
    ops = field_ops_per_verify()
    return {"imad_wide": 100 * ops["mul"] + 55 * ops["sqr"],
            "imad": 9 * (ops["mul"] + ops["sqr"])}
