"""Build and load the port's CUDA sources.

Each library is compiled at first use by `nvcc` from the sources in the
package (csrc/), with a plain C interface, and loaded with ctypes. The
output goes to `ops/_build/` (listed in .gitignore) under a name keyed
by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads the existing library. A failed build raises; there
is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v") + ARCH_FLAGS

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# ptxas's resource report (registers, spills, local memory) per library
ptxas_report: Dict[str, str] = {}


def nvcc_path() -> str:
    """nvcc on PATH, else the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def _digest(sources: Sequence[str], headers: Sequence[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in list(sources) + list(headers):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def load(name: str, sources: Sequence[str],
         headers: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (if needed) and load lib<name>-<hash>.so from csrc/."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        so = os.path.join(BUILD_DIR,
                          f"lib{name}-{_digest(sources, headers)}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                   *(os.path.join(CSRC, s) for s in sources)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {name} ({proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
            ptxas_report[name] = proc.stderr.strip()
            os.replace(tmp, so)
        lib = _loaded[name] = ctypes.CDLL(so)
        return lib
