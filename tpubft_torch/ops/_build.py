"""Build and load the port's CUDA sources.

Each library is compiled at first use by `nvcc` from the sources in the
package (csrc/), with a plain C interface, and loaded with ctypes. The
output goes to `ops/_build/` (listed in .gitignore) under a name keyed
by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads the existing library. A failed build raises
BuildError; there is no fallback.

`load_host` does the same for the port's host C++ engines (native/),
with g++ and the flags of the reference's native build (build.py:_FLAGS).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, List, Sequence

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v") + ARCH_FLAGS
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fno-plt")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# ptxas's resource report (registers, spills, local memory) per library
ptxas_report: Dict[str, str] = {}


def ptxas_functions(report: str) -> Dict[str, Dict[str, int]]:
    """A library's ptxas -v report -> {function: {"registers", "stack",
    "spill_stores", "spill_loads"}} (registers for the kernels only), the
    names demangled to name<template arguments> where they are templates
    of integers."""
    out: Dict[str, Dict[str, int]] = {}
    entry = props = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = _demangle(m.group(1))
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = _demangle(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props:
            out.setdefault(props, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.setdefault(entry, {})["registers"] = int(m.group(1))
    return out


def _demangle(name: str) -> str:
    m = re.match(r"_Z\d+([A-Za-z_]\w*?)I((?:Li\d+E)+)E", name)
    if m:
        args = re.findall(r"Li(\d+)E", m.group(2))
        return f"{m.group(1)}<{','.join(args)}>"
    m = re.match(r"_Z(\d+)", name)
    return name[m.end():m.end() + int(m.group(1))] if m else name


class BuildError(Exception):
    """A kernel library could not be built. Not a RuntimeError, so the
    callers that answer a lost device from the host (sparse_merkle,
    statetransfer/digests) let it through."""


def nvcc_path() -> str:
    """nvcc on PATH, else the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise BuildError("nvcc not found: the CUDA kernels are built from "
                     "source at first use and need the CUDA toolkit")


def _digest(sources: Sequence[str], headers: Sequence[str],
            flags: Sequence[str] = NVCC_FLAGS, root: str = CSRC) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in list(sources) + list(headers):
        with open(os.path.join(root, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _compile(name: str, so: str, cmd_head: Sequence[str],
             paths: Sequence[str]) -> str:
    """Run the compiler into a temporary file and rename it to `so`;
    -> the compiler's stderr."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [*cmd_head, "-o", tmp, *paths]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise BuildError(
            f"{cmd[0]} failed building {name} ({proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    return proc.stderr.strip()


def load(name: str, sources: Sequence[str],
         headers: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (if needed) and load lib<name>-<hash>.so from csrc/.

    nvcc runs outside the lock, so different libraries build in parallel
    threads; two threads building the same one each write their own
    temporary file and the atomic rename keeps either."""
    with _lock:
        lib = _loaded.get(name)
    if lib is not None:
        return lib
    so = os.path.join(BUILD_DIR, f"lib{name}-{_digest(sources, headers)}.so")
    if not os.path.exists(so):
        ptxas_report[name] = _compile(
            name, so, [nvcc_path(), *NVCC_FLAGS],
            [os.path.join(CSRC, s) for s in sources])
    with _lock:
        return _loaded.setdefault(name, ctypes.CDLL(so))


def load_host(name: str) -> ctypes.CDLL:
    """Build (if needed) and load native/<name>.cpp with g++ into
    _build/lib<name>-<hash>.so (the reference builds its copy next to
    the source, the reference native build.py:29-48)."""
    with _lock:
        lib = _loaded.get(name)
    if lib is not None:
        return lib
    src = f"{name}.cpp"
    digest = _digest((src,), (), GXX_FLAGS, NATIVE)
    so = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if not os.path.exists(so):
        gxx = shutil.which("g++")
        if gxx is None:
            raise BuildError(f"g++ not found: native/{src} is built from "
                             "source at first use")
        _compile(name, so, [gxx, *GXX_FLAGS], [os.path.join(NATIVE, src)])
    with _lock:
        return _loaded.setdefault(name, ctypes.CDLL(so))


def build_parallel(builders: Dict[str, Callable[[], object]]
                   ) -> Dict[str, float]:
    """Run every builder at once, one thread each (nvcc and g++ run
    outside the lock, so the libraries build in parallel); -> {name:
    seconds}. The first error raised by a builder is raised here once
    all have ended."""
    seconds: Dict[str, float] = {}
    errors: List[BaseException] = []

    def build(name: str, fn) -> None:
        t0 = time.monotonic()
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)
        seconds[name] = time.monotonic() - t0

    threads = [threading.Thread(target=build, args=item)
               for item in builders.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return seconds
