"""The rung-3 inversion kernel's own arithmetic (ops/csrc/fe_inv.cu), away
from the card: the source is compiled with the host g++ through
ops/csrc/fe_inv_host.cpp (the header's host mode; a group's four lanes
run as coroutines in lock-step at every shuffle) and both of its
designs, four lanes an element and one, are held against Python's
pow(x, p-2, p), the plain version F.canonical(F.inv) and JAX's
f25519.inv: 512 seeded elements, the edge cases and elements whose limbs
sit at the top of their ranges. Also the limb bounds the kernel's one-pass
carry rests on. The kernel itself is checked on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import ctypes
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubft.ops import f25519 as RF
from tpubft_torch.ops import f25519 as F

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(__file__), "..", "tpubft_torch", "ops",
                    "csrc")
EDGES = [0, 1, 2, 19, F.P - 1, (F.P - 1) // 2]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the host build of fe_inv.cu needs a C++20 "
                    "compiler")
    so = str(tmp_path_factory.mktemp("fe_inv_host") / "libfe_inv_host.so")
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-x",
         "c++", "-o", so, os.path.join(CSRC, "fe_inv_host.cpp")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(so)
    lib.fe_inv_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int, ctypes.c_int]
    lib.fe_inv_host.restype = ctypes.c_int
    return lib


def _limbs(vals):
    return np.ascontiguousarray(
        np.stack([F.int_to_limbs(v) for v in vals], 1).astype(np.int32))


def _top_limbs(rng, count=64):
    """Canonical elements with many of their 24 TPU limbs at 2^bits - 1,
    and the ten 26/25-bit limbs of the kernel's radix at their tops."""
    bits = np.diff([(255 * k + 23) // 24 for k in range(F.NL + 1)])
    out = [F.P - 1 - k for k in range(8)]
    while len(out) < count:
        mask = rng.random(F.NL) < 0.75
        v, pos = 0, 0
        for k, b in enumerate(bits):
            limb = (1 << int(b)) - 1 if mask[k] else int(
                rng.integers(0, 1 << int(b)))
            v |= limb << pos
            pos += int(b)
        if v < F.P:
            out.append(v)
    # ten-limb tops: limb i of the 26/25-bit radix at its maximum
    pos = [(51 * i + 1) // 2 for i in range(11)]
    for i in range(10):
        out.append(((1 << (pos[i + 1] - pos[i])) - 1) << pos[i])
    return out


def _corpus(name):
    rng = np.random.default_rng(20)
    if name == "seeded_512":
        return [int.from_bytes(rng.bytes(32), "little") % F.P
                for _ in range(512)]
    if name == "edges":
        return EDGES
    return _top_limbs(rng)


def _run(lib, a, lanes):
    out = np.zeros_like(a)
    assert lib.fe_inv_host(a.ctypes.data, out.ctypes.data, a.shape[1],
                           lanes) == 0
    return out


@pytest.mark.parametrize("lanes", [4, 1])
@pytest.mark.parametrize("corpus", ["seeded_512", "edges", "top_limbs"])
def test_kernel_arithmetic_equals_python_ints_and_plain(host_lib, corpus,
                                                        lanes):
    vals = _corpus(corpus)
    a = _limbs(vals)
    got = _run(host_lib, a, lanes)
    want = _limbs([pow(v, F.P - 2, F.P) for v in vals])
    assert np.array_equal(got, want)
    plain = F.canonical(F.inv(torch.from_numpy(a))).numpy()
    assert np.array_equal(got, plain)


def test_kernel_arithmetic_equals_jax_inv(host_lib):
    vals = EDGES + _corpus("seeded_512")[:58]
    a = _limbs(vals)
    want = np.asarray(RF.canonical(RF.inv(jnp.asarray(a))))
    assert np.array_equal(_run(host_lib, a, 4), want)
    assert np.array_equal(_run(host_lib, a, 1), want)


def test_host_build_refuses_other_lane_counts(host_lib):
    a = _limbs([3])
    assert host_lib.fe_inv_host(a.ctypes.data, a.ctypes.data, 1, 2) == -1


# ---- the bounds of the one-pass carry (fe_inv.cu, "Design") ----

def _width(k):
    return 26 - (k & 1)


def _limb_bound(c_max):
    """A limb after the pass: its own low bits, the next-lower column's
    piece b (below 2^width) and the piece two columns down, 19 x its high
    bits plus the bits of 19 b above 2^26 (at most 18)."""
    return [2 * ((1 << _width(k)) - 1) + 19 * c_max + 18 for k in range(10)]


def _columns(f, g, weight):
    """The largest sum each column can reach with limbs below f and g."""
    return [sum(f[i] * g[(m - i) % 10] * weight(i, (m - i) % 10)
                for i in range(10)) for m in range(10)]


def _product_weight(i, j):
    return (2 if i & 1 and j & 1 else 1) * (19 if i + j >= 10 else 1)


def test_carry_bounds_are_a_fixed_point():
    """Limbs below 2^(width+1) + 2^18 give column sums below 2^62, so the
    top piece h >> 51 is below 2^11, and the limbs the pass makes are below
    the same bound; every operand a step forms (2f, 19g, 38g on an odd
    limb) fits 32 bits."""
    c_max = (1 << 13) - 1                      # h < 2^64: h >> 51 < 2^13
    bound = _limb_bound(c_max)
    assert all(b < (1 << (_width(k) + 1)) + (1 << 18)
               for k, b in enumerate(bound))
    odd = [b for k, b in enumerate(bound) if k & 1]
    assert 2 * max(bound[k] for k in range(1, 10, 2)) < 1 << 32
    assert 19 * max(bound) < 1 << 32
    assert 38 * max(odd) < 1 << 32
    # a square is a product of the value with itself: the same column sums
    # whichever way the products are grouped
    h = _columns(bound, bound, _product_weight)
    assert max(h) < 1 << 62
    assert max(h) >> 51 <= c_max
    assert _limb_bound(max(h) >> 51) <= bound
