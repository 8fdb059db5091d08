"""The port's ECDSA kernels (ops/ecdsa.py's plain versions and host half,
ops/csrc/ecdsa.cu's own arithmetic) against the reference and each other,
exactly (tolerance: none; fold values word for word, verdicts, integers):

  * the curve constants in ecdsa.cu recomputed from the parameters;
  * ecdsa.cu compiled with g++ in host mode (csrc/ecdsa_host.cpp): its
    field against Python ints, its complete addition against the plain
    Curve.add (the same projective point), its RLC fold against
    rlc_fold_plain word for word on batches with a forged lane and the
    two crafted wrap-case lanes, its per-item verify against
    verify_plain and the reference's scalar engine, both curves;
  * rlc_fold_plain and verify_plain against the reference's jitted XLA
    kernels (make_rlc_kernel, make_verify_kernel) on the CPU, one batch
    of 8 with a forged item (secp256k1);
  * the reference's prepared RLC batch through convert.rlc_inputs_from_numpy
    equal to the port's own;
  * rlc_verify_batch's bisection with its launch counted: one real plain
    launch, the rest answered by the host engine (a plain launch on the
    CPU is thousands of op-by-op field products);
  * the CUDA wrapper refuses CPU tensors, and the work counts.

The kernels themselves run on the card (tests/test_torch_cuda.py,
chip_smoke.py, tools/ecdsa_probe.py).
"""
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tpubft.crypto import scalar as RS
from tpubft.ops import ecdsa as RE
from tpubft_torch import convert, device, testing
from tpubft_torch.crypto import scalar as S
from tpubft_torch.ops import ecdsa as E
from tpubft_torch.ops import ecdsa_cuda as ec
from tpubft_torch.ops import field as F

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(__file__), "..", "tpubft_torch", "ops",
                    "csrc")
CURVES = ("secp256k1", "secp256r1")
CPU = torch.device("cpu")
R256 = 1 << 256


@pytest.fixture(autouse=True)
def _cpu():
    device.set_default_device("cpu")
    yield
    device.set_default_device(None)


def _words(x):
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def test_kernel_constants_match_the_curves():
    src = open(os.path.join(CSRC, "ecdsa.cu")).read()
    table = src[src.index("EC_CURVES[2] = {"):src.index("};", src.index(
        "EC_CURVES[2] = {"))]
    nums = [int(v, 16) for v in re.findall(r"0x([0-9a-f]{8})u", table)]
    flags = re.findall(r"^\s+([01])},", table, re.M)
    assert len(nums) == 2 * (8 * 8 + 1) and len(flags) == 2
    for ci, curve in enumerate(CURVES):
        c = E.CURVES[curve]
        p = c["p"]
        want = (_words(p) + [(-pow(p, -1, 1 << 32)) % (1 << 32)]
                + _words(R256 * R256 % p) + _words(R256 % p)
                + _words(c["a"] % p * R256 % p)
                + _words(3 * c["b"] % p * R256 % p)
                + _words(c["gx"] * R256 % p) + _words(c["gy"] * R256 % p)
                + _words(p - 2))
        assert nums[ci * 65:(ci + 1) * 65] == want, curve
        assert int(flags[ci]) == int(c["a"] == 0)
    assert ec.CURVE_INDEX == {c: i for i, c in enumerate(CURVES)}


# ---- the kernel's own arithmetic, on the host ----

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the host build of ecdsa.cu needs one")
    so = str(tmp_path_factory.mktemp("ecdsa_host") / "libecdsa_host.so")
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-o", so,
                    os.path.join(CSRC, "ecdsa_host.cpp")], check=True)
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ecdsa_host_rlc.argtypes = [ci] + [vp] * 9 + [ci, vp]
    lib.ecdsa_host_verify.argtypes = [ci] + [vp] * 6 + [ci, vp, vp]
    lib.ecdsa_host_field.argtypes = [ci, ci, vp, vp, vp, ci]
    lib.ecdsa_host_pt_add.argtypes = [ci, vp, vp, vp]
    return lib


def _p(a: np.ndarray):
    return ctypes.c_void_p(a.ctypes.data)


def _u32(a) -> np.ndarray:
    a = np.ascontiguousarray(a)
    if a.dtype == bool:
        return a.astype(np.uint8)
    return a.astype(np.uint32) if a.dtype != np.uint32 else a


def host_rlc(lib, curve, cols) -> np.ndarray:
    """The RLC launch in the host build -> the fold's 8 words (int32)."""
    arrs = [_u32(c) for c in cols]
    out = np.zeros(8, np.uint32)
    assert lib.ecdsa_host_rlc(ec.CURVE_INDEX[curve], *(_p(a) for a in arrs),
                              arrs[0].shape[1], _p(out)) == 0
    return out.view(np.int32)


def host_verify(lib, curve, cols):
    arrs = [_u32(c) for c in cols]
    b = arrs[0].shape[1]
    ok, x = np.zeros(b, np.uint8), np.zeros((8, b), np.uint32)
    assert lib.ecdsa_host_verify(ec.CURVE_INDEX[curve],
                                 *(_p(a) for a in arrs), b, _p(ok),
                                 _p(x)) == 0
    return ok.astype(bool), x.view(np.int32)


@pytest.mark.parametrize("curve", CURVES)
def test_kernel_field_matches_python_ints(host_lib, curve):
    p = E.CURVES[curve]["p"]
    rinv = pow(R256, -1, p)
    rng = np.random.default_rng(1)
    xs = [0, 1, 2, p - 1, p - 2, R256 - p, p >> 1] + [
        int.from_bytes(rng.bytes(32), "little") % p for _ in range(9)]
    ys = list(reversed(xs))
    a = np.array([_words(x) for x in xs], np.uint32)
    b = np.array([_words(y) for y in ys], np.uint32)
    ops = {0: lambda x, y: x * y * rinv % p, 1: lambda x, y: (x + y) % p,
           2: lambda x, y: (x - y) % p,
           # the inversion in Montgomery form: (x R^-1)^-1 R = x^-1 R^2
           3: lambda x, y: pow(x, -1, p) * R256 * R256 % p if x else 0,
           4: lambda x, y: x * R256 % p, 5: lambda x, y: x * rinv % p}
    for op, want in ops.items():
        r = np.zeros_like(a)
        assert host_lib.ecdsa_host_field(ec.CURVE_INDEX[curve], op, _p(a),
                                         _p(b), _p(r), len(xs)) == 0
        assert [E.int_of(w) for w in r] == \
            [want(x, y) for x, y in zip(xs, ys)], op


def _port_pt(cv, pts):
    f = cv.f
    cols = [torch.stack([torch.as_tensor(f.from_int(v[k])) for v in pts], 1)
            for k in range(3)]
    return type(cv.identity((1,), CPU))(*cols)


@pytest.mark.parametrize("curve", CURVES)
def test_kernel_point_addition_is_curve_add(host_lib, curve):
    """pt_add (host build) and Curve.add give the same projective point
    on P+P, P+(-P), O+P, P+O, P+Q and a projective (Z != 1) input."""
    c = E.CURVES[curve]
    p = c["p"]
    cv = E.get_curve(curve)
    pts = [S._jac_to_affine(S._mul_g(k, curve), p) for k in (3, 7, 11)]
    P = (pts[0][0], pts[0][1], 1)
    Q = (pts[1][0], pts[1][1], 1)
    O = (0, 1, 0)
    z = 12345
    Pz = (P[0] * z % p, P[1] * z % p, z)
    cases = [(P, P), (P, (P[0], p - P[1], 1)), (O, P), (P, O), (P, Q),
             (Pz, Q), (O, O)]
    for a, b in cases:
        pa = np.array([_words(v * R256 % p) for v in a], np.uint32)
        pb = np.array([_words(v * R256 % p) for v in b], np.uint32)
        out = np.zeros_like(pa)
        assert host_lib.ecdsa_host_pt_add(ec.CURVE_INDEX[curve], _p(pa),
                                          _p(pb), _p(out)) == 0
        got = [E.int_of(w) * pow(R256, -1, p) % p for w in out]
        want = cv.add(_port_pt(cv, [a]), _port_pt(cv, [b]))
        assert got == [cv.f.to_int(t[:, 0]) for t in want], (a, b)


def _batch(curve, b, forged):
    """b corpus items (`forged` indices forged) with the wrap lanes after:
    the RLC columns, the verify columns, the host's expected verdicts."""
    items = testing.ecdsa_corpus(curve, b, seed=b, forged=forged)
    rlc_w, ver_w, (_, wrap_want) = testing.ecdsa_wrap_lanes(curve)
    prep = E.prepare_rlc_batch(curve, items)
    rcols = tuple(np.concatenate([c, w], -1) for c, w in
                  zip(E.rlc_columns(prep, range(b)), rlc_w))
    vprep = E.prepare_batch(curve, items)
    vcols = tuple(np.concatenate([c, w], -1) for c, w in
                  zip(vprep[:6], ver_w))
    want = RS.ecdsa_verify_batch([(pk, m, s) for m, s, pk in items],
                                 curve) + wrap_want
    return rcols, vcols, want


@pytest.mark.parametrize("curve", CURVES)
def test_kernel_fold_and_verify_equal_the_plain_versions(host_lib, curve):
    """On 4 corpus lanes (one forged) and the 2 wrap lanes: the fold's
    value word for word (nonzero here), the clean lanes' fold 0 in both,
    the verdicts and x equal, and the verdicts the reference's scalar
    engine's (and the wrap lane's r + n accepted)."""
    rcols, vcols, want = _batch(curve, 4, forged=(2,))
    got = host_rlc(host_lib, curve, rcols)
    plain = E.rlc_fold_plain(curve, *E.to_tensors(rcols, CPU)).numpy()
    assert np.array_equal(got, plain) and got.any()
    clean = [0, 1, 3, 4]
    ccols = tuple(c[..., clean] for c in rcols)
    assert not host_rlc(host_lib, curve, ccols).any()
    ok, x = host_verify(host_lib, curve, vcols)
    pok, px = E.verify_plain(curve, *E.to_tensors(vcols, CPU))
    assert ok.tolist() == pok.tolist() == want == \
        [True, True, False, True, True, False]
    assert np.array_equal(x, px.numpy())


@pytest.mark.parametrize("curve", CURVES)
def test_kernel_on_larger_batches_and_inactive_lanes(host_lib, curve):
    """The host build alone (fast) on 40 lanes: each forged lane makes the
    fold nonzero, the clean subset folds to 0, inactive (host-invalid)
    lanes add nothing, and verdicts equal the reference's engine."""
    rcols, vcols, want = _batch(curve, 40, forged=(5, 17))
    assert host_rlc(host_lib, curve, rcols).any()
    clean = [i for i in range(41) if i not in (5, 17)]
    assert not host_rlc(host_lib, curve,
                        tuple(c[..., clean] for c in rcols)).any()
    off = list(rcols)
    off[7] = off[7].copy()
    off[7][[5, 17, 41]] = False
    assert not host_rlc(host_lib, curve, tuple(off)).any()
    assert host_verify(host_lib, curve, vcols)[0].tolist() == want


# ---- the plain versions against the reference's jitted kernels ----

@pytest.fixture(scope="module")
def reference_kernels():
    return (RE.make_rlc_kernel("secp256k1"),
            RE.make_verify_kernel("secp256k1"))


def test_plain_kernels_match_the_reference_jit(reference_kernels):
    import jax.numpy as jnp
    rlc_k, verify_k = reference_kernels
    curve = "secp256k1"
    items = testing.ecdsa_corpus(curve, 8, seed=3, forged=(6,))
    rprep = RE.prepare_rlc_batch(curve, items)
    vprep = RE.prepare_batch(curve, items)
    want_ok = np.asarray(verify_k(*vprep[:6])) & vprep.host_valid
    pprep = E.prepare_batch(curve, items)
    got_ok, _ = E.verify_plain(curve, *E.to_tensors(pprep[:6], CPU))
    assert (got_ok.numpy() & pprep.host_valid).tolist() == want_ok.tolist() \
        == [i != 6 for i in range(8)]

    def ref_fold(idxs):
        return bool(rlc_k(rprep.u1_bits[:, idxs], rprep.u2_bits[:, idxs],
                          rprep.qx[:, idxs], rprep.qy[:, idxs],
                          rprep.xr_m[:, idxs], rprep.xrpn_m[:, idxs],
                          rprep.wrap_ok[idxs],
                          jnp.asarray(rprep.host_valid[idxs]),
                          rprep.a_m[:, idxs]))
    port = E.prepare_rlc_batch(curve, items)
    full, clean = list(range(8)), [0, 1, 2, 3, 4, 5, 7, 7]
    for idxs in (full, clean):
        ok = not E.rlc_fold_plain(curve, *E.to_tensors(
            E.rlc_columns(port, idxs), CPU)).any()
        assert ok == ref_fold(idxs) == (idxs is clean)


def test_rlc_inputs_from_the_reference_equal_the_port_prep():
    for curve in CURVES:
        items = testing.ecdsa_corpus(curve, 5, seed=4, forged=(1,))
        # a host-invalid item and an off-curve key among them
        items[3] = (items[3][0], b"\0" * 64, items[3][2])
        items[4] = (items[4][0], items[4][1], b"\x04" + b"\0" * 64)
        got = convert.rlc_inputs_from_numpy(
            curve, *RE.prepare_rlc_batch(curve, items), device=CPU)
        want = E.to_tensors(E.rlc_columns(E.prepare_rlc_batch(curve, items),
                                          range(5)), CPU)
        assert len(got) == len(want) == 9
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
        assert got[7].tolist() == [True, True, True, False, False]


# ---- the bisection ----

def _bisection_launches(live, bad):
    """Launches of the reference's descent over `live` with `bad` forged."""
    if not live:
        return 0
    if not bad & set(live) or len(live) == 1:
        return 1
    mid = len(live) // 2
    return 1 + _bisection_launches(live[:mid], bad) + \
        _bisection_launches(live[mid:], bad)


@pytest.mark.parametrize("forged", [(), (3,), (0, 9, 10)])
def test_bisection_isolates_forged_items(monkeypatch, forged):
    curve = "secp256k1"
    items = testing.ecdsa_corpus(curve, 12, seed=5, forged=forged)
    items[7] = (items[7][0], items[7][1][:40], items[7][2])   # host-invalid
    want = RS.ecdsa_verify_batch([(pk, m, s) for m, s, pk in items], curve)
    coeff = {E.int_of(E.words_of([a])[:, 0]): i for i, a in
             enumerate(E._rlc_coeffs(items))}
    launches = []
    real = E.rlc_fold_kernel

    def counted(curve_name, *args):
        lanes = [coeff[E.int_of(args[8][:, j].numpy())]
                 for j in range(args[8].shape[1])]
        launches.append(lanes)
        if len(launches) == 1:
            return real(curve_name, *args)
        ok = all(want[i] for i in lanes)
        return torch.zeros(8, dtype=torch.int32) if ok else \
            torch.ones(8, dtype=torch.int32)
    monkeypatch.setattr(E, "rlc_fold_kernel", counted)
    E.reset_counts()
    got = E.rlc_verify_batch(curve, items)
    assert got.tolist() == want
    live = [i for i in range(12) if i != 7]
    assert launches[0] == live
    assert len(launches) == _bisection_launches(live, set(forged))
    assert E.COUNTS[curve]["rlc_launches"] == len(launches)
    assert E.COUNTS[curve]["bisection_launches"] == len(launches) - 1
    assert E.COUNTS[curve]["lanes"] == sum(map(len, launches))


def test_empty_and_all_invalid_batches_launch_nothing(monkeypatch):
    monkeypatch.setattr(E, "rlc_fold_kernel", lambda *a: pytest.fail(
        "launched"))
    assert E.rlc_verify_batch("secp256k1", []).tolist() == []
    bad = [(b"m", b"\0" * 64, b"\x04" + b"\0" * 64)] * 3
    assert E.rlc_verify_batch("secp256k1", bad).tolist() == [False] * 3


def test_cuda_wrapper_refuses_cpu_tensors():
    items = testing.ecdsa_corpus("secp256k1", 2, seed=6)
    prep = E.prepare_rlc_batch("secp256k1", items)
    args = E.to_tensors(E.rlc_columns(prep, range(2)), CPU)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ec.rlc("secp256k1", *args)
    vprep = E.prepare_batch("secp256k1", items)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ec.verify("secp256k1", *E.to_tensors(vprep[:6], CPU))
    with pytest.raises(ValueError, match="unknown curve"):
        ec.rlc("p-384", *args)


def test_work_counts():
    """The bound's count (products M, squarings S): the cheapest way on
    the run's scalars, hand-counted on scalars whose digits are known."""
    w = E.words_of
    lam = S._GLV_PARAMS["secp256k1"]["lam"]
    # one addition (7M + 4S) joins [1]G and [1]Q
    assert ec.ladder_ops("secp256r1", 1, 1) == (7, 4)
    # G's fixed-base tables: u1 = 2^200 is one digit, no doubling
    assert ec.ladder_ops("secp256r1", 1 << 200, 1) == (7, 4)
    # Q is doubled 200 times (3M + 5S each on P-256) then added once
    assert ec.ladder_ops("secp256r1", 1, 1 << 200) == (607, 1004)
    # secp256k1's GLV: u2 = lambda is phi(Q) (1M) and no doubling
    assert ec.ladder_ops("secp256k1", 1, lam) == (8, 4)
    u1, u2 = w([1, 1 << 200]), w([1, 1])
    on = np.ones(2, bool)
    # the fold's residual: 1S + 2M a lane, 2M more on a wrap lane
    assert ec.field_ops("secp256r1", u1, u2, on) == (2 * (7 + 2), 2 * 5)
    assert ec.field_ops("secp256r1", u1, u2, on, np.array([True, False])
                        ) == (2 * (7 + 2) + 2, 2 * 5)
    assert ec.field_ops("secp256r1", u1, u2, np.array([False, True])) \
        == (7 + 2, 5)
    # the per-item verify: 3M (batch inversion) + 1S + 1M a lane, one
    # inversion (255S + 15M) a launch, less the 3M of the first lane
    assert ec.field_ops("secp256r1", u1, u2, on, per_item=True) == \
        (2 * (7 + 4) - 3 + 15, 2 * (4 + 1) + 255)
    ops, nbytes = ec.work("secp256r1", u1, u2, on)
    assert ops == ec.op_cost("secp256r1", 18, 10) == 18 * 128 + 10 * 72
    assert nbytes == 7 * 32 * 2 + 2 * 2 + 32
    # secp256k1's reduction: 10 wide multiply-adds an operand
    assert ec.op_cost("secp256k1", 1, 1) == 128 + 72 + 2 * 20
    # on random scalars the function needs far less than the kernel runs
    rng = np.random.default_rng(3)
    for curve in ("secp256k1", "secp256r1"):
        n = E.CURVES[curve]["n"]
        ks = [int.from_bytes(rng.bytes(32), "big") % n for _ in range(8)]
        u1, u2, on = w(ks[:4]), w(ks[4:]), np.ones(4, bool)
        needed, _ = ec.work(curve, u1, u2, on)
        assert needed * 4 < ec.kernel_field_muls(curve, u1, u2, on) * \
            ec.OPS_PER_FIELD_MUL
    # the kernel: 257 + digits additions of 14 products, 2 + 6 more, 1 out
    u1, u2 = w([1, 1 << 255]), w([0, 3])
    assert ec.kernel_field_muls("secp256k1", u1, u2, on[:2]) == \
        1 + (2 + 14 * (257 + 1) + 6) + (2 + 14 * (257 + 3) + 6)
    assert F.get_field(E.CURVES["secp256k1"]["p"]) is \
        E.get_curve("secp256k1").f
