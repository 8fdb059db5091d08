"""The port's ECDSA kernels (ops/ecdsa.py's plain versions and host half,
ops/csrc/ecdsa.cu's own arithmetic) against the reference and each other,
exactly (tolerance: none; fold values word for word, verdicts, integers):

  * the constants in ecdsa.cu recomputed from the curves' parameters, G's
    fixed-base table from them and the wrapper's launch plan;
  * ecdsa.cu compiled with g++ in host mode (csrc/ecdsa_host.cpp): its
    field (shape reductions, squaring, inversion, the probe's Montgomery
    product) against Python ints, its Jacobian formulas against the plain
    Curve.jac_double / jac_add (the same coordinates) and the host
    engine's points, its GLV split against scalar._glv_split (a
    hypothesis property), its RLC fold against rlc_fold_plain word for
    word on batches with a forged lane, the two crafted wrap-case lanes,
    inactive lanes and crafted exceptional lanes (P = Q and P = -Q in the
    join, u1 = 0, u2 = 0), its per-item verify against verify_plain and
    the reference's scalar engine, both curves, and its count of field
    products against ops/ecdsa_cuda.kernel_counts;
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
from hypothesis import given, settings
from hypothesis import strategies as st

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


def _table(src, name):
    body = src[src.index(name + "["):]
    body = body[:body.index("};")]
    return [int(v, 16) for v in re.findall(r"0x([0-9a-f]{8})u", body)]


def test_kernel_constants_match_the_curves():
    src = open(os.path.join(CSRC, "ecdsa.cu")).read()
    want = []
    for curve in CURVES:
        p = E.CURVES[curve]["p"]
        want += _words(p) + _words(p - 2)
    assert _table(src, "EC_CURVES") == want
    glv, n = S._GLV_PARAMS["secp256k1"], E.CURVES["secp256k1"]["n"]

    def w(x, k):
        return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(k)]
    assert _table(src, "K1_N") == w(n, 8)
    assert _table(src, "K1_HALF_N") == w(n >> 1, 8)
    assert _table(src, "K1_DELTA") == w((1 << 256) - n, 5)
    assert _table(src, "K1_A1") == w(glv["a1"], 4)
    assert _table(src, "K1_A2") == w(glv["a2"], 5)
    assert _table(src, "K1_B1") == w(-glv["b1"], 4)
    assert _table(src, "K1_B2") == w(glv["b2"], 4)
    assert _table(src, "K1_BETA") == w(glv["beta"], 8)

    def off(width, count):
        return sum((1 << (width - 1)) << (width * j) for j in range(count))
    assert _table(src, "EC_QOFF") == w(off(5, 52), 9)
    assert _table(src, "EC_K1OFF") == w(off(5, 26), 5)
    assert _table(src, "EC_GOFF") == w(off(8, 33), 9)
    defines = dict(re.findall(r"#define (EC_\w+) (\d+)", src))
    assert int(defines["EC_WIN"]) == E.Q_WINDOW
    assert int(defines["EC_QDIG_K1"]) == E.Q_DIGITS["secp256k1"]
    assert int(defines["EC_QDIG"]) == E.Q_DIGITS["secp256r1"]
    assert int(defines["EC_GDIG"]) == E.G_DIGITS
    assert int(defines["EC_GTAB"]) == 1 << (E.G_WINDOW - 1)
    assert int(defines["EC_LPC"]) == ec.LPC
    assert ec.CURVE_INDEX == {c: i for i, c in enumerate(CURVES)}


@pytest.mark.parametrize("curve", CURVES)
def test_g_table_is_recomputed_from_the_curve(curve):
    """fixed_base_table[j][d - 1] = d 2^(8 j) G (the host engine's
    multiples of G), and the kernel's words lay it out as csrc reads it."""
    c = E.CURVES[curve]
    tab = E.fixed_base_table(curve)
    assert len(tab) == E.G_DIGITS and {len(r) for r in tab} == {128}
    for j, d in [(0, 1), (0, 2), (0, 128), (5, 77), (32, 1), (32, 128)]:
        want = S._jac_to_affine(S._mul_g((d << (8 * j)) % c["n"], curve),
                                c["p"])
        assert tab[j][d - 1] == want
        words = ec.g_table_words(curve)[(j * 128 + d - 1) * 16:][:16]
        assert [E.int_of(words[:8]), E.int_of(words[8:])] == list(want)
    assert ec.g_table_words(curve).size == E.G_DIGITS * 128 * 16


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
    lib.ecdsa_host_rlc.argtypes = [ci] + [vp] * 10 + [ci, vp]
    lib.ecdsa_host_verify.argtypes = [ci] + [vp] * 7 + [ci, vp, vp]
    lib.ecdsa_host_field.argtypes = [ci, ci, vp, vp, vp, ci]
    lib.ecdsa_host_pt.argtypes = [ci, ci, vp, vp, ci, vp]
    lib.ecdsa_host_glv.argtypes = [vp] * 4
    lib.ecdsa_host_products.restype = ctypes.c_longlong
    lib.ecdsa_lanes_per_cta.argtypes = [ci, ci]
    return lib


def _p(a: np.ndarray):
    return ctypes.c_void_p(a.ctypes.data)


def _u32(a) -> np.ndarray:
    a = np.ascontiguousarray(a)
    if a.dtype == bool:
        return a.astype(np.uint8)
    return a.astype(np.uint32) if a.dtype != np.uint32 else a


def _gtab(curve) -> np.ndarray:
    return np.ascontiguousarray(ec.g_table_words(curve))


def host_rlc(lib, curve, cols) -> np.ndarray:
    """The RLC launch in the host build -> the fold's 8 words (int32)."""
    arrs = [_u32(c) for c in cols]
    out = np.zeros(8, np.uint32)
    assert lib.ecdsa_host_rlc(ec.CURVE_INDEX[curve], *(_p(a) for a in arrs),
                              _p(_gtab(curve)), arrs[0].shape[1],
                              _p(out)) == 0
    return out.view(np.int32)


def host_verify(lib, curve, cols):
    arrs = [_u32(c) for c in cols]
    b = arrs[0].shape[1]
    ok, x = np.zeros(b, np.uint8), np.zeros((8, b), np.uint32)
    assert lib.ecdsa_host_verify(ec.CURVE_INDEX[curve],
                                 *(_p(a) for a in arrs), _p(_gtab(curve)),
                                 b, _p(ok), _p(x)) == 0
    return ok.astype(bool), x.view(np.int32)


@pytest.mark.parametrize("curve", CURVES)
def test_kernel_field_matches_python_ints(host_lib, curve):
    p = E.CURVES[curve]["p"]
    rng = np.random.default_rng(1)
    xs = [0, 1, 2, p - 1, p - 2, R256 - p, p >> 1, (1 << 255) + 12345,
          p - (1 << 224)] + [int.from_bytes(rng.bytes(32), "little") % p
                             for _ in range(40)]
    ys = list(reversed(xs))
    a = np.array([_words(x) for x in xs], np.uint32)
    b = np.array([_words(y) for y in ys], np.uint32)
    ops = {0: lambda x, y: x * y % p, 1: lambda x, y: (x + y) % p,
           2: lambda x, y: (x - y) % p,
           3: lambda x, y: pow(x, -1, p) if x else 0,
           4: lambda x, y: x * x % p,
           # the probe's Montgomery product: x y 2^-256
           5: lambda x, y: x * y * pow(R256, -1, p) % p}
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


def _host_pt(lib, curve, op, a, b, flags=0):
    pa = np.array([_words(v) for v in a], np.uint32)
    pb = np.array([_words(v) for v in b], np.uint32)
    out = np.zeros_like(pa)
    assert lib.ecdsa_host_pt(ec.CURVE_INDEX[curve], op, _p(pa), _p(pb),
                             flags, _p(out)) == 0
    return [E.int_of(w) for w in out]


@pytest.mark.parametrize("curve", CURVES)
def test_kernel_point_addition_is_curve_add(host_lib, curve):
    """pt_dbl, pt_add (with the negation and phi flags) and pt_madd (host
    build) give Curve.jac_double's / jac_add's Jacobian coordinates on
    P+P, P+(-P), O+P, P+O, P+Q, O+O and inputs with Z != 1, and the host
    engine's affine points."""
    c = E.CURVES[curve]
    p, a = c["p"], c["a"]
    cv = E.get_curve(curve)
    pts = [S._jac_to_affine(S._mul_g(k, curve), p) for k in (3, 7, 11)]
    P = (pts[0][0], pts[0][1], 1)
    Q = (pts[1][0], pts[1][1], 1)
    O = (0, 1, 0)
    z = 12345
    Pz = (P[0] * z * z % p, P[1] * z * z * z % p, z)
    Qz = (Q[0] * 4 % p, Q[1] * 8 % p, 2)
    neg = (P[0], p - P[1], 1)

    def plain(pt):
        return [cv.f.to_int(t[:, 0]) for t in pt]
    for x in (P, Pz, O):
        assert _host_pt(host_lib, curve, 0, x, x) == \
            plain(cv.jac_double(_port_pt(cv, [x])))
    for x, y in [(P, P), (P, neg), (O, P), (P, O), (P, Q), (Pz, Qz),
                 (Pz, Q), (O, O), (Qz, Pz)]:
        got = _host_pt(host_lib, curve, 1, x, y)
        assert got == plain(cv.jac_add(_port_pt(cv, [x]), _port_pt(cv, [y]))
                            ), (x, y)
        want = S._jac_to_affine(S._jac_add(x, y, p, a), p)
        assert (S._jac_to_affine(tuple(got), p) == want), (x, y)
        if y[2] == 1:       # the mixed addition on the affine y
            assert _host_pt(host_lib, curve, 2, x, y) == got
        # negated second point (flags & 1)
        yn = (y[0], (p - y[1]) % p, y[2])
        assert _host_pt(host_lib, curve, 1, x, y, 1) == \
            _host_pt(host_lib, curve, 1, x, yn)
    if curve == "secp256k1":
        beta = S._GLV_PARAMS[curve]["beta"]
        lam = S._GLV_PARAMS[curve]["lam"]
        got = _host_pt(host_lib, curve, 1, Pz, Q, 2)
        assert got == _host_pt(host_lib, curve, 1, Pz,
                               (Q[0] * beta % p, Q[1], 1))
        want = S._jac_add(Pz, S._jac_mul(lam, pts[1], c), p, a)
        assert S._jac_to_affine(tuple(got), p) == S._jac_to_affine(want, p)


_GLV = S._GLV_PARAMS["secp256k1"]
_N1 = E.CURVES["secp256k1"]["n"]


def _host_glv(lib, k):
    k1, k2 = np.zeros(5, np.uint32), np.zeros(5, np.uint32)
    negs = np.zeros(2, np.uint32)
    kw = np.array(_words(k), np.uint32)
    assert lib.ecdsa_host_glv(_p(kw), _p(k1), _p(k2), _p(negs)) == 0
    return E.int_of(k1), bool(negs[0]), E.int_of(k2), bool(negs[1])


@settings(max_examples=300, deadline=None)
@given(st.one_of(st.integers(0, _N1 - 1),
                 st.sampled_from([0, 1, _N1 - 1, _N1 >> 1, (_N1 >> 1) + 1,
                                  1 << 128, 1 << 255, _GLV["lam"],
                                  _N1 - _GLV["lam"]])))
def test_kernel_glv_split_matches_the_host_engine(host_lib, k):
    """The kernel's in-prologue split is scalar._glv_split's, and the
    property it is used for: k1 + k2 lambda = k (mod n), both halves
    below 2^128."""
    got = _host_glv(host_lib, k)
    assert got == S._glv_split(k, _GLV, _N1)
    k1 = -got[0] if got[1] else got[0]
    k2 = -got[2] if got[3] else got[2]
    assert (k1 + k2 * _GLV["lam"] - k) % _N1 == 0
    assert got[0] < 1 << 128 and got[2] < 1 << 128


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
def test_kernel_exceptional_lanes_equal_the_plain_versions(host_lib, curve):
    """The crafted exceptional lanes: verdicts and x as Python ints say,
    equal to verify_plain's; the fold over them (every lane active, the
    wrap factor on the first three) word for word equal to
    rlc_fold_plain's, and 0 over the accepted lanes alone."""
    vcols, rcols, want, xs = testing.ecdsa_exceptional_lanes(curve)
    ok, x = host_verify(host_lib, curve, vcols)
    pok, px = E.verify_plain(curve, *E.to_tensors(vcols, CPU))
    assert ok.tolist() == pok.tolist() == want
    assert [E.int_of(x[:, i]) for i in range(len(xs))] == xs
    assert np.array_equal(x, px.numpy())
    got = host_rlc(host_lib, curve, rcols)
    plain = E.rlc_fold_plain(curve, *E.to_tensors(rcols, CPU)).numpy()
    assert np.array_equal(got, plain) and got.any()
    acc = [i for i in range(len(want)) if want[i]]
    assert not host_rlc(host_lib, curve,
                        tuple(c[..., acc] for c in rcols)).any()


@pytest.mark.parametrize("curve", CURVES)
def test_kernel_on_larger_batches_and_inactive_lanes(host_lib, curve):
    """The host build alone (fast) on 40 lanes: each forged lane makes the
    fold nonzero, the clean subset folds to 0, inactive (host-invalid)
    lanes add nothing, verdicts equal the reference's engine, and the
    field products it runs are ops/ecdsa_cuda.kernel_counts'."""
    rcols, vcols, want = _batch(curve, 40, forged=(5, 17))
    host_lib.ecdsa_host_products()
    assert host_rlc(host_lib, curve, rcols).any()
    assert host_lib.ecdsa_host_products() == ec.kernel_field_muls(
        curve, rcols[0], rcols[1], rcols[7], rcols[6])
    clean = [i for i in range(41) if i not in (5, 17)]
    assert not host_rlc(host_lib, curve,
                        tuple(c[..., clean] for c in rcols)).any()
    off = list(rcols)
    off[7] = off[7].copy()
    off[7][[5, 17, 41]] = False
    host_lib.ecdsa_host_products()
    assert not host_rlc(host_lib, curve, tuple(off)).any()
    assert host_lib.ecdsa_host_products() == ec.kernel_field_muls(
        curve, off[0], off[1], off[7], off[6])
    assert host_verify(host_lib, curve, vcols)[0].tolist() == want
    assert host_lib.ecdsa_host_products() == ec.kernel_field_muls(
        curve, vcols[0], vcols[1], np.ones(42, bool), per_item=True)


def test_launch_plan_is_the_kernels(host_lib):
    """The wrapper's lanes a CTA (ecdsa_cuda.lanes_per_cta) is the
    source's: as few as spread the lanes over the SMs, at most 16."""
    for b in (1, 2, 6, 128, 132, 133, 264, 1000, 2112, 5000):
        for sms in (1, 114, 132):
            assert ec.lanes_per_cta(b, sms) == \
                host_lib.ecdsa_lanes_per_cta(b, sms)
    assert ec.lanes_per_cta(6, 132) == 1 and ec.lanes_per_cta(5000, 132) == 16


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
    # on random scalars the kernel runs more products than the function
    # needs at its cheapest, but less than three times as many
    rng = np.random.default_rng(3)
    for curve in ("secp256k1", "secp256r1"):
        n = E.CURVES[curve]["n"]
        ks = [int.from_bytes(rng.bytes(32), "big") % n for _ in range(8)]
        u1, u2, on = w(ks[:4]), w(ks[4:]), np.ones(4, bool)
        m, sq = ec.field_ops(curve, u1, u2, on)
        assert m + sq < ec.kernel_field_muls(curve, u1, u2, on) \
            < 3 * (m + sq)
    # the kernel, hand-counted on secp256k1: u2 = 0 runs Q's table (8
    # doublings, 7 mixed additions) and the chain's 125 doublings, u1 = 1
    # one digit (into the identity: no product), no join, the residual's
    # 4 products; u1 = 2^255 is two digits (one mixed addition), u2 = 3 one
    # (GLV: k1 = 3, k2 = 0), then the join (16)
    u1, u2 = w([1, 1 << 255]), w([0, 3])
    assert ec.kernel_field_muls("secp256k1", u1, u2, on[:2]) == \
        (133 * 7 + 7 * 11 + 4) + (11 + 133 * 7 + 7 * 11 + 16 + 4)
    assert ec.kernel_counts("secp256k1", u1, u2, on[:2])["chain"] == \
        {"dbl": 133, "add": 1, "madd": 7, "mul": 4}
    # at B = 128 (the kernel rows' batch) at most half of the products the
    # one-thread binary ladder that this kernel replaced ran there:
    # 802,961 (secp256k1) and 1,031,815 (P-256)
    for curve, before in (("secp256k1", 802961), ("secp256r1", 1031815)):
        items = testing.ecdsa_corpus(curve, 128, seed=128)
        prep = E.prepare_rlc_batch(curve, items)
        assert 2 * ec.kernel_field_muls(curve, prep.u1, prep.u2,
                                        prep.host_valid, prep.wrap_ok) \
            <= before
    assert F.get_field(E.CURVES["secp256k1"]["p"]) is \
        E.get_curve("secp256k1").f
