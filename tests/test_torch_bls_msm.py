"""The port's G1 MSM (ops/bls12_381.py, ops/field.py, ops/weierstrass.py and
the kernel's own arithmetic) against the reference, exactly:

  * the plain `plain_msm_batch_kernel`, fed through
    convert.msm_inputs_from_numpy, against the JAX package's
    tpubft.ops.bls12_381.msm_batch on the CPU (one fixed shape, S=2 K=4,
    with an identity slot, a None point, a zero scalar and one >= r);
  * msm, combine_shares_batch and batch_scalar_mul on CPU tensors against
    the host engine's g1_msm / combine_shares at K = 1, 5 and 16;
  * csrc/bls12_381_msm.cu's field, curve and lane functions, compiled
    with g++ in host mode (csrc/bls12_381_msm_host.cpp), against Python
    ints at the same edge cases, P + P and P + (-P);
  * the torch Field and Curve against Python ints, with hypothesis.

The kernel itself runs on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import ctypes
import os
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tpubft.crypto import bls12381 as RB
from tpubft.ops import bls12_381 as RO
from tpubft_torch import convert, device
from tpubft_torch.ops import bls12_381 as B
from tpubft_torch.ops import bls12_381_cuda as bc
from tpubft_torch.ops import field as F

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(__file__), "..", "tpubft_torch", "ops",
                    "csrc")
P, R = RB.P, RB.R
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _cpu():
    device.set_default_device("cpu")
    yield
    device.set_default_device(None)


def _points(n, seed):
    rng = random.Random(seed)
    return [RB.g1_mul(RB.G1_GEN, rng.randrange(1, R)) for _ in range(n)]


def _want(points, scalars):
    live = [(p, k) for p, k in zip(points, scalars) if p is not None]
    return RB.g1_msm([p for p, _ in live], [k for _, k in live])


def _edge_segments():
    """S=2, K=4: a None point, a zero scalar, one >= r; the second
    segment cancels to the identity and its padded slot is empty."""
    pts = _points(4, seed=1)
    return [(pts, [R + 12345, 0, 7, R - 1]),
            ([pts[0], RB.g1_neg(pts[0]), None], [9, 9, 4])]


def test_plain_kernel_matches_jax_msm_batch():
    segments = _edge_segments()
    want = RO.msm_batch(segments)
    assert want == [_want(p, k) for p, k in segments]
    assert want[1] is None
    # the reference's own kernel inputs, as _msm_batch_launch builds them
    cv = RO.g1_curve()
    smax, kmax = 2, 4
    infinity = np.ones((smax, kmax), bool)
    pts, ks = [], []
    for j, (points, scalars) in enumerate(segments):
        for i in range(kmax):
            if i < len(points) and points[i] is not None:
                pts.append(points[i])
                ks.append(scalars[i] % R)
                infinity[j, i] = False
            else:
                pts.append((0, 0))
                ks.append(0)
    px, py = cv.affine_to_device(pts)
    px = px.reshape(px.shape[0], smax, kmax)
    py = py.reshape(py.shape[0], smax, kmax)
    bits = RO._bits_msb_batch(ks).reshape(RO.SCALAR_BITS, smax, kmax)
    args = convert.msm_inputs_from_numpy(bits, px, py, infinity, CPU)
    assert [tuple(a.shape) for a in args] == [(8, 2, 4), (12, 2, 4),
                                              (12, 2, 4), (2, 4)]
    x, y, z = [a.numpy() for a in B.plain_msm_batch_kernel(*args)]
    got = [B._to_affine_host(x[:, j], y[:, j], z[:, j]) for j in range(2)]
    assert got == want
    # and the reference kernel's projective output, made affine
    rx, ry, rz = [np.asarray(a) for a in RO.msm_batch_kernel(
        bits, px, py, infinity)]
    assert [RO._to_affine_host(rx[:, j, 0], ry[:, j, 0], rz[:, j, 0])
            for j in range(2)] == want


@pytest.mark.parametrize("k", [1, 5, 16])
def test_msm_combine_and_scalar_mul_match_the_host_engine(k):
    pts = _points(k, seed=k)
    rng = random.Random(k)
    scalars = [rng.randrange(0, 2 * R) for _ in range(k)]
    scalars[0] = R + 3
    assert B.msm(pts, scalars) == RB.g1_msm(pts, scalars)
    ids = sorted(rng.sample(range(1, 40), k))
    jobs = [(ids, pts), (ids[:-1] or ids, pts[:-1] or pts)]
    assert B.combine_shares_batch(jobs) == [
        RB.combine_shares(i, s) for i, s in jobs]
    muls = list(pts)
    muls[-1] = None
    ks = [0] + scalars[1:]
    assert B.batch_scalar_mul(muls, ks) == [
        None if p is None else RB.g1_mul(p, s) for p, s in zip(muls, ks)]


def test_empty_inputs():
    assert B.msm([], []) is None
    assert B.msm_batch([]) == []
    assert B.batch_scalar_mul([], []) == []


# ---- the kernel's own arithmetic, on the host ----

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the host build of bls12_381_msm.cu needs one")
    so = str(tmp_path_factory.mktemp("bls_host") / "libbls_msm_host.so")
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-o", so,
         os.path.join(CSRC, "bls12_381_msm_host.cpp")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.bls_host_msm.argtypes = [vp] * 7 + [ci] * 4
    lib.bls_host_field.argtypes = [ci, ci, vp, vp, vp]
    lib.bls_host_glv.argtypes = [vp, vp]
    lib.bls_msm_plan.argtypes = [ci] * 4 + [vp]
    return lib


# the card's lanes an element, and one thread an element
HOST_LANES = sorted({1, bc.LANES})
LAM = bc.GLV_LAMBDA


def _host_msm(lib, arrays, s, k, lanes, sms=132):
    """The kernel's launch, in the host build -> s affine results."""
    words, px, py, inf = [np.ascontiguousarray(a) for a in arrays]
    inf = inf.astype(np.uint8)
    out = [np.zeros((12, s), np.int64) for _ in range(3)]
    assert lib.bls_host_msm(*(ctypes.c_void_p(a.ctypes.data)
                              for a in (words, px, py, inf, *out)),
                            s, k, lanes, sms) == 0
    return [B._to_affine_host(out[0][:, j], out[1][:, j], out[2][:, j])
            for j in range(s)]


@pytest.mark.parametrize("shape", [(1, 1), (1, 5), (3, 7), (2, 130)])
def test_kernel_arithmetic_on_the_host(host_lib, shape):
    """The launch on the card's lanes an element: whole segments in a CTA,
    and (K = 130) pieces with the second launch's sum."""
    s, k = shape
    lanes = bc.LANES
    pts = _points(min(k, 8), seed=s * 100 + k)
    rng = random.Random(k)
    segments = []
    for j in range(s):
        seg_pts = [pts[i % len(pts)] for i in range(k - j % 2)]
        ks = [rng.randrange(R) for _ in seg_pts]
        if len(seg_pts) > 3:
            seg_pts[1] = None                   # a None point
            ks[2] = 0                           # a zero scalar
            ks[3] = R + ks[3]                   # one >= r
        segments.append((seg_pts, ks))
    if s > 1:                                   # P + (-P) and P + P
        segments[1] = ([pts[0], RB.g1_neg(pts[0])] + segments[1][0][2:],
                       [5, 5] + segments[1][1][2:])
    host = B.prepare_msm_batch(segments)
    assert _host_msm(host_lib, host, s, k, lanes) == \
        [_want(p, ks) for p, ks in segments]
    muls = [pts[0], pts[0], None] + pts[1:]
    ks = [R - 1, 2, 5] + [rng.randrange(2 * R) for _ in pts[1:]]
    assert _host_msm(host_lib, B._prep_msm(muls, ks), len(muls), 1,
                     lanes) == [None if p is None else RB.g1_mul(p, x)
                                for p, x in zip(muls, ks)]


# scalars at the edges of the signing and the GLV split
EDGE_SCALARS = {
    "r-1": R - 1, "r-10": R - 10, "lambda-1": LAM - 1, "lambda": LAM,
    "lambda+1": LAM + 1, "2^128": 1 << 128,
    "k2=0": 0x1234_5678_9ABC_DEF0_0FED_CBA9_8765_4321,   # k < lambda
    "k1=0": 12345 * LAM,                              # k = k2 lambda
    "(r-1)/2": (R - 1) // 2, "(r+1)/2": (R + 1) // 2, "1": 1, "8": 8,
    "16": 16}


@pytest.mark.parametrize("lanes", HOST_LANES)
@pytest.mark.parametrize("name", sorted(EDGE_SCALARS))
def test_kernel_edge_scalars_on_the_host(host_lib, name, lanes):
    """One edge scalar on a multiply, and in a segment beside P and -P at
    the same scalar (which cancel) and a random share."""
    k = EDGE_SCALARS[name]
    k1, k2, _ = bc.glv_split(k % R)
    if name == "k2=0":
        assert k2 == 0
    if name == "k1=0":
        assert k1 == 0
    pts = _points(3, seed=len(name))
    want = RB.g1_mul(pts[0], k)
    assert _host_msm(host_lib, B._prep_msm([pts[0]], [k]), 1, 1,
                     lanes) == [want]
    seg = ([pts[0], pts[1], RB.g1_neg(pts[1]), pts[2]], [k, k, k, 7])
    assert _host_msm(host_lib, B.prepare_msm_batch([seg]), 1, 4,
                     lanes) == [_want(*seg)]


@pytest.mark.parametrize("lanes", HOST_LANES)
def test_kernel_identity_segments_on_the_host(host_lib, lanes):
    """All-identity segments (None points, zero scalars, padding) beside a
    live one: the identity, and the live one's sum."""
    pts = _points(2, seed=9)
    segs = [([None, None], [3, 4]), (pts, [0, R]), ([pts[0]], [R - 3]),
            ([], [])]
    assert _host_msm(host_lib, B.prepare_msm_batch(segs), 4, 2, lanes) == \
        [None, None, RB.g1_mul(pts[0], R - 3), None]


def test_kernel_wide_segment_on_the_host(host_lib):
    """K = 667 (config 4's combine) at the card's plan: pieces of a CTA,
    their partial points and the second launch's sum, on one lane an
    element (the card's lanes take 15 s here; its K = 130 case above runs
    the same plan on them); and 40 lanes on the card's lanes, planned for
    4 SMs (10 pieces)."""
    pts = _points(16, seed=667)
    rng = random.Random(667)
    seg_pts = [pts[i % 16] for i in range(667)]
    ks = RB.lagrange_coeffs_at_zero(sorted(rng.sample(range(1, 1001), 667)))
    host = B.prepare_msm_batch([(seg_pts, ks)])
    want = [RB.g1_msm(seg_pts, ks)]
    assert bc.plan(1, 667, 132)["pps"] > 1
    assert _host_msm(host_lib, host, 1, 667, 1) == want
    small = host[0][:, :, :40], host[1][:, :, :40], host[2][:, :, :40], \
        host[3][:, :40]
    assert _host_msm(host_lib, small, 1, 40, bc.LANES, sms=4) == \
        [RB.g1_msm(seg_pts[:40], ks[:40])]


@pytest.mark.parametrize("lanes", bc.LANE_CHOICES)
def test_kernel_field_ops_match_python_ints(host_lib, lanes):
    """The Montgomery product, sum and difference of the kernel's field,
    on `lanes` lanes an element (the lookahead's carries between lanes),
    at loose inputs up to 2p - 1."""
    rng = random.Random(lanes)
    two_p = 2 * P
    vals = [0, 1, P - 1, P, two_p - 1, (1 << 32) - 1, (1 << 352) - 1] + \
        [rng.randrange(two_p) for _ in range(40)]
    rinv = pow(1 << 384, -1, P)

    def words(x):
        return np.array([(x >> (32 * i)) & 0xFFFFFFFF for i in range(12)],
                        dtype=np.uint32)
    out = np.zeros(12, np.uint32)
    for a, b in zip(vals, vals[::-1]):
        for op, want in ((0, a * b * rinv), (1, a + b), (2, a - b)):
            wa, wb = words(a), words(b)
            host_lib.bls_host_field(op, lanes, wa.ctypes.data,
                                    wb.ctypes.data, out.ctypes.data)
            got = sum(int(w) << (32 * i) for i, w in enumerate(out))
            assert got < two_p and got % P == want % P, (op, a, b)


@settings(max_examples=200, deadline=None)
@given(st.integers(min_value=0, max_value=R - 1))
def test_glv_split_and_digits_rebuild_the_scalar(host_lib, k):
    """The kernel's prologue (host-built) and its Python mirror: the signed
    scalar is k1 + k2 lambda with both halves below 2^128 (k1 < lambda),
    each half is sum d_j 16^j over its digits in [-8, 8)."""
    kw = np.array([(k >> (32 * i)) & 0xFFFFFFFF for i in range(8)],
                  dtype=np.uint32)
    out = np.zeros(19, np.uint32)
    host_lib.bls_host_glv(kw.ctypes.data, out.ctypes.data)
    val = [int(x) for x in out]

    def num(ws):
        return sum(w << (32 * i) for i, w in enumerate(ws))
    k1, k2, neg = num(val[0:4]), num(val[4:8]), bool(val[8])
    assert (k1, k2, neg) == bc.glv_split(k)
    assert k1 < LAM and k2 < 1 << 127
    assert (R - k if neg else k) == k1 + k2 * LAM
    assert neg == (k > (R - 1) // 2)
    for half, kp in ((k1, num(val[9:14])), (k2, num(val[14:19]))):
        ds = [((kp >> (4 * j)) & 15) - 8 for j in range(bc.DIGITS)]
        assert ds == bc.digits(half)
        assert all(-8 <= d < 8 for d in ds)
        assert sum(d * 16 ** j for j, d in enumerate(ds)) == half


def test_endomorphism_is_lambda_on_subgroup_points():
    """(beta x, y) = [lambda] P on the subgroup, with the beta the kernel
    holds (csrc BLS_BETA, in Montgomery form) and crypto/bls12381's."""
    import re
    from tpubft_torch.crypto import bls12381 as TB
    with open(os.path.join(CSRC, "bls12_381_msm.cu")) as f:
        src = f.read()
    body = re.search(r"BLS_BETA\[NW\] = \{([^}]*)\}", src).group(1)
    words = [int(w.strip().rstrip("u"), 16) for w in body.split(",")]
    beta = sum(w << (32 * i) for i, w in enumerate(words)) * \
        pow(1 << 384, -1, P) % P
    assert beta == TB._G1_BETA and pow(beta, 3, P) == 1 and beta != 1
    assert TB._G1_LAMBDA == LAM
    for pt in _points(4, seed=12) + [RB.G1_GEN]:
        assert RB.g1_mul(pt, LAM) == (beta * pt[0] % P, pt[1])


@pytest.mark.parametrize("shape", [(64, 5), (1, 667), (667, 1), (1, 1),
                                   (3, 7), (5, 9), (300, 3)])
def test_plan_matches_the_kernel(host_lib, shape):
    """ops/bls12_381_cuda.plan, which the counts use, is csrc's bls_plan."""
    s, k = shape
    out = np.zeros(7, np.int32)
    host_lib.bls_msm_plan(s, k, bc.LANES, 132, out.ctypes.data)
    pl = bc.plan(s, k, 132)
    assert list(out) == [pl["piece"], pl["spc"], pl["pps"], pl["ctas"],
                         pl["chains"] * bc.LANES, pl["chains"],
                         pl["reduce_groups"]]


# ---- the plain field and curve ----

FE = F.get_field(P)
elements = st.integers(min_value=0, max_value=P - 1)


def _mont(xs):
    return torch.as_tensor(np.stack([FE.from_int(x) for x in xs], 1))


def _ints(t):
    return [FE.to_int(w) for w in FE.to_words(t).T.numpy()]


@settings(max_examples=25, deadline=None)
@given(st.lists(st.tuples(elements, elements), min_size=1, max_size=6))
def test_field_ops_match_python_ints(pairs):
    xs = [a for a, _ in pairs] + [0, P - 1]
    ys = [b for _, b in pairs] + [P - 1, P - 1]
    a, b = _mont(xs), _mont(ys)
    assert _ints(FE.mul(a, b)) == [x * y % P for x, y in zip(xs, ys)]
    assert _ints(FE.add(a, b)) == [(x + y) % P for x, y in zip(xs, ys)]
    assert _ints(FE.sub(a, b)) == [(x - y) % P for x, y in zip(xs, ys)]
    assert _ints(FE.neg(a)) == [-x % P for x in xs]
    # a chain keeps its limbs loose and its value exact
    r, want = a, list(xs)
    for _ in range(6):
        r = FE.mul(FE.sub(FE.add(r, b), FE.add(a, a)), FE.add(r, b))
        want = [(w + y - 2 * x) * (w + y) % P
                for w, x, y in zip(want, xs, ys)]
        assert int(r[:-1].abs().max()) < 1 << 17
    assert _ints(r) == want
    raw = torch.as_tensor(np.stack([F.int_to_limbs(x) for x in xs], 1))
    assert FE.from_mont(FE.to_mont(raw)).tolist() == raw.tolist()
    assert FE.is_zero(FE.sub(a, a)).all() and FE.eq(a, a).all()


@settings(max_examples=15, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=R - 1), min_size=2,
                max_size=4))
def test_curve_add_matches_affine_addition(ks):
    cv = B.g1_curve()
    pts = [RB.g1_mul_py(RB.G1_GEN, k) for k in ks]
    pts.append(pts[0])                          # P + P
    live = [p for p in pts if p is not None]
    if not live:
        return
    xs = _mont([p[0] for p in live])
    ys = _mont([p[1] for p in live])
    a = cv.from_affine(xs, ys)
    b = cv.from_affine(xs.roll(1, 1), ys.roll(1, 1))
    s = cv.add(a, b)
    words = [cv.f.to_words(c).numpy() for c in s]
    got = [B._to_affine_host(words[0][:, i], words[1][:, i],
                             words[2][:, i]) for i in range(len(live))]
    assert got == [RB.g1_add(p, q)
                   for p, q in zip(live, live[-1:] + live[:-1])]


# ---- the bound's work count (ops/bls12_381_cuda.field_muls) ----

def test_glv_lambda_is_a_cube_root_of_unity_mod_r():
    from tpubft_torch.ops import bls12_381_cuda as bc
    lam = bc.GLV_LAMBDA
    assert lam < 1 << 128 and (lam * lam + lam + 1) % R == 0


@pytest.mark.parametrize("scalars,muls", [
    ([], 0), ([0], 0), ([R], 0),
    ([2], 8),               # one doubling
    ([5], 27),              # NAF 1 0 1: two doublings and an addition
    ([R - 5], 27),          # signed: -[5]P, negation is free
    ([1, 1, 1], 22),        # a multisig sum: two additions
    ([1, R - 1], 11),       # P + (-P)
])
def test_segment_field_muls_small_cases(scalars, muls):
    from tpubft_torch.ops import bls12_381_cuda as bc
    assert bc.segment_field_muls(scalars) == muls


def test_field_muls_counts_what_the_function_needs():
    """Below what the kernel runs (kernel_counts: fixed-length chains, the
    trees); identity lanes and zero scalars count nothing; config 2's ids 1..5 (coefficients 5, r - 10,
    10, r - 5, 1) need a few operations a segment."""
    from tpubft_torch.ops import bls12_381_cuda as bc
    rng = random.Random(3)
    pts = _points(3, seed=3)
    ids = sorted(rng.sample(range(1, 97), 64))
    ks = RB.lagrange_coeffs_at_zero(ids)
    lagrange5 = RB.lagrange_coeffs_at_zero([1, 2, 3, 4, 5])
    assert [min(k, R - k) for k in lagrange5] == [5, 10, 10, 5, 1]
    segs = [([pts[0]] * 64, ks), ([pts[1]] * 5, lagrange5),
            ([pts[2], None, pts[2]], [0, ks[0], 0])]
    words, _, _, inf = B.prepare_msm_batch(segs)
    per_segment = [bc.segment_field_muls(k) for k in (ks, lagrange5)]
    assert bc.field_muls(words, inf, True) == sum(per_segment)
    assert per_segment[1] < 200
    assert bc.field_muls(words, inf, True) < \
        bc.kernel_counts(3, 64, 132)["field_muls"] / 4
    mwords, _, _, minf = B._prep_msm([pts[0]] * 4 + [None], ks[:5])
    assert bc.field_muls(mwords, minf, False) == sum(
        bc.segment_field_muls([k]) for k in ks[:4])
    ops, nbytes = bc.work(words, inf, True)
    assert ops == bc.field_muls(words, inf, True) * bc.OPS_PER_FIELD_MUL


def test_crossover_is_read_from_the_largest_shapes_down():
    from tpubft_torch.tools.msm_crossover import crossover

    def rows(*pairs):
        return [{"shares": s, "host_ms": h, "device_ms": d}
                for s, h, d in pairs]
    assert crossover(rows((5, 1, 20), (160, 30, 20), (320, 60, 21))) == 160
    assert crossover(rows((5, 1, 20), (160, 21, 20), (320, 19, 21))) is None
    assert crossover(rows((5, 30, 20), (10, 40, 20))) == 5
