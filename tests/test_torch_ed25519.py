"""The port's Ed25519 verify (tpubft_torch/ops/ed25519.py) against the
reference (tpubft/ops/ed25519.py: the XLA kernel on the CPU, which is
bit-identical to the Pallas TPU kernel, and the host preparation).

Inputs are the port's seeded strict-verify corpus (tpubft_torch.testing):
valid, tampered, wrong key, wrong message, s >= L, non-canonical A and R,
A with x = 0 and the sign bit, a non-square y, wrong-length signature and
key, random R — at B = 64, the reference's smallest size class. Every
comparison is exact.
"""
import jax
import numpy as np
import pytest
import torch

from tpubft.ops import ed25519 as R
from tpubft_torch import convert, testing
from tpubft_torch.crypto import scalar
from tpubft_torch.ops import ed25519 as ops
from tpubft_torch.ops import ed25519_cuda
from tpubft_torch.ops.dispatch import device_breaker

# one intra-op thread: these tests run many tiny tensor ops, and several
# test workers share the host's cores
torch.set_num_threads(1)

B = 64


@pytest.fixture(scope="module")
def corpus():
    return testing.ed25519_corpus(B - 4, seed=3)


@pytest.fixture(scope="module")
def ref_raw(corpus):
    """The reference XLA kernel's raw verdicts on the padded batch."""
    prep = R.prepare_batch(corpus)
    return np.asarray(R.verify_kernel(*R._pad_rows(prep, len(corpus), B)))


def test_corpus_covers_every_kind(corpus):
    assert len(corpus) >= len(testing.KINDS)
    verdicts = [scalar.ed25519_verify(pk, m, s) for m, s, pk in corpus]
    kinds = [testing.KINDS[i % len(testing.KINDS)]
             for i in range(len(corpus))]
    for kind, ok in zip(kinds, verdicts):
        assert ok == kind.startswith("valid"), kind


def test_prepare_batch_identical(corpus):
    got = ops.prepare_batch(corpus)
    want = R.prepare_batch(corpus)
    for name in ops.PreparedBatch._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        assert np.array_equal(g, w), name
    # the corner cases that reach the kernel pass the host checks
    kinds = [testing.KINDS[i % len(testing.KINDS)]
             for i in range(len(corpus))]
    rejected = ("s_ge_l", "a_noncanonical", "r_noncanonical", "short_sig",
                "short_pk")
    reach_kernel = ("valid", "wrong_key", "wrong_msg", "a_x0_sign",
                    "a_nonsquare", "valid_long_msg", "r_x0_sign",
                    "r_nonsquare", "a_small_order")
    for kind, ok in zip(kinds, got.host_valid):
        if kind in rejected:
            assert not ok, kind
        elif kind in reach_kernel:
            assert ok, kind


def test_host_helpers_identical():
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 256, size=(B, 32), dtype=np.uint8)
    assert np.array_equal(ops._windows_le(rows), R._windows_le(rows))
    for bound in (ops.L, ops.P, 1, 2**256 - 1):
        assert np.array_equal(ops._lex_lt(rows, bound),
                              R._lex_lt(rows, bound))
    assert np.array_equal(ops._base_niels_table(), R._base_niels_table())
    assert ops._SIZE_CLASSES == R._SIZE_CLASSES
    for n in (1, 64, 65, 300, 40000):
        assert ops._pad_to_class(n) == R._pad_to_class(n)


def test_plain_kernel_matches_xla(corpus, ref_raw):
    """Raw verdicts (before host_valid) of the plain PyTorch kernel on the
    reference's own prepared arrays, carried over by convert.py."""
    prep = R.prepare_batch(corpus)
    args = convert.prepared_from_numpy(*R._pad_rows(prep, len(corpus), B),
                                       device="cpu")
    got = ops.verify_kernel(*args)
    assert got.dtype == torch.bool and got.shape == (B,)
    assert np.array_equal(got.numpy(), ref_raw)
    assert ref_raw[len(corpus):].tolist() == [False] * (B - len(corpus))


def test_verify_batch_matches_reference(corpus):
    got = ops.verify_batch(corpus, device="cpu")
    want = R.verify_batch(corpus)
    assert got.tolist() == want.tolist()
    assert got.tolist() == [scalar.ed25519_verify(pk, m, s)
                            for m, s, pk in corpus]
    assert ops.verify_batch([], device="cpu").tolist() == []


def test_decompress_matches(corpus):
    prep = ops.prepare_batch(corpus)
    pt, valid = ops.decompress(torch.from_numpy(prep.a_y),
                               torch.from_numpy(prep.a_sign))
    rpt, rvalid = jax.jit(R.decompress)(prep.a_y, prep.a_sign)
    assert np.array_equal(valid.numpy(), np.asarray(rvalid))
    for c in ("x", "y", "t"):
        assert np.array_equal(getattr(pt, c).numpy(),
                              np.asarray(getattr(rpt, c))), c


def _affine_ref(p):
    from tpubft.ops import f25519 as RF
    zi = RF.inv(p.z)
    return RF.canonical(RF.mul(p.x, zi)), RF.canonical(RF.mul(p.y, zi))


def test_double_scalar_mul_affine_matches():
    """[s]B + [h]A for random windows and valid keys: affine coordinates
    equal."""
    n = 8
    rng = np.random.default_rng(17)
    keys = [testing._signer(i).public_bytes() for i in range(n)]
    prep = ops.prepare_batch([(b"m", b"\0" * 64, pk) for pk in keys])
    s_win = rng.integers(0, 16, size=(64, n), dtype=np.int32)
    h_win = rng.integers(0, 16, size=(64, n), dtype=np.int32)
    pt, valid = ops.decompress(torch.from_numpy(prep.a_y),
                               torch.from_numpy(prep.a_sign))
    assert valid.all()
    q = ops.double_scalar_mul(torch.from_numpy(s_win),
                              torch.from_numpy(h_win), pt)
    from tpubft_torch.ops import f25519 as F
    zi = F.inv(q.z)
    got = (F.canonical(F.mul(q.x, zi)).numpy(),
           F.canonical(F.mul(q.y, zi)).numpy())

    @jax.jit
    def ref(s, h, a_y, a_sign):
        rpt, _ = R.decompress(a_y, a_sign)
        return _affine_ref(R.double_scalar_mul(s, h, rpt))

    want = ref(s_win, h_win, prep.a_y, prep.a_sign)
    assert np.array_equal(got[0], np.asarray(want[0]))
    assert np.array_equal(got[1], np.asarray(want[1]))


def test_plain_kernel_matches_xla_on_raw_lanes():
    """Inputs the host never sends (y >= p for A or R): the plain version
    and the reference XLA kernel give the verdicts the CUDA kernel is held
    to (testing.raw_kernel_lanes)."""
    arrays, want = testing.raw_kernel_lanes()
    got = ops.verify_kernel(*ops.to_tensors(arrays, "cpu"))
    assert got.tolist() == want == [True, False, True, False]
    assert np.asarray(R.verify_kernel(*arrays)).tolist() == want


def test_cuda_tensors_on_cpu_host_raise(corpus, monkeypatch):
    """No card here: asking for the card raises, and nothing reaches the
    plain version on the way."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only host")

    def forbidden(*args):
        raise AssertionError("the plain version must not run for cuda")

    monkeypatch.setattr(ops, "plain_verify_kernel", forbidden)
    try:
        with pytest.raises((RuntimeError, AssertionError)) as err:
            ops.verify_batch(corpus[:4], device="cuda")
    finally:
        device_breaker().reset()     # the failed launch counted on it
    assert "plain version must not run" not in str(err.value)
    from tpubft_torch import device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.default_device()


def test_wrappers_refuse_what_the_kernel_does_not_take(corpus):
    prep = ops.prepare_batch(corpus[:4])
    args = ops.to_tensors(ops._pad_rows(prep, 4, 4), "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ed25519_cuda.verify(*args)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ed25519_cuda.fe_mul(args[2], args[4])
    meta = tuple(a.to("meta") for a in args)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.verify_kernel(*meta)
    assert ed25519_cuda.LAUNCHES["ed25519_verify"] == 0


def test_kernel_cost_model():
    """The per-verify operation counts: what the four lanes execute (each
    decompressing a point, no inversion, building the table and running
    the 64 windows of 4 doublings and 2 additions) and what the function
    needs, which chip_smoke turns into the bound."""
    lane = ed25519_cuda.lane_ops()
    assert lane["decompress"] == {"sqr": 255, "mul": 19}
    assert lane["ladder"] == {"sqr": 64 * 4, "mul": 64 * 8}
    counts = ed25519_cuda.field_ops_per_verify()
    assert counts == {"sqr": 2048, "mul": 2300}
    need = ed25519_cuda.function_ops_per_verify()
    assert need == {"sqr": 2 * 255 + 64 * 16,
                    "mul": 2 * 18 + 2 + 14 * 9 + 64 * 31 + 2}
    assert need["sqr"] < counts["sqr"] and need["mul"] < counts["mul"]
    imad = ed25519_cuda.imad_per_verify(need)
    assert imad["imad_wide"] == 100 * 2150 + 55 * 1534
    steps = ed25519_cuda.critical_path_steps()
    assert steps["ladder"] == 64 * 12 and steps["total"] == 1070
    consts, btab = ed25519_cuda.kernel_constants()
    assert consts.shape == (3, 10) and btab.shape == (16, 3, 10)
    # the uploaded limbs are canonical values of the reference's constants
    for row, value in zip(consts.tolist(), (ops.D, ops.K2D, ops.SQRT_M1)):
        assert sum(v << ((51 * i + 1) // 2) for i, v in enumerate(row)) \
            == value


@pytest.mark.slow
def test_plain_kernel_matches_pallas_interpret():
    """One TILE through the Pallas kernel in interpret mode, as
    tests/test_ops_ed25519_pallas.py runs it."""
    from unittest import mock

    from jax.experimental import pallas as pl

    from tpubft.ops import ed25519_pallas as pk

    items = testing.ed25519_corpus(pk.TILE, seed=23)
    prep = R.prepare_batch(items)
    real_call = pl.pallas_call

    def interp_call(*args, **kw):
        kw.pop("compiler_params", None)
        kw["interpret"] = True
        return real_call(*args, **kw)

    with mock.patch.object(pl, "pallas_call", interp_call):
        want = np.asarray(pk.verify_kernel.__wrapped__(
            prep.s_win, prep.h_win, prep.a_y, prep.a_sign, prep.r_y,
            prep.r_sign))
    got = ops.verify_kernel(*ops.to_tensors(
        (prep.s_win, prep.h_win, prep.a_y, prep.a_sign, prep.r_y,
         prep.r_sign), "cpu")).numpy()
    assert got.tolist() == want.tolist()
