"""The port's batched SHA-256 (tpubft_torch/ops/sha256.py) against the
reference (tpubft/ops/sha256.py: its host padding and its two jitted
kernels under JAX on the CPU) and against hashlib.

The port's entry points run here on CPU tensors, where they take the plain
PyTorch version; the CUDA kernel is held against the same plain version on
the card (tests/test_torch_cuda.py, chip_smoke.py). Every comparison is
exact.
"""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubft.ops import sha256 as R
from tpubft_torch.ops import sha256 as S
from tpubft_torch.ops import _build, sha256_cuda
from tpubft_torch.ops.dispatch import device_breaker
from tpubft_torch.statetransfer import digests
from tpubft_torch.utils import flight

# one intra-op thread: these tests run many tiny tensor ops, and several
# test workers share the host's cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
EDGE_LENGTHS = (0, 55, 56, 63, 64, 119, 300)


def _messages(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.bytes(n) for n in lengths]


def _merkle_messages(n, seed=1):
    rng = np.random.default_rng(seed)
    return [b"\x01" + rng.bytes(64) for _ in range(n)]


def _mixed():
    return _messages(EDGE_LENGTHS + (1000, 5, 64, 4096), seed=2)


@pytest.mark.parametrize("n", EDGE_LENGTHS)
def test_pad_and_blocks_needed_equal_reference(n):
    msg = _messages([n])[0]
    nb = S.blocks_needed(n)
    assert nb == R.blocks_needed(n)
    got, want = S._pad_to_words(msg, nb), R._pad_to_words(msg, nb)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_prepare_equals_reference():
    msgs = _merkle_messages(37)
    got, want = S.prepare(msgs), R.prepare(msgs)
    assert got.dtype == want.dtype == np.uint32
    assert got.shape == want.shape == (37, 2, 16)
    assert np.array_equal(got, want)


def test_prepare_mixed_equals_reference():
    msgs = _mixed()
    gw, gn = S.prepare_mixed(msgs)
    ww, wn = R.prepare_mixed(msgs)
    assert gw.dtype == ww.dtype and gn.dtype == wn.dtype
    assert np.array_equal(gw, ww) and np.array_equal(gn, wn)
    assert gw.shape[1] == 128                   # 4096 B -> 65 -> pow2


def test_prepare_rejects_mixed_block_counts():
    with pytest.raises(ValueError):
        S.prepare([b"short", b"x" * 100])


def test_plain_equals_reference_uniform_kernel():
    msgs = _merkle_messages(64) + [b"\x01" * 65]
    words = R.prepare(msgs)
    want = np.asarray(R.sha256_kernel(jnp.asarray(words)))
    w, nb = S.to_tensors(
        words, np.full(len(msgs), words.shape[1], np.uint32), CPU)
    got = S.digests_from_tensor(S.plain_sha256(w, nb))
    assert np.array_equal(got, want)


def test_plain_equals_reference_masked_kernel():
    words, nblocks = R.prepare_mixed(_mixed())
    want = np.asarray(R.sha256_kernel_masked(jnp.asarray(words),
                                             jnp.asarray(nblocks)))
    w, nb = S.to_tensors(words, nblocks, CPU)
    got = S.digests_from_tensor(S.plain_sha256(w, nb))
    assert np.array_equal(got, want)


def test_plain_freezes_lanes_past_their_block_count():
    """Block counts of 0 and beyond nb: the reference's masked kernel
    keeps the initial state for 0 and compresses all nb blocks for
    anything larger."""
    words, _ = R.prepare_mixed(_mixed()[:4])
    nblocks = np.array([0, 1, 7, 9], np.uint32)
    want = np.asarray(R.sha256_kernel_masked(jnp.asarray(words),
                                             jnp.asarray(nblocks)))
    got = S.digests_from_tensor(S.plain_sha256(
        *S.to_tensors(words, nblocks, CPU)))
    assert np.array_equal(got, want)
    assert np.array_equal(got[0], S.H0)


@pytest.mark.parametrize("n", EDGE_LENGTHS)
def test_batch_equals_hashlib_on_edge_lengths(n):
    msgs = _messages([n] * 3, seed=n)
    want = [hashlib.sha256(m).digest() for m in msgs]
    assert S.sha256_batch(msgs, CPU) == want
    assert S.sha256_batch_mixed(msgs, CPU) == want


def test_batch_mixed_equals_hashlib_across_lengths():
    msgs = _messages(EDGE_LENGTHS, seed=3)
    assert S.sha256_batch_mixed(msgs, CPU) == \
        [hashlib.sha256(m).digest() for m in msgs]


def test_batch_of_300_merkle_messages_equals_hashlib():
    msgs = _merkle_messages(300)
    assert S.sha256_batch(msgs, CPU) == \
        [hashlib.sha256(m).digest() for m in msgs]


def test_empty_batches():
    assert S.sha256_batch([], CPU) == []
    assert S.sha256_batch_mixed([], CPU) == []


def test_batch_goes_through_the_device_seam():
    breaker = device_breaker()
    breaker.reset()
    flight.kernel_profiler().reset()
    before = breaker.snapshot()["successes"]
    S.sha256_batch(_merkle_messages(5), CPU)
    row = flight.kernel_profiler().snapshot()["sha256"]
    assert row["calls"] == 1 and row["batch_max"] == 8     # pow2 padding
    assert breaker.snapshot()["successes"] == before + 1


def test_kernel_routing_refuses_other_devices():
    w = torch.zeros((1, 1, 16), dtype=torch.int32, device="meta")
    nb = torch.ones(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        S.sha256_kernel(w, nb)


def test_cuda_wrapper_refuses_cpu_tensors():
    w, nb = S.to_tensors(*R.prepare_mixed(_mixed()), CPU)
    before = sha256_cuda.LAUNCHES["sha256"]
    with pytest.raises(ValueError, match="CUDA tensor"):
        sha256_cuda.sha256(w, nb)
    assert sha256_cuda.LAUNCHES["sha256"] == before


# the shape of `cuobjdump -sass` output: a prologue, a loop closed by a
# backward branch, an epilogue, and the trailing self-branch after EXIT
_SASS = """
\t\tFunction : sha256_kernel
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x0 */
        /*0010*/              @P0 EXIT ;                            /* 0x0 */
        /*0020*/                   IMAD.SHL.U32 R12, R31, 0x4, RZ ; /* 0x0 */
        /*0030*/                   LDG.E.128.CONSTANT R12, desc[UR4][R24.64] ;
        /*0040*/                   SHF.R.W.U32 R26, R8, 0x6, R8 ;  /* 0x0 */
        /*0050*/                   ULDC.64 UR60, c[0x3][0xc8] ;    /* 0x0 */
        /*0060*/                   LOP3.LUT R32, R10, R8, R9, 0xb8, !PT ;
        /*0070*/                   IADD3 R27, R12, R32, R11 ;      /* 0x0 */
        /*0080*/                   ISETP.GE.AND P0, PT, R31, R3, PT ;
        /*0090*/              @!P0 BRA 0x20 ;                       /* 0x0 */
        /*00a0*/                   STG.E.128 desc[UR4][R2.64], R4 ;
        /*00b0*/                   EXIT ;                           /* 0x0 */
        /*00c0*/                   BRA 0xc0;                        /* 0x0 */
"""


def test_sass_loop_body_is_the_block_loop():
    body = sha256_cuda.loop_body(_SASS)
    assert body == {"IMAD": 1, "LDG": 1, "SHF": 1, "ULDC": 1, "LOP3": 1,
                    "IADD3": 1, "ISETP": 1, "BRA": 1}
    # loads, the branch and the uniform load of K are not INT32 work
    assert sha256_cuda.int32_ops(body) == 5


def test_sass_without_a_loop_raises():
    with pytest.raises(ValueError, match="no backward branch"):
        sha256_cuda.loop_body(_SASS.replace("BRA 0x20", "BRA 0xa0"))


@pytest.mark.parametrize("sizes", [[100] * 20, [100, 5000] * 10])
def test_window_digests_device_path_equals_hashlib(sizes):
    raws = _messages(sizes, seed=len(set(sizes)))
    digests.DEGRADED = 0
    assert digests.window_digests(raws, device=CPU) == \
        [hashlib.sha256(r).digest() for r in raws]
    assert digests.DEGRADED == 0


def test_window_digests_below_threshold_stay_on_the_host(monkeypatch):
    def boom(*_a, **_k):
        raise AssertionError("must not reach the device")
    monkeypatch.setattr(S, "sha256_batch_mixed", boom)
    raws = _messages([10] * (digests.DEVICE_DIGEST_THRESHOLD - 1))
    assert digests.window_digests(raws) == \
        [hashlib.sha256(r).digest() for r in raws]


def test_window_digests_count_a_failed_device_call(monkeypatch):
    def boom(*_a, **_k):
        raise RuntimeError("device lost")
    monkeypatch.setattr(S, "sha256_batch_mixed", boom)
    raws = _messages([70] * 20)
    digests.DEGRADED = 0
    assert digests.window_digests(raws) == \
        [hashlib.sha256(r).digest() for r in raws]
    assert digests.DEGRADED == 1


@pytest.mark.parametrize("fault", [ValueError("words must be int32"),
                                   _build.BuildError("nvcc failed")])
def test_window_digests_raise_on_a_program_fault(monkeypatch, fault):
    """Only device loss (a RuntimeError) degrades to hashlib; a wrapper
    refusing its inputs or a kernel that does not build raises."""
    def boom(*_a, **_k):
        raise fault
    monkeypatch.setattr(S, "sha256_batch_mixed", boom)
    digests.DEGRADED = 0
    with pytest.raises(type(fault)):
        digests.window_digests(_messages([70] * 20))
    assert digests.DEGRADED == 0
