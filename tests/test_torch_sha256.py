"""The port's batched SHA-256 (tpubft_torch/ops/sha256.py) against the
reference (tpubft/ops/sha256.py: its host padding, its batch entry points
and its two jitted kernels under JAX on the CPU) and against hashlib.

The port's contract is raw bytes and offsets in, digests out. Its entry
points run here on CPU tensors, where they take the plain PyTorch version
(`plain_sha256_raw`: the padding as tensor ops, then the compression
`plain_sha256`); the CUDA kernel is held against the same plain version on
the card (tests/test_torch_cuda.py, chip_smoke.py). Every comparison is
exact.
"""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubft.ops import sha256 as R
from tpubft_torch import convert, testing
from tpubft_torch.kvbc import create_blockchain
from tpubft_torch.ops import sha256 as S
from tpubft_torch.ops import _build, sha256_cuda
from tpubft_torch.storage import MemoryDB
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


def _raw(messages, lead=0):
    """(data, offsets) tensors of the messages joined after `lead` bytes
    of filler, so message 0 starts at byte `lead`."""
    blob, offsets = S.pack([b"\xa5" * lead + messages[0], *messages[1:]]
                           if messages else [])
    offsets[0] = lead if messages else 0
    data, offs = S.to_device(blob, offsets, CPU)
    return data, offs


def _words(words_u32, nblocks):
    """Reference-layout numpy arrays -> the plain compression's tensors."""
    return (torch.from_numpy(np.ascontiguousarray(words_u32, np.uint32)
                             .view(np.int32)),
            torch.from_numpy(np.asarray(nblocks).astype(np.int32)))


def _hex(digests):
    return [bytes(row).hex() for row in digests.numpy()]


@pytest.mark.parametrize("n", EDGE_LENGTHS)
def test_pad_and_blocks_needed_equal_reference(n):
    msg = _messages([n])[0]
    nb = S.blocks_needed(n)
    assert nb == R.blocks_needed(n)
    words, nblocks = S.pad_words(*_raw([msg]))
    assert nblocks.tolist() == [nb]
    want = R._pad_to_words(msg, nb)
    assert np.array_equal(words[0].numpy().view(np.uint32), want)


def test_prepare_equals_reference():
    """The tensor padding of a uniform batch equals the reference's host
    padding (prepare)."""
    msgs = _merkle_messages(37)
    words, nblocks = S.pad_words(*_raw(msgs))
    want = R.prepare(msgs)
    assert words.dtype == torch.int32 and want.dtype == np.uint32
    assert tuple(words.shape) == want.shape == (37, 2, 16)
    assert np.array_equal(words.numpy().view(np.uint32), want)
    assert nblocks.tolist() == [2] * 37


def test_prepare_mixed_equals_reference():
    """Each message padded at its own block count: equal to the
    reference's prepare_mixed up to the block count, which the port does
    not round up to a power of two."""
    msgs = _mixed()
    gw, gn = S.pad_words(*_raw(msgs))
    ww, wn = R.prepare_mixed(msgs)
    assert gw.shape[1] == 65 and ww.shape[1] == 128      # 4096 B -> 65
    assert np.array_equal(gw.numpy().view(np.uint32), ww[:, :65])
    assert not ww[:, 65:].any()
    assert np.array_equal(gn.numpy(), wn.astype(np.int32))


def test_prepare_rejects_mixed_block_counts():
    """sha256_batch keeps the reference's contract: one block count."""
    with pytest.raises(ValueError, match="mixed block counts"):
        S.sha256_batch([b"short", b"x" * 100], CPU)


def test_plain_equals_reference_uniform_kernel():
    msgs = _merkle_messages(64) + [b"\x01" * 65]
    words = R.prepare(msgs)
    want = np.asarray(R.sha256_kernel(jnp.asarray(words)))
    got = S.plain_sha256(*_words(words, [words.shape[1]] * len(msgs)))
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_plain_equals_reference_masked_kernel():
    words, nblocks = R.prepare_mixed(_mixed())
    want = np.asarray(R.sha256_kernel_masked(jnp.asarray(words),
                                             jnp.asarray(nblocks)))
    got = S.plain_sha256(*_words(words, nblocks))
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_plain_freezes_lanes_past_their_block_count():
    """Block counts of 0 and beyond nb: the reference's masked kernel
    keeps the initial state for 0 and compresses all nb blocks for
    anything larger."""
    words, _ = R.prepare_mixed(_mixed()[:4])
    nblocks = np.array([0, 1, 7, 9], np.uint32)
    want = np.asarray(R.sha256_kernel_masked(jnp.asarray(words),
                                             jnp.asarray(nblocks)))
    got = S.plain_sha256(*_words(words, nblocks)).numpy().view(np.uint32)
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
    assert row["calls"] == 1 and row["batch_max"] == 5     # no padding
    assert breaker.snapshot()["successes"] == before + 1


def test_kernel_routing_refuses_other_devices():
    data = torch.zeros(4, dtype=torch.uint8, device="meta")
    offsets = torch.zeros(2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        S.sha256_kernel(data, offsets)


def test_cuda_wrapper_refuses_cpu_tensors():
    data, offsets = _raw(_mixed())
    before = sha256_cuda.LAUNCHES["sha256"]
    with pytest.raises(ValueError, match="CUDA tensor"):
        sha256_cuda.sha256_raw(data, offsets)
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


# ---- the raw-bytes contract: plain version vs reference and hashlib ----

RAW_LENGTHS = (0, 1, 55, 56, 63, 64, 119, 120, 4400)


@pytest.fixture(scope="module")
def raw_edge():
    msgs = _messages(RAW_LENGTHS, seed=7)
    return msgs, R.sha256_batch_mixed(msgs)


@pytest.mark.parametrize("lead", range(16))
def test_plain_raw_equals_reference_at_every_alignment(raw_edge, lead):
    """Lengths around every padding edge, the first message starting at
    each residue mod 16 (the rest follow at their own residues)."""
    msgs, want = raw_edge
    got = S.plain_sha256_raw(*_raw(msgs, lead))
    assert _hex(got) == [d.hex() for d in want]
    assert want == [hashlib.sha256(m).digest() for m in msgs]


@pytest.fixture(scope="module")
def ledger_windows():
    """A state-transfer window of 64 raw kvbcbench blocks, and one of the
    mixed sizes chip_smoke uses (block counts 5, 68 and 69)."""
    out = {}
    for name, kw in (("uniform", {}), ("mixed", {"big_every": 8})):
        bc = create_blockchain(MemoryDB(), use_device_hashing=False)
        bc.add_blocks([convert.block_updates(rows) for rows in
                       testing.kvbcbench_rows(64, **kw)])
        out[name] = [bc.get_raw_block(b) for b in range(1, 65)]
    return out


@pytest.mark.parametrize("window", ["uniform", "mixed"])
def test_plain_raw_equals_reference_on_ledger_windows(ledger_windows,
                                                      window):
    raws = ledger_windows[window]
    counts = {S.blocks_needed(len(r)) for r in raws}
    assert (len(counts) > 2) == (window == "mixed")
    want = R.sha256_batch_mixed(raws)
    words, nblocks = R.prepare_mixed(raws)
    masked = np.asarray(R.sha256_kernel_masked(jnp.asarray(words),
                                               jnp.asarray(nblocks)))
    got = S.plain_sha256_raw(*_raw(raws))
    assert _hex(got) == [d.hex() for d in want]
    assert got.numpy().tobytes() == masked.astype(">u4").tobytes()
    assert want == [hashlib.sha256(r).digest() for r in raws]
    assert S.sha256_batch_mixed(raws, CPU) == want


def test_plain_raw_equals_reference_on_a_merkle_level():
    msgs = _merkle_messages(300, seed=9)
    want = R.sha256_batch(msgs)
    assert _hex(S.plain_sha256_raw(*_raw(msgs))) == [d.hex() for d in want]
    assert want == [hashlib.sha256(m).digest() for m in msgs]


@pytest.mark.parametrize("case", ["non_monotone", "wrong_end", "negative"])
def test_plain_raw_refuses_bad_offsets(case):
    data, offsets = _raw(_messages([10, 20, 30]))
    bad = offsets.clone()
    if case == "non_monotone":
        bad[1], bad[2] = bad[2].item(), bad[1].item()
    elif case == "wrong_end":
        bad[-1] -= 1
    else:
        bad[0] = -1
    with pytest.raises(ValueError):
        S.plain_sha256_raw(data, bad)


def test_pack_is_one_join_and_a_cumulative_sum():
    msgs = _messages([3, 0, 70, 5])
    blob, offsets = S.pack(msgs)
    assert blob == b"".join(msgs)
    assert offsets.dtype == np.int64 and offsets.tolist() == [0, 3, 3, 73, 78]
    blob, offsets = S.pack([])
    assert blob == b"" and offsets.tolist() == [0]


def test_plain_raw_of_an_empty_batch():
    data, offsets = S.to_device(b"", np.zeros(1, np.int64), CPU)
    assert tuple(S.plain_sha256_raw(data, offsets).shape) == (0, 32)


# ---- the bound and the chain floor ----

def test_bound_counts_a_fixed_number_of_operations_per_compression():
    """64 rounds of 26 and 48 schedule steps of 13 32-bit operations, plus
    8 state adds, from the FIPS 180-4 formulation: no build involved."""
    assert sha256_cuda.OPS_PER_COMPRESSION == 64 * 26 + 48 * 13 + 8 == 2296
    lengths = [0, 55, 56, 119, 4400]          # 1, 1, 2, 2, 69 compressions
    ops, nbytes = sha256_cuda.work(lengths)
    assert ops == 75 * 2296
    assert nbytes == sum(lengths) + 8 * 6 + 32 * 5
    assert sha256_cuda.library.cache_info().currsize == 0


def test_chain_floor_follows_the_longest_message():
    lengths = [100, 4400, 300]               # 69 compressions at most
    ms = sha256_cuda.chain_floor_ms(lengths, 1980.0)
    assert ms == pytest.approx(69 * 64 * sha256_cuda.ROUND_CYCLES / 1.98e6)
