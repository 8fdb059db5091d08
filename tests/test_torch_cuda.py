"""The CUDA kernels of the port on a card: the verify kernel against the
plain PyTorch version and the host scalar engine, the field kernels
(fe_mul, and fe_inv in both of its designs) against Python ints, the SHA-256 kernel against hashlib and its plain
version, and the bring-up kernels against theirs. Marked `cuda`; each test
skips where no card is present (run on the card:
python -m pytest --noconftest tests/test_torch_cuda.py).
"""
import hashlib

import numpy as np
import pytest
import torch

from tpubft_torch import testing
from tpubft_torch.crypto import scalar
from tpubft_torch.ops import bringup_cuda as bu
from tpubft_torch.ops import ed25519 as ops
from tpubft_torch.ops import ed25519_cuda as kc
from tpubft_torch.ops import f25519 as F
from tpubft_torch.ops import sha256 as sha
from tpubft_torch.ops import sha256_cuda
from tpubft_torch.tools import bringup

# one intra-op thread: these tests run many tiny tensor ops, and several
# test workers share the host's cores
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("batch", [1, 3, 33, 100, 192, 1024])
def test_verify_kernel_matches_plain_and_scalar(card, batch):
    items = testing.ed25519_corpus(batch, seed=batch)
    prep = ops.prepare_batch(items)
    args = ops.to_tensors(ops._pad_rows(prep, batch, batch), card)
    before = kc.LAUNCHES["ed25519_verify"]
    got = ops.verify_kernel(*args).cpu().numpy()
    assert kc.LAUNCHES["ed25519_verify"] == before + 1
    assert np.array_equal(got, ops.plain_verify_kernel(*args).cpu().numpy())
    want = [scalar.ed25519_verify(pk, m, s) for m, s, pk in items]
    assert (got & prep.host_valid).tolist() == want
    assert ops.verify_batch(items, device=card).tolist() == want


def test_verify_kernel_on_raw_lanes(card):
    """y >= p for A or R, which the host never sends: the kernel's raw
    verdicts equal the plain version's."""
    arrays, want = testing.raw_kernel_lanes()
    args = ops.to_tensors(arrays, card)
    assert kc.verify(*args).cpu().tolist() == want
    assert ops.plain_verify_kernel(*args).cpu().tolist() == want


def test_copy_kernel_at_2p20_lanes(card):
    a = torch.randint(0, 1 << 26, (F.NL, 1 << 20), dtype=torch.int32,
                      device=card)
    assert torch.equal(bu.bringup_copy(a), bu.plain_copy(a))
    # a view one word in: not 16-byte aligned, the scalar path
    flat = torch.arange(F.NL * 1000 + 1, dtype=torch.int32, device=card)
    off = flat[1:].view(F.NL, 1000)
    assert torch.equal(bu.bringup_copy(off), bu.plain_copy(off))


def test_field_kernels_match_python_ints(card):
    rng = np.random.default_rng(0)
    va = [int.from_bytes(rng.bytes(32), "little") % F.P for _ in range(512)]
    vb = [int.from_bytes(rng.bytes(32), "little") % F.P for _ in range(512)]
    ta = torch.from_numpy(np.stack([F.int_to_limbs(v) for v in va], 1))
    tb = torch.from_numpy(np.stack([F.int_to_limbs(v) for v in vb], 1))
    mul = kc.fe_mul(ta.to(card), tb.to(card)).cpu().numpy()
    inv = bu.fe_inv(ta.to(card)).cpu().numpy()
    for i in range(512):
        assert np.array_equal(mul[:, i], F.int_to_limbs(va[i] * vb[i]))
        assert np.array_equal(inv[:, i],
                              F.int_to_limbs(pow(va[i], F.P - 2, F.P)))


@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("n", [1, 3, 33, 1024, 1 << 17])
def test_fe_inv_ragged_and_edges(card, n, lanes):
    """Both designs at ragged sizes (a partial group, warp and block), the
    edge cases 0, 1, 2, 19, p-1, (p-1)/2 first: every lane against
    Python ints up to 1024 (a strided sample of 257 above), and against
    the plain version on the first 1024."""
    from tpubft_torch.tools import fe_inv_probe
    a_np = fe_inv_probe.elements(n, seed=n)
    a = torch.from_numpy(a_np).to(card)
    before = bu.LAUNCHES["fe_inv"], bu.FE_INV_LANES[lanes]
    got = bu._fe_inv(a, lanes)
    assert (bu.LAUNCHES["fe_inv"], bu.FE_INV_LANES[lanes]) == (
        before[0] + 1, before[1] + 1)
    got_np = got.cpu().numpy()
    assert fe_inv_probe.sample_mismatches(
        a_np, got_np, samples=n if n <= 1024 else 257) == 0
    m = min(n, 1024)
    plain = bringup._plain_inv(a[:, :m].contiguous()).cpu().numpy()
    assert np.array_equal(got_np[:, :m], plain)


def test_fe_inv_lanes_rule_on_this_card(card):
    """The public wrapper runs four lanes an element up to 32 x SMs and one
    above, as the launcher reports it, and both designs agree."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    a = torch.from_numpy(bringup._rand_elems(np.random.default_rng(1),
                                             32 * sms + 1)).to(card)
    small, large = a[:, :32 * sms].contiguous(), a
    assert bu.lanes_for(small.shape[1], sms) == 4
    assert bu.lanes_for(large.shape[1], sms) == 1
    bu.reset_launches()
    got_small = bu.fe_inv(small)
    assert bu.FE_INV_LANES == {4: 1, 1: 0}
    got_large = bu.fe_inv(large)
    assert bu.FE_INV_LANES == {4: 1, 1: 1}
    assert torch.equal(got_small, bu._fe_inv(small, 1))
    assert torch.equal(got_large[:, :32 * sms], bu._fe_inv(small, 4))


def _sha_messages(batch, mixed):
    """Merkle nodes (65 bytes: every start residue mod 4 and 16), or
    lengths around the padding edges, up to 69 blocks at small batch."""
    rng = np.random.default_rng(batch)
    if not mixed:
        return [b"\x01" + rng.bytes(64) for _ in range(batch)]
    sizes = [0, 1, 55, 56, 63, 64, 119, 120, 300]
    if batch <= 1024:
        sizes.append(4400)
    return [rng.bytes(sizes[i % len(sizes)]) for i in range(batch)]


@pytest.mark.parametrize("mixed", [False, True], ids=["uniform", "mixed"])
@pytest.mark.parametrize("batch", [1, 3, 33, 64, 1024, 16384])
def test_sha256_kernel_matches_hashlib_and_plain(card, batch, mixed):
    msgs = _sha_messages(batch, mixed)
    blob, offsets = sha.pack(msgs)
    data, offs = sha.to_device(blob, offsets, card)
    assert data.data_ptr() % 4 == 0
    before = sha256_cuda.LAUNCHES["sha256"]
    got = sha.sha256_kernel(data, offs)
    assert sha256_cuda.LAUNCHES["sha256"] == before + 1
    assert torch.equal(got, sha.plain_sha256_raw(data, offs))
    want = [hashlib.sha256(m).digest() for m in msgs]
    raw = got.cpu().numpy().tobytes()
    assert [raw[i:i + 32] for i in range(0, len(raw), 32)] == want
    assert sha.sha256_batch_mixed(msgs, device=card) == want


@pytest.mark.parametrize("case", ["cpu", "dtype", "non_monotone",
                                  "wrong_end", "host_wrong_end"])
def test_sha256_wrapper_refuses_bad_offsets(card, case):
    blob, offsets = sha.pack(_sha_messages(33, True))
    data, offs = sha.to_device(blob, offsets, card)
    host = None
    if case == "cpu":
        offs = offs.cpu()
    elif case == "dtype":
        offs = offs.to(torch.int32)
    elif case == "non_monotone":
        offs = offs.clone()
        offs[[5, 6]] = offs[[6, 5]]
    elif case == "wrong_end":
        offs = offs.clone()
        offs[-1] -= 1
    else:
        host = offsets.copy()
        host[-1] -= 1
    before = sha256_cuda.LAUNCHES["sha256"]
    with pytest.raises(ValueError):
        sha256_cuda.sha256_raw(data, offs, host)
    assert sha256_cuda.LAUNCHES["sha256"] == before


@pytest.mark.parametrize("rung", [0, 1, 4])
def test_bringup_kernels_match_plain_and_ints(card, rung):
    before = dict(bu.LAUNCHES)
    r = bringup.RUNGS[rung](np.random.default_rng(rung), card, 1000)
    assert r.ok, r.report
    assert sum(bu.LAUNCHES.values()) == sum(before.values()) + 1


def test_table_gather_with_a_random_constant(card):
    rng = np.random.default_rng(5)
    a = torch.from_numpy(bringup._rand_elems(rng, 300)).to(card)
    col = torch.from_numpy(bringup._rand_elems(rng, 1)[:, 0].copy()).to(card)
    assert torch.equal(bu.fe_table_gather(a, col),
                       bu.plain_table_gather(a, col))


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity"])
def test_wrappers_refuse_bad_cuda_tensors(card, case):
    good = torch.zeros((F.NL, 64), dtype=torch.int32, device=card)
    bad = {"dtype": good.to(torch.int64), "shape": good[:12].contiguous(),
           "contiguity": good.t().contiguous().t()}[case]
    data = torch.zeros(256, dtype=torch.uint8, device=card)
    offsets = torch.tensor([0, 64, 128], dtype=torch.int64, device=card)
    bad_data = {"dtype": data.to(torch.int32)[:128],
                "shape": data.view(2, 128),
                "contiguity": data[::2]}[case]
    for call in (lambda: bu.bringup_copy(bad), lambda: bu.fe_carry(bad),
                 lambda: bu.fe_inv(bad),
                 lambda: bu.fe_table_gather(bad, good[:, 0].contiguous()),
                 lambda: sha256_cuda.sha256_raw(bad_data, offsets)):
        with pytest.raises(ValueError):
            call()


def test_sha256_roundtrip_refuses_bad_staging(card):
    """The host half's one-call round trip takes uint8 host buffers whose
    head holds batch+1 offsets; anything else raises before the card."""
    blob, offsets = sha.pack(_sha_messages(3, True))
    pinned = torch.empty(offsets.nbytes + len(blob), dtype=torch.uint8,
                         pin_memory=True)
    pinned[:offsets.nbytes] = torch.from_numpy(offsets.view(np.uint8))
    pinned[offsets.nbytes:] = torch.frombuffer(bytearray(blob),
                                               dtype=torch.uint8)
    out = torch.empty(96, dtype=torch.uint8, pin_memory=True)
    before = sha256_cuda.LAUNCHES["sha256"]
    for args in ((pinned.view(torch.int8), offsets.nbytes, out, 3),
                 (pinned.to(card), offsets.nbytes, out, 3),
                 (pinned, offsets.nbytes - 8, out, 3),         # short head
                 (pinned, offsets.nbytes, out[:64], 3)):       # short out
        with pytest.raises(ValueError):
            sha256_cuda.sha256_roundtrip(*args, card)
    assert sha256_cuda.LAUNCHES["sha256"] == before
    sha256_cuda.sha256_roundtrip(pinned, offsets.nbytes, out, 3, card)
    assert out.numpy().tobytes() == b"".join(
        hashlib.sha256(m).digest() for m in _sha_messages(3, True))
    assert sha256_cuda.LAUNCHES["sha256"] == before + 1
