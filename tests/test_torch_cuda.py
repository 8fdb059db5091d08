"""The CUDA kernels of the port on a card: the verify kernel against the
plain PyTorch version and the host scalar engine, and the field test
kernels against Python ints. Marked `cuda`; each test skips where no card
is present (run on the card: python -m pytest tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

from tpubft_torch import testing
from tpubft_torch.crypto import scalar
from tpubft_torch.ops import ed25519 as ops
from tpubft_torch.ops import ed25519_cuda as kc
from tpubft_torch.ops import f25519 as F

# one intra-op thread: these tests run many tiny tensor ops, and several
# test workers share the host's cores
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("batch", [1, 100, 1024])
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


def test_field_kernels_match_python_ints(card):
    rng = np.random.default_rng(0)
    va = [int.from_bytes(rng.bytes(32), "little") % F.P for _ in range(512)]
    vb = [int.from_bytes(rng.bytes(32), "little") % F.P for _ in range(512)]
    ta = torch.from_numpy(np.stack([F.int_to_limbs(v) for v in va], 1))
    tb = torch.from_numpy(np.stack([F.int_to_limbs(v) for v in vb], 1))
    mul = kc.fe_mul(ta.to(card), tb.to(card)).cpu().numpy()
    inv = kc.fe_inv(ta.to(card)).cpu().numpy()
    for i in range(512):
        assert np.array_equal(mul[:, i], F.int_to_limbs(va[i] * vb[i]))
        assert np.array_equal(inv[:, i],
                              F.int_to_limbs(pow(va[i], F.P - 2, F.P)))
