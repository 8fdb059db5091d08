"""The port's sparse Merkle tree (tpubft_torch/kvbc/sparse_merkle.py)
against the reference (tpubft/kvbc/sparse_merkle.py) on the same updates,
byte for byte: roots, latest and versioned proofs, archive pruning and
every DB row.

`_DEVICE_THRESHOLD` is lowered to 8 in both packages, so the levels of
these small trees take the device path: the reference's jitted SHA-256
under JAX on the CPU, the port's plain PyTorch version on CPU tensors.
"""
import hashlib

import numpy as np
import pytest
import torch

from tpubft.kvbc import sparse_merkle as RSM
from tpubft.storage.memorydb import MemoryDB as RMemoryDB
from tpubft_torch import device
from tpubft_torch.kvbc import sparse_merkle as SM
from tpubft_torch.storage import MemoryDB

# one intra-op thread: these tests run many tiny tensor ops, and several
# test workers share the host's cores
torch.set_num_threads(1)


@pytest.fixture
def device_levels(monkeypatch):
    monkeypatch.setattr(RSM, "_DEVICE_THRESHOLD", 8)
    monkeypatch.setattr(SM, "_DEVICE_THRESHOLD", 8)
    device.set_default_device("cpu")
    SM.DEGRADED = 0
    yield
    device.set_default_device(None)


def _rows(db):
    return list(db.scan_all())


def _proof(p):
    return p.bitmap, p.siblings


def _updates(rng, n, deletes=()):
    out = {}
    for i in rng.choice(200, size=n, replace=False):
        out[b"key-%d" % i] = hashlib.sha256(b"v-%d" % i).digest()
    for k in deletes:
        out[k] = None
    return out


def test_tree_roots_proofs_and_rows_equal_reference(device_levels):
    rdb, pdb = RMemoryDB(), MemoryDB()
    rt = RSM.SparseMerkleTree(rdb, use_device=True)
    pt = SM.SparseMerkleTree(pdb, use_device=True)
    rng = np.random.default_rng(0)
    first = _updates(rng, 24)
    rounds = [first, _updates(rng, 10, deletes=list(first)[:4])]
    for version, ups in enumerate(rounds, start=1):
        assert pt.update_batch(dict(ups), version=version) == \
            rt.update_batch(dict(ups), version=version)
    assert _rows(pdb) == _rows(rdb)
    keys = list(first)[:8] + [b"absent"]
    for key in keys:
        assert _proof(pt.prove(key)) == _proof(rt.prove(key))
        for version in (1, 2):
            got = pt.prove_at(key, version)
            assert _proof(got) == _proof(rt.prove_at(key, version))
            root = pt.root_at(version)
            assert root == rt.root_at(version)
            vh = pt.get_value_hash_at(key, version)
            assert SM.SparseMerkleTree.verify(root, key, vh, got)
    assert pt.prune_versions(2) == rt.prune_versions(2) > 0
    assert _rows(pdb) == _rows(rdb)
    assert SM.DEGRADED == 0


def test_update_batches_equals_reference(device_levels):
    rdb, pdb = RMemoryDB(), MemoryDB()
    rt = RSM.SparseMerkleTree(rdb, use_device=True)
    pt = SM.SparseMerkleTree(pdb, use_device=True)
    rng = np.random.default_rng(1)
    blocks = [_updates(rng, 10) for _ in range(4)]
    blocks[3][next(iter(blocks[0]))] = None          # a later delete
    assert pt.update_batches(blocks, first_version=1) == \
        rt.update_batches(blocks, first_version=1)
    assert _rows(pdb) == _rows(rdb)
