"""KVBC — the ledger layer of the port (port of tpubft/kvbc): the
categorized key-value blockchain over the storage layer, with a sparse
Merkle tree for state proofs whose level hashing goes through the batched
SHA-256 kernel (ops/sha256.py). The v4 and v1 engines wait for their
slices."""
from tpubft_torch.kvbc.blockchain import KeyValueBlockchain
from tpubft_torch.kvbc.categories import (BLOCK_MERKLE, IMMUTABLE,
                                          VERSIONED_KV, BlockUpdates,
                                          CategoryUpdates)
from tpubft_torch.kvbc.sparse_merkle import SparseMerkleTree


def create_blockchain(db, version: str = "categorized",
                      use_device_hashing: bool = True):
    """Engine-selecting facade (tpubft/kvbc/__init__.py): the categorized
    engine for "categorized" / "v2"; "v4" and "v1" / "direct" are not
    ported yet."""
    if version in ("categorized", "v2"):
        return KeyValueBlockchain(db, use_device_hashing=use_device_hashing)
    if version in ("v4", "v1", "direct"):
        raise NotImplementedError(
            f"kvbc engine {version!r} is not ported to tpubft_torch yet")
    raise ValueError(f"unknown kvbc version {version!r}")


__all__ = ["KeyValueBlockchain", "create_blockchain", "SparseMerkleTree",
           "BlockUpdates", "CategoryUpdates", "BLOCK_MERKLE", "VERSIONED_KV",
           "IMMUTABLE"]
