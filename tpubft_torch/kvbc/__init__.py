"""KVBC — the ledger layer of the port (port of tpubft/kvbc): the
categorized key-value blockchain over the storage layer, with a sparse
Merkle tree for state proofs whose level hashing goes through the batched
SHA-256 kernel (ops/sha256.py); the v4 engine (latest keys, no Merkle
trees) and the v1 direct-KV engine (a migration source) behind the same
facade."""
from tpubft_torch.kvbc.blockchain import KeyValueBlockchain
from tpubft_torch.kvbc.categories import (BLOCK_MERKLE, IMMUTABLE,
                                          VERSIONED_KV, BlockUpdates,
                                          CategoryUpdates)
from tpubft_torch.kvbc.sparse_merkle import SparseMerkleTree
from tpubft_torch.kvbc.v4 import V4KeyValueBlockchain


def create_blockchain(db, version: str = "categorized",
                      use_device_hashing: bool = True):
    """Engine-selecting facade (tpubft/kvbc/__init__.py; concord-bft's
    kvbc_adapter): one call site picks the categorized engine
    (multi-version reads + sparse-Merkle proofs), the v4 engine
    (latest-keys-native, write-optimized) or the v1 direct-KV engine
    behind the same interface. Only the categorized engine has device
    work to route."""
    if version in ("categorized", "v2"):
        return KeyValueBlockchain(db, use_device_hashing=use_device_hashing)
    if version == "v4":
        return V4KeyValueBlockchain(db)
    if version in ("v1", "direct"):
        from tpubft_torch.kvbc.v1 import DirectKVBlockchain
        return DirectKVBlockchain(db)
    raise ValueError(f"unknown kvbc version {version!r}")


__all__ = ["KeyValueBlockchain", "V4KeyValueBlockchain", "create_blockchain",
           "SparseMerkleTree", "BlockUpdates", "CategoryUpdates",
           "BLOCK_MERKLE", "VERSIONED_KV", "IMMUTABLE"]
