"""tpubft_torch — the PyTorch/CUDA port of tpubft.

The JAX package `tpubft` is the reference and stays as it is; this
package imports nothing of it (nor JAX). Each slice of the port is held
against the reference at the public boundary: verdict vectors, key
material, certificate bytes, digests, ledger rows, and the replica's
wire bytes and replies. The slices so far are config 1's replica core
with its client stack and in-process cluster (consensus/, bftclient/,
comm/, testing/), config 1's signature plane (SigManager and the
multisig-ed25519 cryptosystem down to the CUDA Ed25519 verify kernel,
ops/csrc/ed25519_verify.cu) and its ledger's hashing path (the
categorized KVBC ledger and sparse Merkle tree down to the CUDA SHA-256
kernel, ops/csrc/sha256.cu), plus the bring-up ladder of tools/bringup.py.
"""
