"""tpubft_torch — the PyTorch/CUDA port of tpubft.

The JAX package `tpubft` is the reference and stays as it is; this
package imports nothing of it (nor JAX). Each slice of the port is held
against the reference at the public boundary: verdict vectors, key
material, certificate bytes. The first slice is the config-1 signature
plane: SigManager and the multisig-ed25519 cryptosystem down to a
hand-written CUDA Ed25519 verify kernel for Hopper (ops/ed25519_cuda.py,
ops/csrc/ed25519_verify.cu).
"""
