"""Batched SHA-256 (port of tpubft/ops/sha256.py).

A batch of messages is padded on the host (FIPS 180-4) into big-endian
32-bit words and hashed in one device call. On the card the call is the
hand-written CUDA kernel (ops/sha256_cuda.py, csrc/sha256.cu); for CPU
tensors it is `plain_sha256`, the plain PyTorch version the kernel is
held against.

Layout, as in the reference: words (B, nb, 16) — message i's block j is
words[i, j], each entry one big-endian 32-bit word as an integer — and
digests (B, 8). The host half works in numpy uint32 exactly like the
reference; on a device the same bits ride an int32 tensor.

One contract serves both of the reference's kernels: `nblocks` (B,)
gives each lane's own block count, and a lane stops compressing after
it. The uniform path (`sha256_kernel` of the reference) passes
nblocks = nb for every lane; the mixed path (`sha256_kernel_masked`)
passes each message's count, with its words FIPS-padded at that count
and zero-filled to nb.

Users: the sparse Merkle tree's level hashing (kvbc/sparse_merkle.py)
and state-transfer window digests (statetransfer/digests.py). Batches
are padded to the next power of two, as in the reference. The
reference's mesh tier (sharding a batch across chips) is not ported.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpubft_torch import device as _device

K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2], dtype=np.uint32)

H0 = np.array([0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
               0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19],
              dtype=np.uint32)

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------
# host half (numpy, byte-identical to the reference)
# ---------------------------------------------------------------------

def _pad_bytes(msg: bytes, nblocks: int) -> bytes:
    bitlen = len(msg) * 8
    data = msg + b"\x80"
    data += b"\x00" * (nblocks * 64 - 8 - len(data))
    data += bitlen.to_bytes(8, "big")
    assert len(data) == nblocks * 64
    return data


def _pad_to_words(msg: bytes, nblocks: int) -> np.ndarray:
    return np.frombuffer(_pad_bytes(msg, nblocks), dtype=">u4").astype(
        np.uint32).reshape(nblocks, 16)


def blocks_needed(msg_len: int) -> int:
    return (msg_len + 8) // 64 + 1


def prepare(messages: Sequence[bytes]) -> np.ndarray:
    """Pad a batch of messages to a common block count -> (B, nb, 16)
    uint32. All messages must need the same number of blocks."""
    nb = blocks_needed(max(len(m) for m in messages))
    for m in messages:
        if blocks_needed(len(m)) != nb:
            raise ValueError("mixed block counts in one batch")
    data = b"".join(_pad_bytes(m, nb) for m in messages)
    return np.frombuffer(data, dtype=">u4").astype(np.uint32).reshape(
        len(messages), nb, 16)


def prepare_mixed(messages: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a mixed-size batch: each message FIPS-padded at its own block
    count, zero-filled to a common count rounded up to a power of two.
    -> (words (B, nb, 16) uint32, nblocks (B,) uint32)."""
    nbs = [blocks_needed(len(m)) for m in messages]
    nb_max = 1 << (max(nbs) - 1).bit_length()
    words = np.zeros((len(messages), nb_max, 16), dtype=np.uint32)
    for i, (m, nb) in enumerate(zip(messages, nbs)):
        words[i, :nb] = _pad_to_words(m, nb)
    return words, np.asarray(nbs, dtype=np.uint32)


def digest_words_to_bytes(dw: np.ndarray) -> List[bytes]:
    return [row.astype(">u4").tobytes() for row in np.asarray(dw)]


def to_tensors(words: np.ndarray, nblocks: np.ndarray,
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host arrays -> the kernel's inputs on `device`: words as an int32
    tensor with the same bits, nblocks as int32."""
    w = torch.from_numpy(np.ascontiguousarray(words, np.uint32)
                         .view(np.int32))
    nb = torch.from_numpy(np.ascontiguousarray(nblocks).astype(np.int32))
    return w.to(device), nb.to(device)


def digests_from_tensor(out: torch.Tensor) -> np.ndarray:
    """(B, 8) int32 digest tensor -> (B, 8) uint32 host array."""
    return out.cpu().numpy().view(np.uint32)


# ---------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------

def _rotations(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """x (B,) rotated right by each of `shifts` (k, 1) at once -> (k, B),
    with garbage above bit 31 (callers mask once after combining)."""
    return (x >> shifts) | (x << (32 - shifts))


def plain_sha256(words: torch.Tensor, nblocks: torch.Tensor
                 ) -> torch.Tensor:
    """SHA-256 of every lane: words (B, nb, 16) int32 (big-endian word
    bits), nblocks (B,) -> (B, 8) int32 digest words. Lane i compresses
    its first min(nblocks[i], nb) blocks.

    Computes in int64 holding unsigned 32-bit values: every value that
    is shifted, rotated or carried into the next round is masked to 32
    bits first (a left shift of such a value by at most 30 bits stays
    below 2^63, and the unmasked sums of at most five of them below
    2^35), so no step depends on signed int32 wrap-around. The
    rotations of one Sigma are taken together as one (3, B) tensor."""
    dev = words.device
    b, nb = words.shape[0], words.shape[1]
    w_all = words.to(torch.int64) & _M32
    counts = nblocks.to(torch.int64)
    k = [int(v) for v in K]

    def rots(*shifts):
        return torch.tensor(shifts, dtype=torch.int64,
                            device=dev).reshape(-1, 1)

    sig1, sig0 = rots(6, 11, 25), rots(2, 13, 22)
    ssig0, ssig1 = rots(7, 18), rots(17, 19)
    state = [torch.full((b,), int(h), dtype=torch.int64, device=dev)
             for h in H0]
    for j in range(nb):
        w = [w_all[:, j, t] for t in range(16)]
        for t in range(16, 64):
            r0 = _rotations(w[t - 15], ssig0)
            r1 = _rotations(w[t - 2], ssig1)
            s0 = r0[0] ^ r0[1] ^ (w[t - 15] >> 3)
            s1 = r1[0] ^ r1[1] ^ (w[t - 2] >> 10)
            w.append((w[t - 16] + (s0 & _M32) + w[t - 7] + (s1 & _M32))
                     & _M32)
        a, bb, c, d, e, f, g, h = state
        for t in range(64):
            r = _rotations(e, sig1)
            s1 = (r[0] ^ r[1] ^ r[2]) & _M32
            ch = (e & f) ^ (~e & g)
            t1 = h + s1 + ch + k[t] + w[t]
            r = _rotations(a, sig0)
            s0 = (r[0] ^ r[1] ^ r[2]) & _M32
            maj = (a & (bb | c)) | (bb & c)
            h, g, f, e = g, f, e, (d + t1) & _M32
            d, c, bb, a = c, bb, a, (t1 + s0 + maj) & _M32
        keep = j < counts
        state = [torch.where(keep, (s + v) & _M32, s)
                 for s, v in zip(state, (a, bb, c, d, e, f, g, h))]
    out = torch.stack(state, dim=1)
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


def sha256_kernel(words: torch.Tensor, nblocks: torch.Tensor
                  ) -> torch.Tensor:
    """Route by device: CUDA tensors launch the Hopper kernel (which
    raises if it cannot), CPU tensors run the plain version."""
    dev = words.device
    if dev.type == "cuda":
        from tpubft_torch.ops import sha256_cuda
        return sha256_cuda.sha256(words, nblocks)
    if dev.type == "cpu":
        return plain_sha256(words, nblocks)
    raise ValueError(f"sha256_kernel: no kernel for device {dev}")


# ---------------------------------------------------------------------
# batch entry points
# ---------------------------------------------------------------------

def _launch(words: np.ndarray, nblocks: np.ndarray, n: int,
            device: torch.device) -> List[bytes]:
    from tpubft_torch.ops.dispatch import device_section
    with device_section("sha256", batch=words.shape[0]):
        out = sha256_kernel(*to_tensors(words, nblocks, device))
        return digest_words_to_bytes(digests_from_tensor(out))[:n]


def sha256_batch(messages: Sequence[bytes],
                 device: Optional[torch.device] = None) -> List[bytes]:
    """Hash a batch of same-block-count messages in one device call on
    `device` (default: the card). The batch is padded to the next power
    of two with copies of the first message."""
    if not messages:
        return []
    n = len(messages)
    m = 1 << (n - 1).bit_length()
    words = prepare(list(messages) + [messages[0]] * (m - n))
    nblocks = np.full(m, words.shape[1], dtype=np.uint32)
    return _launch(words, nblocks, n, _device.resolve(device))


def sha256_batch_mixed(messages: Sequence[bytes],
                       device: Optional[torch.device] = None
                       ) -> List[bytes]:
    """Hash a batch of messages of any sizes in one device call.
    Same-block-count batches take the uniform path."""
    if not messages:
        return []
    n = len(messages)
    if len({blocks_needed(len(m)) for m in messages}) == 1:
        return sha256_batch(messages, device)
    m = 1 << (n - 1).bit_length()
    words, nblocks = prepare_mixed(list(messages) + [messages[0]] * (m - n))
    return _launch(words, nblocks, n, _device.resolve(device))
