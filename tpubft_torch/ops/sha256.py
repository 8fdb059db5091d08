"""Batched SHA-256 (port of tpubft/ops/sha256.py).

Contract: the messages of a batch travel as raw bytes, `data` uint8 (N,)
holding them concatenated and `offsets` int64 (B+1,) their boundaries
(message i is data[offsets[i]:offsets[i+1]]); the result is (B, 32) uint8
big-endian digests. `sha256_kernel` routes by device: on the card the
hand-written CUDA kernel (ops/sha256_cuda.py, csrc/sha256.cu), which pads
and byte-swaps on the card; for CPU tensors `plain_sha256_raw`, the plain
PyTorch version the kernel is held against. That one builds the
reference's layout with tensor ops (`pad_words`: FIPS 180-4 padding into
big-endian words (B, nb, 16), each message at its own block count) and
runs `plain_sha256`, the compression of both of the reference's kernels
(sha256_kernel and sha256_kernel_masked: lane i compresses its first
nblocks[i] blocks).

The host half (`sha256_batch`, `sha256_batch_mixed`) is one join of the
messages, offsets from a cumulative sum, one copy into a pinned staging
buffer, then one C call (sha256_cuda.sha256_roundtrip): one
host-to-device copy of offsets and bytes together, the launch, one
device-to-host copy of the digests into pinned memory and one
synchronisation; `COPIES` counts the copies and their bytes. For CPU
tensors the same steps run through `to_device`, `sha256_kernel` and
`from_device`, which also stage tensors for a caller of the kernel's own
contract. No batch or block count is rounded up: that bounded the
reference's compiled XLA shapes, and the digests are the same without it.

Users: the sparse Merkle tree's level hashing (kvbc/sparse_merkle.py)
and state-transfer window digests (statetransfer/digests.py). The
reference's mesh tier (sharding a batch across chips) is not ported.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

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




def blocks_needed(msg_len: int) -> int:
    return (msg_len + 8) // 64 + 1


def check_offsets(offsets: np.ndarray, nbytes: int) -> None:
    """Raise ValueError unless offsets (B+1,) are non-negative,
    non-decreasing and end at nbytes."""
    if offsets.ndim != 1 or len(offsets) < 1:
        raise ValueError("offsets must have B+1 >= 1 entries")
    if int(offsets[-1]) != nbytes:
        raise ValueError(f"offsets end at {int(offsets[-1])}, data holds "
                         f"{nbytes} bytes")
    if int(offsets[0]) < 0 or bool((offsets[1:] < offsets[:-1]).any()):
        raise ValueError("offsets must be non-negative and non-decreasing")


def pad_words(data: torch.Tensor, offsets: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's kernel inputs from raw bytes, with tensor ops:
    every message FIPS 180-4 padded at its own block count and
    zero-filled to the batch's largest -> (words (B, nb, 16) int32 with
    the bits of big-endian words, nblocks (B,) int32)."""
    dev = data.device
    starts = offsets[:-1].to(torch.int64)
    lens = offsets[1:].to(torch.int64) - starts
    b = lens.numel()
    nblocks = (lens + 8) // 64 + 1
    nb = int(nblocks.max()) if b else 0
    pos = torch.arange(nb * 64, device=dev)
    inside = pos < lens[:, None]
    byte = torch.zeros((b, nb * 64), dtype=torch.int64, device=dev)
    if data.numel():
        idx = (starts[:, None] + pos).clamp(max=data.numel() - 1)
        byte = torch.where(inside, data[idx].to(torch.int64), byte)
    byte = torch.where(pos == lens[:, None], 0x80, byte)
    k = pos - (nblocks[:, None] * 64 - 8)          # byte of the bit length
    in_len = (k >= 0) & (k < 8)
    len_byte = ((lens[:, None] * 8) >> (8 * (7 - k.clamp(0, 7)))) & 0xFF
    byte = torch.where(in_len, len_byte, byte)
    q = byte.reshape(b, nb * 16, 4)
    words = (q[..., 0] << 24) | (q[..., 1] << 16) | (q[..., 2] << 8) | q[..., 3]
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32).reshape(b, nb, 16), nblocks.to(torch.int32)


def digest_bytes(digest_words: torch.Tensor) -> torch.Tensor:
    """(B, 8) int32 digest words -> (B, 32) uint8 big-endian digests."""
    w = digest_words.to(torch.int64) & _M32
    return torch.stack([(w >> s) & 0xFF for s in (24, 16, 8, 0)],
                       dim=-1).reshape(-1, 32).to(torch.uint8)


def plain_sha256_raw(data: torch.Tensor, offsets: torch.Tensor
                     ) -> torch.Tensor:
    """The plain version of the kernel's contract: data uint8 (N,),
    offsets int64 (B+1,) -> (B, 32) uint8 digests."""
    check_offsets(offsets.cpu().numpy(), data.numel())
    if offsets.numel() == 1:
        return torch.empty((0, 32), dtype=torch.uint8, device=data.device)
    return digest_bytes(plain_sha256(*pad_words(data, offsets)))


def sha256_kernel(data: torch.Tensor, offsets: torch.Tensor,
                  host_offsets: Optional[np.ndarray] = None
                  ) -> torch.Tensor:
    """Route by device: CUDA tensors launch the Hopper kernel (which
    raises if it cannot), CPU tensors run the plain version."""
    dev = data.device
    if dev.type == "cuda":
        from tpubft_torch.ops import sha256_cuda
        return sha256_cuda.sha256_raw(data, offsets, host_offsets)
    if dev.type == "cpu":
        return plain_sha256_raw(data, offsets)
    raise ValueError(f"sha256_kernel: no kernel for device {dev}")


# ---------------------------------------------------------------------
# the host half
# ---------------------------------------------------------------------

# copies between host and card made by this module
COPIES: Dict[str, int] = {"h2d": 0, "h2d_bytes": 0, "d2h": 0,
                          "d2h_bytes": 0}


class _Pinned:
    """A pinned host buffer reused across calls and grown as needed. Used
    only by `_roundtrip`, which synchronises before it returns, under the
    device gate."""

    def __init__(self) -> None:
        self._buf: Optional[torch.Tensor] = None

    def take(self, nbytes: int) -> torch.Tensor:
        if self._buf is None or self._buf.numel() < nbytes:
            size = max(nbytes, 1 << 16,
                       0 if self._buf is None else 2 * self._buf.numel())
            self._buf = torch.empty(size, dtype=torch.uint8,
                                    pin_memory=True)
        return self._buf[:nbytes]


_h2d = _Pinned()
_d2h = _Pinned()


def pack(messages: Sequence[bytes]) -> Tuple[bytes, np.ndarray]:
    """The batch as the kernel takes it: the messages joined, and their
    boundaries (B+1,) int64 by a cumulative sum of their lengths."""
    offsets = np.zeros(len(messages) + 1, dtype=np.int64)
    np.cumsum(np.fromiter(map(len, messages), np.int64, len(messages)),
              out=offsets[1:])
    return b"".join(messages), offsets


def to_device(blob: bytes, offsets: np.ndarray, device: torch.device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(data, offsets) tensors on `device` for the kernel's own contract,
    offsets and bytes sent in one copy."""
    head = offsets.nbytes
    host = np.empty(head + len(blob), dtype=np.uint8)
    host[:head] = offsets.view(np.uint8)
    host[head:] = np.frombuffer(blob, np.uint8)
    buf = torch.from_numpy(host).to(device)
    if device.type == "cuda":
        COPIES["h2d"] += 1
        COPIES["h2d_bytes"] += host.size
    return buf[head:], buf[:head].view(torch.int64)


def from_device(out: torch.Tensor) -> bytes:
    """The (B, 32) digests as one bytes object, in one copy."""
    if out.device.type == "cuda":
        COPIES["d2h"] += 1
        COPIES["d2h_bytes"] += out.numel()
    return out.cpu().numpy().tobytes()


def _roundtrip(blob: bytes, offsets: np.ndarray, dev: torch.device
               ) -> bytes:
    """The batch staged in pinned memory and hashed on the card in one C
    call: one copy each way and one synchronisation."""
    from tpubft_torch.ops import sha256_cuda
    head = offsets.nbytes
    stage = _h2d.take(head + len(blob))
    host = stage.numpy()
    host[:head] = offsets.view(np.uint8)
    host[head:] = np.frombuffer(blob, np.uint8)
    b = len(offsets) - 1
    out = _d2h.take(32 * b)
    sha256_cuda.sha256_roundtrip(stage, head, out, b, dev)
    COPIES["h2d"] += 1
    COPIES["h2d_bytes"] += stage.numel()
    COPIES["d2h"] += 1
    COPIES["d2h_bytes"] += out.numel()
    return out.numpy().tobytes()


def _hash(messages: Sequence[bytes], device: Optional[torch.device]
          ) -> List[bytes]:
    from tpubft_torch.ops.dispatch import device_section
    dev = _device.resolve(device)
    blob, offsets = pack(messages)
    # the staging buffers are used under the device gate, which
    # serialises the calls that fill and drain them
    with device_section("sha256", batch=len(messages)):
        if dev.type == "cuda":
            raw = _roundtrip(blob, offsets, dev)
        else:
            raw = from_device(sha256_kernel(*to_device(blob, offsets, dev)))
    return [raw[i:i + 32] for i in range(0, len(raw), 32)]


def sha256_batch(messages: Sequence[bytes],
                 device: Optional[torch.device] = None) -> List[bytes]:
    """Hash a batch of messages that all need the same number of blocks
    (the reference's contract; ValueError otherwise) in one device call
    on `device` (default: the card)."""
    if not messages:
        return []
    nbs = {blocks_needed(len(m)) for m in messages}
    if len(nbs) != 1:
        raise ValueError("mixed block counts in one batch")
    return _hash(messages, device)


def sha256_batch_mixed(messages: Sequence[bytes],
                       device: Optional[torch.device] = None
                       ) -> List[bytes]:
    """Hash a batch of messages of any sizes in one device call."""
    if not messages:
        return []
    return _hash(messages, device)
