// Batched SHA-256 for Hopper (sm_90a), one message per thread.
//
// Replaces the two jitted XLA programs of tpubft/ops/sha256.py:
// sha256_kernel (:82, every lane has nb blocks) and sha256_kernel_masked
// (:178, lane i's state freezes after its own block count). One kernel
// serves both: it takes words (B, nb, 16) int32 — big-endian message words
// as integers, each message FIPS 180-4 padded at its own block count and
// zero-filled to nb — and nblocks (B,) int32, and lane i compresses its
// first min(nblocks[i], nb) blocks. The uniform contract passes nb for
// every lane. Output (B, 8) int32 digest words.
//
// Design: the state (8 words) and a rolling 16-word message schedule stay in
// registers, K lives in constant memory (every lane reads the same round
// constant at the same time, so the read is a broadcast), rotations are
// __funnelshift_r. Each block is read as four 16-byte loads by its own
// thread; neighbouring threads read neighbouring messages, 64 bytes apart,
// so a warp's four loads together cover 2 KB of contiguous words.
//
// What bounds it on this card: nvcc fuses each three-input xor of a Sigma,
// and ch and maj, into one LOP3, and the round's adds into IADD3s, so a
// round is about 14 integer instructions (6 of them SHF rotations) and a
// schedule step about 10. The body of the block loop in the built SASS is
// 1,390 32-bit integer instructions (672 SHF, 352 LOP3, 241 IADD3, 119
// IMAD, loop bookkeeping) beside 4 loads, 7 uniform loads of K and the
// branch: ops/sha256_cuda.sass_loop_body reads it with cuobjdump, and
// chip_smoke bounds the kernel by that count. A Merkle level of 1024 lanes x
// 2 blocks is 2.8e6 instructions, about 0.17 us at 132 SMs x 64 INT32 lanes
// per clock, and 168 KB moved, about 0.05 us at 3.35 TB/s; a state-transfer
// window of 64 raw blocks is less. Both are far below a kernel launch, so
// the kernel is bound by launch latency, and one thread's serial chain of
// rounds sets its time once launched. Nothing here is tuned for that.
#include <cuda_runtime.h>
#include <stdint.h>

#define SHA_THREADS 128

__constant__ uint32_t c_k[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
    0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
    0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
    0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
    0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
    0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
    0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
    0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
    0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; t++) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + S1 + ch + c_k[t] + wt;
    const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    const uint32_t t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

extern "C" __global__ void __launch_bounds__(SHA_THREADS)
sha256_kernel(const int4* __restrict__ words,
              const int32_t* __restrict__ nblocks,
              int32_t* __restrict__ out, int batch, int nb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch) return;
  uint32_t st[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                    0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
  const int count = min(nblocks[i], nb);
  const int4* msg = words + (size_t)i * nb * 4;
  for (int j = 0; j < count; j++) {
    uint32_t w[16];
#pragma unroll
    for (int q = 0; q < 4; q++) {
      const int4 v = msg[j * 4 + q];
      w[4 * q] = (uint32_t)v.x;
      w[4 * q + 1] = (uint32_t)v.y;
      w[4 * q + 2] = (uint32_t)v.z;
      w[4 * q + 3] = (uint32_t)v.w;
    }
    compress(st, w);
  }
  int4* o = reinterpret_cast<int4*>(out + (size_t)i * 8);
  o[0] = make_int4((int)st[0], (int)st[1], (int)st[2], (int)st[3]);
  o[1] = make_int4((int)st[4], (int)st[5], (int)st[6], (int)st[7]);
}

// ---- plain C interface (loaded with ctypes) ----
// Returns a cudaError_t as int: 0 on success. The launch goes on the
// caller's stream and does not synchronise. `words` and `out` must be
// 16-byte aligned (the wrapper checks).

extern "C" int sha256_launch(const int32_t* words, const int32_t* nblocks,
                             int32_t* out, int batch, int nb, void* stream) {
  if (batch <= 0) return 0;
  const unsigned grid = (unsigned)((batch + SHA_THREADS - 1) / SHA_THREADS);
  sha256_kernel<<<grid, SHA_THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const int4*>(words), nblocks, out, batch, nb);
  return (int)cudaGetLastError();
}

extern "C" const char* sha256_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
