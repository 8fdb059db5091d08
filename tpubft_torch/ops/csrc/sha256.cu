// Batched SHA-256 for Hopper (sm_90a): raw message bytes in, digests out.
//
// Replaces the two jitted XLA programs of tpubft/ops/sha256.py,
// sha256_kernel (:82, every lane has nb blocks) and sha256_kernel_masked
// (:178, a lane's state freezes after its own block count), and the host
// padding that fed them (prepare / prepare_mixed: FIPS 180-4 padding, the
// big-endian word layout, block counts and batches rounded up to powers of
// two, which only bounded XLA's compiled shapes). One contract serves both:
//
//   data     uint8 (N,)    the messages, concatenated (4-byte aligned base)
//   offsets  int64 (B+1,)  message i is data[offsets[i] : offsets[i+1]]
//   out      uint8 (B, 32) big-endian digests (16-byte aligned)
//
// The kernel counts each message's blocks, (len + 8) / 64 + 1, reads the
// message at any byte offset (aligned 32-bit words joined and byte-swapped
// by __byte_perm), writes the 0x80 byte, the zeros and the 64-bit bit
// length itself, and stores the digest bytes in order. Offsets are clamped
// to the buffer, so no input makes it read outside `data`.
//
// What bounds it on this card. SHA-256 needs about 2,300 32-bit operations
// per 64-byte block (ops/sha256_cuda.OPS_PER_COMPRESSION), so even a
// 16,384-message Merkle level is microseconds of the card's integer rate
// and bytes; config 1's real launch, a state-transfer window of 64 blocks
// of 4-5 compressions, is two CTAs of serial chains. Each round depends on
// the one before and issues 6 funnel-shift rotations and 4 LOP3 on the
// integer ALU, whose 16 lanes per SM partition take two cycles a warp
// instruction, and 4-6 adds, which nvcc splits between IADD3 (ALU) and
// IMAD (the FMA pipe): by the compiler's stall counts a lone warp's round
// is 30 issue cycles (ops/sha256_cuda.ROUND_CYCLES), and clock64 probes
// read about 35 on an H100. Forcing every add onto IMAD made it slower.
// Two more costs showed in the probes of a chain lane that waits for a
// helper to expand a whole block and loads kw[t] from shared memory each
// round: the chain idle until block 0's 64 schedule words are written
// (about 1,700 cycles after its loads land), and 33-42 cycles a round,
// each load issued just before its use. Here:
//
//  - two lanes per message, in two warps of one 64-thread CTA: lane i of
//    warp 0 is message i's chain lane, lane i of warp 1 its helper. The
//    roles are split by warp, not within one, because a warp issues one
//    instruction for all its lanes: lanes of one warp in different roles
//    would take turns, while two warps run on two SM partitions at once;
//  - loads: a CTA whose 32 messages' bytes fit STAGE_BYTES (Merkle levels,
//    ledger windows) first copies them into shared memory, all 64 threads
//    issuing coalesced 16-byte cp.async copies back to back: one exposed
//    memory latency a launch, and no per-lane scattered loads (17 a block
//    and lane, 32 lanes 65 bytes apart: L1 wavefronts that cost a
//    16,384-node level more than its loads' bytes). A CTA with longer
//    messages (the 69-block ones of a window of big blocks) streams: the
//    helper loads each block's 17 words from global memory while it
//    expands the block before, so no message is ever resident whole;
//  - the helper expands each block's schedule W[0..63] + K[t] into shared
//    memory, double-buffered by block (kw[2][32][17] uint4, lane-major
//    with four words of padding so a quarter-warp's 16-byte accesses hit
//    distinct banks), and hands it over a quarter (16 rounds) at a time:
//    `bar.arrive` on a named barrier per buffer and quarter, on which the
//    chain waits with `bar.sync`; the chain gives a buffer back with
//    `bar.arrive` on the buffer's own barrier. So the chain starts block 0
//    once its first 16 words are in, and the helper runs up to a block
//    ahead;
//  - the chain lane runs only the 64 rounds, the state in registers, and
//    loads a quarter's 16 kw values with four LDS.128 right after its
//    barrier, so one shared-memory latency a quarter is exposed, not one a
//    round;
//  - a ragged batch as in the verify kernel: lanes past the batch hash a
//    clamped copy of the last message and skip the store, and both warps
//    run their loops to the longest message of the 32, so every barrier
//    and warp collective sees all lanes.
#include <cuda_runtime.h>
#include <stdint.h>

// messages a CTA: a chain warp and a helper warp
#define SHA_MSGS 32
#define SHA_THREADS (2 * SHA_MSGS)
// shared memory for a CTA's staged message bytes
#define STAGE_BYTES 12288
#define STAGE_WORDS (STAGE_BYTES / 4)
// staged bytes past the last message's end that its last block's 17-word
// read may touch (at most 8 + 68 + 3), rounded up
#define STAGE_TAIL 128

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

// Little-endian 32-bit word `wi` of data (nbytes long); bytes past the end
// read as 0, so the tail of the buffer is never overread.
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ data,
                                              long long wi, long long nbytes) {
  const long long b = wi * 4;
  if (b + 4 <= nbytes)
    return __ldg(reinterpret_cast<const uint32_t*>(data) + wi);
  uint32_t v = 0;
  for (int k = 0; k < 4; k++)
    if (b + k < nbytes) v |= (uint32_t)__ldg(data + b + k) << (8 * k);
  return v;
}

// The 17 aligned words that cover block `blk` of the message at byte
// `start`: from the staged copy (`stage`, which holds data from byte
// `base` on; base is 4-aligned relative to data) or, without one, from
// global memory.
__device__ __forceinline__ void fetch_block(uint32_t u[17],
                                            const uint8_t* __restrict__ data,
                                            long long nbytes,
                                            const uint32_t* stage,
                                            long long base, long long start,
                                            long long blk) {
  const long long b = start + 64 * blk;
  if (stage) {
    const uint32_t* p = stage + ((b - base) >> 2);
#pragma unroll
    for (int k = 0; k < 17; k++) u[k] = p[k];
    return;
  }
  const long long w0 = b >> 2;
  if ((w0 + 17) * 4 <= nbytes) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(data) + w0;
#pragma unroll
    for (int k = 0; k < 17; k++) u[k] = __ldg(p + k);
  } else {
#pragma unroll
    for (int k = 0; k < 17; k++) u[k] = load_word(data, w0 + k, nbytes);
  }
}

// The 16 big-endian words of block `blk` of a message of `len` bytes and
// `nb` blocks, FIPS 180-4 padded: message bytes, then 0x80, zeros, and the
// bit length in the last 8 bytes of block nb-1.
__device__ __forceinline__ void block_words(uint32_t w[16],
                                            const uint32_t u[17],
                                            long long start, long long len,
                                            long long blk, int nb) {
  const uint32_t sh = (uint32_t)((start + 64 * blk) & 3);
  const uint32_t sel = (sh << 12) | ((sh + 1) << 8) | ((sh + 2) << 4) |
                       (sh + 3);
#pragma unroll
  for (int k = 0; k < 16; k++) w[k] = __byte_perm(u[k], u[k + 1], sel);
  const long long rest = len - 64 * blk;  // message bytes from this block on
  if (rest >= 64) return;
  const int left0 = rest < 0 ? -4 : (int)rest;
  const bool last = blk == nb - 1;
  const unsigned long long bitlen = (unsigned long long)len * 8;
#pragma unroll
  for (int k = 0; k < 16; k++) {
    const int left = left0 - 4 * k;  // message bytes from this word on
    uint32_t x = w[k];
    if (left < 4) {
      const int keep = left < 0 ? 0 : left;
      x = keep ? (x & (0xffffffffu << (32 - 8 * keep))) : 0u;
      if (left >= 0) x |= 0x80u << (24 - 8 * keep);
    }
    if (last && k == 14) x = (uint32_t)(bitlen >> 32);
    if (last && k == 15) x = (uint32_t)bitlen;
    w[k] = x;
  }
}

// Schedule word t of the block in w (a rolling window of 16).
__device__ __forceinline__ uint32_t schedule(uint32_t w[16], int t) {
  if (t < 16) return w[t];
  const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
  const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
  const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
  const uint32_t wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
  w[t & 15] = wt;
  return wt;
}

// A lane's row of a kw buffer: 64 words and 4 of padding.
typedef uint4 KwRow[17];

// Named barriers (0 is __syncthreads): quarter q of kw buffer `buf` is
// written, READY; buffer `buf` is read and may be overwritten, FREE.
#define BAR_READY(buf, q) (1 + 4 * (buf) + (q))
#define BAR_FREE(buf) (9 + (buf))

#ifndef SHA256_HOST_SHIM
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(SHA_THREADS) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(SHA_THREADS) : "memory");
}
#endif

#ifndef SHA256_HOST_SHIM
// A 16-byte copy from global to shared memory that does not hold up the
// thread (cp.async): `src_bytes` (0-16) are read, the rest zero-filled.
__device__ __forceinline__ void copy_async16(void* dst, const void* src,
                                             int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}
#endif

// Copy data[lo, hi) into stage, from lo rounded down to a 16-byte address,
// with all threads of the CTA: each issues its 16-byte copies back to
// back, so the CTA waits for one memory latency, not one a copy. Bytes
// outside data are never read and stage as 0. -> the byte of data at
// stage[0].
__device__ __forceinline__ long long stage_range(uint32_t* stage,
                                                 const uint8_t* __restrict__ data,
                                                 long long nbytes, long long lo,
                                                 long long hi) {
  const long long base =
      lo - (long long)(reinterpret_cast<uintptr_t>(data + lo) & 15);
  const int chunks = (int)((hi - base + 15) >> 4);
  uint4* s4 = reinterpret_cast<uint4*>(stage);
  for (int i = threadIdx.x; i < chunks; i += SHA_THREADS) {
    const long long b = base + 16 * (long long)i;
    if (b >= 0) {
      const long long n = nbytes - b;
      copy_async16(&s4[i], data + b, n >= 16 ? 16 : (n > 0 ? (int)n : 0));
    } else {  // the chunk that starts before data: bytewise
      uint32_t v[4];
#pragma unroll
      for (int k = 0; k < 4; k++) {
        v[k] = 0;
        for (int j = 0; j < 4; j++) {
          const long long p = b + 4 * k + j;
          if (p >= 0 && p < nbytes) v[k] |= (uint32_t)__ldg(data + p) << (8 * j);
        }
      }
      s4[i] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
  copy_async_wait();
  return base;
}

__device__ __forceinline__ void store_digest(uint8_t* __restrict__ out,
                                             long long m, const uint32_t st[8]) {
  uint4* o = reinterpret_cast<uint4*>(out + m * 32);
  o[0] = make_uint4(__byte_perm(st[0], 0, 0x0123), __byte_perm(st[1], 0, 0x0123),
                    __byte_perm(st[2], 0, 0x0123), __byte_perm(st[3], 0, 0x0123));
  o[1] = make_uint4(__byte_perm(st[4], 0, 0x0123), __byte_perm(st[5], 0, 0x0123),
                    __byte_perm(st[6], 0, 0x0123), __byte_perm(st[7], 0, 0x0123));
}

// The chain lane: 16 rounds a quarter, each quarter once the helper has
// written it.
__device__ __forceinline__ void chain(uint32_t st[8], KwRow (*kw)[SHA_MSGS],
                                      int lane, int nb, int steps) {
  for (int j = 0; j < steps; j++) {
    const int buf = j & 1;
    uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
    for (int q = 0; q < 4; q++) {
      bar_sync(BAR_READY(buf, q));
      if (j < nb) {
        const uint4* row = &kw[buf][lane][4 * q];
        const uint4 k4[4] = {row[0], row[1], row[2], row[3]};
#pragma unroll
        for (int r = 0; r < 16; r++) {
          const uint4 kq = k4[r / 4];
          const uint32_t kt = r % 4 == 0 ? kq.x : r % 4 == 1 ? kq.y
                              : r % 4 == 2 ? kq.z : kq.w;
          const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
          const uint32_t ch = (e & f) ^ (~e & g);
          const uint32_t t1 = h + kt + ch + S1;
          const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
          const uint32_t maj = (a & b) | (c & (a | b));
          h = g; g = f; f = e; e = d + t1;
          d = c; c = b; b = a; a = t1 + S0 + maj;
        }
      }
    }
    if (j < nb) {
      st[0] += a; st[1] += b; st[2] += c; st[3] += d;
      st[4] += e; st[5] += f; st[6] += g; st[7] += h;
    }
    if (j + 2 < steps) bar_arrive(BAR_FREE(buf));
  }
}

// The helper lane: block j's words padded and expanded into kw buffer
// j & 1 a quarter at a time, block j+1's words fetched meanwhile (from
// global memory they have the expansion's time to land).
__device__ __forceinline__ void helper(KwRow (*kw)[SHA_MSGS], int lane,
                                       const uint8_t* __restrict__ data,
                                       long long nbytes, const uint32_t* stage,
                                       long long base, long long start,
                                       long long len, int nb, int steps) {
  uint32_t u[17], v[17], w[16];
  fetch_block(u, data, nbytes, stage, base, start, 0);
  for (int j = 0; j < steps; j++) {
    const int buf = j & 1;
    if (j >= 2) bar_sync(BAR_FREE(buf));
    const bool active = j < nb;
    if (active) block_words(w, u, start, len, j, nb);
    if (j + 1 < nb) fetch_block(v, data, nbytes, stage, base, start, j + 1);
#pragma unroll
    for (int q = 0; q < 4; q++) {
      if (active) {
#pragma unroll
        for (int i = 0; i < 4; i++) {
          const int t = 16 * q + 4 * i;
          uint4 x;
          x.x = schedule(w, t) + c_k[t];
          x.y = schedule(w, t + 1) + c_k[t + 1];
          x.z = schedule(w, t + 2) + c_k[t + 2];
          x.w = schedule(w, t + 3) + c_k[t + 3];
          kw[buf][lane][4 * q + i] = x;
        }
      }
      __syncwarp();
      bar_arrive(BAR_READY(buf, q));
    }
#pragma unroll
    for (int k = 0; k < 17; k++) u[k] = v[k];
  }
}

// One thread's part: threads 0..31 of the CTA are chain lanes, 32..63
// helper lanes, lane i of each serving message blockIdx.x * 32 + i.
__device__ __forceinline__ void sha256_pair(const uint8_t* __restrict__ data,
                                            long long nbytes,
                                            const long long* __restrict__ offsets,
                                            uint8_t* __restrict__ out,
                                            int batch, KwRow (*kw)[SHA_MSGS],
                                            uint32_t* stage) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x % SHA_MSGS;
  const long long gm = (long long)blockIdx.x * SHA_MSGS + lane;
  const bool live = gm < batch;
  const long long m = live ? gm : batch - 1;
  long long start = offsets[m], stop = offsets[m + 1];
  start = start < 0 ? 0 : (start > nbytes ? nbytes : start);
  stop = stop < start ? start : (stop > nbytes ? nbytes : stop);
  const long long len = stop - start;
  const int nb = (int)((len + 8) / 64 + 1);
  // both warps serve the same 32 messages, so both get the same count
  // and take the same staging decision
  const int steps = __reduce_max_sync(full, nb);
  const long long lo = __shfl_sync(full, start, 0);
  const long long hi = __shfl_sync(full, stop, SHA_MSGS - 1);
  const bool inside = __all_sync(full, start >= lo && stop <= hi);
  const uint32_t* src = nullptr;
  long long base = 0;
  if (inside && hi - lo + STAGE_TAIL + 32 <= STAGE_BYTES) {
    base = stage_range(stage, data, nbytes, lo,
                       hi + STAGE_TAIL < nbytes ? hi + STAGE_TAIL : nbytes);
    src = stage;
  }
  __syncthreads();
  if (threadIdx.x < SHA_MSGS) {
    uint32_t st[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                      0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
    chain(st, kw, lane, nb, steps);
    if (live) store_digest(out, m, st);
  } else {
    helper(kw, lane, data, nbytes, src, base, start, len, nb, steps);
  }
}

#ifndef SHA256_HOST_SHIM

extern "C" __global__ void __launch_bounds__(SHA_THREADS)
sha256_raw_kernel(const uint8_t* __restrict__ data, long long nbytes,
                  const long long* __restrict__ offsets,
                  uint8_t* __restrict__ out, int batch) {
  __shared__ KwRow kw[2][SHA_MSGS];
  // STAGE_WORDS plus the 17-word read of a block that starts at the end
  __shared__ __align__(16) uint32_t stage[STAGE_WORDS + 32];
  sha256_pair(data, nbytes, offsets, out, batch, kw, stage);
}

// ---- plain C interface (loaded with ctypes) ----
// Returns a cudaError_t as int: 0 on success. The launch goes on the
// caller's stream and does not synchronise. `data` must be 4-byte aligned
// and `out` 16-byte aligned (the wrapper checks).

extern "C" int sha256_raw_launch(const uint8_t* data, long long nbytes,
                                 const long long* offsets, uint8_t* out,
                                 int batch, void* stream) {
  if (batch <= 0) return 0;
  const unsigned grid = (unsigned)((batch + SHA_MSGS - 1) / SHA_MSGS);
  sha256_raw_kernel<<<grid, SHA_THREADS, 0, (cudaStream_t)stream>>>(
      data, nbytes, offsets, out, batch);
  return (int)cudaGetLastError();
}

// The host half's round trip in one call: `host_in` (pinned: the int64
// offsets, `head` bytes, then the message bytes) copied to `dev_in`, the
// kernel, the digests copied to `host_out` (pinned), and one stream
// synchronisation, which also runs when a step fails, so the pinned
// buffers are free again whenever this returns.
extern "C" int sha256_raw_roundtrip(const void* host_in, void* dev_in,
                                    long long in_bytes, long long head,
                                    void* dev_out, void* host_out, int batch,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyAsync(dev_in, host_in, (size_t)in_bytes,
                                    cudaMemcpyHostToDevice, s);
  if (err == cudaSuccess && batch > 0) {
    const uint8_t* base = static_cast<const uint8_t*>(dev_in);
    err = (cudaError_t)sha256_raw_launch(
        base + head, in_bytes - head, reinterpret_cast<const long long*>(base),
        static_cast<uint8_t*>(dev_out), batch, stream);
    if (err == cudaSuccess)
      err = cudaMemcpyAsync(host_out, dev_out, (size_t)batch * 32,
                            cudaMemcpyDeviceToHost, s);
  }
  const cudaError_t sync = cudaStreamSynchronize(s);
  return (int)(err != cudaSuccess ? err : sync);
}

extern "C" const char* sha256_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

#endif  // SHA256_HOST_SHIM
