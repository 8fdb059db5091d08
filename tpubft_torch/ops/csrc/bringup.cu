// Bring-up kernels for Hopper (sm_90a): rungs 0, 1 and 4 of the ladder.
//
// Replace the Pallas rung bodies of tools/pallas_bringup.py that the field
// kernels of ed25519_verify.cu (rungs 2 and 3) do not cover. Every kernel
// takes (24, n) int32 limbs of the TPU radix (limb k of lane i at
// a[k * n + i], limb k holding bits W[k] .. W[k+1] with
// W[k] = ceil(255 k / 24)), one lane per thread, and writes (24, n) int32:
//
//   bringup_copy     rung 0 (_body_copy, :95): out = a + c0, where c0 is the
//                    first entry of the radix table (BITS[0]), as the TPU
//                    rung added consts[0, 0]. A stream over the 24n words
//                    as one flat array (24n is a multiple of four): each
//                    thread moves 16 bytes, one int4 load and store; if a
//                    pointer is not 16-byte aligned, the same grid walks
//                    the words one by one (a grid-stride loop). At 2^20
//                    lanes one int4 a thread ran as fast as torch.add on
//                    the card, one word a thread took 1.75x as long, and
//                    a grid capped at 16 blocks an SM with four int4 loads
//                    in flight a thread was slower too (PERF.md).
//   fe_carry         rung 1 (_body_carry, :99; _Engine.normalize,
//                    tpubft/ops/ed25519_pallas.py:184): two parallel carry
//                    passes in the 10/11-bit radix, the carry out of limb 23
//                    folded into limb 0 with factor 19 (2^255 = 19 mod p).
//                    Loose limbs up to 7x tight in; the output limbs equal
//                    ops/f25519.normalize limb for limb (same passes, same
//                    arithmetic shifts on signed int32).
//   fe_table_gather  rung 4 (_body_table, :114; pallas_call :175): builds
//                    a, a^2, a^3, a^4 per lane in SHARED memory, selects
//                    entry a[0] & 3 and multiplies it by a constant element
//                    `col` (column 0 of the base niels table on the ladder),
//                    canonical limbs out. The multiply is ed25519_field.cuh's
//                    (converted at entry and exit, as fe_mul does). The table
//                    is a small pilot of a shared-memory [h](-A) table for the
//                    verify kernel: entry j of lane t sits at tab[j][limb][t],
//                    so a warp's 32 lanes read 32 consecutive words of one
//                    entry (no bank conflicts) whatever entries they select.
//
// What bounds them on this card: rungs 0 and 1 are memory-bound streams
// (96 bytes read and 96 written per lane, a few integer operations per limb);
// rung 4 does four field multiplies per lane (about 840 32-bit multiply-add
// equivalents) on 192 bytes, so at the ladder's 1024 lanes all three are
// launch-bound: 192 KB is 0.06 us of HBM time against a few microseconds
// to start a kernel. The copy's vector stream is for large n (2^20 lanes,
// 96 MB each way), where the bytes bound it. ops/bringup_cuda.work counts
// both sides for the bound.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ed25519_field.cuh"

#define BU_THREADS 128
#define NL 24

__device__ __forceinline__ int limb_bits(int k) { return w24(k + 1) - w24(k); }

extern "C" __global__ void __launch_bounds__(BU_THREADS)
bringup_copy_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                    int total, int c0) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(out)) &
       15) != 0) {
    for (int k = i; k < total; k += gridDim.x * blockDim.x)
      out[k] = a[k] + c0;
    return;
  }
  const int vecs = total / 4;
  if (i < vecs) {
    int4 v = __ldg(reinterpret_cast<const int4*>(a) + i);
    v.x += c0; v.y += c0; v.z += c0; v.w += c0;
    reinterpret_cast<int4*>(out)[i] = v;
  }
}

extern "C" __global__ void __launch_bounds__(BU_THREADS)
fe_carry_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t c[NL];
#pragma unroll
  for (int k = 0; k < NL; k++) c[k] = a[k * n + i];
#pragma unroll
  for (int pass = 0; pass < 2; pass++) {
    int32_t carry = 0;   // hi of the limb below, shifted up one position
#pragma unroll
    for (int k = 0; k < NL; k++) {
      const int bits = limb_bits(k);
      const int32_t hi = c[k] >> bits;           // arithmetic
      c[k] = (c[k] & ((1 << bits) - 1)) + carry;
      carry = hi;
    }
    c[0] += carry * 19;                          // carry out of limb 23
  }
#pragma unroll
  for (int k = 0; k < NL; k++) out[k * n + i] = c[k];
}

extern "C" __global__ void __launch_bounds__(BU_THREADS)
fe_table_gather_kernel(const int32_t* __restrict__ a,
                       const int32_t* __restrict__ col,
                       int32_t* __restrict__ out, int n) {
  __shared__ int32_t tab[4][10][BU_THREADS];
  const int t = threadIdx.x;
  const int i = blockIdx.x * blockDim.x + t;
  if (i >= n) return;              // each lane reads only its own column
  const Fe x = fe_reduce(fe_from_w24(a + i, n));
  Fe cur = x;
#pragma unroll
  for (int j = 0; j < 4; j++) {
    if (j > 0) cur = fe_mul(cur, x);
#pragma unroll
    for (int l = 0; l < 10; l++) tab[j][l][t] = cur.v[l];
  }
  const int idx = a[i] & 3;        // limb 0 of the lane: the pseudo-digit
  Fe sel;
#pragma unroll
  for (int l = 0; l < 10; l++) sel.v[l] = tab[idx][l][t];
  const Fe c = fe_reduce(fe_from_w24(col, 1));
  fe_to_w24(fe_canon(fe_mul(sel, c)), out + i, n);
}

static unsigned grid_for(int n) {
  return (unsigned)((n + BU_THREADS - 1) / BU_THREADS);
}

// ---- plain C interface (loaded with ctypes) ----
// Each returns a cudaError_t as int: 0 on success. Launches go on the
// caller's stream and do not synchronise.

extern "C" int bringup_copy_launch(const int32_t* a, int32_t* out, int n,
                                   int c0, void* stream) {
  if (n <= 0) return 0;
  bringup_copy_kernel<<<grid_for(NL * n / 4), BU_THREADS, 0,
                        (cudaStream_t)stream>>>(a, out, NL * n, c0);
  return (int)cudaGetLastError();
}

extern "C" int fe_carry_launch(const int32_t* a, int32_t* out, int n,
                               void* stream) {
  if (n <= 0) return 0;
  fe_carry_kernel<<<grid_for(n), BU_THREADS, 0, (cudaStream_t)stream>>>(
      a, out, n);
  return (int)cudaGetLastError();
}

extern "C" int fe_table_gather_launch(const int32_t* a, const int32_t* col,
                                      int32_t* out, int n, void* stream) {
  if (n <= 0) return 0;
  fe_table_gather_kernel<<<grid_for(n), BU_THREADS, 0,
                           (cudaStream_t)stream>>>(a, col, out, n);
  return (int)cudaGetLastError();
}

extern "C" const char* bringup_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
