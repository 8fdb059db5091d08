// Ed25519 batch verify for Hopper (sm_90a), four lanes per signature.
//
// Replaces tpubft/ops/ed25519_pallas.py::verify_kernel (the Pallas TPU
// kernel, pallas_call at :421) and computes the same verdict for every lane:
// RFC 8032 strict (cofactorless) verify — decompress A (square root in F_p,
// validity bit, the x == 0 with sign 1 rejection), negate it, build the
// 16-entry table of [j](-A), run the 64-window msb-first ladder (4
// doublings, a niels mixed add of [s_w]B, an add of [h_w](-A) per window)
// and check encode(Q) == R. The host half (SHA-512, s < L, y < p, window
// recoding) and the host_valid mask stay in ops/ed25519.py, as in the
// reference.
//
// Inputs, as the reference kernel takes them: s_win, h_win (64, B) int32
// nibbles in little-endian window order; a_y, r_y (24, B) int32 tight
// limbs of the TPU radix (values below 2^255); a_sign, r_sign (B,) int32.
// Output (B,) bool (one byte per signature). Any B: the ragged edge is
// handled here, so callers do not pad.
//
// Design (ed25519_field.cuh has the formulas). A verify is one long chain
// of dependent field operations, and at config 1's batches (100 signatures
// a PrePrepare) a handful of warps run on a 132-SM card, so latency, not
// throughput, sets the time. Hence:
//  - four lanes per signature: a group of four consecutive threads, lane c
//    owning coordinate c of the running point; each of the reference's
//    formulas runs as two steps of one multiply or square per lane (Hisil
//    et al.'s four-processor schedule), with limbs exchanged by shuffles
//    within the group between steps. A window costs 12 multiply latencies
//    on the critical path instead of 48;
//  - no final inversion: lanes 1 and 3 decompress R while lanes 0 and 2
//    decompress A (the same square-root code), and the verdict compares
//    X == x_R Z and Y == y_R Z. The critical path is about 1,070 dependent
//    field steps (272 decompression, 29 table, 768 ladder, 1 compare)
//    against 3,740 for one thread doing everything;
//  - the [j](-A) table in shared memory, in cached form
//    (Y-X, Y+X, 2d T, 2Z), lane c's coordinate at tab[j][limb][thread]:
//    each thread reads only its own column, so a warp's 32 reads of one
//    limb row are 32 consecutive words whatever entries the signatures
//    select (no bank conflicts, no per-thread local array). The base niels
//    table is copied from global memory to shared memory per block, as
//    btab[limb][digit*4 + lane] (at most two-way conflicts), instead of
//    constant memory, which serialises the per-lane indices;
//  - 64-thread blocks (16 signatures): 40 KB of table, 2.5 KB of R's
//    coordinates kept for the compare and 2.5 KB of base table are static
//    shared memory, under the 48 KB that needs no opt-in, and five blocks
//    fit an SM's 227 KB;
//  - no thread returns early: a group past the batch verifies a clamped
//    copy of the last signature and skips only the store, so every shuffle
//    sees all 32 lanes of its warp.
//
// What bounds it on this card: integer multiply throughput at large batch. A
// strict verify needs 2,150 multiplies and 1,534 squares (A and R
// decompressed once each, the table, the ladder, the compare:
// ed25519_cuda.function_ops_per_verify), at 100 IMAD.WIDE + 9 IMAD per
// multiply and 55 + 9 per square; the bound is that count x B over 132 SMs
// x 64 INT32 multiply-adds per clock x the SM clock, counting an IMAD.WIDE
// as two (chip_smoke.py computes it). The four lanes execute 2,300
// multiplies and 2,048 squares, 15% more: each point is decompressed on
// two lanes, and a lane with no work in a step multiplies by 1 or 2. At
// small batch the chain's latency is what is left: about 0.49 ms at B =
// 100 to 1024 on an H100, against 3.3 ms for one thread per signature
// (PERF.md).
//
// ptxas (printed by chip_smoke.py's device phase): 255 registers, 0 bytes
// spilled in the kernel, 46,080 bytes of shared memory, a 184-byte stack
// frame for its one call, fe_decompress, which saves 136 bytes of
// registers once per thread. With the decompression inlined the kernel
// spilled 80 bytes inside the ladder instead.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ed25519_field.cuh"

#define ED_THREADS 64                   // verify: 16 signatures a block
#define FE_THREADS 128                  // the field test kernel
#define ED_BTAB_WORDS (10 * 16 * 4)

// the base niels table, btab[limb][digit*4 + lane]: lane c's coordinate of
// [d]B in the order the additions take it (y-x, y+x, 2d x y, 2)
__device__ int32_t g_btab[ED_BTAB_WORDS];

extern "C" __global__ void __launch_bounds__(ED_THREADS)
ed25519_verify_kernel(const int32_t* __restrict__ s_win,
                      const int32_t* __restrict__ h_win,
                      const int32_t* __restrict__ a_y,
                      const int32_t* __restrict__ a_sign,
                      const int32_t* __restrict__ r_y,
                      const int32_t* __restrict__ r_sign,
                      uint8_t* __restrict__ out, int batch) {
  __shared__ int32_t tab[17 * 10 * ED_THREADS];
  __shared__ int32_t btab[ED_BTAB_WORDS];
  const int t = threadIdx.x;
  for (int i = t; i < ED_BTAB_WORDS; i += ED_THREADS) btab[i] = g_btab[i];
  __syncthreads();
  const int c = t & 3;
  const int g = (blockIdx.x * ED_THREADS + t) >> 2;
  const int b = g < batch ? g : batch - 1;
  const bool ok = verify_group(c, s_win + b, h_win + b, a_y + b, a_sign[b],
                               r_y + b, r_sign[b], batch, tab + t,
                               ED_THREADS, btab);
  if (c == 0 && g < batch) out[g] = ok ? 1 : 0;
}

// Field test kernel (the chip_smoke `ladder` phase, rung 2): the verify
// kernel's own fe_mul on (24, n) tight canonical limbs in, canonical limbs
// out. Rung 3, the inversion, has a kernel of its own (fe_inv.cu).
extern "C" __global__ void __launch_bounds__(FE_THREADS)
ed25519_fe_mul_kernel(const int32_t* __restrict__ a,
                      const int32_t* __restrict__ b,
                      int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fe x = fe_reduce(fe_from_w24(a + i, n));
  const Fe y = fe_reduce(fe_from_w24(b + i, n));
  fe_to_w24(fe_canon(fe_mul(x, y)), out + i, n);
}

static unsigned grid_for(long long threads, int per_block) {
  return (unsigned)((threads + per_block - 1) / per_block);
}

// ---- plain C interface (loaded with ctypes) ----
// Each returns a cudaError_t as int: 0 on success. Launches go on the
// caller's stream and do not synchronise.

// consts (3, 10): D, 2D, sqrt(-1); btab (16, 3, 10): [d]B as
// (y+x, y-x, 2d x y), canonical limbs. The base table is rearranged here
// into the kernel's per-lane order.
extern "C" int ed25519_upload_consts(const int32_t* consts,
                                     const int32_t* btab) {
  cudaError_t err = cudaMemcpyToSymbol(c_consts, consts, sizeof(c_consts));
  if (err != cudaSuccess) return (int)err;
  int32_t lanes[ED_BTAB_WORDS];
  static const int coord_of_lane[3] = {1, 0, 2};   // y-x, y+x, 2d x y
  for (int l = 0; l < 10; l++)
    for (int d = 0; d < 16; d++)
      for (int c = 0; c < 4; c++)
        lanes[l * 64 + d * 4 + c] =
            c < 3 ? btab[(d * 3 + coord_of_lane[c]) * 10 + l]
                  : (l == 0 ? 2 : 0);
  return (int)cudaMemcpyToSymbol(g_btab, lanes, sizeof(lanes));
}

extern "C" int ed25519_verify_launch(const int32_t* s_win,
                                     const int32_t* h_win,
                                     const int32_t* a_y,
                                     const int32_t* a_sign,
                                     const int32_t* r_y,
                                     const int32_t* r_sign, uint8_t* out,
                                     int batch, void* stream) {
  if (batch <= 0) return 0;
  ed25519_verify_kernel<<<grid_for(4LL * batch, ED_THREADS), ED_THREADS, 0,
                          (cudaStream_t)stream>>>(
      s_win, h_win, a_y, a_sign, r_y, r_sign, out, batch);
  return (int)cudaGetLastError();
}

extern "C" int ed25519_fe_mul_launch(const int32_t* a, const int32_t* b,
                                     int32_t* out, int n, void* stream) {
  if (n <= 0) return 0;
  ed25519_fe_mul_kernel<<<grid_for(n, FE_THREADS), FE_THREADS, 0,
                          (cudaStream_t)stream>>>(a, b, out, n);
  return (int)cudaGetLastError();
}

extern "C" const char* ed25519_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
