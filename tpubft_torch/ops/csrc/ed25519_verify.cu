// Ed25519 batch verify for Hopper (sm_90a), one signature per thread.
//
// Replaces tpubft/ops/ed25519_pallas.py::verify_kernel (the Pallas TPU
// kernel, pallas_call at :421) and computes the same verdict for every lane:
// RFC 8032 strict (cofactorless) verify — decompress A (square root in F_p,
// validity bit, the x == 0 with sign 1 rejection), negate it, build the
// 16-entry extended table of [j](-A), run the 64-window msb-first ladder
// (4 doublings, a niels mixed add of [s_w]B, an extended add of [h_w](-A)
// per window), canonicalise the affine result and compare y and the x
// parity with R. The host half (SHA-512, s < L, y < p, window recoding) and
// the host_valid mask stay in ops/ed25519.py, as in the reference.
//
// Inputs, as the reference kernel takes them: s_win, h_win (64, B) int32
// nibbles in little-endian window order; a_y, r_y (24, B) int32 tight
// canonical limbs of the TPU radix; a_sign, r_sign (B,) int32. Output (B,)
// bool (one byte per lane). Any B: the grid covers ceil(B/128) blocks and
// the ragged edge is masked here, so callers do not pad.
//
// What bounds it on this card: integer multiply issue. The verify is pure
// per-lane arithmetic on data that is read once (712 bytes per lane); from
// the representation in ed25519_field.cuh a verify costs 2207 field
// multiplies (100 IMAD.WIDE + 9 IMAD each) and 1533 squares (55 IMAD.WIDE +
// 9 IMAD each), about 3.05e5 IMAD.WIDE and 3.4e4 IMAD. Counting an IMAD.WIDE
// as two 32-bit multiply-adds, the bound is that count x B over
// 132 SMs x 64 INT32 multiply-adds per clock x the SM clock
// (ed25519_cuda.imad_per_verify has the count; chip_smoke.py computes the
// bound from it). The design's answer: a 64-bit-product radix that needs a
// quarter of the 24-limb radix's multiplies, a dedicated square, and no
// data-dependent control flow; the [h](-A) table lives in local memory
// (16 points x 160 bytes per thread) and the ladder issues one table read
// per window. Making the kernel fast (occupancy, table in shared memory,
// a cached-point form) is later work; ptxas's register and spill report for
// this build is recorded in PERF.md.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ed25519_field.cuh"

#define ED_THREADS 128

extern "C" __global__ void __launch_bounds__(ED_THREADS)
ed25519_verify_kernel(const int32_t* __restrict__ s_win,
                      const int32_t* __restrict__ h_win,
                      const int32_t* __restrict__ a_y,
                      const int32_t* __restrict__ a_sign,
                      const int32_t* __restrict__ r_y,
                      const int32_t* __restrict__ r_sign,
                      uint8_t* __restrict__ out, int batch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  out[b] = verify_lane(s_win + b, h_win + b, a_y + b, a_sign[b], r_y + b,
                       r_sign[b], batch) ? 1 : 0;
}

// Field test kernels (the chip_smoke `ladder` phase): the verify kernel's own
// fe_mul / fe_inv on (24, n) tight canonical limbs in, canonical limbs out.
extern "C" __global__ void __launch_bounds__(ED_THREADS)
ed25519_fe_mul_kernel(const int32_t* __restrict__ a,
                      const int32_t* __restrict__ b,
                      int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fe x = fe_reduce(fe_from_w24(a + i, n));
  const Fe y = fe_reduce(fe_from_w24(b + i, n));
  fe_to_w24(fe_canon(fe_mul(x, y)), out + i, n);
}

extern "C" __global__ void __launch_bounds__(ED_THREADS)
ed25519_fe_inv_kernel(const int32_t* __restrict__ a,
                      int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fe x = fe_reduce(fe_from_w24(a + i, n));
  fe_to_w24(fe_canon(fe_inv(x)), out + i, n);
}

static unsigned grid_for(int n) {
  return (unsigned)((n + ED_THREADS - 1) / ED_THREADS);
}

// ---- plain C interface (loaded with ctypes) ----
// Each returns a cudaError_t as int: 0 on success. Launches go on the
// caller's stream and do not synchronise.

extern "C" int ed25519_upload_consts(const int32_t* consts,
                                     const int32_t* btab) {
  cudaError_t err = cudaMemcpyToSymbol(c_consts, consts, sizeof(c_consts));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(c_btab, btab, sizeof(c_btab));
}

extern "C" int ed25519_verify_launch(const int32_t* s_win,
                                     const int32_t* h_win,
                                     const int32_t* a_y,
                                     const int32_t* a_sign,
                                     const int32_t* r_y,
                                     const int32_t* r_sign, uint8_t* out,
                                     int batch, void* stream) {
  if (batch <= 0) return 0;
  ed25519_verify_kernel<<<grid_for(batch), ED_THREADS, 0,
                          (cudaStream_t)stream>>>(
      s_win, h_win, a_y, a_sign, r_y, r_sign, out, batch);
  return (int)cudaGetLastError();
}

extern "C" int ed25519_fe_mul_launch(const int32_t* a, const int32_t* b,
                                     int32_t* out, int n, void* stream) {
  if (n <= 0) return 0;
  ed25519_fe_mul_kernel<<<grid_for(n), ED_THREADS, 0,
                          (cudaStream_t)stream>>>(a, b, out, n);
  return (int)cudaGetLastError();
}

extern "C" int ed25519_fe_inv_launch(const int32_t* a, int32_t* out, int n,
                                     void* stream) {
  if (n <= 0) return 0;
  ed25519_fe_inv_kernel<<<grid_for(n), ED_THREADS, 0,
                          (cudaStream_t)stream>>>(a, out, n);
  return (int)cudaGetLastError();
}

extern "C" const char* ed25519_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
