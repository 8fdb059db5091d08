// GF(2^255-19) inversion for Hopper (sm_90a): rung 3 of the bring-up ladder.
//
// Replaces the Pallas rung body _body_inv (tools/pallas_bringup.py:109,
// pallas_call :82), which computes _Engine.inv (tpubft/ops/ed25519_pallas.py:
// 233): a^(p-2) mod p, inv(0) = 0, on (24, n) int32 tight canonical limbs of
// the TPU radix (limb k of element i at a[k * n + i]), canonical limbs out.
// The exponent is the standard curve25519 addition chain (254 squares, 11
// multiplies), as in the reference, so the result is the reference's.
//
// What bounds it on this card. The chain is 265 dependent field steps, so
// at the ladder's 1024 elements (a few warps on a 132-SM card) each step's
// latency sets the time, not the card's integer rate: the throughput bound
// (ops/bringup_cuda.work) applies only where the card is full, around 2^17
// elements. The one-thread design this replaces (the verify kernel's fe_sq
// / fe_mul, one element a thread) spent about 905 cycles a step, most of
// it in ref10's serial carry: 12 dependent carries on int64, each several
// dependent 32-bit instructions. With the carry below, a square on one
// thread is a loop of 129 instructions, 55 of them IMAD.WIDE, and takes
// about 448 cycles: the products now set its time (PERF.md).
//
// Design.
//  - A parallel carry in one pass, on unsigned limbs. Every intermediate
//    value is nonnegative (the input is canonical, and the chain only
//    squares and multiplies), so limbs are uint32 and column sums uint64.
//    Column m's sum h (weight 2^ceil(25.5 m)) splits at once into three
//    pieces: a, its low bits, stays in limb m; b, the next limb's width of
//    bits, goes to limb m+1; c = h >> 51 (below 2^13) goes to limb m+2.
//    Pieces that cross 2^255 are multiplied by 19 (2^255 = 19 mod p), and
//    19 b of column 9 is split again between limbs 0 and 1. A limb is then
//    the sum of three pieces, below 2^(width+1) + 2^18, with no second
//    round: that bound is a fixed point of the step (every column sum stays
//    below 2^62, every operand, 19x included, below 2^32;
//    tests/test_torch_fe_inv.py checks the arithmetic of the bounds).
//  - One element on a group of four lanes where the card is not full
//    (fe_inv_group). Lane c sums the columns m = c, c+4, c+8 (lanes 2 and
//    3 have a third, dummy column, so the four run one instruction
//    stream): 30 products a step on each lane instead of 55 (square) or
//    100 (multiply) on one thread. Column m = sum_i f_i G_(m-i), where G
//    extends g below index 0 by 19 x; lane c holds f in the natural order
//    and g rotated by c (r_k = g_((c+k) mod 10)), so G_(m-i) = W_(4s-i)
//    with register indices that are the same on every lane, and only the
//    weights (x2 for two odd limbs, x19 where the rotation wraps) differ by
//    lane, as values. The pieces move by 17 shuffles within the group: 7
//    bring each lane the b and c pieces of its own three limbs, 10 gather
//    the ten limbs onto every lane; the rotated copy is three selects a
//    limb. Every lane-dependent constant is hidden from the compiler
//    (fi_opaque), which otherwise unswitched the loop on the lane and split
//    the warp at every shuffle. Splitting the square's triangle of 55
//    products instead (21 a lane) measured no faster: the shuffles and the
//    carry, not the products, set a step's time on four lanes (PERF.md).
//  - One element a thread where the card is full (fe_inv_one): the same
//    carry on all ten columns in registers, a square in 55 products. Four
//    lanes execute more than twice the instructions an element, which
//    loses where the integer rate, not the chain, bounds the time. The
//    launcher takes four lanes while 4n threads are at most one warp per
//    SM partition (n <= 32 x SMs; ops/bringup_cuda.lanes_for) and one
//    above.
//  - The chain in registers: a loop over squares with an unrolled body, no
//    local memory. No thread returns early in the group kernel: a group past
//    n inverts a clamped copy and skips only the store, so every shuffle
//    sees its whole warp.
//
// `stamps`, when not null, receives clock64() at the chain's start and end
// from thread 0 of block 0 (cycles a step = difference / 265;
// tools/fe_inv_probe.py).
//
// The host check (tests/test_torch_fe_inv.py) compiles this file with g++
// through fe_inv_host.cpp, which defines ed_shfl and runs a group's four
// lanes as coroutines in lock-step.
#include <stdint.h>

#include "ed25519_field.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FI_CLOCK() clock64()
#define FI_MEM __device__ __forceinline__
#else
#define FI_CLOCK() 0LL
#define FI_MEM inline
#endif

#define FI_THREADS 128         // one element a thread
#define FI_GROUP_THREADS 32    // four lanes an element: a warp a block

ED_FN int fi_width(int k) { return 26 - (k & 1); }

// The pieces of column sum h of a column of width sm followed by one of
// width sn (sm + sn = 51): a stays, b goes one limb up (times mb), c two
// up (times mc), with the bits of mb * b above sn.
struct FiPieces { uint32_t a, b, c; };

ED_FN FiPieces fi_split(uint64_t h, int sm, int sn, uint32_t mb,
                        uint32_t mc) {
  FiPieces p;
  p.a = (uint32_t)h & ((1u << sm) - 1);
  const uint32_t b = mb * ((uint32_t)(h >> sm) & ((1u << sn) - 1));
  p.b = b & ((1u << sn) - 1);
  p.c = mc * (uint32_t)(h >> 51) + (b >> sn);
  return p;
}

// ---- one element a thread ----

struct Fu { uint32_t v[10]; };

ED_FN Fu fu_carry(const uint64_t h[10]) {
  uint32_t a[10], b[10], c[10];
#pragma unroll
  for (int m = 0; m < 10; m++) {
    const FiPieces p = fi_split(h[m], fi_width(m), fi_width(m + 1),
                                m == 9 ? 19 : 1, m >= 8 ? 19 : 1);
    a[m] = p.a;
    b[m] = p.b;
    c[m] = p.c;
  }
  Fu r;
#pragma unroll
  for (int k = 0; k < 10; k++)
    r.v[k] = a[k] + b[(k + 9) % 10] + c[(k + 8) % 10];
  return r;
}

ED_FN Fu fu_mul(const Fu& f, const Fu& g) {
  uint32_t f2[10], g19[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    f2[i] = 2 * f.v[i];
    g19[i] = 19 * g.v[i];
  }
  uint64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = 0; j < 10; j++) {
      const uint32_t l = ((i & 1) && (j & 1)) ? f2[i] : f.v[i];
      const uint32_t r = (i + j >= 10) ? g19[j] : g.v[j];
      h[(i + j) % 10] += (uint64_t)l * r;
    }
  }
  return fu_carry(h);
}

// the 45 cross products once (left operand doubled) and the 10 squares
ED_FN Fu fu_sq(const Fu& f) {
  uint32_t f2[10], f19[10], f38[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    f2[i] = 2 * f.v[i];
    f19[i] = 19 * f.v[i];
    f38[i] = 38 * f.v[i];
  }
  uint64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = i; j < 10; j++) {
      const bool odd = (i & 1) && (j & 1);
      const uint32_t l = i == j ? f.v[i] : f2[i];
      const uint32_t r = (i + j >= 10) ? (odd ? f38[j] : f19[j])
                                       : (odd ? f2[j] : f.v[j]);
      h[(i + j) % 10] += (uint64_t)l * r;
    }
  }
  return fu_carry(h);
}

struct FiOne {
  typedef Fu V;
  FI_MEM V sq(const V& a) { return fu_sq(a); }
  FI_MEM V mul(const V& a, const V& b) { return fu_mul(a, b); }
};

// ---- one element on a group of four lanes ----

// A value as a lane holds it: the limbs in the natural order (g) and
// rotated by the lane (r_k = g_((c+k) mod 10)).
struct F4 { uint32_t g[10], r[10]; };

// A lane's value the compiler must not see through: every lane-dependent
// constant of the group design passes through it once, so that the loop
// body stays one instruction stream for the four lanes (knowing the lane,
// the compiler unswitched the loop on it, which split the warp at every
// shuffle).
ED_FN uint32_t fi_opaque(uint32_t x) {
#ifdef __CUDACC__
  asm volatile("mov.b32 %0, %0;" : "+r"(x));
#endif
  return x;
}

// a where the mask is all ones, b where it is zero: one LOP3
ED_FN uint32_t fi_sel(uint32_t mask, uint32_t a, uint32_t b) {
  return (a & mask) | (b & ~mask);
}

ED_FN uint32_t fi_mask(bool on) { return fi_opaque(on ? ~0u : 0u); }

struct FiGroup {
  typedef F4 V;
  int src_b, src_c;         // the lanes one and two before this one
  uint32_t is0, is3, below2, above1, odd, high;   // masks of the lane
  uint32_t odd_shift;       // 1 on even lanes: two odd limbs weigh 2
  uint32_t wrap_mul[3];     // weight of W_t, t = -3..-1
  uint32_t sm, sn;          // widths of this lane's columns and the next
  uint32_t mb[3], mc[3];    // x19 of slot s's pieces b and c

  FI_MEM void init(int c) {
    src_b = (int)fi_opaque((c + 3) & 3);
    src_c = (int)fi_opaque((c + 2) & 3);
    is0 = fi_mask(c == 0);
    is3 = fi_mask(c == 3);
    below2 = fi_mask(c < 2);
    above1 = fi_mask(c >= 2);
    odd = fi_mask(c & 1);
    high = fi_mask(c & 2);
    odd_shift = fi_opaque(1 - (c & 1));
#pragma unroll
    for (int t = -3; t < 0; t++)
      wrap_mul[t + 3] = fi_opaque(c + t < 0 ? 19 : 1);
    sm = fi_opaque(fi_width(c));
    sn = fi_opaque(fi_width(c + 1));
#pragma unroll
    for (int s = 0; s < 3; s++) {
      const int m = c + 4 * s;
      mb[s] = fi_opaque(m == 9 ? 19 : 1);
      mc[s] = fi_opaque((m == 8 || m == 9) ? 19 : 1);
    }
  }

  // This lane's three column sums -> the value, every limb on every lane.
  // Limb k = c + 4s is summed here from piece a of column k (this lane),
  // piece b of column k-1 (the lane before, or lane 3's slot before, and
  // for k = 0 column 9: lane 1's slot 2) and piece c of column k-2 (two
  // lanes before, or slot before, and for k = 0, 1 this lane's slot 2);
  // then each limb is gathered from its lane. 17 shuffles.
  FI_MEM V exchange(const uint64_t h[3]) {
    uint32_t qa[3], qb[3], qc[3];
#pragma unroll
    for (int s = 0; s < 3; s++) {
      const FiPieces q = fi_split(h[s], sm, sn, mb[s], mc[s]);
      qa[s] = q.a;
      qb[s] = q.b;
      qc[s] = q.c;
    }
    const uint32_t b9 = ED_SHFL(qb[2], 1);
    uint32_t own[3];
#pragma unroll
    for (int s = 0; s < 3; s++) {
      const uint32_t sb = s > 0 ? fi_sel(is3, qb[s > 0 ? s - 1 : 0], qb[s])
                                : qb[s];
      const uint32_t sc =
          s > 0 ? fi_sel(above1, qc[s > 0 ? s - 1 : 0], qc[s]) : qc[s];
      uint32_t b = ED_SHFL(sb, src_b);
      uint32_t cc = ED_SHFL(sc, src_c);
      if (s == 0) {
        b = fi_sel(is0, b9, b);
        cc = fi_sel(below2, qc[2], cc);
      }
      own[s] = qa[s] + b + cc;
    }
    V out;
#pragma unroll
    for (int k = 0; k < 10; k++) out.g[k] = ED_SHFL(own[k / 4], k % 4);
    // the rotation by selects: the four lanes' candidates are g_k..g_(k+3)
#pragma unroll
    for (int k = 0; k < 10; k++) {
      const uint32_t lo = fi_sel(odd, out.g[(k + 1) % 10], out.g[k]);
      const uint32_t hi =
          fi_sel(odd, out.g[(k + 3) % 10], out.g[(k + 2) % 10]);
      out.r[k] = fi_sel(high, hi, lo);
    }
    return out;
  }

  // f * g: f in the natural order, g rotated; lane c sums columns c + 4s,
  // ten products each
  FI_MEM V mul_fr(const uint32_t f[10], const uint32_t r[10]) {
    uint32_t fl[10], w[18];                   // w[t + 9] = W_t
#pragma unroll
    for (int i = 0; i < 10; i++) fl[i] = (i & 1) ? f[i] << odd_shift : f[i];
#pragma unroll
    for (int t = 0; t < 9; t++) w[t + 9] = r[t];
#pragma unroll
    for (int t = -9; t < -3; t++) w[t + 9] = 19 * r[t + 10];
#pragma unroll
    for (int t = -3; t < 0; t++) w[t + 9] = wrap_mul[t + 3] * r[t + 10];
    uint64_t h[3];
#pragma unroll
    for (int s = 0; s < 3; s++) {
      h[s] = 0;
#pragma unroll
      for (int i = 0; i < 10; i++) h[s] += (uint64_t)fl[i] * w[4 * s - i + 9];
    }
    return exchange(h);
  }

  FI_MEM V sq(const V& a) { return mul_fr(a.g, a.r); }
  FI_MEM V mul(const V& a, const V& b) { return mul_fr(a.g, b.r); }
};

// x^(p-2): the curve25519 chain of fe_chain_250 and its tail (254 squares,
// 11 multiplies). Every multiply takes the running value first and a kept
// one second, so the group design keeps only the rotated limbs of the
// kept ones.
template <class Ops>
ED_FN typename Ops::V fi_pow2k(Ops& o, typename Ops::V x, int k) {
  for (int i = 0; i < k; i++) x = o.sq(x);
  return x;
}

template <class Ops>
ED_FN typename Ops::V fi_chain(Ops& o, const typename Ops::V& x) {
  typedef typename Ops::V V;
  const V z2 = o.sq(x);
  const V z9 = o.mul(fi_pow2k(o, z2, 2), x);
  const V z11 = o.mul(z9, z2);
  const V z_5 = o.mul(o.sq(z11), z9);
  const V z_10 = o.mul(fi_pow2k(o, z_5, 5), z_5);
  const V z_20 = o.mul(fi_pow2k(o, z_10, 10), z_10);
  const V z_40 = o.mul(fi_pow2k(o, z_20, 20), z_20);
  const V z_50 = o.mul(fi_pow2k(o, z_40, 10), z_10);
  const V z_100 = o.mul(fi_pow2k(o, z_50, 50), z_50);
  const V z_200 = o.mul(fi_pow2k(o, z_100, 100), z_100);
  const V t250 = o.mul(fi_pow2k(o, z_200, 50), z_50);
  return o.mul(fi_pow2k(o, t250, 5), z11);
}

ED_FN Fe fi_to_fe(const uint32_t v[10]) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = (int32_t)v[i];
  return r;
}

// One element on one thread: `in[k * stride]` -> `out[k * stride]`.
ED_FN void fe_inv_one(const int32_t* in, int32_t* out, int stride,
                      long long* stamps) {
  const Fe x = fe_from_w24(in, stride);
  Fu xu;
#pragma unroll
  for (int i = 0; i < 10; i++) xu.v[i] = (uint32_t)x.v[i];
  FiOne o;
  const long long t0 = FI_CLOCK();
  const Fu y = fi_chain(o, xu);
  if (stamps) {
    stamps[0] = t0;
    stamps[1] = FI_CLOCK();
  }
  fe_to_w24(fe_canon(fi_to_fe(y.v)), out, stride);
}

// Lane c of the group inverting `in[k * stride]`. Lane c stores limbs
// k = c mod 4 of the result when `store`.
ED_FN void fe_inv_group(int c, const int32_t* in, int32_t* out, int stride,
                        bool store, long long* stamps) {
  FiGroup o;
  o.init(c);
  const Fe x = fe_from_w24(in, stride);
  // the input as column sums: limb c + 4s (a select, not an index)
  uint64_t h[3];
#pragma unroll
  for (int s = 0; s < 3; s++) {
    const int m = c + 4 * s;
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) v = m == i ? (uint32_t)x.v[i] : v;
    h[s] = v;
  }
  const long long t0 = FI_CLOCK();
  const F4 y = fi_chain(o, o.exchange(h));
  if (stamps) {
    stamps[0] = t0;
    stamps[1] = FI_CLOCK();
  }
  int32_t limbs[24];
  fe_to_w24(fe_canon(fi_to_fe(y.g)), limbs, 1);
  if (store) {
#pragma unroll
    for (int k = 0; k < 24; k++)
      if ((k & 3) == c) out[k * stride] = limbs[k];
  }
}

#ifdef __CUDACC__

extern "C" __global__ void __launch_bounds__(FI_THREADS)
fe_inv_one_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                  int n, long long* stamps) {
  const int i = blockIdx.x * FI_THREADS + threadIdx.x;
  if (i >= n) return;
  fe_inv_one(a + i, out + i, n, i == 0 ? stamps : nullptr);
}

extern "C" __global__ void __launch_bounds__(FI_GROUP_THREADS)
fe_inv_group_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                    int n, long long* stamps) {
  const int t = threadIdx.x;
  const int g = (blockIdx.x * FI_GROUP_THREADS + t) >> 2;
  const int e = g < n ? g : n - 1;
  fe_inv_group(t & 3, a + e, out + e, n, g < n,
               blockIdx.x == 0 && t == 0 ? stamps : nullptr);
}

// ---- plain C interface (loaded with ctypes) ----
// Returns a cudaError_t as int: 0 on success. The launch goes on the
// caller's stream and does not synchronise. lanes: 4 (a group an element)
// or 1 (a thread an element); stamps: null, or two int64 on the card.
// `*launched` receives the lanes an element of the kernel that was
// launched (0 when none was).
extern "C" int fe_inv_launch(const int32_t* a, int32_t* out, int n,
                             int lanes, long long* stamps, int* launched,
                             void* stream) {
  *launched = 0;
  if (n <= 0) return 0;
  if (lanes != 1 && lanes != 4) return (int)cudaErrorInvalidValue;
  const int block = lanes == 4 ? FI_GROUP_THREADS : FI_THREADS;
  const unsigned grid =
      (unsigned)(((long long)lanes * n + block - 1) / block);
  if (lanes == 4) {
    fe_inv_group_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        a, out, n, stamps);
    *launched = 4;
  } else {
    fe_inv_one_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        a, out, n, stamps);
    *launched = 1;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* fe_inv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

#endif  // __CUDACC__
