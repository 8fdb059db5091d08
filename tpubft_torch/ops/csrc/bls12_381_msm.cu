// BLS12-381 G1 multi-scalar multiplication for Hopper (sm_90a).
//
// Replaces the jitted XLA programs of tpubft/ops/bls12_381.py:
//   msm_kernel (:46-47)         sum_i [k_i] P_i, one segment;
//   msm_batch_kernel (:137-138) S independent sums of K points each, in
//                               one launch (one combine flush);
//   batch_scalar_mul.kern (:241) [k_i] P_i for each i, no reduction.
// One ladder kernel serves all three; the MSMs add a per-segment reduce.
//
// Contract (all int64 tensors hold 32-bit words, least significant first):
//   words    (8, N)   the scalars, reduced mod r, little-endian words
//   px, py   (12, N)  affine points, Montgomery form (R = 2^384), < p
//   inf      (N,)     uint8, 1 = the identity (a None point, a padded
//                     slot, a zero scalar): the lane contributes nothing
//   out x,y,z         projective (X:Y:Z), Montgomery form, each word
//                     vector canonical (< p): (12, N) for the ladder,
//                     (12, S) for the MSM, N = S K lane-major by segment.
// The host turns (X:Y:Z) into affine (ops/bls12_381._to_affine_host).
//
// Arithmetic: Fp on twelve 32-bit words, Montgomery CIOS with the card's
// native 32x32->64 multiply (IMAD.WIDE). Elements are held loosely in
// [0, 2p): with 4p < R a product of two such elements is again below 2p,
// so the multiply needs no final subtraction; add and sub bring their
// result back into [0, 2p) with one conditional subtraction or addition
// of 2p. The curve formulas are the complete ones of Renes, Costello and
// Batina for a = 0 (b3 = 3b = 12): doubling (their algorithm 9, 6M+2S),
// mixed addition of an affine point (algorithm 8, 11M) on the ladder, and
// projective addition (algorithm 7, 12M) in the reduce. They have no
// exceptions for the identity (0:1:0) the ladder starts from, for P + P
// or for P + (-P), on any curve without points of order two, which
// E(Fp): y^2 = x^3 + 4 is not (its order is odd). The reference uses the
// general complete form (weierstrass.py:58-99); both give the same points.
//
// What bounds it on this card. A lane's work is one serial chain: up to
// 255 doublings and adds, about 19 dependent field multiplies a step, each
// 288 wide multiply-adds in order. Config 2's flush has 320 lanes (5
// shares x 64 slots) and config 4's combine 667: three to six CTAs, a few
// warps on a few of 132 SMs, so the card's integer rate is far from the
// limit and the latency of one chain is the time. The bound that
// chip_smoke.py prints counts the multiplies these scalars need
// (ops/bls12_381_cuda.field_muls) over the INT32 rate, against which this
// kernel is slow by design: a simple kernel that is right first.
// Windowing, Pippenger buckets and work split across lanes are for later.
//
// Host mode: with BLS_HOST defined the file compiles with g++ (the field,
// curve and lane functions only; ops/csrc/bls12_381_msm_host.cpp runs
// them lane by lane on the host for the CPU tests).
#include <stdint.h>

// BLS_FN: the field and lane functions, inlined. BLS_PT_FN: the three
// point formulas, kept as calls: with them inlined too, nvcc 12.9's
// front end (cicc) crashes with a segmentation fault on this file. As
// calls they cost a 288-304 byte stack frame (the points pass by
// reference) and leave the kernels at 168-188 registers.
#ifdef BLS_HOST
#define BLS_FN static inline
#define BLS_PT_FN static
#define BLS_CONST static const
#else
#include <cuda_runtime.h>
#define BLS_FN __device__ __forceinline__
#define BLS_PT_FN __device__ __noinline__
#define BLS_CONST __constant__
#endif

#define NW 12           // 32-bit words a field element
#define SW 8            // 32-bit words a scalar
#define SCALAR_BITS 255
#define LADDER_THREADS 128
#define REDUCE_THREADS 128

struct fp {
    uint32_t v[NW];
};

struct pt {
    fp x, y, z;
};

BLS_CONST uint32_t BLS_P[NW] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u,
    0x6730d2a0u, 0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u,
    0x397fe69au, 0x1a0111eau};
BLS_CONST uint32_t BLS_2P[NW] = {
    0xffff5556u, 0x73fdffffu, 0x62a7ffffu, 0x3d57fffdu, 0xed61ec48u,
    0xce61a541u, 0xe70a257eu, 0xc8ee9709u, 0x869759aeu, 0x96374f6cu,
    0x72ffcd34u, 0x340223d4u};
// R mod p: the Montgomery form of 1
BLS_CONST uint32_t BLS_ONE[NW] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau,
    0x5f489857u, 0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u,
    0xfa80e493u, 0x15f65ec3u};
// -p^-1 mod 2^32
#define BLS_PINV 0xfffcfffdu

// ---------------- Fp, loose in [0, 2p) ----------------

// r = a - m if a >= m, else a (m = p or 2p; a < 2m)
BLS_FN void fp_cond_sub(fp& r, const uint32_t* a, const uint32_t* m) {
    uint32_t d[NW];
    uint64_t bw = 0;
    for (int i = 0; i < NW; ++i) {
        uint64_t t = (uint64_t)a[i] - m[i] - bw;
        d[i] = (uint32_t)t;
        bw = t >> 63;
    }
    for (int i = 0; i < NW; ++i) r.v[i] = bw ? a[i] : d[i];
}

BLS_FN void fp_add(fp& r, const fp& a, const fp& b) {
    uint32_t s[NW];
    uint64_t c = 0;
    for (int i = 0; i < NW; ++i) {   // a + b < 4p < 2^383: no carry out
        c += (uint64_t)a.v[i] + b.v[i];
        s[i] = (uint32_t)c;
        c >>= 32;
    }
    fp_cond_sub(r, s, BLS_2P);
}

BLS_FN void fp_sub(fp& r, const fp& a, const fp& b) {
    uint32_t d[NW];
    uint64_t bw = 0;
    for (int i = 0; i < NW; ++i) {
        uint64_t t = (uint64_t)a.v[i] - b.v[i] - bw;
        d[i] = (uint32_t)t;
        bw = t >> 63;
    }
    // a < b: add 2p back (the sum wraps past 2^384 exactly once)
    uint64_t c = 0;
    for (int i = 0; i < NW; ++i) {
        c += (uint64_t)d[i] + (bw ? BLS_2P[i] : 0u);
        r.v[i] = (uint32_t)c;
        c >>= 32;
    }
}

// Montgomery product a b R^-1 (CIOS). a, b < 2p -> r < 2p (4p < R).
BLS_FN void fp_mul(fp& r, const fp& a, const fp& b) {
    uint32_t t[NW + 2];
    for (int j = 0; j < NW + 2; ++j) t[j] = 0;
    for (int i = 0; i < NW; ++i) {
        uint64_t c = 0;
        const uint64_t ai = a.v[i];
        for (int j = 0; j < NW; ++j) {
            c += ai * b.v[j] + t[j];
            t[j] = (uint32_t)c;
            c >>= 32;
        }
        c += t[NW];
        t[NW] = (uint32_t)c;
        t[NW + 1] = (uint32_t)(c >> 32);
        const uint64_t m = (uint32_t)(t[0] * BLS_PINV);
        c = (m * BLS_P[0] + t[0]) >> 32;
        for (int j = 1; j < NW; ++j) {
            c += m * BLS_P[j] + t[j];
            t[j - 1] = (uint32_t)c;
            c >>= 32;
        }
        c += t[NW];
        t[NW - 1] = (uint32_t)c;
        t[NW] = t[NW + 1] + (uint32_t)(c >> 32);
    }
    for (int j = 0; j < NW; ++j) r.v[j] = t[j];
}

// r = 12 a = b3 a, by additions
BLS_FN void fp_mul_b3(fp& r, const fp& a) {
    fp a2, a4, a8;
    fp_add(a2, a, a);
    fp_add(a4, a2, a2);
    fp_add(a8, a4, a4);
    fp_add(r, a8, a4);
}

BLS_FN void fp_canon(fp& r, const fp& a) { fp_cond_sub(r, a.v, BLS_P); }

BLS_FN void fp_set(fp& r, const uint32_t* w) {
    for (int i = 0; i < NW; ++i) r.v[i] = w[i];
}

BLS_FN void pt_identity(pt& p) {
    for (int i = 0; i < NW; ++i) {
        p.x.v[i] = 0;
        p.z.v[i] = 0;
    }
    fp_set(p.y, BLS_ONE);
}

// ---------------- G1, complete formulas for a = 0 ----------------

// r = 2p (RCB algorithm 9)
BLS_PT_FN void pt_dbl(pt& r, const pt& p) {
    fp t0, t1, t2, x3, y3, z3;
    fp_mul(t0, p.y, p.y);
    fp_add(z3, t0, t0);
    fp_add(z3, z3, z3);
    fp_add(z3, z3, z3);
    fp_mul(t1, p.y, p.z);
    fp_mul(t2, p.z, p.z);
    fp_mul_b3(t2, t2);
    fp_mul(x3, t2, z3);
    fp_add(y3, t0, t2);
    fp_mul(z3, t1, z3);
    fp_add(t1, t2, t2);
    fp_add(t2, t1, t2);
    fp_sub(t0, t0, t2);
    fp_mul(y3, t0, y3);
    fp_add(y3, x3, y3);
    fp_mul(t1, p.x, p.y);
    fp_mul(x3, t0, t1);
    fp_add(x3, x3, x3);
    r.x = x3;
    r.y = y3;
    r.z = z3;
}

// r = p + (qx, qy, 1), q not the identity (RCB algorithm 8)
BLS_PT_FN void pt_add_mixed(pt& r, const pt& p, const fp& qx, const fp& qy) {
    fp t0, t1, t2, t3, t4, x3, y3, z3;
    fp_mul(t0, p.x, qx);
    fp_mul(t1, p.y, qy);
    fp_add(t3, qx, qy);
    fp_add(t4, p.x, p.y);
    fp_mul(t3, t3, t4);
    fp_add(t4, t0, t1);
    fp_sub(t3, t3, t4);
    fp_mul(t4, qy, p.z);
    fp_add(t4, t4, p.y);
    fp_mul(y3, qx, p.z);
    fp_add(y3, y3, p.x);
    fp_add(x3, t0, t0);
    fp_add(t0, x3, t0);
    fp_mul_b3(t2, p.z);
    fp_add(z3, t1, t2);
    fp_sub(t1, t1, t2);
    fp_mul_b3(y3, y3);
    fp_mul(x3, t4, y3);
    fp_mul(t2, t3, t1);
    fp_sub(x3, t2, x3);
    fp_mul(y3, y3, t0);
    fp_mul(t1, t1, z3);
    fp_add(y3, t1, y3);
    fp_mul(t0, t0, t3);
    fp_mul(z3, z3, t4);
    fp_add(z3, z3, t0);
    r.x = x3;
    r.y = y3;
    r.z = z3;
}

// r = p + q (RCB algorithm 7)
BLS_PT_FN void pt_add(pt& r, const pt& p, const pt& q) {
    fp t0, t1, t2, t3, t4, x3, y3, z3;
    fp_mul(t0, p.x, q.x);
    fp_mul(t1, p.y, q.y);
    fp_mul(t2, p.z, q.z);
    fp_add(t3, p.x, p.y);
    fp_add(t4, q.x, q.y);
    fp_mul(t3, t3, t4);
    fp_add(t4, t0, t1);
    fp_sub(t3, t3, t4);
    fp_add(t4, p.y, p.z);
    fp_add(x3, q.y, q.z);
    fp_mul(t4, t4, x3);
    fp_add(x3, t1, t2);
    fp_sub(t4, t4, x3);
    fp_add(x3, p.x, p.z);
    fp_add(y3, q.x, q.z);
    fp_mul(x3, x3, y3);
    fp_add(y3, t0, t2);
    fp_sub(y3, x3, y3);
    fp_add(x3, t0, t0);
    fp_add(t0, x3, t0);
    fp_mul_b3(t2, t2);
    fp_add(z3, t1, t2);
    fp_sub(t1, t1, t2);
    fp_mul_b3(y3, y3);
    fp_mul(x3, t4, y3);
    fp_mul(t2, t3, t1);
    fp_sub(x3, t2, x3);
    fp_mul(y3, y3, t0);
    fp_mul(t1, t1, z3);
    fp_add(y3, t1, y3);
    fp_mul(t0, t0, t3);
    fp_mul(z3, z3, t4);
    fp_add(z3, z3, t0);
    r.x = x3;
    r.y = y3;
    r.z = z3;
}

// ---------------- lanes ----------------

BLS_FN void load_fp(fp& r, const int64_t* src, long long stride,
                    long long idx) {
    for (int i = 0; i < NW; ++i) r.v[i] = (uint32_t)src[i * stride + idx];
}

BLS_FN void store_pt(int64_t* ox, int64_t* oy, int64_t* oz, long long stride,
                     long long idx, const pt& p) {
    fp c;
    fp_canon(c, p.x);
    for (int i = 0; i < NW; ++i) ox[i * stride + idx] = c.v[i];
    fp_canon(c, p.y);
    for (int i = 0; i < NW; ++i) oy[i * stride + idx] = c.v[i];
    fp_canon(c, p.z);
    for (int i = 0; i < NW; ++i) oz[i * stride + idx] = c.v[i];
}

BLS_FN void load_pt(pt& p, const int64_t* x, const int64_t* y,
                    const int64_t* z, long long stride, long long idx) {
    load_fp(p.x, x, stride, idx);
    load_fp(p.y, y, stride, idx);
    load_fp(p.z, z, stride, idx);
}

// Lane n of N: [k] P by the msb-first double-and-add ladder from the
// identity, from k's top set bit down (the rows above it leave the
// identity as it is; shares and coefficients are public, so the lane
// need not run in constant time).
BLS_FN void ladder_lane(pt& acc, const int64_t* words, const int64_t* px,
                        const int64_t* py, const uint8_t* inf, long long n,
                        long long N) {
    pt_identity(acc);
    if (inf[n]) return;
    uint32_t k[SW];
    for (int w = 0; w < SW; ++w) k[w] = (uint32_t)words[w * N + n];
    int top = -1;
    for (int i = SCALAR_BITS - 1; i >= 0 && top < 0; --i)
        if ((k[i >> 5] >> (i & 31)) & 1u) top = i;
    fp x, y;
    load_fp(x, px, N, n);
    load_fp(y, py, N, n);
    for (int i = top; i >= 0; --i) {
        pt_dbl(acc, acc);
        if ((k[i >> 5] >> (i & 31)) & 1u) pt_add_mixed(acc, acc, x, y);
    }
}

// threads of a segment's reduce: a power of two, at most REDUCE_THREADS
static inline int reduce_threads(int K) {
    int t = 1;
    while (t < K && t < REDUCE_THREADS) t *= 2;
    return t;
}

#ifndef BLS_HOST

__global__ void __launch_bounds__(LADDER_THREADS)
bls_ladder_kernel(const int64_t* __restrict__ words,
                  const int64_t* __restrict__ px,
                  const int64_t* __restrict__ py,
                  const uint8_t* __restrict__ inf, int64_t* ox, int64_t* oy,
                  int64_t* oz, long long N) {
    long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    pt acc;
    ladder_lane(acc, words, px, py, inf, n, N);
    store_pt(ox, oy, oz, N, n, acc);
}

// Segment s = blockIdx.x: thread t adds lanes t, t + T, ... of the
// segment, then a tree over the T partial sums in shared memory
// (T = blockDim.x, a power of two).
__global__ void __launch_bounds__(REDUCE_THREADS)
bls_reduce_kernel(const int64_t* __restrict__ lx,
                  const int64_t* __restrict__ ly,
                  const int64_t* __restrict__ lz, int64_t* ox, int64_t* oy,
                  int64_t* oz, int S, int K) {
    extern __shared__ pt sh[];
    const int s = blockIdx.x, t = threadIdx.x;
    const long long N = (long long)S * K;
    pt acc;
    pt_identity(acc);
    for (int k = t; k < K; k += blockDim.x) {
        pt q;
        load_pt(q, lx, ly, lz, N, (long long)s * K + k);
        pt_add(acc, acc, q);
    }
    sh[t] = acc;
    __syncthreads();
    for (int stride = blockDim.x / 2; stride > 0; stride >>= 1) {
        if (t < stride) {
            pt_add(acc, sh[t], sh[t + stride]);
            sh[t] = acc;
        }
        __syncthreads();
    }
    if (t == 0) store_pt(ox, oy, oz, S, s, sh[0]);
}

extern "C" {

// [k_i] P_i for N lanes -> (12, N) x 3.
int bls_mul_launch(const int64_t* words, const int64_t* px,
                   const int64_t* py, const uint8_t* inf, int64_t* ox,
                   int64_t* oy, int64_t* oz, long long N, void* stream) {
    if (N <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    unsigned blocks = (unsigned)((N + LADDER_THREADS - 1) / LADDER_THREADS);
    bls_ladder_kernel<<<blocks, LADDER_THREADS, 0, st>>>(
        words, px, py, inf, ox, oy, oz, N);
    return (int)cudaGetLastError();
}

// S sums of K lanes each: the ladder into lx/ly/lz (12, S K), then the
// reduce into ox/oy/oz (12, S).
int bls_msm_launch(const int64_t* words, const int64_t* px,
                   const int64_t* py, const uint8_t* inf, int64_t* lx,
                   int64_t* ly, int64_t* lz, int64_t* ox, int64_t* oy,
                   int64_t* oz, int S, int K, void* stream) {
    if (S <= 0 || K <= 0) return 0;
    int err = bls_mul_launch(words, px, py, inf, lx, ly, lz,
                             (long long)S * K, stream);
    if (err) return err;
    int threads = reduce_threads(K);
    bls_reduce_kernel<<<S, threads, threads * sizeof(pt),
                        (cudaStream_t)stream>>>(lx, ly, lz, ox, oy, oz, S,
                                                K);
    return (int)cudaGetLastError();
}

const char* bls_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

#endif  // BLS_HOST
