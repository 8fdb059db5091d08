// BLS12-381 G1 multi-scalar multiplication for Hopper (sm_90a).
//
// Replaces the jitted XLA programs of tpubft/ops/bls12_381.py:
//   msm_kernel (:46-47)         sum_i [k_i] P_i, one segment;
//   msm_batch_kernel (:137-138) S independent sums of K points each, in
//                               one launch (one combine flush);
//   batch_scalar_mul.kern (:241) [k_i] P_i for each i, no reduction.
// One launcher serves all three: batch_scalar_mul is S = B segments of
// K = 1 point.
//
// Contract (all int64 tensors hold 32-bit words, least significant first):
//   words    (8, N)   the scalars, reduced mod r, little-endian words
//   px, py   (12, N)  affine points, Montgomery form (R = 2^384), < p
//   inf      (N,)     uint8, 1 = the identity (a None point, a padded
//                     slot, a zero scalar): the lane contributes nothing
//   out x,y,z         projective (X:Y:Z), Montgomery form, each word
//                     vector canonical (< p), (12, S); N = S K lane-major
//                     by segment.
// The host turns (X:Y:Z) into affine (ops/bls12_381._to_affine_host).
//
// Precondition: every point lies in the order-r subgroup. Signing the
// scalar (k or r - k) and the GLV split below compute [k] P only there.
// The reference assumes the same subgroup (it reduces every scalar mod
// r), and every caller's points are shares and keys decompressed with
// the subgroup check (crypto/bls12381.py g1_decompress).
//
// What bounded the per-lane ladder this replaces (16.0-17.5 ms at every
// shape on an H100) and what this design does about each cause:
//  1. One serial chain of up to 255 doublings and 128 additions a lane.
//     Now each lane's scalar is signed (k > (r-1)/2: k = r - k and -P)
//     and split by GLV, k = k1 + k2 lambda with lambda = z^2 - 1,
//     k1 = k mod lambda, k2 = k div lambda (a Barrett division by a
//     precomputed constant, in the chain's prologue), both below 2^128.
//     Half 2 rides the endomorphism (beta x, y) = [lambda] P, one field
//     multiply. Each half runs on its own group of lanes: a signed fixed
//     window of 4 bits (k' = k + 0x88..8, digit j = nibble j of k' - 8,
//     in [-8, 8)), a table of 1P..8P in shared memory, then 4 doublings
//     a window and one addition a digit: 128 doublings and 33 additions
//     a chain instead of up to 255 and 128.
//  2. A 12-word CIOS product accumulated in uint64_t and shifted, every
//     carry a 64-bit add and a shift on the dependent path. Now the
//     product is PTX carry chains (mad.lo.cc / madc.hi.cc / addc) on
//     registers, and one element lies on a group of L lanes (L = 1, 2 or
//     4, a template parameter): lane c holds words c W .. c W + W - 1
//     (W = 12 / L) of every element. In the product every lane gathers
//     all of a (12 shuffles), adds a_i b and m p to its own W words a row,
//     takes m from lane 0 (one shuffle) and its new top word from the
//     lane above (one shuffle); the carries between lanes stay pending
//     (below 4) until one carry-lookahead at the end. Additions and
//     subtractions resolve their carries between lanes by the same
//     lookahead: two ballots, one integer add (carry-in mask =
//     (G + (G | P)) ^ (P & ~G)), no serial ripple. The clock64 probe
//     below (tools/bls_msm_probe.py) reads the cycles of a product at
//     L = 1, 2, 4; four lanes were fastest on an H100 (PERF.md), and the
//     launches take L = 4 (ops/bls12_381_cuda.LANES).
//  3. The point formulas were __noinline__ calls that passed points by
//     reference through a 288-304 byte stack frame. The formulas are
//     still calls (one copy of each in the binary: inlined copies of a
//     12-word product at every call site overflow the instruction cache;
//     at L = 1, where a product is 12 unrolled rows, a doubling cost 2.4
//     times its 8 products), but their operands are points in shared
//     memory named by pointer: the values they compute stay in
//     registers, and no point passes through local memory (ptxas -v:
//     0 bytes of stack frame for pt_dbl and pt_add). Their independent
//     products run in pairs (f_mul2): a doubling is 4 steps of the chain,
//     an addition 6.
//  4. 128-thread CTAs of one lane a thread left 3-6 of 132 SMs busy. Now
//     two chains a lane, L threads a chain, and CTAs of at most 8 lanes,
//     as few lanes each as spread the launch over the SMs (bls_plan):
//     config 2's flush (S=64, K=5) is 64 CTAs, config 4's combine
//     (K=667) and its 667 multiplies 112.
//  5. The reduce was a second launch over every lane's point in int64
//     words. Now a CTA sums its chains by a tree in shared memory: a
//     segment of up to 8 lanes is summed whole in the CTA that ran it.
//     A wider segment (config 4's K=667) leaves one partial point a CTA
//     in 32-bit words, and a second launch sums the partials.
// The groups of a warp run in lock-step: every chain runs the same
// sequence of doublings and additions whatever its scalar (a zero digit
// adds the identity), and the trees' idle groups add into a spare slot,
// so the shuffles and ballots name the whole warp. Groups that branched
// on their own scalars, with shuffles naming only the group, measured
// 5.2-5.9 ms at these shapes against 1.7-1.9 in lock-step, the rest of
// the kernel as it then was (H100, PERF.md).
// What bounds it now: a chain's latency, the cycles of a step of two
// products (the probe) times the steps on the longest chain
// (ops/bls12_381_cuda.chain_floor_ms), and the additions' lookaheads
// between them; not the card's integer rate, which these shapes leave
// mostly idle.
//
// Complete formulas of Renes, Costello and Batina for a = 0 (b3 = 3b =
// 12): doubling (their algorithm 9, 6M + 2S) and projective addition
// (algorithm 7, 12M). They have no exceptions for the identity (0:1:0),
// for P + P or for P + (-P) on E(Fp): y^2 = x^3 + 4 (odd order). Elements
// are loose in [0, 2p): with 4p < R a product of two is again below 2p;
// add and sub bring their result back with one conditional subtraction
// or addition of 2p.
//
// Host mode: with BLS_HOST defined the file compiles with g++ (the field,
// curve, scalar and chain functions; ops/csrc/bls12_381_msm_host.cpp runs
// a group's lanes as coroutines in lock-step for the CPU tests and
// supplies the carry flag, bls_host_shfl and bls_host_ballot).
#include <stdint.h>

#define NW 12            // 32-bit words a field element
#define SW 8             // 32-bit words a scalar
#define PTW (3 * NW)     // words of a projective point in shared memory
#define SLOTS 10         // points a chain keeps: the sum, O, 1P..8P
#define WINDOW 4         // bits a digit
#define DIGITS 33        // digits of a half-scalar plus 0x88..8 (132 bits)
#define MAX_LANES 8      // lanes a CTA at most: 16 chains
#define MAX_CHAINS (2 * MAX_LANES)

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
// beta R mod p: beta is crypto/bls12381.py's _G1_BETA, the cube root of
// unity with (beta x, y) = [lambda] (x, y) on the subgroup
BLS_CONST uint32_t BLS_BETA[NW] = {
    0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u, 0x5dab2246u, 0xd3851b95u,
    0x587042afu, 0x01bacb9eu, 0x8eb60ebeu, 0x83d050d2u, 0x03f97d6eu,
    0x54638741u, 0x18f02065u};
// -p^-1 mod 2^32
#define BLS_PINV 0xfffcfffdu

// the group order r, (r - 1) / 2, lambda = z^2 - 1 (z = -0xd201000000010000)
// and mu = floor(2^256 / lambda)
BLS_CONST uint32_t BLS_R[SW] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u, 0x09a1d805u,
    0x3339d808u, 0x299d7d48u, 0x73eda753u};
BLS_CONST uint32_t BLS_HALF_R[SW] = {
    0x80000000u, 0x7fffffffu, 0x7fff2dffu, 0xa9ded201u, 0x04d0ec02u,
    0x199cec04u, 0x94cebea4u, 0x39f6d3a9u};
BLS_CONST uint32_t BLS_LAMBDA[4] = {0xffffffffu, 0x00000000u, 0x0001a402u,
                                    0xac45a401u};
BLS_CONST uint32_t BLS_MU[5] = {0xf6cfee30u, 0x63f6e522u, 0xe01faaddu,
                                0x7c6becf1u, 0x00000001u};

// ---------------- carry chains ----------------
// One carry flag: a chain never spans a shuffle or a ballot, so the host
// build's single flag (bls_cf) serves every lane of a group.

#ifdef BLS_HOST
static uint32_t bls_cf;
BLS_FN uint32_t add_cc(uint32_t a, uint32_t b) {
    const uint64_t s = (uint64_t)a + b;
    bls_cf = (uint32_t)(s >> 32);
    return (uint32_t)s;
}
BLS_FN uint32_t addc_cc(uint32_t a, uint32_t b) {
    const uint64_t s = (uint64_t)a + b + bls_cf;
    bls_cf = (uint32_t)(s >> 32);
    return (uint32_t)s;
}
BLS_FN uint32_t addc(uint32_t a, uint32_t b) { return a + b + bls_cf; }
BLS_FN uint32_t sub_cc(uint32_t a, uint32_t b) {
    const uint64_t d = (uint64_t)a - b;
    bls_cf = (uint32_t)(d >> 63);
    return (uint32_t)d;
}
BLS_FN uint32_t subc_cc(uint32_t a, uint32_t b) {
    const uint64_t d = (uint64_t)a - b - bls_cf;
    bls_cf = (uint32_t)(d >> 63);
    return (uint32_t)d;
}
BLS_FN uint32_t subc(uint32_t a, uint32_t b) { return a - b - bls_cf; }
BLS_FN uint32_t hi32(uint32_t a, uint32_t b) {
    return (uint32_t)(((uint64_t)a * b) >> 32);
}
BLS_FN uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    return add_cc(a * b, c);
}
BLS_FN uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    return addc_cc(a * b, c);
}
BLS_FN uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    return add_cc(hi32(a, b), c);
}
BLS_FN uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    return addc_cc(hi32(a, b), c);
}
BLS_FN uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
    return addc(hi32(a, b), c);
}
#else
#define BLS_ASM2(name, op)                                              \
    BLS_FN uint32_t name(uint32_t a, uint32_t b) {                      \
        uint32_t r;                                                     \
        asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));     \
        return r;                                                       \
    }
#define BLS_ASM3(name, op)                                              \
    BLS_FN uint32_t name(uint32_t a, uint32_t b, uint32_t c) {          \
        uint32_t r;                                                     \
        asm volatile(op " %0, %1, %2, %3;"                              \
                     : "=r"(r) : "r"(a), "r"(b), "r"(c));               \
        return r;                                                       \
    }
BLS_ASM2(add_cc, "add.cc.u32")
BLS_ASM2(addc_cc, "addc.cc.u32")
BLS_ASM2(addc, "addc.u32")
BLS_ASM2(sub_cc, "sub.cc.u32")
BLS_ASM2(subc_cc, "subc.cc.u32")
BLS_ASM2(subc, "subc.u32")
BLS_ASM3(mad_lo_cc, "mad.lo.cc.u32")
BLS_ASM3(madc_lo_cc, "madc.lo.cc.u32")
BLS_ASM3(mad_hi_cc, "mad.hi.cc.u32")
BLS_ASM3(madc_hi_cc, "madc.hi.cc.u32")
BLS_ASM3(madc_hi, "madc.hi.u32")
#endif

// ---------------- a group of L lanes ----------------

template <int L>
struct Fe {
    uint32_t v[NW / L];
};

// What a lane knows of its group: its index c, the warp's threads that
// shuffle together (all of the warp's: its groups run in lock-step), and
// its own words of p and 2p.
template <int L>
struct Grp {
    int c;
    uint32_t mask;
    uint32_t p[NW / L], p2[NW / L];
};

template <int L>
BLS_FN Grp<L> grp(int c, uint32_t mask) {
    constexpr int W = NW / L;
    Grp<L> g;
    g.c = c;
    g.mask = mask;
#pragma unroll
    for (int j = 0; j < W; ++j) {
        g.p[j] = BLS_P[c * W + j];
        g.p2[j] = BLS_2P[c * W + j];
    }
    return g;
}

template <int L>
BLS_FN uint32_t g_shfl(const Grp<L>& g, uint32_t v, int src) {
#ifdef BLS_HOST
    (void)g;
    return bls_host_shfl(v, src & (L - 1));
#else
    return __shfl_sync(g.mask, v, src, L);
#endif
}

// the group's predicates as L bits, lane c at bit c
template <int L>
BLS_FN uint32_t g_ballot(const Grp<L>& g, bool pred) {
#ifdef BLS_HOST
    (void)g;
    return bls_host_ballot(pred);
#else
    const unsigned base = (threadIdx.x & 31u) & ~(unsigned)(L - 1);
    return (__ballot_sync(g.mask, pred) >> base) & ((1u << L) - 1u);
#endif
}

// Carry-lookahead over the group: each lane's block generates a carry
// (`gen`) or passes one on (`prop`); -> the carry into this lane, and in
// `top` the carry out of the last lane. With G and P the group's bits,
// the carries in are (G + (G | P)) ^ (P & ~G) and the carry out is bit L
// of the sum. The same serves borrows.
template <int L>
BLS_FN uint32_t g_carry(const Grp<L>& g, bool gen, bool prop,
                        uint32_t& top) {
    const uint32_t G = g_ballot(g, gen), P = g_ballot(g, prop);
    const uint32_t s = G + (G | P);
    top = (s >> L) & 1u;
    return ((s ^ (P & ~G)) >> g.c) & 1u;
}

// ---------------- Fp, loose in [0, 2p) ----------------

// r = s - m if s >= m, else s (m: this lane's words of p or 2p; s < 2m)
template <int L>
BLS_FN Fe<L> f_condsub(const Grp<L>& g, const Fe<L>& s, const uint32_t* m) {
    constexpr int W = NW / L;
    Fe<L> d;
    d.v[0] = sub_cc(s.v[0], m[0]);
#pragma unroll
    for (int j = 1; j < W; ++j) d.v[j] = subc_cc(s.v[j], m[j]);
    uint32_t borrow = subc(0u, 0u) & 1u;
    if (L > 1) {
        uint32_t any = d.v[0];
#pragma unroll
        for (int j = 1; j < W; ++j) any |= d.v[j];
        const uint32_t bi = g_carry(g, borrow != 0, any == 0, borrow);
        d.v[0] = sub_cc(d.v[0], bi);
#pragma unroll
        for (int j = 1; j < W; ++j) d.v[j] = subc_cc(d.v[j], 0u);
    }
    Fe<L> r;
#pragma unroll
    for (int j = 0; j < W; ++j) r.v[j] = borrow ? s.v[j] : d.v[j];
    return r;
}

// the carries of a sum between lanes (the sum's total has no carry out)
template <int L>
BLS_FN void f_settle(const Grp<L>& g, Fe<L>& s, uint32_t carry) {
    constexpr int W = NW / L;
    if (L == 1) return;
    uint32_t all = s.v[0];
#pragma unroll
    for (int j = 1; j < W; ++j) all &= s.v[j];
    uint32_t top;
    const uint32_t ci = g_carry(g, carry != 0, all == ~0u, top);
    s.v[0] = add_cc(s.v[0], ci);
#pragma unroll
    for (int j = 1; j < W; ++j) s.v[j] = addc_cc(s.v[j], 0u);
}

template <int L>
BLS_FN Fe<L> f_add(const Grp<L>& g, const Fe<L>& a, const Fe<L>& b) {
    constexpr int W = NW / L;
    Fe<L> s;                          // a + b < 4p < 2^384: no carry out
    s.v[0] = add_cc(a.v[0], b.v[0]);
#pragma unroll
    for (int j = 1; j < W; ++j) s.v[j] = addc_cc(a.v[j], b.v[j]);
    f_settle(g, s, addc(0u, 0u));
    return f_condsub(g, s, g.p2);
}

template <int L>
BLS_FN Fe<L> f_sub(const Grp<L>& g, const Fe<L>& a, const Fe<L>& b) {
    constexpr int W = NW / L;
    Fe<L> d;
    d.v[0] = sub_cc(a.v[0], b.v[0]);
#pragma unroll
    for (int j = 1; j < W; ++j) d.v[j] = subc_cc(a.v[j], b.v[j]);
    uint32_t borrow = subc(0u, 0u) & 1u;
    if (L > 1) {
        uint32_t any = d.v[0];
#pragma unroll
        for (int j = 1; j < W; ++j) any |= d.v[j];
        const uint32_t bi = g_carry(g, borrow != 0, any == 0, borrow);
        d.v[0] = sub_cc(d.v[0], bi);
#pragma unroll
        for (int j = 1; j < W; ++j) d.v[j] = subc_cc(d.v[j], 0u);
    }
    // a < b: add 2p back (the sum wraps past 2^384 exactly once)
    const uint32_t on = 0u - borrow;
    Fe<L> r;
    r.v[0] = add_cc(d.v[0], g.p2[0] & on);
#pragma unroll
    for (int j = 1; j < W; ++j) r.v[j] = addc_cc(d.v[j], g.p2[j] & on);
    f_settle(g, r, addc(0u, 0u));
    return r;
}

// Montgomery product a b R^-1 (CIOS over the group). a, b < 2p -> < 2p.
// Row i (f_row): t += a_i b and t += m p on this lane's W words, each a
// carry chain whose top word waits in `e` (weight: the lane above's first
// word); m = t_0 p' comes from lane 0; then the shift by one word takes
// the lane above's first word. e stays below 4; f_finish carries it into
// the lane above once, after the last row, and the lookahead of f_settle
// clears the carries between lanes.
template <int L>
BLS_FN void f_row(const Grp<L>& g, uint32_t ai, const Fe<L>& b,
                  uint32_t* t, uint32_t& e) {
    constexpr int W = NW / L;
    t[0] = mad_lo_cc(ai, b.v[0], t[0]);
#pragma unroll
    for (int j = 1; j < W; ++j) t[j] = madc_lo_cc(ai, b.v[j], t[j]);
    uint32_t top1 = addc(0u, 0u);
    t[1] = mad_hi_cc(ai, b.v[0], t[1]);
#pragma unroll
    for (int j = 2; j < W; ++j) t[j] = madc_hi_cc(ai, b.v[j - 1], t[j]);
    top1 = madc_hi(ai, b.v[W - 1], top1);
    uint32_t m = t[0] * BLS_PINV;
    if (L > 1) m = g_shfl(g, m, 0);
    t[0] = mad_lo_cc(m, g.p[0], t[0]);
#pragma unroll
    for (int j = 1; j < W; ++j) t[j] = madc_lo_cc(m, g.p[j], t[j]);
    uint32_t top2 = addc(0u, 0u);
    t[1] = mad_hi_cc(m, g.p[0], t[1]);
#pragma unroll
    for (int j = 2; j < W; ++j) t[j] = madc_hi_cc(m, g.p[j - 1], t[j]);
    top2 = madc_hi(m, g.p[W - 1], top2);
    uint32_t up = 0;
    if (L > 1) {
        up = g_shfl(g, t[0], g.c + 1);
        if (g.c == L - 1) up = 0;
    }
#pragma unroll
    for (int j = 0; j < W - 1; ++j) t[j] = t[j + 1];
    uint32_t w = add_cc(up, e);
    uint32_t ne = addc(0u, 0u);
    w = add_cc(w, top1);
    ne = addc(ne, 0u);
    t[W - 1] = add_cc(w, top2);
    e = addc(ne, 0u);
}

template <int L>
BLS_FN Fe<L> f_finish(const Grp<L>& g, const uint32_t* t, uint32_t e) {
    constexpr int W = NW / L;
    Fe<L> r;
#pragma unroll
    for (int j = 0; j < W; ++j) r.v[j] = t[j];
    if (L > 1) {
        uint32_t in = g_shfl(g, e, g.c - 1);
        if (g.c == 0) in = 0;
        r.v[0] = add_cc(r.v[0], in);
#pragma unroll
        for (int j = 1; j < W; ++j) r.v[j] = addc_cc(r.v[j], 0u);
        f_settle(g, r, addc(0u, 0u));
    }
    return r;
}

// The rows run as a loop over the lane that holds a_i (its W rows
// unrolled): fully unrolled, the product was 1,088 cycles alone against
// 1,558 but the kernel took 20-25% longer, its code too large for the
// instruction cache between the formulas (H100).
template <int L>
BLS_FN Fe<L> f_mul(const Grp<L>& g, const Fe<L>& a, const Fe<L>& b) {
    constexpr int W = NW / L;
    uint32_t t[W], e = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) t[j] = 0;
#pragma unroll 1
    for (int src = 0; src < L; ++src) {
        uint32_t as[W];
#pragma unroll
        for (int j = 0; j < W; ++j)
            as[j] = L == 1 ? a.v[j] : g_shfl(g, a.v[j], src);
#pragma unroll
        for (int i = 0; i < W; ++i) f_row(g, as[i], b, t, e);
    }
    return f_finish(g, t, e);
}

// Two independent products, r = a b and s = c d, row by row in one loop:
// while one waits on a shuffle the other's carry chains run. The point
// formulas pair their independent products this way (H100: the kernel
// 19-20% faster than with the products one after another).
template <int L>
BLS_FN void f_mul2(const Grp<L>& g, const Fe<L>& a, const Fe<L>& b,
                   const Fe<L>& c, const Fe<L>& d, Fe<L>& r, Fe<L>& s) {
    constexpr int W = NW / L;
    uint32_t t[W], u[W], e = 0, f = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) t[j] = u[j] = 0;
#pragma unroll 1
    for (int src = 0; src < L; ++src) {
        uint32_t as[W], cs[W];
#pragma unroll
        for (int j = 0; j < W; ++j) {
            as[j] = L == 1 ? a.v[j] : g_shfl(g, a.v[j], src);
            cs[j] = L == 1 ? c.v[j] : g_shfl(g, c.v[j], src);
        }
#pragma unroll
        for (int i = 0; i < W; ++i) {
            f_row(g, as[i], b, t, e);
            f_row(g, cs[i], d, u, f);
        }
    }
    r = f_finish(g, t, e);
    s = f_finish(g, u, f);
}

// 12 a = b3 a, by additions
template <int L>
BLS_FN Fe<L> f_b3(const Grp<L>& g, const Fe<L>& a) {
    const Fe<L> a2 = f_add(g, a, a);
    const Fe<L> a4 = f_add(g, a2, a2);
    return f_add(g, f_add(g, a4, a4), a4);
}

template <int L>
BLS_FN Fe<L> f_zero() {
    Fe<L> r;
#pragma unroll
    for (int j = 0; j < NW / L; ++j) r.v[j] = 0;
    return r;
}

template <int L>
BLS_FN Fe<L> f_const(const Grp<L>& g, const uint32_t* w) {
    Fe<L> r;
#pragma unroll
    for (int j = 0; j < NW / L; ++j) r.v[j] = w[g.c * (NW / L) + j];
    return r;
}

// ---------------- points in shared memory ----------------
// A point is PTW words: X, Y, Z, twelve words each; lane c reads and
// writes words c W .. c W + W - 1 of each.

template <int L>
BLS_FN Fe<L> ld_fe(const Grp<L>& g, const uint32_t* s) {
    Fe<L> r;
#pragma unroll
    for (int j = 0; j < NW / L; ++j) r.v[j] = s[g.c * (NW / L) + j];
    return r;
}

template <int L>
BLS_FN void st_fe(const Grp<L>& g, uint32_t* s, const Fe<L>& a) {
#pragma unroll
    for (int j = 0; j < NW / L; ++j) s[g.c * (NW / L) + j] = a.v[j];
}

template <int L>
BLS_FN void st_pt(const Grp<L>& g, uint32_t* s, const Fe<L>& x,
                  const Fe<L>& y, const Fe<L>& z) {
    st_fe(g, s, x);
    st_fe(g, s + NW, y);
    st_fe(g, s + 2 * NW, z);
}

template <int L>
BLS_FN void st_identity(const Grp<L>& g, uint32_t* s) {
    st_pt(g, s, f_zero<L>(), f_const(g, BLS_ONE), f_zero<L>());
}

// ---------------- G1, complete formulas for a = 0 ----------------

// d = 2a (RCB algorithm 9, its products in four independent pairs); d
// may be a
template <int L>
BLS_PT_FN void pt_dbl(uint32_t* d, const uint32_t* a, int c, uint32_t mask) {
    const Grp<L> g = grp<L>(c, mask);
    const Fe<L> x = ld_fe(g, a), y = ld_fe(g, a + NW), z = ld_fe(g, a + 2 * NW);
    Fe<L> t0, t1, t2, xy, x3, z3, u, v;
    f_mul2(g, y, y, y, z, t0, t1);
    f_mul2(g, z, z, x, y, t2, xy);
    t2 = f_b3(g, t2);
    Fe<L> z8 = f_add(g, t0, t0);
    z8 = f_add(g, z8, z8);
    z8 = f_add(g, z8, z8);
    f_mul2(g, t2, z8, t1, z8, x3, z3);
    Fe<L> y3 = f_add(g, t0, t2);
    t1 = f_add(g, t2, t2);
    t2 = f_add(g, t1, t2);
    t0 = f_sub(g, t0, t2);
    f_mul2(g, t0, y3, t0, xy, u, v);
    y3 = f_add(g, x3, u);
    x3 = f_add(g, v, v);
    st_pt(g, d, x3, y3, z3);
}

// d = a + (b, or -b where negb) (RCB algorithm 7, its products in six
// independent pairs); d may be a or b
template <int L>
BLS_PT_FN void pt_add(uint32_t* d, const uint32_t* a, const uint32_t* b,
                      uint32_t negb, int c, uint32_t mask) {
    const Grp<L> g = grp<L>(c, mask);
    const Fe<L> px = ld_fe(g, a), py = ld_fe(g, a + NW), pz = ld_fe(g, a + 2 * NW);
    const Fe<L> qx = ld_fe(g, b), qz = ld_fe(g, b + 2 * NW);
    Fe<L> qy = ld_fe(g, b + NW);
    const Fe<L> qn = f_sub(g, f_zero<L>(), qy);
#pragma unroll
    for (int j = 0; j < NW / L; ++j) qy.v[j] = negb ? qn.v[j] : qy.v[j];
    Fe<L> t0, t1, t2, t3, t4, x3, y3, z3;
    f_mul2(g, px, qx, py, qy, t0, t1);
    f_mul2(g, pz, qz, f_add(g, px, py), f_add(g, qx, qy), t2, t3);
    f_mul2(g, f_add(g, py, pz), f_add(g, qy, qz), f_add(g, px, pz),
           f_add(g, qx, qz), t4, x3);
    t3 = f_sub(g, t3, f_add(g, t0, t1));
    t4 = f_sub(g, t4, f_add(g, t1, t2));
    y3 = f_sub(g, x3, f_add(g, t0, t2));
    t0 = f_add(g, f_add(g, t0, t0), t0);
    t2 = f_b3(g, t2);
    z3 = f_add(g, t1, t2);
    t1 = f_sub(g, t1, t2);
    y3 = f_b3(g, y3);
    Fe<L> u, v;
    f_mul2(g, t4, y3, t3, t1, x3, t2);
    x3 = f_sub(g, t2, x3);
    f_mul2(g, y3, t0, t1, z3, y3, t1);
    y3 = f_add(g, t1, y3);
    f_mul2(g, t0, t3, z3, t4, u, v);
    z3 = f_add(g, v, u);
    st_pt(g, d, x3, y3, z3);
}

// ---------------- the scalar: sign, GLV split, digits ----------------

// k (8 words, < r) -> k1, k2 (4 words each, < 2^128) and whether the
// point is negated: k or r - k, whichever is at most (r - 1) / 2, is
// k1 + k2 lambda with k2 = floor(k / lambda), by Barrett: q = floor(k mu /
// 2^256) is at most 2 below k2, corrected by subtracting lambda.
BLS_FN void glv_split(const uint32_t kin[SW], uint32_t k1[4], uint32_t k2[4],
                      uint32_t& neg) {
    uint32_t k[SW];
    int cmp = 0;
    for (int i = SW - 1; i >= 0; --i)
        if (cmp == 0)
            cmp = kin[i] > BLS_HALF_R[i] ? 1 : kin[i] < BLS_HALF_R[i] ? -1 : 0;
    neg = cmp > 0;
    uint64_t bw = 0;
    for (int i = 0; i < SW; ++i) {
        const uint64_t d = neg ? (uint64_t)BLS_R[i] - kin[i] - bw
                               : (uint64_t)kin[i];
        k[i] = (uint32_t)d;
        bw = neg ? (d >> 63) : 0;
    }
    // k mu: 13 words; q = words 8..11 (k < 2^254: q < 2^127)
    uint32_t prod[SW + 5];
    for (int i = 0; i < SW + 5; ++i) prod[i] = 0;
    for (int i = 0; i < SW; ++i) {
        uint64_t c = 0;
        for (int j = 0; j < 5; ++j) {
            c += (uint64_t)k[i] * BLS_MU[j] + prod[i + j];
            prod[i + j] = (uint32_t)c;
            c >>= 32;
        }
        prod[i + 5] = (uint32_t)c;
    }
    uint32_t q[4];
    for (int i = 0; i < 4; ++i) q[i] = prod[SW + i];
    // rem = k - q lambda (at most 3 lambda, below 2^130)
    uint32_t ql[SW];
    for (int i = 0; i < SW; ++i) ql[i] = 0;
    for (int i = 0; i < 4; ++i) {
        uint64_t c = 0;
        for (int j = 0; j < 4; ++j) {
            c += (uint64_t)q[i] * BLS_LAMBDA[j] + ql[i + j];
            ql[i + j] = (uint32_t)c;
            c >>= 32;
        }
        ql[i + 4] = (uint32_t)c;
    }
    uint32_t rem[5];
    bw = 0;
    for (int i = 0; i < 5; ++i) {
        const uint64_t d = (uint64_t)k[i] - ql[i] - bw;
        rem[i] = (uint32_t)d;
        bw = d >> 63;
    }
    for (int it = 0; it < 3; ++it) {
        // rem >= lambda: subtract it and count one more
        uint32_t d[5];
        bw = 0;
        for (int i = 0; i < 5; ++i) {
            const uint64_t t = (uint64_t)rem[i] - (i < 4 ? BLS_LAMBDA[i] : 0u) - bw;
            d[i] = (uint32_t)t;
            bw = t >> 63;
        }
        uint64_t c = bw ? 0 : 1;
        for (int i = 0; i < 5; ++i) rem[i] = bw ? rem[i] : d[i];
        for (int i = 0; i < 4; ++i) {
            c += q[i];
            q[i] = (uint32_t)c;
            c >>= 32;
        }
    }
    for (int i = 0; i < 4; ++i) {
        k1[i] = rem[i];
        k2[i] = q[i];
    }
}

// kh + 0x888...8 (DIGITS nibbles): digit j = nibble j - 8, in [-8, 8)
BLS_FN void recode(const uint32_t kh[4], uint32_t kp[5]) {
    uint64_t c = 0;
    for (int i = 0; i < 5; ++i) {
        c += (uint64_t)(i < 4 ? kh[i] : 0u) + (i < 4 ? 0x88888888u : 0x8u);
        kp[i] = (uint32_t)c;
        c >>= 32;
    }
}

// (selects, not an index: kp stays in registers)
BLS_FN int digit(const uint32_t kp[5], int j) {
    const int w = j >> 3;
    const uint32_t v = w == 0 ? kp[0] : w == 1 ? kp[1] : w == 2 ? kp[2]
                     : w == 3 ? kp[3] : kp[4];
    return (int)((v >> (4 * (j & 7))) & 15u) - 8;
}

// ---------------- a chain ----------------

// Slots of a chain in shared memory: the running sum, the identity, then
// 1P..8P; the table's slot m is SLOT_T + m, the identity's SLOT_T.
#define SLOT_T 1

// One GLV half of lane n on the group: [k_half] (+-P, or its
// endomorphism image) into slots[0..PTW). Every chain runs the same
// sequence, whatever its scalar: the table 2P..8P, then from the top
// digit (DIGITS - 1) down 4 doublings a window (none before the first)
// and one addition of +-T[|d|], T[0] the identity, which the complete
// formulas add like any point. The groups of a warp therefore run in
// lock-step, and their shuffles and ballots can name the whole warp. A
// dead lane (the identity, a padded slot) runs the same sequence on the
// scalar 0: every digit 0, its sum the identity.
template <int L>
BLS_FN void chain(uint32_t* slots, int c, uint32_t mask, bool live,
                         const int64_t* words, const int64_t* px,
                         const int64_t* py, long long n, long long N,
                         int half) {
    constexpr int W = NW / L;
    const Grp<L> g = grp<L>(c, mask);
    uint32_t k[SW], k1[4], k2[4], kp[5], neg;
    for (int i = 0; i < SW; ++i) k[i] = live ? (uint32_t)words[i * N + n] : 0u;
    glv_split(k, k1, k2, neg);
    for (int i = 0; i < 4; ++i) k1[i] = half ? k2[i] : k1[i];
    recode(k1, kp);
    Fe<L> x, y;
#pragma unroll
    for (int j = 0; j < W; ++j) {
        x.v[j] = live ? (uint32_t)px[(c * W + j) * N + n] : 0u;
        y.v[j] = live ? (uint32_t)py[(c * W + j) * N + n] : 0u;
    }
    const Fe<L> yn = f_sub(g, f_zero<L>(), y);
    const Fe<L> xb = f_mul(g, x, f_const(g, BLS_BETA));
#pragma unroll
    for (int j = 0; j < W; ++j) {
        y.v[j] = neg ? yn.v[j] : y.v[j];
        x.v[j] = half ? xb.v[j] : x.v[j];
    }
    uint32_t* T = slots + SLOT_T * PTW;
    st_identity(g, T);
    st_identity(g, slots);
    st_pt(g, T + PTW, x, y, f_const(g, BLS_ONE));
    for (int m = 2; m <= 8; ++m) {
        if (m & 1)
            pt_add<L>(T + m * PTW, T + (m - 1) * PTW, T + PTW, 0, c, mask);
        else
            pt_dbl<L>(T + m * PTW, T + (m / 2) * PTW, c, mask);
    }
    for (int j = DIGITS - 1; j >= 0; --j) {
        if (j < DIGITS - 1)
            for (int i = 0; i < WINDOW; ++i) pt_dbl<L>(slots, slots, c, mask);
        const int d = digit(kp, j);
        pt_add<L>(slots, slots, T + (d < 0 ? -d : d) * PTW, d < 0, c, mask);
    }
}

// canonical words of a point, this lane's, into (12, S) int64 at column
// s where `store` (every group of the warp computes them)
template <int L>
BLS_FN void store_final(const uint32_t* pt, int c, uint32_t mask,
                               bool store, int64_t* ox, int64_t* oy,
                               int64_t* oz, int S, long long s) {
    const Grp<L> g = grp<L>(c, mask);
    int64_t* outs[3] = {ox, oy, oz};
    for (int k = 0; k < 3; ++k) {
        const Fe<L> v = f_condsub(g, ld_fe(g, pt + k * NW), g.p);
        if (store)
#pragma unroll
            for (int j = 0; j < NW / L; ++j)
                outs[k][(long long)(c * (NW / L) + j) * S + s] = v.v[j];
    }
}

// ---------------- the launch plan ----------------

// CTAs of `piece` lanes of one segment (two chains a lane), or `spc` whole
// segments of K <= MAX_LANES lanes, as few lanes a CTA as spread the lanes
// over `sms` SMs. A segment wider than MAX_LANES lanes is `pps` pieces;
// then each CTA leaves a partial point and a second launch of
// `reduce_groups` groups a segment sums them.
struct BlsPlan {
    int piece, spc, pps, ctas, threads, chains, reduce_groups;
};

static inline BlsPlan bls_plan(int S, int K, int L, int sms) {
    BlsPlan pl;
    const long long lanes = (long long)S * K;
    long long t = (lanes + sms - 1) / (sms > 0 ? sms : 1);
    if (t < 1) t = 1;
    if (t > MAX_LANES) t = MAX_LANES;
    if (K <= MAX_LANES) {
        pl.piece = K;
        pl.spc = (int)(t / K) > 1 ? (int)(t / K) : 1;
        pl.pps = 1;
        pl.ctas = (S + pl.spc - 1) / pl.spc;
    } else {
        pl.piece = (int)t;
        pl.spc = 1;
        pl.pps = (K + pl.piece - 1) / pl.piece;
        pl.ctas = S * pl.pps;
    }
    pl.chains = pl.spc * 2 * pl.piece;
    pl.threads = pl.chains * L;
    pl.reduce_groups = pl.pps > 1 ? (pl.pps < MAX_CHAINS ? pl.pps : MAX_CHAINS)
                                  : 0;
    return pl;
}

#ifndef BLS_HOST

// the threads of this warp that the block has: the groups of a warp run
// in lock-step, so their shuffles and ballots name all of them
__device__ __forceinline__ uint32_t warp_mask() {
    const unsigned n = blockDim.x - (threadIdx.x & ~31u);
    return n >= 32 ? ~0u : (1u << n) - 1u;
}

// A lane's index in its group, hidden from the compiler so that it
// cannot unswitch a loop on it (and split the group at every shuffle).
__device__ __forceinline__ int opaque(int x) {
    asm volatile("mov.b32 %0, %0;" : "+r"(x));
    return x;
}

// Chains, then the tree of each piece in shared memory, then its sum:
// the segment's result (pps == 1) or a partial point (pps > 1). At every
// level of the tree each group adds: a pair's first group into its sum,
// the others into their own table's last slot, unused by then.
template <int L>
__global__ void __launch_bounds__(MAX_CHAINS * L)
bls_chain_kernel(const int64_t* __restrict__ words,
                 const int64_t* __restrict__ px,
                 const int64_t* __restrict__ py,
                 const uint8_t* __restrict__ inf, int64_t* ox, int64_t* oy,
                 int64_t* oz, uint32_t* partial, int S, int K, int piece,
                 int spc, int pps) {
    extern __shared__ uint32_t sh[];
    const int t = threadIdx.x, gid = t / L, c = opaque(t % L);
    const uint32_t mask = warp_mask();
    const int width = 2 * piece;                  // chains a piece
    const int pi = gid / width, gi = gid % width;
    const long long q = (long long)blockIdx.x * spc + pi;
    const bool live_piece = q < (long long)S * pps;
    const long long s = live_piece ? q / pps : 0;
    const int kk = (int)(live_piece ? q % pps : 0) * piece + gi / 2;
    const long long N = (long long)S * K, n = s * K + kk;
    const bool live = live_piece && kk < K && !inf[n];
    uint32_t* slots = sh + (long long)gid * SLOTS * PTW;
    chain<L>(slots, c, mask, live, words, px, py, n, N, gi & 1);
    __syncthreads();
    uint32_t* base = sh + (long long)(pi * width) * SLOTS * PTW;
    for (int stride = 1; stride < width; stride *= 2) {
        const bool adds = gi % (2 * stride) == 0 && gi + stride < width;
        pt_add<L>(adds ? slots : slots + (SLOTS - 1) * PTW, slots,
                  adds ? base + (gi + stride) * SLOTS * PTW : slots, 0, c,
                  mask);
        __syncthreads();
    }
    if (pps == 1) {
        store_final<L>(slots, c, mask, live_piece && gi == 0, ox, oy, oz, S,
                       s);
    } else if (live_piece && gi == 0) {
        for (int w = c; w < PTW; w += L) partial[q * PTW + w] = slots[w];
    }
}

// Segment s = blockIdx.x: group g sums partials g, g + G, ... (G =
// blockDim.x / L; past the last, the identity), then a tree over the G
// sums in shared memory, every group adding at every step as above.
template <int L>
__global__ void __launch_bounds__(MAX_CHAINS * L)
bls_reduce_kernel(const uint32_t* __restrict__ partial, int64_t* ox,
                  int64_t* oy, int64_t* oz, int S, int pps) {
    extern __shared__ uint32_t sh[];
    const int t = threadIdx.x, gid = t / L, c = opaque(t % L);
    const int G = blockDim.x / L;
    const uint32_t mask = warp_mask();
    const long long s = blockIdx.x;
    uint32_t* slot = sh + gid * 2 * PTW;
    uint32_t* spare = slot + PTW;
    {
        const Grp<L> g = grp<L>(c, mask);
        st_identity(g, slot);
        st_identity(g, spare);
    }
    const int rounds = (pps + G - 1) / G;
    for (int r = 0; r < rounds; ++r) {
        const int j = gid + r * G;
        pt_add<L>(slot, slot, j < pps ? partial + (s * pps + j) * PTW : spare,
                  0, c, mask);
    }
    __syncthreads();
    for (int stride = 1; stride < G; stride *= 2) {
        const bool adds = gid % (2 * stride) == 0 && gid + stride < G;
        pt_add<L>(adds ? slot : spare, slot,
                  adds ? sh + (gid + stride) * 2 * PTW : slot, 0, c, mask);
        __syncthreads();
    }
    store_final<L>(slot, c, mask, gid == 0, ox, oy, oz, S, s);
}

// clock64 cycles of `iters` dependent field products, of `iters` steps
// of two dependent products side by side (f_mul2) and of iters / 8
// dependent doublings on one group (block 0, one group a block).
template <int L>
__global__ void bls_probe_kernel(int iters, long long* stamps,
                                 uint32_t* sink) {
    __shared__ uint32_t sh[PTW];
    const int c = opaque(threadIdx.x % L);
    const uint32_t mask = warp_mask();
    const Grp<L> g = grp<L>(c, mask);
    Fe<L> x = f_const(g, BLS_ONE), y = f_const(g, BLS_BETA);
    st_pt(g, sh, y, x, y);
    __syncwarp(mask);
    Fe<L> z = y;
    const long long t0 = clock64();
    for (int i = 0; i < iters; ++i) x = f_mul(g, x, y);
    const long long t1 = clock64();
    for (int i = 0; i < iters / 8; ++i) pt_dbl<L>(sh, sh, c, mask);
    const long long t2 = clock64();
    for (int i = 0; i < iters; ++i) f_mul2(g, x, y, z, y, x, z);
    const long long t3 = clock64();
    for (int j = 0; j < NW / L; ++j)
        sink[c * (NW / L) + j] = x.v[j] ^ z.v[j] ^ sh[c * (NW / L) + j];
    if (c == 0) {
        stamps[0] = t1 - t0;
        stamps[1] = t2 - t1;
        stamps[2] = t3 - t2;
    }
}

template <int L>
static int launch(const int64_t* words, const int64_t* px, const int64_t* py,
                  const uint8_t* inf, int64_t* ox, int64_t* oy, int64_t* oz,
                  uint32_t* partial, int S, int K, int sms,
                  cudaStream_t st) {
    const BlsPlan pl = bls_plan(S, K, L, sms);
    const size_t smem = (size_t)pl.chains * SLOTS * PTW * sizeof(uint32_t);
    bls_chain_kernel<L><<<pl.ctas, pl.threads, smem, st>>>(
        words, px, py, inf, ox, oy, oz, partial, S, K, pl.piece, pl.spc,
        pl.pps);
    int err = (int)cudaGetLastError();
    if (err || pl.pps == 1) return err;
    bls_reduce_kernel<L><<<S, pl.reduce_groups * L,
                           pl.reduce_groups * 2 * PTW * sizeof(uint32_t),
                           st>>>(partial, ox, oy, oz, S, pl.pps);
    return (int)cudaGetLastError();
}

// the current card's SMs (read once)
static int bls_sms() {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0, n = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        sms = n > 0 ? n : 1;
    }
    return sms;
}

extern "C" {

// S sums of K lanes each -> (12, S) x 3, on `lanes` (1, 2 or 4) lanes an
// element, planned for the current card's SMs; [k_i] P_i for B lanes is
// S = B, K = 1. `partial`: PTW uint32 a piece (bls_msm_plan's S x pps),
// unused when pps is 1.
int bls_msm_launch(const int64_t* words, const int64_t* px,
                   const int64_t* py, const uint8_t* inf, int64_t* ox,
                   int64_t* oy, int64_t* oz, uint32_t* partial, int S, int K,
                   int lanes, void* stream) {
    if (S <= 0 || K <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const int sms = bls_sms();
    switch (lanes) {
        case 1:
            return launch<1>(words, px, py, inf, ox, oy, oz, partial, S, K,
                             sms, st);
        case 2:
            return launch<2>(words, px, py, inf, ox, oy, oz, partial, S, K,
                             sms, st);
        case 4:
            return launch<4>(words, px, py, inf, ox, oy, oz, partial, S, K,
                             sms, st);
    }
    return (int)cudaErrorInvalidValue;
}

// stamps (3 int64 on the card): cycles of `iters` products, of iters / 8
// doublings, of `iters` pairs of products; sink: NW uint32 on the card
int bls_probe_launch(int lanes, int iters, long long* stamps, uint32_t* sink,
                     void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (lanes) {
        case 1: bls_probe_kernel<1><<<1, 1, 0, st>>>(iters, stamps, sink); break;
        case 2: bls_probe_kernel<2><<<1, 2, 0, st>>>(iters, stamps, sink); break;
        case 4: bls_probe_kernel<4><<<1, 4, 0, st>>>(iters, stamps, sink); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

const char* bls_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

#endif  // BLS_HOST

extern "C" {

// the plan of a launch: piece, spc, pps, ctas, threads, chains,
// reduce_groups into out[0..7)
int bls_msm_plan(int S, int K, int lanes, int sms, int* out) {
    const BlsPlan pl = bls_plan(S, K, lanes, sms);
    const int v[7] = {pl.piece, pl.spc, pl.pps, pl.ctas, pl.threads,
                      pl.chains, pl.reduce_groups};
    for (int i = 0; i < 7; ++i) out[i] = v[i];
    return 0;
}

}  // extern "C"
