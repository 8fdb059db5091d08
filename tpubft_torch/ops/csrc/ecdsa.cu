// ECDSA verification kernels for Hopper (sm_90a): the RLC fold and the
// per-item verify over secp256k1 (a = 0) and P-256 (a = -3).
//
// Replaces the JAX package's two jitted XLA programs of
// tpubft/ops/ecdsa.py: make_rlc_kernel (:303-304, the body
// rlc_fold_body :267-300) and make_verify_kernel.<locals>.kernel
// (:169-184). Wrapper: ops/ecdsa_cuda.py; plain versions:
// ops/ecdsa.rlc_fold_plain / verify_plain (ops/ecdsa._ladder runs this
// file's schedule on Curve.window_sum / fixed_base_sum / jac_add).
//
// ecdsa_rlc, per lane i:
//   T = [u1]G + [u2]Q = (X : Y : Z), Jacobian (x = X / Z^2)
//   d1 = X - r Z^2,  d2 = X - (r+n) Z^2 where wrap_ok, else 1
//   rho = d1 d2;  rho = 1 where Z = 0;  rho = 0 on an inactive lane
//   w = a rho
// then sum_i w_i over the launch: a tree over each CTA's lanes into one
// partial a CTA, and a second kernel that sums the partials in a fixed
// order (no atomics: the sum is deterministic). The host's verdict is
// "the sum is 0". ecdsa_verify, per item: the same T, x = X (1/Z)^2, the
// verdict x == r or x == r+n, and Z != 0; writes the verdicts (B,) and
// x (8, B). Inputs and outputs are canonical integers as (8, B)
// little-endian 32-bit words (word k of lane i at k * B + i); the field
// keeps canonical integers too (no Montgomery form), so nothing is
// converted on the way in or out.
//
// What bounded the design this replaces (7.57-10.43 ms a launch at any
// width on an H100, about 2,500 cycles a product) and what this one
// does about each cause:
//  1. One thread a lane in CTAs of 64: a launch of 6 lanes ran 6
//     threads on one SM. Now each lane has two threads, one in each warp
//     of a 64-thread CTA: warp 0 runs [u2]Q, warp 1 [u1]G, and a CTA
//     holds as few lanes (at most EC_LPC) as spread the launch over the
//     SMs (ops/ecdsa_cuda.lanes_per_cta): 6 lanes are 6 CTAs, 128
//     lanes 128.
//  2. A CIOS product in uint64_t, every carry a 64-bit add and a shift,
//     on points in local memory (1,024-byte stack frames). Now the
//     product (and a dedicated squaring) is PTX carry chains on
//     registers (mad.lo.cc / madc.hi.cc / addc) into 16 words, reduced
//     by the prime's shape: secp256k1's 2^256 = 2^32 + 977 folds the
//     high half twice; P-256's Solinas form sums nine word vectors in
//     signed 64-bit columns (the probe's Montgomery product, f_mul_mont,
//     took 1,190-1,200 cycles against 940-1,040 on an H100). The
//     products are __noinline__ calls on values in registers, and the
//     formulas run their independent products in pairs (f_mul2: a pair
//     1,650 cycles against 2 x 1,040). The point formulas are
//     __noinline__ calls too (inlined copies crashed cicc 12.9) on points
//     in shared memory named by pointer and stride; their values stay in
//     registers (ptxas: 0 bytes of stack frame anywhere). Two other
//     forms of the product, rows of 64-bit multiply-adds in plain C and
//     each row's low and high halves as two chains, ran no faster.
//  3. A binary Shamir ladder of 256 general complete additions of acc to
//     itself (14-18 products) and up to 256 more. Now Jacobian formulas:
//     a doubling of 7 products (a = 0: 3M + 4S) or 8 (a = -3: 4M + 4S),
//     an addition of 16 (12M + 4S), a mixed addition of 11 (8M + 3S).
//     [u2]Q: signed 5-bit windows (digits in [-16, 16)) over a table of
//     1Q..16Q in shared memory; on secp256k1 u2 splits by GLV in the
//     thread's prologue (glv_split, scalar._glv_split's exact rounding)
//     into two halves below 2^128 that share one chain of doublings, the
//     second on phi(Q) = (beta X : Y : Z): 125 doublings and up to 52
//     additions instead of 256 and 256, P-256 255 and up to 52. [u1]G:
//     G is fixed, so its multiples are affine tables made once from the
//     curve's parameters (ops/ecdsa.fixed_base_table, uploaded by the
//     wrapper): u1 in 33 signed 8-bit digits, one mixed addition a
//     nonzero digit and no doubling, on the lane's second thread; one
//     addition joins the parts.
//  4. A Fermat inversion by square and multiply (about 500 products on
//     secp256k1). Now 4-bit fixed windows over the constant p - 2: 252
//     squarings and a product a nonzero nibble.
// Jacobian additions are not complete, and a forger picks u1, u2 and Q.
// Each formula detects its exceptional inputs in the thread and computes
// the true point there: P1 = O gives P2, P2 = O gives P1, P1 = P2 (H = R
// = 0) the doubling, and P1 = -P2 (H = 0, R != 0) gives Z3 = 0, the
// identity. Doublings need no case: Z = 0 stays 0, and neither curve has
// a point of order 2. A zero digit adds nothing. The plain version makes
// the same choices by selects, so the fold's value (which scales with
// each lane's Z^2) is the plain version's to the word.
// What bounds it now: one lane's chain of dependent products, the cycles
// of a doubling and an addition (the clock64 probe, ecdsa_probe_kernel)
// times the steps of the longest chain (ops/ecdsa_cuda.chain_floor_ms);
// not the card's integer rate, which these widths leave mostly idle.
//
// Host mode: with ECDSA_HOST defined the file compiles as plain C++
// (csrc/ecdsa_host.cpp runs each lane's two parts one after the other on
// the host for the CPU tests, the carry flag one variable).
#include <stddef.h>
#include <stdint.h>

#ifdef ECDSA_HOST
#define EC_FN static inline
#define EC_PT_FN static __attribute__((noinline))
#define EC_CONST static const
// the host build counts its field products (ops/ecdsa_cuda.kernel_counts)
static long long ec_products;
#define EC_COUNT_PRODUCT() (++ec_products)
#else
#define EC_COUNT_PRODUCT() ((void)0)
#include <cuda_runtime.h>
#define EC_FN __device__ __forceinline__
#define EC_PT_FN __device__ __noinline__
#define EC_CONST __constant__
#endif

#define EC_W 8          // words of a field element or a scalar
#define EC_PT 24        // words of a Jacobian point (X, Y, Z)
#define EC_WIN 5        // bits of a window of [u2]Q
#define EC_TAB 16       // its table: 1Q .. 16Q
#define EC_QDIG_K1 26   // windows of a GLV half (below 2^128, +K1OFF < 2^130)
#define EC_QDIG 52      // windows of a full scalar (+QOFF < 2^260)
#define EC_GDIG 33      // 8-bit windows of u1 (+GOFF < 2^264)
#define EC_GTAB 128     // G's table a window: d 2^(8 j) G, d = 1..128
#define EC_LPC 16       // lanes a CTA at most
#define EC_THREADS 64   // warp 0: the lanes' [u2]Q, warp 1: their [u1]G
#define EC_KW 10        // words of a recoded scalar (or two GLV halves)

// Shared memory of a lane, in words; word w of lane l lies at
// sh[w * lpc + l] (the lanes of a CTA interleaved: a warp's threads read
// neighbouring words).
#define EC_SH_QTAB 0                              // 1Q .. 16Q
#define EC_SH_QACC (EC_TAB * EC_PT)               // [u2]Q, then T
#define EC_SH_GACC (EC_SH_QACC + EC_PT)           // [u1]G
#define EC_SH_QK (EC_SH_GACC + EC_PT)             // recoded u2 (or halves)
#define EC_SH_GK (EC_SH_QK + EC_KW)               // recoded u1
#define EC_SH_LANE (EC_SH_GK + EC_KW)

// G's table (EC_GDIG * EC_GTAB * 2 * EC_W words a curve): window j,
// digit d at ((j * EC_GTAB + d - 1) * 2 * EC_W), affine x then y,
// canonical words (ops/ecdsa_cuda.g_table_words)

struct CurveConsts {
    uint32_t p[EC_W];
    uint32_t pm2[EC_W]; // p - 2, the inversion's exponent
};

// Index 0: secp256k1 (a = 0), 1: secp256r1 (P-256, a = -3).
// tests/test_torch_ecdsa_kernel.py recomputes every constant of this
// file from the curves' parameters.
EC_CONST CurveConsts EC_CURVES[2] = {
    {{0xfffffc2fu, 0xfffffffeu, 0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu},
     {0xfffffc2du, 0xfffffffeu, 0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu}},
    {{0xffffffffu, 0xffffffffu, 0xffffffffu, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000001u, 0xffffffffu},
     {0xfffffffdu, 0xffffffffu, 0xffffffffu, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000001u, 0xffffffffu}},
};

// secp256k1's GLV split (crypto/scalar._GLV_PARAMS): the order n, n >> 1,
// 2^256 - n, a1, a2, -b1, b2, and beta (phi(x, y) = (beta x, y) =
// [lambda](x, y)).
EC_CONST uint32_t K1_N[8] = {0xd0364141u, 0xbfd25e8cu, 0xaf48a03bu, 0xbaaedce6u,
                             0xfffffffeu, 0xffffffffu, 0xffffffffu, 0xffffffffu};
EC_CONST uint32_t K1_HALF_N[8] = {0x681b20a0u, 0xdfe92f46u, 0x57a4501du, 0x5d576e73u,
                                  0xffffffffu, 0xffffffffu, 0xffffffffu, 0x7fffffffu};
EC_CONST uint32_t K1_DELTA[5] = {0x2fc9bebfu, 0x402da173u, 0x50b75fc4u, 0x45512319u,
                                 0x00000001u};
EC_CONST uint32_t K1_A1[4] = {0x9284eb15u, 0xe86c90e4u, 0xa7d46bcdu, 0x3086d221u};
EC_CONST uint32_t K1_A2[5] = {0x9d44cfd8u, 0x57c1108du, 0xa8e2f3f6u, 0x14ca50f7u,
                              0x00000001u};
EC_CONST uint32_t K1_B1[4] = {0x0abfe4c3u, 0x6f547fa9u, 0x010e8828u, 0xe4437ed6u};
EC_CONST uint32_t K1_B2[4] = {0x9284eb15u, 0xe86c90e4u, 0xa7d46bcdu, 0x3086d221u};
EC_CONST uint32_t K1_BETA[8] = {0x719501eeu, 0xc1396c28u, 0x12f58995u, 0x9cf04975u,
                                0xac3434e9u, 0x6e64479eu, 0x657c0710u, 0x7ae96a2bu};

// Recoding offsets: k + OFF has digit j = window j - 2^(w-1), a signed
// digit in [-2^(w-1), 2^(w-1)): sum_j 16 * 32^j over 52 windows (QOFF)
// and over 26 (K1OFF), sum_j 128 * 256^j over 33 (GOFF).
EC_CONST uint32_t EC_QOFF[9] = {0x21084210u, 0x08421084u, 0x42108421u, 0x10842108u,
                                0x84210842u, 0x21084210u, 0x08421084u, 0x42108421u,
                                0x00000008u};
EC_CONST uint32_t EC_K1OFF[5] = {0x21084210u, 0x08421084u, 0x42108421u, 0x10842108u,
                                 0x00000002u};
EC_CONST uint32_t EC_GOFF[9] = {0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u,
                                0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u,
                                0x00000080u};

// ---------------- carry chains ----------------
// One carry flag; the host build emulates it in ec_cf.

#ifdef ECDSA_HOST
static uint32_t ec_cf;
EC_FN uint32_t add_cc(uint32_t a, uint32_t b) {
    const uint64_t s = (uint64_t)a + b;
    ec_cf = (uint32_t)(s >> 32);
    return (uint32_t)s;
}
EC_FN uint32_t addc_cc(uint32_t a, uint32_t b) {
    const uint64_t s = (uint64_t)a + b + ec_cf;
    ec_cf = (uint32_t)(s >> 32);
    return (uint32_t)s;
}
EC_FN uint32_t addc(uint32_t a, uint32_t b) { return a + b + ec_cf; }
EC_FN uint32_t sub_cc(uint32_t a, uint32_t b) {
    const uint64_t d = (uint64_t)a - b;
    ec_cf = (uint32_t)(d >> 63);
    return (uint32_t)d;
}
EC_FN uint32_t subc_cc(uint32_t a, uint32_t b) {
    const uint64_t d = (uint64_t)a - b - ec_cf;
    ec_cf = (uint32_t)(d >> 63);
    return (uint32_t)d;
}
EC_FN uint32_t subc(uint32_t a, uint32_t b) { return a - b - ec_cf; }
EC_FN uint32_t hi32(uint32_t a, uint32_t b) {
    return (uint32_t)(((uint64_t)a * b) >> 32);
}
EC_FN uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    return add_cc(a * b, c);
}
EC_FN uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    return addc_cc(a * b, c);
}
EC_FN uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    return add_cc(hi32(a, b), c);
}
EC_FN uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    return addc_cc(hi32(a, b), c);
}
EC_FN uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
    return addc(hi32(a, b), c);
}
EC_FN uint32_t mad_hi(uint32_t a, uint32_t b, uint32_t c) {
    return hi32(a, b) + c;
}
EC_FN uint32_t shl1(uint32_t lo, uint32_t hi) { return (hi << 1) | (lo >> 31); }
#else
#define EC_ASM2(name, op)                                               \
    EC_FN uint32_t name(uint32_t a, uint32_t b) {                       \
        uint32_t r;                                                     \
        asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));     \
        return r;                                                       \
    }
#define EC_ASM3(name, op)                                               \
    EC_FN uint32_t name(uint32_t a, uint32_t b, uint32_t c) {           \
        uint32_t r;                                                     \
        asm volatile(op " %0, %1, %2, %3;"                              \
                     : "=r"(r) : "r"(a), "r"(b), "r"(c));               \
        return r;                                                       \
    }
EC_ASM2(add_cc, "add.cc.u32")
EC_ASM2(addc_cc, "addc.cc.u32")
EC_ASM2(addc, "addc.u32")
EC_ASM2(sub_cc, "sub.cc.u32")
EC_ASM2(subc_cc, "subc.cc.u32")
EC_ASM2(subc, "subc.u32")
EC_ASM3(mad_lo_cc, "mad.lo.cc.u32")
EC_ASM3(madc_lo_cc, "madc.lo.cc.u32")
EC_ASM3(mad_hi_cc, "mad.hi.cc.u32")
EC_ASM3(madc_hi_cc, "madc.hi.cc.u32")
EC_ASM3(madc_hi, "madc.hi.u32")
EC_ASM3(mad_hi, "mad.hi.u32")
EC_FN uint32_t shl1(uint32_t lo, uint32_t hi) { return __funnelshift_l(lo, hi, 1); }
#endif

// ---------------- the field: canonical integers in [0, p) ----------------

struct Fe {
    uint32_t v[EC_W];
};

EC_FN Fe ld(const uint32_t* s, int st) {
    Fe r;
#pragma unroll
    for (int k = 0; k < EC_W; ++k) r.v[k] = s[k * st];
    return r;
}

EC_FN void sto(uint32_t* s, int st, const Fe& a) {
#pragma unroll
    for (int k = 0; k < EC_W; ++k) s[k * st] = a.v[k];
}

EC_FN Fe f_small(uint32_t x) {
    Fe r;
#pragma unroll
    for (int k = 0; k < EC_W; ++k) r.v[k] = k ? 0u : x;
    return r;
}

EC_FN bool f_is_zero(const Fe& a) {
    uint32_t acc = 0;
#pragma unroll
    for (int k = 0; k < EC_W; ++k) acc |= a.v[k];
    return acc == 0;
}

EC_FN bool f_eq(const Fe& a, const Fe& b) {
    uint32_t acc = 0;
#pragma unroll
    for (int k = 0; k < EC_W; ++k) acc |= a.v[k] ^ b.v[k];
    return acc == 0;
}

// s - p where s + carry 2^256 >= p, else s (s + carry 2^256 < 2p)
template <int C>
EC_FN Fe f_csub(const Fe& s, uint32_t carry) {
    Fe d;
    d.v[0] = sub_cc(s.v[0], EC_CURVES[C].p[0]);
#pragma unroll
    for (int j = 1; j < EC_W; ++j) d.v[j] = subc_cc(s.v[j], EC_CURVES[C].p[j]);
    const uint32_t borrow = subc(0u, 0u) & 1u;
    const bool take = carry || !borrow;
    Fe r;
#pragma unroll
    for (int j = 0; j < EC_W; ++j) r.v[j] = take ? d.v[j] : s.v[j];
    return r;
}

template <int C>
EC_FN Fe f_add(const Fe& a, const Fe& b) {
    Fe s;
    s.v[0] = add_cc(a.v[0], b.v[0]);
#pragma unroll
    for (int j = 1; j < EC_W; ++j) s.v[j] = addc_cc(a.v[j], b.v[j]);
    return f_csub<C>(s, addc(0u, 0u));
}

template <int C>
EC_FN Fe f_sub(const Fe& a, const Fe& b) {
    Fe d;
    d.v[0] = sub_cc(a.v[0], b.v[0]);
#pragma unroll
    for (int j = 1; j < EC_W; ++j) d.v[j] = subc_cc(a.v[j], b.v[j]);
    const uint32_t on = 0u - (subc(0u, 0u) & 1u);
    Fe r;   // a < b: add p back (the sum wraps past 2^256 once)
    r.v[0] = add_cc(d.v[0], EC_CURVES[C].p[0] & on);
#pragma unroll
    for (int j = 1; j < EC_W; ++j) r.v[j] = addc_cc(d.v[j], EC_CURVES[C].p[j] & on);
    return r;
}

template <int C>
EC_FN Fe f_neg(const Fe& a) {
    return f_sub<C>(f_small(0u), a);
}

// t += a_i b 2^(32 i), row i of a product: a carry chain of the low
// halves into t[i..i+7] (its carry into t[i+8], not yet written) and one
// of the high halves into t[i+1..i+8]
EC_FN void mul_row(uint32_t ai, const Fe& b, uint32_t* t, int i) {
    t[i] = mad_lo_cc(ai, b.v[0], t[i]);
#pragma unroll
    for (int j = 1; j < EC_W; ++j) t[i + j] = madc_lo_cc(ai, b.v[j], t[i + j]);
    t[i + EC_W] = addc(0u, 0u);
    t[i + 1] = mad_hi_cc(ai, b.v[0], t[i + 1]);
#pragma unroll
    for (int j = 1; j < EC_W - 1; ++j)
        t[i + j + 1] = madc_hi_cc(ai, b.v[j], t[i + j + 1]);
    t[i + EC_W] = madc_hi(ai, b.v[EC_W - 1], t[i + EC_W]);
}

// row i of a squaring's cross products: t += a_i a_j 2^(32 (i + j)),
// j = i+1 .. 7, as mul_row's two chains
EC_FN void sqr_row(const Fe& a, uint32_t* t, int i) {
    t[2 * i + 1] = mad_lo_cc(a.v[i], a.v[i + 1], t[2 * i + 1]);
#pragma unroll
    for (int j = i + 2; j < EC_W; ++j) t[i + j] = madc_lo_cc(a.v[i], a.v[j], t[i + j]);
    t[i + EC_W] = addc(0u, 0u);
    if (i + 1 < EC_W - 1) {
        t[2 * i + 2] = mad_hi_cc(a.v[i], a.v[i + 1], t[2 * i + 2]);
#pragma unroll
        for (int j = i + 2; j < EC_W - 1; ++j)
            t[i + j + 1] = madc_hi_cc(a.v[i], a.v[j], t[i + j + 1]);
        t[i + EC_W] = madc_hi(a.v[i], a.v[EC_W - 1], t[i + EC_W]);
    } else {
        t[i + EC_W] = mad_hi(a.v[i], a.v[EC_W - 1], t[i + EC_W]);
    }
}

// the cross products doubled by a shift, then the diagonal a_i^2 in one
// chain
EC_FN void sqr_finish(const Fe& a, uint32_t* t) {
#pragma unroll
    for (int k = 2 * EC_W - 1; k > 0; --k) t[k] = shl1(t[k - 1], t[k]);
    t[0] <<= 1;
    t[0] = mad_lo_cc(a.v[0], a.v[0], t[0]);
    t[1] = madc_hi_cc(a.v[0], a.v[0], t[1]);
#pragma unroll
    for (int i = 1; i < EC_W - 1; ++i) {
        t[2 * i] = madc_lo_cc(a.v[i], a.v[i], t[2 * i]);
        t[2 * i + 1] = madc_hi_cc(a.v[i], a.v[i], t[2 * i + 1]);
    }
    t[2 * EC_W - 2] = madc_lo_cc(a.v[EC_W - 1], a.v[EC_W - 1], t[2 * EC_W - 2]);
    t[2 * EC_W - 1] = madc_hi(a.v[EC_W - 1], a.v[EC_W - 1], t[2 * EC_W - 1]);
}

EC_FN void zero_wide(uint32_t* t) {
#pragma unroll
    for (int k = 0; k < 2 * EC_W; ++k) t[k] = 0;
}

// secp256k1: t = H 2^256 + L = L + H (2^32 + 977) (mod p), folded twice
// (the second fold's carry leaves a value below 2^66, so the last
// addition of 2^32 + 977 carries no further), then below 2p -> [0, p).
EC_FN Fe reduce_k1(const uint32_t* t) {
    Fe s;
    uint64_t acc = 0;
#pragma unroll
    for (int i = 0; i < EC_W; ++i) {
        acc += (uint64_t)t[i] + (uint64_t)t[EC_W + i] * 977u +
               (i ? (uint64_t)t[EC_W + i - 1] : 0u);
        s.v[i] = (uint32_t)acc;
        acc >>= 32;
    }
    const uint64_t hi = acc + t[2 * EC_W - 1];      // below 2^34
    const uint64_t m = hi * 977u;
    acc = (uint64_t)s.v[0] + (uint32_t)m;
    s.v[0] = (uint32_t)acc;
    acc = (acc >> 32) + s.v[1] + (m >> 32) + (uint32_t)hi;
    s.v[1] = (uint32_t)acc;
    acc = (acc >> 32) + s.v[2] + (hi >> 32);
    s.v[2] = (uint32_t)acc;
#pragma unroll
    for (int i = 3; i < EC_W; ++i) {
        acc = (acc >> 32) + s.v[i];
        s.v[i] = (uint32_t)acc;
    }
    const uint32_t c = (uint32_t)(acc >> 32);
    acc = (uint64_t)s.v[0] + c * 977u;
    s.v[0] = (uint32_t)acc;
    acc = (acc >> 32) + s.v[1] + c;
    s.v[1] = (uint32_t)acc;
#pragma unroll
    for (int i = 2; i < EC_W; ++i) {
        acc = (acc >> 32) + s.v[i];
        s.v[i] = (uint32_t)acc;
    }
    return f_csub<0>(s, 0u);
}

// P-256 (FIPS 186-4 D.2.3): t = s1 + 2 s2 + 2 s3 + s4 + s5 - d1 - d2 - d3
// - d4 (mod p), as signed 64-bit columns of t's words c0..c15; the carry
// out of the top (in [-4, 5]) folds back as 2^256 = 2^224 - 2^192 - 2^96
// + 1 (mod p), three passes bring it to 0, then below 2p -> [0, p).
EC_FN Fe reduce_p256(const uint32_t* t) {
    int64_t c[2 * EC_W], col[EC_W];
#pragma unroll
    for (int k = 0; k < 2 * EC_W; ++k) c[k] = t[k];
    col[0] = c[0] + c[8] + c[9] - c[11] - c[12] - c[13] - c[14];
    col[1] = c[1] + c[9] + c[10] - c[12] - c[13] - c[14] - c[15];
    col[2] = c[2] + c[10] + c[11] - c[13] - c[14] - c[15];
    col[3] = c[3] + 2 * c[11] + 2 * c[12] + c[13] - c[15] - c[8] - c[9];
    col[4] = c[4] + 2 * c[12] + 2 * c[13] + c[14] - c[9] - c[10];
    col[5] = c[5] + 2 * c[13] + 2 * c[14] + c[15] - c[10] - c[11];
    col[6] = c[6] + 3 * c[14] + 2 * c[15] + c[13] - c[8] - c[9];
    col[7] = c[7] + 3 * c[15] + c[8] - c[10] - c[11] - c[12] - c[13];
    Fe s;
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
        int64_t cy = 0;
#pragma unroll
        for (int k = 0; k < EC_W; ++k) {
            const int64_t v = col[k] + cy;
            s.v[k] = (uint32_t)v;
            cy = v >> 32;
        }
#pragma unroll
        for (int k = 0; k < EC_W; ++k) col[k] = s.v[k];
        col[0] += cy;
        col[3] -= cy;
        col[6] -= cy;
        col[7] += cy;
    }
    return f_csub<1>(s, 0u);
}

template <int C>
EC_FN Fe f_reduce(const uint32_t* t) {
    return C == 0 ? reduce_k1(t) : reduce_p256(t);
}

// The products are __noinline__ calls (their operands and results in
// registers: 0 bytes of stack frame): one copy of each in the binary.
// Inlined at every call site the formulas' code overflowed the
// instruction cache, and a launch over 128 SMs took 1.58 ms against
// 1.19 at 6 (H100, PERF.md).
#ifdef ECDSA_HOST
#define EC_MUL_FN EC_FN
#else
#define EC_MUL_FN __device__ __noinline__
#endif

template <int C>
EC_MUL_FN Fe f_mul(const Fe a, const Fe b) {
    EC_COUNT_PRODUCT();
    uint32_t t[2 * EC_W];
    zero_wide(t);
#pragma unroll
    for (int i = 0; i < EC_W; ++i) mul_row(a.v[i], b, t, i);
    return f_reduce<C>(t);
}

template <int C>
EC_MUL_FN Fe f_sqr(const Fe a) {
    EC_COUNT_PRODUCT();
    uint32_t t[2 * EC_W];
    zero_wide(t);
#pragma unroll
    for (int i = 0; i < EC_W - 1; ++i) sqr_row(a, t, i);
    sqr_finish(a, t);
    return f_reduce<C>(t);
}

// Two independent products (or squarings), row by row in one body: while
// one row's chain waits on its last instruction the other's runs. The
// formulas run their independent products in such pairs.
struct Fe2 {
    Fe a, b;
};

template <int C>
EC_MUL_FN Fe2 f_mul2(const Fe a, const Fe b, const Fe c, const Fe d) {
    EC_COUNT_PRODUCT();
    EC_COUNT_PRODUCT();
    uint32_t t[2 * EC_W], u[2 * EC_W];
    zero_wide(t);
    zero_wide(u);
#pragma unroll
    for (int i = 0; i < EC_W; ++i) {
        mul_row(a.v[i], b, t, i);
        mul_row(c.v[i], d, u, i);
    }
    Fe2 r;
    r.a = f_reduce<C>(t);
    r.b = f_reduce<C>(u);
    return r;
}

template <int C>
EC_MUL_FN Fe2 f_sqr2(const Fe a, const Fe c) {
    EC_COUNT_PRODUCT();
    EC_COUNT_PRODUCT();
    uint32_t t[2 * EC_W], u[2 * EC_W];
    zero_wide(t);
    zero_wide(u);
#pragma unroll
    for (int i = 0; i < EC_W - 1; ++i) {
        sqr_row(a, t, i);
        sqr_row(c, u, i);
    }
    sqr_finish(a, t);
    sqr_finish(c, u);
    Fe2 r;
    r.a = f_reduce<C>(t);
    r.b = f_reduce<C>(u);
    return r;
}

// The Montgomery product a b 2^-256 (mod p) as interleaved carry chains
// (CIOS; -p^-1 mod 2^32 is 0xd2253531 on secp256k1, 1 on P-256): not used
// by the kernels, timed by the probe beside the shape reduction above.
template <int C>
EC_FN Fe f_mul_mont(const Fe& a, const Fe& b) {
    const uint32_t pinv = C == 0 ? 0xd2253531u : 1u;
    uint32_t t[EC_W], e = 0;
#pragma unroll
    for (int j = 0; j < EC_W; ++j) t[j] = 0;
#pragma unroll
    for (int i = 0; i < EC_W; ++i) {
        t[0] = mad_lo_cc(a.v[i], b.v[0], t[0]);
#pragma unroll
        for (int j = 1; j < EC_W; ++j) t[j] = madc_lo_cc(a.v[i], b.v[j], t[j]);
        uint32_t top1 = addc(0u, 0u);
        t[1] = mad_hi_cc(a.v[i], b.v[0], t[1]);
#pragma unroll
        for (int j = 2; j < EC_W; ++j) t[j] = madc_hi_cc(a.v[i], b.v[j - 1], t[j]);
        top1 = madc_hi(a.v[i], b.v[EC_W - 1], top1);
        const uint32_t m = t[0] * pinv;
        t[0] = mad_lo_cc(m, EC_CURVES[C].p[0], t[0]);
#pragma unroll
        for (int j = 1; j < EC_W; ++j) t[j] = madc_lo_cc(m, EC_CURVES[C].p[j], t[j]);
        uint32_t top2 = addc(0u, 0u);
        t[1] = mad_hi_cc(m, EC_CURVES[C].p[0], t[1]);
#pragma unroll
        for (int j = 2; j < EC_W; ++j) t[j] = madc_hi_cc(m, EC_CURVES[C].p[j - 1], t[j]);
        top2 = madc_hi(m, EC_CURVES[C].p[EC_W - 1], top2);
#pragma unroll
        for (int j = 0; j < EC_W - 1; ++j) t[j] = t[j + 1];
        uint32_t w = add_cc(e, top1);
        uint32_t ne = addc(0u, 0u);
        t[EC_W - 1] = add_cc(w, top2);
        e = addc(ne, 0u);
    }
    Fe r;
#pragma unroll
    for (int j = 0; j < EC_W; ++j) r.v[j] = t[j];
    return f_csub<C>(r, e);
}

// a^-1 = a^(p-2) (0 for 0) by 4-bit windows of p - 2 from the top, over
// a^1 .. a^15 kept in shared memory at `tab` (stride st)
template <int C>
EC_FN Fe f_inv(const Fe& a, uint32_t* tab, int st) {
    Fe x = a;
    sto(tab, st, x);
    for (int m = 2; m < 16; ++m) {
        x = f_mul<C>(x, a);
        sto(tab + (m - 1) * EC_W * st, st, x);
    }
    Fe r = f_small(0u);
    bool started = false;
    for (int j = 2 * EC_W * 4 - 1; j >= 0; --j) {
        const int nib = (int)((EC_CURVES[C].pm2[j >> 3] >> (4 * (j & 7))) & 15u);
        if (started)
            for (int s = 0; s < 4; ++s) r = f_sqr<C>(r);
        if (nib) {
            const Fe t = ld(tab + (nib - 1) * EC_W * st, st);
            r = started ? f_mul<C>(r, t) : t;
            started = true;
        }
    }
    return r;
}

// ---------------- the curve: Jacobian (X : Y : Z), x = X / Z^2 ----------------
// A point in memory is X, Y, Z, eight words each at stride st.

EC_FN void st_pt(uint32_t* d, int ds, const Fe& x, const Fe& y, const Fe& z) {
    sto(d, ds, x);
    sto(d + EC_W * ds, ds, y);
    sto(d + 2 * EC_W * ds, ds, z);
}

EC_FN void st_identity(uint32_t* d, int ds) {
    st_pt(d, ds, f_small(0u), f_small(1u), f_small(0u));
}

// d = 2a: YY = Y^2, S = 4 X YY, M = 3 X^2 (a = 0) or 3 (X - Z^2)(X + Z^2)
// (a = -3), X3 = M^2 - 2S, Y3 = M (S - X3) - 8 YY^2, Z3 = 2 Y Z; the
// products in four steps of two (a = 0: the last one alone). Z = 0 stays
// 0. d may be a.
template <int C>
EC_PT_FN void pt_dbl(uint32_t* d, int ds, const uint32_t* a, int as) {
    const Fe X = ld(a, as), Y = ld(a + EC_W * as, as), Z = ld(a + 2 * EC_W * as, as);
    Fe M, S, X3, YYYY, A, YZ;
    if (C == 0) {
        const Fe2 p1 = f_sqr2<C>(Y, X);
        M = f_add<C>(f_add<C>(p1.b, p1.b), p1.b);
        const Fe2 p2 = f_mul2<C>(M, M, X, p1.a);
        S = f_add<C>(p2.b, p2.b);
        S = f_add<C>(S, S);
        X3 = f_sub<C>(p2.a, f_add<C>(S, S));
        const Fe2 p3 = f_mul2<C>(M, f_sub<C>(S, X3), p1.a, p1.a);
        A = p3.a;
        YYYY = p3.b;
        YZ = f_mul<C>(Y, Z);
    } else {
        const Fe2 p1 = f_sqr2<C>(Y, Z);
        const Fe2 p2 = f_mul2<C>(f_sub<C>(X, p1.b), f_add<C>(X, p1.b), X, p1.a);
        M = f_add<C>(f_add<C>(p2.a, p2.a), p2.a);
        S = f_add<C>(p2.b, p2.b);
        S = f_add<C>(S, S);
        const Fe2 p3 = f_mul2<C>(M, M, p1.a, p1.a);
        YYYY = p3.b;
        X3 = f_sub<C>(p3.a, f_add<C>(S, S));
        const Fe2 p4 = f_mul2<C>(M, f_sub<C>(S, X3), Y, Z);
        A = p4.a;
        YZ = p4.b;
    }
    Fe Y8 = f_add<C>(YYYY, YYYY);
    Y8 = f_add<C>(Y8, Y8);
    Y8 = f_add<C>(Y8, Y8);
    st_pt(d, ds, X3, f_sub<C>(A, Y8), f_add<C>(YZ, YZ));
}

// The common end of both additions, with U1 = X1 Z2^2, S1 = Y1 Z2^3,
// H = U2 - U1, R = S2 - S1 and Z1 Z2 = z1 z2: X3 = R^2 - H^3 - 2 U1 H^2,
// Y3 = R (U1 H^2 - X3) - S1 H^3, Z3 = Z1 Z2 H, in four steps of two
// products (z2 = 1: the mixed addition, one product fewer).
template <int C>
EC_FN void add_tail(uint32_t* d, int ds, const Fe& U1, const Fe& S1,
                    const Fe& H, const Fe& R, const Fe& z1, const Fe* z2) {
    Fe HH, zz, RR, Z3;
    if (z2) {
        const Fe2 p1 = f_mul2<C>(H, H, z1, *z2);
        HH = p1.a;
        zz = p1.b;
    } else {
        const Fe2 p1 = f_mul2<C>(H, H, z1, H);
        HH = p1.a;
        Z3 = p1.b;
    }
    const Fe2 p2 = f_mul2<C>(H, HH, U1, HH);
    const Fe HHH = p2.a, V = p2.b;
    if (z2) {
        const Fe2 p3 = f_mul2<C>(R, R, zz, H);
        RR = p3.a;
        Z3 = p3.b;
    } else {
        RR = f_sqr<C>(R);
    }
    const Fe X3 = f_sub<C>(f_sub<C>(RR, HHH), f_add<C>(V, V));
    const Fe2 p4 = f_mul2<C>(R, f_sub<C>(V, X3), S1, HHH);
    st_pt(d, ds, X3, f_sub<C>(p4.a, p4.b), Z3);
}

// d = a + b', b' = b with Y negated where negb and X multiplied by beta
// where phi (secp256k1's endomorphism); the exceptional inputs as the
// header says. d may be a or b.
template <int C>
EC_PT_FN void pt_add(uint32_t* d, int ds, const uint32_t* a, int as,
                     const uint32_t* b, int bs, uint32_t negb, uint32_t phi) {
    const Fe X1 = ld(a, as), Y1 = ld(a + EC_W * as, as), Z1 = ld(a + 2 * EC_W * as, as);
    Fe X2 = ld(b, bs), Y2 = ld(b + EC_W * bs, bs);
    const Fe Z2 = ld(b + 2 * EC_W * bs, bs);
    if (phi) X2 = f_mul<C>(X2, ld(K1_BETA, 1));
    if (negb) Y2 = f_neg<C>(Y2);
    if (f_is_zero(Z1)) {
        st_pt(d, ds, X2, Y2, Z2);
        return;
    }
    if (f_is_zero(Z2)) {
        st_pt(d, ds, X1, Y1, Z1);
        return;
    }
    const Fe2 zz = f_sqr2<C>(Z1, Z2);
    const Fe2 u = f_mul2<C>(X1, zz.b, X2, zz.a);
    const Fe2 t = f_mul2<C>(Y1, Z2, Y2, Z1);
    const Fe2 s = f_mul2<C>(t.a, zz.b, t.b, zz.a);
    const Fe H = f_sub<C>(u.b, u.a), R = f_sub<C>(s.b, s.a);
    if (f_is_zero(H) && f_is_zero(R)) {
        pt_dbl<C>(d, ds, a, as);
        return;
    }
    add_tail<C>(d, ds, u.a, s.a, H, R, Z1, &Z2);
}

// d = a + (x, y') for an affine point (x then y at b, stride bs; never
// the identity), y' = -y where negb: the addition above with Z2 = 1.
template <int C>
EC_PT_FN void pt_madd(uint32_t* d, int ds, const uint32_t* a, int as,
                      const uint32_t* b, int bs, uint32_t negb) {
    const Fe X1 = ld(a, as), Y1 = ld(a + EC_W * as, as), Z1 = ld(a + 2 * EC_W * as, as);
    const Fe x2 = ld(b, bs);
    Fe y2 = ld(b + EC_W * bs, bs);
    if (negb) y2 = f_neg<C>(y2);
    if (f_is_zero(Z1)) {
        st_pt(d, ds, x2, y2, f_small(1u));
        return;
    }
    const Fe2 p1 = f_mul2<C>(Z1, Z1, y2, Z1);
    const Fe2 p2 = f_mul2<C>(x2, p1.a, p1.b, p1.a);
    const Fe H = f_sub<C>(p2.a, X1), R = f_sub<C>(p2.b, Y1);
    if (f_is_zero(H) && f_is_zero(R)) {
        pt_dbl<C>(d, ds, a, as);
        return;
    }
    add_tail<C>(d, ds, X1, Y1, H, R, Z1, nullptr);
}

// ---------------- scalars: GLV split, recoding ----------------

// floor((c k + (n >> 1)) / n) for secp256k1's n: c (4 words), k < n (8
// words). With t = c k + n/2 = H 2^256 + L (H < 2^128), t - H n = L + H
// (2^256 - n) < 3 2^256 < 4n: the quotient is H plus at most 3.
EC_FN void glv_round(const uint32_t* c, const uint32_t* k, uint32_t* q) {
    uint32_t t[12];
    for (int i = 0; i < 12; ++i) t[i] = 0;
    for (int i = 0; i < EC_W; ++i) {
        uint64_t acc = 0;
        for (int j = 0; j < 4; ++j) {
            acc += (uint64_t)k[i] * c[j] + t[i + j];
            t[i + j] = (uint32_t)acc;
            acc >>= 32;
        }
        t[i + 4] = (uint32_t)acc;
    }
    uint64_t acc = 0;
    for (int i = 0; i < 12; ++i) {
        acc += (uint64_t)t[i] + (i < EC_W ? K1_HALF_N[i] : 0u);
        t[i] = (uint32_t)acc;
        acc >>= 32;
    }
    uint32_t s[10];
    for (int i = 0; i < 10; ++i) s[i] = i < EC_W ? t[i] : 0u;
    for (int i = 0; i < 4; ++i) {
        acc = 0;
        for (int j = 0; j < 5; ++j) {
            acc += (uint64_t)t[EC_W + i] * K1_DELTA[j] + s[i + j];
            s[i + j] = (uint32_t)acc;
            acc >>= 32;
        }
        for (int m = i + 5; m < 10; ++m) {
            acc += s[m];
            s[m] = (uint32_t)acc;
            acc >>= 32;
        }
    }
    for (int i = 0; i < 4; ++i) q[i] = t[EC_W + i];
    for (int it = 0; it < 3; ++it) {
        int cmp = (s[8] | s[9]) ? 1 : 0;
        for (int i = EC_W - 1; i >= 0; --i)
            if (cmp == 0) cmp = s[i] > K1_N[i] ? 1 : s[i] < K1_N[i] ? -1 : 0;
        const bool ge = cmp >= 0;
        int64_t bw = 0;
        for (int i = 0; i < 10; ++i) {
            const int64_t d = (int64_t)s[i] - (ge && i < EC_W ? K1_N[i] : 0u) + bw;
            s[i] = (uint32_t)d;
            bw = d >> 32;
        }
        uint64_t cq = ge ? 1u : 0u;
        for (int i = 0; i < 4; ++i) {
            cq += q[i];
            q[i] = (uint32_t)cq;
            cq >>= 32;
        }
    }
}

// r -= x y (mod 2^160), or r += where add; x 4 words, y ny words
EC_FN void mac160(uint32_t* r, const uint32_t* x, const uint32_t* y, int ny,
                  bool add) {
    uint32_t p[5] = {0, 0, 0, 0, 0};
    for (int i = 0; i < 4; ++i) {
        uint64_t acc = 0;
        for (int j = 0; j < ny && i + j < 5; ++j) {
            acc += (uint64_t)x[i] * y[j] + p[i + j];
            p[i + j] = (uint32_t)acc;
            acc >>= 32;
        }
        if (i + ny < 5) p[i + ny] = (uint32_t)acc;
    }
    int64_t c = 0;
    for (int i = 0; i < 5; ++i) {
        const int64_t v = (int64_t)r[i] + (add ? (int64_t)p[i] : -(int64_t)p[i]) + c;
        r[i] = (uint32_t)v;
        c = v >> 32;
    }
}

// |r| and its sign, r a two's-complement value of 5 words
EC_FN uint32_t abs160(uint32_t* r) {
    const uint32_t neg = r[4] >> 31;
    uint64_t c = neg;
    for (int i = 0; i < 5; ++i) {
        c += (uint64_t)(neg ? ~r[i] : r[i]);
        r[i] = (uint32_t)c;
        c >>= 32;
    }
    return neg;
}

// secp256k1's GLV split of k < n, exactly crypto/scalar._glv_split: c1 =
// round(b2 k / n), c2 = round(-b1 k / n), k1 = k - c1 a1 - c2 a2, k2 =
// -c1 b1 - c2 b2 (both below 2^128 in size) -> |k1|, |k2| in 5 words and
// their signs (1: negative)
EC_FN void glv_split(const uint32_t* k, uint32_t* k1, uint32_t& neg1,
                     uint32_t* k2, uint32_t& neg2) {
    uint32_t c1[4], c2[4];
    glv_round(K1_B2, k, c1);
    glv_round(K1_B1, k, c2);
    for (int i = 0; i < 5; ++i) {
        k1[i] = k[i];
        k2[i] = 0;
    }
    mac160(k1, c1, K1_A1, 4, false);
    mac160(k1, c2, K1_A2, 5, false);
    mac160(k2, c1, K1_B1, 4, true);
    mac160(k2, c2, K1_B2, 4, false);
    neg1 = abs160(k1);
    neg2 = abs160(k2);
}

// dst (nw words at stride st) = k (nk words) + off (nw words)
EC_FN void recode(uint32_t* dst, int st, const uint32_t* k, int nk,
                  const uint32_t* off, int nw) {
    uint64_t c = 0;
    for (int i = 0; i < nw; ++i) {
        c += (uint64_t)(i < nk ? k[i] : 0u) + off[i];
        dst[i * st] = (uint32_t)c;
        c >>= 32;
    }
}

// digit j (5-bit window at bit 5j) of a recoded scalar in shared memory
EC_FN int q_digit(const uint32_t* kw, int st, int j) {
    const int b = EC_WIN * j, w = b >> 5, s = b & 31;
    uint32_t v = kw[w * st] >> s;
    if (s > 32 - EC_WIN) v |= kw[(w + 1) * st] << (32 - s);
    return (int)(v & (EC_TAB * 2 - 1)) - EC_TAB;
}

// ---------------- a lane's two parts ----------------

// [u2]Q into the lane's QACC (sh: the lane's shared memory at stride st):
// the table 1Q..16Q (an even entry doubles its half, an odd one adds Q),
// then from the top window down 5 doublings (none before the first) and,
// for each scalar (the two GLV halves on secp256k1, the second on phi),
// the addition of +-T[|d|] where its digit d is not 0.
template <int C>
EC_FN void q_part(uint32_t* sh, int st, const uint32_t* k, const Fe& qx,
                  const Fe& qy) {
    constexpr int cols = C == 0 ? 2 : 1;
    constexpr int digits = C == 0 ? EC_QDIG_K1 : EC_QDIG;
    uint32_t* tab = sh + EC_SH_QTAB * st;
    uint32_t* acc = sh + EC_SH_QACC * st;
    uint32_t* kw = sh + EC_SH_QK * st;
    const int es = EC_PT * st;     // words between table entries
    st_pt(tab, st, qx, qy, f_small(1u));
    for (int m = 2; m <= EC_TAB; ++m) {
        if (m & 1)
            pt_madd<C>(tab + (m - 1) * es, st, tab + (m - 2) * es, st, tab, st, 0u);
        else
            pt_dbl<C>(tab + (m - 1) * es, st, tab + (m / 2 - 1) * es, st);
    }
    uint32_t neg[2] = {0u, 0u};
    if (C == 0) {
        uint32_t k1[5], k2[5];
        glv_split(k, k1, neg[0], k2, neg[1]);
        recode(kw, st, k1, 5, EC_K1OFF, 5);
        recode(kw + 5 * st, st, k2, 5, EC_K1OFF, 5);
    } else {
        recode(kw, st, k, EC_W, EC_QOFF, 9);
    }
    st_identity(acc, st);
    for (int j = digits - 1; j >= 0; --j) {
        if (j < digits - 1)
            for (int i = 0; i < EC_WIN; ++i) pt_dbl<C>(acc, st, acc, st);
#pragma unroll
        for (int c = 0; c < cols; ++c) {
            const int dg = q_digit(kw + 5 * c * st, st, j);
            if (dg)
                pt_add<C>(acc, st, acc, st, tab + ((dg < 0 ? -dg : dg) - 1) * es, st,
                          (uint32_t)(dg < 0) ^ neg[c], (uint32_t)c);
        }
    }
}

// [u1]G into the lane's GACC: for each 8-bit window j from the bottom,
// the mixed addition of +-(|d| 2^(8j) G) from G's table where d != 0
template <int C>
EC_FN void g_part(uint32_t* sh, int st, const uint32_t* u1,
                  const uint32_t* gtab) {
    uint32_t* acc = sh + EC_SH_GACC * st;
    uint32_t* kw = sh + EC_SH_GK * st;
    recode(kw, st, u1, EC_W, EC_GOFF, 9);
    st_identity(acc, st);
    for (int j = 0; j < EC_GDIG; ++j) {
        const int dg = (int)((kw[(j >> 2) * st] >> (8 * (j & 3))) & 255u) - EC_GTAB;
        if (dg)
            pt_madd<C>(acc, st, acc, st,
                       gtab + ((size_t)j * EC_GTAB + (dg < 0 ? -dg : dg) - 1) * 2 * EC_W,
                       1, (uint32_t)(dg < 0));
    }
}

EC_FN void load_lane(uint32_t* d, const uint32_t* src, int B, int i) {
    for (int k = 0; k < EC_W; ++k) d[k] = src[(size_t)k * B + i];
}

EC_FN Fe load_fe(const uint32_t* src, int B, int i) {
    Fe r;
    load_lane(r.v, src, B, i);
    return r;
}

// T = [u2]Q + [u1]G into QACC; -> X, Z
template <int C>
EC_FN void join(uint32_t* sh, int st, Fe& X, Fe& Z) {
    uint32_t* acc = sh + EC_SH_QACC * st;
    pt_add<C>(acc, st, acc, st, sh + EC_SH_GACC * st, st, 0u, 0u);
    X = ld(acc, st);
    Z = ld(acc + 2 * EC_W * st, st);
}

// One lane of ecdsa_rlc after its two parts: w = a rho
template <int C>
EC_FN Fe rlc_finish(uint32_t* sh, int st, const uint32_t* xrs,
                    const uint32_t* xrpns, const uint8_t* wrap_ok,
                    const uint32_t* as, int B, int i) {
    Fe X, Z;
    join<C>(sh, st, X, Z);
    const Fe ZZ = f_sqr<C>(Z);
    // Jacobian x-residuals: zero iff x(T) == r (resp. r+n)
    const Fe d1 = f_sub<C>(X, f_mul<C>(load_fe(xrs, B, i), ZZ));
    const Fe d2 = wrap_ok[i] ? f_sub<C>(X, f_mul<C>(load_fe(xrpns, B, i), ZZ))
                             : f_small(1u);
    Fe rho = f_mul<C>(d1, d2);
    // the identity has Z = 0: pin rho to 1 (a reject)
    if (f_is_zero(Z)) rho = f_small(1u);
    return f_mul<C>(load_fe(as, B, i), rho);
}

// One item of ecdsa_verify after its two parts: x (canonical) and the
// verdict
template <int C>
EC_FN bool verify_finish(uint32_t* sh, int st, const uint32_t* rs,
                         const uint32_t* rpns, int B, int i, Fe& x) {
    Fe X, Z;
    join<C>(sh, st, X, Z);
    const Fe zi = f_inv<C>(Z, sh + EC_SH_QTAB * st, st);
    x = f_mul<C>(X, f_sqr<C>(zi));
    const bool match = f_eq(x, load_fe(rs, B, i)) || f_eq(x, load_fe(rpns, B, i));
    return match && !f_is_zero(Z);
}

// the launch plan: lanes a CTA, as few as spread B lanes over `sms` SMs
static inline int ec_lanes_per_cta(int B, int sms) {
    int l = (B + sms - 1) / (sms > 0 ? sms : 1);
    return l < 1 ? 1 : l > EC_LPC ? EC_LPC : l;
}

#ifndef ECDSA_HOST

template <int C>
__global__ void __launch_bounds__(EC_THREADS)
ecdsa_rlc_kernel(const uint32_t* __restrict__ u1, const uint32_t* __restrict__ u2,
                 const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
                 const uint32_t* __restrict__ xr, const uint32_t* __restrict__ xrpn,
                 const uint8_t* __restrict__ wrap_ok,
                 const uint8_t* __restrict__ active,
                 const uint32_t* __restrict__ a,
                 const uint32_t* __restrict__ gtab, int B, int lpc,
                 uint32_t* __restrict__ partial) {
    extern __shared__ uint32_t sh[];
    const int l = threadIdx.x & 31, role = threadIdx.x >> 5;
    const int i = blockIdx.x * lpc + l;
    const bool live = l < lpc && i < B && active[i];
    uint32_t* lane = sh + l;
    if (live) {
        uint32_t k[EC_W];
        if (role == 0) {
            load_lane(k, u2, B, i);
            q_part<C>(lane, lpc, k, load_fe(qx, B, i), load_fe(qy, B, i));
        } else {
            load_lane(k, u1, B, i);
            g_part<C>(lane, lpc, k, gtab);
        }
    }
    __syncthreads();
    // the weights, then a tree over the CTA's lanes, in QACC's first words
    uint32_t* w = lane + EC_SH_QACC * lpc;
    if (role == 0 && l < lpc)
        sto(w, lpc, live ? rlc_finish<C>(lane, lpc, xr, xrpn, wrap_ok, a, B, i)
                         : f_small(0u));
    __syncthreads();
    for (int s = 1; s < lpc; s *= 2) {
        if (role == 0 && l % (2 * s) == 0 && l + s < lpc)
            sto(w, lpc, f_add<C>(ld(w, lpc), ld(w + s, lpc)));
        __syncthreads();
    }
    if (threadIdx.x < EC_W)
        partial[blockIdx.x * EC_W + threadIdx.x] = sh[(EC_SH_QACC + threadIdx.x) * lpc];
}

// One CTA: the partials' sum in a fixed order
template <int C>
__global__ void __launch_bounds__(EC_THREADS)
ecdsa_rlc_sum_kernel(const uint32_t* __restrict__ partial, int nparts,
                     uint32_t* __restrict__ out) {
    __shared__ uint32_t sh[EC_W][EC_THREADS];
    const int tid = threadIdx.x;
    Fe acc = f_small(0u);
    for (int j = tid; j < nparts; j += EC_THREADS)
        acc = f_add<C>(acc, ld(partial + j * EC_W, 1));
    sto(&sh[0][tid], EC_THREADS, acc);
    __syncthreads();
    for (int s = EC_THREADS / 2; s > 0; s >>= 1) {
        if (tid < s)
            sto(&sh[0][tid], EC_THREADS,
                f_add<C>(ld(&sh[0][tid], EC_THREADS), ld(&sh[0][tid + s], EC_THREADS)));
        __syncthreads();
    }
    if (tid < EC_W) out[tid] = sh[tid][0];
}

template <int C>
__global__ void __launch_bounds__(EC_THREADS)
ecdsa_verify_kernel(const uint32_t* __restrict__ u1, const uint32_t* __restrict__ u2,
                    const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
                    const uint32_t* __restrict__ r, const uint32_t* __restrict__ rpn,
                    const uint32_t* __restrict__ gtab, int B, int lpc,
                    uint8_t* __restrict__ ok, uint32_t* __restrict__ xout) {
    extern __shared__ uint32_t sh[];
    const int l = threadIdx.x & 31, role = threadIdx.x >> 5;
    const int i = blockIdx.x * lpc + l;
    const bool live = l < lpc && i < B;
    uint32_t* lane = sh + l;
    if (live) {
        uint32_t k[EC_W];
        if (role == 0) {
            load_lane(k, u2, B, i);
            q_part<C>(lane, lpc, k, load_fe(qx, B, i), load_fe(qy, B, i));
        } else {
            load_lane(k, u1, B, i);
            g_part<C>(lane, lpc, k, gtab);
        }
    }
    __syncthreads();
    if (live && role == 0) {
        Fe x;
        ok[i] = verify_finish<C>(lane, lpc, r, rpn, B, i, x) ? 1 : 0;
        for (int k = 0; k < EC_W; ++k) xout[(size_t)k * B + i] = x.v[k];
    }
}

// clock64 cycles on one thread: `iters` dependent products, squarings,
// Montgomery products and pairs of products (f_mul2), iters / 8
// dependent doublings, additions and mixed additions (on G's multiples from the table: no exceptional case)
template <int C>
__global__ void ecdsa_probe_kernel(int iters, const uint32_t* __restrict__ gtab,
                                   long long* stamps, uint32_t* sink) {
    __shared__ uint32_t sh[2 * EC_PT];
    const Fe gx = ld(gtab, 1), gy = ld(gtab + EC_W, 1);
    st_pt(sh, 1, gx, gy, f_small(1u));
    st_pt(sh + EC_PT, 1, ld(gtab + 4 * EC_W, 1), ld(gtab + 5 * EC_W, 1), gx);
    Fe x = gx, y = gy;
    long long t[8];
    t[0] = clock64();
    for (int n = 0; n < iters; ++n) x = f_mul<C>(x, y);
    t[1] = clock64();
    for (int n = 0; n < iters; ++n) y = f_sqr<C>(y);
    t[2] = clock64();
    for (int n = 0; n < iters; ++n) x = f_mul_mont<C>(x, y);
    t[3] = clock64();
    Fe z = gy;
    for (int n = 0; n < iters; ++n) {
        const Fe2 r = f_mul2<C>(x, y, z, y);
        x = r.a;
        z = r.b;
    }
    t[4] = clock64();
    for (int n = 0; n < iters / 8; ++n) pt_dbl<C>(sh, 1, sh, 1);
    t[5] = clock64();
    for (int n = 0; n < iters / 8; ++n) pt_add<C>(sh, 1, sh, 1, sh + EC_PT, 1, 0u, 0u);
    t[6] = clock64();
    for (int n = 0; n < iters / 8; ++n) pt_madd<C>(sh, 1, sh, 1, gtab + 2 * EC_W, 1, 0u);
    t[7] = clock64();
    for (int k = 0; k < EC_W; ++k) sink[k] = x.v[k] ^ y.v[k] ^ z.v[k] ^ sh[k];
    for (int k = 0; k < 7; ++k) stamps[k] = t[k + 1] - t[k];
}

static size_t ec_smem(int lpc) { return (size_t)EC_SH_LANE * lpc * sizeof(uint32_t); }

template <int C>
static cudaError_t rlc_launch(const uint32_t* u1, const uint32_t* u2,
                              const uint32_t* qx, const uint32_t* qy,
                              const uint32_t* xr, const uint32_t* xrpn,
                              const uint8_t* wrap_ok, const uint8_t* active,
                              const uint32_t* a, const uint32_t* gtab, int B,
                              int lpc, uint32_t* partial, uint32_t* out,
                              cudaStream_t stream) {
    const int blocks = (B + lpc - 1) / lpc;
    ecdsa_rlc_kernel<C><<<blocks, EC_THREADS, ec_smem(lpc), stream>>>(
        u1, u2, qx, qy, xr, xrpn, wrap_ok, active, a, gtab, B, lpc, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ecdsa_rlc_sum_kernel<C><<<1, EC_THREADS, 0, stream>>>(partial, blocks, out);
    return cudaGetLastError();
}

template <int C>
static cudaError_t verify_launch(const uint32_t* u1, const uint32_t* u2,
                                 const uint32_t* qx, const uint32_t* qy,
                                 const uint32_t* r, const uint32_t* rpn,
                                 const uint32_t* gtab, int B, int lpc,
                                 uint8_t* ok, uint32_t* x, cudaStream_t stream) {
    const int blocks = (B + lpc - 1) / lpc;
    ecdsa_verify_kernel<C><<<blocks, EC_THREADS, ec_smem(lpc), stream>>>(
        u1, u2, qx, qy, r, rpn, gtab, B, lpc, ok, x);
    return cudaGetLastError();
}

extern "C" {

// curve: 0 secp256k1, 1 secp256r1. gtab: the curve's G table (above);
// lpc: lanes a CTA (1..EC_LPC, ecdsa_lanes_per_cta); partial:
// (B + lpc - 1) / lpc * 8 words of scratch; out: 8 words.
// Returns a cudaError_t (0 on success).
int ecdsa_rlc_launch(int curve, const void* u1, const void* u2,
                     const void* qx, const void* qy, const void* xr,
                     const void* xrpn, const void* wrap_ok,
                     const void* active, const void* a, const void* gtab,
                     int B, int lpc, void* partial, void* out, void* stream) {
    if (B <= 0 || lpc < 1 || lpc > EC_LPC) return (int)cudaErrorInvalidValue;
    auto f = curve == 0 ? rlc_launch<0> : curve == 1 ? rlc_launch<1> : nullptr;
    if (f == nullptr) return (int)cudaErrorInvalidValue;
    return (int)f((const uint32_t*)u1, (const uint32_t*)u2,
                  (const uint32_t*)qx, (const uint32_t*)qy,
                  (const uint32_t*)xr, (const uint32_t*)xrpn,
                  (const uint8_t*)wrap_ok, (const uint8_t*)active,
                  (const uint32_t*)a, (const uint32_t*)gtab, B, lpc,
                  (uint32_t*)partial, (uint32_t*)out, (cudaStream_t)stream);
}

int ecdsa_verify_launch(int curve, const void* u1, const void* u2,
                        const void* qx, const void* qy, const void* r,
                        const void* rpn, const void* gtab, int B, int lpc,
                        void* ok, void* x, void* stream) {
    if (B <= 0 || lpc < 1 || lpc > EC_LPC) return (int)cudaErrorInvalidValue;
    auto f = curve == 0 ? verify_launch<0> : curve == 1 ? verify_launch<1> : nullptr;
    if (f == nullptr) return (int)cudaErrorInvalidValue;
    return (int)f((const uint32_t*)u1, (const uint32_t*)u2,
                  (const uint32_t*)qx, (const uint32_t*)qy,
                  (const uint32_t*)r, (const uint32_t*)rpn,
                  (const uint32_t*)gtab, B, lpc, (uint8_t*)ok, (uint32_t*)x,
                  (cudaStream_t)stream);
}

// stamps (7 int64 on the card): cycles of `iters` products, squarings,
// Montgomery products, pairs of products, of iters / 8 doublings,
// additions, mixed additions; sink: 8 uint32 on the card
int ecdsa_probe_launch(int curve, int iters, const void* gtab, long long* stamps,
                       uint32_t* sink, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (curve == 0)
        ecdsa_probe_kernel<0><<<1, 1, 0, st>>>(iters, (const uint32_t*)gtab, stamps, sink);
    else if (curve == 1)
        ecdsa_probe_kernel<1><<<1, 1, 0, st>>>(iters, (const uint32_t*)gtab, stamps, sink);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

const char* ecdsa_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

#endif  // ECDSA_HOST

extern "C" {

// lanes a CTA for B lanes on `sms` SMs
int ecdsa_lanes_per_cta(int B, int sms) { return ec_lanes_per_cta(B, sms); }

}  // extern "C"
