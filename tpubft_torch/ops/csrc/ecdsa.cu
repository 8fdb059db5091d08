// ECDSA verification kernels for Hopper (sm_90a): the RLC fold and the
// per-item verify over secp256k1 (a = 0) and P-256 (a = -3).
//
// Replaces the JAX package's two jitted XLA programs of
// tpubft/ops/ecdsa.py: make_rlc_kernel (:303-304, the body
// rlc_fold_body :267-300) and make_verify_kernel.<locals>.kernel
// (:169-184). Wrapper: ops/ecdsa_cuda.py; plain versions:
// ops/ecdsa.rlc_fold_plain / verify_plain.
//
// ecdsa_rlc, per lane i (one thread a lane):
//   T = [u1]G + [u2]Q                     (Shamir, below)
//   d1 = X - r Z,  d2 = X - (r+n) Z where wrap_ok, else 1
//   rho = d1 d2;  rho = 1 where Z = 0;  rho = 0 on an inactive lane
//   w = a rho
// then sum_i w_i over the launch: a tree in each CTA into one partial a
// CTA, and a second kernel that sums the partials in a fixed order (no
// atomics: the sum is deterministic) and writes it out of Montgomery
// form, eight canonical 32-bit words. The host's verdict is "the sum is
// 0".
// ecdsa_verify, per item: the same T, its affine x by a Fermat inversion
// of Z, the verdict x == r or x == r+n, and Z != 0; writes the verdicts
// (B,) and x (8, B).
//
// Inputs are canonical integers as (8, B) little-endian 32-bit words
// (word k of lane i at k * B + i, so a warp's loads coalesce); the
// kernels convert Qx, Qy, r, r+n and a to their Montgomery form
// (R = 2^256, eight words) by one product with R^2 mod p.
//
// The ladder: G + Q is added once up front, then each of 256 steps
// doubles and, where the step's digit b1 + 2 b2 of (u1, u2) is not 0,
// adds G, Q or G + Q. Both are the complete projective addition of
// Renes-Costello-Batina (the closed form in ops/weierstrass.Curve.add,
// the a-terms only for a != 0), so no input needs a special case and
// the projective result is Curve.shamir_bits' to the word: the fold's
// value, which scales with each lane's Z^2, is the plain version's.
//
// What bounds it: the field products. A step costs a doubling (14
// products for a = 0, 18 for a = -3, in the complete formula) and, on
// 3 of 4 steps, an addition of the same cost: about 6,300 (secp256k1)
// to 8,100 (P-256) products of eight words a lane, each a CIOS
// Montgomery product in uint64_t (64 + 64 wide multiply-adds). One
// thread a lane runs them as one dependent chain, so the kernel takes
// the chain's latency whatever B is (until the card is full); the bound
// that chip_smoke prints (ops/ecdsa_cuda.work) counts the cheapest
// formulas' products on the run's scalars. The point formulas and the
// product are __noinline__ functions on pointers (points in local
// memory): inlined, the code of one complete addition is tens of KB
// (the BLS kernel's instruction cache overflowed, and cicc 12.9
// crashed on inlined point formulas).
//
// Host mode: with ECDSA_HOST defined the file compiles as plain C++
// (csrc/ecdsa_host.cpp runs the lanes on the host for the CPU tests).
#include <stddef.h>
#include <stdint.h>

#ifdef ECDSA_HOST
#define EC_FN static inline
#define EC_NOINLINE static __attribute__((noinline))
#define EC_CONST static const
#else
#include <cuda_runtime.h>
#define EC_FN __device__ __forceinline__
#define EC_NOINLINE __device__ __noinline__
#define EC_CONST __constant__
#endif

#define EC_W 8          // words of a field element or a scalar
#define EC_PT 24        // words of a projective point (X, Y, Z)
#define EC_CTA 64       // threads (lanes) a CTA of ecdsa_rlc / ecdsa_verify

struct CurveConsts {
    uint32_t p[EC_W];
    uint32_t pinv;      // -p^-1 mod 2^32
    uint32_t r2[EC_W];  // R^2 mod p, R = 2^256
    uint32_t one[EC_W]; // R mod p: 1 in Montgomery form
    uint32_t a[EC_W];   // a R mod p
    uint32_t b3[EC_W];  // 3 b R mod p
    uint32_t gx[EC_W];  // the generator, Montgomery form
    uint32_t gy[EC_W];
    uint32_t pm2[EC_W]; // p - 2, the inversion's exponent
    int a_zero;
};

// Index 0: secp256k1, 1: secp256r1 (P-256). tests/test_torch_ecdsa_kernel.py
// recomputes every word from the curves' parameters.
EC_CONST CurveConsts EC_CURVES[2] = {
    // secp256k1
    {{0xfffffc2fu, 0xfffffffeu, 0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu},
     0xd2253531u,
     {0x000e90a1u, 0x000007a2u, 0x00000001u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},  // r2
     {0x000003d1u, 0x00000001u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},  // one
     {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},  // a
     {0x00005025u, 0x00000015u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},  // b3
     {0x487e2097u, 0xd7362e5au, 0x29bc66dbu, 0x231e2953u, 0x33fd129cu, 0x979f48c0u, 0xe9089f48u, 0x9981e643u},  // gx
     {0xd3dbabe2u, 0xb15ea6d2u, 0x1f1dc64du, 0x8dfc5d5du, 0xac19c136u, 0x70b6b59au, 0xd4a582d6u, 0xcf3f851fu},  // gy
     {0xfffffc2du, 0xfffffffeu, 0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu},  // pm2
     1},
    // secp256r1
    {{0xffffffffu, 0xffffffffu, 0xffffffffu, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000001u, 0xffffffffu},
     0x00000001u,
     {0x00000003u, 0x00000000u, 0xffffffffu, 0xfffffffbu, 0xfffffffeu, 0xffffffffu, 0xfffffffdu, 0x00000004u},  // r2
     {0x00000001u, 0x00000000u, 0x00000000u, 0xffffffffu, 0xffffffffu, 0xffffffffu, 0xfffffffeu, 0x00000000u},  // one
     {0xfffffffcu, 0xffffffffu, 0xffffffffu, 0x00000003u, 0x00000000u, 0x00000000u, 0x00000004u, 0xfffffffcu},  // a
     {0x7d4e399fu, 0x89d69e26u, 0x698c91b2u, 0x06d01166u, 0xe5638c84u, 0xb0e66203u, 0x0d95d89cu, 0x94901259u},  // b3
     {0x18a9143cu, 0x79e730d4u, 0x5fedb601u, 0x75ba95fcu, 0x77622510u, 0x79fb732bu, 0xa53755c6u, 0x18905f76u},  // gx
     {0xce95560au, 0xddf25357u, 0xba19e45cu, 0x8b4ab8e4u, 0xdd21f325u, 0xd2e88688u, 0x25885d85u, 0x8571ff18u},  // gy
     {0xfffffffdu, 0xffffffffu, 0xffffffffu, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000001u, 0xffffffffu},  // pm2
     0},
};

// ---------------- the field: elements in [0, p), Montgomery form ----------------

template <int C>
EC_FN bool f_geq_p(const uint32_t* t) {
    for (int j = EC_W - 1; j >= 0; --j) {
        if (t[j] != EC_CURVES[C].p[j]) return t[j] > EC_CURVES[C].p[j];
    }
    return true;
}

template <int C>
EC_FN void f_sub_p(uint32_t* t) {
    uint64_t borrow = 0;
#pragma unroll
    for (int j = 0; j < EC_W; ++j) {
        uint64_t d = (uint64_t)t[j] - EC_CURVES[C].p[j] - borrow;
        t[j] = (uint32_t)d;
        borrow = (d >> 32) & 1;
    }
}

template <int C>
EC_FN void f_copy(uint32_t* r, const uint32_t* a) {
#pragma unroll
    for (int j = 0; j < EC_W; ++j) r[j] = a[j];
}

template <int C>
EC_FN bool f_is_zero(const uint32_t* a) {
    uint32_t acc = 0;
#pragma unroll
    for (int j = 0; j < EC_W; ++j) acc |= a[j];
    return acc == 0;
}

template <int C>
EC_FN bool f_eq(const uint32_t* a, const uint32_t* b) {
    uint32_t acc = 0;
#pragma unroll
    for (int j = 0; j < EC_W; ++j) acc |= a[j] ^ b[j];
    return acc == 0;
}

// r = a + b mod p (a, b < p)
template <int C>
EC_FN void f_add(uint32_t* r, const uint32_t* a, const uint32_t* b) {
    uint32_t s[EC_W];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < EC_W; ++j) {
        c += (uint64_t)a[j] + b[j];
        s[j] = (uint32_t)c;
        c >>= 32;
    }
    if (c || f_geq_p<C>(s)) f_sub_p<C>(s);
    f_copy<C>(r, s);
}

// r = a - b mod p (a, b < p)
template <int C>
EC_FN void f_sub(uint32_t* r, const uint32_t* a, const uint32_t* b) {
    uint32_t d[EC_W];
    uint64_t borrow = 0;
#pragma unroll
    for (int j = 0; j < EC_W; ++j) {
        uint64_t t = (uint64_t)a[j] - b[j] - borrow;
        d[j] = (uint32_t)t;
        borrow = (t >> 32) & 1;
    }
    if (borrow) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < EC_W; ++j) {
            c += (uint64_t)d[j] + EC_CURVES[C].p[j];
            d[j] = (uint32_t)c;
            c >>= 32;
        }
    }
    f_copy<C>(r, d);
}

// r = a b R^-1 mod p (a, b < p): CIOS, one 32-bit word of b a row, the
// accumulator ten words; below 2p after the last row, then one
// conditional subtraction. r may alias a or b.
template <int C>
EC_NOINLINE void f_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
    uint32_t t[EC_W + 2];
    uint32_t av[EC_W];
#pragma unroll
    for (int j = 0; j < EC_W; ++j) av[j] = a[j];
#pragma unroll
    for (int j = 0; j < EC_W + 2; ++j) t[j] = 0;
#pragma unroll
    for (int i = 0; i < EC_W; ++i) {
        const uint64_t bi = b[i];
        uint64_t carry = 0;
#pragma unroll
        for (int j = 0; j < EC_W; ++j) {
            uint64_t uv = (uint64_t)t[j] + (uint64_t)av[j] * bi + carry;
            t[j] = (uint32_t)uv;
            carry = uv >> 32;
        }
        uint64_t uv = (uint64_t)t[EC_W] + carry;
        t[EC_W] = (uint32_t)uv;
        t[EC_W + 1] = (uint32_t)(uv >> 32);
        const uint32_t m = t[0] * EC_CURVES[C].pinv;
        uv = (uint64_t)t[0] + (uint64_t)m * EC_CURVES[C].p[0];
        carry = uv >> 32;
#pragma unroll
        for (int j = 1; j < EC_W; ++j) {
            uv = (uint64_t)t[j] + (uint64_t)m * EC_CURVES[C].p[j] + carry;
            t[j - 1] = (uint32_t)uv;
            carry = uv >> 32;
        }
        uv = (uint64_t)t[EC_W] + carry;
        t[EC_W - 1] = (uint32_t)uv;
        t[EC_W] = t[EC_W + 1] + (uint32_t)(uv >> 32);
    }
    if (t[EC_W] || f_geq_p<C>(t)) f_sub_p<C>(t);
    f_copy<C>(r, t);
}

// a canonical integer -> Montgomery form
template <int C>
EC_FN void f_to_mont(uint32_t* r, const uint32_t* a) {
    uint32_t r2[EC_W];
    f_copy<C>(r2, EC_CURVES[C].r2);
    f_mul<C>(r, a, r2);
}

// Montgomery form -> the canonical integer
template <int C>
EC_FN void f_from_mont(uint32_t* r, const uint32_t* a) {
    uint32_t one[EC_W] = {1, 0, 0, 0, 0, 0, 0, 0};
    f_mul<C>(r, a, one);
}

// r = a^(p-2) = a^-1 (0 for 0), square and multiply from the top bit
template <int C>
EC_NOINLINE void f_inv(uint32_t* r, const uint32_t* a) {
    uint32_t acc[EC_W], av[EC_W];
    f_copy<C>(acc, EC_CURVES[C].one);
    f_copy<C>(av, a);
    for (int i = 255; i >= 0; --i) {
        f_mul<C>(acc, acc, acc);
        if ((EC_CURVES[C].pm2[i >> 5] >> (i & 31)) & 1) f_mul<C>(acc, acc, av);
    }
    f_copy<C>(r, acc);
}

// ---------------- the curve: projective (X:Y:Z), Montgomery form ----------------

// out = P + Q, the complete RCB addition in ops/weierstrass.Curve.add's
// closed form; valid for P = Q, the identity and inverses. out may alias
// P or Q.
template <int C>
EC_NOINLINE void pt_add(uint32_t* out, const uint32_t* P, const uint32_t* Q) {
    const uint32_t *X1 = P, *Y1 = P + EC_W, *Z1 = P + 2 * EC_W;
    const uint32_t *X2 = Q, *Y2 = Q + EC_W, *Z2 = Q + 2 * EC_W;
    uint32_t b3[EC_W], xx[EC_W], yy[EC_W], zz[EC_W], xy[EC_W], xz[EC_W],
        yz[EC_W], s1[EC_W], s2[EC_W], tm[EC_W], tp[EC_W], u[EC_W], v[EC_W],
        m1[EC_W], m2[EC_W], X3[EC_W], Y3[EC_W], Z3[EC_W];
    f_copy<C>(b3, EC_CURVES[C].b3);
    f_mul<C>(xx, X1, X2);
    f_mul<C>(yy, Y1, Y2);
    f_mul<C>(zz, Z1, Z2);
    // cross terms via (u+v)(s+t) - us - vt
    f_add<C>(s1, X1, Y1);
    f_add<C>(s2, X2, Y2);
    f_mul<C>(xy, s1, s2);
    f_sub<C>(xy, xy, xx);
    f_sub<C>(xy, xy, yy);
    f_add<C>(s1, X1, Z1);
    f_add<C>(s2, X2, Z2);
    f_mul<C>(xz, s1, s2);
    f_sub<C>(xz, xz, xx);
    f_sub<C>(xz, xz, zz);
    f_add<C>(s1, Y1, Z1);
    f_add<C>(s2, Y2, Z2);
    f_mul<C>(yz, s1, s2);
    f_sub<C>(yz, yz, yy);
    f_sub<C>(yz, yz, zz);
    f_mul<C>(s1, b3, zz);      // 3b ZZ
    f_mul<C>(u, b3, xz);       // u = a XX + 3b XZ - a^2 ZZ
    f_sub<C>(tm, yy, s1);      // YY - a XZ - 3b ZZ
    f_add<C>(tp, yy, s1);      // YY + a XZ + 3b ZZ
    f_add<C>(v, xx, xx);       // v = 3 XX + a ZZ
    f_add<C>(v, v, xx);
    if (!EC_CURVES[C].a_zero) {
        uint32_t a[EC_W];
        f_copy<C>(a, EC_CURVES[C].a);
        f_mul<C>(s1, a, xz);   // a XZ
        f_mul<C>(s2, a, zz);   // a ZZ
        f_sub<C>(tm, tm, s1);
        f_add<C>(tp, tp, s1);
        f_mul<C>(m1, a, xx);
        f_add<C>(u, u, m1);
        f_mul<C>(m1, a, s2);
        f_sub<C>(u, u, m1);
        f_add<C>(v, v, s2);
    }
    f_mul<C>(m1, xy, tm);
    f_mul<C>(m2, yz, u);
    f_sub<C>(X3, m1, m2);
    f_mul<C>(m1, v, u);
    f_mul<C>(m2, tp, tm);
    f_add<C>(Y3, m1, m2);
    f_mul<C>(m1, yz, tp);
    f_mul<C>(m2, xy, v);
    f_add<C>(Z3, m1, m2);
    f_copy<C>(out, X3);
    f_copy<C>(out + EC_W, Y3);
    f_copy<C>(out + 2 * EC_W, Z3);
}

// acc = [u1]G + [u2]Q; u1, u2 canonical words, qx, qy Montgomery form
template <int C>
EC_NOINLINE void shamir(uint32_t* acc, const uint32_t* u1, const uint32_t* u2,
                        const uint32_t* qx_m, const uint32_t* qy_m) {
    uint32_t tab[3 * EC_PT];   // G, Q, G + Q
    f_copy<C>(tab, EC_CURVES[C].gx);
    f_copy<C>(tab + EC_W, EC_CURVES[C].gy);
    f_copy<C>(tab + 2 * EC_W, EC_CURVES[C].one);
    f_copy<C>(tab + EC_PT, qx_m);
    f_copy<C>(tab + EC_PT + EC_W, qy_m);
    f_copy<C>(tab + EC_PT + 2 * EC_W, EC_CURVES[C].one);
    pt_add<C>(tab + 2 * EC_PT, tab, tab + EC_PT);
    // the identity (0 : 1 : 0); doubling it leaves it as it is
    for (int j = 0; j < EC_W; ++j) {
        acc[j] = 0;
        acc[2 * EC_W + j] = 0;
    }
    f_copy<C>(acc + EC_W, EC_CURVES[C].one);
    for (int i = 255; i >= 0; --i) {
        pt_add<C>(acc, acc, acc);
        const int d = (int)((u1[i >> 5] >> (i & 31)) & 1) |
                      ((int)((u2[i >> 5] >> (i & 31)) & 1) << 1);
        if (d) pt_add<C>(acc, acc, tab + (d - 1) * EC_PT);
    }
}

template <int C>
EC_FN void load_lane(uint32_t* d, const uint32_t* src, int B, int i) {
    for (int k = 0; k < EC_W; ++k) d[k] = src[(size_t)k * B + i];
}

// One lane of ecdsa_rlc: w = a rho (Montgomery form), 0 when inactive
template <int C>
EC_FN void rlc_lane(uint32_t* w, const uint32_t* u1s, const uint32_t* u2s,
                    const uint32_t* qxs, const uint32_t* qys,
                    const uint32_t* xrs, const uint32_t* xrpns,
                    const uint8_t* wrap_ok, const uint8_t* active,
                    const uint32_t* as, int B, int i) {
    for (int k = 0; k < EC_W; ++k) w[k] = 0;
    if (!active[i]) return;
    uint32_t u1[EC_W], u2[EC_W], qx[EC_W], qy[EC_W], t[EC_PT], x[EC_W],
        d1[EC_W], d2[EC_W], rho[EC_W];
    load_lane<C>(u1, u1s, B, i);
    load_lane<C>(u2, u2s, B, i);
    load_lane<C>(x, qxs, B, i);
    f_to_mont<C>(qx, x);
    load_lane<C>(x, qys, B, i);
    f_to_mont<C>(qy, x);
    shamir<C>(t, u1, u2, qx, qy);
    const uint32_t *X = t, *Z = t + 2 * EC_W;
    // projective x-residuals: zero iff x(T) == r (resp. r+n)
    load_lane<C>(x, xrs, B, i);
    f_to_mont<C>(d1, x);
    f_mul<C>(d1, d1, Z);
    f_sub<C>(d1, X, d1);
    if (wrap_ok[i]) {
        load_lane<C>(x, xrpns, B, i);
        f_to_mont<C>(d2, x);
        f_mul<C>(d2, d2, Z);
        f_sub<C>(d2, X, d2);
    } else {
        f_copy<C>(d2, EC_CURVES[C].one);
    }
    f_mul<C>(rho, d1, d2);
    // the identity has X = 0: pin rho to 1 (a reject)
    if (f_is_zero<C>(Z)) f_copy<C>(rho, EC_CURVES[C].one);
    load_lane<C>(x, as, B, i);
    f_to_mont<C>(x, x);
    f_mul<C>(w, x, rho);
}

// One item of ecdsa_verify: writes x (canonical) and returns the verdict
template <int C>
EC_FN bool verify_lane(uint32_t* x, const uint32_t* u1s, const uint32_t* u2s,
                       const uint32_t* qxs, const uint32_t* qys,
                       const uint32_t* rs, const uint32_t* rpns, int B,
                       int i) {
    uint32_t u1[EC_W], u2[EC_W], qx[EC_W], qy[EC_W], t[EC_PT], zi[EC_W],
        r[EC_W];
    load_lane<C>(u1, u1s, B, i);
    load_lane<C>(u2, u2s, B, i);
    load_lane<C>(x, qxs, B, i);
    f_to_mont<C>(qx, x);
    load_lane<C>(x, qys, B, i);
    f_to_mont<C>(qy, x);
    shamir<C>(t, u1, u2, qx, qy);
    const bool is_id = f_is_zero<C>(t + 2 * EC_W);
    f_inv<C>(zi, t + 2 * EC_W);
    f_mul<C>(x, t, zi);
    f_from_mont<C>(x, x);
    load_lane<C>(r, rs, B, i);
    bool match = f_eq<C>(x, r);
    load_lane<C>(r, rpns, B, i);
    match = match || f_eq<C>(x, r);
    return match && !is_id;
}

#ifndef ECDSA_HOST

template <int C>
__global__ void __launch_bounds__(EC_CTA)
ecdsa_rlc_kernel(const uint32_t* __restrict__ u1, const uint32_t* __restrict__ u2,
                 const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
                 const uint32_t* __restrict__ xr, const uint32_t* __restrict__ xrpn,
                 const uint8_t* __restrict__ wrap_ok,
                 const uint8_t* __restrict__ active,
                 const uint32_t* __restrict__ a, int B,
                 uint32_t* __restrict__ partial) {
    __shared__ uint32_t sh[EC_CTA][EC_W];
    const int tid = threadIdx.x;
    const int i = blockIdx.x * EC_CTA + tid;
    uint32_t w[EC_W] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (i < B) rlc_lane<C>(w, u1, u2, qx, qy, xr, xrpn, wrap_ok, active, a, B, i);
    for (int k = 0; k < EC_W; ++k) sh[tid][k] = w[k];
    __syncthreads();
    for (int s = EC_CTA / 2; s > 0; s >>= 1) {
        if (tid < s) f_add<C>(sh[tid], sh[tid], sh[tid + s]);
        __syncthreads();
    }
    if (tid < EC_W) partial[blockIdx.x * EC_W + tid] = sh[0][tid];
}

// One CTA: the partials' sum in a fixed order, out of Montgomery form
template <int C>
__global__ void __launch_bounds__(EC_CTA)
ecdsa_rlc_sum_kernel(const uint32_t* __restrict__ partial, int nparts,
                     uint32_t* __restrict__ out) {
    __shared__ uint32_t sh[EC_CTA][EC_W];
    const int tid = threadIdx.x;
    uint32_t acc[EC_W] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int j = tid; j < nparts; j += EC_CTA) f_add<C>(acc, acc, partial + j * EC_W);
    for (int k = 0; k < EC_W; ++k) sh[tid][k] = acc[k];
    __syncthreads();
    for (int s = EC_CTA / 2; s > 0; s >>= 1) {
        if (tid < s) f_add<C>(sh[tid], sh[tid], sh[tid + s]);
        __syncthreads();
    }
    if (tid == 0) {
        f_from_mont<C>(acc, sh[0]);
        for (int k = 0; k < EC_W; ++k) out[k] = acc[k];
    }
}

template <int C>
__global__ void __launch_bounds__(EC_CTA)
ecdsa_verify_kernel(const uint32_t* __restrict__ u1, const uint32_t* __restrict__ u2,
                    const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
                    const uint32_t* __restrict__ r, const uint32_t* __restrict__ rpn,
                    int B, uint8_t* __restrict__ ok, uint32_t* __restrict__ xout) {
    const int i = blockIdx.x * EC_CTA + threadIdx.x;
    if (i >= B) return;
    uint32_t x[EC_W];
    ok[i] = verify_lane<C>(x, u1, u2, qx, qy, r, rpn, B, i) ? 1 : 0;
    for (int k = 0; k < EC_W; ++k) xout[(size_t)k * B + i] = x[k];
}

template <int C>
static cudaError_t rlc_launch(const uint32_t* u1, const uint32_t* u2,
                              const uint32_t* qx, const uint32_t* qy,
                              const uint32_t* xr, const uint32_t* xrpn,
                              const uint8_t* wrap_ok, const uint8_t* active,
                              const uint32_t* a, int B, uint32_t* partial,
                              uint32_t* out, cudaStream_t stream) {
    const int blocks = (B + EC_CTA - 1) / EC_CTA;
    ecdsa_rlc_kernel<C><<<blocks, EC_CTA, 0, stream>>>(
        u1, u2, qx, qy, xr, xrpn, wrap_ok, active, a, B, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ecdsa_rlc_sum_kernel<C><<<1, EC_CTA, 0, stream>>>(partial, blocks, out);
    return cudaGetLastError();
}

template <int C>
static cudaError_t verify_launch(const uint32_t* u1, const uint32_t* u2,
                                 const uint32_t* qx, const uint32_t* qy,
                                 const uint32_t* r, const uint32_t* rpn,
                                 int B, uint8_t* ok, uint32_t* x,
                                 cudaStream_t stream) {
    const int blocks = (B + EC_CTA - 1) / EC_CTA;
    ecdsa_verify_kernel<C><<<blocks, EC_CTA, 0, stream>>>(u1, u2, qx, qy, r,
                                                          rpn, B, ok, x);
    return cudaGetLastError();
}

extern "C" {

// curve: 0 secp256k1, 1 secp256r1. partial: (B + 63) / 64 * 8 words of
// scratch; out: 8 words. Returns a cudaError_t (0 on success).
int ecdsa_rlc_launch(int curve, const void* u1, const void* u2,
                     const void* qx, const void* qy, const void* xr,
                     const void* xrpn, const void* wrap_ok,
                     const void* active, const void* a, int B,
                     void* partial, void* out, void* stream) {
    if (B <= 0) return (int)cudaErrorInvalidValue;
    auto f = curve == 0 ? rlc_launch<0> : curve == 1 ? rlc_launch<1> : nullptr;
    if (f == nullptr) return (int)cudaErrorInvalidValue;
    return (int)f((const uint32_t*)u1, (const uint32_t*)u2,
                  (const uint32_t*)qx, (const uint32_t*)qy,
                  (const uint32_t*)xr, (const uint32_t*)xrpn,
                  (const uint8_t*)wrap_ok, (const uint8_t*)active,
                  (const uint32_t*)a, B, (uint32_t*)partial, (uint32_t*)out,
                  (cudaStream_t)stream);
}

int ecdsa_verify_launch(int curve, const void* u1, const void* u2,
                        const void* qx, const void* qy, const void* r,
                        const void* rpn, int B, void* ok, void* x,
                        void* stream) {
    if (B <= 0) return (int)cudaErrorInvalidValue;
    auto f = curve == 0 ? verify_launch<0> : curve == 1 ? verify_launch<1> : nullptr;
    if (f == nullptr) return (int)cudaErrorInvalidValue;
    return (int)f((const uint32_t*)u1, (const uint32_t*)u2,
                  (const uint32_t*)qx, (const uint32_t*)qy,
                  (const uint32_t*)r, (const uint32_t*)rpn, B, (uint8_t*)ok,
                  (uint32_t*)x, (cudaStream_t)stream);
}

const char* ecdsa_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

#endif  // ECDSA_HOST
