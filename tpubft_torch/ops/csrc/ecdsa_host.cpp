// Host build of ecdsa.cu's arithmetic, for a check of the kernels' own
// code away from the card (tests/test_torch_ecdsa_kernel.py):
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libecdsa_host.so ecdsa_host.cpp
//
// The .cu compiles as plain C++ with ECDSA_HOST: the field, the point
// formulas, the GLV split, the recoding, a lane's two parts and its end.
// A lane's two threads share nothing but its shared memory, read after a
// barrier, so here each lane runs its [u1]G part, then its [u2]Q part,
// then its end, in a buffer of its own (stride 1), and the launches sum
// the RLC weights mod p lane by lane (the card's CTA trees and partial
// sums add the same values in another order; the sum mod p is the same).
#define ECDSA_HOST
#include "ecdsa.cu"

template <int C>
static void host_parts(uint32_t* sh, const uint32_t* u1, const uint32_t* u2,
                       const uint32_t* qx, const uint32_t* qy,
                       const uint32_t* gtab, int B, int i) {
    uint32_t k[EC_W];
    load_lane(k, u1, B, i);
    g_part<C>(sh, 1, k, gtab);
    load_lane(k, u2, B, i);
    q_part<C>(sh, 1, k, load_fe(qx, B, i), load_fe(qy, B, i));
}

template <int C>
static void host_rlc(const uint32_t* u1, const uint32_t* u2,
                     const uint32_t* qx, const uint32_t* qy,
                     const uint32_t* xr, const uint32_t* xrpn,
                     const uint8_t* wrap_ok, const uint8_t* active,
                     const uint32_t* a, const uint32_t* gtab, int B,
                     uint32_t* out) {
    static uint32_t sh[EC_SH_LANE];
    Fe acc = f_small(0u);
    for (int i = 0; i < B; ++i) {
        if (!active[i]) continue;
        host_parts<C>(sh, u1, u2, qx, qy, gtab, B, i);
        acc = f_add<C>(acc, rlc_finish<C>(sh, 1, xr, xrpn, wrap_ok, a, B, i));
    }
    sto(out, 1, acc);
}

template <int C>
static void host_verify(const uint32_t* u1, const uint32_t* u2,
                        const uint32_t* qx, const uint32_t* qy,
                        const uint32_t* r, const uint32_t* rpn,
                        const uint32_t* gtab, int B, uint8_t* ok,
                        uint32_t* xout) {
    static uint32_t sh[EC_SH_LANE];
    for (int i = 0; i < B; ++i) {
        host_parts<C>(sh, u1, u2, qx, qy, gtab, B, i);
        Fe x;
        ok[i] = verify_finish<C>(sh, 1, r, rpn, B, i, x) ? 1 : 0;
        for (int k = 0; k < EC_W; ++k) xout[(size_t)k * B + i] = x.v[k];
    }
}

// op 0: a b, 1: a + b, 2: a - b, 3: a^-1, 4: a^2, 5: a b 2^-256 (the
// probe's Montgomery product); n elements of 8 words, each contiguous
template <int C>
static void host_field(int op, const uint32_t* a, const uint32_t* b,
                       uint32_t* r, int n) {
    static uint32_t tab[15 * EC_W];
    for (int e = 0; e < n; ++e) {
        const Fe x = ld(a + e * EC_W, 1), y = ld(b + e * EC_W, 1);
        Fe z;
        switch (op) {
            case 0: z = f_mul<C>(x, y); break;
            case 1: z = f_add<C>(x, y); break;
            case 2: z = f_sub<C>(x, y); break;
            case 3: z = f_inv<C>(x, tab, 1); break;
            case 4: z = f_sqr<C>(x); break;
            default: z = f_mul_mont<C>(x, y); break;
        }
        sto(r + e * EC_W, 1, z);
    }
}

// op 0: out = 2P; 1: P + Q' (Q' = Q, Y negated where flags & 1, X times
// beta where flags & 2); 2: P + (Q's x, y) as an affine point (Y negated
// where flags & 1). Jacobian points of 24 words.
template <int C>
static void host_pt(int op, const uint32_t* p, const uint32_t* q, int flags,
                    uint32_t* out) {
    uint32_t a[EC_PT], b[EC_PT];
    for (int k = 0; k < EC_PT; ++k) {
        a[k] = p[k];
        b[k] = q[k];
    }
    if (op == 0)
        pt_dbl<C>(a, 1, a, 1);
    else if (op == 1)
        pt_add<C>(a, 1, a, 1, b, 1, flags & 1, (flags >> 1) & 1);
    else
        pt_madd<C>(a, 1, a, 1, b, 1, flags & 1);
    for (int k = 0; k < EC_PT; ++k) out[k] = a[k];
}

extern "C" {

int ecdsa_host_rlc(int curve, const uint32_t* u1, const uint32_t* u2,
                   const uint32_t* qx, const uint32_t* qy,
                   const uint32_t* xr, const uint32_t* xrpn,
                   const uint8_t* wrap_ok, const uint8_t* active,
                   const uint32_t* a, const uint32_t* gtab, int B,
                   uint32_t* out) {
    if (curve == 0)
        host_rlc<0>(u1, u2, qx, qy, xr, xrpn, wrap_ok, active, a, gtab, B, out);
    else if (curve == 1)
        host_rlc<1>(u1, u2, qx, qy, xr, xrpn, wrap_ok, active, a, gtab, B, out);
    else
        return 1;
    return 0;
}

int ecdsa_host_verify(int curve, const uint32_t* u1, const uint32_t* u2,
                      const uint32_t* qx, const uint32_t* qy,
                      const uint32_t* r, const uint32_t* rpn,
                      const uint32_t* gtab, int B, uint8_t* ok, uint32_t* x) {
    if (curve == 0)
        host_verify<0>(u1, u2, qx, qy, r, rpn, gtab, B, ok, x);
    else if (curve == 1)
        host_verify<1>(u1, u2, qx, qy, r, rpn, gtab, B, ok, x);
    else
        return 1;
    return 0;
}

int ecdsa_host_field(int curve, int op, const uint32_t* a, const uint32_t* b,
                     uint32_t* r, int n) {
    if (curve == 0)
        host_field<0>(op, a, b, r, n);
    else if (curve == 1)
        host_field<1>(op, a, b, r, n);
    else
        return 1;
    return 0;
}

int ecdsa_host_pt(int curve, int op, const uint32_t* p, const uint32_t* q,
                  int flags, uint32_t* out) {
    if (curve == 0)
        host_pt<0>(op, p, q, flags, out);
    else if (curve == 1)
        host_pt<1>(op, p, q, flags, out);
    else
        return 1;
    return 0;
}

// the field products run since the last call (squarings included)
long long ecdsa_host_products(void) {
    const long long n = ec_products;
    ec_products = 0;
    return n;
}

// secp256k1's split of k (8 words, < n): |k1|, |k2| (5 words each) and
// their signs
int ecdsa_host_glv(const uint32_t* k, uint32_t* k1, uint32_t* k2,
                   uint32_t* negs) {
    glv_split(k, k1, negs[0], k2, negs[1]);
    return 0;
}

}  // extern "C"
