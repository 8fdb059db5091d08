// Host build of ecdsa.cu's arithmetic, for a check of the kernels' own
// code away from the card (tests/test_torch_ecdsa_kernel.py):
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libecdsa_host.so ecdsa_host.cpp
//
// The .cu compiles as plain C++ with ECDSA_HOST: the field, the point
// formula, the ladder and the two lane functions. The kernels are one
// thread a lane with no exchange between lanes, so the launches here run
// the lanes one after another and sum the RLC weights mod p (the card's
// CTA trees and partial sums add the same values in another order; the
// sum mod p is the same).
#define ECDSA_HOST
#include "ecdsa.cu"

template <int C>
static void host_rlc(const uint32_t* u1, const uint32_t* u2,
                     const uint32_t* qx, const uint32_t* qy,
                     const uint32_t* xr, const uint32_t* xrpn,
                     const uint8_t* wrap_ok, const uint8_t* active,
                     const uint32_t* a, int B, uint32_t* out) {
    uint32_t acc[EC_W] = {0, 0, 0, 0, 0, 0, 0, 0}, w[EC_W];
    for (int i = 0; i < B; ++i) {
        rlc_lane<C>(w, u1, u2, qx, qy, xr, xrpn, wrap_ok, active, a, B, i);
        f_add<C>(acc, acc, w);
    }
    f_from_mont<C>(out, acc);
}

template <int C>
static void host_verify(const uint32_t* u1, const uint32_t* u2,
                        const uint32_t* qx, const uint32_t* qy,
                        const uint32_t* r, const uint32_t* rpn, int B,
                        uint8_t* ok, uint32_t* xout) {
    uint32_t x[EC_W];
    for (int i = 0; i < B; ++i) {
        ok[i] = verify_lane<C>(x, u1, u2, qx, qy, r, rpn, B, i) ? 1 : 0;
        for (int k = 0; k < EC_W; ++k) xout[(size_t)k * B + i] = x[k];
    }
}

// op 0: a b R^-1, 1: a + b, 2: a - b, 3: a^-1, 4: to Montgomery form,
// 5: from it; n elements of 8 words, each element's words contiguous
template <int C>
static void host_field(int op, const uint32_t* a, const uint32_t* b,
                       uint32_t* r, int n) {
    for (int e = 0; e < n; ++e) {
        const uint32_t *x = a + e * EC_W, *y = b + e * EC_W;
        uint32_t* z = r + e * EC_W;
        switch (op) {
            case 0: f_mul<C>(z, x, y); break;
            case 1: f_add<C>(z, x, y); break;
            case 2: f_sub<C>(z, x, y); break;
            case 3: f_inv<C>(z, x); break;
            case 4: f_to_mont<C>(z, x); break;
            default: f_from_mont<C>(z, x); break;
        }
    }
}

extern "C" {

int ecdsa_host_rlc(int curve, const uint32_t* u1, const uint32_t* u2,
                   const uint32_t* qx, const uint32_t* qy,
                   const uint32_t* xr, const uint32_t* xrpn,
                   const uint8_t* wrap_ok, const uint8_t* active,
                   const uint32_t* a, int B, uint32_t* out) {
    if (curve == 0)
        host_rlc<0>(u1, u2, qx, qy, xr, xrpn, wrap_ok, active, a, B, out);
    else if (curve == 1)
        host_rlc<1>(u1, u2, qx, qy, xr, xrpn, wrap_ok, active, a, B, out);
    else
        return 1;
    return 0;
}

int ecdsa_host_verify(int curve, const uint32_t* u1, const uint32_t* u2,
                      const uint32_t* qx, const uint32_t* qy,
                      const uint32_t* r, const uint32_t* rpn, int B,
                      uint8_t* ok, uint32_t* x) {
    if (curve == 0)
        host_verify<0>(u1, u2, qx, qy, r, rpn, B, ok, x);
    else if (curve == 1)
        host_verify<1>(u1, u2, qx, qy, r, rpn, B, ok, x);
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

// out = P + Q on projective Montgomery points of 24 words
int ecdsa_host_pt_add(int curve, const uint32_t* p, const uint32_t* q,
                      uint32_t* out) {
    if (curve == 0)
        pt_add<0>(out, p, q);
    else if (curve == 1)
        pt_add<1>(out, p, q);
    else
        return 1;
    return 0;
}

}  // extern "C"
