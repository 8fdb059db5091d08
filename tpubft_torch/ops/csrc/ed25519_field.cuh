// GF(2^255-19) and Ed25519 point arithmetic for one lane per thread.
//
// Field representation: ten signed 32-bit limbs of alternating 26 and 25
// bits (limb i at bit ceil(25.5*i)), 64-bit products (the ref10 radix).
// Hopper multiplies 32x32->64 natively (IMAD.WIDE), so a field multiply is
// 100 wide multiply-adds into ten int64 column sums plus one carry chain;
// the TPU's 24-limb 10/11-bit radix (tpubft/ops/f25519.py) existed only for
// the TPU's int32 vector unit and is converted at kernel entry.
//
// Operand budget (ref10's): fe_mul/fe_sq take limbs bounded by 1.65*2^26
// (even) / 1.65*2^25 (odd); every output of fe_mul, fe_sq and fe_reduce is
// bounded by about 2^25 / 2^24. So a sum or difference of at most three
// such outputs may feed a multiply; the one four-term value in the doubling
// formula goes through fe_reduce first. With these bounds the 19*g
// precomputes fit in int32 and every column sum stays below 2^62.
//
// Everything here is __device__ code for the verify kernel in
// ed25519_verify.cu; ED_FN also lets a host C++ compiler build the same
// functions for a quick check of the arithmetic away from the card.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define ED_FN __device__ __forceinline__
#define ED_CONST __constant__
#else
#define ED_FN static inline
#define ED_CONST static
#endif

struct Fe { int32_t v[10]; };
struct Ext { Fe x, y, z, t; };

// constants uploaded from the host (ed25519_cuda.py computes them from
// Python ints): D, 2D, sqrt(-1), then the niels table [d]B for d = 0..15 as
// (y+x, y-x, 2d*x*y), all canonical limbs
ED_CONST int32_t c_consts[3][10];
ED_CONST int32_t c_btab[16][3][10];
#define ED_D 0
#define ED_K2D 1
#define ED_SQRTM1 2

ED_FN Fe fe_const(int which) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = c_consts[which][i];
  return r;
}

ED_FN Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = 0;
  return r;
}

ED_FN Fe fe_one() {
  Fe r = fe_zero();
  r.v[0] = 1;
  return r;
}

ED_FN Fe fe_add(const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = a.v[i] + b.v[i];
  return r;
}

ED_FN Fe fe_sub(const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = a.v[i] - b.v[i];
  return r;
}

ED_FN Fe fe_neg(const Fe& a) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = -a.v[i];
  return r;
}

// Signed carry chain over ten column sums (ref10's order): centres every
// limb, folds the carry out of limb 9 back into limb 0 with factor 19
// (2^255 = 19 mod p).
ED_FN Fe fe_carry(int64_t h[10]) {
  int64_t c;
  c = (h[0] + (1LL << 25)) >> 26; h[1] += c; h[0] -= c * (1LL << 26);
  c = (h[4] + (1LL << 25)) >> 26; h[5] += c; h[4] -= c * (1LL << 26);
  c = (h[1] + (1LL << 24)) >> 25; h[2] += c; h[1] -= c * (1LL << 25);
  c = (h[5] + (1LL << 24)) >> 25; h[6] += c; h[5] -= c * (1LL << 25);
  c = (h[2] + (1LL << 25)) >> 26; h[3] += c; h[2] -= c * (1LL << 26);
  c = (h[6] + (1LL << 25)) >> 26; h[7] += c; h[6] -= c * (1LL << 26);
  c = (h[3] + (1LL << 24)) >> 25; h[4] += c; h[3] -= c * (1LL << 25);
  c = (h[7] + (1LL << 24)) >> 25; h[8] += c; h[7] -= c * (1LL << 25);
  c = (h[4] + (1LL << 25)) >> 26; h[5] += c; h[4] -= c * (1LL << 26);
  c = (h[8] + (1LL << 25)) >> 26; h[9] += c; h[8] -= c * (1LL << 26);
  c = (h[9] + (1LL << 24)) >> 25; h[0] += c * 19; h[9] -= c * (1LL << 25);
  c = (h[0] + (1LL << 25)) >> 26; h[1] += c; h[0] -= c * (1LL << 26);
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = (int32_t)h[i];
  return r;
}

// Bring a sum of a few reduced values back to the reduced bound.
ED_FN Fe fe_reduce(const Fe& a) {
  int64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = a.v[i];
  return fe_carry(h);
}

// Schoolbook product. The pair (i, j) lands in column (i+j) mod 10 with
// weight 2 when both limbs are odd (25.5-bit radix) and 19 when i+j >= 10.
ED_FN Fe fe_mul(const Fe& f, const Fe& g) {
  int32_t g19[10], f2[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    g19[i] = 19 * g.v[i];
    f2[i] = 2 * f.v[i];
  }
  int64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = 0; j < 10; j++) {
      const int32_t a = ((i & 1) && (j & 1)) ? f2[i] : f.v[i];
      const int32_t b = (i + j >= 10) ? g19[j] : g.v[j];
      h[(i + j) % 10] += (int64_t)a * b;
    }
  }
  return fe_carry(h);
}

// Square: the 45 cross products once, doubled, plus the 10 squares.
ED_FN Fe fe_sq(const Fe& f) {
  int32_t f19[10], f2[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    f19[i] = 19 * f.v[i];
    f2[i] = 2 * f.v[i];
  }
  int64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = i; j < 10; j++) {
      const int32_t a = (i == j) ? f.v[i] : f2[i];
      const int32_t b = (i + j >= 10) ? f19[j] : f.v[j];
      int64_t p = (int64_t)a * b;
      if ((i & 1) && (j & 1)) p += p;
      h[(i + j) % 10] += p;
    }
  }
  return fe_carry(h);
}

ED_FN Fe fe_pow2k(Fe x, int k) {
  for (int i = 0; i < k; i++) x = fe_sq(x);
  return x;
}

// x^(2^250 - 1) and x^11: the shared core of the inversion and square-root
// chains (the standard curve25519 addition chain, as in the reference).
ED_FN void fe_chain_250(const Fe& x, Fe* t250, Fe* z11) {
  Fe z2 = fe_sq(x);
  Fe z9 = fe_mul(fe_pow2k(z2, 2), x);
  *z11 = fe_mul(z9, z2);
  Fe z_5 = fe_mul(fe_sq(*z11), z9);
  Fe z_10 = fe_mul(fe_pow2k(z_5, 5), z_5);
  Fe z_20 = fe_mul(fe_pow2k(z_10, 10), z_10);
  Fe z_40 = fe_mul(fe_pow2k(z_20, 20), z_20);
  Fe z_50 = fe_mul(fe_pow2k(z_40, 10), z_10);
  Fe z_100 = fe_mul(fe_pow2k(z_50, 50), z_50);
  Fe z_200 = fe_mul(fe_pow2k(z_100, 100), z_100);
  *t250 = fe_mul(fe_pow2k(z_200, 50), z_50);
}

// x^(p-2); inv(0) = 0
ED_FN Fe fe_inv(const Fe& x) {
  Fe t250, z11;
  fe_chain_250(x, &t250, &z11);
  return fe_mul(fe_pow2k(t250, 5), z11);
}

// x^((p-5)/8)
ED_FN Fe fe_pow_p58(const Fe& x) {
  Fe t250, z11;
  fe_chain_250(x, &t250, &z11);
  return fe_mul(fe_pow2k(t250, 2), x);
}

// Canonical residue in [0, p): limbs in [0, 2^26) / [0, 2^25) (ref10's
// fe_tobytes without the byte packing). q = floor(value / p) is found from
// the top down, then value - q*p is carried out exactly.
ED_FN Fe fe_canon(const Fe& a) {
  Fe h = fe_reduce(a);
  int32_t q = (19 * h.v[9] + (1 << 24)) >> 25;
#pragma unroll
  for (int i = 0; i < 10; i++) q = (h.v[i] + q) >> ((i & 1) ? 25 : 26);
  h.v[0] += 19 * q;
#pragma unroll
  for (int i = 0; i < 9; i++) {
    const int s = (i & 1) ? 25 : 26;
    const int32_t c = h.v[i] >> s;
    h.v[i + 1] += c;
    h.v[i] -= c * (1 << s);
  }
  h.v[9] &= (1 << 25) - 1;
  return h;
}

ED_FN bool fe_iszero(const Fe& a) {
  Fe c = fe_canon(a);
  int32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) acc |= c.v[i];
  return acc == 0;
}

// Bit position of limb k of the TPU layout: W[k] = ceil(255*k/24), limbs of
// 10 or 11 bits. `limbs[k*stride]` holds limb k of this lane.
ED_FN int w24(int k) { return (255 * k + 23) / 24; }
ED_FN int off10(int i) { return (51 * i + 1) / 2; }

// Tight 24-limb value (< 2^255, limbs in [0, 2^bits)) -> canonical Fe.
ED_FN Fe fe_from_w24(const int32_t* limbs, int stride) {
  uint32_t w[9];
#pragma unroll
  for (int i = 0; i < 9; i++) w[i] = 0;
#pragma unroll
  for (int k = 0; k < 24; k++) {
    const uint64_t v = (uint64_t)(uint32_t)limbs[k * stride]
                       << (w24(k) & 31);
    w[w24(k) >> 5] |= (uint32_t)v;
    w[(w24(k) >> 5) + 1] |= (uint32_t)(v >> 32);
  }
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int off = off10(i), width = (i & 1) ? 25 : 26;
    const uint64_t lo = (uint64_t)w[off >> 5] |
                        ((uint64_t)w[(off >> 5) + 1] << 32);
    r.v[i] = (int32_t)((lo >> (off & 31)) & ((1u << width) - 1));
  }
  return r;
}

// Canonical Fe -> tight 24-limb value (the inverse of fe_from_w24).
ED_FN void fe_to_w24(const Fe& c, int32_t* limbs, int stride) {
  uint32_t w[9];
#pragma unroll
  for (int i = 0; i < 9; i++) w[i] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const uint64_t v = (uint64_t)(uint32_t)c.v[i] << (off10(i) & 31);
    w[off10(i) >> 5] |= (uint32_t)v;
    w[(off10(i) >> 5) + 1] |= (uint32_t)(v >> 32);
  }
#pragma unroll
  for (int k = 0; k < 24; k++) {
    const int off = w24(k), width = w24(k + 1) - w24(k);
    const uint64_t lo = (uint64_t)w[off >> 5] |
                        ((uint64_t)w[(off >> 5) + 1] << 32);
    limbs[k * stride] = (int32_t)((lo >> (off & 31)) & ((1u << width) - 1));
  }
}

// ---- points: the reference's formulas (tpubft/ops/ed25519.py) ----

ED_FN Ext ext_identity() {
  Ext p;
  p.x = fe_zero(); p.y = fe_one(); p.z = fe_one(); p.t = fe_zero();
  return p;
}

// unified extended addition (add-2008-hwcd-3, a=-1, k=2d): 9 multiplies
ED_FN Ext ext_add(const Ext& p, const Ext& q) {
  const Fe a = fe_mul(fe_sub(p.y, p.x), fe_sub(q.y, q.x));
  const Fe b = fe_mul(fe_add(p.y, p.x), fe_add(q.y, q.x));
  const Fe c = fe_mul(fe_mul(p.t, fe_const(ED_K2D)), q.t);
  const Fe d = fe_mul(p.z, fe_add(q.z, q.z));
  const Fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c),
           h = fe_add(b, a);
  Ext r;
  r.x = fe_mul(e, f); r.y = fe_mul(g, h); r.z = fe_mul(f, g);
  r.t = fe_mul(e, h);
  return r;
}

// dedicated doubling (dbl-2008-hwcd, a=-1): 4 multiplies + 4 squares
ED_FN Ext ext_dbl(const Ext& p) {
  const Fe a = fe_sq(p.x), b = fe_sq(p.y);
  Fe c = fe_sq(p.z);
  c = fe_add(c, c);
  const Fe e = fe_sub(fe_sub(fe_sq(fe_add(p.x, p.y)), a), b);
  const Fe g = fe_sub(b, a);
  const Fe h = fe_neg(fe_add(a, b));
  const Fe f = fe_reduce(fe_sub(g, c));      // four terms: reduce first
  Ext r;
  r.x = fe_mul(e, f); r.y = fe_mul(g, h); r.z = fe_mul(f, g);
  r.t = fe_mul(e, h);
  return r;
}

// mixed addition with the niels point [d]B from constant memory: 7 multiplies
ED_FN Ext ext_madd_base(const Ext& p, int d) {
  Fe ypx, ymx, t2d;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    ypx.v[i] = c_btab[d][0][i];
    ymx.v[i] = c_btab[d][1][i];
    t2d.v[i] = c_btab[d][2][i];
  }
  const Fe a = fe_mul(fe_sub(p.y, p.x), ymx);
  const Fe b = fe_mul(fe_add(p.y, p.x), ypx);
  const Fe c = fe_mul(p.t, t2d);
  const Fe dd = fe_add(p.z, p.z);
  const Fe e = fe_sub(b, a), f = fe_sub(dd, c), g = fe_add(dd, c),
           h = fe_add(b, a);
  Ext r;
  r.x = fe_mul(e, f); r.y = fe_mul(g, h); r.z = fe_mul(f, g);
  r.t = fe_mul(e, h);
  return r;
}

// RFC 8032 strict verify of one lane: decompress A, Q = [s]B + [h](-A) by a
// 64-window msb-first ladder, compare encode(Q) with R. `stride` is the
// batch size: window w of this lane is s_win[w*stride], limb k is
// a_y[k*stride].
ED_FN bool verify_lane(const int32_t* s_win, const int32_t* h_win,
                       const int32_t* a_y, int32_t a_sign,
                       const int32_t* r_y, int32_t r_sign, int stride) {
  // decompress A: x = sqrt((y^2-1)/(d y^2+1)) by the (p-5)/8 exponent
  const Fe y = fe_reduce(fe_from_w24(a_y, stride));
  const Fe one = fe_one();
  const Fe y2 = fe_sq(y);
  const Fe u = fe_sub(y2, one);
  const Fe v = fe_add(fe_mul(y2, fe_const(ED_D)), one);
  const Fe v3 = fe_mul(fe_sq(v), v);
  const Fe v7 = fe_mul(fe_sq(v3), v);
  const Fe w = fe_pow_p58(fe_mul(u, v7));
  Fe x = fe_mul(fe_mul(u, v3), w);
  const Fe vx2 = fe_mul(v, fe_sq(x));
  const bool c1 = fe_iszero(fe_sub(vx2, u));
  const bool c2 = fe_iszero(fe_add(vx2, u));
  bool valid = c1 || c2;
  if (c2) x = fe_mul(x, fe_const(ED_SQRTM1));
  const Fe xc = fe_canon(x);
  int32_t x_or = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) x_or |= xc.v[i];
  const bool sign = a_sign != 0;
  if (((xc.v[0] & 1) != 0) != sign) x = fe_neg(x);
  valid = valid && !(x_or == 0 && sign);

  // table [j](-A), j = 0..15
  Ext na;
  na.x = fe_neg(x); na.y = y; na.z = one; na.t = fe_neg(fe_mul(x, y));
  Ext tab[16];
  tab[0] = ext_identity();
  tab[1] = na;
  for (int j = 2; j < 16; j++) tab[j] = ext_add(tab[j - 1], na);

  Ext acc = ext_identity();
  for (int win = 63; win >= 0; win--) {
    acc = ext_dbl(ext_dbl(ext_dbl(ext_dbl(acc))));
    acc = ext_madd_base(acc, s_win[win * stride] & 15);
    acc = ext_add(acc, tab[h_win[win * stride] & 15]);
  }

  // encode(acc) == (r_y, r_sign)
  const Fe zi = fe_inv(acc.z);
  const Fe xa = fe_canon(fe_mul(acc.x, zi));
  const Fe ya = fe_canon(fe_mul(acc.y, zi));
  const Fe r = fe_from_w24(r_y, stride);
  int32_t diff = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) diff |= ya.v[i] ^ r.v[i];
  const bool parity_ok = ((xa.v[0] & 1) != 0) == (r_sign != 0);
  return valid && diff == 0 && parity_ok;
}
