// GF(2^255-19) and Ed25519 point arithmetic for the verify kernel, with a
// signature spread over a group of four lanes.
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
// such outputs may feed a multiply. With these bounds the 19*g precomputes
// fit in int32 and every column sum stays below 2^62; fe_sq's doubled form
// (2f^2, as ref10's fe_sq2) is only taken of a single reduced output, whose
// column sums stay below 2^60.
//
// Points (the g_* functions): lane c = 0..3 of a group of four consecutive
// threads owns coordinate c of an extended point (X, Y, Z, T), and each
// formula of the reference (tpubft/ops/ed25519.py: dbl-2008-hwcd,
// add-2008-hwcd-3, the niels mixed add; a = -1) runs as two steps of one
// multiply or square per lane, the four-processor schedule of Hisil, Wong,
// Carter and Dawson, "Twisted Edwards Curves Revisited" (ASIACRYPT 2008).
// Limbs move between the steps by shuffles within the group (ED_SHFL).
//
// Everything here is __device__ code for ed25519_verify.cu, bringup.cu and
// fe_inv.cu; ED_FN also lets a host C++ compiler build the same functions
// for a check of the arithmetic away from the card (a host build provides
// ed_shfl and ed_shfl_xor, running the four lanes of a group in lock-step).
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define ED_FN __device__ __forceinline__
#define ED_NOINLINE __device__ __noinline__
#define ED_CONST __constant__
#define ED_SHFL(v, src) __shfl_sync(0xffffffffu, (v), (src), 4)
#define ED_SHFL_XOR(v, m) __shfl_xor_sync(0xffffffffu, (v), (m), 4)
#else
#define ED_FN static inline
#define ED_NOINLINE static
#define ED_CONST static
#define ED_SHFL(v, src) ed_shfl((v), (src))
#define ED_SHFL_XOR(v, m) ed_shfl_xor((v), (m))
#endif

struct Fe { int32_t v[10]; };

// constants uploaded from the host (ed25519_cuda.py computes them from
// Python ints): D, 2D, sqrt(-1), canonical limbs; every lane reads the same
// word, so they stay in constant memory
ED_CONST int32_t c_consts[3][10];
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

// Square: the 45 cross products once, doubled, plus the 10 squares; with
// `twice` 1 the column sums are doubled before the carry, giving 2f^2 as one
// reduced output (ref10's fe_sq2).
ED_FN Fe fe_sq(const Fe& f, int twice = 0) {
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
  const int64_t keep = -(int64_t)twice;        // all ones or zero
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] += h[i] & keep;
  return fe_carry(h);
}

ED_FN Fe fe_pow2k(Fe x, int k) {
  for (int i = 0; i < k; i++) x = fe_sq(x);
  return x;
}

// x^(2^250 - 1) and x^11: the core of the square-root chain (the standard
// curve25519 addition chain, as in the reference; fe_inv.cu runs the
// inversion's own copy of it on its four-lane field steps).
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

ED_FN Fe fe_sel(bool take_a, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = take_a ? a.v[i] : b.v[i];
  return r;
}

// entry c of (a0, a1, a2, a3): lane c's pick, by selects (no branch)
ED_FN Fe fe_pick4(int c, const Fe& a0, const Fe& a1, const Fe& a2,
                  const Fe& a3) {
  return fe_sel(c < 2, fe_sel(c == 0, a0, a1), fe_sel(c == 2, a2, a3));
}

ED_FN Fe fe_small(int32_t k) {
  Fe r = fe_zero();
  r.v[0] = k;
  return r;
}

// RFC 8032 decompression of (y, sign) by the (p-5)/8 exponent: x with the
// parity of `sign`; *valid is false where (y^2-1)/(d y^2+1) has no square
// root and where x = 0 with the sign bit set. The conditional sqrt(-1)
// factor is a select, so lanes that take it do not split from the others.
// A call, not inlined: inlined into the verify kernel, its live values
// pushed ptxas to 255 registers and a spill inside the ladder; as a call it
// costs one stack frame per thread, once.
ED_NOINLINE Fe fe_decompress(const Fe& y, bool sign, bool* valid) {
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
  x = fe_sel(c2, fe_mul(x, fe_const(ED_SQRTM1)), x);
  const Fe xc = fe_canon(x);
  int32_t x_or = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) x_or |= xc.v[i];
  x = fe_sel(((xc.v[0] & 1) != 0) != sign, fe_neg(x), x);
  *valid = (c1 || c2) && !(x_or == 0 && sign);
  return x;
}

// ---- a point on a group of four lanes ----

ED_FN Fe fe_shfl(const Fe& a, int src) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = ED_SHFL(a.v[i], src);
  return r;
}

// The exchanges below go limb by limb: each limb is shuffled and consumed
// at once, so a step keeps its inputs and two operands live, not the
// other lanes' coordinates as well.

// First operand of an addition's first step, from this lane's coordinate
// v: lane 0 Y-X, lane 1 Y+X, lane 2 T, lane 3 Z.
ED_FN Fe g_add_operand(const Fe& v, int c) {
  const int src = c < 2 ? 1 : (c ^ 1);
  const int32_t sx = c == 0 ? -1 : (c == 1 ? 1 : 0);
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; i++)
    r.v[i] = ED_SHFL(v.v[i], src) + sx * ED_SHFL(v.v[i], 0);
  return r;
}

// Second step of every formula here: the lanes hold the first step's
// products a, b, c, d in lane order; with E = b-a, F = d-c, G = d+c,
// H = b+a, lane 0 returns X3 = E F, lane 1 Y3 = G H, lane 2 Z3 = F G and
// lane 3 T3 = E H. One exchange within each pair (lanes 0,1 then hold a
// and b, lanes 2,3 c and d), one across the pairs.
ED_FN Fe g_finish(const Fe& prod, int c) {
  Fe op1, op2;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int32_t o = ED_SHFL_XOR(prod.v[i], 1);
    // lanes 0,1: E, H; lanes 2,3: F, G
    const int32_t diff = (c & 1) ? prod.v[i] - o : o - prod.v[i];
    const int32_t sum = prod.v[i] + o;
    const int32_t xd = ED_SHFL_XOR(diff, 2), xs = ED_SHFL_XOR(sum, 2);
    op1.v[i] = c == 1 ? xs : (c == 3 ? xd : diff);      // E, G, F, E
    op2.v[i] = c == 0 ? xd : (c == 3 ? xs : sum);       // F, H, G, H
  }
  return fe_mul(op1, op2);
}

// Addition of a point in cached form: lane c passes coordinate c of
// (Y2-X2, Y2+X2, 2d T2, 2 Z2) — or of the base niels point
// (y-x, y+x, 2d x y, 2), the mixed addition — as q. add-2008-hwcd-3:
// a = (Y1-X1)(Y2-X2), b = (Y1+X1)(Y2+X2), c = T1 2d T2, d = Z1 2 Z2.
ED_FN Fe g_add(const Fe& v, int c, const Fe& q) {
  return g_finish(fe_mul(g_add_operand(v, c), q), c);
}

// dbl-2008-hwcd with a = -1: lanes square X, Y, Z (doubled: C = 2 Z^2) and
// X+Y into A, B, C, S; then E = S-A-B, G = B-A, H = -A-B, F = G-C, each a
// sum of at most three reduced outputs, and lane c multiplies its pair of
// (E F, G H, F G, E H). T is not read.
ED_FN Fe g_dbl(const Fe& v, int c) {
  Fe op;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int32_t x = ED_SHFL(v.v[i], 0), y = ED_SHFL(v.v[i], 1);
    op.v[i] = c == 3 ? x + y : v.v[i];
  }
  const Fe s = fe_sq(op, c == 2);
  Fe op1, op2;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int32_t a = ED_SHFL(s.v[i], 0), b = ED_SHFL(s.v[i], 1),
                  cc = ED_SHFL(s.v[i], 2), ss = ED_SHFL(s.v[i], 3);
    const int32_t e = ss - a - b, g = b - a, h = -a - b, f = g - cc;
    op1.v[i] = c == 1 ? g : (c == 2 ? f : e);           // E, G, F, E
    op2.v[i] = c == 0 ? f : (c == 2 ? g : h);           // F, H, G, H
  }
  return fe_mul(op1, op2);
}

// Limb l of entry e of a table of per-lane rows: tab[(e * 10 + l) * stride].
ED_FN Fe fe_load_row(const int32_t* tab, int e, int stride) {
  Fe r;
#pragma unroll
  for (int l = 0; l < 10; l++) r.v[l] = tab[(e * 10 + l) * stride];
  return r;
}

ED_FN void fe_store_row(int32_t* tab, int e, int stride, const Fe& a) {
#pragma unroll
  for (int l = 0; l < 10; l++) tab[(e * 10 + l) * stride] = a.v[l];
}

// RFC 8032 strict verify of one signature by lane c of its group.
//
// Lanes 0 and 2 decompress A, lanes 1 and 3 R (the same code on their own
// input). Lane c then builds coordinate c of the cached table
// [j](-A), j = 0..15, in its own column of `tab` (tab[(j*10+l)*tab_stride];
// no other lane reads it; row 16 keeps R's coordinate for the compare, out
// of the registers), and runs the 64-window msb-first ladder
// Q = [s]B + [h](-A): four doublings, a mixed addition of [s_w]B read from
// `btab` (btab[l*64 + d*4 + c]: coordinate c of the niels point [d]B) and
// an addition of [h_w](-A). The verdict compares projectively,
// X == x_R Z and Y == y_R Z, so no inversion is needed; R must decompress
// (which rejects a y with no square root and x = 0 with the sign bit, as
// encode(Q) == R does) and its y must be below p (the plain version's
// canonical compare). Every lane returns the group's verdict.
//
// Inputs as the kernel takes them: window w of the signature is
// s_win[w*stride], limb k of A's y is a_y[k*stride]; tight 24-limb values
// below 2^255 and nibbles in 0..15, as ops/ed25519.prepare_batch makes
// them.
ED_FN bool verify_group(int c, const int32_t* s_win, const int32_t* h_win,
                        const int32_t* a_y, int32_t a_sign,
                        const int32_t* r_y, int32_t r_sign, int stride,
                        int32_t* tab, int tab_stride, const int32_t* btab) {
  const bool is_r = (c & 1) != 0;
  const Fe y_in = fe_from_w24(is_r ? r_y : a_y, stride);
  int32_t noncanon = 0;                        // R's y must be below p
  {
    const Fe yc = fe_canon(y_in);
#pragma unroll
    for (int i = 0; i < 10; i++) noncanon |= yc.v[i] ^ y_in.v[i];
  }
  const Fe y = fe_reduce(y_in);
  bool valid;
  const Fe x = fe_decompress(y, (is_r ? r_sign : a_sign) != 0, &valid);
  valid = valid && !(is_r && noncanon != 0);
  const Fe xa = fe_shfl(x, 0), ya = fe_shfl(y, 0);
  // lane 0 keeps x_R, lane 1 y_R for the compare, in the table's row 16
  fe_store_row(tab, 16, tab_stride, fe_sel(c == 0, fe_shfl(x, 1), y));

  // -A = (-x, y, 1, -x y); cached: (y + x, y - x, -2d x y, 2)
  const Fe one = fe_one(), two = fe_small(2), zero = fe_zero();
  const Fe xy = fe_mul(xa, ya);
  const Fe t2d = fe_mul(xy, fe_const(ED_K2D));
  const Fe cached_a = fe_pick4(c, fe_add(ya, xa), fe_sub(ya, xa),
                               fe_neg(t2d), two);
  fe_store_row(tab, 0, tab_stride, fe_pick4(c, one, one, zero, two));
  fe_store_row(tab, 1, tab_stride, cached_a);
  // extended -> cached is one multiply of the addition's first operand:
  // (Y-X) 1, (Y+X) 1, T 2d, Z 2
  const Fe to_cached = fe_pick4(c, one, one, fe_const(ED_K2D), two);
  Fe cur = g_dbl(fe_pick4(c, fe_neg(xa), ya, one, zero), c);   // [2](-A)
  for (int j = 2; j < 15; j++) {
    const Fe op = g_add_operand(cur, c);
    fe_store_row(tab, j, tab_stride, fe_mul(op, to_cached));
    cur = g_finish(fe_mul(op, cached_a), c);
  }
  fe_store_row(tab, 15, tab_stride,
               fe_mul(g_add_operand(cur, c), to_cached));

  Fe acc = fe_pick4(c, zero, one, one, zero);   // the identity
  for (int win = 63; win >= 0; win--) {
    const int sd = s_win[win * stride] & 15;
    const int hd = h_win[win * stride] & 15;
    acc = g_dbl(g_dbl(g_dbl(g_dbl(acc, c), c), c), c);
    Fe base;
#pragma unroll
    for (int l = 0; l < 10; l++) base.v[l] = btab[l * 64 + sd * 4 + c];
    acc = g_add(acc, c, base);
    acc = g_add(acc, c, fe_load_row(tab, hd, tab_stride));
  }

  // lane 0: X - x_R Z, lane 1: Y - y_R Z
  const Fe z = fe_shfl(acc, 2);
  const bool eq = fe_iszero(fe_sub(acc,
                                   fe_mul(fe_load_row(tab, 16, tab_stride),
                                          z)));
  int32_t ok = valid && (c >= 2 || eq);
  ok &= ED_SHFL_XOR(ok, 1);
  ok &= ED_SHFL_XOR(ok, 2);
  return ok != 0;
}
