// BLS12-381 device arithmetic for the aggregation and pairing kernels.
//
//   Fp     6 x 64-bit limbs, Montgomery form (R = 2^384), CIOS multiply
//          through unsigned __int128 products
//   Fp2    c0 + c1 u, u^2 = -1
//   Fp12   the flat sextic Fp2[w]/(w^6 - xi), xi = 1 + u: the tower of the
//          host oracle (crypto/bls12_381.py) and of native/bls12_381.cpp,
//          not the 2-3-2 tower of blst/kilic; multiplication by the
//          even/odd split over Fp6 = Fp2[v]/(v^3 - xi), v = w^2
//   G1/G2  Jacobian; add and double are the JAX package's formulas
//          (tendermint_tpu/ops/bls_g1.py g1_add/g1_double: add-2007-bl,
//          dbl-2009-l) with its masks and identity (0, 1, 0), so a tree of
//          them reproduces its canonical Jacobian result
//   Miller doubling and addition steps with lines scaled by 2 Y Z^3 and
//          Z lambda (tendermint_tpu/ops/bls_pairing.py _dbl_step/_add_step)
//
// The Fp2/Fp12 code follows native/bls12_381.cpp, the repo's C++ version of
// the same construction. Inversion is Fermat (a^(p-2)), which is constant
// time and maps 0 to 0 as the plain versions do.
//
// Values cross the boundary as canonical little-endian bytes: 48 per Fp
// element; any 48-byte input is read mod p. Built by nvcc for sm_90a; the
// code is plain C++ over stdint types, so g++ builds it too with the CUDA
// qualifiers defined away (how the kernels are checked without a card).
#pragma once

#include <stdint.h>

namespace bdev {

typedef unsigned __int128 u128;

struct fp {
  uint64_t l[6];
};
struct fp2 {
  fp c0, c1;
};
struct fp12 {
  fp2 c[6];
};

__constant__ uint64_t FP_P[6] = {
    0xb9feffffffffaaabull, 0x1eabfffeb153ffffull, 0x6730d2a0f6b0f624ull,
    0x64774b84f38512bfull, 0x4b1ba7b6434bacd7ull, 0x1a0111ea397fe69aull};
__constant__ uint64_t FP_R2[6] = {
    0xf4df1f341c341746ull, 0x0a76e6a609d104f1ull, 0x8de5476c4c95b6d5ull,
    0x67eb88a9939d83c0ull, 0x9a793e85b519952dull, 0x11988fe592cae3aaull};
__constant__ uint64_t FP_ONE_MONT[6] = {
    0x760900000002fffdull, 0xebf4000bc40c0002ull, 0x5f48985753c758baull,
    0x77ce585370525745ull, 0x5c071a97a256ec6dull, 0x15f65ec3fa80e493ull};
__constant__ uint64_t FP_P_MINUS_2[6] = {
    0xb9feffffffffaaa9ull, 0x1eabfffeb153ffffull, 0x6730d2a0f6b0f624ull,
    0x64774b84f38512bfull, 0x4b1ba7b6434bacd7ull, 0x1a0111ea397fe69aull};
static constexpr uint64_t FP_N0 = 0x89f3fffcfffcfffdull;  // -p^-1 mod 2^64
static constexpr uint64_t X_ABS = 0xD201000000010000ull;  // |x|, x < 0

// gamma_i = xi^(i (p - 1) / 6), plain (not Montgomery) limbs, from the
// host oracle's table (crypto/bls12_381.py _GAMMA); fp12_gamma converts.
__constant__ uint64_t GAMMA_RAW[6][2][6] = {
    {{0x0000000000000001ull, 0, 0, 0, 0, 0}, {0, 0, 0, 0, 0, 0}},
    {{0x8d0775ed92235fb8ull, 0xf67ea53d63e7813dull, 0x7b2443d784bab9c4ull,
      0x0fd603fd3cbd5f4full, 0xc231beb4202c0d1full, 0x1904d3bf02bb0667ull},
     {0x2cf78a126ddc4af3ull, 0x282d5ac14d6c7ec2ull, 0xec0c8ec971f63c5full,
      0x54a14787b6c7b36full, 0x88e9e902231f9fb8ull, 0x00fc3e2b36c4e032ull}},
    {{0, 0, 0, 0, 0, 0},
     {0x8bfd00000000aaacull, 0x409427eb4f49fffdull, 0x897d29650fb85f9bull,
      0xaa0d857d89759ad4ull, 0xec02408663d4de85ull, 0x1a0111ea397fe699ull}},
    {{0xc81084fbede3cc09ull, 0xee67992f72ec05f4ull, 0x77f76e17009241c5ull,
      0x48395dabc2d3435eull, 0x6831e36d6bd17ffeull, 0x06af0e0437ff400bull},
     {0xc81084fbede3cc09ull, 0xee67992f72ec05f4ull, 0x77f76e17009241c5ull,
      0x48395dabc2d3435eull, 0x6831e36d6bd17ffeull, 0x06af0e0437ff400bull}},
    {{0x8bfd00000000aaadull, 0x409427eb4f49fffdull, 0x897d29650fb85f9bull,
      0xaa0d857d89759ad4ull, 0xec02408663d4de85ull, 0x1a0111ea397fe699ull},
     {0, 0, 0, 0, 0, 0}},
    {{0x9b18fae980078116ull, 0xc63a3e6e257f8732ull, 0x8beadf4d8e9c0566ull,
      0xf39816240c0b8feeull, 0xdf47fa6b48b1e045ull, 0x05b2cfd9013a5fd8ull},
     {0x1ee605167ff82995ull, 0x5871c1908bd478cdull, 0xdb45f3536814f0bdull,
      0x70df3560e77982d0ull, 0x6bd3ad4afa99cc91ull, 0x144e4211384586c1ull}},
};

// --- Fp -------------------------------------------------------------------

__device__ __forceinline__ void fp_set(fp& o, const uint64_t* v) {
  for (int i = 0; i < 6; i++) o.l[i] = v[i];
}

__device__ __forceinline__ void fp_zero(fp& o) {
  for (int i = 0; i < 6; i++) o.l[i] = 0;
}

__device__ __forceinline__ bool fp_is_zero(const fp& a) {
  uint64_t z = 0;
  for (int i = 0; i < 6; i++) z |= a.l[i];
  return z == 0;
}

__device__ __forceinline__ bool fp_geq_p(const fp& a) {
  for (int i = 5; i >= 0; i--) {
    if (a.l[i] > FP_P[i]) return true;
    if (a.l[i] < FP_P[i]) return false;
  }
  return true;
}

__device__ __forceinline__ uint64_t fp_add_raw(fp& o, const fp& a, const fp& b) {
  u128 c = 0;
  for (int i = 0; i < 6; i++) {
    c += (u128)a.l[i] + b.l[i];
    o.l[i] = (uint64_t)c;
    c >>= 64;
  }
  return (uint64_t)c;
}

__device__ __forceinline__ void fp_sub_p(fp& o) {
  u128 brw = 0;
  for (int i = 0; i < 6; i++) {
    u128 d = (u128)o.l[i] - FP_P[i] - brw;
    o.l[i] = (uint64_t)d;
    brw = (d >> 64) & 1;
  }
}

__device__ __forceinline__ void fp_add(fp& o, const fp& a, const fp& b) {
  uint64_t carry = fp_add_raw(o, a, b);
  if (carry || fp_geq_p(o)) fp_sub_p(o);
}

__device__ __forceinline__ void fp_sub(fp& o, const fp& a, const fp& b) {
  u128 brw = 0;
  for (int i = 0; i < 6; i++) {
    u128 d = (u128)a.l[i] - b.l[i] - brw;
    o.l[i] = (uint64_t)d;
    brw = (d >> 64) & 1;
  }
  if (brw) {
    u128 c = 0;
    for (int i = 0; i < 6; i++) {
      c += (u128)o.l[i] + FP_P[i];
      o.l[i] = (uint64_t)c;
      c >>= 64;
    }
  }
}

__device__ __forceinline__ void fp_neg(fp& o, const fp& a) {
  fp z;
  fp_zero(z);
  fp_sub(o, z, a);
}

// Montgomery CIOS: o = a b R^-1 mod p, for a < 2^384 and b < p (o < p)
__device__ __noinline__ void fp_mul(fp& o, const fp& a, const fp& b) {
  uint64_t t[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 6; i++) {
    u128 c = 0;
    for (int j = 0; j < 6; j++) {
      c += (u128)t[j] + (u128)a.l[j] * b.l[i];
      t[j] = (uint64_t)c;
      c >>= 64;
    }
    c += t[6];
    t[6] = (uint64_t)c;
    t[7] = (uint64_t)(c >> 64);
    uint64_t m = t[0] * FP_N0;
    c = (u128)t[0] + (u128)m * FP_P[0];
    c >>= 64;
    for (int j = 1; j < 6; j++) {
      c += (u128)t[j] + (u128)m * FP_P[j];
      t[j - 1] = (uint64_t)c;
      c >>= 64;
    }
    c += t[6];
    t[5] = (uint64_t)c;
    t[6] = t[7] + (uint64_t)(c >> 64);
  }
  fp r;
  for (int i = 0; i < 6; i++) r.l[i] = t[i];
  if (t[6] || fp_geq_p(r)) fp_sub_p(r);
  o = r;
}

__device__ __forceinline__ void fp_sqr(fp& o, const fp& a) { fp_mul(o, a, a); }

__device__ __forceinline__ void fp_one(fp& o) { fp_set(o, FP_ONE_MONT); }

// a^(p-2): the inverse for a != 0, and 0 for 0
__device__ __noinline__ void fp_inv(fp& o, const fp& a) {
  fp r;
  fp_one(r);
  for (int i = 380; i >= 0; i--) {
    fp_sqr(r, r);
    if ((FP_P_MINUS_2[i >> 6] >> (i & 63)) & 1) fp_mul(r, r, a);
  }
  o = r;
}

// 48 little-endian bytes (any value < 2^384) -> Montgomery form mod p
__device__ __forceinline__ void fp_load(fp& o, const uint8_t* b) {
  fp n;
  for (int i = 0; i < 6; i++) {
    uint64_t v = 0;
    for (int j = 7; j >= 0; j--) v = (v << 8) | b[8 * i + j];
    n.l[i] = v;
  }
  fp r2;
  fp_set(r2, FP_R2);
  fp_mul(o, n, r2);
}

// Montgomery -> canonical 48 little-endian bytes
__device__ __forceinline__ void fp_store(uint8_t* b, const fp& a) {
  fp one, n;
  fp_zero(one);
  one.l[0] = 1;
  fp_mul(n, a, one);
  for (int i = 0; i < 6; i++) {
    uint64_t v = n.l[i];
    for (int j = 0; j < 8; j++) {
      b[8 * i + j] = (uint8_t)v;
      v >>= 8;
    }
  }
}

// --- Fp2 ------------------------------------------------------------------

__device__ __forceinline__ bool f2_is_zero(const fp2& a) {
  return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}

__device__ __forceinline__ void f2_add(fp2& o, const fp2& a, const fp2& b) {
  fp_add(o.c0, a.c0, b.c0);
  fp_add(o.c1, a.c1, b.c1);
}

__device__ __forceinline__ void f2_sub(fp2& o, const fp2& a, const fp2& b) {
  fp_sub(o.c0, a.c0, b.c0);
  fp_sub(o.c1, a.c1, b.c1);
}

__device__ __forceinline__ void f2_neg(fp2& o, const fp2& a) {
  fp_neg(o.c0, a.c0);
  fp_neg(o.c1, a.c1);
}

__device__ __forceinline__ void f2_conj(fp2& o, const fp2& a) {
  o.c0 = a.c0;
  fp_neg(o.c1, a.c1);
}

// Karatsuba: 3 Fp multiplications
__device__ __noinline__ void f2_mul(fp2& o, const fp2& a, const fp2& b) {
  fp t0, t1, s0, s1, m;
  fp_mul(t0, a.c0, b.c0);
  fp_mul(t1, a.c1, b.c1);
  fp_add(s0, a.c0, a.c1);
  fp_add(s1, b.c0, b.c1);
  fp_mul(m, s0, s1);
  fp_sub(o.c1, m, t0);
  fp_sub(o.c1, o.c1, t1);
  fp_sub(o.c0, t0, t1);
}

// (a0 + a1)(a0 - a1), 2 a0 a1
__device__ __noinline__ void f2_sqr(fp2& o, const fp2& a) {
  fp s, d, m;
  fp_add(s, a.c0, a.c1);
  fp_sub(d, a.c0, a.c1);
  fp_mul(m, a.c0, a.c1);
  fp_mul(o.c0, s, d);
  fp_add(o.c1, m, m);
}

// o = a (1 + u)
__device__ __forceinline__ void f2_mul_xi(fp2& o, const fp2& a) {
  fp t0, t1;
  fp_sub(t0, a.c0, a.c1);
  fp_add(t1, a.c0, a.c1);
  o.c0 = t0;
  o.c1 = t1;
}

__device__ __forceinline__ void f2_scale(fp2& o, const fp2& a, const fp& k) {
  fp_mul(o.c0, a.c0, k);
  fp_mul(o.c1, a.c1, k);
}

__device__ __noinline__ void f2_inv(fp2& o, const fp2& a) {
  fp t0, t1, t;
  fp_sqr(t0, a.c0);
  fp_sqr(t1, a.c1);
  fp_add(t, t0, t1);
  fp_inv(t, t);
  fp_mul(o.c0, a.c0, t);
  fp_mul(t, a.c1, t);
  fp_neg(o.c1, t);
}

__device__ __forceinline__ void f2_load(fp2& o, const uint8_t* b) {
  fp_load(o.c0, b);
  fp_load(o.c1, b + 48);
}

__device__ __forceinline__ void f2_store(uint8_t* b, const fp2& a) {
  fp_store(b, a.c0);
  fp_store(b + 48, a.c1);
}

// --- Fp12 = Fp2[w]/(w^6 - xi) ---------------------------------------------

__device__ __forceinline__ void f12_one(fp12& o) {
  for (int i = 0; i < 6; i++) {
    fp_zero(o.c[i].c0);
    fp_zero(o.c[i].c1);
  }
  fp_one(o.c[0].c0);
}

__device__ __forceinline__ void f12_load(fp12& o, const uint8_t* b) {
  for (int i = 0; i < 6; i++) f2_load(o.c[i], b + 96 * i);
}

__device__ __forceinline__ void f12_store(uint8_t* b, const fp12& a) {
  for (int i = 0; i < 6; i++) f2_store(b + 96 * i, a.c[i]);
}

// Fp6 = Fp2[v]/(v^3 - xi)
__device__ __noinline__ void f6_mul(fp2* o, const fp2* a, const fp2* b) {
  fp2 t0, t1, t2, s, u, w, x2;
  f2_mul(t0, a[0], b[0]);
  f2_mul(t1, a[1], b[1]);
  f2_mul(t2, a[2], b[2]);
  // c0 = t0 + xi ((a1 + a2)(b1 + b2) - t1 - t2)
  f2_add(s, a[1], a[2]);
  f2_add(u, b[1], b[2]);
  f2_mul(w, s, u);
  f2_sub(w, w, t1);
  f2_sub(w, w, t2);
  f2_mul_xi(w, w);
  fp2 c0;
  f2_add(c0, t0, w);
  // c1 = (a0 + a1)(b0 + b1) - t0 - t1 + xi t2
  f2_add(s, a[0], a[1]);
  f2_add(u, b[0], b[1]);
  f2_mul(w, s, u);
  f2_sub(w, w, t0);
  f2_sub(w, w, t1);
  f2_mul_xi(x2, t2);
  fp2 c1;
  f2_add(c1, w, x2);
  // c2 = (a0 + a2)(b0 + b2) - t0 - t2 + t1
  f2_add(s, a[0], a[2]);
  f2_add(u, b[0], b[2]);
  f2_mul(w, s, u);
  f2_sub(w, w, t0);
  f2_sub(w, w, t2);
  f2_add(o[2], w, t1);
  o[0] = c0;
  o[1] = c1;
}

// v (a0 + a1 v + a2 v^2) = xi a2 + a0 v + a1 v^2
__device__ __forceinline__ void f6_mul_by_v(fp2* o, const fp2* a) {
  fp2 t;
  f2_mul_xi(t, a[2]);
  fp2 a0 = a[0], a1 = a[1];
  o[0] = t;
  o[1] = a0;
  o[2] = a1;
}

// a b = (Ea Eb + v Oa Ob) + w ((Ea + Oa)(Eb + Ob) - Ea Eb - Oa Ob)
__device__ __noinline__ void f12_mul(fp12& o, const fp12& a, const fp12& b) {
  fp2 Ea[3] = {a.c[0], a.c[2], a.c[4]};
  fp2 Oa[3] = {a.c[1], a.c[3], a.c[5]};
  fp2 Eb[3] = {b.c[0], b.c[2], b.c[4]};
  fp2 Ob[3] = {b.c[1], b.c[3], b.c[5]};
  fp2 EE[3], OO[3], sa[3], sb[3], m[3], vOO[3];
  f6_mul(EE, Ea, Eb);
  f6_mul(OO, Oa, Ob);
  for (int i = 0; i < 3; i++) {
    f2_add(sa[i], Ea[i], Oa[i]);
    f2_add(sb[i], Eb[i], Ob[i]);
  }
  f6_mul(m, sa, sb);
  f6_mul_by_v(vOO, OO);
  for (int i = 0; i < 3; i++) {
    fp2 even, odd;
    f2_add(even, EE[i], vOO[i]);
    f2_sub(odd, m[i], EE[i]);
    f2_sub(odd, odd, OO[i]);
    o.c[2 * i] = even;
    o.c[2 * i + 1] = odd;
  }
}

// a^2 = (E^2 + v O^2) + w (2 E O), with t = (E + O)(E + v O):
// E^2 + v O^2 = t - EO - v EO
__device__ __noinline__ void f12_sqr(fp12& o, const fp12& a) {
  fp2 E[3] = {a.c[0], a.c[2], a.c[4]};
  fp2 O[3] = {a.c[1], a.c[3], a.c[5]};
  fp2 EO[3], vO[3], s1[3], s2[3], t[3], vEO[3];
  f6_mul(EO, E, O);
  f6_mul_by_v(vO, O);
  for (int i = 0; i < 3; i++) {
    f2_add(s1[i], E[i], O[i]);
    f2_add(s2[i], E[i], vO[i]);
  }
  f6_mul(t, s1, s2);
  f6_mul_by_v(vEO, EO);
  for (int i = 0; i < 3; i++) {
    fp2 even, odd;
    f2_sub(even, t[i], EO[i]);
    f2_sub(even, even, vEO[i]);
    f2_add(odd, EO[i], EO[i]);
    o.c[2 * i] = even;
    o.c[2 * i + 1] = odd;
  }
}

// o = a (l0 + l2 w^2 + l3 w^3): 18 Fp2 multiplications
__device__ __noinline__ void f12_mul_line(fp12& o, const fp12& a, const fp2& l0,
                                          const fp2& l2, const fp2& l3) {
  fp2 acc[11];
  for (int k = 0; k < 11; k++) {
    fp_zero(acc[k].c0);
    fp_zero(acc[k].c1);
  }
  for (int i = 0; i < 6; i++) {
    fp2 m;
    f2_mul(m, a.c[i], l0);
    f2_add(acc[i], acc[i], m);
    f2_mul(m, a.c[i], l2);
    f2_add(acc[i + 2], acc[i + 2], m);
    f2_mul(m, a.c[i], l3);
    f2_add(acc[i + 3], acc[i + 3], m);
  }
  for (int k = 0; k < 6; k++) {
    if (k + 6 <= 10) {
      fp2 hx;
      f2_mul_xi(hx, acc[k + 6]);
      f2_add(acc[k], acc[k], hx);
    }
    o.c[k] = acc[k];
  }
}

// w -> -w (frobenius^6)
__device__ __forceinline__ void f12_conj(fp12& o, const fp12& a) {
  for (int i = 0; i < 6; i++) {
    if (i & 1)
      f2_neg(o.c[i], a.c[i]);
    else
      o.c[i] = a.c[i];
  }
}

__device__ __forceinline__ void fp12_gamma(fp2* g) {
  for (int i = 0; i < 6; i++) {
    fp c0, c1;
    fp_set(c0, GAMMA_RAW[i][0]);
    fp_set(c1, GAMMA_RAW[i][1]);
    fp r2;
    fp_set(r2, FP_R2);
    fp_mul(g[i].c0, c0, r2);
    fp_mul(g[i].c1, c1, r2);
  }
}

// a^p: conjugate each Fp2 coefficient, twist by gamma_i
__device__ __noinline__ void f12_frob(fp12& o, const fp12& a, const fp2* gamma) {
  for (int i = 0; i < 6; i++) {
    fp2 cj;
    f2_conj(cj, a.c[i]);
    f2_mul(o.c[i], cj, gamma[i]);
  }
}

__device__ __noinline__ void f6_inv(fp2* o, const fp2* a) {
  fp2 c0, c1, c2, t, s, ti;
  f2_sqr(c0, a[0]);
  f2_mul(t, a[1], a[2]);
  f2_mul_xi(t, t);
  f2_sub(c0, c0, t);
  f2_sqr(c1, a[2]);
  f2_mul_xi(c1, c1);
  f2_mul(t, a[0], a[1]);
  f2_sub(c1, c1, t);
  f2_sqr(c2, a[1]);
  f2_mul(t, a[0], a[2]);
  f2_sub(c2, c2, t);
  // t = a0 c0 + xi (a1 c2 + a2 c1)
  f2_mul(t, a[1], c2);
  f2_mul(s, a[2], c1);
  f2_add(t, t, s);
  f2_mul_xi(t, t);
  f2_mul(s, a[0], c0);
  f2_add(t, t, s);
  f2_inv(ti, t);
  f2_mul(o[0], c0, ti);
  f2_mul(o[1], c1, ti);
  f2_mul(o[2], c2, ti);
}

// a^-1 through the even subalgebra: a conj(a) has only even w powers
__device__ __noinline__ void f12_inv(fp12& o, const fp12& a) {
  fp12 ac, n, n12;
  f12_conj(ac, a);
  f12_mul(n, a, ac);
  fp2 n6[3] = {n.c[0], n.c[2], n.c[4]};
  fp2 n6i[3];
  f6_inv(n6i, n6);
  for (int i = 0; i < 6; i++) {
    fp_zero(n12.c[i].c0);
    fp_zero(n12.c[i].c1);
  }
  n12.c[0] = n6i[0];
  n12.c[2] = n6i[1];
  n12.c[4] = n6i[2];
  f12_mul(o, ac, n12);
}

// (a + b z)^2 = (a^2 + xi b^2) + 2ab z over Fp4 = Fp2[z]/(z^2 - xi)
__device__ __forceinline__ void f4_sqr(fp2& o0, fp2& o1, const fp2& a, const fp2& b) {
  fp2 t0, t1, s;
  f2_sqr(t0, a);
  f2_sqr(t1, b);
  f2_add(s, a, b);
  f2_sqr(o1, s);
  f2_sub(o1, o1, t0);
  f2_sub(o1, o1, t1);
  f2_mul_xi(s, t1);
  f2_add(o0, t0, s);
}

// h_re = 3 t_re - 2 a_re; h_im = 3 t_im + 2 a_im
__device__ __forceinline__ void gs_comb(fp2& hre, fp2& him, const fp2& tre,
                                        const fp2& tim, const fp2& are,
                                        const fp2& aim) {
  fp2 u;
  f2_sub(u, tre, are);
  f2_add(u, u, u);
  f2_add(hre, u, tre);
  f2_add(u, tim, aim);
  f2_add(u, u, u);
  f2_add(him, u, tim);
}

// Granger-Scott squaring; valid in the cyclotomic subgroup only
__device__ __noinline__ void f12_cyclo_sqr(fp12& o, const fp12& a) {
  fp2 A0, A1, B0, B1, C0, C1;
  f4_sqr(A0, A1, a.c[0], a.c[3]);
  f4_sqr(B0, B1, a.c[1], a.c[4]);
  f4_sqr(C0, C1, a.c[2], a.c[5]);
  fp2 c1 = a.c[1], c4 = a.c[4];
  gs_comb(o.c[0], o.c[3], A0, A1, a.c[0], a.c[3]);
  gs_comb(o.c[2], o.c[5], B0, B1, a.c[2], a.c[5]);
  fp2 re, u;
  f2_mul_xi(re, C1);
  f2_add(u, re, c1);
  f2_add(u, u, u);
  f2_add(o.c[1], u, re);
  f2_sub(u, C0, c4);
  f2_add(u, u, u);
  f2_add(o.c[4], u, C0);
}

// a^x for the negative BLS parameter, a in the cyclotomic subgroup
// (conj is the inverse there)
__device__ __noinline__ void f12_exp_x_signed(fp12& o, const fp12& a) {
  fp12 r;
  f12_one(r);
  for (int i = 63; i >= 0; i--) {
    f12_cyclo_sqr(r, r);
    if ((X_ABS >> i) & 1) f12_mul(r, r, a);
  }
  f12_conj(o, r);
}

// f^((p^12 - 1)/r * 3): easy part, then the hard part's chain
// (x-1)^2 (x+p) (x^2+p^2-1) + 3 (tendermint_tpu/ops/bls_pairing.py)
__device__ __noinline__ void final_exponentiation(fp12& o, const fp12& f_in,
                                                  const fp2* gamma) {
  fp12 f, t, u;
  f12_conj(t, f_in);
  f12_inv(u, f_in);
  f12_mul(f, t, u);
  f12_frob(t, f, gamma);
  f12_frob(t, t, gamma);
  f12_mul(f, t, f);
  fp12 a, b, c;
  f12_exp_x_signed(a, f);
  f12_conj(t, f);
  f12_mul(a, a, t);
  f12_exp_x_signed(t, a);
  f12_conj(u, a);
  f12_mul(a, t, u);
  f12_exp_x_signed(b, a);
  f12_frob(t, a, gamma);
  f12_mul(b, b, t);
  f12_exp_x_signed(t, b);
  f12_exp_x_signed(c, t);
  f12_frob(t, b, gamma);
  f12_frob(t, t, gamma);
  f12_mul(c, c, t);
  f12_conj(t, b);
  f12_mul(c, c, t);
  f12_cyclo_sqr(t, f);
  f12_mul(t, t, f);
  f12_mul(o, c, t);
}

// --- Miller steps ---------------------------------------------------------

// line scaled by 2 Y Z^3, and T <- 2T
__device__ __noinline__ void miller_dbl_step(fp2& l0, fp2& l2, fp2& l3, fp2& X,
                                             fp2& Y, fp2& Z, const fp& xp,
                                             const fp& yp) {
  fp2 A, B, C, D, E, F, Zsq, Z3, t;
  f2_sqr(A, X);
  f2_sqr(B, Y);
  f2_sqr(C, B);
  f2_add(t, X, B);
  f2_sqr(t, t);
  f2_sub(t, t, A);
  f2_sub(t, t, C);
  f2_add(D, t, t);
  f2_add(E, A, A);
  f2_add(E, E, A);
  f2_sqr(F, E);
  f2_sqr(Zsq, Z);
  f2_mul(l0, E, X);
  f2_sub(l0, l0, B);
  f2_sub(l0, l0, B);
  f2_mul(t, E, Zsq);
  f2_scale(t, t, xp);
  f2_neg(l2, t);
  f2_mul(Z3, Y, Z);
  f2_add(Z3, Z3, Z3);
  f2_mul(t, Z3, Zsq);
  f2_scale(l3, t, yp);
  f2_sub(X, F, D);
  f2_sub(X, X, D);
  f2_sub(t, D, X);
  f2_mul(Y, E, t);
  f2_add(C, C, C);
  f2_add(C, C, C);
  f2_add(C, C, C);
  f2_sub(Y, Y, C);
  Z = Z3;
}

// line through T and Q (affine) scaled by Z lambda, and T <- T + Q
__device__ __noinline__ void miller_add_step(fp2& l0, fp2& l2, fp2& l3, fp2& X,
                                             fp2& Y, fp2& Z, const fp2& xq,
                                             const fp2& yq, const fp& xp,
                                             const fp& yp) {
  fp2 Zsq, Zcu, theta, lam, Zlam, t;
  f2_sqr(Zsq, Z);
  f2_mul(Zcu, Zsq, Z);
  f2_mul(t, yq, Zcu);
  f2_sub(theta, Y, t);
  f2_mul(t, xq, Zsq);
  f2_sub(lam, X, t);
  f2_mul(Zlam, Z, lam);
  f2_mul(l0, theta, xq);
  f2_mul(t, Zlam, yq);
  f2_sub(l0, l0, t);
  f2_scale(t, theta, xp);
  f2_neg(l2, t);
  f2_scale(l3, Zlam, yp);
  fp2 h, hh, i, j, r, v, X3, Y3, Z3;
  f2_neg(h, lam);
  f2_sqr(hh, h);
  f2_add(i, hh, hh);
  f2_add(i, i, i);
  f2_mul(j, h, i);
  f2_neg(r, theta);
  f2_add(r, r, r);
  f2_mul(v, X, i);
  f2_sqr(X3, r);
  f2_sub(X3, X3, j);
  f2_sub(X3, X3, v);
  f2_sub(X3, X3, v);
  f2_sub(t, v, X3);
  f2_mul(Y3, r, t);
  f2_mul(t, Y, j);
  f2_add(t, t, t);
  f2_sub(Y3, Y3, t);
  f2_mul(Z3, Z, h);
  f2_add(Z3, Z3, Z3);
  X = X3;
  Y = Y3;
  Z = Z3;
}

// --- Jacobian G1 (over fp) and G2 (over fp2) ------------------------------

__device__ __forceinline__ void fe_add(fp& o, const fp& a, const fp& b) { fp_add(o, a, b); }
__device__ __forceinline__ void fe_add(fp2& o, const fp2& a, const fp2& b) { f2_add(o, a, b); }
__device__ __forceinline__ void fe_sub(fp& o, const fp& a, const fp& b) { fp_sub(o, a, b); }
__device__ __forceinline__ void fe_sub(fp2& o, const fp2& a, const fp2& b) { f2_sub(o, a, b); }
__device__ __forceinline__ void fe_mul(fp& o, const fp& a, const fp& b) { fp_mul(o, a, b); }
__device__ __forceinline__ void fe_mul(fp2& o, const fp2& a, const fp2& b) { f2_mul(o, a, b); }
__device__ __forceinline__ void fe_sqr(fp& o, const fp& a) { fp_sqr(o, a); }
__device__ __forceinline__ void fe_sqr(fp2& o, const fp2& a) { f2_sqr(o, a); }
__device__ __forceinline__ bool fe_is_zero(const fp& a) { return fp_is_zero(a); }
__device__ __forceinline__ bool fe_is_zero(const fp2& a) { return f2_is_zero(a); }
__device__ __forceinline__ void fe_zero(fp& o) { fp_zero(o); }
__device__ __forceinline__ void fe_zero(fp2& o) {
  fp_zero(o.c0);
  fp_zero(o.c1);
}
__device__ __forceinline__ void fe_one(fp& o) { fp_one(o); }
__device__ __forceinline__ void fe_one(fp2& o) {
  fp_one(o.c0);
  fp_zero(o.c1);
}
__device__ __forceinline__ void fe_load(fp& o, const uint8_t* b) { fp_load(o, b); }
__device__ __forceinline__ void fe_load(fp2& o, const uint8_t* b) { f2_load(o, b); }
__device__ __forceinline__ void fe_store(uint8_t* b, const fp& a) { fp_store(b, a); }
__device__ __forceinline__ void fe_store(uint8_t* b, const fp2& a) { f2_store(b, a); }

template <class F>
struct jac {
  F x, y, z;
};

// the JAX package's identity, (0, 1, 0)
template <class F>
__device__ __forceinline__ void jac_identity(jac<F>& o) {
  fe_zero(o.x);
  fe_one(o.y);
  fe_zero(o.z);
}

template <class F>
__device__ __noinline__ void jac_double(jac<F>& o, const jac<F>& p) {
  if (fe_is_zero(p.y) || fe_is_zero(p.z)) {
    jac_identity(o);
    return;
  }
  F a, b, c, d, e, f, t, x3, y3, z3;
  fe_sqr(a, p.x);
  fe_sqr(b, p.y);
  fe_sqr(c, b);
  fe_add(t, p.x, b);
  fe_sqr(t, t);
  fe_sub(t, t, a);
  fe_sub(t, t, c);
  fe_add(d, t, t);
  fe_add(e, a, a);
  fe_add(e, e, a);
  fe_sqr(f, e);
  fe_sub(x3, f, d);
  fe_sub(x3, x3, d);
  fe_sub(t, d, x3);
  fe_mul(y3, e, t);
  fe_add(c, c, c);
  fe_add(c, c, c);
  fe_add(c, c, c);
  fe_sub(y3, y3, c);
  fe_mul(z3, p.y, p.z);
  fe_add(z3, z3, z3);
  o.x = x3;
  o.y = y3;
  o.z = z3;
}

// p + q; precedence as the JAX masks: p at infinity -> q, q at infinity
// -> p, equal -> 2p, opposite -> identity
template <class F>
__device__ __noinline__ void jac_add(jac<F>& o, const jac<F>& p, const jac<F>& q) {
  if (fe_is_zero(p.z)) {
    o = q;
    return;
  }
  if (fe_is_zero(q.z)) {
    o = p;
    return;
  }
  F z1z1, z2z2, u1, u2, s1, s2, t;
  fe_sqr(z1z1, p.z);
  fe_sqr(z2z2, q.z);
  fe_mul(u1, p.x, z2z2);
  fe_mul(u2, q.x, z1z1);
  fe_mul(s1, p.y, q.z);
  fe_mul(s1, s1, z2z2);
  fe_mul(s2, q.y, p.z);
  fe_mul(s2, s2, z1z1);
  F h, r;
  fe_sub(h, u2, u1);
  fe_sub(r, s2, s1);
  if (fe_is_zero(h)) {
    if (fe_is_zero(r))
      jac_double(o, p);
    else
      jac_identity(o);
    return;
  }
  F i, j, v, x3, y3, z3;
  fe_add(t, h, h);
  fe_sqr(i, t);
  fe_mul(j, h, i);
  fe_add(r, r, r);
  fe_mul(v, u1, i);
  fe_sqr(x3, r);
  fe_sub(x3, x3, j);
  fe_sub(x3, x3, v);
  fe_sub(x3, x3, v);
  fe_sub(t, v, x3);
  fe_mul(y3, r, t);
  fe_mul(t, s1, j);
  fe_add(t, t, t);
  fe_sub(y3, y3, t);
  fe_add(z3, p.z, q.z);
  fe_sqr(z3, z3);
  fe_sub(z3, z3, z1z1);
  fe_sub(z3, z3, z2z2);
  fe_mul(z3, z3, h);
  o.x = x3;
  o.y = y3;
  o.z = z3;
}

}  // namespace bdev
