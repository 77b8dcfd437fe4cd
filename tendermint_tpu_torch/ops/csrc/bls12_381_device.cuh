// BLS12-381 device arithmetic for the aggregation and pairing kernels.
//
//   Fp     6 x 64-bit limbs, Montgomery form (R = 2^384), CIOS multiply
//          through unsigned __int128 products (the one-thread reference
//          of the pairing and the G1 and G2 sums)
//   fq     the warp kernels' Fp: 12 x 32-bit limbs, the same Montgomery
//          form (R = 2^384), so a value is the same integer in both; CIOS
//          over 32 x 32 -> 64-bit products, the products nvcc issues as
//          IMAD.WIDE.U32 (Hopper has no 64-bit multiply), in registers
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
// the same construction. The one-thread inversion is Fermat (a^(p-2)),
// constant time; the warp kernels' fq_inv is a binary extended Euclid with
// the same value. Both map 0 to 0, as the plain versions do.
//
// The pairing kernels and the G2 sums run on a warp, the G1 sums on groups
// of lanes of a warp (the end of this file): their Fp12 operations and
// point additions are stage programs (bls12_381_programs.cuh, generated by
// ops/bls_warp_gen.py from these one-thread formulas) that run_program
// interprets, a stage of independent fq products or additions at a time,
// two jobs a lane, over Fp values in shared memory.
//
// Values cross the boundary as canonical little-endian bytes: 48 per Fp
// element; any 48-byte input is read mod p. Built by nvcc for sm_90a; the
// code is plain C++ over stdint types, so g++ builds it too: the CPU tests
// run the warp functions through a host harness,
// tests/bls_pairing_host.cpp. Outside nvcc the device qualifiers below
// become plain (inline) C++.
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifndef __CUDACC__
#define __device__ inline
#define __forceinline__
#define __noinline__
#define __constant__ static
#endif

#include "bls12_381_programs.cuh"

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

// --- the warp-wide pairing: fq and the stage programs ----------------------
//
// tm_miller gives one warp to a chunk of two pairs and tm_final_exp one warp
// to an element. Their Fp12 arithmetic is the one-thread formulas above,
// unrolled into stage programs (bls12_381_programs.cuh): a stage is up to 64
// independent jobs of one kind, Fp products, or additions, subtractions and
// selects, or the one inversion; lane l runs jobs l and l + 32, and the lanes
// meet at the warp's sync between stages. The operands live in slots of
// shared memory, one fq each; no stage reads a slot that another lane of it
// writes (the generator's rule, which the CPU harness checks), so the order
// of the lanes inside a stage cannot change a value, and every value is the
// exact field element the one-thread code computes, in canonical limbs.
// The doubling and addition steps of the two pairs do not depend on f, so
// their products share stages with f's squaring.
//
// W is the warp: W::kLanes (32), w.lane, w.ld(slot), w.st(slot, v),
// w.sync(). On the card it is shared memory and __syncwarp (bls_kernels.cu);
// in the CPU harness, 32 host threads in lock-step that check each stage's
// slot accesses. The G1 sums run the same way on groups of fewer lanes.

struct alignas(16) fq {
  uint32_t l[12];
};

static constexpr uint32_t FQ_N0 = 0xfffcfffdu;  // -p^-1 mod 2^32

// the 32-bit limbs of p, as immediates once a loop is unrolled
__device__ __forceinline__ uint32_t fq_p(int i) {
  switch (i) {
    case 0: return 0xffffaaabu;
    case 1: return 0xb9feffffu;
    case 2: return 0xb153ffffu;
    case 3: return 0x1eabfffeu;
    case 4: return 0xf6b0f624u;
    case 5: return 0x6730d2a0u;
    case 6: return 0xf38512bfu;
    case 7: return 0x64774b84u;
    case 8: return 0x434bacd7u;
    case 9: return 0x4b1ba7b6u;
    case 10: return 0x397fe69au;
    default: return 0x1a0111eau;
  }
}

// r + top 2^384 < 2p -> the representative in [0, p)
__device__ __forceinline__ void fq_reduce_once(fq& r, uint32_t top) {
  uint32_t d[12];
  uint32_t brw = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) {
    const uint64_t x = (uint64_t)r.l[i] - fq_p(i) - brw;
    d[i] = (uint32_t)x;
    brw = (uint32_t)(x >> 63);
  }
  const bool take = top != 0 || brw == 0;
#pragma unroll
  for (int i = 0; i < 12; i++) r.l[i] = take ? d[i] : r.l[i];
}

// N independent Montgomery products o[k] = a[k] b[k] R^-1 mod p (a[k] <
// 2^384, b[k] < p, o[k] < p), CIOS over 32-bit words with their rows
// interleaved, so a lane has N chains in flight. The reduction factor M =
// -a b p^-1 mod 2^384 is unique, so the result is fp_mul's limb for limb.
template <int N>
__device__ __forceinline__ void fq_mul_n(fq* o, const fq* a, const fq* b) {
  uint32_t t[N][13];
#pragma unroll
  for (int k = 0; k < N; k++)
#pragma unroll
    for (int j = 0; j < 13; j++) t[k][j] = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) {
#pragma unroll
    for (int k = 0; k < N; k++) {
      const uint32_t bi = b[k].l[i];
      uint64_t c = 0;
#pragma unroll
      for (int j = 0; j < 12; j++) {
        c += (uint64_t)a[k].l[j] * bi + t[k][j];
        t[k][j] = (uint32_t)c;
        c >>= 32;
      }
      c += t[k][12];
      t[k][12] = (uint32_t)c;
      const uint32_t hi = (uint32_t)(c >> 32);
      const uint32_t m = t[k][0] * FQ_N0;
      c = ((uint64_t)m * fq_p(0) + t[k][0]) >> 32;
#pragma unroll
      for (int j = 1; j < 12; j++) {
        c += (uint64_t)m * fq_p(j) + t[k][j];
        t[k][j - 1] = (uint32_t)c;
        c >>= 32;
      }
      c += t[k][12];
      t[k][11] = (uint32_t)c;
      t[k][12] = hi + (uint32_t)(c >> 32);
    }
  }
#pragma unroll
  for (int k = 0; k < N; k++) {
    fq r;
#pragma unroll
    for (int j = 0; j < 12; j++) r.l[j] = t[k][j];
    fq_reduce_once(r, t[k][12]);
    o[k] = r;
  }
}

__device__ __forceinline__ void fq_mul(fq& o, const fq& a, const fq& b) {
  fq_mul_n<1>(&o, &a, &b);
}

__device__ __forceinline__ void fq_from64(fq& o, const uint64_t* v) {
  for (int i = 0; i < 6; i++) {
    o.l[2 * i] = (uint32_t)v[i];
    o.l[2 * i + 1] = (uint32_t)(v[i] >> 32);
  }
}

// a + b, or a - b when neg (a, b < p), by one path of two carry chains:
// s = a + b, or a + ~b + 1 = a - b mod 2^384 (carry c1: a >= b); then
// t = s - p (carry c2: s >= p), or s + p; the one of s and t in [0, p)
__device__ __forceinline__ void fq_add_sub(fq& o, const fq& a, const fq& b,
                                           bool neg) {
  const uint32_t m = 0u - (uint32_t)neg;
  fq s, t;
  uint64_t c = neg ? 1u : 0u;
#pragma unroll
  for (int i = 0; i < 12; i++) {
    c += (uint64_t)a.l[i] + (b.l[i] ^ m);
    s.l[i] = (uint32_t)c;
    c >>= 32;
  }
  uint64_t d = neg ? 0u : 1u;  // + (2^384 - p) = + ~p + 1, or + p
#pragma unroll
  for (int i = 0; i < 12; i++) {
    d += (uint64_t)s.l[i] + (fq_p(i) ^ ~m);
    t.l[i] = (uint32_t)d;
    d >>= 32;
  }
  const bool take = neg ? c == 0 : d != 0;
#pragma unroll
  for (int i = 0; i < 12; i++) o.l[i] = take ? t.l[i] : s.l[i];
}

// R^3 mod p: the Montgomery product of a plain inverse with it is the
// Montgomery form of the inverse
__constant__ uint32_t FQ_R3[12] = {
    0xd94ca1e0u, 0xed48ac6bu, 0x03a7adf8u, 0x315f831eu, 0x615e29ddu, 0x9a53352au,
    0x921e1761u, 0x34c04e5eu, 0x65724728u, 0x2512d435u, 0x91755d4du, 0x0aa63460u};

__device__ __forceinline__ bool fq_is_zero(const fq& a) {
  uint32_t z = 0;
  for (int i = 0; i < 12; i++) z |= a.l[i];
  return z == 0;
}

__device__ __forceinline__ bool fq_is_one_plain(const fq& a) {
  uint32_t z = a.l[0] ^ 1u;
  for (int i = 1; i < 12; i++) z |= a.l[i];
  return z == 0;
}

// a >= b, as integers
__device__ __forceinline__ bool fq_geq(const fq& a, const fq& b) {
  uint32_t brw = 0;
  for (int i = 0; i < 12; i++) {
    const uint64_t x = (uint64_t)a.l[i] - b.l[i] - brw;
    brw = (uint32_t)(x >> 63);
  }
  return brw == 0;
}

// a -= b, as integers (a >= b)
__device__ __forceinline__ void fq_sub_int(fq& a, const fq& b) {
  uint32_t brw = 0;
  for (int i = 0; i < 12; i++) {
    const uint64_t x = (uint64_t)a.l[i] - b.l[i] - brw;
    a.l[i] = (uint32_t)x;
    brw = (uint32_t)(x >> 63);
  }
}

// a / 2 mod p, for a < p: a >> 1, or (a + p) >> 1 when a is odd
__device__ __forceinline__ void fq_half(fq& a) {
  const uint32_t mask = 0u - (a.l[0] & 1u);
  uint64_t c = 0;
  for (int i = 0; i < 12; i++) {
    c += (uint64_t)a.l[i] + (fq_p(i) & mask);
    a.l[i] = (uint32_t)c;
    c >>= 32;
  }
  for (int i = 0; i < 11; i++) a.l[i] = (a.l[i] >> 1) | (a.l[i + 1] << 31);
  a.l[11] = (a.l[11] >> 1) | ((uint32_t)c << 31);
}

// the inverse in Montgomery form (fp_inv's value: 0 for 0), by the binary
// extended Euclidean algorithm on the limbs A of a: u = A, v = p with
// x1 A = u and x2 A = v mod p, halving and subtracting until u or v is 1.
// Its time depends on a; the pairing's operands are public. A^-1 R^3 R^-1
// = R^2 / A is the Montgomery form of (A / R)^-1.
__device__ __noinline__ void fq_inv(fq& o, const fq& a) {
  if (fq_is_zero(a)) {
    o = a;
    return;
  }
  fq u = a, v, x1, x2;
  for (int i = 0; i < 12; i++) {
    v.l[i] = fq_p(i);
    x1.l[i] = 0;
    x2.l[i] = 0;
  }
  x1.l[0] = 1;
  while (!fq_is_one_plain(u) && !fq_is_one_plain(v)) {
    while ((u.l[0] & 1u) == 0) {
      for (int i = 0; i < 11; i++) u.l[i] = (u.l[i] >> 1) | (u.l[i + 1] << 31);
      u.l[11] >>= 1;
      fq_half(x1);
    }
    while ((v.l[0] & 1u) == 0) {
      for (int i = 0; i < 11; i++) v.l[i] = (v.l[i] >> 1) | (v.l[i + 1] << 31);
      v.l[11] >>= 1;
      fq_half(x2);
    }
    if (fq_geq(u, v)) {
      fq_sub_int(u, v);
      fq_add_sub(x1, x1, x2, true);
    } else {
      fq_sub_int(v, u);
      fq_add_sub(x2, x2, x1, true);
    }
  }
  fq r3;
  for (int i = 0; i < 12; i++) r3.l[i] = FQ_R3[i];
  fq_mul(o, fq_is_one_plain(u) ? x1 : x2, r3);
}

// 48 little-endian bytes (any value < 2^384) -> Montgomery form mod p
__device__ __forceinline__ void fq_load(fq& o, const uint8_t* b) {
  fq n, r2;
  for (int i = 0; i < 12; i++)
    n.l[i] = (uint32_t)b[4 * i] | (uint32_t)b[4 * i + 1] << 8 |
             (uint32_t)b[4 * i + 2] << 16 | (uint32_t)b[4 * i + 3] << 24;
  fq_from64(r2, FP_R2);
  fq_mul(o, n, r2);
}

// Montgomery -> canonical 48 little-endian bytes
__device__ __forceinline__ void fq_store(uint8_t* b, const fq& a) {
  fq one, n;
  for (int i = 0; i < 12; i++) one.l[i] = 0;
  one.l[0] = 1;
  fq_mul(n, a, one);
  for (int i = 0; i < 12; i++)
    for (int j = 0; j < 4; j++) b[4 * i + j] = (uint8_t)(n.l[i] >> (8 * j));
}

// --- the interpreter --------------------------------------------------------

constexpr int K_MUL = 0, K_ALU = 1, K_INV = 2;
constexpr int OP_MUL = 0, OP_ADD = 1, OP_SUB = 2, OP_SEL0 = 3, OP_SEL1 = 4,
              OP_INV = 5;

__device__ __forceinline__ int job_dst(uint32_t j) { return (j >> 3) & 511; }
__device__ __forceinline__ int job_a(uint32_t j) { return (j >> 12) & 1023; }
__device__ __forceinline__ int job_b(uint32_t j) { return (j >> 22) & 1023; }

// an addition, subtraction or select; flags bit k: pair k is valid
template <class W>
__device__ __forceinline__ void alu_job(W& w, uint32_t j, unsigned flags) {
  const int op = j & 7;
  const fq a = w.ld(job_a(j)), b = w.ld(job_b(j));
  fq r;
  if (op <= OP_SUB)
    fq_add_sub(r, a, b, op == OP_SUB);
  else
    r = ((flags >> (op - OP_SEL0)) & 1) ? a : b;
  w.st(job_dst(j), r);
}

// job i of stage word st, or 0 past its jobs
__device__ __forceinline__ uint32_t stage_job(uint32_t st, int i) {
  return i < (int)((st >> 2) & 127) ? prog::JOBS[(st >> 9) + i] : 0u;
}

// the stages first .. first + n - 1 of prog::STAGES on the G lanes of w (a
// warp, G = 32, or a group of a warp), then w's sync after each: lane l
// runs jobs l and l + G of a stage. Every lane runs every stage (lanes
// without a job idle), so the lanes stay converged at their syncs. A
// stage's jobs are loaded while the stage before it runs.
template <class W, int G = W::kLanes>
__device__ __forceinline__ void run_program(W& w, int first, int n,
                                            unsigned flags) {
  const int l = w.lane;
  uint32_t st = prog::STAGES[first];
  uint32_t j0 = stage_job(st, l), j1 = stage_job(st, l + G);
  for (int s = first; s < first + n; s++) {
    const uint32_t st_next = s + 1 < first + n ? prog::STAGES[s + 1] : 0u;
    const uint32_t n0 = stage_job(st_next, l), n1 = stage_job(st_next, l + G);
    const int kind = st & 3, nj = (st >> 2) & 127;
    if (kind == K_MUL) {
      if (nj > G) {
        // two products a lane; a lane with one reads slot 0 for the other
        // and discards it
        const bool two = l + G < nj;
        fq a[2] = {w.ld(job_a(j0)), w.ld(job_a(j1))};
        fq b[2] = {w.ld(job_b(j0)), w.ld(job_b(j1))};
        fq r[2];
        fq_mul_n<2>(r, a, b);
        w.st(job_dst(j0), r[0]);
        if (two) w.st(job_dst(j1), r[1]);
      } else if (l < nj) {
        const fq a = w.ld(job_a(j0)), b = w.ld(job_b(j0));
        fq r;
        fq_mul(r, a, b);
        w.st(job_dst(j0), r);
      }
    } else if (kind == K_ALU) {
      if (l < nj) alu_job(w, j0, flags);
      if (l + G < nj) alu_job(w, j1, flags);
    } else if (l < nj) {
      fq r;
      fq_inv(r, w.ld(job_a(j0)));
      w.st(job_dst(j0), r);
    }
    w.sync();
    st = st_next;
    j0 = n0;
    j1 = n1;
  }
}

#define TM_RUN(w, P, flags) run_program(w, prog::P##_FIRST, prog::P##_N, flags)

// slots 0 .. NCONST - 1: zero, one and gamma's coefficients
template <class W>
__device__ __forceinline__ void warp_consts(W& w) {
  if (w.lane < prog::NCONST) {
    fq c;
    for (int i = 0; i < 12; i++) c.l[i] = prog::CONSTS[w.lane][i];
    w.st(w.lane, c);
  }
  w.sync();
}

// the Miller value of chunk k (pairs 2k, 2k + 1), conjugated, into out as
// 144 Montgomery words (an fp12's memory layout): lanes 0-11 load the
// coordinates (P to M_P, Q to M_Q), then f = 1 and T = Q, then a program
// per bit of |x| after the leading one (M_ADD where the bit is set), then
// f = conj(f). Invalid pairs run their T chain and fold the identity line.
template <class W>
__device__ __forceinline__ void miller_chunk_w(W& w, const uint8_t* xp,
                                               const uint8_t* yp,
                                               const uint8_t* xq,
                                               const uint8_t* yq,
                                               const bool* valid, int k,
                                               uint32_t* out) {
  warp_consts(w);
  const int l = w.lane;
  if (l < 12) {
    const uint8_t* src;
    if (l < 4) {
      src = ((l & 1) ? yp : xp) + 48 * (2 * k + (l >> 1));
    } else {
      const int q = l - 4;  // pair q / 4, x or y, component
      src = (((q >> 1) & 1) ? yq : xq) + 96 * (2 * k + (q >> 2)) + 48 * (q & 1);
    }
    fq v;
    fq_load(v, src);
    w.st(l < 4 ? prog::M_P + l : prog::M_Q + l - 4, v);
  }
  w.sync();
  const unsigned flags = (valid[2 * k] ? 1u : 0u) | (valid[2 * k + 1] ? 2u : 0u);
  TM_RUN(w, M_INIT, flags);
  for (int bit = 62; bit >= 0; bit--) {
    if ((X_ABS >> bit) & 1)
      TM_RUN(w, M_ADD, flags);
    else
      TM_RUN(w, M_DBL, flags);
  }
  TM_RUN(w, M_FINAL, flags);
  if (l < 12) {
    const fq v = w.ld(prog::M_F + l);
    for (int i = 0; i < 12; i++) out[12 * l + i] = v.l[i];
  }
  w.sync();
}

// s[dst] = s[x] s[y], fp12s of 144 Montgomery words (the chunk product);
// the warp's constants must be loaded
template <class W>
__device__ __forceinline__ void chunk_mul_w(W& w, uint32_t* s, int dst, int x,
                                            int y) {
  const int l = w.lane;
  if (l < 24) {
    const uint32_t* src = s + 144 * (l < 12 ? x : y) + 12 * (l % 12);
    fq v;
    for (int i = 0; i < 12; i++) v.l[i] = src[i];
    w.st(prog::C_X + l, v);  // C_Y = C_X + 12
  }
  w.sync();
  TM_RUN(w, MUL12, 0u);
  if (l < 12) {
    const fq v = w.ld(prog::C_Z + l);
    for (int i = 0; i < 12; i++) s[144 * dst + 12 * l + i] = v.l[i];
  }
  w.sync();
}

// the product of the c (a power of two) chunk values in s, as a tree
// (level `step` multiplies chunk 2 i step + step into 2 i step), products
// of a level spread over nwarps warps, block_sync between levels; warp 0
// writes the canonical bytes
template <class W, class Sync>
__device__ __forceinline__ void chunk_product_w(W& w, int warp, int nwarps,
                                                uint32_t* s, int c,
                                                uint8_t* out,
                                                Sync block_sync) {
  warp_consts(w);
  for (int step = 1; step < c; step <<= 1) {
    for (int i = warp; 2 * i * step < c; i += nwarps)
      chunk_mul_w(w, s, 2 * i * step, 2 * i * step, 2 * i * step + step);
    block_sync();
  }
  if (warp == 0 && w.lane < 12) {
    fq v;
    for (int i = 0; i < 12; i++) v.l[i] = s[12 * w.lane + i];
    fq_store(out + 48 * w.lane, v);
  }
}

// a^|x| into R from X (the input of a^x; its conj is taken by the next
// program)
template <class W>
__device__ __forceinline__ void exp_xabs_w(W& w) {
  TM_RUN(w, FE_RONE, 0u);
  for (int i = 63; i >= 0; i--) {
    TM_RUN(w, FE_CYC, 0u);
    if ((X_ABS >> i) & 1) TM_RUN(w, FE_MULX, 0u);
  }
}

// f^((p^12 - 1)/r * 3) of the element at in (576 bytes) into out:
// final_exponentiation's easy part and hard-part chain, each a^x a run of
// 64 cyclotomic squarings and 6 products
template <class W>
__device__ __forceinline__ void final_exp_w(W& w, const uint8_t* in,
                                            uint8_t* out) {
  warp_consts(w);
  const int l = w.lane;
  if (l < 12) {
    fq v;
    fq_load(v, in + 48 * l);
    w.st(prog::E_F + l, v);
  }
  w.sync();
  TM_RUN(w, FE_EASY, 0u);  // F = easy(f), X = F
  exp_xabs_w(w);
  TM_RUN(w, FE_G1, 0u);  // A = f^x conj(f), X = A
  exp_xabs_w(w);
  TM_RUN(w, FE_G2, 0u);  // A = a^x conj(a), X = A
  exp_xabs_w(w);
  TM_RUN(w, FE_G3, 0u);  // B = a^x frob(a), X = B
  exp_xabs_w(w);
  TM_RUN(w, FE_G4, 0u);  // X = b^x
  exp_xabs_w(w);
  TM_RUN(w, FE_G5, 0u);  // O = (b^x)^x frob^2(b) conj(b) f^2 f
  if (l < 12) fq_store(out + 48 * l, w.ld(prog::E_O + l));
  w.sync();
}

// --- the warp-wide G2 point sums ---------------------------------------------
//
// tm_g2_aggregate and tm_g2_add run each G2 addition on one warp: the
// points sit in slots (P at prog::G2_P, Q at prog::G2_Q, six fq each:
// coordinate c component k at + 2 c + k), and jac_add<fp2> runs as two
// stage programs with its branches between them. Every lane reads the
// slots a branch tests, so each branch is taken by the whole warp; fq
// values are fully reduced, so a zero test is exact. The order of the tests
// is jac_add's, the JAX package's precedence: P at infinity gives Q, Q at
// infinity gives P, h = 0 and r = 0 give 2P, h = 0 alone the identity. The
// doubling runs only where it is taken.

// the Fp2 at slots s, s + 1 is zero (read by every lane)
template <class W>
__device__ __forceinline__ bool f2_slots_zero(W& w, int s) {
  return fq_is_zero(w.ld(s)) && fq_is_zero(w.ld(s + 1));
}

// O = the identity (0, 1, 0)
template <class W>
__device__ __forceinline__ void g2_identity_w(W& w) {
  if (w.lane < 6)
    w.st(prog::G2_O + w.lane, w.ld(w.lane == 2 ? prog::ONE_SLOT : prog::ZERO_SLOT));
  w.sync();
}

// O = 2P, jac_double<fp2>: the identity where y or z is zero, else G2_DBL
template <class W>
__device__ __forceinline__ void g2_dbl_w(W& w) {
  if (f2_slots_zero(w, prog::G2_P + 2) || f2_slots_zero(w, prog::G2_P + 4))
    g2_identity_w(w);
  else
    TM_RUN(w, G2_DBL, 0u);
}

// P + Q, jac_add<fp2>: the first slot of the sum (G2_Q, G2_P or G2_O); the
// warp's constants must be loaded
template <class W>
__device__ __forceinline__ int g2_add_w(W& w) {
  if (f2_slots_zero(w, prog::G2_P + 4)) return prog::G2_Q;
  if (f2_slots_zero(w, prog::G2_Q + 4)) return prog::G2_P;
  TM_RUN(w, G2_HR, 0u);  // z1z1, z2z2, u1, s1, h, r
  if (f2_slots_zero(w, prog::G2_H)) {
    if (f2_slots_zero(w, prog::G2_R))
      g2_dbl_w(w);
    else
      g2_identity_w(w);
  } else {
    TM_RUN(w, G2_ADD_FIN, 0u);
  }
  return prog::G2_O;
}

// o = p + q of two points of 288 canonical bytes ([3][2][48]), read mod p:
// lanes 0-11 load P and Q, lanes 0-5 store the sum's canonical bytes
template <class W>
__device__ __forceinline__ void g2_add_bytes_w(W& w, const uint8_t* p,
                                               const uint8_t* q, uint8_t* o) {
  warp_consts(w);
  const int l = w.lane;
  if (l < 12) {
    fq v;
    fq_load(v, (l < 6 ? p : q) + 48 * (l % 6));
    w.st(prog::G2_P + l, v);  // G2_Q = G2_P + 6
  }
  w.sync();
  const int sum = g2_add_w(w);
  if (l < 6) fq_store(o + 48 * l, w.ld(sum + l));
  w.sync();
}

// the sum of b points of 288 canonical bytes at in, padded with the
// identity to nb (a power of two), into out: all threads of the block
// load the leaves into s (nb points of six fq, Montgomery form); level
// `step` adds point 2 i step + step into 2 i step (the JAX package's
// pairing of neighbours), addition i of a level on warp i mod nwarps,
// block_sync between levels; warp 0 writes the canonical bytes
template <class W, class Sync>
__device__ __forceinline__ void g2_tree_w(W& w, int warp, int nwarps,
                                          const uint8_t* in, fq* s, uint8_t* out,
                                          int b, int nb, Sync block_sync) {
  const int l = w.lane;
  for (int c = 32 * warp + l; c < 6 * nb; c += 32 * nwarps) {
    if (c < 6 * b) {
      fq_load(s[c], in + 48 * (size_t)c);
    } else {
      fq v;
      for (int i = 0; i < 12; i++) v.l[i] = c % 6 == 2 ? prog::CONSTS[prog::ONE_SLOT][i] : 0u;
      s[c] = v;
    }
  }
  warp_consts(w);
  block_sync();
  for (int step = 1; step < nb; step <<= 1) {
    for (int i = warp; 2 * i * step < nb; i += nwarps) {
      fq* pk = s + 6 * (size_t)(2 * i * step);
      if (l < 12) w.st(prog::G2_P + l, pk[l < 6 ? l : 6 * step + l - 6]);
      w.sync();
      const int sum = g2_add_w(w);
      if (l < 6) pk[l] = w.ld(sum + l);
      w.sync();
    }
    block_sync();
  }
  if (warp == 0 && l < 6) fq_store(out + 48 * l, s[l]);
}

// --- the G1 point sums on lane groups -----------------------------------------
//
// tm_g1_aggregate and tm_g1_add run each G1 addition on a group of G lanes
// of a warp (G = W::kLanes, 4 or 8: bls_kernels.cu's kG1TreeLanes and
// kG1AddLanes), 32 / G groups a warp: jac_add<fp> as the stage programs
// G1_HR and G1_ADD_FIN,
// or G1_DBL where h = r = 0, with g2_add_w's branches between them, taken
// by the whole group. The programs hold at most 8 jobs a stage (two a lane
// on four lanes). A group's slots are its own region of shared memory
// (P at prog::G1_P, Q at prog::G1_Q, O at prog::G1_O, a coordinate a slot;
// slots 0 and 1 zero and one), and its sync is __syncwarp over its own
// lanes (group_mask), so the groups of a warp run and branch apart.

// the lanes of warp lane l's group of G (a power of two), as the mask of
// __syncwarp
template <int G>
__device__ __forceinline__ unsigned group_mask(int l) {
  return G == 32 ? 0xffffffffu : ((1u << (G & 31)) - 1u) << (l & (32 - G));
}

// slots 0 and 1: zero and one
template <class W>
__device__ __forceinline__ void g1_consts(W& w) {
  static_assert(W::kLanes >= 4, "the G1 programs run two jobs a lane on four lanes");
  if (w.lane < 2) {
    fq c;
    for (int i = 0; i < 12; i++) c.l[i] = prog::CONSTS[w.lane][i];
    w.st(w.lane, c);
  }
  w.sync();
}

// O = the identity (0, 1, 0)
template <class W>
__device__ __forceinline__ void g1_identity_g(W& w) {
  if (w.lane < 3)
    w.st(prog::G1_O + w.lane, w.ld(w.lane == 1 ? prog::ONE_SLOT : prog::ZERO_SLOT));
  w.sync();
}

// O = 2P, jac_double<fp>: the identity where y or z is zero, else G1_DBL
template <class W>
__device__ __forceinline__ void g1_dbl_g(W& w) {
  if (fq_is_zero(w.ld(prog::G1_P + 1)) || fq_is_zero(w.ld(prog::G1_P + 2)))
    g1_identity_g(w);
  else
    TM_RUN(w, G1_DBL, 0u);
}

// P + Q, jac_add<fp>: the first slot of the sum (G1_Q, G1_P or G1_O); the
// group's constants must be loaded
template <class W>
__device__ __forceinline__ int g1_add_g(W& w) {
  if (fq_is_zero(w.ld(prog::G1_P + 2))) return prog::G1_Q;
  if (fq_is_zero(w.ld(prog::G1_Q + 2))) return prog::G1_P;
  TM_RUN(w, G1_HR, 0u);  // z1z1, z2z2, u1, s1, h, r
  if (fq_is_zero(w.ld(prog::G1_H))) {
    if (fq_is_zero(w.ld(prog::G1_R)))
      g1_dbl_g(w);
    else
      g1_identity_g(w);
  } else {
    TM_RUN(w, G1_ADD_FIN, 0u);
  }
  return prog::G1_O;
}

// o = p + q of two points of 144 canonical bytes ([3][48]), read mod p:
// the group's lanes load the six coordinates of P and Q, lanes 0-2 store
// the sum's canonical bytes
template <class W>
__device__ __forceinline__ void g1_add_bytes_g(W& w, const uint8_t* p,
                                               const uint8_t* q, uint8_t* o) {
  g1_consts(w);
  const int l = w.lane;
  for (int c = l; c < 6; c += W::kLanes) {
    fq v;
    fq_load(v, (c < 3 ? p : q) + 48 * (c % 3));
    w.st(prog::G1_P + c, v);  // G1_Q = G1_P + 3
  }
  w.sync();
  const int sum = g1_add_g(w);
  if (l < 3) fq_store(o + 48 * l, w.ld(sum + l));
  w.sync();
}

// the sum of b points of 144 canonical bytes at in, padded with the
// identity to nb (a power of two), into out: all threads of the block load
// the leaves into s (nb points of three fq, Montgomery form); level `step`
// adds point 2 i step + step into 2 i step (the JAX package's pairing of
// neighbours), addition i of a level on group i mod ngroups, block_sync
// between levels; group 0 writes the canonical bytes
template <class W, class Sync>
__device__ __forceinline__ void g1_tree_g(W& w, int group, int ngroups,
                                          const uint8_t* in, fq* s, uint8_t* out,
                                          int b, int nb, Sync block_sync) {
  constexpr int G = W::kLanes;
  const int l = w.lane;
  for (int c = G * group + l; c < 3 * nb; c += G * ngroups) {
    if (c < 3 * b) {
      fq_load(s[c], in + 48 * (size_t)c);
    } else {
      fq v;
      for (int i = 0; i < 12; i++) v.l[i] = c % 3 == 1 ? prog::CONSTS[prog::ONE_SLOT][i] : 0u;
      s[c] = v;
    }
  }
  g1_consts(w);
  block_sync();
  for (int step = 1; step < nb; step <<= 1) {
    for (int i = group; 2 * i * step < nb; i += ngroups) {
      fq* pk = s + 3 * (size_t)(2 * i * step);
      for (int c = l; c < 6; c += G) w.st(prog::G1_P + c, pk[c < 3 ? c : 3 * step + c - 3]);
      w.sync();
      const int sum = g1_add_g(w);
      if (l < 3) pk[l] = w.ld(sum + l);
      w.sync();
    }
    block_sync();
  }
  if (group == 0 && l < 3) fq_store(out + 48 * l, s[l]);
}

}  // namespace bdev
