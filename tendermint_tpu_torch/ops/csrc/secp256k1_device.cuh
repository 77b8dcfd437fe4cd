// secp256k1 device arithmetic for the ECDSA verify kernel.
//
//   fe     the field mod p = 2^256 - 2^32 - 977 as 4 x 64-bit little-endian
//          words, always canonical (in [0, p)): products through
//          unsigned __int128, reduced by folding the high half through
//          2^256 = 0x1000003D1 (mod p)
//   point  Jacobian (X, Y, Z) on y^2 = x^3 + 7; the identity is (0, 1, 0)
//
// pt_double and pt_add are the JAX package's formulas and masks
// (tendermint_tpu/ops/secp256k1_kernel.py double :69 / add_points :87:
// dbl-2009-l, add-2007-bl; P == Q doubles, P == -Q gives the identity, an
// input at infinity gives the other, y == 0 or z == 0 doubles to the
// identity). Every value equals the JAX package's mod p, so every mask,
// and with them the verdict, is the same; the limbs differ (it keeps
// radix-2^8 int32 limbs for a TPU without 64-bit lanes).
//
// Built by nvcc for sm_90a; the code is plain C++ over stdint types, so g++
// builds it too with the CUDA qualifiers defined away (how the kernel is
// checked without a card).
#pragma once

#include <stdint.h>

namespace sdev {

typedef unsigned __int128 u128;

struct fe {
  uint64_t v[4];
};
struct point {
  fe x, y, z;
};

// p, and 2^256 - p = 2^32 + 977
static constexpr uint64_t P0 = 0xFFFFFFFEFFFFFC2Full;
static constexpr uint64_t P1 = 0xFFFFFFFFFFFFFFFFull;
static constexpr uint64_t FOLD = 0x1000003D1ull;

__device__ __forceinline__ void fe_set_u64(fe& o, uint64_t a) {
  o.v[0] = a;
  o.v[1] = o.v[2] = o.v[3] = 0;
}

__device__ __forceinline__ bool fe_is_zero(const fe& a) {
  return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

__device__ __forceinline__ bool fe_eq(const fe& a, const fe& b) {
  return ((a.v[0] ^ b.v[0]) | (a.v[1] ^ b.v[1]) | (a.v[2] ^ b.v[2]) |
          (a.v[3] ^ b.v[3])) == 0;
}

// o = s - p (mod 2^256); returns the borrow (1 when s < p)
__device__ __forceinline__ uint64_t sub_p(fe& o, const fe& s) {
  u128 d = (u128)s.v[0] - P0;
  o.v[0] = (uint64_t)d;
  uint64_t brw = (uint64_t)(d >> 64) & 1;
  for (int i = 1; i < 4; i++) {
    d = (u128)s.v[i] - P1 - brw;
    o.v[i] = (uint64_t)d;
    brw = (uint64_t)(d >> 64) & 1;
  }
  return brw;
}

__device__ __forceinline__ void fe_add(fe& o, const fe& a, const fe& b) {
  fe s, t;
  u128 c = 0;
  for (int i = 0; i < 4; i++) {
    c += (u128)a.v[i] + b.v[i];
    s.v[i] = (uint64_t)c;
    c >>= 64;
  }
  // a + b < 2p: subtract p once when the sum carried out or is >= p (with
  // a carry, s - p mod 2^256 is the true difference)
  const uint64_t brw = sub_p(t, s);
  o = (c || !brw) ? t : s;
}

__device__ __forceinline__ void fe_sub(fe& o, const fe& a, const fe& b) {
  u128 d;
  uint64_t brw = 0;
  fe s;
  for (int i = 0; i < 4; i++) {
    d = (u128)a.v[i] - b.v[i] - brw;
    s.v[i] = (uint64_t)d;
    brw = (uint64_t)(d >> 64) & 1;
  }
  if (brw) {  // a < b: add p back
    u128 c = (u128)s.v[0] + P0;
    s.v[0] = (uint64_t)c;
    c >>= 64;
    for (int i = 1; i < 4; i++) {
      c += (u128)s.v[i] + P1;
      s.v[i] = (uint64_t)c;
      c >>= 64;
    }
  }
  o = s;
}

// a 512-bit value t (8 words) mod p
__device__ __forceinline__ void fe_reduce512(fe& o, const uint64_t* t) {
  uint64_t r[4];
  u128 c = 0;
  for (int i = 0; i < 4; i++) {  // lo + hi * (2^32 + 977): below 2^290
    c += (u128)t[i] + (u128)t[4 + i] * FOLD;
    r[i] = (uint64_t)c;
    c >>= 64;
  }
  const u128 d = c * FOLD;  // the carry (< 2^35) folded once more
  u128 s = (u128)r[0] + (uint64_t)d;
  r[0] = (uint64_t)s;
  s = (s >> 64) + r[1] + (uint64_t)(d >> 64);
  r[1] = (uint64_t)s;
  s = (s >> 64) + r[2];
  r[2] = (uint64_t)s;
  s = (s >> 64) + r[3];
  r[3] = (uint64_t)s;
  if (s >> 64) {  // wrapped past 2^256: r is now small, add the fold
    s = (u128)r[0] + FOLD;
    r[0] = (uint64_t)s;
    for (int i = 1; i < 4; i++) {
      s = (s >> 64) + r[i];
      r[i] = (uint64_t)s;
    }
  }
  fe x, y;
  for (int i = 0; i < 4; i++) x.v[i] = r[i];
  o = sub_p(y, x) ? x : y;  // r < 2^256 < 2p
}

__device__ __forceinline__ void fe_mul(fe& o, const fe& a, const fe& b) {
  uint64_t t[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; i++) {
    u128 c = 0;
    for (int j = 0; j < 4; j++) {
      c += (u128)a.v[i] * b.v[j] + t[i + j];
      t[i + j] = (uint64_t)c;
      c >>= 64;
    }
    t[i + 4] = (uint64_t)c;
  }
  fe_reduce512(o, t);
}

__device__ __forceinline__ void fe_sqr(fe& o, const fe& a) { fe_mul(o, a, a); }

// a * 2^k by k doublings
__device__ __forceinline__ void fe_shl(fe& o, const fe& a, int k) {
  o = a;
  for (int i = 0; i < k; i++) fe_add(o, o, o);
}

// the field element of a signed 64-bit integer
__device__ __forceinline__ void fe_from_i64(fe& o, int64_t v) {
  fe m, zero;
  fe_set_u64(zero, 0);
  fe_set_u64(m, v < 0 ? (uint64_t)0 - (uint64_t)v : (uint64_t)v);
  if (v < 0)
    fe_sub(o, zero, m);
  else
    o = m;
}

// sum of limb[i] * 2^(8 i) mod p for 32 radix-2^8 limbs (any int32 values)
__device__ __forceinline__ void fe_from_limbs(fe& o, const int32_t* limb) {
  fe acc, d;
  fe_set_u64(acc, 0);
  for (int i = 31; i >= 0; i--) {
    fe_shl(acc, acc, 8);
    fe_from_i64(d, limb[i]);
    fe_add(acc, acc, d);
  }
  o = acc;
}

// --- Jacobian group law (a = 0) --------------------------------------------

__device__ __forceinline__ void pt_identity(point& o) {
  fe_set_u64(o.x, 0);
  fe_set_u64(o.y, 1);
  fe_set_u64(o.z, 0);
}

// dbl-2009-l; the identity when y or z is zero
__device__ __forceinline__ void pt_double(point& o, const point& p) {
  if (fe_is_zero(p.y) || fe_is_zero(p.z)) {
    pt_identity(o);
    return;
  }
  fe a, b, c, d, e, f, t, x3, y3, z3;
  fe_sqr(a, p.x);
  fe_sqr(b, p.y);
  fe_sqr(c, b);
  fe_add(t, p.x, b);
  fe_sqr(t, t);
  fe_sub(t, t, a);
  fe_sub(t, t, c);
  fe_add(d, t, t);  // 2((x + b)^2 - a - c)
  fe_add(e, a, a);
  fe_add(e, e, a);  // 3a
  fe_sqr(f, e);
  fe_add(t, d, d);
  fe_sub(x3, f, t);
  fe_sub(t, d, x3);
  fe_mul(y3, e, t);
  fe_shl(t, c, 3);
  fe_sub(y3, y3, t);
  fe_mul(z3, p.y, p.z);
  fe_add(z3, z3, z3);
  o.x = x3;
  o.y = y3;
  o.z = z3;
}

// add-2007-bl with the JAX package's masks, in its order of precedence:
// q at infinity gives p, p at infinity gives q, P == Q doubles, P == -Q
// gives the identity
__device__ __forceinline__ void pt_add(point& o, const point& p,
                                       const point& q) {
  if (fe_is_zero(q.z)) {
    o = p;
    return;
  }
  if (fe_is_zero(p.z)) {
    o = q;
    return;
  }
  fe z1z1, z2z2, u1, u2, s1, s2, h, sd, t;
  fe_sqr(z1z1, p.z);
  fe_sqr(z2z2, q.z);
  fe_mul(u1, p.x, z2z2);
  fe_mul(u2, q.x, z1z1);
  fe_mul(s1, p.y, q.z);
  fe_mul(s1, s1, z2z2);
  fe_mul(s2, q.y, p.z);
  fe_mul(s2, s2, z1z1);
  fe_sub(h, u2, u1);
  fe_sub(sd, s2, s1);
  if (fe_is_zero(h)) {
    if (fe_is_zero(sd))
      pt_double(o, p);
    else
      pt_identity(o);
    return;
  }
  fe r, i, j, v, x3, y3, z3;
  fe_add(r, sd, sd);
  fe_add(t, h, h);
  fe_sqr(i, t);
  fe_mul(j, h, i);
  fe_mul(v, u1, i);
  fe_sqr(x3, r);
  fe_sub(x3, x3, j);
  fe_add(t, v, v);
  fe_sub(x3, x3, t);
  fe_sub(t, v, x3);
  fe_mul(y3, r, t);
  fe_mul(t, s1, j);
  fe_add(t, t, t);
  fe_sub(y3, y3, t);
  fe_mul(z3, p.z, q.z);
  fe_mul(z3, z3, h);
  fe_add(z3, z3, z3);
  o.x = x3;
  o.y = y3;
  o.z = z3;
}

}  // namespace sdev
