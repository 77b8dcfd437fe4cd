// secp256k1 device arithmetic for the ECDSA verify kernel.
//
//   fs     the kernel's field mod p = 2^256 - 2^32 - 977: 8 x 32-bit
//          little-endian limbs, always canonical (in [0, p)); products
//          through 32 x 32 -> 64-bit multiply-adds (Hopper's native
//          product), the 512-bit product folded twice through 2^256 =
//          2^32 + 977 (mod p), then one conditional subtraction of p
//   fe     the one-thread reference: 4 x 64-bit words, canonical, products
//          through unsigned __int128, the same fold (no kernel runs it; the
//          CPU harness holds fs and the lanes against it)
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
// The kernel runs a row on a group of 4 lanes (the end of this file): the
// same formulas as the stage programs S_HR, S_ADD_FIN and S_DBL
// (secp256k1_programs.cuh, generated by ops/secp_lane_gen.py from the G1
// graphs of ops/bls_warp_gen.py), which run_program interprets a stage of
// independent fs products or additions at a time over slots of shared
// memory, with pt_add's branches between them. Both cores are canonical,
// so every slot holds the one-thread limbs of the same value.
//
// Built by nvcc for sm_90a; the code is plain C++ over stdint types, so g++
// builds it too: the CPU tests run the group functions through a host
// harness, tests/secp_lanes_host.cpp. Outside nvcc the device qualifiers
// below become plain (inline) C++.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include <utility>

#ifndef __CUDACC__
#define __host__
#define __device__ inline
#define __forceinline__
#define __noinline__
#define __constant__ static
#endif

#include "secp256k1_programs.cuh"

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


// --- fs: the kernel's field, 8 x 32-bit limbs ----------------------------------

struct alignas(16) fs {
  uint32_t l[8];
};

// the 32-bit limbs of p and of n, as immediates once a loop is unrolled
__device__ __forceinline__ uint32_t fs_p(int i) {
  return i == 0 ? 0xFFFFFC2Fu : i == 1 ? 0xFFFFFFFEu : 0xFFFFFFFFu;
}

__device__ __forceinline__ uint32_t fs_n(int i) {
  switch (i) {
    case 0: return 0xD0364141u;
    case 1: return 0xBFD25E8Cu;
    case 2: return 0xAF48A03Bu;
    case 3: return 0xBAAEDCE6u;
    case 4: return 0xFFFFFFFEu;
    default: return 0xFFFFFFFFu;
  }
}

__device__ __forceinline__ void fs_set_u32(fs& o, uint32_t a) {
  o.l[0] = a;
#pragma unroll
  for (int i = 1; i < 8; i++) o.l[i] = 0;
}

__device__ __forceinline__ bool fs_is_zero(const fs& a) {
  uint32_t x = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) x |= a.l[i];
  return x == 0;
}

__device__ __forceinline__ bool fs_eq(const fs& a, const fs& b) {
  uint32_t x = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) x |= a.l[i] ^ b.l[i];
  return x == 0;
}

// a < p, of the integer a (not mod p)
__device__ __forceinline__ bool fs_lt_p(const fs& a) {
  uint64_t brw = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) brw = ((uint64_t)a.l[i] - fs_p(i) - brw) >> 63;
  return brw != 0;
}

// r - p where that does not borrow (r < 2^256 < 2p)
__device__ __forceinline__ void fs_reduce_once(fs& r) {
  uint32_t d[8];
  uint64_t brw = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint64_t x = (uint64_t)r.l[i] - fs_p(i) - brw;
    d[i] = (uint32_t)x;
    brw = x >> 63;
  }
#pragma unroll
  for (int i = 0; i < 8; i++) r.l[i] = brw ? r.l[i] : d[i];
}

// o = a b mod p for any a, b < 2^256: the 512-bit product t, row by row
// through 32 x 32 -> 64-bit multiply-adds, then folded through 2^256 =
// 2^32 + 977: lo + hi 977 + hi 2^32 (below 2^256 + 2^289), the part past
// 2^256 (below 2^34) folded once more the same way; a carry out of that
// leaves a value below 2^67, to which the fold is added once without a
// carry; then one conditional subtraction of p
__device__ __forceinline__ void fs_mul(fs& o, const fs& a, const fs& b) {
  uint32_t t[16];
#pragma unroll
  for (int j = 0; j < 16; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint32_t bi = b.l[i];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c += (uint64_t)a.l[j] * bi + t[i + j];
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
    t[i + 8] = (uint32_t)c;
  }
  fs r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)t[i] + (uint64_t)t[8 + i] * 977u + (i ? t[7 + i] : 0u);
    r.l[i] = (uint32_t)c;
    c >>= 32;
  }
  const uint64_t top = c + t[15];
  c = (uint64_t)r.l[0] + top * 977u;
  r.l[0] = (uint32_t)c;
  c = (c >> 32) + r.l[1] + top;
  r.l[1] = (uint32_t)c;
#pragma unroll
  for (int i = 2; i < 8; i++) {
    c = (c >> 32) + r.l[i];
    r.l[i] = (uint32_t)c;
  }
  const uint32_t wrap = (uint32_t)(c >> 32);  // 0 or 1: + wrap (2^32 + 977)
  c = (uint64_t)r.l[0] + 977u * wrap;
  r.l[0] = (uint32_t)c;
  c = (c >> 32) + r.l[1] + wrap;
  r.l[1] = (uint32_t)c;
#pragma unroll
  for (int i = 2; i < 8; i++) {
    c = (c >> 32) + r.l[i];
    r.l[i] = (uint32_t)c;
  }
  fs_reduce_once(r);
  o = r;
}

// a + b, or a - b when neg (a, b < p), by one path of two carry chains:
// s = a + b, or a + ~b + 1 = a - b mod 2^256 (carry c: a >= b); then
// t = s - p (carry d: s >= p), or s + p; the one of s and t in [0, p)
__device__ __forceinline__ void fs_add_sub(fs& o, const fs& a, const fs& b,
                                           bool neg) {
  const uint32_t m = 0u - (uint32_t)neg;
  fs s, t;
  uint64_t c = neg ? 1u : 0u;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)a.l[i] + (b.l[i] ^ m);
    s.l[i] = (uint32_t)c;
    c >>= 32;
  }
  uint64_t d = neg ? 0u : 1u;  // + (2^256 - p) = + ~p + 1, or + p
#pragma unroll
  for (int i = 0; i < 8; i++) {
    d += (uint64_t)s.l[i] + (fs_p(i) ^ ~m);
    t.l[i] = (uint32_t)d;
    d >>= 32;
  }
  // a sum: t where it carried (s + 2^256 - p >= 2^256: s >= p) or where s
  // itself carried past 2^256; a difference: t where a - b borrowed
  const bool take = neg ? c == 0 : (d != 0 || c != 0);
#pragma unroll
  for (int i = 0; i < 8; i++) o.l[i] = take ? t.l[i] : s.l[i];
}

__device__ __forceinline__ void fs_add(fs& o, const fs& a, const fs& b) {
  fs_add_sub(o, a, b, false);
}

__device__ __forceinline__ void fs_sub(fs& o, const fs& a, const fs& b) {
  fs_add_sub(o, a, b, true);
}

// the field element of a signed 64-bit integer
__device__ __forceinline__ void fs_from_i64(fs& o, int64_t v) {
  const uint64_t m = v < 0 ? (uint64_t)0 - (uint64_t)v : (uint64_t)v;
  fs a, zero;
  fs_set_u32(a, (uint32_t)m);
  a.l[1] = (uint32_t)(m >> 32);
  fs_set_u32(zero, 0);
  if (v < 0)
    fs_sub(o, zero, a);
  else
    o = a;
}

// sum of limb[i] * 2^(8 i) mod p for 32 radix-2^8 limbs (any int32 values),
// by fe_from_limbs's steps
__device__ __forceinline__ void fs_from_limbs(fs& o, const int32_t* limb) {
  fs acc, d;
  fs_set_u32(acc, 0);
  for (int i = 31; i >= 0; i--) {
    for (int k = 0; k < 8; k++) fs_add(acc, acc, acc);
    fs_from_i64(d, limb[i]);
    fs_add(acc, acc, d);
  }
  o = acc;
}

// the big-endian 32-byte integer at b (not reduced)
__device__ __forceinline__ void fs_load_be(fs& o, const uint8_t* b) {
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint32_t x = 0;
#pragma unroll
    for (int j = 0; j < 4; j++) x = (x << 8) | b[4 * (7 - i) + j];
    o.l[i] = x;
  }
}

// --- the interpreter --------------------------------------------------------------
//
// W is a row's group: W::kLanes (4), w.lane, w.ld(slot), w.st(slot, v),
// w.sync(). On the card, the group's region of shared memory and
// __syncwarp over its own lanes (secp256k1_kernels.cu); in the CPU harness,
// four host threads in lock-step that check each stage's slot accesses.
// A program's stages are unrolled at compile time: each stage's kind, job
// count and jobs are constants, so a lane only selects its job among them
// (no table is read at run time).

constexpr int K_MUL = 0;  // a stage's kind; the other is additions
constexpr int OP_SUB = 2;  // a job's op; 1 is an addition

__device__ __forceinline__ int job_dst(uint32_t j) { return (j >> 3) & 511; }
__device__ __forceinline__ int job_a(uint32_t j) { return (j >> 12) & 1023; }
__device__ __forceinline__ int job_b(uint32_t j) { return (j >> 22) & 1023; }

// stage word s, and job i of stage word st or 0 past its jobs (constant
// expressions)
__host__ __device__ constexpr uint32_t stage_word(int s) { return prog::STAGES[s]; }
__host__ __device__ constexpr uint32_t stage_job(uint32_t st, int i) {
  return i < (int)((st >> 2) & 127) ? prog::JOBS[(st >> 9) + i] : 0u;
}

// an addition or subtraction
template <class W>
__device__ __forceinline__ void alu_job(W& w, uint32_t j) {
  const fs a = w.ld(job_a(j)), b = w.ld(job_b(j));
  fs r;
  fs_add_sub(r, a, b, (j & 7) == OP_SUB);
  w.st(job_dst(j), r);
}

// lane l's job of stage word ST among jobs k .. k + 3
template <uint32_t ST, int K>
__device__ __forceinline__ uint32_t lane_job(int l) {
  constexpr uint32_t j0 = stage_job(ST, K), j1 = stage_job(ST, K + 1),
                     j2 = stage_job(ST, K + 2), j3 = stage_job(ST, K + 3);
  return l == 0 ? j0 : l == 1 ? j1 : l == 2 ? j2 : j3;
}

// lane l's additions of stage word ST from job K on, in order (a word 0 is
// no job)
template <uint32_t ST, int K, class W>
__device__ __forceinline__ void alu_chain(W& w, int l) {
  if constexpr (K < (int)((ST >> 2) & 127)) {
    const uint32_t j = lane_job<ST, K>(l);
    if (j) alu_job(w, j);
    alu_chain<ST, K + 4>(w, l);
  }
}

// stage S of prog::STAGES on the 4 lanes of w, then w's sync: in a product
// stage lane l runs job l (the programs hold at most 4 products a stage),
// in an addition stage jobs l, l + 4, l + 8, ... in order, a chain whose
// operands only this lane writes in the stage. Every lane runs every stage
// (lanes without a job idle), so the lanes stay converged at their syncs.
template <class W, int S>
__device__ __forceinline__ void run_stage(W& w) {
  static_assert(W::kLanes == 4, "a row's group is 4 lanes");
  constexpr uint32_t st = stage_word(S);
  constexpr int nj = (st >> 2) & 127;
  const int l = w.lane;
  if constexpr ((st & 3) == K_MUL) {
    const uint32_t j0 = lane_job<st, 0>(l);
    if (l < nj) {
      fs r;
      fs_mul(r, w.ld(job_a(j0)), w.ld(job_b(j0)));
      w.st(job_dst(j0), r);
    }
  } else {
    alu_chain<st, 0>(w, l);
  }
  w.sync();
}

template <class W, int FIRST, int... I>
__device__ __forceinline__ void run_stages(W& w, std::integer_sequence<int, I...>) {
  (run_stage<W, FIRST + I>(w), ...);
}

// the stages FIRST .. FIRST + N - 1 of prog::STAGES on w
template <int FIRST, int N, class W>
__device__ __forceinline__ void run_program(W& w) {
  run_stages<W, FIRST>(w, std::make_integer_sequence<int, N>{});
}

#define S_RUN(w, P) run_program<prog::P##_FIRST, prog::P##_N>(w)

// --- a row on a group of 4 lanes ------------------------------------------------
//
// tm_secp_verify runs each row on a group of 4 lanes of a warp, 8 rows a
// warp. The group's slots are its own region of shared memory: the
// programs' slots (the accumulator in P, the operand in Q), then the
// row's table of Q; its sync is __syncwarp over its own lanes (group_mask),
// so the groups of a warp run and branch apart. pt_double and pt_add run
// as the stage programs, in place in P, with their branches between them:
// every lane reads the slots a branch tests, so the group takes each branch
// whole; every branch ends with a sync, so the next stage may overwrite
// what the test read. The steps are the one-thread kernel's, so each table
// entry and each ladder value is its point, limb for limb.

constexpr int kRowLanes = 4;
// the row's table of Q: entry d coordinate c at S_TAB + 3 d + c
constexpr int S_TAB = prog::S_SLOTS;
// slots a row, odd: the same slot of neighbouring groups then sits 8 banks
// apart, so a quarter warp's 16-byte loads of it do not collide
constexpr int S_REGION = (S_TAB + 48) | 1;

// the lanes of warp lane l's group of G (a power of two), as the mask of
// __syncwarp
template <int G>
__device__ __forceinline__ unsigned group_mask(int l) {
  return G == 32 ? 0xffffffffu : ((1u << (G & 31)) - 1u) << (l & (32 - G));
}

// slots dst .. dst + n - 1 = src .. src + n - 1, then sync
template <class W>
__device__ __forceinline__ void copy_g(W& w, int dst, int src, int n) {
  for (int c = w.lane; c < n; c += W::kLanes) w.st(dst + c, w.ld(src + c));
  w.sync();
}

// P = the identity (0, 1, 0), after a sync: the lanes may have just read P
// to take this branch
template <class W>
__device__ __forceinline__ void identity_g(W& w) {
  w.sync();
  if (w.lane < 3)
    w.st(prog::S_P + w.lane, w.ld(w.lane == 1 ? prog::ONE_SLOT : prog::ZERO_SLOT));
  w.sync();
}

// P = 2P, pt_double: the identity where y or z is zero, else S_DBL
template <class W>
__device__ __forceinline__ void dbl_g(W& w) {
  if (fs_is_zero(w.ld(prog::S_P + 1)) || fs_is_zero(w.ld(prog::S_P + 2)))
    identity_g(w);
  else
    S_RUN(w, S_DBL);
}

// P = P + Q, pt_add in its order of precedence: q at infinity leaves P, p
// at infinity takes Q, then S_HR, and h = 0 doubles P (r = 0) or gives the
// identity, else S_ADD_FIN
template <class W>
__device__ __forceinline__ void add_g(W& w) {
  if (fs_is_zero(w.ld(prog::S_Q + 2))) {
    w.sync();
    return;
  }
  if (fs_is_zero(w.ld(prog::S_P + 2))) {
    w.sync();
    copy_g(w, prog::S_P, prog::S_Q, 3);
    return;
  }
  S_RUN(w, S_HR);  // z1z1, z2z2, u1, s1, h, r
  if (fs_is_zero(w.ld(prog::S_H))) {
    if (fs_is_zero(w.ld(prog::S_R)))
      dbl_g(w);
    else
      identity_g(w);
  } else {
    S_RUN(w, S_ADD_FIN);
  }
}

// the radix-16 digit k (most significant first) of a big-endian scalar
__device__ __forceinline__ int nibble(const uint8_t* s, int k) {
  const int byte = s[k >> 1];
  return (k & 1) ? (byte & 15) : (byte >> 4);
}

// out[row] = ok_in & ~inf(R) & (x(R) mod n == r), R = u1 G + u2 Q, on the
// group w (the operands as tm_secp_verify takes them; g: [d]G for d < 16,
// three fs a point, affine with z = 1, the identity at d = 0). The
// one-thread kernel's steps: Q's table in the group's slots (identity, Q,
// even entries by doubling entry d / 2, odd ones by adding Q to entry d -
// 1), the radix-16 Straus ladder (64 steps of 4 doublings, the table entry
// of u2's digit, the G entry of u1's), and without an inversion: with Z !=
// 0, x(R) == r iff r < p and X == r Z^2, the wrapped branch iff r + n does
// not carry, r + n < p and X == (r + n) Z^2. A row with ok_in false
// leaves at once.
template <class W>
__device__ __forceinline__ void secp_row_g(W& w, int row, const int32_t* qx,
                                           const int32_t* qy, const uint8_t* u1,
                                           const uint8_t* u2, const uint8_t* rb,
                                           const bool* ok_in, const fs* g,
                                           bool* out) {
  const int l = w.lane;
  if (!ok_in[row]) {
    if (l == 0) out[row] = false;
    return;
  }
  // zero and one; the table's entry 0, the identity, and entry 1, Q with
  // z = 1 (lanes 0 and 1 convert its coordinates)
  if (l < 3) {
    fs c;
    fs_set_u32(c, l == 1 ? 1u : 0u);
    if (l < 2) w.st(l, c);
    w.st(S_TAB + l, c);
    if (l < 2) {
      fs_from_limbs(c, (l ? qy : qx) + (size_t)row * 32);
    } else {
      fs_set_u32(c, 1u);
    }
    w.st(S_TAB + 3 + l, c);
  }
  w.sync();
  // P and Q = entry 1; P is the last entry made, Q stays
  for (int c = l; c < 6; c += kRowLanes) w.st(prog::S_P + c, w.ld(S_TAB + 3 + c % 3));
  w.sync();
  for (int d = 2; d < 16; d++) {
    if (d % 2 == 0) {
      if (d > 2) copy_g(w, prog::S_P, S_TAB + 3 * (d / 2), 3);
      dbl_g(w);
    } else {
      add_g(w);
    }
    copy_g(w, S_TAB + 3 * d, prog::S_P, 3);
  }
  const uint8_t* s1 = u1 + (size_t)row * 32;
  const uint8_t* s2 = u2 + (size_t)row * 32;
  if (l < 3) w.st(prog::S_P + l, w.ld(l == 1 ? prog::ONE_SLOT : prog::ZERO_SLOT));
  w.sync();
  for (int k = 0; k < 64; k++) {
    for (int j = 0; j < 4; j++) dbl_g(w);
    copy_g(w, prog::S_Q, S_TAB + 3 * nibble(s2, k), 3);
    add_g(w);
    const fs* gq = g + 3 * nibble(s1, k);
    if (l < 3) w.st(prog::S_Q + l, gq[l]);
    w.sync();
    add_g(w);
  }
  if (fs_is_zero(w.ld(prog::S_P + 2))) {  // R at infinity
    if (l == 0) out[row] = false;
    return;
  }
  // r + n, and whether it carried past 2^256
  fs r, rn;
  fs_load_be(r, rb + (size_t)row * 32);
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)r.l[i] + fs_n(i);
    rn.l[i] = (uint32_t)c;
    c >>= 32;
  }
  // Z^2 into z1z1's slot, then r Z^2 and (r + n) Z^2 into the next two
  if (l == 0) {
    fs z2;
    fs_mul(z2, w.ld(prog::S_P + 2), w.ld(prog::S_P + 2));
    w.st(prog::S_Z1Z1, z2);
  }
  w.sync();
  if (l < 2) {
    fs t;
    const fs v = l ? rn : r;
    fs_mul(t, v, w.ld(prog::S_Z1Z1));
    w.st(prog::S_Z2Z2 + l, t);
  }
  w.sync();
  const fs x = w.ld(prog::S_P);
  const bool direct = fs_lt_p(r) && fs_eq(w.ld(prog::S_Z2Z2), x);
  const bool wrapped = c == 0 && fs_lt_p(rn) && fs_eq(w.ld(prog::S_Z2Z2 + 1), x);
  if (l == 0) out[row] = direct || wrapped;
}

}  // namespace sdev
